"""BERT/TinyBERT encoder + classification head — the paper's own models.

TinyBERT4 (Jiao et al. 2019): L=4, d_h=312, d_i=1200, 12 heads — the student
quantized in Table 1. Post-LN, learned positions, GELU FFN, bidirectional
attention. ``bert_encode`` / ``bert_classify_logits`` take an
``ExecutionPlan`` (its ``cfg`` and ``segments``) and per-row ``lengths``:
padded key positions are masked out of the bidirectional attention, so a
bucket-padded batch row matches the unpadded forward (to float rounding:
PyTorch picks its reduction order by shape, so the match is within a stated
tolerance, and the integer codes of the first quantized linear are equal).
``want_taps`` also returns the last layer's q/k/v for MINI distillation,
and ``classification_loss`` is the fine-tuning objective.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..core.tree import slice_stack, tree_map
from .transformer import _embed, _norm, block_apply, init_lm


def tinybert_config(num_classes: int = 2, layers=4, d=312, heads=12,
                    d_ff=1200, vocab=30522, name="tinybert4") -> ModelConfig:
    return ModelConfig(
        name=name, family="bert", num_layers=layers, d_model=d,
        num_heads=heads, num_kv_heads=heads, d_ff=d_ff, vocab_size=vocab,
        qkv_bias=True, out_bias=True, norm="ln", act="gelu", rope=False,
        causal=False, learned_pos=True, dtype="float32", remat=False)


def init_bert_classifier(cfg: ModelConfig, num_classes: int,
                         g: torch.Generator, device) -> dict:
    """fp classifier params on ``device``, drawn from ``g`` (a generator on
    that device)."""
    params = init_lm(cfg, g, device)
    params.pop("lm_head", None)  # classification head instead
    d = cfg.d_model
    params["pooler"] = {
        "w": torch.randn((d, d), generator=g, device=device) * 0.02,
        "b": torch.zeros((d,), device=device)}
    params["classifier"] = {
        "w": torch.randn((d, num_classes), generator=g, device=device) * 0.02,
        "b": torch.zeros((num_classes,), device=device)}
    return params


def _device(params) -> torch.device:
    return params["embed"].device


def bert_encode(params, plan, tokens, *, lengths=None, want_taps: bool = False):
    """Final hidden states (B, S, d) through the plan's segments, or
    ``(h, taps)`` with ``want_taps``: the last layer's q/k/v (only the last
    layer is tapped, as in the JAX package: MINI needs no layer mapping).

    ``lengths`` (B,) masks key positions ``>= lengths[b]`` out of every
    attention layer. Padded QUERY positions still produce (garbage) outputs;
    callers read real positions only (the CLS pool reads position 0).
    """
    cfg, segments = plan.cfg, plan.segments
    dev = _device(params)
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    kv_len = (None if lengths is None
              else torch.as_tensor(lengths, dtype=torch.int32, device=dev))
    x = _embed(params, cfg, tokens)
    layers = params["layers"]
    presliced = isinstance(layers, (list, tuple))
    taps = None
    last = segments[-1][1] - 1
    for si, (start, end, spec) in enumerate(segments):
        seg = layers[si] if presliced else slice_stack(layers, start, end)
        for i in range(end - start):
            lp = tree_map(lambda a: a[i], seg)
            tap = want_taps and start + i == last
            out = block_apply(x, lp, cfg, spec, kv_len=kv_len, want_taps=tap)
            x = out[0]
            if tap:
                taps = out[2]
    h = _norm(x, params["final_norm"], cfg.norm)
    return (h, taps) if want_taps else h


def bert_pool(params, h: torch.Tensor) -> torch.Tensor:
    """CLS pooling: tanh projection of position 0 -> (B, d) embedding."""
    return torch.tanh(h[:, 0].to(torch.float32) @ params["pooler"]["w"]
                      + params["pooler"]["b"])


def bert_classify_logits(params, plan, tokens, *,
                         lengths: Optional[torch.Tensor] = None,
                         want_taps: bool = False):
    """Class logits (B, num_classes), or ``(logits, taps)`` with
    ``want_taps``."""
    h = bert_encode(params, plan, tokens, lengths=lengths, want_taps=want_taps)
    if want_taps:
        h, taps = h
    pooled = bert_pool(params, h)
    logits = pooled @ params["classifier"]["w"] + params["classifier"]["b"]
    return (logits, taps) if want_taps else logits


def classification_loss(logits: torch.Tensor, labels) -> torch.Tensor:
    """Mean cross-entropy of integer ``labels`` (B,) under ``logits``."""
    labels = torch.as_tensor(labels, device=logits.device).to(torch.int64)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.mean(logz - gold)
