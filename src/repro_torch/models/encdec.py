"""Encoder-decoder backbone (the Seamless-M4T medium shape), the counterpart
of the JAX package's ``models/encdec.py``.

The modality frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings ``src_embeds`` (B, S_src, d_model). The
decoder is a causal stack with cross-attention onto the encoder output.
The policy's segments apply to the decoder (the deployed half); the encoder
runs at the first segment's spec throughout. A forward longer than
``attn_chunk_threshold`` takes the chunk branch in its self-attention,
which for the bidirectional encoder is the flash kernel with
``causal=False``; cross-attention never does.

Decode state: one fp ``{'k', 'v', 'len'}`` cache over the decoder layers,
(L_dec, B, S, Hkv, hd) with a 0-d cursor, updated in place (the JAX package
returns new arrays). A decode step takes ``enc_out`` instead of
``src_embeds`` (``api.decode_extra_inputs``): the encoder runs once. With
``cfg.remat`` each encoder layer and each decoder layer but a tapped one
runs under activation checkpointing in training (``layers.remat``), at the
JAX package's ``jax.checkpoint`` places.

A sharded training step (``spec.groups``) runs every attention (self and
cross) and FFN as the transformer's: the rank's heads and FFN columns,
the row-parallel ``wo`` / ``w2`` summed over the model ranks, so
``enc_out`` is replicated and the cross-attention's column-parallel
``wk`` / ``wv`` take it whole. The embedding and the head are cut over the
vocabulary, and under FSDP each encoder and decoder layer is taken from
the data rank that owns it (``transformer.take_layer``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..core.tree import tree_map
from .attention import attention_block
from .layers import QuantSpec, remat
from .transformer import (_embed, _norm, _normal, ffn_apply, init_attention,
                          init_ffn, init_norm, layer_cache, lm_head_logits,
                          rank_heads, take_layer, write_new_kv)


def init_encdec(cfg: ModelConfig, g: torch.Generator, device) -> dict:
    """The JAX ``init_encdec`` tree (same keys, shapes and init scales);
    values come from ``g``, so parity tests carry JAX's arrays across."""
    d = cfg.d_model
    norm = lambda stacked: init_norm(d, stacked, device, cfg.norm)
    E, D = cfg.enc_layers, cfg.dec_layers
    return {
        "embed": _normal(g, (cfg.padded_vocab, d), device),
        "enc": {"ln1": norm(E), "attn": init_attention(g, cfg, E, device),
                "ln2": norm(E), "ffn": init_ffn(g, cfg, E, device)},
        "dec": {"ln1": norm(D), "self": init_attention(g, cfg, D, device),
                "ln2": norm(D), "cross": init_attention(g, cfg, D, device),
                "ln3": norm(D), "ffn": init_ffn(g, cfg, D, device)},
        "enc_norm": norm(None),
        "final_norm": norm(None),
        "lm_head": _normal(g, (d, cfg.padded_vocab), device),
    }


def _chunk(cfg: ModelConfig, S: int) -> int:
    return cfg.attn_chunk if S > cfg.attn_chunk_threshold else 0


def _enc_block(x, p, cfg: ModelConfig, spec: QuantSpec):
    a, _ = attention_block(
        _norm(x, p["ln1"], cfg.norm), p["attn"], **rank_heads(cfg, spec), spec=spec,
        causal=False, rope=cfg.rope, rope_theta=cfg.rope_theta,
        chunk=_chunk(cfg, x.shape[1]))
    x = x + a
    return x + ffn_apply(_norm(x, p["ln2"], cfg.norm), p["ffn"], cfg, spec)


def _dec_block(x, enc_out, p, cfg: ModelConfig, spec: QuantSpec, cache=None,
               want_taps: bool = False):
    """Self-attention (causal, over ``cache`` when given), cross-attention
    onto ``enc_out``, FFN. Returns (x, new_kv, taps)."""
    heads = rank_heads(cfg, spec)
    a, new_kv, *taps = attention_block(
        _norm(x, p["ln1"], cfg.norm), p["self"], **heads, spec=spec, causal=True,
        rope=cfg.rope, rope_theta=cfg.rope_theta, cache=cache,
        chunk=_chunk(cfg, x.shape[1]), want_taps=want_taps)
    x = x + a
    c, _ = attention_block(
        _norm(x, p["ln2"], cfg.norm), p["cross"], **heads, spec=spec, causal=False,
        rope=False, kv_input=enc_out)
    x = x + c
    x = x + ffn_apply(_norm(x, p["ln3"], cfg.norm), p["ffn"], cfg, spec)
    return x, new_kv, (taps[0] if taps else None)


def encode(params, cfg: ModelConfig, segments, src_embeds) -> torch.Tensor:
    """The encoder over ``src_embeds`` (B, S_src, d) at the first segment's
    spec, normed: the ``enc_out`` a decode step attends."""
    enc_spec = segments[0][2]
    groups = segments[0][2].groups
    dev = params["embed"].device
    h = torch.as_tensor(src_embeds, device=dev).to(cfg.torch_dtype)
    enc = params["enc"]
    n = enc["ln1"]["scale"].shape[0]         # a norm's stack: never cut
    for i in range(n):      # JAX checkpoints the encoder's body; FSDP's take
        # runs inside it, so it is recomputed too
        h = remat(cfg.remat, lambda h, i=i: _enc_block(
            h, take_layer(enc, i, n, groups), cfg, enc_spec), h)
    return _norm(h, params["enc_norm"], cfg.norm)


def encdec_forward(params, cfg: ModelConfig, segments, *, tokens,
                   src_embeds=None, enc_out=None, caches: Optional[dict] = None,
                   want_taps: bool = False, want_aux: bool = False):
    """Train / prefill: ``src_embeds`` + ``tokens``. Decode: ``tokens`` (B,
    1) + ``caches`` + ``enc_out``. Returns ``(logits, new_caches)``, then
    the last decoder layer's self-attention taps with ``want_taps`` and a
    0 load-balance loss with ``want_aux``. The caches are written in place;
    ``new_caches`` holds the same buffers and ``len + S``."""
    dev = params["embed"].device
    groups = segments[0][2].groups
    if enc_out is None:
        if src_embeds is None:
            raise ValueError("encdec_forward needs src_embeds (the encoder's "
                             "input) or enc_out (its output)")
        enc_out = encode(params, cfg, segments, src_embeds)
    else:
        enc_out = torch.as_tensor(enc_out, device=dev)
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    x = _embed(params, cfg, tokens, groups=groups)
    dec = params["dec"]
    presliced = isinstance(dec, (list, tuple))
    n_dec = None if presliced else dec["ln1"]["scale"].shape[0]
    last = segments[-1][1] - 1
    taps = None
    for si, (start, end, spec) in enumerate(segments):
        seg = dec[si] if presliced else None
        for i in range(end - start):
            j = start + i
            take = ((lambda i=i, seg=seg: tree_map(lambda a: a[i], seg)) if presliced
                    else (lambda j=j: take_layer(dec, j, n_dec, groups)))
            cache_l = None if caches is None else layer_cache(caches, j)
            tap = want_taps and j == last
            if tap or caches is not None:
                x, new_kv, t = _dec_block(x, enc_out, take(), cfg, spec,
                                          cache=cache_l, want_taps=tap)
            else:   # JAX checkpoints every decoder layer but the tapped one
                x, new_kv, t = remat(cfg.remat, lambda h, e, take=take, spec=spec:
                                     _dec_block(h, e, take(), cfg, spec), x, enc_out)
            if tap:
                taps = t
            if caches is not None:
                write_new_kv(caches, j, new_kv)
    new_caches = None
    if caches is not None:
        new_caches = {**caches, "len": caches["len"] + x.shape[1]}
    x = _norm(x, params["final_norm"], cfg.norm)
    logits = lm_head_logits(x, params["lm_head"], cfg, groups)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return ((logits, new_caches) + ((taps,) if want_taps else ())
            + ((aux,) if want_aux else ()))


def encdec_caches(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype, device) -> dict:
    """The fp decode cache over the decoder layers, a 0-d cursor."""
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    shape = (cfg.dec_layers, batch, max_len, cfg.num_kv_heads, cfg.hd)
    return {"k": z(shape, dtype), "v": z(shape, dtype), "len": z((), torch.int32)}
