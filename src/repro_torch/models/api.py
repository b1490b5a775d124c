"""Family-dispatching model API: init / forward / decode state.

``forward(params, plan, state=..., tokens=..., patch_embeds=...,
patch_mask=..., src_embeds=..., enc_out=...) -> (logits, new_state)`` for
every family the port serves: dense decoders, MoE decoders, the vlm with
its patch-embedding stub, the bert stack as an LM, the encoder-decoder
(``src_embeds`` for the encoder, or its output ``enc_out`` in a decode
step, ``decode_extra_inputs``), the Mamba2 hybrid and xLSTM.
``want_taps=True`` adds the last layer's taps (xLSTM's: ``{'hidden'}``, the
stack's output) and ``want_aux=True`` then the MoE load-balance loss (0 for
the other families), the JAX package's ``forward`` returning both always.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import encdec, hybrid, transformer, xlstm

#: families whose forward and decode state the port serves (every family of
#: the JAX package's registry)
FAMILIES = ("dense", "bert", "vlm", "moe", "hybrid", "encdec", "xlstm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r}: the port serves {FAMILIES}")


def init_model(cfg: ModelConfig, g: torch.Generator, device) -> dict:
    """fp params on ``device`` drawn from ``g`` (the JAX tree's keys and
    shapes)."""
    _check_family(cfg)
    if cfg.family == "xlstm":
        return xlstm.init_xlstm(cfg, g, device)
    if cfg.family == "hybrid":
        return hybrid.init_hybrid(cfg, g, device)
    if cfg.family == "encdec":
        return encdec.init_encdec(cfg, g, device)
    return transformer.init_lm(cfg, g, device)


def forward(params, plan, *, state: Optional[dict] = None, tokens,
            patch_embeds=None, patch_mask=None, src_embeds=None, enc_out=None,
            want_taps: bool = False, want_aux: bool = False):
    """One forward under ``plan`` (an ``ExecutionPlan``): logits (B, S,
    padded_vocab) and the decode state advanced by S tokens (updated in
    place; None without a state). vlm inputs: ``patch_embeds`` (B, P, d)
    placed at the True positions of ``patch_mask`` (B, S); encdec inputs:
    ``src_embeds`` (B, S_src, d) or, in a decode step, ``enc_out``.
    ``want_taps`` adds the last layer's taps for distillation, ``want_aux``
    then the summed MoE load-balance loss (a 0-d f32 tensor)."""
    cfg = plan.cfg
    _check_family(cfg)
    kw = dict(want_taps=want_taps, want_aux=want_aux)
    if cfg.family == "xlstm":
        return xlstm.xlstm_forward(params, cfg, plan.segments, tokens=tokens,
                                   states=state, **kw)
    if cfg.family == "hybrid":
        return hybrid.hybrid_forward(params, cfg, plan.segments, tokens=tokens,
                                     states=state, **kw)
    if cfg.family == "encdec":
        return encdec.encdec_forward(params, cfg, plan.segments, tokens=tokens,
                                     src_embeds=src_embeds, enc_out=enc_out,
                                     caches=state, **kw)
    return transformer.lm_forward(params, cfg, plan.segments,
                                  tokens=tokens, patch_embeds=patch_embeds,
                                  patch_mask=patch_mask, caches=state, **kw)


def decode_state(cfg: ModelConfig, batch: int, max_len: int,
                 dtype: torch.dtype = torch.bfloat16, *,
                 per_slot_len: bool = False, kv_bits: Optional[int] = None,
                 device=None, kv_heads: Optional[int] = None) -> dict:
    """The KV cache of ``batch`` rows of ``max_len`` positions on
    ``device``: fp rows in ``dtype`` at kv_bits 16, the packed quantized
    layout at 8/4 (``None`` follows ``cfg.kv_bits``). ``per_slot_len``
    gives a (batch,) cursor vector so a serving slot table refills slots
    independently. ``kv_heads`` is the number of KV heads held (a
    tensor-parallel rank's share; default all). Serving callers use
    ``plan.decode_state``, so cache, prefill and decode share the plan's
    one decode dtype and head share. The token-mode families keep an fp
    state with one 0-d cursor (``per_slot_len`` and kv_bits 8/4 raise, as
    in the JAX package): the hybrid's Mamba2 states and shared-block KV,
    the encoder-decoder's decoder KV; xLSTM's recurrent state is f32
    whatever ``dtype`` and holds no positions (``max_len`` is unused)."""
    _check_family(cfg)
    from ..deploy.plan import validate_cache_layout
    kv_bits = cfg.kv_bits if kv_bits is None else kv_bits
    validate_cache_layout(cfg, per_slot_len=per_slot_len, kv_bits=kv_bits)
    if cfg.family == "xlstm":
        return xlstm.xlstm_states(cfg, batch, device)
    if cfg.family == "hybrid":
        return hybrid.hybrid_states(cfg, batch, max_len, dtype, device)
    if cfg.family == "encdec":
        return encdec.encdec_caches(cfg, batch, max_len, dtype, device)
    return transformer.lm_caches(cfg, batch, max_len, dtype,
                                 per_slot_len=per_slot_len, kv_bits=kv_bits,
                                 device=device, kv_heads=kv_heads)


def decode_extra_inputs(cfg: ModelConfig, batch: int, src_len: int,
                        dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """A family's extra decode inputs, zeros on ``device`` (the card unless
    the caller asks for the CPU): the encoder-decoder's ``enc_out`` (batch,
    src_len, d_model), which a caller fills with the encoder's output
    (``encdec.encode``); nothing for the other families."""
    _check_family(cfg)
    if cfg.family != "encdec":
        return {}
    dev = resolve_device(device)
    return {"enc_out": torch.zeros((batch, src_len, cfg.d_model), dtype=dtype,
                                   device=dev)}
