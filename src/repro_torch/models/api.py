"""Family-dispatching model API: init / forward / decode state.

``forward(params, plan, state=..., tokens=..., patch_embeds=...,
patch_mask=...) -> (logits, new_state)`` for the transformer families the
port serves (dense decoders, MoE decoders, the vlm with its
patch-embedding stub, and the bert stack as an LM); ``want_taps=True``
adds the last layer's q/k/v taps and ``want_aux=True`` then the MoE
load-balance loss (0 for the other families), the JAX package's ``forward``
returning both always. Families without a KV slot cache (xlstm, hybrid,
encdec) raise a ``ValueError`` that names the slice they arrive with.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from . import transformer

#: families whose forward and decode state this slice of the port serves
FAMILIES = ("dense", "bert", "vlm", "moe")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"family {cfg.family!r}: the port serves {FAMILIES} so far; "
            "the token-mode families (xlstm, hybrid, encdec) arrive with "
            "a later slice")


def init_model(cfg: ModelConfig, g: torch.Generator, device) -> dict:
    """fp params on ``device`` drawn from ``g`` (the JAX tree's keys and
    shapes)."""
    _check_family(cfg)
    return transformer.init_lm(cfg, g, device)


def forward(params, plan, *, state: Optional[dict] = None, tokens,
            patch_embeds=None, patch_mask=None, want_taps: bool = False,
            want_aux: bool = False):
    """One forward under ``plan`` (an ``ExecutionPlan``): logits (B, S,
    padded_vocab) and the decode state advanced by S tokens (updated in
    place; None without a state). vlm inputs: ``patch_embeds`` (B, P, d)
    placed at the True positions of ``patch_mask`` (B, S). ``want_taps``
    adds the last layer's q/k/v for distillation, ``want_aux`` then the
    summed MoE load-balance loss (a 0-d f32 tensor)."""
    _check_family(plan.cfg)
    return transformer.lm_forward(params, plan.cfg, plan.segments,
                                  tokens=tokens, patch_embeds=patch_embeds,
                                  patch_mask=patch_mask, caches=state,
                                  want_taps=want_taps, want_aux=want_aux)


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
    one decode dtype and head share."""
    _check_family(cfg)
    kv_bits = cfg.kv_bits if kv_bits is None else kv_bits
    return transformer.lm_caches(cfg, batch, max_len, dtype,
                                 per_slot_len=per_slot_len, kv_bits=kv_bits,
                                 device=device, kv_heads=kv_heads)
