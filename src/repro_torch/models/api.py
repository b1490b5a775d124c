"""Family-dispatching model API: init / forward / decode state.

``forward(params, plan, state=..., tokens=...) -> (logits, new_state)``
for the transformer families the port serves (dense decoders, and the bert
stack as an LM). The JAX package's ``forward`` also returns taps and an aux
loss, which belong to the QAT and MoE slices. Families without a KV slot
cache (xlstm, hybrid, encdec), MoE and the vlm inputs raise a
``ValueError`` that names the slice they arrive with.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from . import transformer

#: families whose forward and decode state this slice of the port serves
FAMILIES = ("dense", "bert")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"family {cfg.family!r}: the port serves {FAMILIES} so far; "
            "moe, vlm and the token-mode families (xlstm, hybrid, encdec) "
            "arrive with the other-families slice")


def init_model(cfg: ModelConfig, g: torch.Generator, device) -> dict:
    """fp params on ``device`` drawn from ``g`` (the JAX tree's keys and
    shapes)."""
    _check_family(cfg)
    return transformer.init_lm(cfg, g, device)


def forward(params, plan, *, state: Optional[dict] = None, tokens):
    """One forward under ``plan`` (an ``ExecutionPlan``): logits (B, S,
    padded_vocab) and the decode state advanced by S tokens (updated in
    place; None without a state)."""
    _check_family(plan.cfg)
    return transformer.lm_forward(params, plan.cfg, plan.segments,
                                  tokens=tokens, caches=state)


def decode_state(cfg: ModelConfig, batch: int, max_len: int,
                 dtype: torch.dtype = torch.bfloat16, *,
                 per_slot_len: bool = False, kv_bits: Optional[int] = None,
                 device=None) -> dict:
    """The KV cache of ``batch`` rows of ``max_len`` positions on
    ``device``: fp rows in ``dtype`` at kv_bits 16, the packed quantized
    layout at 8/4 (``None`` follows ``cfg.kv_bits``). ``per_slot_len``
    gives a (batch,) cursor vector so a serving slot table refills slots
    independently. Serving callers use ``plan.decode_state``, so cache,
    prefill and decode share the plan's one decode dtype."""
    _check_family(cfg)
    kv_bits = cfg.kv_bits if kv_bits is None else kv_bits
    return transformer.lm_caches(cfg, batch, max_len, dtype,
                                 per_slot_len=per_slot_len, kv_bits=kv_bits,
                                 device=device)
