"""Architecture registry of the port (bert and dense decoder families)
plus ``reduced``, the CPU-sized variant of a config."""
from __future__ import annotations

import dataclasses

from .archs import ARCHS
from .base import ModelConfig


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: same family and wiring, tiny dims (the JAX
    package's ``configs.reduced`` for the families the port serves)."""
    if cfg.family not in ("dense", "bert"):
        raise ValueError(f"reduced(): family {cfg.family!r} is not served by "
                         "the port yet")
    kw = dict(
        num_layers=4, d_model=64, num_heads=4, head_dim=16, d_ff=128,
        vocab_size=256, dtype="float32", remat=False,
        attn_chunk_threshold=64, attn_chunk=32, ssm_chunk=8,
        moe_group_size=16,
    )
    kw["num_kv_heads"] = (min(cfg.num_kv_heads, 4)
                          if cfg.num_kv_heads < cfg.num_heads else 4)
    return dataclasses.replace(cfg, **kw)


__all__ = ["ARCHS", "ModelConfig", "get_config", "reduced"]
