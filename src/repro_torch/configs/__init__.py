"""Architecture registry of the port (bert family)."""
from __future__ import annotations

from .archs import ARCHS
from .base import ModelConfig


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ModelConfig", "get_config"]
