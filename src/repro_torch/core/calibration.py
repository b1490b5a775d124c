"""Activation calibration hook (paper §3.1, following Q8BERT).

Activations: run a few forward batches, collect |a| statistics, and set
s = (top-0.01% largest |a|) / l_max, i.e. the 99.99th percentile. During
``calibration_mode`` every quantizable matmul reports its input's |a|
percentile here, in call order; ``core.qat`` maps the stream back onto the
``s_a`` leaves by the per-family site order.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["PERCENTILE_DEFAULT", "calibration_mode", "active", "record_input"]

PERCENTILE_DEFAULT = 99.99  # "top 0.01% largest value"

_COLLECTOR: Optional["calibration_mode"] = None


class calibration_mode:
    """Context manager enabling activation-stat collection."""

    def __init__(self, percentile: float = PERCENTILE_DEFAULT):
        self.percentile = percentile
        self.records: list[np.ndarray] = []

    def __enter__(self):
        global _COLLECTOR
        if _COLLECTOR is not None:
            raise RuntimeError("nested calibration_mode")
        _COLLECTOR = self
        return self

    def __exit__(self, *exc):
        global _COLLECTOR
        _COLLECTOR = None
        return False


def active() -> bool:
    return _COLLECTOR is not None


def record_input(x: torch.Tensor) -> None:
    """Record percentile(|x|) over the whole input."""
    if _COLLECTOR is None:
        return
    a = np.abs(x.detach().to("cpu", torch.float32).numpy())
    stat = np.percentile(a.reshape(-1), _COLLECTOR.percentile)
    _COLLECTOR.records.append(np.asarray(stat, np.float32))
