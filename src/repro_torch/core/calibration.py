"""Calibration: initial quantization scales (paper §3.1, following Q8BERT).

* Weights: s = max|w| / l_max, per-tensor or per-row (per output channel).
* Activations: run a few forward batches, collect |a| statistics, and set
  s = (top-0.01% largest |a|) / l_max, i.e. the 99.99th percentile.

During ``calibration_mode`` every quantizable matmul reports its input's
|a| percentile here, in call order; ``core.qat`` maps the stream back onto
the ``s_a`` leaves by the per-family site order. ``ActCalibrator`` is the
streaming estimator: a seeded uniform subsample per batch plus the running
max, the percentile taken over the reservoir at finalize (max-clamped),
deterministic across runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .quantizer import qrange

__all__ = ["weight_scale", "ActCalibrator", "PERCENTILE_DEFAULT",
           "calibration_mode", "active", "record_input"]

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


def _abs_numpy(x) -> np.ndarray:
    return np.abs(torch.as_tensor(x).detach().to("cpu", torch.float32).numpy())


def record_input(x: torch.Tensor, per_axis0: bool = False) -> None:
    """Record percentile(|x|); per_axis0 keeps the leading (expert) axis."""
    if _COLLECTOR is None:
        return
    a = _abs_numpy(x)
    if per_axis0:
        stat = np.percentile(a.reshape(a.shape[0], -1), _COLLECTOR.percentile,
                             axis=1)
    else:
        stat = np.percentile(a.reshape(-1), _COLLECTOR.percentile)
    _COLLECTOR.records.append(np.asarray(stat, np.float32))


def weight_scale(w: torch.Tensor, bits: int,
                 axis: Optional[int] = None) -> torch.Tensor:
    """abs-max weight scale; ``axis`` is the kept (per-channel) axis,
    None = per-tensor."""
    _, qmax = qrange(bits)
    if axis is None:
        s = torch.amax(torch.abs(w))
    else:
        axis = axis % w.dim()
        red = tuple(i for i in range(w.dim()) if i != axis)
        s = torch.amax(torch.abs(w), dim=red, keepdim=True)
    qmax_t = torch.full((), float(qmax), dtype=s.dtype, device=s.device)
    return torch.clamp_min(s / qmax_t, 1e-8).to(torch.float32)


@dataclasses.dataclass
class ActCalibrator:
    """Streaming |activation| percentile estimator (one per quantized
    activation)."""

    percentile: float = PERCENTILE_DEFAULT
    samples_per_batch: int = 4096
    seed: int = 0

    def __post_init__(self):
        self._chunks: list[np.ndarray] = []
        self._absmax = 0.0
        self._step = 0

    def update(self, a) -> None:
        flat = _abs_numpy(a).reshape(-1)
        self._absmax = max(self._absmax, float(flat.max(initial=0.0)))
        if flat.size > self.samples_per_batch:
            rng = np.random.default_rng(self.seed + self._step)
            flat = rng.choice(flat, size=self.samples_per_batch, replace=False)
        self._chunks.append(flat)
        self._step += 1

    def scale(self, bits: int) -> torch.Tensor:
        """Finalize: s = percentile(|a|) / l_max (clamped to the running
        max), a 0-d f32 tensor on the CPU."""
        _, qmax = qrange(bits)
        if not self._chunks:
            return torch.tensor(1.0, dtype=torch.float32)
        sample = np.concatenate(self._chunks)
        p = float(np.percentile(sample, self.percentile))
        p = min(max(p, 1e-8), self._absmax if self._absmax > 0 else p)
        return torch.tensor(np.float32(p / qmax))
