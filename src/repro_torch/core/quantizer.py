"""Deploy-time half of the LSQ quantizer (paper §4.1):

  Q[x] = s * round(clamp(x / s, l_min, l_max)),   l_min = -2^{k-1}+1, l_max = 2^{k-1}

``torch.round`` rounds half to even, as ``jnp.round`` does, so integer codes
are bit-identical to the JAX package's. The trainable ``lsq_quantize`` /
``fake_quant`` arrive with the QAT slice.
"""
from __future__ import annotations

import torch

__all__ = ["qrange", "quantize_to_int", "dequantize"]


def qrange(bits: int) -> tuple[int, int]:
    """Clamp bounds. Paper: l_min = -2^{k-1}+1, l_max = 2^{k-1} (k=4: [-7, 8]).

    For k=8 the paper's l_max = 128 cannot live in the int8 deployment carrier
    (it wraps to -128), so the 8-bit grid is [-127, 127]; k=4 keeps the
    paper's exact asymmetric grid.
    """
    if bits >= 8:
        return -(2 ** (bits - 1)) + 1, 2 ** (bits - 1) - 1
    return -(2 ** (bits - 1)) + 1, 2 ** (bits - 1)


def quantize_to_int(x: torch.Tensor, s: torch.Tensor, bits: int) -> torch.Tensor:
    """Deploy-time quantization to int8-carried codes on the qrange grid.

    ``s`` must be a tensor on ``x``'s device: a Python-float divisor on a
    CUDA tensor is turned into a multiply by its reciprocal by PyTorch,
    which is not the IEEE division the reference performs."""
    qmin, qmax = qrange(bits)
    z = torch.round(torch.clamp(x.to(torch.float32) / s, qmin, qmax))
    return z.to(torch.int8)


def dequantize(q: torch.Tensor, s: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * s).to(dtype)
