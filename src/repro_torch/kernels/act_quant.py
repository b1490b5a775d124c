"""Activation quantization: f32 or bf16 (M, K) -> int8 codes on the qrange grid.

Replaces ``src/repro/kernels/act_quant.py::act_quant_pallas`` (its
``pl.pallas_call`` at act_quant.py:42). CUDA source: ``csrc/act_quant.cu``.
Bound on H100 by bytes (f32 or bf16 in, int8 out); the kernel makes one
pass with 16- or 8-byte loads and masks the ragged end itself, so there is
no pad-and-slice as in the TPU wrapper. bf16 inputs widen to f32 before the
division, as the reference's ``astype(f32)`` does.
"""
from __future__ import annotations

import torch

from ..core.quantizer import qrange
from . import build


def act_quant_plain(x: torch.Tensor, s: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Plain version: ``clip(round(x / s), qmin, qmax)`` as int8."""
    build.note_plain(x, "act_quant")
    qmin, qmax = qrange(bits)
    z = torch.clamp(torch.round(x.to(torch.float32) / s), qmin, qmax)
    return z.to(torch.int8)


#: activation dtypes the kernel reads, by the flag its C entry takes
IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def act_quant_cuda(x: torch.Tensor, s: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """x: (M, K) f32 or bf16 on the card, s: per-tensor f32 scale (device
    tensor)."""
    dev = x.device
    M, K = x.shape
    if x.dtype not in IN_DTYPES:
        raise TypeError(f"x: expected one of {list(IN_DTYPES)}, got {x.dtype}")
    build.check(x, "x", x.dtype, (M, K), dev)
    build.check(s, "s", torch.float32, tuple(s.shape), dev)
    if s.numel() != 1:
        raise ValueError(f"s: expected a per-tensor scale, got shape {tuple(s.shape)}")
    qmin, qmax = qrange(bits)
    out = torch.empty((M, K), dtype=torch.int8, device=dev)
    if out.numel():
        build.launch("act_quant", dev, x.data_ptr(), s.data_ptr(),
                     out.data_ptr(), M, K, qmin, qmax, IN_DTYPES[x.dtype])
    return out
