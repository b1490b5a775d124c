"""Activation quantization: f32 or bf16 (M, K) -> int8 codes on the qrange grid.

Replaces ``src/repro/kernels/act_quant.py::act_quant_pallas`` (its
``pl.pallas_call`` at act_quant.py:42). CUDA source: ``csrc/act_quant.cu``,
whose arithmetic (``csrc/quant.cuh``) the split-K GEMM also runs as it
loads its activations, so a GEMM on that path needs no act_quant launch
(``gemm_plan.quantizes_in_gemm``). Bound on H100 by bytes (f32 or bf16 in,
int8 out); the kernel makes one pass with 16- or 8-byte loads and masks the
ragged end itself, so there is no pad-and-slice as in the TPU wrapper. It
can write the codes at a row pitch wider than K (the wgmma GEMM's TMA rows
are a multiple of 16 bytes). bf16 inputs widen to f32 before the division,
as the reference's ``astype(f32)`` does.
"""
from __future__ import annotations

from typing import Optional

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


def act_quant_cuda(x: torch.Tensor, s: torch.Tensor, bits: int = 8,
                   pitch: Optional[int] = None) -> torch.Tensor:
    """x: (M, K) f32 or bf16 on the card, s: per-tensor f32 scale (device
    tensor). ``pitch`` (>= K, default K): the codes' row pitch; the result
    is the (M, K) view of an (M, pitch) buffer whose pad bytes are never
    written."""
    dev = x.device
    M, K = x.shape
    pitch = K if pitch is None else pitch
    if x.dtype not in IN_DTYPES:
        raise TypeError(f"x: expected one of {list(IN_DTYPES)}, got {x.dtype}")
    build.check(x, "x", x.dtype, (M, K), dev)
    build.check(s, "s", torch.float32, tuple(s.shape), dev)
    if s.numel() != 1:
        raise ValueError(f"s: expected a per-tensor scale, got shape {tuple(s.shape)}")
    if pitch < K:
        raise ValueError(f"pitch: expected at least K = {K}, got {pitch}")
    qmin, qmax = qrange(bits)
    out = torch.empty((M, pitch), dtype=torch.int8, device=dev)
    if out.numel():
        build.launch("act_quant", dev, x.data_ptr(), s.data_ptr(),
                     out.data_ptr(), M, K, pitch, qmin, qmax, IN_DTYPES[x.dtype])
    return out[:, :K]
