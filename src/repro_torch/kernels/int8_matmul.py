"""int8 x int8 -> int32 matmul with the fused dequant epilogue.

Replaces ``src/repro/kernels/int8_matmul.py::int8_matmul_pallas`` (its
``pl.pallas_call`` at int8_matmul.py:59). CUDA source:
``csrc/int8_matmul.cu`` on the shared ``csrc/int_gemm.cuh``. Bound on H100
by bytes at the serving shapes (the f32 output dominates at large M, the
weights at decode's small M); the kernel keeps the int32 accumulator in
registers and writes each output once, dequantized, in the activations'
dtype (f32, or bf16 rounded to nearest even). Ragged M, N and K are masked in the kernel, so there are no
divisor tiles.
"""
from __future__ import annotations

import torch

from . import build

#: output dtypes of the integer GEMMs, by the flag their C entries take
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_out_dtype(out_dtype: torch.dtype) -> int:
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype: expected one of {list(OUT_DTYPES)}, "
                        f"got {out_dtype}")
    return OUT_DTYPES[out_dtype]


def int_matmul_exact(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (K, N) int8 -> int32, exact on any device: every
    product and partial sum is an integer below 127^2 * K << 2^53."""
    return (x8.to(torch.float64) @ w8.to(torch.float64)).to(torch.int32)


def int8_matmul_plain(x8: torch.Tensor, w8: torch.Tensor, s_a: torch.Tensor,
                      s_w: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version: ``(acc.f32 * (s_a * s_w)).to(out_dtype)`` with the
    product of the scales formed first, as the reference epilogue does."""
    build.note_plain(x8, "int8_matmul")
    return (int_matmul_exact(x8, w8).to(torch.float32)
            * (s_a * s_w)).to(out_dtype)


def int8_matmul_cuda(x8: torch.Tensor, w8: torch.Tensor, s_a: torch.Tensor,
                     s_w: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x8: (M, K) int8, w8: (K, N) int8, s_a: () f32, s_w: (1, N) f32;
    returns (M, N) ``out_dtype`` (f32 or bf16)."""
    flag = check_out_dtype(out_dtype)
    dev = x8.device
    M, K = x8.shape
    N = w8.shape[1]
    build.check(x8, "x8", torch.int8, (M, K), dev)
    build.check(w8, "w8", torch.int8, (K, N), dev)
    build.check(s_a, "s_a", torch.float32, (), dev)
    build.check(s_w, "s_w", torch.float32, (1, N), dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if out.numel():
        build.launch("int8_matmul", dev, x8.data_ptr(), w8.data_ptr(),
                     s_a.data_ptr(), s_w.data_ptr(), out.data_ptr(), M, N, K,
                     flag)
    return out
