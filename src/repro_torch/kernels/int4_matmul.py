"""Packed-int4 weight matmul, plain and with the fused bias + activation
epilogue (the paper's deployed W4A4 layer).

Replaces ``src/repro/kernels/int4_matmul.py::int4_matmul_pallas`` (its
``pl.pallas_call`` at int4_matmul.py:105) and ``int4_matmul_fused_pallas``
(at int4_matmul.py:143). CUDA source: ``csrc/int4_matmul.cu`` on the shared
``csrc/int_gemm.cuh``. Weights are (K/2, N) bytes holding two codes along
K; the kernel unpacks them to int8 in shared memory (Hopper's tensor cores
have no int4 rate). Bound on H100 by bytes at the serving shapes; the fused
kernel writes its (M, N) output once instead of three times.
"""
from __future__ import annotations

import torch

from . import build
from .int8_matmul import check_out_dtype, int_matmul_exact
from .kv_pack import INT4_BIAS, unpack_nibbles_rows

__all__ = ["INT4_BIAS", "EPILOGUE_ACTS", "gelu_tanh", "apply_epilogue",
           "int4_matmul_plain", "int4_matmul_fused_plain", "int4_matmul_cuda",
           "int4_matmul_fused_cuda"]

#: fused activations, by the code the CUDA entry takes
EPILOGUE_ACTS = {"none": 0, "gelu": 1, "relu": 2}


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` in its own operation order; the
    fused CUDA epilogue evaluates the same expression, one rounding per
    operation."""
    cdf = 0.5 * (1.0 + torch.tanh(0.7978845608028654
                                  * (x + 0.044715 * (x * x * x))))
    return x * cdf


def apply_epilogue(r: torch.Tensor, act: str) -> torch.Tensor:
    """f32 epilogue activation; mirrors ``models.layers.act_fn``."""
    if act == "none":
        return r
    if act == "gelu":
        return gelu_tanh(r)
    if act == "relu":
        return torch.clamp_min(r, 0.0)
    raise ValueError(f"unsupported fused activation {act!r}")


def int4_matmul_plain(x8: torch.Tensor, wp: torch.Tensor, s_a: torch.Tensor,
                      s_w: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version: unpack the nibbles, exact int matmul, dequant, cast."""
    build.note_plain(x8, "int4_matmul")
    acc = int_matmul_exact(x8, unpack_nibbles_rows(wp))
    return (acc.to(torch.float32) * (s_a * s_w)).to(out_dtype)


def int4_matmul_fused_plain(x8: torch.Tensor, wp: torch.Tensor,
                            s_a: torch.Tensor, s_w: torch.Tensor,
                            bias: torch.Tensor, act: str = "none",
                            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the fused kernel: dequant, ``+ bias``, activation,
    all in f32, then one cast to ``out_dtype``."""
    build.note_plain(x8, "int4_matmul_fused")
    acc = int_matmul_exact(x8, unpack_nibbles_rows(wp))
    r = acc.to(torch.float32) * (s_a * s_w)
    return apply_epilogue(r + bias, act).to(out_dtype)


def _check_operands(x8, wp, s_a, s_w):
    dev = x8.device
    M, K = x8.shape
    Kp, N = wp.shape
    if Kp * 2 != K:
        raise ValueError(f"packed weights cover K={2 * Kp}, activations K={K}")
    build.check(x8, "x8", torch.int8, (M, K), dev)
    build.check(wp, "wp", torch.uint8, (Kp, N), dev)
    build.check(s_a, "s_a", torch.float32, (), dev)
    build.check(s_w, "s_w", torch.float32, (1, N), dev)
    return dev, M, N, K


def int4_matmul_cuda(x8: torch.Tensor, wp: torch.Tensor, s_a: torch.Tensor,
                     s_w: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x8: (M, K) int8 codes, wp: (K/2, N) uint8, s_a: () f32, s_w: (1, N);
    returns (M, N) ``out_dtype`` (f32 or bf16)."""
    flag = check_out_dtype(out_dtype)
    dev, M, N, K = _check_operands(x8, wp, s_a, s_w)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if out.numel():
        build.launch("int4_matmul", dev, x8.data_ptr(), wp.data_ptr(),
                     s_a.data_ptr(), s_w.data_ptr(), out.data_ptr(), M, N, K,
                     flag)
    return out


def int4_matmul_fused_cuda(x8: torch.Tensor, wp: torch.Tensor,
                           s_a: torch.Tensor, s_w: torch.Tensor,
                           bias: torch.Tensor, act: str = "none",
                           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """As :func:`int4_matmul_cuda` plus ``bias: (1, N) f32`` and ``act``."""
    if act not in EPILOGUE_ACTS:
        raise ValueError(f"unsupported fused activation {act!r}")
    flag = check_out_dtype(out_dtype)
    dev, M, N, K = _check_operands(x8, wp, s_a, s_w)
    build.check(bias, "bias", torch.float32, (1, N), dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if out.numel():
        build.launch("int4_matmul_fused", dev, x8.data_ptr(), wp.data_ptr(),
                     s_a.data_ptr(), s_w.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), M, N, K, EPILOGUE_ACTS[act], flag)
    return out
