"""Packed-int4 weight matmul, plain and with the fused bias + activation
epilogue (the paper's deployed W4A4 layer).

Replaces ``src/repro/kernels/int4_matmul.py::int4_matmul_pallas`` (its
``pl.pallas_call`` at int4_matmul.py:105) and ``int4_matmul_fused_pallas``
(at int4_matmul.py:143). CUDA source: ``csrc/int4_matmul.cu`` on the shared
``csrc/int_gemm*.cuh``. Weights are (K/2, N) bytes holding two codes along
K; the kernels unpack them to int8 on the way to the tensor cores
(Hopper's have no int4 rate). Both entries take the path
:func:`.gemm_plan.gemm_plan` picks, as ``int8_matmul`` does, with the
epilogue (scale; or + bias and none / GELU / ReLU) as a template parameter
of each: split-K for M <= 64 (the decode step and a short encoder batch,
bound by the packed weight's bytes; it quantizes f32 or bf16 activations
as it loads them), wgmma with a TMA ring for M >= 128 and N % 16 == 0 (the
long forwards, the prefill, the encoder's FFN-up at K = 312 with its codes
at a pitch of 320), the 64 x 64 ``mma.sync`` tiles for the rest. The fused
kernel (the encoder's FFN-up layer) writes its (M, N) output once instead
of three times.
"""
from __future__ import annotations

import torch

from ..core.quantizer import qrange
from . import build
from .gemm_plan import gemm_plan
from .int8_matmul import check_out_dtype, gemm_input, int_matmul_exact, workspace
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


def _launch(name: str, x, wp, s_a, s_w, bias, out_dtype, a_bits, extra=()):
    """Check the operands, take the plan's path and launch entry ``name``:
    ``x`` (M, K) int8 codes, or f32 / bf16 activations where the plan is
    split-K, ``wp`` (K/2, N) uint8, ``s_a`` () f32, ``s_w`` (1, N) f32,
    ``bias`` (1, N) f32 or None; ``extra``: the entry's arguments between
    K and the dtype flag."""
    flag = check_out_dtype(out_dtype)
    dev = x.device
    M, K = x.shape
    Kp, N = wp.shape
    if Kp * 2 != K:
        raise ValueError(f"packed weights cover K={2 * Kp}, activations K={K}")
    plan = gemm_plan(M, N, K, 4)
    x, lda, kind = gemm_input(x, plan, K)
    build.check(wp, "wp", torch.uint8, (Kp, N), dev)
    build.check(s_a, "s_a", torch.float32, (), dev)
    build.check(s_w, "s_w", torch.float32, (1, N), dev)
    if bias is not None:
        build.check(bias, "bias", torch.float32, (1, N), dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if out.numel():
        ws = workspace(plan, dev)
        qmin, qmax = qrange(a_bits)
        head = (x.data_ptr(), wp.data_ptr(), s_a.data_ptr(), s_w.data_ptr())
        if bias is not None:
            head += (bias.data_ptr(),)
        build.launch(name, dev, *head, out.data_ptr(), ws.data_ptr(), M, N, K,
                     *extra, flag, plan.path, plan.splits, plan.kc, lda, kind,
                     qmin, qmax)
    return out


def int4_matmul_cuda(x: torch.Tensor, wp: torch.Tensor, s_a: torch.Tensor,
                     s_w: torch.Tensor, out_dtype: torch.dtype = torch.float32,
                     a_bits: int = 8) -> torch.Tensor:
    """x: (M, K) int8 codes, or f32 / bf16 activations where the plan is
    split-K (quantized with ``s_a`` on the ``a_bits`` grid inside the
    GEMM); wp: (K/2, N) uint8, s_a: () f32, s_w: (1, N); returns (M, N)
    ``out_dtype`` (f32 or bf16)."""
    return _launch("int4_matmul", x, wp, s_a, s_w, None, out_dtype, a_bits)


def int4_matmul_fused_cuda(x: torch.Tensor, wp: torch.Tensor,
                           s_a: torch.Tensor, s_w: torch.Tensor,
                           bias: torch.Tensor, act: str = "none",
                           out_dtype: torch.dtype = torch.float32,
                           a_bits: int = 8) -> torch.Tensor:
    """As :func:`int4_matmul_cuda` plus ``bias: (1, N) f32`` and ``act``."""
    if act not in EPILOGUE_ACTS:
        raise ValueError(f"unsupported fused activation {act!r}")
    return _launch("int4_matmul_fused", x, wp, s_a, s_w, bias, out_dtype, a_bits,
                   extra=(EPILOGUE_ACTS[act],))
