"""int8 x int8 -> int32 matmul with the fused dequant epilogue.

Replaces ``src/repro/kernels/int8_matmul.py::int8_matmul_pallas`` (its
``pl.pallas_call`` at int8_matmul.py:59). CUDA source:
``csrc/int8_matmul.cu``, whose C entry runs one of three paths that
:func:`.gemm_plan.gemm_plan` picks from the shapes: split-K for M <= 64
(``csrc/int_gemm_splitk.cuh``; the decode step, bound by the weight's
bytes), which takes the f32 or bf16 activations and quantizes them as it
loads them, so the decode step runs no act_quant; wgmma with a TMA ring for
M >= 128 (``csrc/int_gemm_wgmma.cuh``; the long forwards and the prefill,
bound by operations), which reads the codes at a row pitch that is a
multiple of 16; and the first design's 64 x 64 ``mma.sync`` tiles for the
rest (``csrc/int_gemm.cuh``; the encoder's N = 312). Each keeps the int32
accumulator exact and writes each output once, dequantized, in the
activations' dtype (f32, or bf16 rounded to nearest even), bit-equal to the
plain version. Ragged M, N and K are masked in the kernels, so there are
no divisor tiles.
"""
from __future__ import annotations

import torch

from ..core.packing import unpack_int4
from ..core.quantizer import qrange, quantize_to_int
from . import build
from .gemm_plan import PATH_SPLITK, GemmPlan, code_pitch, gemm_plan

#: output dtypes of the integer GEMMs, by the flag their C entries take
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: what the GEMMs' C entries take as activations, by the kind they name it:
#: int8 codes, or f32 / bf16 values that split-K quantizes as it loads them
IN_KINDS = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


def check_out_dtype(out_dtype: torch.dtype) -> int:
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype: expected one of {list(OUT_DTYPES)}, "
                        f"got {out_dtype}")
    return OUT_DTYPES[out_dtype]


def int_matmul_exact(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (..., K, N) int8 -> int32 (batched over the leading
    dims as ``torch.matmul`` broadcasts), exact on any device: every
    product and partial sum is an integer below 127^2 * K << 2^53."""
    return (x8.to(torch.float64) @ w8.to(torch.float64)).to(torch.int32)


def expert_matmul_exact(x: torch.Tensor, wq: torch.Tensor, s_a: torch.Tensor,
                        s_w: torch.Tensor, w_bits: int, a_bits: int) -> torch.Tensor:
    """The deployed integer product over experts, all at once: x (E, C, K)
    float, wq (E, K, N) int8 codes or (E, K/2, N) packed nibbles, s_a (E, 1,
    1), s_w (E, 1, N). Each expert's activations are quantized with its own
    scale, the int32 accumulator is exact (:func:`int_matmul_exact`, batched)
    and the epilogue is ``(acc.f32 * (s_a * s_w)).to(x.dtype)``, the JAX
    package's ``_expert_matmul`` in its order. The plain integer path of
    every backend on the CPU and of the reference backend on the card."""
    w8 = unpack_int4(wq, axis=-2) if w_bits == 4 else wq
    K = x.shape[-1]
    if w8.shape[-2] != K:          # int4 packing padded K to even
        w8 = w8.narrow(-2, 0, K)
    acc = int_matmul_exact(quantize_to_int(x, s_a, a_bits), w8)
    return (acc.to(torch.float32) * (s_a * s_w)).to(x.dtype)


def int8_matmul_plain(x8: torch.Tensor, w8: torch.Tensor, s_a: torch.Tensor,
                      s_w: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version: ``(acc.f32 * (s_a * s_w)).to(out_dtype)`` with the
    product of the scales formed first, as the reference epilogue does."""
    build.note_plain(x8, "int8_matmul")
    return (int_matmul_exact(x8, w8).to(torch.float32)
            * (s_a * s_w)).to(out_dtype)


def workspace(plan, device: torch.device) -> torch.Tensor:
    """The split-K partials' int32 workspace of ``plan`` (written whole by
    the kernel before it is read; a placeholder for the other paths)."""
    return torch.empty((max(plan.ws_bytes // 4, 4),), dtype=torch.int32,
                       device=device)


def gemm_input(x: torch.Tensor, plan: GemmPlan, K: int) -> tuple[torch.Tensor, int, int]:
    """``x`` as ``plan``'s path reads it, with its row pitch and its kind
    (:data:`IN_KINDS`). int8 codes come at :func:`.gemm_plan.code_pitch`
    (``ops`` has ``act_quant`` write them there; codes at another pitch are
    copied into a buffer of that pitch). f32 or bf16 activations go to the
    split-K path only, which quantizes them as it loads them; they must be
    contiguous. Either is copied to a fresh buffer when a storage offset
    leaves it off the 16-byte boundary the kernels' vector loads and TMA
    need."""
    M, device = x.shape[0], x.device
    if x.dtype not in IN_KINDS:
        raise TypeError(f"x: expected one of {list(IN_KINDS)}, got {x.dtype}")
    kind = IN_KINDS[x.dtype]
    if kind:
        build.check(x, "x", x.dtype, (M, K), device)
        if plan.path != PATH_SPLITK:
            raise ValueError(f"x: {x.dtype} activations are quantized inside the GEMM "
                             f"on the split-K path only, not the {plan.name} path of "
                             f"M={M}; quantize them with act_quant first")
        if x.data_ptr() % 16:
            x = x.clone()
        return x, K, kind
    build.check(x, "x", torch.int8, (M, K), device, contiguous=False)
    pitch = code_pitch(plan, K)
    if M and (x.stride(0) != pitch or x.data_ptr() % 16):
        buf = torch.empty((M, pitch), dtype=torch.int8, device=device)
        buf[:, :K].copy_(x)
        x = buf[:, :K]
    return x, pitch, kind


def int8_matmul_cuda(x: torch.Tensor, w8: torch.Tensor, s_a: torch.Tensor,
                     s_w: torch.Tensor, out_dtype: torch.dtype = torch.float32,
                     a_bits: int = 8) -> torch.Tensor:
    """x: (M, K) int8 codes, or f32 / bf16 activations where the plan is
    split-K (quantized with ``s_a`` on the ``a_bits`` grid inside the
    GEMM); w8: (K, N) int8, s_a: () f32, s_w: (1, N) f32; returns (M, N)
    ``out_dtype`` (f32 or bf16)."""
    flag = check_out_dtype(out_dtype)
    dev = x.device
    M, K = x.shape
    N = w8.shape[1]
    plan = gemm_plan(M, N, K, 8)
    x, lda, kind = gemm_input(x, plan, K)
    build.check(w8, "w8", torch.int8, (K, N), dev)
    build.check(s_a, "s_a", torch.float32, (), dev)
    build.check(s_w, "s_w", torch.float32, (1, N), dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if out.numel():
        ws = workspace(plan, dev)
        qmin, qmax = qrange(a_bits)
        build.launch("int8_matmul", dev, x.data_ptr(), w8.data_ptr(),
                     s_a.data_ptr(), s_w.data_ptr(), out.data_ptr(),
                     ws.data_ptr(), M, N, K, flag, plan.path, plan.splits,
                     plan.kc, lda, kind, qmin, qmax)
    return out
