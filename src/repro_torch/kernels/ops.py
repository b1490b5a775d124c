"""Dispatch layer for the kernels (shapes, padding, device choice).

``qlinear`` lands here when its ``QuantSpec.use_kernels`` is set, and so
do the MoE experts' integer products (:func:`expert_matmul`), the
quantized-cache branch of ``attention_block`` for one-token decode steps,
and ``chunked_attention`` (the cacheless branch of long forwards). A
tensor on the card goes to the hand-written CUDA kernel, a tensor on the CPU
to the kernel's plain PyTorch version, and nothing else decides between them.
On the CPU, activation codes are quantized before every matmul. On the
card, a GEMM whose plan is split-K (``gemm_plan.quantizes_in_gemm``: M <=
64, the decode step) takes the float activations and quantizes them as it
loads them, with act_quant's arithmetic; every other GEMM gets act_quant's
codes at the row pitch its path reads (``gemm_plan.code_pitch``). The
kernels mask their ragged edges, so no divisor tiles are picked here.

A tensor on the ``meta`` device (the step analysis, ``launch/op_analysis``)
takes a third branch: it charges the kernel launches the card would make
for these shapes, each as one op with the bytes and operations its bound
reckons, to every recorder in :data:`ANALYSIS`, and returns an empty meta
result of the kernel's shape and dtype. It computes nothing and is no
fallback: a CUDA tensor still reaches only its kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import decode_attention as _da
from . import flash_attention as _fa
from .act_quant import act_quant_cuda, act_quant_plain
from .decode_attention import (decode_attention_cuda,
                               decode_attention_paged_cuda,
                               decode_attention_paged_plain,
                               decode_attention_plain)
from .flash_attention import (TILE, flash_attention_cuda,
                              flash_attention_plain)
from .gemm_plan import code_pitch, gemm_plan, quantizes_in_gemm
from .int4_matmul import (int4_matmul_cuda, int4_matmul_fused_cuda,
                          int4_matmul_fused_plain, int4_matmul_plain)
from .int8_matmul import (expert_matmul_exact, int8_matmul_cuda,
                          int8_matmul_plain)


#: recorders of the meta branch: each is called, once a launch the card
#: would make, as ``rec(kernel, nbytes=..., dot_flops=..., integer=...)``
ANALYSIS: list = []


def _charge(kernel: str, nbytes: float, dot_flops: float = 0.0,
            integer: bool = False) -> None:
    for rec in ANALYSIS:
        rec(kernel, nbytes=nbytes, dot_flops=dot_flops, integer=integer)


def _gemm_bytes(M: int, N: int, K: int, bits: int, x_itemsize: int) -> int:
    """Bytes one GEMM call must move: the activations (the float rows where
    the call quantizes them itself, else the int8 codes), the weight codes
    (K / 2 packed rows at 4 bits), the scales and the output (x's dtype)."""
    quantized = quantizes_in_gemm(M, N, K, bits)
    w = -(-K // 2) * N if bits == 4 else K * N
    return M * K * (x_itemsize if quantized else 1) + w + 4 + 4 * N + M * N * x_itemsize


def _act_quant_bytes(M: int, K: int, x_itemsize: int) -> int:
    """Bytes one act_quant call must move: the float rows, one code a value,
    the scale."""
    return M * K * (x_itemsize + 1) + 4


def _meta_gemm(x: torch.Tensor, N: int, K: int, bits: int, kernel: str) -> torch.Tensor:
    """The meta branch of a GEMM: act_quant where the plan does not
    quantize inside the GEMM, then the GEMM, each charged as one launch."""
    M = x.shape[0]
    if not quantizes_in_gemm(M, N, K, bits):
        _charge("act_quant", _act_quant_bytes(M, K, x.element_size()))
    _charge(kernel, _gemm_bytes(M, N, K, bits, x.element_size()), 2.0 * M * N * K,
            integer=True)
    return torch.empty((M, N), dtype=x.dtype, device="meta")


def act_quant(x: torch.Tensor, s: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """(..., K) float -> (..., K) int8 codes on the ``bits`` grid."""
    K = x.shape[-1]
    if x.is_meta:
        _charge("act_quant", _act_quant_bytes(x.numel() // max(K, 1), K,
                                              x.element_size()))
        return torch.empty(x.shape, dtype=torch.int8, device="meta")
    x2 = x.reshape(-1, K).contiguous()
    fn = act_quant_cuda if x2.is_cuda else act_quant_plain
    return fn(x2, s, bits).reshape(*x.shape[:-1], K)


def gemm_activations(x: torch.Tensor, N: int, K: int, bits: int, s_a: torch.Tensor,
                     a_bits: int) -> torch.Tensor:
    """What the card's (M, K) x (K, N) GEMM with ``bits``-bit weights takes
    for the activations ``x``: ``x`` itself where the GEMM quantizes as it
    loads (split-K), else act_quant's codes at the row pitch of the plan's
    path. Decided from the shapes alone."""
    M = x.shape[0]
    if quantizes_in_gemm(M, N, K, bits):
        return x
    return act_quant_cuda(x, s_a, a_bits, pitch=code_pitch(gemm_plan(M, N, K, bits), K))


def int8_matmul(x: torch.Tensor, w8: torch.Tensor, s_a: torch.Tensor,
                s_w: torch.Tensor, a_bits: int = 8) -> torch.Tensor:
    """x: (M, K) float -> quantize -> int8 GEMM -> dequant to x.dtype.
    w8: (K, N) int8."""
    K, N = w8.shape
    if x.is_meta:
        return _meta_gemm(x, N, K, 8, "int8_matmul")
    s_w = s_w.reshape(1, N).contiguous()
    if x.is_cuda:
        return int8_matmul_cuda(gemm_activations(x.contiguous(), N, K, 8, s_a, a_bits),
                                w8, s_a, s_w, out_dtype=x.dtype, a_bits=a_bits)
    x8 = act_quant(x, s_a, bits=a_bits)
    return int8_matmul_plain(x8, w8, s_a, s_w, out_dtype=x.dtype)


def int4_matmul(x: torch.Tensor, wp: torch.Tensor, s_a: torch.Tensor,
                s_w: torch.Tensor, a_bits: int = 8,
                bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None) -> torch.Tensor:
    """x: (M, K) float; wp: (K/2, N) packed nibbles. Returns x.dtype.

    ``act`` selects the fused kernel: dequant + bias + activation in its
    epilogue, one write of the (M, N) result instead of three. With ``act``
    set, ``bias`` (or zeros) is folded in as well.
    """
    Kw, N = wp.shape[0] * 2, wp.shape[1]
    if x.is_meta:
        return _meta_gemm(x, N, Kw, 4, "int4_matmul" if act is None
                          else "int4_matmul_fused")
    s_w = s_w.reshape(1, N).contiguous()
    b = None
    if act is not None:
        b = (torch.zeros((1, N), dtype=torch.float32, device=x.device)
             if bias is None else bias.reshape(1, N).to(torch.float32).contiguous())
    if x.is_cuda:
        xk = x if x.shape[1] == Kw else F.pad(x, (0, Kw - x.shape[1]))  # packing padded K
        xk = gemm_activations(xk.contiguous(), N, Kw, 4, s_a, a_bits)
        if act is not None:
            return int4_matmul_fused_cuda(xk, wp, s_a, s_w, b, act, out_dtype=x.dtype,
                                          a_bits=a_bits)
        return int4_matmul_cuda(xk, wp, s_a, s_w, out_dtype=x.dtype, a_bits=a_bits)
    x8 = act_quant(x, s_a, bits=a_bits)
    if x8.shape[1] != Kw:  # packing padded K to even; pad the codes to match
        x8 = F.pad(x8, (0, Kw - x8.shape[1]))
    if act is not None:
        return int4_matmul_fused_plain(x8, wp, s_a, s_w, b, act, out_dtype=x.dtype)
    return int4_matmul_plain(x8, wp, s_a, s_w, out_dtype=x.dtype)


def expert_matmul(x_ecd: torch.Tensor, p: dict, spec,
                  reduce: bool = False) -> torch.Tensor:
    """The deployed integer product over MoE experts: x (E, C, K) float @
    each expert's weight codes ``p['wq']`` ((E, K, N) int8, or (E, K/2, N)
    packed nibbles at ``spec.w_bits`` 4), with its own activation scale
    ``p['s_a'][e]`` ((E, 1, 1)) and weight scales ``p['s_w'][e]`` ((E, 1,
    N)); returns (E, C, N) in x's dtype.

    On the card, one :func:`int8_matmul` / :func:`int4_matmul` call per
    expert, each at the full capacity C (empty slots included: skipping an
    expert would need a host read of the counts, and the decode step stays
    capturable in a CUDA graph), each handed that expert's scalar scale, so
    a split-K GEMM quantizes inside with it. On the CPU, the exact batched
    product (``expert_matmul_exact``): the same bits. ``reduce`` sums a
    row-parallel weight's int32 partials over the tensor-parallel ranks,
    which only the plain path does (the kernels are single-device)."""
    if not spec.a_bits:
        raise ValueError("expert_matmul: the integer kernels take activation "
                         "codes; a_bits=0 (fp activations) is the reference "
                         "backend's path")
    if not (x_ecd.is_cuda or x_ecd.is_meta):
        return expert_matmul_exact(x_ecd, p["wq"], p["s_a"], p["s_w"],
                                   spec.w_bits, spec.a_bits, reduce=reduce)
    if reduce:
        raise ValueError("expert_matmul: a tensor-parallel row-parallel sum "
                         "runs on the plain integer path only (backend "
                         "'reference')")
    E = x_ecd.shape[0]
    x_ecd = x_ecd.contiguous()
    s_a = p["s_a"].reshape(E)                  # views: expert e's scalar ...
    s_w = p["s_w"]                             # ... and its (1, N) row
    gemm = int4_matmul if spec.w_bits == 4 else int8_matmul
    return torch.stack([gemm(x_ecd[e], p["wq"][e], s_a[e], s_w[e], a_bits=spec.a_bits)
                        for e in range(E)])


def decode_attention(q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor,
                     k_scale: torch.Tensor, v_scale: torch.Tensor,
                     k_new: torch.Tensor, v_new: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over a quantized KV cache: q (B, H, dh), ONE new
    token per slot; k_q/v_q (B, S, Hkv, dhp) codes; k_scale/v_scale
    (B, S, Hkv); k_new/v_new (B, Hkv, dh); lengths a scalar or (B,) cursor
    tensor. Returns (B, H, dh) in q's dtype."""
    B = q.shape[0]
    if q.is_meta:       # the lengths are data: charge the whole extent
        H, dh = q.shape[1], q.shape[2]
        S, Hkv = k_q.shape[1], k_q.shape[2]
        bits = 8 if k_q.shape[-1] == dh else 4
        _charge("decode_attention", _da.bound_bytes(B, S, Hkv, H, dh, bits, [S] * B,
                                                    q.element_size()),
                4.0 * B * H * (S + 1) * dh)
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    lens = lengths.to(torch.int32).reshape(-1).expand(B).contiguous()
    fn = decode_attention_cuda if q.is_cuda else decode_attention_plain
    return fn(q.contiguous(), k_q.contiguous(), v_q.contiguous(),
              k_scale.contiguous(), v_scale.contiguous(), k_new.contiguous(),
              v_new.contiguous(), lens)


def decode_attention_paged(q: torch.Tensor, k_q: torch.Tensor,
                           v_q: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, tables: torch.Tensor,
                           k_new: torch.Tensor, v_new: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention straight from one layer of a block pool: q (B, H,
    dh), ONE new token per slot; k_q/v_q (NB, block, Hkv, dhp) codes;
    k_scale/v_scale (NB, block, Hkv); tables (B, nb) block ids (out-of-range
    entries clamp); k_new/v_new (B, Hkv, dh); lengths (B,). Returns (B, H,
    dh) in q's dtype."""
    B = q.shape[0]
    if q.is_meta:       # the lengths are data: charge the tables' extent
        H, dh = q.shape[1], q.shape[2]
        block, Hkv, nb = k_q.shape[1], k_q.shape[2], tables.shape[1]
        bits = 8 if k_q.shape[-1] == dh else 4
        _charge("decode_attention_paged",
                _da.bound_bytes_paged(B, nb, block, Hkv, H, dh, bits,
                                      [nb * block] * B, q.element_size()),
                4.0 * B * H * (nb * block + 1) * dh)
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    lens = lengths.to(torch.int32).reshape(-1).expand(B).contiguous()
    fn = decode_attention_paged_cuda if q.is_cuda else decode_attention_paged_plain
    return fn(q.contiguous(), k_q.contiguous(), v_q.contiguous(),
              k_scale.contiguous(), v_scale.contiguous(),
              tables.to(torch.int32).contiguous(), k_new.contiguous(),
              v_new.contiguous(), lens)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """Forward attention: q (B, S, H, dh), k/v (B, S, Hkv, dh) with H % Hkv
    == 0, unrepeated (query head h reads KV head h // (H // Hkv)). Returns
    (B, S, H, dh) in q's dtype. On the CPU the plain version runs at the
    kernel's tile, or at the largest divisor of S below it."""
    if q.is_meta:
        B, S, H, dh = q.shape
        _charge("flash_attention", _fa.bound_bytes(B, S, H, k.shape[2], dh,
                                                   q.element_size()),
                _fa.bound_flops(B, S, H, dh, causal))
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal)
    blk = math.gcd(q.shape[1], TILE)
    return flash_attention_plain(q, k, v, causal=causal, bq=blk, bk=blk)
