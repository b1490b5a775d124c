"""Dispatch layer for the kernels (shapes, padding, device choice).

``qlinear`` lands here when its ``QuantSpec.use_kernels`` is set, and the
quantized-cache branch of ``attention_block`` for one-token decode steps. A
tensor on the card goes to the hand-written CUDA kernel, a tensor on the CPU
to the kernel's plain PyTorch version, and nothing else decides between them.
Activation codes are quantized before every matmul; the kernels mask their
ragged edges, so no divisor tiles are picked here.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .act_quant import act_quant_cuda, act_quant_plain
from .decode_attention import decode_attention_cuda, decode_attention_plain
from .int4_matmul import (int4_matmul_cuda, int4_matmul_fused_cuda,
                          int4_matmul_fused_plain, int4_matmul_plain)
from .int8_matmul import int8_matmul_cuda, int8_matmul_plain


def act_quant(x: torch.Tensor, s: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """(..., K) float -> (..., K) int8 codes on the ``bits`` grid."""
    K = x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    fn = act_quant_cuda if x2.is_cuda else act_quant_plain
    return fn(x2, s, bits).reshape(*x.shape[:-1], K)


def int8_matmul(x: torch.Tensor, w8: torch.Tensor, s_a: torch.Tensor,
                s_w: torch.Tensor, a_bits: int = 8) -> torch.Tensor:
    """x: (M, K) float -> quantize -> int8 GEMM -> dequant to x.dtype.
    w8: (K, N) int8."""
    x8 = act_quant(x, s_a, bits=a_bits)
    s_w = s_w.reshape(1, w8.shape[1]).contiguous()
    fn = int8_matmul_cuda if x8.is_cuda else int8_matmul_plain
    return fn(x8, w8, s_a, s_w, out_dtype=x.dtype)


def int4_matmul(x: torch.Tensor, wp: torch.Tensor, s_a: torch.Tensor,
                s_w: torch.Tensor, a_bits: int = 8,
                bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None) -> torch.Tensor:
    """x: (M, K) float; wp: (K/2, N) packed nibbles. Returns x.dtype.

    ``act`` selects the fused kernel: dequant + bias + activation in its
    epilogue, one write of the (M, N) result instead of three. With ``act``
    set, ``bias`` (or zeros) is folded in as well.
    """
    x8 = act_quant(x, s_a, bits=a_bits)
    K, N = x8.shape[1], wp.shape[1]
    if wp.shape[0] * 2 != K:  # packing padded K to even; pad x to match
        x8 = F.pad(x8, (0, wp.shape[0] * 2 - K))
    s_w = s_w.reshape(1, N).contiguous()
    on_card = x8.is_cuda
    if act is not None:
        b = (torch.zeros((1, N), dtype=torch.float32, device=x8.device)
             if bias is None else bias.reshape(1, N).to(torch.float32).contiguous())
        fn = int4_matmul_fused_cuda if on_card else int4_matmul_fused_plain
        return fn(x8, wp, s_a, s_w, b, act, out_dtype=x.dtype)
    fn = int4_matmul_cuda if on_card else int4_matmul_plain
    return fn(x8, wp, s_a, s_w, out_dtype=x.dtype)


def decode_attention(q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor,
                     k_scale: torch.Tensor, v_scale: torch.Tensor,
                     k_new: torch.Tensor, v_new: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over a quantized KV cache: q (B, H, dh), ONE new
    token per slot; k_q/v_q (B, S, Hkv, dhp) codes; k_scale/v_scale
    (B, S, Hkv); k_new/v_new (B, Hkv, dh); lengths a scalar or (B,) cursor
    tensor. Returns (B, H, dh) in q's dtype."""
    B = q.shape[0]
    lens = lengths.to(torch.int32).reshape(-1).expand(B).contiguous()
    fn = decode_attention_cuda if q.is_cuda else decode_attention_plain
    return fn(q.contiguous(), k_q.contiguous(), v_q.contiguous(),
              k_scale.contiguous(), v_scale.contiguous(), k_new.contiguous(),
              v_new.contiguous(), lens)
