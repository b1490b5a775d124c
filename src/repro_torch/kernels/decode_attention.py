"""One-token decode attention over a quantized (int8 / packed int4) KV cache.

Replaces ``src/repro/kernels/decode_attention.py::decode_attention_pallas``
(its ``pl.pallas_call`` at decode_attention.py:102). CUDA source:
``csrc/decode_attention.cu``. Bound on H100 by bytes: a decode step reads
each slot's codes and scales once, a quarter (int8) or an eighth (int4) of
an f32 cache. The kernel dequantizes blocks of 32 rows in shared memory
inside an online softmax, so neither the dequantized cache nor the (B, S)
score matrix exists in device memory; the current token's fp K/V are folded
in after the loop (it attends itself at full precision).
"""
from __future__ import annotations

import torch

from . import build
from .kv_pack import dequantize_kv

NEG_INF = -2.0e38

#: q / k_new / v_new / output dtypes, by the flag the C entry takes
IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's limits (one block per (KV head, slot) holds G x dh floats)
MAX_HEAD_DIM = 128
MAX_GROUP = 8


def _scale(dh: int) -> float:
    """1/sqrt(dh) as the reference forms it: in double, then f32."""
    return 1.0 / float(dh) ** 0.5


def decode_attention_plain(q: torch.Tensor, k_q: torch.Tensor,
                           v_q: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Plain version: dequantize the cache to f32, one softmax over
    [cache masked to ``lengths`` ; new token], cast to ``q.dtype``.
    Shapes as :func:`decode_attention_cuda`."""
    build.note_plain(q, "decode_attention")
    B, H, dh = q.shape
    S, Hkv = k_q.shape[1], k_q.shape[2]
    g = H // Hkv
    qf = q.to(torch.float32) * torch.full((), _scale(dh), dtype=torch.float32,
                                          device=q.device)
    qg = qf.reshape(B, Hkv, g, dh)
    k = dequantize_kv(k_q, k_scale)                    # (B, S, Hkv, dh) f32
    v = dequantize_kv(v_q, v_scale)
    s1 = torch.einsum("bhgd,bshd->bhgs", qg, k)
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] < lengths.to(torch.int64).reshape(B, 1)
    s1 = torch.where(valid[:, None, None, :], s1, NEG_INF)
    kn = k_new.to(torch.float32)
    vn = v_new.to(torch.float32)
    s2 = torch.einsum("bhgd,bhd->bhg", qg, kn)[..., None]
    p = torch.softmax(torch.cat([s1, s2], dim=-1), dim=-1)
    out = (torch.einsum("bhgs,bshd->bhgd", p[..., :S], v)
           + p[..., S:] * vn[:, :, None, :])
    return out.reshape(B, H, dh).to(q.dtype)


def decode_attention_cuda(q: torch.Tensor, k_q: torch.Tensor,
                          v_q: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, dh) f32 or bf16; k_q/v_q: (B, S, Hkv, dhp) int8 (dhp = dh)
    or uint8 nibbles (dhp = dh/2); k_scale/v_scale: (B, S, Hkv) f32;
    k_new/v_new: (B, Hkv, dh) in q's dtype; lengths: (B,) int32. Returns
    (B, H, dh) in q's dtype."""
    dev = q.device
    if q.dim() != 3 or k_q.dim() != 4:
        raise ValueError(f"q must be (B, H, dh) and k_q (B, S, Hkv, dhp), got "
                         f"{tuple(q.shape)} and {tuple(k_q.shape)}")
    B, H, dh = q.shape
    S, Hkv, dhp = k_q.shape[1], k_q.shape[2], k_q.shape[3]
    if q.dtype not in IN_DTYPES:
        raise TypeError(f"q: expected one of {list(IN_DTYPES)}, got {q.dtype}")
    if k_q.dtype == torch.int8:
        bits, want_dhp = 8, dh
    elif k_q.dtype == torch.uint8:
        bits, want_dhp = 4, dh // 2
    else:
        raise TypeError(f"k_q: expected int8 or uint8 codes, got {k_q.dtype}")
    if dhp != want_dhp or (bits == 4 and dh % 2):
        raise ValueError(f"k_q: head_dim extent {dhp} does not fit dh={dh} "
                         f"at {bits} bits")
    if H % Hkv or H // Hkv > MAX_GROUP or dh > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention kernel takes H % Hkv == 0, "
                         f"H/Hkv <= {MAX_GROUP}, dh <= {MAX_HEAD_DIM}; got "
                         f"H={H}, Hkv={Hkv}, dh={dh}")
    build.check(q, "q", q.dtype, (B, H, dh), dev)
    build.check(k_q, "k_q", k_q.dtype, (B, S, Hkv, dhp), dev)
    build.check(v_q, "v_q", k_q.dtype, (B, S, Hkv, dhp), dev)
    build.check(k_scale, "k_scale", torch.float32, (B, S, Hkv), dev)
    build.check(v_scale, "v_scale", torch.float32, (B, S, Hkv), dev)
    build.check(k_new, "k_new", q.dtype, (B, Hkv, dh), dev)
    build.check(v_new, "v_new", q.dtype, (B, Hkv, dh), dev)
    build.check(lengths, "lengths", torch.int32, (B,), dev)
    out = torch.empty((B, H, dh), dtype=q.dtype, device=dev)
    if out.numel():
        build.launch("decode_attention", dev, q.data_ptr(), k_q.data_ptr(),
                     v_q.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                     k_new.data_ptr(), v_new.data_ptr(), lengths.data_ptr(),
                     out.data_ptr(), B, S, H, Hkv, dh, bits,
                     IN_DTYPES[q.dtype], _scale(dh))
    return out


def bound_bytes(B: int, S: int, Hkv: int, H: int, dh: int, bits: int,
                lengths, elem_bytes: int) -> int:
    """Bytes one call must move: each slot's min(len, S) code rows and
    scales of K and V, q and the new K/V, the lengths, and the output."""
    dhp = dh if bits == 8 else dh // 2
    rows = sum(min(max(int(n), 0), S) for n in lengths)
    cache = 2 * rows * Hkv * (dhp + 4)
    return (cache + B * H * dh * elem_bytes * 2 + 2 * B * Hkv * dh * elem_bytes
            + 4 * B)


__all__ = ["NEG_INF", "decode_attention_plain", "decode_attention_cuda",
           "bound_bytes", "MAX_HEAD_DIM", "MAX_GROUP"]
