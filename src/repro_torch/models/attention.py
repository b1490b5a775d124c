"""GQA multi-head attention: cacheless (encoder, prefill) and KV-cache decode.

All projections route through ``qlinear`` (quantizable per the MKQ policy);
the scores and the softmax stay in fp32 (paper §5). The cacheless and the
fp-cache branches are plain PyTorch, as the JAX package computes them
outside any Pallas kernel. One-token decode steps over a quantized cache
under a kernel plan go through ``ops.decode_attention`` (the hand-written
decode-attention kernel); every other quantized-cache step dequantizes and
attends in PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch

from .layers import QuantSpec, apply_rope, qlinear, rope_tables

NEG_INF = -2.0e38


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, n, -1)


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def full_attention(q, k, v, *, causal: bool,
                   kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,Sq,H,dh), k/v: (B,Skv,H,dh) -> (B,Sq,H,dh). fp32 softmax.

    ``kv_len`` broadcasts against (B, H, Sq, Skv): keys at or past it are
    set to ``NEG_INF`` before the softmax."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    # a tensor divisor (made by a fill, no host copy): PyTorch turns a
    # Python-float divisor on the card into a multiply by its reciprocal
    scores = scores / torch.sqrt(torch.full((), float(dh), dtype=torch.float32,
                                            device=scores.device))
    Sq, Skv = q.shape[1], k.shape[1]
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(Skv, device=q.device)[None, :]
        scores = torch.where((ki <= qi)[None, None], scores, NEG_INF)
    if kv_len is not None:  # mask key positions beyond each row's length
        valid = torch.arange(Skv, device=q.device)[None, None, None, :] < kv_len
        scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def cached_decode_attention(q, k_cache, v_cache, k_new, v_new, length):
    """Decode attention: q (B,Sq,H,dh) over cache (B,Smax,H,dh) masked to
    ``length`` plus the Sq new tokens (causal among themselves), fp32
    softmax. ``length`` is a 0-d tensor (one cursor) or (B,) per-slot
    lengths: each serving slot masks its own prefix of the cache."""
    B, Sq, H, dh = q.shape
    Smax = k_cache.shape[1]
    scale = 1.0 / torch.sqrt(torch.full((), float(dh), dtype=torch.float32,
                                        device=q.device))
    s1 = torch.einsum("bqhd,bkhd->bhqk", q, k_cache).to(torch.float32) * scale
    lb = length.reshape(-1, 1, 1, 1) if length.dim() else length
    valid = torch.arange(Smax, device=q.device)[None, None, None, :] < lb
    s1 = torch.where(valid, s1, NEG_INF)
    s2 = torch.einsum("bqhd,bkhd->bhqk", q, k_new).to(torch.float32) * scale
    if Sq > 1:
        qi = torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(Sq, device=q.device)[None, :]
        s2 = torch.where((ki <= qi)[None, None], s2, NEG_INF)
    s = torch.softmax(torch.cat([s1, s2], dim=-1), dim=-1)
    p1, p2 = s[..., :Smax].to(q.dtype), s[..., Smax:].to(q.dtype)
    return (torch.einsum("bhqk,bkhd->bqhd", p1, v_cache)
            + torch.einsum("bhqk,bkhd->bqhd", p2, v_new))


def attention_block(x: torch.Tensor, p: dict, *, n_heads: int, n_kv: int,
                    hd: int, spec: QuantSpec, causal: bool = True,
                    rope: bool = False, rope_theta: float = 10000.0,
                    cache: Optional[dict] = None,
                    kv_len: Optional[torch.Tensor] = None):
    """One attention sublayer (the residual is the caller's). Returns
    ``(out, new_kv)``.

    cache: one layer's decode cache, fp ``{'k', 'v', 'len'}`` or quantized
        ``{'k_q', 'v_q', 'k_scale', 'v_scale', 'len'}``; ``len`` is a 0-d
        cursor or (B,) per-slot lengths. With a cache the new tokens sit at
        positions ``len ...`` and attend the cache masked to ``len`` plus
        themselves; ``new_kv`` is their (k, v), which the caller writes
        (quantizing on append), so a token attends itself at full precision.
    kv_len: (B,) per-row valid lengths for the cacheless path: keys at or
        past a row's length are masked before the softmax, which keeps
        bucket-padded bidirectional (encoder) rows independent of their
        zero tail.
    """
    B, Sq, _ = x.shape
    q = _split_heads(qlinear(x, p["wq"], spec), n_heads)
    k = _split_heads(qlinear(x, p["wk"], spec), n_kv)
    v = _split_heads(qlinear(x, p["wv"], spec), n_kv)
    if rope:
        positions = torch.arange(Sq, device=x.device)[None, :]
        if cache is not None:
            off = cache["len"]
            positions = positions + (off[:, None] if off.dim() else off)
        cos, sin = rope_tables(positions, hd, rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    groups = n_heads // n_kv
    new_kv = None
    if cache is not None and "k_q" in cache:
        if spec.use_kernels and Sq == 1:
            from ..kernels import ops as kops
            out = kops.decode_attention(
                q[:, 0], cache["k_q"], cache["v_q"], cache["k_scale"],
                cache["v_scale"], k[:, 0], v[:, 0], cache["len"])[:, None]
        else:
            from ..kernels.kv_pack import dequantize_kv
            kk_c = _repeat_kv(dequantize_kv(cache["k_q"], cache["k_scale"],
                                            q.dtype), groups)
            vv_c = _repeat_kv(dequantize_kv(cache["v_q"], cache["v_scale"],
                                            q.dtype), groups)
            out = cached_decode_attention(q, kk_c, vv_c, _repeat_kv(k, groups),
                                          _repeat_kv(v, groups), cache["len"])
        new_kv = (k, v)
    elif cache is not None:
        out = cached_decode_attention(
            q, _repeat_kv(cache["k"].to(q.dtype), groups),
            _repeat_kv(cache["v"].to(q.dtype), groups),
            _repeat_kv(k, groups), _repeat_kv(v, groups), cache["len"])
        new_kv = (k, v)
    else:
        out = full_attention(q, _repeat_kv(k, groups), _repeat_kv(v, groups),
                             causal=causal,
                             kv_len=(None if kv_len is None
                                     else kv_len.reshape(-1, 1, 1, 1)))
    out = out.reshape(B, Sq, n_heads * hd)
    return qlinear(out, p["wo"], spec), new_kv
