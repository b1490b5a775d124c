"""Multi-head attention, cacheless (encoder) branch.

All projections route through ``qlinear`` (quantizable per the MKQ policy);
the scores and the softmax stay in fp32 (paper §5). This is plain PyTorch:
the JAX package computes it outside any Pallas kernel too. The KV-cache
decode branches arrive with the decode serving slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from .layers import QuantSpec, qlinear

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


def attention_block(x: torch.Tensor, p: dict, *, n_heads: int, n_kv: int,
                    hd: int, spec: QuantSpec, causal: bool = True,
                    rope: bool = False,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One cacheless attention sublayer (the residual is the caller's).

    kv_len: (B,) per-row valid lengths; keys at or past a row's length are
    masked before the softmax, which keeps bucket-padded bidirectional
    (encoder) rows independent of their zero tail.
    """
    if rope:
        raise NotImplementedError("RoPE families arrive with a later slice")
    B, Sq, _ = x.shape
    q = _split_heads(qlinear(x, p["wq"], spec), n_heads)
    k = _split_heads(qlinear(x, p["wk"], spec), n_kv)
    v = _split_heads(qlinear(x, p["wv"], spec), n_kv)
    groups = n_heads // n_kv
    out = full_attention(q, _repeat_kv(k, groups), _repeat_kv(v, groups),
                         causal=causal,
                         kv_len=None if kv_len is None else kv_len.reshape(-1, 1, 1, 1))
    out = out.reshape(B, Sq, n_heads * hd)
    return qlinear(out, p["wo"], spec)
