"""MINI (MiniLM-style) distillation with scale factors (paper §4.2).

Last-layer-only self-attention relation distillation:

  L_attention = sum_a KL( A_a^S || A_a^T ),      A = softmax(q k^T / sqrt(d_r))
  L_value     = sum_a KL( VR_a^S || VR_a^T ),    VR = softmax(v v^T / sqrt(d_r))
  L_final     = L_train + alpha * L_output + beta * (L_attention + L_value)

Because only the LAST layer's q/k/v taps are used, the teacher may be deeper
than the student with no layer mapping. Teacher width/head-count mismatch is
handled MiniLM-v2 style: q/k/v are re-split into ``num_relation_heads``
before building relations, so only the relation-head count must agree.

For attention-free blocks the relation terms are inapplicable;
:func:`hidden_state_loss` is the documented substitute.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["kl_from_logits", "relation_distribution", "minilm_losses",
           "output_loss", "hidden_state_loss", "combine_losses"]

_NEG_INF = -1e9


def _masked_mean(d: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.mean(d)
    return torch.sum(d * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def kl_from_logits(p_logits: torch.Tensor, q_logits: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean KL(P || Q) over leading dims; distributions over the last axis."""
    p_log = torch.log_softmax(p_logits.to(torch.float32), dim=-1)
    q_log = torch.log_softmax(q_logits.to(torch.float32), dim=-1)
    kl = torch.sum(torch.exp(p_log) * (p_log - q_log), dim=-1)
    return _masked_mean(kl, mask)


def relation_distribution(a: torch.Tensor, b: torch.Tensor,
                          num_relation_heads: int,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Relation logits: (B, S, D) x (B, S, D) -> (B, R, S, S), to be
    softmax'd over keys.

    Splits the feature dim into R relation heads (MiniLM-v2) so
    student/teacher widths may differ as long as D is divisible by R on
    each side.
    """
    B, S, D = a.shape
    R = num_relation_heads
    if D % R:
        raise ValueError(f"feature dim {D} not divisible by relation heads {R}")
    dr = D // R
    ah = a.reshape(B, S, R, dr).transpose(1, 2)
    bh = b.reshape(B, S, R, dr).transpose(1, 2)
    # f32 sqrt of f32(dr), as jnp.sqrt(jnp.float32(dr)); a tensor divisor
    # keeps the IEEE division on the card
    root = torch.sqrt(torch.full((), float(dr), dtype=torch.float32,
                                 device=a.device))
    logits = torch.einsum("brsd,brtd->brst", ah, bh) / root
    if mask is not None:  # mask keys: (B, S) -> (B, 1, 1, S)
        logits = torch.where(mask[:, None, None, :] > 0, logits, _NEG_INF)
    return logits


def minilm_losses(taps_s: dict, taps_t: dict, num_relation_heads: int,
                  mask: Optional[torch.Tensor] = None):
    """(L_attention, L_value) from last-layer q/k/v taps {'q','k','v': (B,S,D)}."""
    qmask = None if mask is None else mask[:, None, :]
    R = num_relation_heads
    attn_s = relation_distribution(taps_s["q"], taps_s["k"], R, mask)
    attn_t = relation_distribution(taps_t["q"], taps_t["k"], R, mask)
    l_attn = kl_from_logits(attn_s, attn_t, qmask)
    val_s = relation_distribution(taps_s["v"], taps_s["v"], R, mask)
    val_t = relation_distribution(taps_t["v"], taps_t["v"], R, mask)
    l_val = kl_from_logits(val_s, val_t, qmask)
    return l_attn, l_val


def output_loss(logits_s: torch.Tensor, logits_t: torch.Tensor,
                kind: str = "mse", mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """L_output: MSE or KL on the network outputs (paper §3.3)."""
    if kind == "mse":
        d = torch.square(logits_s.to(torch.float32) - logits_t.to(torch.float32))
        return _masked_mean(torch.mean(d, dim=-1), mask)
    if kind == "kl":
        return kl_from_logits(logits_t, logits_s, mask)  # teacher as target dist
    raise ValueError(f"unknown output loss {kind!r}")


def hidden_state_loss(h_s: torch.Tensor, h_t: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Substitute relation loss for attention-free blocks."""
    d = torch.mean(torch.square(h_s.to(torch.float32) - h_t.to(torch.float32)), -1)
    return _masked_mean(d, mask)


def combine_losses(l_train, l_output, l_attn, l_value, alpha: float = 10.0,
                   beta: float = 1.0):
    """Paper eq. (10). Returns (L_final, dict of parts)."""
    total = l_train + alpha * l_output + beta * (l_attn + l_value)
    return total, {
        "loss/train": l_train, "loss/output": l_output,
        "loss/attention": l_attn, "loss/value": l_value, "loss/total": total,
    }

