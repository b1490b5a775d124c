"""Gradient compression for the data-parallel mean, the counterpart of the
JAX package's ``distributed/compression.py``, over a ``torch.distributed``
process group (gloo on the CPU, NCCL on the cards).

* ``none``: the plain mean (sum over the ranks, divided by their count).
* ``bf16``: reduce in bfloat16, half the wire bytes of f32 and no state,
  then cast back.
* ``int8_ef``: int8 codes with error feedback: ``t = g + e``; one scale
  shared by every rank, ``s = max(max_ranks |t|max / 127, 1e-12)``; codes
  ``q = clip(round(t / s), -127, 127)``; an int32 sum of the codes; the
  residual ``e' = t - q s`` carried to the next step, so the compression
  error is compensated rather than accumulated.

Each returns the mean gradient over the group, as the uncompressed
reduction does, and the error state (``None`` unless ``int8_ef``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..core.tree import tree_map

__all__ = ["compressed_grad_mean", "METHODS"]

METHODS = ("none", "bf16", "int8_ef")


def _zip_map(fn, a, b):
    """``fn`` over the leaves of two trees of one structure (dicts and
    lists); returns the trees of its two outputs."""
    if isinstance(a, dict):
        pairs = {k: _zip_map(fn, a[k], b[k]) for k in a}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    if isinstance(a, (list, tuple)):
        pairs = [_zip_map(fn, x, y) for x, y in zip(a, b)]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    return fn(a, b)


def compressed_grad_mean(grads, group=None, method: str = "bf16",
                         error_state: Optional[dict] = None):
    """Mean-reduce ``grads`` (a tree of tensors, every rank's of the same
    structure) over ``group`` (None: the default group) with compression.
    Returns ``(mean_grads, new_error_state)``; the inputs are not
    modified."""
    if method not in METHODS:
        raise ValueError(f"unknown compression {method!r}")
    n = dist.get_world_size(group)

    def mean(g, dtype):
        t = g.to(dtype, copy=True)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return (t / torch.full((), n, dtype=dtype, device=t.device)).to(g.dtype)

    if method == "none":
        return tree_map(lambda g: mean(g, g.dtype), grads), error_state
    if method == "bf16":
        return tree_map(lambda g: mean(g, torch.bfloat16), grads), error_state

    if error_state is None:
        error_state = tree_map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def one(g, e):
        f32 = dict(dtype=torch.float32, device=g.device)
        t = g.to(torch.float32) + e
        # one scale across the ranks, so the int32 sum dequantizes exactly
        amax = torch.amax(torch.abs(t)).reshape(1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        s = torch.clamp_min(amax[0] / torch.full((), 127.0, **f32), 1e-12)
        q = torch.clamp(torch.round(t / s), -127, 127).to(torch.int8)
        e_new = t - q.to(torch.float32) * s
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        m = total.to(torch.float32) * s / torch.full((), n, **f32)
        return m.to(g.dtype), e_new

    return _zip_map(one, grads, error_state)
