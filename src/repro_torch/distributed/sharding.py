"""Serving shard rules: a leaf's '/'-joined path -> the axis it shards over
the tensor-parallel ranks, or ``None`` (replicated).

The JAX package's regex table (``distributed/sharding.py``), copied:
column-parallel linears (wq/wk/wv, w1/w3, up-projections) shard their out
dim N, with their ``s_w`` scales and biases; row-parallel linears (wo, w2,
down, out_proj) shard their in dim K, the packed K/2 rows for int4 codes
(nibbles pair adjacent rows, so a contiguous slice of packed rows is a
contiguous slice of K). Everything else is replicated: norms, activation
scales, the row-parallel ``s_w`` and bias, and (a serving override) the
embedding, learned positions and ``lm_head``, whose logits feed the
sampler, so its reduction order stays that of one device.

A rank holds contiguous slices: rank ``r`` of ``tp`` keeps
``[r * n / tp, (r + 1) * n / tp)`` along its leaf's axis. Row-parallel
linears then sum int32 partial products over the ranks
(``models/layers.py``), so every rank ends each layer with tp=1's
activations. The decode state shards its KV heads (``k``/``v`` and the
quantized ``k_q``/``v_q``/``k_scale``/``v_scale``, dense slots or pool
blocks); cursors and block tables stay on the host, replicated.
"""
from __future__ import annotations

import re
from typing import Optional

import torch

from ..core.tree import tree_leaves_with_path, tree_map_with_path

__all__ = ["serving_param_specs", "serving_state_specs", "shard_serving",
           "gather_serving"]

#: (regex on the joined path, the spec of the LAST dims, left-padded with
#: None for stacked layer leaves): JAX's ``_RULES``, "model" the tp axis
_RULES: list[tuple[str, tuple]] = [
    (r"(^|/)embed$", ("model", None)),
    (r"(^|/)pos_embed$", (None, None)),
    (r"(^|/)lm_head$", (None, "model")),
    (r"(^|/)router$", (None, None)),
    (r"(^|/)(wq|wk|wv|w1|w3|wqkv|w13|up|in_z|in_x|w_in)/(w|wq)$", (None, "model")),
    (r"(^|/)(wq|wk|wv|w1|w3|wqkv|w13|up|in_z|in_x|w_in)/s_w$", (None, "model")),
    (r"(^|/)(wq|wk|wv|w1|w3|wqkv|w13|up|in_z|in_x|w_in)/b$", ("model",)),
    (r"(^|/)(wo|w2|down|out_proj)/(w|wq)$", ("model", None)),
    (r"(^|/)w_gates/w$", (None, None)),
]

#: replicated in serving whatever the rule above says (JAX's
#: ``_SERVING_REPLICATED``): the sampler's inputs
_SERVING_REPLICATED = re.compile(r"(^|/)(embed|pos_embed|lm_head)$")

#: fused projections: N-chunks of a concatenated q|k|v (or w1|w3) are not
#: per-head slices of each part, so the port shards none of them
_FUSED = re.compile(r"(^|/)(wqkv|w13)/")

_STATE_HEAD_AXIS = {"k": 2, "v": 2, "k_q": 2, "v_q": 2,
                    "k_scale": 1, "v_scale": 1}   # counted from the end


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _spec_axis(s: str, ndim: int) -> Optional[int]:
    for pat, tail in _RULES:
        if re.search(pat, s):
            tail = tail[-ndim:] if ndim < len(tail) else tail
            if "model" not in tail:
                return None
            return ndim - len(tail) + tail.index("model")
    return None


def serving_param_specs(params) -> dict:
    """The tree of shard axes (an int, or None for replicated) of a
    DEPLOYED parameter tree, the counterpart of JAX's
    ``serving_param_specs``. A fused projection leaf raises, naming it."""
    def spec(path, leaf):
        s = _path_str(path)
        if _FUSED.search(s):
            raise ValueError(
                f"{s}: fused projections (wqkv, w13) have no tensor-parallel "
                "layout in the port; contiguous N-chunks of the fused matrix "
                "are not per-head slices of its parts")
        if _SERVING_REPLICATED.search(s):
            return None
        return _spec_axis(s, leaf.dim())
    return tree_map_with_path(spec, params)


def serving_state_specs(state, tp: int) -> dict:
    """The tree of shard axes of a decode state or block-pool buffer dict
    (JAX's ``serving_state_specs``): the KV-head axis of every K/V buffer
    whose head count ``tp`` divides, None for the rest (cursors, tables)."""
    def spec(path, leaf):
        base = _path_str(path).rsplit("/", 1)[-1]
        back = _STATE_HEAD_AXIS.get(base)
        if back is None or not isinstance(leaf, torch.Tensor) \
                or leaf.dim() < back:
            return None
        axis = leaf.dim() - back
        return axis if leaf.shape[axis] % tp == 0 else None
    return tree_map_with_path(spec, state)


def shard_serving(tree, specs, rank: int, tp: int):
    """Rank ``rank``'s contiguous slice of every sharded leaf (copied, so
    the full array can be freed); replicated leaves pass through."""
    flat = dict(tree_leaves_with_path(specs))

    def cut(path, leaf):
        axis = flat[path]
        if axis is None:
            return leaf
        n = leaf.shape[axis]
        if n % tp:
            raise ValueError(f"{_path_str(path)}: axis {axis} of size {n} does "
                             f"not divide over tp={tp}")
        w = n // tp
        return leaf.narrow(axis, rank * w, w).contiguous()
    return tree_map_with_path(cut, tree)


def gather_serving(tree, specs, tp: int):
    """The inverse of :func:`shard_serving` over the ``tp`` ranks of the
    default process group: every sharded leaf all-gathered back to its full
    logical array, on every rank."""
    import torch.distributed as dist
    flat = dict(tree_leaves_with_path(specs))

    def join(path, leaf):
        axis = flat[path]
        if axis is None:
            return leaf
        parts = [torch.empty_like(leaf) for _ in range(tp)]
        dist.all_gather(parts, leaf.contiguous())
        return torch.cat(parts, dim=axis)
    return tree_map_with_path(join, tree)

