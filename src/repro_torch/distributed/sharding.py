"""Shard rules: a leaf's '/'-joined path -> the axis it shards over.

Serving (tensor parallelism over ``tp`` ranks). The JAX package's regex
table (``distributed/sharding.py``), copied: column-parallel linears
(wq/wk/wv, w1/w3, the fused wqkv/w13, up-projections) shard their out dim
N, with their ``s_w`` scales and biases; row-parallel linears (wo, w2,
down, out_proj) shard their in dim K, the packed K/2 rows for int4 codes
(nibbles pair adjacent rows, so a contiguous slice of packed rows is a
contiguous slice of K). Everything else is replicated: norms, activation
scales, the row-parallel ``s_w`` and bias, and (a serving override) the
embedding, learned positions and ``lm_head``, whose logits feed the
sampler, so its reduction order stays that of one device.

A rank holds contiguous slices: rank ``r`` of ``tp`` keeps
``[r * n / tp, (r + 1) * n / tp)`` along its leaf's axis. A fused
projection is cut part by part (:class:`FusedAxis`): rank ``r`` keeps its
slice of q, of k and of v (of the gate and of the up columns), concatenated,
so its product splits into its own heads exactly as an unfused rank's
three products do. Row-parallel linears then sum int32 partial products
over the ranks (``models/layers.py``), so every rank ends each layer with
tp=1's activations. The decode state shards its KV heads (``k``/``v`` and
the quantized ``k_q``/``v_q``/``k_scale``/``v_scale``, dense slots or pool
blocks); cursors and block tables stay on the host, replicated.

Training (the JAX package's ``spec_for`` / ``param_specs`` /
``batch_spec`` / ``safe_batch_spec`` / ``state_specs``): each returns, per
leaf, a tuple with one entry a dim, an axis name, a tuple of axis names or
None, which is what JAX's ``PartitionSpec`` holds. ``mesh`` is any layout
with ``axis_names`` and a ``shape`` dict (``launch.mesh.make_production_mesh``).

The sharded training step places by those rules (``training_specs``: each
cut dim a :class:`TrainAxis`): "model" cuts over a ``TrainGroups``' model
ranks (fused projections part by part), "data" (FSDP) the layer stack over
its data ranks. The concatenated column-parallel outputs of the token-mode
families are cut part by part too (``_TRAIN_PARTS``): the mLSTM's ``up``
is ``[xi | z]`` and the sLSTM's ``w_in`` ``[i | f | z | o]``, so a rank
holds its heads of every part; gathered, every leaf is JAX's full array.
``shard_training`` / ``gather_training`` move a param, gradient or
Adam-moment tree between its full logical arrays and one
rank's slices, leaf by leaf. A vocabulary-sharded ``embed`` / ``lm_head``
whose rows do not divide over the model ranks is padded to ``ceil(V /
model)`` rows a rank (zeros past ``V``); gathering drops the padding.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

from ..core.tree import tree_leaves_with_path, tree_map_with_path

__all__ = ["FusedAxis", "serving_param_specs", "serving_state_specs",
           "shard_serving", "gather_serving", "spec_for", "param_specs",
           "set_mesh_axis_sizes", "batch_spec", "safe_batch_spec",
           "state_specs", "TrainAxis", "TrainSpec", "training_specs",
           "shard_training",
           "gather_training"]

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

#: fused projections: sharded part by part (:class:`FusedAxis`)
_FUSED = re.compile(r"(^|/)(wqkv|w13)/")


@dataclasses.dataclass(frozen=True)
class FusedAxis:
    """The shard axis of a fused projection's leaf and its parts' relative
    widths along it: (H, Hkv, Hkv) for ``wqkv``, (1, 1) for ``w13``. Each
    part is cut into ``tp`` contiguous slices; a rank holds its slice of
    every part, in order."""
    axis: int
    parts: tuple


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


def serving_param_specs(params, cfg=None) -> dict:
    """The tree of shard axes (an int, a :class:`FusedAxis`, or None for
    replicated) of a DEPLOYED parameter tree, the counterpart of JAX's
    ``serving_param_specs``. A fused ``wqkv`` splits by the config's head
    counts: without ``cfg`` it raises, naming the leaf."""
    def spec(path, leaf):
        s = _path_str(path)
        if _SERVING_REPLICATED.search(s):
            return None
        axis = _spec_axis(s, leaf.dim())
        fused = _FUSED.search(s)
        if not fused or axis is None:
            return axis
        if fused.group(2) == "w13":
            return FusedAxis(axis, (1, 1))
        if cfg is None:
            raise ValueError(
                f"{s}: fused projections (wqkv) shard q, k and v each by "
                "heads; pass the model config, whose head counts split it")
        return FusedAxis(axis, (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    return tree_map_with_path(spec, params)


def _parts(n: int, weights: tuple) -> list:
    total = sum(weights)
    if n % total:
        raise ValueError(f"a fused axis of {n} does not split into {weights}")
    return [n // total * w for w in weights]


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
        if isinstance(axis, FusedAxis):
            pieces = torch.split(leaf, _parts(leaf.shape[axis.axis], axis.parts),
                                 dim=axis.axis)
            return torch.cat([_cut(path, p, axis.axis, rank, tp) for p in pieces],
                             dim=axis.axis).contiguous()
        return _cut(path, leaf, axis, rank, tp)
    return tree_map_with_path(cut, tree)


def _cut(path, leaf, axis: int, rank: int, tp: int):
    """Rank ``rank``'s contiguous slice of ``leaf`` along ``axis``."""
    n = leaf.shape[axis]
    if n % tp:
        raise ValueError(f"{_path_str(path)}: axis {axis} of size {n} does "
                         f"not divide over tp={tp}")
    w = n // tp
    return leaf.narrow(axis, rank * w, w).contiguous()


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
        ranks = [torch.empty_like(leaf) for _ in range(tp)]
        dist.all_gather(ranks, leaf.contiguous())
        if not isinstance(axis, FusedAxis):
            return torch.cat(ranks, dim=axis)
        sizes = _parts(leaf.shape[axis.axis], axis.parts)
        split = [torch.split(r, sizes, dim=axis.axis) for r in ranks]
        return torch.cat([torch.cat([r[i] for r in split], dim=axis.axis)
                          for i in range(len(sizes))], dim=axis.axis)
    return tree_map_with_path(join, tree)


# ------------------------------------------------------------ training rules
def spec_for(path, leaf) -> tuple:
    """The training spec of one parameter leaf: the rule's tail, left-padded
    with None to the leaf's rank (JAX's ``spec_for``)."""
    ndim = leaf.dim() if isinstance(leaf, torch.Tensor) else len(leaf.shape)
    s = _path_str(path)
    for pat, tail in _RULES:
        if re.search(pat, s):
            tail = tail[-ndim:] if ndim < len(tail) else tail
            return (None,) * (ndim - len(tail)) + tuple(tail)
    return (None,) * ndim


def param_specs(params, fsdp_axes: tuple = (), fsdp_min_dim: int = 2) -> dict:
    """The tree of training specs of ``params`` (JAX's ``param_specs``).
    ``fsdp_axes``: stacked leaves (rank above ``fsdp_min_dim``) also shard
    their leading (layer) dim over these axes where it divides, else over a
    shorter tail of them, as JAX's ZeRO-style rule does."""
    def spec(path, leaf):
        s = spec_for(path, leaf)
        if fsdp_axes and leaf.dim() > fsdp_min_dim and s[0] is None:
            for k in range(len(fsdp_axes)):
                axes = fsdp_axes[k:]
                if leaf.shape[0] % _axes_size(axes) == 0:
                    return (axes if len(axes) > 1 else axes[0],) + s[1:]
        return s
    return tree_map_with_path(spec, params)


_AXSZ: dict = {}


def set_mesh_axis_sizes(mesh) -> None:
    """Record ``mesh``'s axis sizes for :func:`param_specs`' FSDP rule."""
    global _AXSZ
    _AXSZ = {a: mesh.shape[a] for a in mesh.axis_names}


def _axes_size(axes: tuple) -> int:
    n = 1
    for a in axes:
        n *= _AXSZ.get(a, 1)
    return n


def _dp(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(mesh, ndim: int, batch_axis: int = 0) -> tuple:
    """The batch dim over the data-parallel axes, the rest replicated."""
    dp = _dp(mesh)
    spec = [None] * ndim
    spec[batch_axis] = dp if len(dp) > 1 else dp[0]
    return tuple(spec)


def safe_batch_spec(mesh, shape: tuple, batch_axis: int = 0) -> tuple:
    """:func:`batch_spec`, replicated where the batch does not divide over
    the data-parallel axes (long_500k's batch of 1)."""
    n_dp = 1
    for a in _dp(mesh):
        n_dp *= mesh.shape[a]
    if shape[batch_axis] % n_dp != 0:
        return (None,) * len(shape)
    return batch_spec(mesh, len(shape), batch_axis)


def state_specs(state_tree, mesh) -> dict:
    """Specs of a decode state (JAX's ``state_specs``): KV rows shard the
    batch over the data axes and heads over "model" (or, where the heads do
    not divide, the sequence); conv states their channels; SSM / mLSTM
    states their batch and heads (the mLSTM ``C`` its value dim); the small
    states their batch only; cursors are replicated."""
    dp = _dp(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    n_dp = 1
    for a in dp:
        n_dp *= mesh.shape[a]
    n_model = mesh.shape.get("model", 1)

    def spec(path, leaf):
        ndim, shape, s = leaf.dim(), leaf.shape, _path_str(path)
        if ndim == 0 or "len" in s:
            return (None,) * ndim
        sp = [None] * ndim
        if s.endswith("/k") or s.endswith("/v") or s in ("k", "v"):
            b_dim, s_dim, h_dim = ndim - 4, ndim - 3, ndim - 2
            if shape[b_dim] % n_dp == 0:
                sp[b_dim] = dpa
            if shape[h_dim] % n_model == 0:
                sp[h_dim] = "model"
            elif shape[s_dim] % n_model == 0:
                sp[s_dim] = "model"
            return tuple(sp)
        if "conv" in s:
            if shape[ndim - 3] % n_dp == 0:
                sp[ndim - 3] = dpa
            if shape[ndim - 1] % n_model == 0:
                sp[ndim - 1] = "model"
            return tuple(sp)
        if s.endswith("ssm") or "/C" in s or s.endswith("C"):
            if ndim >= 4 and shape[ndim - 4] % n_dp == 0:
                sp[ndim - 4] = dpa
            if s.endswith("C") and shape[ndim - 1] % n_model == 0:
                sp[ndim - 1] = "model"
            elif shape[ndim - 3] % n_model == 0:
                sp[ndim - 3] = "model"
            return tuple(sp)
        for d in range(ndim):
            if shape[d] % n_dp == 0 and shape[d] >= n_dp and d >= ndim - 3 \
                    and shape[d] > 1:
                sp[d] = dpa
                break
        return tuple(sp)
    return tree_map_with_path(spec, state_tree)


# ------------------------------------------------ the sharded training step
#: leaves sharded over the vocabulary: padded where their rows do not divide
_VOCAB = re.compile(r"(^|/)(embed|lm_head)$")


#: concatenated column-parallel outputs the training rules cut part by
#: part (the port's layers split them after the product): name -> parts
_TRAIN_PARTS = {"up": 2, "w_in": 4}
_TRAIN_PARTED = re.compile(r"(^|/)(%s)/" % "|".join(_TRAIN_PARTS))


@dataclasses.dataclass(frozen=True)
class TrainAxis:
    """One cut dim of a training leaf: the mesh ``axis`` ("model" or
    "data"), the dim's logical ``size``, and a fused projection's parts'
    relative widths (each part cut on its own, as ``FusedAxis``)."""
    axis: str
    size: int
    parts: tuple = (1,)

    def local(self, n: int) -> int:
        """The dim's size on one of ``n`` ranks (``ceil(size / n)``)."""
        return -(-self.size // n)


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """A training leaf's cuts: one entry a dim, a :class:`TrainAxis` or
    None (a tree leaf of its own, where a bare tuple would be a subtree)."""
    dims: tuple

    @property
    def axes(self) -> tuple:
        """The mesh axes the leaf is cut over, sorted."""
        return tuple(sorted({ta.axis for ta in self.dims if ta is not None}))


def training_specs(params, cfg=None, *, data: int = 1,
                   fsdp: bool = False) -> dict:
    """Per leaf, a :class:`TrainSpec`: per dim a :class:`TrainAxis` or
    None. The "model" cuts are JAX's ``_RULES`` (``spec_for``); with
    ``fsdp`` a stacked leaf (rank above 2) whose layer count divides over
    ``data`` also cuts its layer dim over "data" (``param_specs``' rule).
    A fused ``wqkv`` splits by the config's head counts (``cfg``); the
    mLSTM's ``up`` and the sLSTM's ``w_in`` into their 2 and 4 parts."""
    def spec(path, leaf):
        s = _path_str(path)
        tail = spec_for(path, leaf)
        if fsdp and leaf.dim() > 2 and tail[0] is None \
                and leaf.shape[0] % data == 0:
            tail = ("data",) + tail[1:]
        fused = _FUSED.search(s)
        parted = _TRAIN_PARTED.search(s)
        out = []
        for dim, ax in enumerate(tail):
            if ax is None:
                out.append(None)
                continue
            parts = (1,)
            if ax == "model" and fused:
                if fused.group(2) == "w13":
                    parts = (1, 1)
                elif cfg is None:
                    raise ValueError(f"{s}: a fused wqkv shards q, k and v "
                                     "by heads; pass the model config")
                else:
                    parts = (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads)
            elif ax == "model" and parted:
                parts = (1,) * _TRAIN_PARTS[parted.group(2)]
            out.append(TrainAxis(ax, leaf.shape[dim], parts))
        return TrainSpec(tuple(out))
    return tree_map_with_path(spec, params)


def _axis_rank(groups, axis: str) -> tuple[int, int]:
    if axis == "model":
        return groups.mp_rank, groups.model
    if axis == "data":
        return groups.dp_rank, groups.data
    raise ValueError(f"training axis {axis!r}: the port's layouts have "
                     "'data' and 'model'")


def shard_training(tree, specs, groups):
    """This rank's slice of every cut leaf of ``tree`` (params, gradients
    or one Adam moment: ``specs``' structure), copied so the full arrays
    can be freed; uncut leaves pass through."""
    flat = dict(tree_leaves_with_path(specs))

    def cut(path, leaf):
        for dim, ta in enumerate(flat[path].dims):
            if ta is None:
                continue
            rank, n = _axis_rank(groups, ta.axis)
            sizes = _parts(ta.size, ta.parts) if len(ta.parts) > 1 else [ta.size]
            pieces = torch.split(leaf, sizes, dim=dim)
            out = []
            for piece in pieces:
                if piece.shape[dim] % n:
                    if not _VOCAB.search(_path_str(path)):
                        raise ValueError(
                            f"{_path_str(path)}: dim {dim} of size "
                            f"{piece.shape[dim]} does not divide over "
                            f"{ta.axis}={n}")
                    pad = list(piece.shape)
                    pad[dim] = ta.local(n) * n - piece.shape[dim]
                    piece = torch.cat([piece, piece.new_zeros(pad)], dim=dim)
                w = piece.shape[dim] // n
                out.append(piece.narrow(dim, rank * w, w))
            leaf = torch.cat(out, dim=dim) if len(out) > 1 else out[0]
        # a copy (a narrow along dim 0 would keep the whole storage alive)
        return (leaf.clone(memory_format=torch.contiguous_format)
                if flat[path].axes else leaf)
    return tree_map_with_path(cut, tree)


def gather_training(tree, specs, groups):
    """The inverse of :func:`shard_training` over ``groups``' ranks: every
    cut leaf all-gathered back to its full logical array (vocabulary
    padding dropped), on every rank."""
    from .collectives import all_gather
    flat = dict(tree_leaves_with_path(specs))

    def join(path, leaf):
        for dim, ta in reversed(list(enumerate(flat[path].dims))):
            if ta is None:
                continue
            group = groups.mp_group if ta.axis == "model" else groups.dp_group
            ranks = all_gather(leaf, group)
            if len(ta.parts) == 1:
                leaf = torch.cat(ranks, dim=dim).narrow(dim, 0, ta.size)
                continue
            n = len(ranks)
            local = [s // n for s in _parts(ta.size, ta.parts)]
            split = [torch.split(r, local, dim=dim) for r in ranks]
            leaf = torch.cat([torch.cat([r[i] for r in split], dim=dim)
                              for i in range(len(local))], dim=dim)
        return leaf
    return tree_map_with_path(join, tree)
