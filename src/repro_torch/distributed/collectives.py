"""Differentiable collectives of the sharded training step, over one group
of a ``launch.mesh.TrainGroups`` layout: the model group (tensor- and
context-parallel) or the data group (FSDP).

* ``copy_to_model``: identity forward, all-reduce (sum) backward: where a
  replicated activation enters column-parallel work, each rank's partial
  input gradient is summed.
* ``reduce_from_model``: all-reduce (sum) forward, identity backward: a
  row-parallel product's partial sums.
* ``gather_from_model(dim)``: all-gather forward, own slice backward, for a
  gathered tensor that every rank then uses alike (the logits, the MINI
  taps), whose gradient is the same on every rank; with ``sum_grad`` the
  gradients are summed before the slice, for a gathered tensor each rank
  uses differently (the context-parallel keys and values).
* ``scatter_to_model(dim)``: own slice forward, all-gather backward.
* ``all_to_all_model(split_dim, cat_dim)``: each rank's ``split_dim`` cut
  into ``model`` pieces, piece ``j`` to rank ``j``, the received pieces
  joined along ``cat_dim``; backward is the move the other way.
* ``sum_over_model``: the sum over the model group forward and backward:
  a statistic each rank computes over its slice of a dim the model ranks
  cut (the sum of squares of a norm over a cut width), whose gradient is
  each rank's share and must be summed too.
* ``model_slice(dim, parts)``: this model rank's slice of each of
  ``parts`` equal parts of a replicated tensor along ``dim`` (its heads of
  a replicated leaf or activation); the gradient is summed over the model
  ranks, so the replicated tensor gets every rank's share once.
* ``mean_from_data``: the mean over the data group forward, identity
  backward (the data ranks' gradients are averaged after the step): a
  batch statistic of the whole batch from the ranks' equal parts.
* ``fsdp_take(stack_shard, i, owner)``: layer ``i`` of the stack shard data
  rank ``owner`` holds, broadcast to every data rank; backward sums the
  layer's gradient onto the owner (the other ranks' shards get none).

Every move is built on ``all_reduce``, ``broadcast`` and ``all_gather``,
which NCCL and gloo take. Two ranks sharing one card run over gloo (NCCL
refuses that); ``probe_gloo_cuda`` checks that gloo takes the three on
CUDA tensors there and raises, naming each it refuses.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["copy_to_model", "reduce_from_model", "sum_over_model", "model_slice",
           "gather_from_model", "scatter_to_model", "all_to_all_model",
           "mean_from_data", "fsdp_take", "all_reduce", "all_gather",
           "probe_gloo_cuda"]

#: the collectives the step is built on
COLLECTIVES = ("all_reduce", "broadcast", "all_gather")


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> list:
    """Every rank's ``t`` (one shape on every rank), in rank order."""
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, t, group=group)
    return outs


def _own(x: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    w = x.shape[dim] // n
    return x.narrow(dim, rank * w, w).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.groups.mp_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return all_reduce(x.clone(), groups.mp_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return all_reduce(x.clone(), groups.mp_group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.groups.mp_group), None


class _MeanFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return all_reduce(x.clone(), groups.dp_group) / groups.data

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sum_grad, groups):
        ctx.dim, ctx.sum_grad, ctx.groups = dim, sum_grad, groups
        return torch.cat(all_gather(x, groups.mp_group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        gr = ctx.groups
        if ctx.sum_grad:
            g = all_reduce(g.contiguous().clone(), gr.mp_group)
        return _own(g, ctx.dim, gr.mp_rank, gr.model), None, None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        return _own(x, dim, groups.mp_rank, groups.model)

    @staticmethod
    def backward(ctx, g):
        gr = ctx.groups
        return torch.cat(all_gather(g, gr.mp_group), dim=ctx.dim), None, None


def _exchange(x: torch.Tensor, split_dim: int, cat_dim: int, groups):
    """The all-to-all over the model group, on ``all_gather``: every rank's
    tensor gathered, its ``mp_rank``-th piece along ``split_dim`` kept,
    the pieces joined along ``cat_dim`` in rank order."""
    parts = all_gather(x, groups.mp_group)
    return torch.cat([_own(p, split_dim, groups.mp_rank, groups.model)
                      for p in parts], dim=cat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, groups):
        ctx.dims, ctx.groups = (split_dim, cat_dim), groups
        return _exchange(x, split_dim, cat_dim, groups)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return _exchange(g, cat_dim, split_dim, ctx.groups), None, None, None


class _FsdpTake(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stack, i, owner, groups):
        ctx.i, ctx.owner, ctx.groups = i, owner, groups
        ctx.shape = stack.shape
        if groups.dp_rank == owner:
            out = stack[i].clone()
        else:
            out = stack.new_empty(stack.shape[1:])
        dist.broadcast(out, src=groups.dp_global_rank(owner), group=groups.dp_group)
        return out

    @staticmethod
    def backward(ctx, g):
        gr = ctx.groups
        # an all-reduce rather than a reduce: gloo takes no reduce of CUDA
        # tensors; only the owner keeps the sum
        total = all_reduce(g.contiguous().clone(), gr.dp_group)
        grad = total.new_zeros(ctx.shape)
        if gr.dp_rank == ctx.owner:
            grad[ctx.i] = total
        return grad, None, None, None


def copy_to_model(x: torch.Tensor, groups) -> torch.Tensor:
    """Identity; the gradient is summed over the model group."""
    return _CopyToModel.apply(x, groups)


def reduce_from_model(x: torch.Tensor, groups) -> torch.Tensor:
    """The sum over the model group; the gradient passes unchanged."""
    return _ReduceFromModel.apply(x, groups)


def sum_over_model(x: torch.Tensor, groups) -> torch.Tensor:
    """The sum over the model group; the gradient is summed over it too
    (each rank's is its share)."""
    return _SumOverModel.apply(x, groups)


def model_slice(x: torch.Tensor, dim: int, groups, parts: int = 1) -> torch.Tensor:
    """This model rank's contiguous slice of each of ``parts`` equal parts
    of ``x`` along ``dim``, joined in order; ``x`` is replicated and its
    gradient is summed over the model ranks (``copy_to_model``)."""
    x = copy_to_model(x, groups)
    return torch.cat([_own(p, dim, groups.mp_rank, groups.model)
                      for p in torch.chunk(x, parts, dim=dim)], dim=dim)


def mean_from_data(x: torch.Tensor, groups) -> torch.Tensor:
    """The mean of ``x`` over the data group; the gradient passes unchanged
    (the data ranks' gradients are averaged after the step)."""
    return _MeanFromData.apply(x, groups)


def gather_from_model(x: torch.Tensor, dim: int, groups,
                      sum_grad: bool = False) -> torch.Tensor:
    """The model ranks' ``x`` joined along ``dim`` in rank order; backward
    takes this rank's slice of the gradient (summed over the ranks first
    with ``sum_grad``)."""
    return _GatherFromModel.apply(x, dim, sum_grad, groups)


def scatter_to_model(x: torch.Tensor, dim: int, groups) -> torch.Tensor:
    """This model rank's contiguous slice of ``x`` along ``dim``."""
    return _ScatterToModel.apply(x, dim, groups)


def all_to_all_model(x: torch.Tensor, split_dim: int, cat_dim: int,
                     groups) -> torch.Tensor:
    """Piece ``j`` of ``x`` along ``split_dim`` to model rank ``j``; the
    pieces received joined along ``cat_dim`` in rank order."""
    return _AllToAll.apply(x, split_dim, cat_dim, groups)


def fsdp_take(stack_shard: torch.Tensor, i: int, owner: int,
              groups) -> torch.Tensor:
    """Row ``i`` of data rank ``owner``'s ``stack_shard``, on every data
    rank of this model rank; its gradient summed onto the owner's row."""
    return _FsdpTake.apply(stack_shard, i, owner, groups)


def probe_gloo_cuda(device) -> None:
    """Call each of ``COLLECTIVES`` once on a CUDA tensor on ``device`` over
    the default (gloo) group (a collective call: every rank must make it);
    raises, naming every one gloo refused. The step has no host path to
    fall back to."""
    refused = []
    for name in COLLECTIVES:
        t = torch.ones(4, device=device)
        try:
            if name == "all_reduce":
                dist.all_reduce(t)
            elif name == "broadcast":
                dist.broadcast(t, src=0)
            else:
                dist.all_gather([torch.empty_like(t)
                                 for _ in range(dist.get_world_size())], t)
        except RuntimeError as e:
            refused.append(f"{name} ({e})")
    if refused:
        raise RuntimeError("gloo refuses collectives of the sharded step on "
                           f"CUDA tensors: {'; '.join(refused)}")
