"""Adam with parameter groups (paper §5.2: distinct lr for weights vs
activation-scales vs weight-scales), written over the parameter tree with
the JAX package's arithmetic (``torch.optim.Adam`` places eps and clips
differently).

Groups are resolved from tree paths: leaves named ``s_a*`` are activation
quantization scales, ``s_w*`` weight quantization scales, everything else
is a weight. Scales are clamped positive after each update (LSQ
stability).

The update works in place: each leaf of ``params``, ``m`` and ``v`` is
overwritten with its new value and the same trees are returned (the JAX
package returns new arrays and lets XLA reuse the buffers). Full-size
training holds params, grads, m and v once each this way.
``value_and_grad`` is the gradient half of a step, over the same trees.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core.tree import tree_leaves_with_path, tree_map, tree_map_with_path


class AdamState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    m: dict
    v: dict


GROUP_WEIGHTS = "weights"
GROUP_ACT_SCALE = "act_scale"
GROUP_W_SCALE = "weight_scale"


def group_for_path(path) -> str:
    for k in reversed(tuple(path)):
        if isinstance(k, str) and k.startswith("s_a"):
            return GROUP_ACT_SCALE
        if isinstance(k, str) and k.startswith("s_w"):
            return GROUP_W_SCALE
    return GROUP_WEIGHTS


def _device(tree) -> torch.device:
    return next(iter(tree_leaves_with_path(tree)))[1].device


def adam_init(params) -> AdamState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=_device(params)),
                     m=tree_map(zeros, params), v=tree_map(zeros, params))


def value_and_grad(loss_fn, params, *args):
    """(loss, aux, grads), the counterpart of ``jax.value_and_grad(...,
    has_aux=True)``: ``loss_fn(params, *args) -> (loss, aux)``
    differentiated over every leaf of ``params`` with
    ``torch.autograd.grad``; leaves the loss does not reach get zero
    gradients, as ``jax.grad`` gives them."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, aux = loss_fn(live, *args)
    paths, leaves = zip(*tree_leaves_with_path(live))
    gl = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_path = {path: torch.zeros_like(t) if g is None else g
               for path, t, g in zip(paths, leaves, gl)}
    grads = tree_map_with_path(lambda path, _: by_path[path], live)
    return loss.detach(), aux, grads


@torch.no_grad()
def adam_update(params, grads, state: AdamState, *, lr_by_group: dict,
                schedule_fn: Callable, b1=0.9, b2=0.999, eps=1e-8,
                grad_clip: float = 0.0):
    """Returns (params, new_state), both updated in place but the step.
    ``lr_by_group``: group name -> base lr."""
    step = state.step + 1
    sched = schedule_fn(step)
    flat = list(tree_leaves_with_path(params))
    gl = [g for _, g in tree_leaves_with_path(grads)]
    ml = [m for _, m in tree_leaves_with_path(state.m)]
    vl = [v for _, v in tree_leaves_with_path(state.v)]
    if not len(flat) == len(gl) == len(ml) == len(vl):
        raise ValueError("params, grads and the Adam state differ in structure")

    factor = None
    if grad_clip:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in gl))
        # a tensor numerator: float / tensor would multiply by a reciprocal
        clip = torch.full((), grad_clip, dtype=torch.float32, device=gnorm.device)
        factor = torch.clamp(clip / torch.clamp_min(gnorm, 1e-12), max=1.0)

    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full((), b1, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.full((), b2, device=stepf.device), stepf)
    for (path, p), g, m, v in zip(flat, gl, ml, vl):
        # JAX's expressions and rounding order, in place and with two
        # leaf-sized temporaries (the stacked layer leaves are GBs at full
        # width):  m = b1 m + (1-b1) g,  v = b2 v + (1-b2) g^2,
        # p -= lr (m / bc1) / (sqrt(v / bc2) + eps)
        g32 = g.to(torch.float32)
        if factor is not None:
            g32 = g32 * factor
        t = g32 * (1 - b1)
        m.mul_(b1).add_(t)
        torch.mul(g32, g32, out=t).mul_(1 - b2)
        v.mul_(b2).add_(t)
        del g32
        torch.div(v, bc2, out=t).sqrt_().add_(eps)
        group = group_for_path(path)
        delta = torch.div(m, bc1).mul_(lr_by_group[group] * sched).div_(t)
        del t
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.to(torch.float32).sub_(delta))
        if group in (GROUP_ACT_SCALE, GROUP_W_SCALE):
            p.clamp_min_(1e-8)                    # scales stay positive
    return params, AdamState(step=step, m=state.m, v=state.v)
