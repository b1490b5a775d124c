"""QAT training driver of the port, the counterpart of the JAX package's
``launch/train.py``.

Flow (paper §4/§5): fp teacher (optional) -> calibrate (weight scales
abs-max, activation scales percentile) -> QAT with LSQ-MSE scale gradients
and MINI distillation -> deploy int4/int8.

Fault tolerance: atomic checkpoints every ``--ckpt-every`` steps and on
SIGTERM; a restart resumes from the latest complete step (a crash mid-save
cannot corrupt it: ``checkpoint/manager.py``), and the data stream
resumes at that step too (``run_training`` asks ``data_fn`` for the
batches from there), so a resumed run takes the batches an uninterrupted
one would. A straggler watchdog flags steps slower than
k x EMA.

A step is ``optim.value_and_grad`` (``torch.autograd.grad`` of the loss
over the parameter leaves: no ``.grad`` accumulates between steps; the
teacher runs under ``torch.no_grad``) followed by ``optim.adam_update``. The fake-quant
forward is plain PyTorch, as the JAX package computes it outside any
kernel.

A sharded step (``build_train_step(..., groups=, specs=)``, ``run_training
(..., groups=, fsdp=)``) is one rank's of ``data x model`` ranks
(``launch.mesh.TrainGroups``, started by ``launch.mesh.spawn_ranks``): the
params and the Adam moments hold the rank's slices by JAX's training rules
(``distributed.training_specs`` / ``shard_training``: tensor parallel over
"model", with FSDP the layer stacks over "data"), the rank takes its data
rank's rows of each batch, the forward meets the other ranks in
``distributed.collectives`` (``cfg.attn_seq_shard``: context-parallel
chunked attention), the gradients of the leaves the data ranks replicate
are averaged over them (``compressed_grad_mean``, ``none``), and the clip's
global norm counts each leaf once. Checkpoints hold the gathered tree, so
the unsharded port and JAX load them. The fp teacher runs whole on every
rank, on its rows. The CLI has no sharding flag, as JAX's has none.

``python -m repro_torch.launch.train [--reduced] [--device cpu] ...`` runs
on the card unless ``--device cpu`` is passed.
"""
from __future__ import annotations

import argparse
import itertools
import os
import signal
import tempfile
import threading
import time

import torch

from ..device import resolve_device


def _plan_mode(cfg) -> str:
    # the port's decode plans serve decoders; a bert stack trains as an LM
    # under an encoder plan (the segments are the same)
    return "encoder" if cfg.family == "bert" else "decode"


def check_trainable(cfg) -> None:
    """Raise for a family the train CLI cannot feed: the encoder-decoder's
    forward needs ``src_embeds``, and the CLI's synthetic LM batches carry
    tokens only, as JAX's do (its ``lm_batches``)."""
    if cfg.family == "encdec":
        raise ValueError(
            f"training family 'encdec' ({cfg.name}) from the CLI: its LM "
            "batches carry tokens only and an encoder-decoder forward needs "
            "src_embeds. The JAX package's train CLI has the same limit (its "
            "lm_batches carry no src_embeds; its forward raises at "
            "models/encdec.py:94). Train it through build_train_step or "
            "run_training with batches that carry src_embeds")


def build_train_step(plan, hparams, teacher=None, teacher_plan=None, *,
                     groups=None, specs=None):
    """Returns ``train_step(params, opt, batch) -> (params, opt, metrics)``;
    ``train_step.loss_fn(params, batch) -> (loss, parts)`` is its loss.

    With ``groups`` (a ``launch.mesh.TrainGroups``; ``plan`` built at
    ``tp=groups.model``) the step is this rank's of a sharded step:
    ``params`` and ``opt`` hold its slices by ``specs`` (``distributed.
    training_specs`` of the full tree), ``batch`` is the whole batch (its
    rows divide over the data ranks), and the metrics are the whole
    batch's.

    ``plan``/``teacher_plan`` are ``ExecutionPlan``s (student QAT plan and
    fp teacher plan). ``params`` and ``opt`` are updated in place. Every
    key of a batch but ``labels`` goes to the forward, so an
    encoder-decoder's batches carry ``src_embeds``. The distillation loss
    is JAX's: MINI on the attention taps where the student's taps hold
    them (``'q'``), the hidden-state loss otherwise (xLSTM, whose taps are
    ``{'hidden'}``), with a 0 value-relation loss."""
    from ..core.distill import (combine_losses, hidden_state_loss,
                                minilm_losses, output_loss)
    from ..models import api
    from ..models.transformer import lm_loss
    from ..optim import adam_update, linear_warmup_decay, value_and_grad

    cfg = plan.cfg
    sharded = groups is not None
    if sharded:
        if specs is None:
            raise ValueError("a sharded step needs the training specs its "
                             "params were cut by (distributed.training_specs)")
        plan = plan.with_groups(groups)
    sched = linear_warmup_decay(hparams.total_steps, hparams.warmup_frac)
    lr_by_group = {"weights": hparams.lr_weights,
                   "act_scale": hparams.lr_act_scale,
                   "weight_scale": hparams.lr_weight_scale}
    distill = teacher is not None

    def loss_fn(params, batch):
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        out = api.forward(params, plan, want_taps=distill, want_aux=True,
                          **inputs)
        logits = out[0]
        labels = torch.as_tensor(batch["labels"], device=logits.device)
        # the MoE load-balance loss joins the LM loss, as in the JAX
        # package (0 for the other families)
        l_train = lm_loss(logits, labels) + out[-1]
        if not distill:
            return l_train, {"loss/train": l_train}
        with torch.no_grad():
            t_logits, _, taps_t = api.forward(teacher, teacher_plan,
                                              want_taps=True, **inputs)
        l_out = output_loss(logits, t_logits)
        taps_s = out[2]
        if taps_s is not None and "q" in taps_s:
            R = min(cfg.num_heads, teacher_plan.cfg.num_heads)
            l_attn, l_val = minilm_losses(taps_s, taps_t, R)
        else:   # attention-free family: hidden-state distillation
            l_attn = hidden_state_loss(taps_s["hidden"], taps_t["hidden"])
            l_val = torch.zeros((), dtype=torch.float32, device=l_attn.device)
        return combine_losses(l_train, l_out, l_attn, l_val,
                              hparams.alpha, hparams.beta)

    def train_step(params, opt, batch):
        norm_reduce = None
        if sharded:
            batch = _rows_of(batch, groups)
        _, parts, grads = value_and_grad(loss_fn, params, batch)
        if sharded:
            grads, parts = _mean_over_data(grads, parts, specs, groups)
            norm_reduce = _norm_reduce(specs, groups)
        params, opt = adam_update(params, grads, opt,
                                  lr_by_group=lr_by_group, schedule_fn=sched,
                                  b1=hparams.adam_b1, b2=hparams.adam_b2,
                                  eps=hparams.adam_eps,
                                  grad_clip=hparams.grad_clip,
                                  norm_reduce=norm_reduce)
        return params, opt, {k: v.detach() for k, v in parts.items()}

    train_step.loss_fn = loss_fn
    return train_step


def _rows_of(batch: dict, groups) -> dict:
    """This data rank's contiguous share of every batch array's rows."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.shape[0] % groups.data:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"divide over data={groups.data} ranks")
        n = v.shape[0] // groups.data
        out[k] = v[groups.dp_rank * n:(groups.dp_rank + 1) * n]
    return out


def _mean_over_data(grads, parts: dict, specs, groups):
    """The whole batch's gradients and loss parts from the data ranks'
    equal shares: each leaf the data ranks replicate is averaged over them
    (``compressed_grad_mean``, ``none``); an FSDP leaf arrives summed on its
    owner (``collectives.fsdp_take``) and is divided by their count."""
    from ..core.tree import tree_leaves_with_path, tree_map_with_path
    from ..distributed import compressed_grad_mean
    from ..distributed.collectives import all_reduce
    if groups.data == 1:
        return grads, parts
    spec_of = dict(tree_leaves_with_path(specs))
    flat = dict(tree_leaves_with_path(grads))
    replicated = {i: g for i, (path, g) in enumerate(flat.items())
                  if "data" not in spec_of[path].axes}
    mean, _ = compressed_grad_mean(replicated, group=groups.dp_group, method="none")
    n = torch.full((), groups.data, dtype=torch.float32)
    by_path = {}
    for i, (path, g) in enumerate(flat.items()):
        if i in mean:
            by_path[path] = mean[i]
        else:
            by_path[path] = (g / n.to(g.device)).to(g.dtype)
    grads = tree_map_with_path(lambda path, _: by_path[path], grads)
    parts = {k: all_reduce(v.detach().clone(), groups.dp_group) / groups.data
             for k, v in parts.items()}
    return grads, parts


def _norm_reduce(specs, groups):
    """``adam_update``'s ``norm_reduce`` for a sharded step: the squares of
    the leaves cut over the same axes summed here, then over those axes'
    groups; a replicated leaf counts once."""
    from ..core.tree import tree_leaves_with_path
    from ..distributed.collectives import all_reduce
    leaf_axes = [spec.axes for _, spec in tree_leaves_with_path(specs)]
    group_of = {"model": groups.mp_group, "data": groups.dp_group}

    def reduce(squares):
        totals = {}
        for sq, ax in zip(squares, leaf_axes):
            totals[ax] = sq if ax not in totals else totals[ax] + sq
        total = None
        for ax, t in totals.items():
            t = t.clone()
            for a in ax:
                all_reduce(t, group_of[a])
            total = t if total is None else total + t
        return total
    return reduce


class StragglerWatchdog:
    """Flags steps slower than ``factor`` x EMA of recent step times."""

    def __init__(self, factor: float = 3.0, alpha: float = 0.1):
        self.factor, self.alpha, self.ema = factor, alpha, None
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        if slow:
            self.flagged.append((step, dt))
        self.ema = dt if self.ema is None else (
            (1 - self.alpha) * self.ema + self.alpha * dt)
        return slow


def run_training(cfg, policy, hparams, data_fn, *, ckpt_dir: str,
                 ckpt_every: int = 50, distill_teacher=None, teacher_cfg=None,
                 log_every: int = 10, max_steps=None, on_step=None,
                 device=None, params=None, opt=None, groups=None,
                 fsdp: bool = False):
    """The loop: resume -> step -> checkpoint; SIGTERM-safe.

    Params come from ``api.init_model`` with a generator seeded 0 on
    ``device`` unless ``params`` (and optionally ``opt``, an ``AdamState``)
    are given, e.g. the JAX package's arrays through
    ``deploy.params_from_numpy``. A checkpoint in ``ckpt_dir`` takes
    precedence over both. ``data_fn(step0)`` returns an iterator of the
    batches from step ``step0`` on (0, or the restored step); it is closed
    when the loop ends if it has a ``close``. Returns ``(state, metrics)`` with ``state =
    {'params', 'opt'}``.

    With ``groups`` (a ``launch.mesh.TrainGroups``; every rank calls this)
    the loop runs the sharded step: the full params (and opt) are cut by
    ``distributed.training_specs`` (``fsdp``: the layer stacks over the
    data ranks too), ``data_fn`` yields whole batches, checkpoints are
    gathered and written by rank 0, and ``state`` holds this rank's
    slices."""
    from ..checkpoint import CheckpointManager
    from ..deploy import ExecutionPlan
    from ..models import api
    from ..optim import adam_init

    dev = resolve_device(device)
    tp = 1 if groups is None else groups.model
    plan = ExecutionPlan.build(cfg, policy, mode=_plan_mode(cfg), tp=tp)
    teacher_plan = (ExecutionPlan.build(teacher_cfg, None,
                                        mode=_plan_mode(teacher_cfg))
                    if teacher_cfg is not None else None)
    if params is None:
        params = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                                dev)
    opt = adam_init(params) if opt is None else opt
    mgr = CheckpointManager(ckpt_dir)
    state = {"params": params, "opt": opt}
    restored, step0 = mgr.restore(state)
    if restored is not None:
        state = restored
        print(f"[train] resumed from step {step0}", flush=True)
    step0 = step0 or 0
    specs = None
    if groups is not None:
        from ..distributed import training_specs
        specs = training_specs(state["params"], cfg, data=groups.data, fsdp=fsdp)
        state = shard_state(state, specs, groups)

    def save(step, state, metrics):
        if groups is not None:
            state = gather_state(state, specs, groups)
            if groups.rank:
                return
        mgr.save(step, state, {k: float(v) for k, v in metrics.items()})

    step_fn = build_train_step(plan, hparams, teacher=distill_teacher,
                               teacher_plan=teacher_plan, groups=groups,
                               specs=specs)
    data_iter = data_fn(step0)
    stop = {"now": False}

    def _sigterm(signum, frame):  # checkpoint-and-exit on preemption
        stop["now"] = True
    main_thread = threading.current_thread() is threading.main_thread()
    old = signal.signal(signal.SIGTERM, _sigterm) if main_thread else None

    watchdog = StragglerWatchdog()
    total = max_steps or hparams.total_steps
    metrics = {}
    try:
        for step in range(step0, total):
            t0 = time.time()
            params, opt, metrics = step_fn(state["params"], state["opt"],
                                           next(data_iter))
            state = {"params": params, "opt": opt}
            dt = time.time() - t0
            if watchdog.observe(step, dt):
                print(f"[train] straggler: step {step} took {dt:.2f}s "
                      f"(ema {watchdog.ema:.2f}s)", flush=True)
            if log_every and step % log_every == 0:
                ms = {k: float(v) for k, v in metrics.items()}
                print(f"[train] step {step} {ms} ({dt:.2f}s)", flush=True)
            if on_step is not None:
                on_step(step, state, metrics)
            if ckpt_every and (step + 1) % ckpt_every == 0 or stop["now"]:
                save(step + 1, state, metrics)
            if stop["now"]:
                print("[train] SIGTERM: checkpointed, exiting", flush=True)
                break
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, old)
        getattr(data_iter, "close", lambda: None)()
    return state, {k: float(v) for k, v in metrics.items()}


def shard_state(state: dict, specs, groups) -> dict:
    """``{'params', 'opt'}`` cut to this rank's slices (the Adam moments as
    their leaves)."""
    from ..distributed import shard_training
    from ..optim import AdamState
    opt = state["opt"]
    return {"params": shard_training(state["params"], specs, groups),
            "opt": AdamState(step=opt.step, m=shard_training(opt.m, specs, groups),
                             v=shard_training(opt.v, specs, groups))}


def gather_state(state: dict, specs, groups) -> dict:
    """The inverse of :func:`shard_state`: the full tree, on every rank."""
    from ..distributed import gather_training
    from ..optim import AdamState
    opt = state["opt"]
    return {"params": gather_training(state["params"], specs, groups),
            "opt": AdamState(step=opt.step, m=gather_training(opt.m, specs, groups),
                             v=gather_training(opt.v, specs, groups))}


def main(argv=None):
    """The JAX package's flags and defaults, plus ``--device`` (default
    ``cuda``) and ``--ckpt-every``. Returns ``(state, metrics)``."""
    from ..configs import TrainHParams, get_config, reduced
    from ..core.policy import QuantPolicy
    from ..data import Prefetcher, SyntheticLM

    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="stablelm-3b")
    p.add_argument("--reduced", action="store_true",
                   help="smoke-size model (CPU)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--int4-last-k", type=int, default=-1)
    p.add_argument("--grad-mode", default="mse", choices=["mse", "ste"])
    p.add_argument("--ckpt-dir",
                   default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never falls back on its own")
    args = p.parse_args(argv)

    cfg = get_config(args.arch)
    check_trainable(cfg)
    dev = resolve_device(args.device)
    if args.reduced:
        cfg = reduced(cfg)
    # an encoder-decoder's policy covers its decoder layers, as in JAX
    n_units = cfg.dec_layers if cfg.family == "encdec" else cfg.num_layers
    k4 = args.int4_last_k if args.int4_last_k >= 0 else n_units // 2
    policy = QuantPolicy(num_layers=n_units, mode="fake", last_k_int4=k4,
                         grad_mode=args.grad_mode)
    hp = TrainHParams(total_steps=args.steps)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
    state, metrics = run_training(
        cfg, policy, hp, lambda step0: Prefetcher(map(data.batch, itertools.count(step0))),
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, max_steps=args.steps,
        device=dev)
    print("[train] done", metrics, flush=True)
    return state, metrics


if __name__ == "__main__":
    main()
