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


def build_train_step(plan, hparams, teacher=None, teacher_plan=None):
    """Returns ``train_step(params, opt, batch) -> (params, opt, metrics)``;
    ``train_step.loss_fn(params, batch) -> (loss, parts)`` is its loss.

    ``plan``/``teacher_plan`` are ``ExecutionPlan``s (student QAT plan and
    fp teacher plan). ``params`` and ``opt`` are updated in place."""
    from ..core.distill import combine_losses, minilm_losses, output_loss
    from ..models import api
    from ..models.transformer import lm_loss
    from ..optim import adam_update, linear_warmup_decay, value_and_grad

    cfg = plan.cfg
    sched = linear_warmup_decay(hparams.total_steps, hparams.warmup_frac)
    lr_by_group = {"weights": hparams.lr_weights,
                   "act_scale": hparams.lr_act_scale,
                   "weight_scale": hparams.lr_weight_scale}
    distill = teacher is not None

    def loss_fn(params, batch):
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        out = api.forward(params, plan, want_taps=distill, **inputs)
        logits = out[0]
        labels = torch.as_tensor(batch["labels"], device=logits.device)
        l_train = lm_loss(logits, labels)
        if not distill:
            return l_train, {"loss/train": l_train}
        with torch.no_grad():
            t_logits, _, taps_t = api.forward(teacher, teacher_plan,
                                              want_taps=True, **inputs)
        l_out = output_loss(logits, t_logits)
        R = min(cfg.num_heads, teacher_plan.cfg.num_heads)
        l_attn, l_val = minilm_losses(out[2], taps_t, R)
        return combine_losses(l_train, l_out, l_attn, l_val,
                              hparams.alpha, hparams.beta)

    def train_step(params, opt, batch):
        _, parts, grads = value_and_grad(loss_fn, params, batch)
        params, opt = adam_update(params, grads, opt,
                                  lr_by_group=lr_by_group, schedule_fn=sched,
                                  b1=hparams.adam_b1, b2=hparams.adam_b2,
                                  eps=hparams.adam_eps,
                                  grad_clip=hparams.grad_clip)
        return params, opt, {k: v.detach() for k, v in parts.items()}

    train_step.loss_fn = loss_fn
    return train_step


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
                 device=None, params=None, opt=None):
    """The loop: resume -> step -> checkpoint; SIGTERM-safe.

    Params come from ``api.init_model`` with a generator seeded 0 on
    ``device`` unless ``params`` (and optionally ``opt``, an ``AdamState``)
    are given, e.g. the JAX package's arrays through
    ``deploy.params_from_numpy``. A checkpoint in ``ckpt_dir`` takes
    precedence over both. ``data_fn(step0)`` returns an iterator of the
    batches from step ``step0`` on (0, or the restored step); it is closed
    when the loop ends if it has a ``close``. Returns ``(state, metrics)`` with ``state =
    {'params', 'opt'}``."""
    from ..checkpoint import CheckpointManager
    from ..deploy import ExecutionPlan
    from ..models import api
    from ..optim import adam_init

    dev = resolve_device(device)
    plan = ExecutionPlan.build(cfg, policy, mode=_plan_mode(cfg))
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

    step_fn = build_train_step(plan, hparams, teacher=distill_teacher,
                               teacher_plan=teacher_plan)
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
                mgr.save(step + 1, state,
                         {k: float(v) for k, v in metrics.items()})
            if stop["now"]:
                print("[train] SIGTERM: checkpointed, exiting", flush=True)
                break
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, old)
        getattr(data_iter, "close", lambda: None)()
    return state, {k: float(v) for k, v in metrics.items()}


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

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    n_units = cfg.num_layers
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
