"""The mini QAT pipeline Table 1 and Table 3 share (the JAX package's
``benchmarks/common.py``): a reduced TinyBERT4 student and a deeper fp
teacher on the synthetic GLUE-style task, fine-tuning with optional MINI
distillation, the paper's lr-sweep protocol and calibration of a QAT
student.

Models are passed with their ``ExecutionPlan`` (cfg + segments) where the
JAX file passes ``(cfg, segments)``; params carry the device, and batches
(numpy) move to it.
"""
from __future__ import annotations

import torch

from ..configs import get_config, reduced
from ..core import qat
from ..core.distill import combine_losses, minilm_losses, output_loss
from ..core.tree import tree_map
from ..data import classification_batches
from ..deploy import ExecutionPlan
from ..models.bert import bert_classify_logits, classification_loss
from ..optim import adam_init, adam_update, linear_warmup_decay, value_and_grad

NUM_CLASSES = 2


def student_config(num_layers=4):
    return reduced(get_config("tinybert4")).replace(
        num_layers=num_layers, d_model=96, num_heads=4, num_kv_heads=4,
        d_ff=192, vocab_size=512)


def teacher_config():
    # deeper teacher (MINI distill needs no layer mapping)
    return student_config(num_layers=6).replace(d_model=128, num_heads=8,
                                                num_kv_heads=8, d_ff=256)


def plan_for(cfg, policy=None) -> ExecutionPlan:
    """The encoder plan a classifier trains and scores under (fp when
    ``policy`` is None, fake-quant for a mode='fake' policy)."""
    return ExecutionPlan.build(cfg, policy, mode="encoder")


def make_task(seed=0, seq=24, batch=64):
    cfg = student_config()
    return classification_batches(cfg.vocab_size, seq, batch,
                                  num_classes=NUM_CLASSES, seed=seed,
                                  prefetch=False)


def _tokens(params, b) -> torch.Tensor:
    return torch.as_tensor(b["tokens"], device=params["embed"].device)


@torch.no_grad()
def evaluate(params, plan, data, n_batches=8, offset=10_000):
    correct = total = 0
    for i in range(n_batches):
        b = data.batch(offset + i)
        logits = bert_classify_logits(params, plan, _tokens(params, b))
        pred = torch.argmax(logits, -1).cpu().numpy()
        correct += int((pred == b["labels"]).sum())
        total += len(b["labels"])
    return correct / total


def classifier_loss(p, plan, toks, labels, *, teacher=None, teacher_plan=None,
                    alpha=10.0, beta=1.0, use_output_kd=True, use_mini_kd=True):
    """The fine-tuning objective: cross-entropy, plus with a teacher the
    output distillation and MINI (4 relation heads) per the paper's eq. (10).
    The teacher runs under ``torch.no_grad``."""
    distill = teacher is not None
    out = bert_classify_logits(p, plan, toks, want_taps=distill)
    logits, taps_s = out if distill else (out, None)
    l_train = classification_loss(logits, labels)
    if not distill:
        return l_train
    with torch.no_grad():
        t_logits, taps_t = bert_classify_logits(teacher, teacher_plan, toks,
                                                want_taps=True)
    zero = torch.zeros((), device=logits.device)
    l_out = output_loss(logits, t_logits) if use_output_kd else zero
    if use_mini_kd:
        l_attn, l_val = minilm_losses(taps_s, taps_t, num_relation_heads=4)
    else:
        l_attn = l_val = zero
    total, _ = combine_losses(l_train, l_out, l_attn, l_val, alpha, beta)
    return total


def train_classifier(params, plan, data, *, steps, lr=3e-3, teacher=None,
                     teacher_plan=None, alpha=10.0, beta=1.0,
                     use_output_kd=True, use_mini_kd=True,
                     freeze_scales=False, on_step=None):
    """QAT (or fp) classifier training with optional MINI distillation.
    Trains a copy: ``params`` is left as it was. ``on_step(i, loss)``, if
    given, sees each step's loss (a 0-d tensor) after its update."""
    params = tree_map(torch.clone, params)
    opt = adam_init(params)
    sched = linear_warmup_decay(steps, 0.1)
    lr_by_group = {"weights": lr, "act_scale": 0.0 if freeze_scales else 0.01,
                   "weight_scale": 0.0 if freeze_scales else 0.001}
    kw = dict(teacher=teacher, teacher_plan=teacher_plan, alpha=alpha,
              beta=beta, use_output_kd=use_output_kd, use_mini_kd=use_mini_kd)

    def loss_fn(p, toks, labels):
        return classifier_loss(p, plan, toks, labels, **kw), None

    for i in range(steps):
        b = data.batch(i)
        labels = torch.as_tensor(b["labels"], device=params["embed"].device)
        loss, _, g = value_and_grad(loss_fn, params, _tokens(params, b), labels)
        params, opt = adam_update(params, g, opt, lr_by_group=lr_by_group,
                                  schedule_fn=sched, grad_clip=1.0)
        if on_step is not None:
            on_step(i, loss)
    return params


def train_best(make_params, plan, data, *, steps, lrs, eval_batches=4, **kw):
    """Paper §5.2 protocol: sweep the lr grid, keep the best dev result
    (post-LN BERT training is seed/lr sensitive; the paper reports the best
    over all hyperparameters)."""
    best, best_acc = None, -1.0
    for lr in lrs:
        params = train_classifier(make_params(), plan, data, steps=steps,
                                  lr=lr, **kw)
        acc = evaluate(params, plan, data, n_batches=eval_batches,
                       offset=20_000)
        if acc > best_acc:
            best, best_acc = params, acc
    return best


def build_qat_student(cfg, policy, data, fp_params, calib_batches=4):
    """Calibrate fp params for the given policy (weights + activations)."""
    params = qat.calibrate_weight_scales(
        fp_params, qat.default_bits_fn(cfg, policy))
    fp_plan = plan_for(cfg)
    fwd = lambda p, b: bert_classify_logits(p, fp_plan, _tokens(p, b))
    batches = [data.batch(5000 + i) for i in range(calib_batches)]
    with torch.no_grad():
        return qat.calibrate_act_scales(params, cfg, policy, fwd, batches)

