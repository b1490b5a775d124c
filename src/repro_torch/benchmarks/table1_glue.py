"""The paper's Table 1 in the port: quality vs int4-layer count, MKQ-BERT vs
KDLSQ (the JAX package's ``benchmarks/table1_glue.py``).

GLUE is replaced by the deterministic synthetic classification task
(``repro_torch.data``): same pipeline, swappable data. Rows follow the
paper: TinyBERT4 (reduced, ``common.student_config``) with the last {1, 2,
3, 4} layers int4 (rest int8), each trained with (a) MKQ-BERT (MSE scale
grads + MINI distill + true k-bit activations) and (b) the KDLSQ baseline
(STE scale grads, int8 activations, output KD only).

``--artifact [DIR]`` runs the deployed quality bench instead: train an fp
student, calibrate, deploy a W4A4 artifact through export -> save -> load,
and score the cold artifact against the fp reference on the same task.
On the card the artifact is deployed on the ``cuda`` backend, so its
score runs through the four integer kernels; on the CPU it runs the plain
integer path (``reference``), as the JAX file does. It emits the JAX
file's ``BENCH_quality.json`` schema, which ``tools/check_quality.py``
reads, and runs the mixed-precision search (``core.autosearch``) with the
check that the cheap probe ranks layers exactly as a full re-deploy does.

Params come from seeded ``torch.Generator``s, so the numbers are the
port's own: ``jax.random``'s init cannot be reproduced, and the JAX
package's ``benchmarks/BENCH_quality_baseline.json`` does not gate them.

``python -m repro_torch.benchmarks.table1_glue [--quick] [--artifact [DIR]
--out JSON] [--device cpu]`` runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

from ..core.policy import QuantPolicy
from ..data import SyntheticClassification
from ..device import resolve_device
from ..models.bert import bert_classify_logits, init_bert_classifier
from . import common


def _init(cfg, seed: int, dev):
    """fp classifier params from a generator seeded by ``seed``."""
    return init_bert_classifier(cfg, common.NUM_CLASSES,
                                torch.Generator(device=dev).manual_seed(seed), dev)


#: the QAT steps of a table's row at ``quick`` size
QUICK_STEPS = 80


def tables_task(seed: int):
    """The tables' student and teacher configs and their synthetic task."""
    cfg, tcfg = common.student_config(), common.teacher_config()
    data = SyntheticClassification(cfg.vocab_size, 24, 64,
                                   num_classes=common.NUM_CLASSES, seed=seed)
    return cfg, tcfg, data


def teacher_and_student(steps: int, seed: int, device=None):
    """The deeper fp teacher and the fp student on ``tables_task(seed)``,
    each the best of the paper's lr sweep at ``2 * steps``; the student
    from ``seed + 1``. Table 1 and Table 3 train the same pair: a caller
    running both may train it once and hand it to each ``run``."""
    dev = resolve_device(device)
    cfg, tcfg, data = tables_task(seed)
    tplan, fplan = common.plan_for(tcfg), common.plan_for(cfg)
    teacher = common.train_best(lambda: _init(tcfg, seed, dev), tplan, data,
                                steps=2 * steps, lrs=(2e-3, 1e-3, 5e-4))
    fp_student = common.train_best(lambda: _init(cfg, seed + 1, dev), fplan,
                                   data, steps=2 * steps, lrs=(2e-3, 1e-3, 5e-4))
    return teacher, fp_student


def run(steps=150, seed=0, rows=(1, 2, 3, 4), quick=False, device=None,
        trained=None):
    """[(name, algo, accuracy), ...]: the teacher and fp student rows, then
    MKQ and KDLSQ at each int4-layer count of ``rows``. ``trained``: the
    (teacher, fp student) of ``teacher_and_student`` at the same steps and
    seed, or None to train them here."""
    if quick:
        steps, rows = QUICK_STEPS, (2, 4)
    dev = resolve_device(device)
    cfg, tcfg, data = tables_task(seed)
    tplan = common.plan_for(tcfg)
    teacher, fp_student = trained or teacher_and_student(steps, seed, dev)
    t_acc = common.evaluate(teacher, tplan, data)
    fp_acc = common.evaluate(fp_student, common.plan_for(cfg), data)
    results = [("teacher_fp32", "-", t_acc), ("student_fp32", "-", fp_acc)]

    for k4 in rows:
        for algo in ("mkq", "kdlsq"):
            pol = QuantPolicy(
                num_layers=cfg.num_layers, mode="fake", last_k_int4=k4,
                grad_mode="mse" if algo == "mkq" else "ste",
                act_bits_override=None if algo == "mkq" else 8)
            plan = common.plan_for(cfg, pol)
            calibrated = common.build_qat_student(cfg, pol, data, fp_student)
            params = common.train_best(
                lambda: calibrated, plan, data, steps=steps,
                lrs=(1e-3, 5e-4), teacher=teacher, teacher_plan=tplan,
                use_mini_kd=(algo == "mkq"), use_output_kd=True)
            acc = common.evaluate(params, plan, data)
            results.append((f"tinybert4_int4x{k4}", algo, acc))
    return results


def main(quick=False, device=None):
    t0 = time.perf_counter()
    results = run(quick=quick, device=device)
    dt_us = (time.perf_counter() - t0) * 1e6
    print("table1,name,algo,accuracy")
    for name, algo, acc in results:
        print(f"table1,{name},{algo},{acc:.4f}")
    by = {(n, a): acc for n, a, acc in results}
    ks = sorted({int(n.split("x")[1]) for n, a, _ in results if "int4" in n})
    wins = sum(by[(f"tinybert4_int4x{k}", "mkq")]
               >= by[(f"tinybert4_int4x{k}", "kdlsq")] for k in ks)
    print(f"table1,mkq_wins_over_kdlsq,derived,{wins}/{len(ks)}")
    print(f"table1,total,us_per_call,{dt_us:.0f}")
    return results


# ------------------------------------------------- deployed quality bench

@torch.no_grad()
def _preds(params, plan, data, n_batches, offset=10_000):
    """Argmax predictions through an ExecutionPlan, the plan-routed forward
    the serving encoder path runs."""
    out = []
    dev = params["embed"].device
    for i in range(n_batches):
        b = data.batch(offset + i)
        logits = bert_classify_logits(params, plan,
                                      torch.as_tensor(b["tokens"], device=dev))
        out.append(torch.argmax(logits, -1).cpu().numpy())
    return np.concatenate(out)


def run_artifact(quick=False, artifact_dir=None, search=True, seed=0,
                 device=None):
    """Train fp student -> calibrate -> deploy W4A4 -> save -> load -> score.

    Returns the BENCH_quality.json payload. The artifact deploys on the
    ``cuda`` backend on the card and on ``reference`` on the CPU. All
    randomness is seeded, so two runs on one host agree exactly.
    """
    from ..core.autosearch import cached_probe_scorer, search_mixed_precision
    from ..deploy import DeployedModel, ExecutionPlan, deploy, retarget_act_bits

    dev = resolve_device(device)
    backend = "cuda" if dev.type == "cuda" else "reference"
    steps = 80 if quick else 200
    n_eval = 8
    cfg = common.student_config()
    data = SyntheticClassification(cfg.vocab_size, 24, 64,
                                   num_classes=common.NUM_CLASSES, seed=seed)

    fp_plan = common.plan_for(cfg)
    fp_student = common.train_best(
        lambda: _init(cfg, seed, dev), fp_plan, data, steps=steps,
        lrs=(2e-3,) if quick else (2e-3, 1e-3))
    fp_acc = common.evaluate(fp_student, fp_plan, data, n_batches=n_eval)
    fp_pred = _preds(fp_student, fp_plan, data, n_eval)

    calib = [data.batch(5000 + i) for i in range(2 if quick else 4)]

    def deploy_policy(policy, act_bits=None, save_dir=None):
        plan = ExecutionPlan.build(cfg, policy, backend=backend,
                                   act_bits=act_bits, mode="encoder")
        model = deploy(fp_student, plan, calib, device=dev)
        if save_dir:   # the real serving path: cold artifact from disk
            model.save(save_dir)
            model = DeployedModel.load(save_dir, device=dev)
        return model

    def score_model(model):
        return common.evaluate(model.params, model.plan, data, n_batches=n_eval)

    # the headline row: every layer W4A4, scored from a cold artifact
    w4_pol = QuantPolicy(num_layers=cfg.num_layers, mode="int",
                         last_k_int4=cfg.num_layers)
    if artifact_dir is None:
        artifact_dir = tempfile.mkdtemp(prefix="mkq-quality-")
    w4a4 = deploy_policy(w4_pol, act_bits=4, save_dir=artifact_dir)
    w4a4_acc = score_model(w4a4)
    w4a4_pred = _preds(w4a4.params, w4a4.plan, data, n_eval)
    agreement = float((w4a4_pred == fp_pred).mean())

    # weight-only parity row: same codes, fp activations (reference backend)
    wfp_acc = score_model(retarget_act_bits(w4a4, 0))

    payload = {"quality": {
        "fp_acc": fp_acc, "w4a4_acc": w4a4_acc,
        "weight_only_acc": wfp_acc, "delta": fp_acc - w4a4_acc,
        "agreement": agreement, "act_bits": 4,
        "n_eval": int(n_eval * 64), "artifact": artifact_dir,
        "backend": backend}}

    if search:
        # relative floor: within 5 accuracy points of the fp student; each
        # probe assembles its candidate from the two cached uniform grids
        cheap = cached_probe_scorer(deploy_policy, score_model)
        res = search_mixed_precision(cfg.num_layers, cheap,
                                     floor_delta=0.05, fp_score=fp_acc)

        # the cheap probe must rank layers IDENTICALLY to the full re-deploy
        # probe (same drops, not just the same order): the assembled slices
        # are the bytes a full deploy produces
        def full(int4_layers):
            return score_model(deploy_policy(QuantPolicy(
                num_layers=cfg.num_layers, mode="int",
                int4_layers=tuple(int4_layers))))

        base_full = full(())
        full_rank = tuple(sorted(
            ((l, base_full - full((l,))) for l in range(cfg.num_layers)),
            key=lambda t: (t[1], t[0])))
        if full_rank != res.sensitivity:
            raise AssertionError(
                f"cheap probe diverged from full probe: "
                f"cheap={res.sensitivity} full={full_rank}")
        payload["search"] = {
            "probe_check": {"ranks_match": True,
                            "base_matches": base_full == res.base_accuracy},
            "floor": res.floor,
            "base_int8_acc": res.base_accuracy,
            "chosen_int4_layers": sorted(res.policy.int4_layers or ()),
            "accuracy": res.accuracy,
            "sensitivity": [[l, d] for l, d in res.sensitivity],
            "trajectory": [[list(ls), acc, ok]
                           for ls, acc, ok in res.trajectory]}
    return payload


def main_artifact(quick=False, artifact_dir=None, out=None, search=True,
                  device=None):
    t0 = time.perf_counter()
    payload = run_artifact(quick=quick, artifact_dir=artifact_dir,
                           search=search, device=device)
    q = payload["quality"]
    print("quality,metric,value")
    for k in ("fp_acc", "w4a4_acc", "weight_only_acc", "delta", "agreement"):
        print(f"quality,{k},{q[k]:.4f}")
    if "search" in payload:
        s = payload["search"]
        print(f"quality,search_int4_layers,\"{s['chosen_int4_layers']}\"")
        print(f"quality,search_acc,{s['accuracy']:.4f}")
    print(f"quality,total_s,{time.perf_counter() - t0:.1f}")
    if out:
        with open(out, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        print(f"quality,json,{out}")
    return payload


def cli(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--artifact", default=None, metavar="DIR", nargs="?",
                   const="", help="deployed-quality mode: export the W4A4 "
                   "artifact to DIR (temp dir when omitted), score it cold "
                   "against the fp reference, run the mixed-precision "
                   "search, and emit --out JSON")
    p.add_argument("--out", default=None, metavar="JSON",
                   help="artifact mode: write BENCH_quality.json here")
    p.add_argument("--no-search", action="store_true",
                   help="artifact mode: skip the mixed-precision search")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never falls back on its own")
    a = p.parse_args(argv)
    if a.artifact is not None:
        return main_artifact(quick=a.quick, artifact_dir=a.artifact or None,
                             out=a.out, search=not a.no_search, device=a.device)
    return main(quick=a.quick, device=a.device)


if __name__ == "__main__":
    cli()
