"""The paper's Table 3 in the port: ablations on TinyBERT4 (reduced,
``common.student_config``) with the last 2 layers int4 (the JAX package's
``benchmarks/table3_ablation.py``).

Rows (paper §5.5): full MKQ / w-o MINI KD / w-o output KD / w-o LSQ
(quantization scales frozen after calibration). Expectation: full MKQ is
the best option; each removed component costs accuracy. Synthetic data and
seeded ``torch.Generator`` init, as in ``table1_glue``.

``python -m repro_torch.benchmarks.table3_ablation [--quick] [--device
cpu]`` runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

from ..core.policy import QuantPolicy
from ..device import resolve_device
from . import common
from .table1_glue import QUICK_STEPS, tables_task, teacher_and_student

VARIANTS = {
    "full_mkq": dict(use_mini_kd=True, use_output_kd=True, freeze_scales=False),
    "wo_mini_kd": dict(use_mini_kd=False, use_output_kd=True, freeze_scales=False),
    "wo_output_kd": dict(use_mini_kd=True, use_output_kd=False, freeze_scales=False),
    "wo_lsq": dict(use_mini_kd=True, use_output_kd=True, freeze_scales=True),
}


def run(steps=150, seed=0, quick=False, device=None, trained=None):
    """[(variant, accuracy), ...] in ``VARIANTS`` order. ``trained``: the
    (teacher, fp student) of ``table1_glue.teacher_and_student`` at the same
    steps and seed (Table 1's), or None to train them here."""
    if quick:
        steps = QUICK_STEPS
    dev = resolve_device(device)
    cfg, tcfg, data = tables_task(seed)
    teacher, fp_student = trained or teacher_and_student(steps, seed, dev)
    pol = QuantPolicy(num_layers=cfg.num_layers, mode="fake", last_k_int4=2,
                      grad_mode="mse")
    plan = common.plan_for(cfg, pol)
    calibrated = common.build_qat_student(cfg, pol, data, fp_student)
    results = []
    for name, kw in VARIANTS.items():
        params = common.train_best(
            lambda: calibrated, plan, data, steps=steps, lrs=(1e-3, 5e-4),
            teacher=teacher, teacher_plan=common.plan_for(tcfg), **kw)
        results.append((name, common.evaluate(params, plan, data)))
    return results


def main(quick=False, device=None):
    t0 = time.perf_counter()
    results = run(quick=quick, device=device)
    print("table3,name,us_per_call,derived")
    for name, acc in results:
        print(f"table3,{name},-,accuracy={acc:.4f}")
    best = max(results, key=lambda r: r[1])[0]
    print(f"table3,best_variant,-,{best}")
    print(f"table3,total,us_per_call,{(time.perf_counter() - t0) * 1e6:.0f}")
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never falls back on its own")
    a = p.parse_args()
    main(quick=a.quick, device=a.device)
