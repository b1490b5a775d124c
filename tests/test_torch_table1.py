"""The port's Table 1 / Table 3 pipelines and the mixed-precision search on
the CPU.

* ``table1_glue.run_artifact(quick=True)`` (the reduced student: 4 layers,
  d 96, vocab 512, 80 fp steps): the payload has JAX's
  ``BENCH_quality.json`` schema, ``tools/check_quality.py``'s loader reads
  it and its check runs against the committed baseline's schema, the
  cheap probe ranked layers as the full re-deploy did, the W4A4 artifact
  was saved and loads; two runs give the same payload.
* ``table1_glue.run`` and ``table3_ablation.run`` at 3 steps: every row of
  the JAX files' shapes, accuracies in [0, 1].
* ``search_mixed_precision`` equals JAX's on the same synthetic scorer;
  ``cached_probe_scorer`` assembles candidates bit-equal to a full deploy
  and deploys each uniform grid once; ``load_search_policy`` reads the
  search it wrote.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import common, table1_glue, table3_ablation
from repro_torch.core.autosearch import (cached_probe_scorer, load_search_policy,
                                         search_mixed_precision)
from repro_torch.core.policy import QuantPolicy


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small, and
    at one thread a test worker does not contend with the suite's others
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROOT = Path(__file__).resolve().parents[1]


def _check_quality():
    spec = importlib.util.spec_from_file_location("check_quality",
                                                  ROOT / "tools" / "check_quality.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def payload(tmp_path_factory):
    art = tmp_path_factory.mktemp("quality") / "w4a4"
    return table1_glue.run_artifact(quick=True, artifact_dir=str(art), device="cpu")


def test_run_artifact_payload_reads_with_check_quality(payload, tmp_path):
    q = payload["quality"]
    for key in ("fp_acc", "w4a4_acc", "weight_only_acc", "delta", "agreement"):
        assert 0.0 <= abs(q[key]) <= 1.0, key
    assert q["act_bits"] == 4 and q["n_eval"] == 512 and q["backend"] == "reference"
    assert q["delta"] == pytest.approx(q["fp_acc"] - q["w4a4_acc"])
    s = payload["search"]
    assert s["probe_check"] == {"ranks_match": True, "base_matches": True}
    assert sorted(l for l, _ in s["sensitivity"]) == [0, 1, 2, 3]
    assert s["floor"] == pytest.approx(q["fp_acc"] - 0.05)
    cq = _check_quality()
    out = tmp_path / "BENCH_quality.json"
    out.write_text(json.dumps(payload, indent=2, sort_keys=True))
    data = cq.load(out)
    base = cq.load(ROOT / "benchmarks" / "BENCH_quality_baseline.json")
    assert set(data["quality"]) >= set(base["quality"])
    failures = cq.check(data, data, tolerance=0.05, max_delta=0.05)
    assert failures == ([] if q["delta"] <= 0.05 else ["delta"])
    from repro_torch.deploy import DeployedModel
    model = DeployedModel.load(q["artifact"], device="cpu")
    assert model.plan.policy.weight_bits_vector().tolist() == [4, 4, 4, 4]
    assert load_search_policy(str(out), 4).int4_layers == tuple(s["chosen_int4_layers"])


def test_run_artifact_is_deterministic(payload, tmp_path):
    again = table1_glue.run_artifact(quick=True, artifact_dir=str(tmp_path / "a"),
                                     search=False, device="cpu")
    for key in ("fp_acc", "w4a4_acc", "weight_only_acc", "agreement"):
        assert again["quality"][key] == payload["quality"][key]


def test_table1_and_table3_rows_at_three_steps():
    rows = table1_glue.run(steps=3, rows=(2,), device="cpu")
    assert [(n, a) for n, a, _ in rows] == [
        ("teacher_fp32", "-"), ("student_fp32", "-"),
        ("tinybert4_int4x2", "mkq"), ("tinybert4_int4x2", "kdlsq")]
    assert all(0.0 <= acc <= 1.0 for _, _, acc in rows)
    res = table3_ablation.run(steps=3, device="cpu")
    assert [n for n, _ in res] == ["full_mkq", "wo_mini_kd", "wo_output_kd", "wo_lsq"]
    assert all(0.0 <= acc <= 1.0 for _, acc in res)
    # one trained fp teacher and student handed to both tables: the same rows
    trained = table1_glue.teacher_and_student(3, 0, "cpu")
    assert table1_glue.run(steps=3, rows=(2,), device="cpu", trained=trained) == rows
    assert table3_ablation.run(steps=3, device="cpu", trained=trained) == res


# ----------------------------------------------------------------- search
def _synthetic_scorer(drops):
    def score(pol):
        return 0.9 - sum(drops[l] for l in (pol.int4_layers or ()))
    return score


@pytest.mark.parametrize("kw", [dict(floor_delta=0.05), dict(accuracy_floor=0.86),
                                dict(floor_delta=0.02, fp_score=0.91)])
def test_search_matches_jax(kw):
    from repro.core.autosearch import search_mixed_precision as jsearch
    drops = [0.03, 0.0, 0.01, 0.02, 0.04]
    ours = search_mixed_precision(5, _synthetic_scorer(drops), **kw)
    ref = jsearch(5, _synthetic_scorer(drops), **kw)
    assert ours.policy.int4_layers == ref.policy.int4_layers
    assert (ours.accuracy, ours.base_accuracy, ours.floor) == (ref.accuracy,
                                                               ref.base_accuracy, ref.floor)
    assert ours.sensitivity == ref.sensitivity and ours.trajectory == ref.trajectory
    assert ours.describe() == ref.describe()
    with pytest.raises(ValueError):
        search_mixed_precision(5, _synthetic_scorer(drops))


def test_cached_probe_assembles_the_full_deploy_bit_for_bit():
    from repro_torch.deploy import ExecutionPlan, deploy
    from repro_torch.models.bert import init_bert_classifier

    cfg = common.student_config(num_layers=3).replace(d_model=32, d_ff=64,
                                                      vocab_size=128)
    fp = init_bert_classifier(cfg, 2, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    calib = [{"tokens": rng.integers(1, 128, (2, 8)).astype(np.int32)}]
    deploys = []

    def deploy_fn(pol):
        deploys.append(pol)
        return deploy(fp, ExecutionPlan.build(cfg, pol, mode="encoder"), calib,
                      device="cpu")
    models = []
    cheap = cached_probe_scorer(deploy_fn, lambda m: models.append(m) or 0.5)
    pol = QuantPolicy(num_layers=3, mode="int", int4_layers=(0, 2))
    assert cheap(pol) == 0.5 and cheap(pol) == 0.5
    assert len(deploys) == 2 and len(models) == 1          # two grids, one score
    full = deploy_fn(pol)
    assembled = models[0]
    assert assembled.plan == full.plan
    for a, b in zip(assembled.params["layers"], full.params["layers"]):
        flat_a = dict(_leaves(a))
        for k, v in _leaves(b):
            assert torch.equal(flat_a[k], v), k
    cheap(dataclasses.replace(pol, int4_layers=(1,)))
    assert len(deploys) == 3                                 # still no new grid


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree
