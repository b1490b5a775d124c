"""Port parity: the load generator (``serving/loadgen.py``).

* ``make_arrivals`` / ``trace_arrivals``: the same (workload, seed) gives
  the port and the JAX package the same arrivals, field for field (prompts,
  sampling knobs, priorities, deadlines, cancels, encode tasks): exact.
* ``run_load`` on a ``VirtualClock`` with a ``VirtualCost``: the port's
  engine (kernel backend, the plain versions on CPU tensors) and JAX's
  engine (its jnp reference backend) serving the same JAX-saved artifact
  (reduced stablelm-3b, layers 0-1 W8A8, 2-3 W4A4, kv_bits 8) give the same
  records (tokens, finish reasons, every clock stamp) and the same
  ``bootstrap_summary``, exactly: virtual time is a function of the op
  sequence, and the greedy streams are equal (``test_torch_decode.py``).
  The mix carries deadlines, priorities, mid-flight cancels, a bounded
  queue (rejections) and decoder ``score`` requests.
* Arrival times are offsets from the start of the replay, also on a clock
  far from 0 (JAX's generator releases every arrival at once there).
* The wall-clock mode on the port's system clock: every offered request is
  accounted for, and the replay lasts at least until the last arrival.
* The wall-clock mode measures TTFT and encode latency from when a request
  was due, so the wait for the step boundary at which it is submitted
  counts (no coordinated omission); exact on a hand-driven clock.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.deploy import DeployedModel as JDeployedModel
from repro.deploy import ExecutionPlan as JExecutionPlan
from repro.deploy import deploy as jdeploy
from repro.serving import ServingEngine as JServingEngine
from repro.serving import VirtualClock as JVirtualClock
from repro.serving import loadgen as jloadgen
from repro_torch.configs import get_config, reduced
from repro_torch.deploy import DeployedModel
from repro_torch.models import api
from repro_torch.serving import (SLO, ServingEngine, VirtualClock, VirtualCost,
                                 Workload, bootstrap_summary, make_arrivals,
                                 run_load, run_trials, trace_arrivals)
from repro_torch.serving import loadgen

WORKLOADS = {
    "mixed": Workload(n_requests=12, rate_rps=30.0, vocab=256, prompt_len=(3, 14),
                      new_tokens=(2, 6), shared_prefix_frac=0.3, sampled_frac=0.3,
                      priorities=(0, 1, 2), deadline_frac=0.3, deadline_s=0.2,
                      cancel_frac=0.2, cancel_after_tokens=3, encode_frac=0.25,
                      encode_task="score"),
    "plain": Workload(n_requests=9, rate_rps=5.0, vocab=256),
}
COST = VirtualCost(decode_step_s=0.01, prefill_per_token_s=0.001,
                   encode_per_token_s=0.0005)
SLO_ = SLO(ttft_s=0.15, itl_s=0.03)


def _jworkload(w: Workload):
    return jloadgen.Workload(**dataclasses.asdict(w))


def _same_arrivals(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.prompt.dtype == b.prompt.dtype
        for f in ("t", "max_new_tokens", "priority", "deadline_s",
                  "cancel_after_tokens", "task", "tenant"):
            assert getattr(a, f) == getattr(b, f), f
        if b.sampling is None:
            assert a.sampling is None
        else:
            assert dataclasses.asdict(a.sampling) == dataclasses.asdict(b.sampling)


@pytest.mark.parametrize("name", list(WORKLOADS))
@pytest.mark.parametrize("seed", [0, 3])
def test_make_arrivals_equal_jax(name, seed):
    w = WORKLOADS[name]
    _same_arrivals(make_arrivals(w, seed=seed), jloadgen.make_arrivals(_jworkload(w),
                                                                      seed=seed))


def test_trace_arrivals_equal_jax(tmp_path):
    trace = [0.0, 0.05, {"t": 0.01, "prompt_len": 9, "max_new_tokens": 3,
                         "priority": 2, "deadline_s": 0.5},
             {"t": 0.2, "temperature": 0.7, "cancel_after_tokens": 1}, 0.3]
    path = tmp_path / "trace.json"
    path.write_text(__import__("json").dumps(trace))
    assert loadgen.load_trace(str(path)) == trace
    w = WORKLOADS["plain"]
    _same_arrivals(trace_arrivals(trace, w, seed=5),
                   jloadgen.trace_arrivals(trace, _jworkload(w), seed=5))
    with pytest.raises(ValueError, match="JSON list"):
        path.write_text('{"t": 1}')
        loadgen.load_trace(str(path))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX reference-backend model, the port's model loaded from the
    artifact JAX saves)."""
    cfg = reduced(get_config("stablelm-3b"))
    jcfg = jreduced(jget_config("stablelm-3b"))
    rng = np.random.default_rng(0)
    tree = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    const = lambda a: bool(torch.all(a == 0) or torch.all(a == 1))
    fp = jax.tree.map(lambda a: a.numpy() if const(a)
                      else rng.normal(0, 0.02, tuple(a.shape)).astype(np.float32), tree)
    calib = [{"tokens": np.random.default_rng(0).integers(1, 256, (4, 16)).astype(np.int32)}]
    policy = JQuantPolicy(num_layers=4, mode="int", last_k_int4=2)
    jparams = jdeploy(jax.tree.map(jnp.asarray, fp),
                      JExecutionPlan.build(jcfg, policy), calib).params
    path = str(tmp_path_factory.mktemp("loadgen_art") / "art")
    JDeployedModel(plan=JExecutionPlan.build(jcfg, policy, backend="pallas", kv_bits=8,
                                             prefill_batch=2),
                   params=jparams).save(path)
    jmodel = JDeployedModel(plan=JExecutionPlan.build(
        jcfg, policy, backend="reference", kv_bits=8, prefill_batch=2), params=jparams)
    return jmodel, DeployedModel.load(path, device="cpu")


RECORD_FIELDS = ("index", "arrival_t", "submit_t", "prompt_len", "max_new_tokens",
                 "priority", "deadline_s", "injected_cancel", "task", "rid",
                 "token_times", "tokens", "finish_reason", "finish_t", "queue_wait_s")


@pytest.mark.parametrize("rate,max_queue,deadline_frac,deadline_s",
                         [(30.0, None, 0.3, 0.2), (400.0, 4, 1.0, 0.02)],
                         ids=["steady", "overload"])
def test_virtual_run_load_equals_jax(models, rate, max_queue, deadline_frac,
                                     deadline_s):
    """Greedy traffic (the sampled share off: the two packages draw sampled
    tokens from different generators) with score requests, deadlines,
    cancels and, overloaded past a bounded queue, sheds and rejections."""
    jmodel, model = models
    w = dataclasses.replace(WORKLOADS["mixed"], sampled_frac=0.0, rate_rps=rate,
                            deadline_frac=deadline_frac, deadline_s=deadline_s)
    jres = jloadgen.run_trials(
        lambda: JServingEngine(jmodel, slots=3, max_len=64, max_queue=max_queue,
                               clock=JVirtualClock()),
        _jworkload(w), n_trials=2, cost=jloadgen.VirtualCost(**dataclasses.asdict(COST)))
    res = run_trials(lambda: ServingEngine(model, slots=3, max_len=64,
                                           max_queue=max_queue, clock=VirtualClock()),
                     w, n_trials=2, cost=COST)
    for r, jr in zip(res, jres):
        assert (r.steps, r.duration_s) == (jr.steps, jr.duration_s)
        for rec, jrec in zip(r.records, jr.records, strict=True):
            for f in RECORD_FIELDS:
                assert getattr(rec, f) == getattr(jrec, f), (rec.index, f)
        assert r.summary(SLO_) == jr.summary(jloadgen.SLO(**dataclasses.asdict(SLO_)))
    outcomes = {rec.finish_reason for r in res for rec in r.records}
    assert {"length", "done", "cancelled"} <= outcomes
    if max_queue:
        assert {"rejected", "shed"} <= outcomes
    assert bootstrap_summary(res, SLO_, n_boot=50) == jloadgen.bootstrap_summary(
        jres, jloadgen.SLO(**dataclasses.asdict(SLO_)), n_boot=50)


def test_virtual_mode_needs_a_virtual_clock(models):
    _, model = models
    with pytest.raises(TypeError, match="VirtualClock"):
        run_load(ServingEngine(model, slots=2, max_len=64),
                 make_arrivals(WORKLOADS["plain"]), cost=COST)


def test_arrivals_are_offsets_from_the_start_of_the_replay(models):
    """Arrival ``i`` is released at the clock's reading when the replay
    starts plus ``a.t``, also on a clock far from 0 (the system clock is
    ``time.monotonic``). The JAX generator compares the offsets with the
    clock itself and releases every arrival at once there."""
    _, model = models
    arrivals = make_arrivals(Workload(n_requests=6, rate_rps=2.0, vocab=256,
                                      new_tokens=(1, 2)), seed=2)
    clock = VirtualClock(start=1000.0)
    res = run_load(ServingEngine(model, slots=4, max_len=64, clock=clock), arrivals,
                   cost=COST)
    assert [r.submit_t - 1000.0 for r in res.records] == pytest.approx(
        [a.t for a in arrivals], abs=0.05)
    assert res.duration_s >= arrivals[-1].t
    jclock = JVirtualClock(start=1000.0)
    jres = jloadgen.run_load(JServingEngine(models[0], slots=4, max_len=64, clock=jclock),
                             jloadgen.make_arrivals(_jworkload(Workload(
                                 n_requests=6, rate_rps=2.0, vocab=256,
                                 new_tokens=(1, 2))), seed=2),
                             cost=jloadgen.VirtualCost(**dataclasses.asdict(COST)))
    assert {r.submit_t for r in jres.records} == {1000.0}


def test_wall_clock_latency_runs_from_the_due_time(models):
    """Without a cost model the pump submits between engine steps: a
    request due while a step runs is submitted when it ends. Its TTFT and
    encode latency count that wait, from ``start + a.t``. The clock here is
    driven by hand: each engine step takes 0.5 s, idle waits sleep on it."""
    _, model = models
    clock = VirtualClock(start=50.0)
    eng = ServingEngine(model, slots=4, max_len=64, clock=clock)
    step = eng.engine_step

    def slow_step():
        out = step()
        clock.advance(0.5)
        return out

    eng.engine_step = slow_step
    arrivals = make_arrivals(Workload(n_requests=3, rate_rps=1.0, vocab=256,
                                      new_tokens=(2, 3)), seed=0)
    arrivals = [dataclasses.replace(a, t=t) for a, t in zip(arrivals, (0.1, 0.3, 0.4))]
    arrivals[2] = dataclasses.replace(arrivals[2], task="score")
    res = run_load(eng, arrivals, sleep=clock.advance)
    by_index = {r.index: r for r in res.records}
    first, late, enc = by_index[0], by_index[1], by_index[2]
    assert [r.due_t for r in (first, late, enc)] == pytest.approx([50.1, 50.3, 50.4])
    assert first.submit_t == pytest.approx(first.due_t, abs=0.003)
    assert late.submit_t == pytest.approx(first.submit_t + 0.5)   # after the step
    assert late.ttft_s == pytest.approx(late.token_times[0] - 50.3)
    assert late.ttft_s > late.token_times[0] - late.submit_t + 0.2
    assert enc.finish_reason == "done"
    assert enc.encode_latency_s == pytest.approx(enc.finish_t - 50.4)
    s = res.summary(SLO(ttft_s=60.0, itl_s=60.0))
    assert s["ttft_p99_ms"] == pytest.approx(1e3 * np.percentile(
        [r.token_times[0] - r.due_t for r in (first, late)], 99))


def test_wall_clock_run_load_accounts_for_every_request(models):
    """The system clock: arrivals released as time passes (the pump sleeps
    while idle); every request completes and is stamped."""
    _, model = models
    w = Workload(n_requests=5, rate_rps=200.0, vocab=256, new_tokens=(2, 3),
                 encode_frac=0.4, encode_task="score")
    arrivals = make_arrivals(w, seed=1)
    res = run_load(ServingEngine(model, slots=2, max_len=64), arrivals)
    assert res.duration_s >= arrivals[-1].t
    s = res.summary(SLO(ttft_s=60.0, itl_s=60.0))
    assert s["n_offered"] == s["n_completed"] == s["n_good"] == 5
    assert s["duration_s"] > 0 and s["ttft_p50_ms"] > 0
