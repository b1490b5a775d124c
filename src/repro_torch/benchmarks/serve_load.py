"""Trace-driven serving load benchmark of the port: SLO goodput under
offered load, the counterpart of the JAX package's
``benchmarks/serve_load.py``. One JSON (``BENCH_load.json``), three parts:

* **wall** — the closed-loop generator (``serving.loadgen``) replays a
  Poisson arrival mix (mixed prompt/output lengths, shared-prefix traffic,
  priorities, deadlines, mid-flight cancellations) against real engines on
  the system clock, repeated over trials, and reports goodput + latency
  percentiles with bootstrap confidence intervals. The SLO thresholds and
  the offered rate are self-calibrated from a warm-up burst on the same
  device (multiples of the measured prefill/decode step cost).
* **virtual** — the same generator on a ``VirtualClock`` with a fixed
  ``VirtualCost``: steady, overload-shedding and cancel-churn scenarios on
  the decoder, the steady one again on a W4A4 engine, a pure encoder
  stream, and the paged-vs-dense capacity burst under one KV byte budget.
  Their goodput / shed / reject numbers are exact and machine-independent.

The JAX file's ``mixed_tenant`` and ``replica_scale`` scenarios need the
multi-tenant engine and replica sets, which arrive with a later slice of
the port; they are not run. The int4 wall variant runs without the JAX
engine's ``warmup=`` pre-compilation (the port's counterpart is the step
under CUDA graphs, ROADMAP Queue 4 item 1: performance work after the first
benchmark). The JSON keeps the JAX file's
schema, so ``tools/check_bench.py`` reads it unchanged.

``python -m repro_torch.benchmarks.serve_load [--quick] [--device cpu]
[--trials N] [--trace T.json] [--out BENCH_load.json]``
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from ..core.policy import QuantPolicy
from ..deploy import ExecutionPlan, deploy
from ..device import resolve_device
from ..models.bert import init_bert_classifier, tinybert_config
from ..serving import (SLO, BlockPool, GenerationRequest, ServingEngine,
                       VirtualClock, VirtualCost, Workload, bootstrap_summary,
                       run_trials)
from ..serving.loadgen import load_trace
from ..serving.prefix_cache import PREFIX_BLOCK
from .serve_latency import bench_config, build_params, device_info

#: SLO / load calibration multipliers over the measured warm-up step cost
TTFT_MULT = 10.0       # ttft_s  = TTFT_MULT * (prefill_p50 + decode_p50)
ITL_MULT = 8.0         # itl_s   = ITL_MULT  * (prefill_p50 + decode_p50)
DEADLINE_MULT = 30.0   # deadline_s = DEADLINE_MULT * service_s
UTILIZATION = 0.5      # offered rate as a fraction of measured capacity

#: the virtual section's fixed cost model: NOT calibrated, so its numbers
#: are the same on every host
VCOST = VirtualCost(decode_step_s=0.01, prefill_per_token_s=0.001)


def _int4_policy(cfg) -> QuantPolicy:
    return QuantPolicy(num_layers=cfg.num_layers, mode="int",
                       last_k_int4=cfg.num_layers)


def calibrate(eng, cfg, w: Workload) -> dict:
    """Warm every path the load mix takes outside the measured window and
    derive the SLOs and the offered rate from the measured step costs."""
    rng = np.random.default_rng(123)
    for plen in (6, 11):                       # buckets 8 and 16
        eng.submit(GenerationRequest(
            prompt=rng.integers(1, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=2))
    if eng.prefix_cache is not None and w.shared_prefix_frac > 0:
        # the shared-prefix bucket: a cold publish, then a warm hit
        prefix = rng.integers(1, cfg.vocab_size, w.shared_prefix_len).astype(np.int32)
        for _ in range(2):
            tail = rng.integers(1, cfg.vocab_size, 6).astype(np.int32)
            eng.submit(GenerationRequest(prompt=np.concatenate([prefix, tail]),
                                         max_new_tokens=2))
    eng.run_until_drained()
    eng.pop_done()
    s = eng.metrics.pop_summary()              # drop warm-up events
    prefill_s = s.get("prefill_p50_ms", 50.0) / 1e3
    decode_s = s.get("decode_p50_ms", 10.0) / 1e3
    step_s = prefill_s + decode_s
    mean_new = (w.new_tokens[0] + w.new_tokens[1]) / 2.0
    service_s = prefill_s + mean_new * decode_s
    return {"prefill_p50_ms": prefill_s * 1e3, "decode_p50_ms": decode_s * 1e3,
            "service_s": service_s,
            "rate_rps": UTILIZATION * eng.slots / service_s,
            "ttft_slo_s": TTFT_MULT * step_s, "itl_slo_s": ITL_MULT * step_s,
            "deadline_s": DEADLINE_MULT * service_s}


def run_wall(quick: bool, trials: Optional[int], trace: Optional[list],
             dev) -> dict:
    """Per variant: calibrate, then run the trial set on ONE engine (drained
    between trials, so only the prefix cache stays warm)."""
    n_trials = trials if trials is not None else (2 if quick else 4)
    n_requests = 10 if quick else 32
    cfg = bench_config()
    out = {}
    for name, use_int4, prefix_cache in (("fp32_kv16", False, 0),
                                         ("int4_kv4", True, 32 << 20)):
        policy = _int4_policy(cfg) if use_int4 else None
        backend = "cuda" if use_int4 else "reference"
        params = build_params(cfg, policy, backend, use_int4, dev)
        plan = ExecutionPlan.build(cfg, policy, backend=backend,
                                   kv_bits=4 if use_int4 else 16,
                                   fuse_epilogue=use_int4, prefix_cache=prefix_cache)
        eng = ServingEngine(params, plan, slots=2, max_len=64)
        w = Workload(n_requests=n_requests, vocab=cfg.vocab_size,
                     prompt_len=(4, 12), new_tokens=(2, 6),
                     shared_prefix_frac=0.5 if prefix_cache else 0.0,
                     sampled_frac=0.25, priorities=(0, 1), deadline_frac=0.2,
                     cancel_frac=0.2, cancel_after_tokens=2)
        calib = calibrate(eng, cfg, w)
        w = dataclasses.replace(w, rate_rps=calib["rate_rps"],
                                deadline_s=calib["deadline_s"])
        slo = SLO(ttft_s=calib["ttft_slo_s"], itl_s=calib["itl_slo_s"])
        results = run_trials(lambda: eng, w, n_trials=n_trials, trace=trace)
        fin = eng.metrics.summary()
        step_latency = {"warmup": False}
        for kind in ("prefill", "decode"):
            for suffix in ("first_ms", "steady_p50_ms"):
                key = f"{kind}_{suffix}"
                if key in fin:
                    step_latency[key] = fin[key]
        out[name] = {"calibration": calib,
                     "workload": {k: v for k, v in w.__dict__.items()
                                  if not isinstance(v, np.ndarray)},
                     "step_latency": step_latency,
                     "summary": bootstrap_summary(results, slo)}
        g = out[name]["summary"].get("goodput", {})
        print(f"[wall] {name}: goodput {g.get('mean', 0):.3f} "
              f"[{g.get('lo', 0):.3f}, {g.get('hi', 0):.3f}] over "
              f"{n_trials}x{n_requests} requests")
    return out


def virtual_scenarios(quick: bool, vocab: int) -> list[tuple]:
    """(name, workload, slo, max_queue) of the decoder's virtual runs."""
    n = 12 if quick else 32
    return [
        ("steady", Workload(n_requests=n, rate_rps=25.0, vocab=vocab,
                            prompt_len=(4, 12), new_tokens=(2, 6)),
         SLO(ttft_s=0.5, itl_s=0.1), None),
        ("overload_shed", Workload(n_requests=n, rate_rps=400.0, vocab=vocab,
                                   prompt_len=(4, 12), new_tokens=(4, 8),
                                   deadline_frac=1.0, deadline_s=0.05),
         SLO(ttft_s=0.2, itl_s=0.1), 4),
        ("cancel_churn", Workload(n_requests=n, rate_rps=50.0, vocab=vocab,
                                  prompt_len=(4, 12), new_tokens=(4, 8),
                                  cancel_frac=0.6, cancel_after_tokens=3),
         SLO(ttft_s=0.5, itl_s=0.1), None),
    ]


def run_virtual(quick: bool, dev) -> dict:
    """The decoder's virtual scenarios on the fp reference plan, and the
    steady one again on a deployed W4A4 engine (int4 weights, act_bits 4,
    the kernels): the cost model keeps its timing identical by construction,
    so the row shows the int4 serving loop scheduling and completing
    exactly like fp."""
    cfg = bench_config()
    plan = ExecutionPlan.build(cfg, None, backend="reference")
    params = build_params(cfg, None, "reference", False, dev)
    w4_plan = ExecutionPlan.build(cfg, _int4_policy(cfg), backend="cuda", act_bits=4)
    w4_params = build_params(cfg, _int4_policy(cfg), "cuda", None, dev, act_bits=4)
    scenarios = virtual_scenarios(quick, cfg.vocab_size)
    steady = next((w, slo, q) for n, w, slo, q in scenarios if n == "steady")
    runs = ([(n, plan, params, w, slo, q) for n, w, slo, q in scenarios]
            + [("steady_w4a4", w4_plan, w4_params, *steady)])
    out = {}
    for name, sc_plan, sc_params, w, slo, max_queue in runs:
        def make_engine(sc_plan=sc_plan, sc_params=sc_params, max_queue=max_queue):
            return ServingEngine(sc_params, sc_plan, slots=2, max_len=64,
                                 max_queue=max_queue, clock=VirtualClock())
        s = bootstrap_summary(run_trials(make_engine, w, n_trials=2, cost=VCOST), slo)
        out[name] = {"cost": VCOST.__dict__, "summary": s}
        g = s.get("goodput", {"mean": 0.0})
        print(f"[virtual] {name}: goodput {g['mean']:.3f}, shed {s['n_shed']}, "
              f"rejected {s['n_rejected']}, cancelled {s['n_cancelled']}")
    return out


def encoder_model(dev):
    """A small int4 W4A4 BERT classifier under a mode='encoder' plan on the
    kernel backend."""
    bcfg = tinybert_config(num_classes=2, layers=2, d=64, heads=4, d_ff=128,
                           vocab=256, name="tinybert-bench")
    bpol = QuantPolicy(num_layers=bcfg.num_layers, mode="int",
                       last_k_int4=bcfg.num_layers)
    bplan = ExecutionPlan.build(bcfg, bpol, backend="cuda", act_bits=4,
                                mode="encoder", prefill_batch=4)
    bparams = init_bert_classifier(bcfg, 2, torch.Generator(device=dev).manual_seed(7),
                                   dev)
    return deploy(bparams, bplan, device=dev)


def run_virtual_encoder(quick: bool, dev) -> dict:
    """``encoder_steady``: a pure classify stream against the encoder
    engine, prefill-only goodput on the virtual clock."""
    n = 12 if quick else 32
    bmodel = encoder_model(dev)
    w_enc = Workload(n_requests=n, rate_rps=40.0, vocab=256, prompt_len=(4, 12),
                     encode_frac=1.0)
    slo_enc = SLO(ttft_s=0.3, itl_s=0.1)
    results = run_trials(lambda: ServingEngine(bmodel, slots=2, max_len=64,
                                               clock=VirtualClock()),
                         w_enc, n_trials=2, cost=VCOST)
    s = bootstrap_summary(results, slo_enc)
    g = s.get("goodput", {"mean": 0.0})
    print(f"[virtual] encoder_steady: goodput {g['mean']:.3f}, "
          f"completed {s['n_completed']}/{s['n_counted']}")
    return {"encoder_steady": {"cost": VCOST.__dict__, "summary": s}}


def run_paged_capacity(quick: bool, dev) -> dict:
    """Paged vs dense under ONE KV byte budget (exactly what dense
    preallocates for 4 slots at kv4): short requests burst at t = 0 into
    both layouts. Reports peak concurrency, ``capacity_ratio`` (paged /
    dense), goodput, and whether the per-request streams are byte-identical
    across layouts."""
    n = 12 if quick else 24
    dense_slots, paged_slots, max_len = 4, 16, 64
    cfg = bench_config()
    pol = _int4_policy(cfg)
    budget = dense_slots * (max_len // PREFIX_BLOCK) * BlockPool.block_bytes(
        cfg, 4, torch.float32)
    rng = np.random.default_rng(42)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(3, 7))).tolist()
               for _ in range(n)]
    params = build_params(cfg, pol, "cuda", None, dev)

    def burst(paging, slots, kv_budget):
        plan = ExecutionPlan.build(cfg, pol, backend="cuda", kv_bits=4,
                                   kv_paging=paging)
        kw = {"kv_budget_bytes": kv_budget} if paging == "paged" else {}
        eng = ServingEngine(params, plan, slots=slots, max_len=max_len,
                            clock=VirtualClock(), **kw)
        streams = [eng.submit(GenerationRequest(prompt=p, max_new_tokens=4))
                   for p in prompts]
        peak = 0
        for _ in range(10_000):
            eng.engine_step()
            peak = max(peak, sum(1 for r in eng.active if r is not None))
            if not (eng.queue or any(r is not None for r in eng.active)):
                break
        done = eng.pop_done()
        toks = [tuple(s.result().tokens) for s in streams]
        good = sum(r.finish_reason == "length" for r in done)
        cell = {"slots": slots, "peak_concurrent": peak,
                "goodput": {"mean": good / n}, "n_requests": n}
        if paging == "paged":
            st = eng.pool.stats()
            cell["kv"] = {k: st[k] for k in ("blocks_total", "block_bytes",
                                             "budget_bytes", "cow_forks",
                                             "evictions")}
        return cell, toks

    dense_cell, dense_toks = burst("dense", dense_slots, None)
    paged_cell, paged_toks = burst("paged", paged_slots, budget)
    ratio = paged_cell["peak_concurrent"] / max(dense_cell["peak_concurrent"], 1)
    out = {"budget_bytes": budget, "dense": dense_cell, "paged": paged_cell,
           "capacity_ratio": ratio, "streams_match": dense_toks == paged_toks}
    print(f"[virtual] paged_capacity: {paged_cell['peak_concurrent']} vs "
          f"{dense_cell['peak_concurrent']} concurrent under {budget >> 10}KiB "
          f"({ratio:.1f}x), streams_match={out['streams_match']}")
    return out


def main(quick: bool = False, trials: Optional[int] = None,
         trace_path: Optional[str] = None,
         out: Optional[str] = "BENCH_load.json", device=None) -> dict:
    dev = resolve_device(device)
    trace = load_trace(trace_path) if trace_path else None
    wall = run_wall(quick, trials, trace, dev)
    virtual = run_virtual(quick, dev)
    virtual.update(run_virtual_encoder(quick, dev))
    virtual["paged_capacity"] = run_paged_capacity(quick, dev)
    payload = {"bench": "serve_load", "quick": quick, "trace": trace_path,
               **device_info(dev), "wall": wall, "virtual": virtual}
    if out:
        with open(out, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        print(f"[serve_load] wrote {out}")
    return payload


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--trials", type=int, default=None,
                   help="override the wall-mode trial count")
    p.add_argument("--trace", default=None,
                   help="recorded-trace JSON to replay in wall mode")
    p.add_argument("--out", default="BENCH_load.json",
                   help="machine-readable results path ('' to skip)")
    a = p.parse_args()
    main(quick=a.quick, trials=a.trials, trace_path=a.trace, out=a.out or None,
         device=a.device)
