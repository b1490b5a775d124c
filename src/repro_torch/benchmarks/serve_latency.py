"""Serving latency/throughput benchmark of the port: weight precision x
KV-cache precision, measured end to end through ``ServingEngine``, the
counterpart of the JAX package's ``benchmarks/serve_latency.py``.

For each variant the same small gelu-FFN causal LM (the reduced
``stablelm-3b`` with ``act="gelu"``, so the int4 variants take the fused
bias + GELU epilogue) is deployed and a burst of requests runs through the
engine (chunked prefill + batched decode), best of three bursts after a
warm-up burst. The ``kv_bits`` axis covers the fp cache and the int8/int4
cache with the decode-attention kernel. Reported per variant: the engine's
``ServeMetrics`` summary (tokens/s, p50/p99 step latency, TTFT and queue
wait). A second section, ``prefix_scenario``, serves a repeated-prefix
workload with the prefix cache off and on; its headline is the prefill
tokens computed, which is deterministic.

The JSON keeps the JAX file's schema (``variants``, ``prefix_scenario``),
so ``tools/check_bench.py`` reads it unchanged; ``backend`` names the
device the run took, and ``card`` the card. On the card the ``cuda``
variants run the hand-written kernels; with ``--device cpu`` they run the
kernels' plain versions and the timings are the host's.

``python -m repro_torch.benchmarks.serve_latency [--quick] [--device cpu]
[--out BENCH_serve.json]``
"""
from __future__ import annotations

import argparse
import json
import platform
from typing import Optional

import numpy as np
import torch

from ..configs import get_config, reduced
from ..core.policy import QuantPolicy
from ..deploy import ExecutionPlan, deploy
from ..device import resolve_device
from ..models import api
from ..serving import GenerationRequest, ServingEngine


def bench_config():
    """The benchmark's model: reduced stablelm-3b with a GELU FFN."""
    return reduced(get_config("stablelm-3b")).replace(act="gelu")


def device_info(dev: torch.device) -> dict:
    out = {"backend": dev.type, "platform": platform.platform()}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
    return out


def build_params(cfg, policy, backend, fuse, dev, act_bits=None):
    """fp params from a seeded generator, deployed under (policy, backend,
    fuse, act_bits) when ``policy`` is set."""
    plan = ExecutionPlan.build(cfg, policy, backend=backend,
                               fuse_epilogue=fuse, act_bits=act_bits)
    params = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if policy is not None:
        params = deploy(params, plan, device=dev).params
    return params


def _serve_burst(eng, cfg, n_requests, max_new, seed=0, prefix=None):
    rng = np.random.default_rng(seed)
    shared = (np.zeros(0, np.int32) if prefix is None
              else np.asarray(prefix, np.int32))
    for _ in range(n_requests):
        plen = int(rng.integers(4, 12))
        tail = rng.integers(1, cfg.vocab_size, plen).astype(np.int32)
        eng.submit(GenerationRequest(prompt=np.concatenate([shared, tail]),
                                     max_new_tokens=max_new))
    eng.run_until_drained()
    eng.pop_done()


def _warmup(eng, cfg):
    """One request per prefill bucket the timed bursts hit (8 and 16) plus
    decode steps, outside the metrics window: first calls allocate."""
    rng = np.random.default_rng(123)
    for plen in (6, 11):
        eng.submit(GenerationRequest(
            prompt=rng.integers(1, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=2))
    eng.run_until_drained()
    eng.pop_done()


def _best_of(eng, cfg, reps=3, **burst) -> dict:
    """Best-of-``reps`` bursts by tokens/s: host noise only ever slows a
    burst, so the fastest is the least disturbed run of the same path."""
    eng.metrics.pop_summary()           # drop warm-up events
    best = None
    for rep in range(reps):
        _serve_burst(eng, cfg, seed=rep, **burst)
        s = eng.metrics.pop_summary()
        if best is None or s["tokens_per_s"] > best["tokens_per_s"]:
            best = s
    return best, s


def run_variants(quick: bool = False, device=None) -> dict:
    dev = resolve_device(device)
    cfg = bench_config()
    n = cfg.num_layers
    n_requests = 3 if quick else 8
    max_new = 4 if quick else 8
    int8_pol = QuantPolicy(num_layers=n, mode="int", last_k_int4=0)
    int4_pol = QuantPolicy(num_layers=n, mode="int", last_k_int4=n)
    # (name, policy, backend, fuse_epilogue, kv_bits, act_bits): act_bits
    # None follows the policy, 8 retargets activations to the int8 grid, 0
    # is the fp-activation weight-only parity path (reference backend)
    variants = [
        ("fp32_kv16", None, "reference", False, 16, None),
        ("int8_kv16", int8_pol, "cuda", False, 16, None),
        ("int4_kv16", int4_pol, "cuda", True, 16, None),
        ("int4_kv8", int4_pol, "cuda", True, 8, None),
        ("int4_kv4", int4_pol, "cuda", True, 4, None),
        ("int4_kv4_a8", int4_pol, "cuda", True, 4, 8),
        ("int4_kv16_afp", int4_pol, "reference", False, 16, 0),
    ]
    results, built = {}, {}
    for name, policy, backend, fuse, kv_bits, act_bits in variants:
        key = (id(policy), backend, fuse, act_bits)
        if key not in built:   # packed weights do not depend on kv_bits
            built[key] = build_params(cfg, policy, backend, fuse, dev, act_bits)
        plan = ExecutionPlan.build(cfg, policy, backend=backend, kv_bits=kv_bits,
                                   fuse_epilogue=fuse, act_bits=act_bits)
        eng = ServingEngine(built[key], plan, slots=2, max_len=64)
        _warmup(eng, cfg)
        results[name], _ = _best_of(eng, cfg, n_requests=n_requests, max_new=max_new)
    return results


def run_prefix_scenario(quick: bool = False, device=None) -> dict:
    """Repeated-prefix workload: every request = one shared 16-token prefix
    + a random tail, served with the prefix cache off and on (batched
    prefill on in both). The counters come from the last burst as one
    coherent set (the first warms the cache); the timings from the best."""
    dev = resolve_device(device)
    cfg = bench_config()
    n = cfg.num_layers
    n_requests = 4 if quick else 12
    max_new = 4 if quick else 8
    prefix = np.random.default_rng(7).integers(1, cfg.vocab_size, 16).astype(np.int32)
    int4_pol = QuantPolicy(num_layers=n, mode="int", last_k_int4=n)
    int8_pol = QuantPolicy(num_layers=n, mode="int", last_k_int4=0)
    variants = [("int4_kv4", int4_pol, 4)]
    if not quick:
        variants.append(("int8_kv8", int8_pol, 8))
    out = {}
    for name, policy, kv_bits in variants:
        params = build_params(cfg, policy, "cuda", kv_bits == 4, dev)
        for mode, budget in (("off", 0), ("on", 32 << 20)):
            plan = ExecutionPlan.build(cfg, policy, backend="cuda", kv_bits=kv_bits,
                                       fuse_epilogue=kv_bits == 4,
                                       prefix_cache=budget, prefill_batch=4)
            eng = ServingEngine(params, plan, slots=2, max_len=64)
            _warmup(eng, cfg)
            best, last = _best_of(eng, cfg, n_requests=n_requests,
                                  max_new=max_new, prefix=prefix)
            for key in ("prefill_tokens", "prefill_steps", "prefix_lookups",
                        "prefix_hit_rate", "prefill_tokens_saved",
                        "prefix_reuse_frac"):
                if key in last:
                    best[key] = last[key]
                else:
                    best.pop(key, None)
            out[f"{name}_prefix_{mode}"] = best
    return out


def main(quick: bool = False, out: Optional[str] = "BENCH_serve.json",
         device=None) -> dict:
    dev = resolve_device(device)
    results = run_variants(quick=quick, device=dev)
    print("variant,tokens_per_s,decode_p50_ms,decode_p99_ms,prefill_p50_ms,"
          "prefill_p99_ms,ttft_p50_ms,queue_wait_p50_ms,total_tokens")
    for name, s in results.items():
        print(f"{name},{s['tokens_per_s']:.1f},{s.get('decode_p50_ms', 0):.2f},"
              f"{s.get('decode_p99_ms', 0):.2f},{s.get('prefill_p50_ms', 0):.2f},"
              f"{s.get('prefill_p99_ms', 0):.2f},{s.get('ttft_p50_ms', 0):.2f},"
              f"{s.get('queue_wait_p50_ms', 0):.2f},{s['total_tokens']}")
    prefix = run_prefix_scenario(quick=quick, device=dev)
    print("prefix_variant,prefill_tokens,prefix_hit_rate,prefill_tokens_saved,"
          "ttft_p50_ms,tokens_per_s")
    for name, s in prefix.items():
        print(f"{name},{s['prefill_tokens']},{s.get('prefix_hit_rate', 0):.2f},"
              f"{s.get('prefill_tokens_saved', 0)},{s.get('ttft_p50_ms', 0):.2f},"
              f"{s['tokens_per_s']:.1f}")
    payload = {"bench": "serve_latency", "quick": quick, **device_info(dev),
               "variants": results, "prefix_scenario": prefix}
    if out:
        with open(out, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        print(f"[serve_latency] wrote {out}")
    return payload


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--out", default="BENCH_serve.json",
                   help="machine-readable results path ('' to skip)")
    a = p.parse_args()
    main(quick=a.quick, out=a.out or None, device=a.device)
