"""Serve CLI of the port: a thin shim over ``repro_torch.serving``, the
counterpart of the JAX package's ``launch/serve.py``.

Entry modes:

* default            build an ExecutionPlan, deploy an int model in-process
                     (fp weights from a seeded generator) and serve a
                     synthetic burst;
* ``--export DIR``   additionally save the DeployedModel artifact to DIR;
* ``--artifact DIR`` load a saved artifact (either package's) and serve it:
                     no fp weights, no recalibration; token streams are
                     byte-identical to the in-memory run that exported it;
* ``--mode encoder`` prefill-only serving: deploys an int4 BERT classifier
                     (or loads one with --artifact) and serves a burst of
                     ``EncodeRequest``\\ s (``--task`` classify/embed/score);
* ``--tenant NAME=DIR`` (repeatable) multi-tenant serving: each NAME loads
                     the artifact at DIR into one ``MultiTenantEngine``
                     (shared clock and metrics, deficit-round-robin fair
                     share); the burst round-robins over the tenants, encode
                     traffic for encoder artifacts, generation otherwise.

Generation flags map onto the request API: ``--temperature/--top-k/
--top-p/--seed`` build the burst's ``SamplingParams`` (temperature 0 =
greedy), ``--n`` fans each prompt into n sample streams, ``--stop`` sets
stop-token ids, ``--stream`` prints each token as the engine emits it.
``--kv-paging paged`` (+ ``--kv-budget-mb``) serves from the paged block
pool, ``--prefix-cache-mb`` turns on shared-prefix reuse, ``--policy-from``
deploys the per-layer bit assignment a search artifact chose.
``--prefill-mode token`` feeds prompts one token per step through a shared
cursor (what ``auto`` picks for ``--arch zamba2-2.7b``, the Mamba2 hybrid,
and ``--arch xlstm-1.3b``, whose requests are not held to ``--max-len``);
an encoder-decoder arch deploys but its engine is refused, as the JAX
engine cannot serve it either.

Scale axes (DESIGN.md §16): ``--replicas N`` serves the burst through a
``ReplicaSet`` of N engines over the one deployed model (least-loaded
dispatch, one rid space); ``--tp N`` shards the deployed weights and KV
heads over N ranks, one process each (``launch.mesh.spawn_tp``): over gloo
with ``--device cpu``, over NCCL on N cards with ``cuda`` (a host with
fewer cards is refused). Tensor parallelism runs the plain integer path
(``--backend reference``; the kernels are single-device); with
``--artifact`` it reshards the saved layout to N at load. Rank 0 prints
and returns the run.

The port runs on the card: ``--device`` defaults to ``cuda`` and raises on
a host without CUDA unless ``--device cpu`` is passed; it never falls back
on its own. ``--backend cuda`` (the default) runs the hand-written kernels,
``reference`` the plain integer path. ``--warmup`` is refused with an
error naming what it waits for (the engine's step under CUDA graphs,
performance work after the first benchmark).

``main(argv)`` returns what the run served (each request's tokens or
encode result, the metrics summary), so a caller can compare two runs.

``python -m repro_torch.launch.serve [--reduced] [--device cpu] ...``
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..serving import (EncodeRequest, GenerationRequest, MultiTenantEngine,
                       QueueFullError, ReplicaSet, SamplingParams,
                       ServingEngine)

#: flags that wait for a later slice of the port: flag -> what they need
LATER = {"--warmup": "the engine's step under CUDA graphs (ROADMAP Queue 4 "
                     "item 1, performance work after the first benchmark)"}


def _build_encoder_model(args, dev):
    """In-process int4 W4A4 BERT classifier artifact for --mode encoder,
    calibrated on a small synthetic batch."""
    from ..core.policy import QuantPolicy
    from ..deploy import ExecutionPlan, deploy
    from ..models.bert import init_bert_classifier, tinybert_config

    cfg = (tinybert_config(layers=4, d=96, heads=4, d_ff=192, vocab=512,
                           name="tinybert4-reduced")
           if args.reduced else tinybert_config())
    n_units = cfg.num_layers
    k4 = args.int4_last_k if args.int4_last_k >= 0 else n_units
    policy = QuantPolicy(num_layers=n_units, mode="int", last_k_int4=k4)
    plan = ExecutionPlan.build(cfg, policy, backend=args.backend,
                               mode="encoder",
                               prefill_batch=max(args.prefill_batch, 1),
                               act_bits=args.act_bits, tp=args.tp or 1)
    params = init_bert_classifier(cfg, 2, torch.Generator(device=dev).manual_seed(0),
                                  dev)
    rng = np.random.default_rng(0)
    calib = [{"tokens": torch.as_tensor(
                 rng.integers(1, cfg.vocab_size, (4, 16)), device=dev)}
             for _ in range(4)]
    return deploy(params, plan, calib, device=dev)


def _build_model(args, dev, say=print):
    """ExecutionPlan + in-process deployment (the non-artifact path)."""
    from ..configs import get_config, reduced
    from ..core.policy import QuantPolicy
    from ..deploy import ExecutionPlan, deploy
    from ..models import api

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    # an encoder-decoder's policy covers its decoder layers, as in JAX
    n_units = cfg.dec_layers if cfg.family == "encdec" else cfg.num_layers
    if args.policy_from:
        from ..core.autosearch import load_search_policy
        policy = load_search_policy(args.policy_from, n_units)
        say(f"[serve] policy from {args.policy_from}: {policy.describe()}")
    else:
        k4 = args.int4_last_k if args.int4_last_k >= 0 else n_units // 2
        policy = QuantPolicy(num_layers=n_units, mode="int", last_k_int4=k4)
    plan = ExecutionPlan.build(cfg, policy, backend=args.backend,
                               kv_bits=args.kv_bits,
                               prefill_mode=args.prefill_mode,
                               prefix_cache=int(args.prefix_cache_mb * (1 << 20)),
                               prefill_batch=args.prefill_batch,
                               act_bits=args.act_bits,
                               kv_paging=args.kv_paging, tp=args.tp or 1)
    params = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    return deploy(params, plan, device=dev)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Serve a deployed model of the port.")
    p.add_argument("--arch", default="stablelm-3b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises on a host without CUDA) or "
                        "'cpu' for the plain PyTorch path")
    p.add_argument("--mode", default="decode", choices=["decode", "encoder"],
                   help="'encoder' serves prefill-only EncodeRequests over "
                        "an int4 BERT classifier artifact")
    p.add_argument("--task", default="classify",
                   choices=["classify", "embed", "score"],
                   help="what the --mode encoder burst asks for per request")
    p.add_argument("--tenant", action="append", default=None, metavar="NAME=DIR",
                   help="repeatable: host the artifact at DIR as tenant NAME "
                        "in one MultiTenantEngine (deficit-round-robin fair "
                        "share; encoder and decoder artifacts mix)")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--max-queue", type=int, default=None,
                   help="bound the pending queue (default unbounded)")
    p.add_argument("--int4-last-k", type=int, default=-1)
    p.add_argument("--prefill-mode", default="auto",
                   choices=["auto", "chunked", "token"])
    p.add_argument("--backend", default="cuda", choices=["cuda", "reference"],
                   help="'cuda' runs the hand-written kernels (their plain "
                        "versions on CPU tensors); 'reference' the plain "
                        "integer path")
    p.add_argument("--kv-bits", type=int, default=16, choices=[16, 8, 4],
                   help="serving KV-cache precision: 16 keeps fp rows, 8/4 "
                        "store codes + per-(token, head) scales")
    p.add_argument("--prefix-cache-mb", type=float, default=0.0,
                   help="shared-prefix KV reuse budget in MiB (0 disables)")
    p.add_argument("--kv-paging", default="dense", choices=["dense", "paged"],
                   help="'paged' serves slots, shared prefixes and forks out "
                        "of one refcounted block pool, with streams "
                        "byte-identical to 'dense'")
    p.add_argument("--kv-budget-mb", type=float, default=None,
                   help="paged KV pool byte budget in MiB (default: the "
                        "dense slots*max_len capacity)")
    p.add_argument("--policy-from", default=None, metavar="JSON",
                   help="load the mixed-precision QuantPolicy from a search "
                        "artifact instead of the --int4-last-k heuristic")
    p.add_argument("--n", type=int, default=1,
                   help="samples per burst prompt")
    p.add_argument("--act-bits", type=int, default=None, choices=[0, 4, 8],
                   help="activation precision override (0 = fp activations, "
                        "reference backend); with --artifact, retargets the "
                        "loaded model")
    p.add_argument("--prefill-batch", type=int, default=1,
                   help="group up to N same-bucket admissions into one "
                        "batch-N prefill forward")
    p.add_argument("--shared-prefix", type=int, default=0, metavar="T",
                   help="give every burst request the same T-token prefix")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stop", default=None, metavar="ID[,ID...]",
                   help="comma-separated stop-token ids")
    p.add_argument("--stream", action="store_true",
                   help="print every token as the engine emits it")
    p.add_argument("--tp", type=int, default=None, metavar="N",
                   help="tensor-parallel degree: shard the deployed weights "
                        "and KV heads over N ranks (gloo on --device cpu, "
                        "NCCL over N cards); needs --backend reference; with "
                        "--artifact, reshards the saved layout to N (default: "
                        "the recorded layout, or 1 when building)")
    p.add_argument("--replicas", type=int, default=1, metavar="N",
                   help="data-parallel replica count: N engines over the one "
                        "deployed model behind one admission queue "
                        "(least-loaded dispatch, shared rid space)")
    p.add_argument("--warmup", action="store_true",
                   help="refused: " + LATER["--warmup"])
    p.add_argument("--artifact", default=None, metavar="DIR",
                   help="serve a saved DeployedModel (plan and arch come "
                        "from the artifact)")
    p.add_argument("--export", default=None, metavar="DIR",
                   help="save the deployed model as an artifact before "
                        "serving")
    return p


def _later_slice(p, args) -> None:
    """Refuse the flags a later slice of the port brings."""
    if args.warmup:
        p.error(f"--warmup is a later slice of the port: {LATER['--warmup']}")


def main(argv: Optional[list] = None) -> dict:
    p = parser()
    args = p.parse_args(argv)
    _later_slice(p, args)
    if args.artifact and args.export:
        p.error("--export builds a fresh model and cannot be combined with "
                "--artifact (which serves an existing one)")
    if args.artifact and args.kv_paging == "paged":
        p.error("--artifact serves the artifact's own plan (including its "
                "kv_paging axis); export the model with --kv-paging paged "
                "instead of overriding it at load time")
    if args.kv_budget_mb is not None and not args.artifact \
            and args.kv_paging != "paged":
        p.error("--kv-budget-mb sizes the paged KV pool; it needs "
                "--kv-paging paged (or a paged artifact)")
    if args.n < 1:
        p.error(f"--n must be >= 1, got {args.n}")
    if args.tp is not None and args.tp < 1:
        p.error(f"--tp must be >= 1, got {args.tp}")
    if args.replicas < 1:
        p.error(f"--replicas must be >= 1, got {args.replicas}")
    if args.tenant and (args.tp is not None or args.replicas > 1):
        p.error("--tenant engines serve each artifact's own recorded "
                "layout; --tp/--replicas apply to single-model serving")
    if args.tenant:
        if args.artifact or args.export:
            p.error("--tenant hosts saved artifacts; it cannot be combined "
                    "with --artifact/--export")
        return _main_tenants(args, resolve_device(args.device))
    dev = resolve_device(args.device)
    if args.tp is not None and args.tp > 1:
        if not args.artifact and args.backend != "reference":
            p.error(f"--tp {args.tp} runs the plain integer path (the "
                    "hand-written kernels are single-device): pass --backend "
                    "reference")
        from .mesh import spawn_tp
        return spawn_tp(_tp_rank, args.tp, args, device=dev)
    return _serve(args, dev)


def _tp_rank(args) -> dict:
    """One rank of ``--tp N``: the whole run, on this rank's shard; only
    rank 0 prints."""
    import torch.distributed as dist
    rank = dist.get_rank()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
    return _serve(args, dev, say=print if rank == 0 else (lambda *a: None))


def _serve(args, dev, say=print) -> dict:
    """Build or load the model, serve the burst, report (rank 0's view
    under ``--tp``)."""
    from ..deploy import DeployedModel

    if args.artifact:
        model = DeployedModel.load(args.artifact, tp=args.tp, device=dev)
        if args.act_bits is not None and args.act_bits != model.plan.act_bits:
            from ..deploy import retarget_act_bits
            model = retarget_act_bits(model, args.act_bits)
            say(f"[serve] retargeted activations to "
                f"{'fp' if args.act_bits == 0 else f'{args.act_bits}-bit'}")
        say(f"[serve] loaded artifact {args.artifact}: {model.plan.describe()}")
    else:
        model = (_build_encoder_model(args, dev) if args.mode == "encoder"
                 else _build_model(args, dev, say))
        if args.export:
            path = model.save(args.export)
            say(f"[serve] exported artifact to {path}")
    if args.mode == "encoder" and model.plan.mode != "encoder":
        parser().error(f"--mode encoder needs a mode='encoder' artifact; "
                       f"{args.artifact or 'the built model'} is "
                       f"mode={model.plan.mode!r}")

    cfg = model.plan.cfg
    kv_budget = (int(args.kv_budget_mb * (1 << 20))
                 if args.kv_budget_mb is not None else None)
    if args.replicas > 1:
        eng = ReplicaSet(model, replicas=args.replicas, slots=args.slots,
                         max_len=args.max_len, max_queue=args.max_queue,
                         kv_budget_bytes=kv_budget)
        say(f"[serve] replica set: {args.replicas} engines, "
            f"{args.slots} slots each")
    else:
        eng = ServingEngine(model, slots=args.slots, max_len=args.max_len,
                            max_queue=args.max_queue, kv_budget_bytes=kv_budget)
    if model.plan.mode == "encoder":
        return _serve_encoder_burst(args, eng, cfg, say)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p, seed=args.seed, n=args.n)
    stop = (frozenset(int(t) for t in args.stop.split(","))
            if args.stop else frozenset())
    on_token = ((lambda rid, tok: say(f"[stream] rid={rid} tok={tok}"))
                if args.stream else None)

    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab_size, args.shared_prefix).astype(np.int32)
    t0 = time.time()
    steps = 0
    for _ in range(args.requests):
        plen = int(rng.integers(4, 12))
        tail = rng.integers(1, cfg.vocab_size, plen).astype(np.int32)
        req = GenerationRequest(prompt=np.concatenate([shared, tail]),
                                max_new_tokens=8, sampling=sampling,
                                stop_tokens=stop)
        while True:
            try:
                eng.submit(req, on_token=on_token)
                break
            except QueueFullError:       # backpressure: drain a round, retry
                eng.engine_step()
                steps += 1
    steps += eng.run_until_drained()
    dt = time.time() - t0
    finished = sorted(eng.pop_done(), key=lambda r: r.rid)
    total_tokens = sum(len(r.out) for r in finished)
    stopped = sum(r.finish_reason == "stop" for r in finished)
    say(f"[serve] {len(finished)} requests, {total_tokens} tokens, "
        f"{steps} engine steps, {dt:.2f}s "
        f"({total_tokens / max(dt, 1e-9):.1f} tok/s, "
        f"{stopped} stop-token exits)")
    say(f"[serve] {eng.metrics.report()}")
    return {"plan": model.plan.describe(), "steps": steps, "seconds": dt,
            "streams": [[int(t) for t in r.out] for r in finished],
            "finish_reasons": [r.finish_reason for r in finished],
            "metrics": eng.metrics.summary()}


def _main_tenants(args, dev) -> dict:
    """--tenant NAME=DIR...: host every artifact in one MultiTenantEngine
    and round-robin a synthetic burst across the tenants (encode traffic for
    encoder artifacts, generation otherwise), as JAX's CLI does."""
    from ..deploy import DeployedModel

    pairs = []
    for spec in args.tenant:
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            raise SystemExit(f"--tenant expects NAME=DIR, got {spec!r}")
        pairs.append((name, path))

    mt = MultiTenantEngine()
    plans = {}
    for name, path in pairs:
        model = DeployedModel.load(path, device=dev)
        mt.add_tenant(name, model, slots=args.slots, max_len=args.max_len,
                      max_queue=args.max_queue)
        plans[name] = model.plan.describe()
        print(f"[serve] tenant {name!r}: {plans[name]}")

    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p, seed=args.seed)
    rng = np.random.default_rng(0)
    t0 = time.time()
    steps = 0
    for i in range(args.requests):
        name = pairs[i % len(pairs)][0]
        t = mt.tenants[name]
        vocab = t.engine.cfg.vocab_size
        plen = int(rng.integers(4, 12))
        toks = rng.integers(1, vocab, plen).astype(np.int32)
        while True:
            try:
                if t.engine.mode == "encoder":
                    mt.submit_encode(EncodeRequest(tokens=toks, task=args.task),
                                     tenant=name)
                else:
                    mt.submit(GenerationRequest(prompt=toks, max_new_tokens=8,
                                                sampling=sampling), tenant=name)
                break
            except QueueFullError:       # backpressure: drain a round, retry
                mt.engine_step()
                steps += 1
    steps += mt.run_until_drained()
    dt = time.time() - t0
    finished = mt.pop_done()
    print(f"[serve] multi-tenant burst: {len(finished)} requests over "
          f"{len(pairs)} tenants, {steps} engine steps, {dt:.2f}s")
    print(f"[serve] {mt.metrics.report()}")
    names = {r.rid: pairs[i % len(pairs)][0] for i, r in
             enumerate(sorted(finished, key=lambda r: r.rid))}
    return {"plans": plans, "steps": steps, "seconds": dt,
            "tenants": [names[r.rid] for r in finished],
            "outputs": [np.asarray(r.result).tolist()
                        if isinstance(r, EncodeRequest)
                        else [int(x) for x in r.out] for r in finished],
            "finish_reasons": [r.finish_reason for r in finished],
            "metrics": mt.metrics.summary()}


def _serve_encoder_burst(args, eng, cfg, say=print) -> dict:
    """Synthetic prefill-only burst: submit EncodeRequests, drain, report."""
    rng = np.random.default_rng(0)
    t0 = time.time()
    steps = 0
    for _ in range(args.requests):
        plen = int(rng.integers(4, 17))
        toks = rng.integers(1, cfg.vocab_size, plen).astype(np.int32)
        req = EncodeRequest(tokens=toks, task=args.task)
        while True:
            try:
                eng.submit_encode(req)
                break
            except QueueFullError:       # backpressure: drain a round, retry
                eng.engine_step()
                steps += 1
    steps += eng.run_until_drained()
    dt = time.time() - t0
    finished = sorted(eng.pop_done(), key=lambda r: r.rid)
    done = sum(r.finish_reason == "done" for r in finished)
    total = sum(len(r.tokens) for r in finished)
    say(f"[serve] encoder burst: {len(finished)} requests ({done} done), "
          f"{total} input tokens, {steps} engine steps, {dt:.2f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s, task={args.task})")
    say(f"[serve] {eng.metrics.report()}")
    return {"plan": eng.plan.describe(), "steps": steps, "seconds": dt,
            "results": [np.asarray(r.result).tolist() for r in finished],
            "finish_reasons": [r.finish_reason for r in finished],
            "metrics": eng.metrics.summary()}


if __name__ == "__main__":
    main()
