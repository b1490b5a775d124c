"""Serve a quantized model with batched, streaming requests on the PyTorch
/ CUDA port (the paper's deployment), as ``examples/serve_int4.py`` does on
the JAX package.

Build an ``ExecutionPlan`` (segments, kernel backend, KV precision),
``deploy()`` the packed int4/int8 ``DeployedModel``, ``save()`` it, then
serve the RELOADED artifact through the continuous-batching engine: its
token streams are byte-identical to serving the in-memory model (asserted).
Then a sampled request iterated token by token and a stop-token request
that releases its slot early. On the card the integer matmuls and the int8
KV cache's decode attention are the hand-written kernels (``cuda``
backend); on the CPU their plain versions run.

Run:  PYTHONPATH=src python examples/torch_serve_int4.py [--quick] [--device cpu]
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.policy import QuantPolicy
from repro_torch.deploy import DeployedModel, ExecutionPlan, deploy
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving import GenerationRequest, SamplingParams, ServingEngine


def _burst(eng, cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        plen = int(rng.integers(4, 16))
        eng.submit(GenerationRequest(
            prompt=rng.integers(1, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=8))
    steps = eng.run_until_drained()
    return steps, {r.rid: r.out.tolist() for r in eng.pop_done()}


def _bytes(tree) -> int:
    from repro_torch.core.tree import tree_leaves_with_path
    return sum(t.numel() * t.element_size() for _, t in tree_leaves_with_path(tree)
               if isinstance(t, torch.Tensor))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="smoke mode: a smaller burst")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduced(get_config("qwen2.5-32b"))
    n = cfg.num_layers
    n_requests = 4 if args.quick else 12
    # kv_bits=8: the KV cache as int8 codes + per-(token, head) scales
    plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=n, mode="int", last_k_int4=n // 2),
                               backend="cuda", kv_bits=8)
    params = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    model = deploy(params, plan, device=dev)
    n_bytes, n_fp = _bytes(model.params), _bytes(params)
    print(f"deployed weights: {n_bytes / 1e6:.2f}MB vs fp32 {n_fp / 1e6:.2f}MB "
          f"({n_fp / n_bytes:.1f}x reduction) on {dev}")

    # serve the in-memory model, then the saved + reloaded artifact: identical
    eng = ServingEngine(model, slots=4, max_len=128)
    t0 = time.time()
    steps, mem_streams = _burst(eng, cfg, n_requests)
    dt = time.time() - t0
    toks = sum(len(v) for v in mem_streams.values())
    print(f"served {len(mem_streams)} requests / {toks} tokens in {steps} engine "
          f"steps, {dt:.2f}s ({toks / dt:.1f} tok/s on {dev.type}, eager)")
    print("metrics:", eng.metrics.report())
    with tempfile.TemporaryDirectory() as td:
        loaded = DeployedModel.load(model.save(f"{td}/artifact"), device=dev)
    eng2 = ServingEngine(loaded, slots=4, max_len=128)
    _, art_streams = _burst(eng2, cfg, n_requests)
    assert art_streams == mem_streams, "artifact streams diverged"
    print(f"artifact round trip: {len(art_streams)} requests byte-identical")

    # streaming + sampling: tokens iterated as the engine produces them
    stream = eng2.submit(GenerationRequest(
        prompt=np.array([5, 9, 2, 7], np.int32), max_new_tokens=8,
        sampling=SamplingParams(temperature=0.8, top_k=40, seed=42)))
    sampled = [int(t) for t in stream]
    print(f"sampled stream (T=0.8, top_k=40, seed=42): {sampled} [{stream.finish_reason}]")

    # a stop token ends the request the moment it is emitted, freeing its slot
    stop = eng2.submit(GenerationRequest(
        prompt=np.array([5, 9, 2, 7], np.int32), max_new_tokens=64,
        stop_tokens={sampled[2]},      # same seed, same stream: stops early
        sampling=SamplingParams(temperature=0.8, top_k=40, seed=42)))
    r = stop.result()
    assert r.finish_reason == "stop" and len(r.tokens) <= 3, r
    print(f"stop-token request: {len(r.tokens)}/64 tokens [{r.finish_reason}]")
    eng2.pop_done()
    return {"streams": art_streams, "sampled": sampled}


if __name__ == "__main__":
    main()
