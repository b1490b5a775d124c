"""Tensor-parallel and replicated int4 serving on the PyTorch / CUDA port,
as ``examples/serve_sharded.py`` does on the JAX package.

* **tp**: ``ExecutionPlan.build(..., tp=2)`` shards the packed integer
  weights column / row-parallel over 2 ranks (one process each: gloo on the
  CPU, NCCL on the cards, a card a rank), the int32 partial sums of each
  row-parallel linear all-reduced, so the streams are byte-identical to
  tp=1. The tp=2 model is saved (gathered) and reloaded at tp 1 (without
  ``--quick`` also at tp 2, and 4 where there are four ranks to run it)
  with the same streams. A host
  with fewer than 2 cards skips this half with a note, as the JAX example
  skips it with fewer than 2 devices.
* **replicas**: ``ReplicaSet(model, replicas=2)`` runs two engines over the
  same deployed arrays behind one admission queue; its streams equal a
  single engine's too.

Run:  PYTHONPATH=src python examples/torch_serve_sharded.py [--quick] [--device cpu]
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.policy import QuantPolicy
from repro_torch.deploy import DeployedModel, ExecutionPlan, deploy
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving import GenerationRequest, ReplicaSet, ServingEngine


def _cfg():
    return reduced(get_config("stablelm-3b")).replace(act="gelu")


def _policy(cfg):
    return QuantPolicy(num_layers=cfg.num_layers, mode="int", last_k_int4=cfg.num_layers)


def _burst(eng, cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    streams = []
    for _ in range(n):
        plen = int(rng.integers(4, 12))
        streams.append(eng.submit(GenerationRequest(
            prompt=rng.integers(1, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=8)))
    eng.run_until_drained()
    eng.pop_done()
    return [tuple(int(t) for t in s.result().tokens) for s in streams]


def _rank_device(device: str) -> torch.device:
    import torch.distributed as dist
    dev = torch.device(device)
    return torch.device("cuda", dist.get_rank()) if dev.type == "cuda" else dev


def _tp_rank(params, path, n_req, device, build):
    """One rank: at ``build`` deploy the fp params under a tp=2 plan, serve
    and save it; else load ``path`` at this group's tp and serve it."""
    import torch.distributed as dist
    cfg, dev = _cfg(), _rank_device(device)
    tp = dist.get_world_size()
    if build:
        plan = ExecutionPlan.build(cfg, _policy(cfg), backend="reference", kv_bits=8, tp=tp)
        model = deploy(params, plan, device=dev)
        model.save(path)
    else:
        model = DeployedModel.load(path, tp=tp, device=dev)
    return _burst(ServingEngine(model, slots=2, max_len=64), cfg, n_req)


def main(argv=None) -> dict:
    from repro_torch.launch.mesh import spawn_tp
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="smoke mode: a smaller burst")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = _cfg()
    n_req = 4 if args.quick else 12
    params = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")

    # reference streams: one process, one device, the plain integer path
    ref_model = deploy(params, ExecutionPlan.build(cfg, _policy(cfg), backend="reference",
                                                   kv_bits=8), device=dev)
    ref = _burst(ServingEngine(ref_model, slots=2, max_len=64), cfg, n_req)
    print(f"[tp=1] {n_req} requests, first stream: {list(ref[0])}")
    out = {"ref": ref, "tp": {}}

    # tensor parallel: build at tp=2, save (gathered), reshard on load
    ranks = torch.cuda.device_count() if dev.type == "cuda" else 4
    if ranks >= 2:
        with tempfile.TemporaryDirectory() as d:
            path = f"{d}/tp2"
            got = spawn_tp(_tp_rank, 2, params, path, n_req, args.device, True,
                           device=dev.type)
            assert got == ref, "tp=2 diverged from tp=1"
            out["tp"][2] = got
            reload = [1] + ([] if args.quick else [2] + ([4] if ranks >= 4 else []))
            for tp in reload:
                if tp == 1:
                    got = _burst(ServingEngine(DeployedModel.load(path, tp=1, device=dev),
                                               slots=2, max_len=64), cfg, n_req)
                else:
                    got = spawn_tp(_tp_rank, tp, None, path, n_req, args.device, False,
                                   device=dev.type)
                assert got == ref, f"tp={tp} (reloaded) diverged from tp=1"
                out["tp"][f"{tp}_reloaded"] = got
                print(f"[tp={tp}] reloaded tp=2 artifact: streams byte-identical to tp=1")
    else:
        print(f"[tp] skipped: host has {ranks} card(s); tp=2 runs a card a rank "
              "(or on the CPU: --device cpu)")

    # data parallel: 2 engines, one admission queue, the same streams
    rs = ReplicaSet(ref_model, replicas=2, slots=2, max_len=64)
    got = _burst(rs, cfg, n_req)
    assert got == ref, "replica set diverged from single engine"
    print(f"[replicas=2] {n_req} requests over {rs.replicas} engines, streams "
          "byte-identical to the single engine")
    out["replicas"] = got
    print("OK")
    return out


if __name__ == "__main__":
    main()
