"""Dry run of the port: build every (arch x shape x layout) cell's step and
analyse it on the ``meta`` device, with no card and no storage.

The counterpart of the JAX package's ``launch/dryrun``, which lowers and
compiles each cell for TPU v5e meshes. Here each cell is the port's own
step, run once on meta tensors under ``launch/op_analysis`` (its numbers
are per device, and the kernels are charged as the card would launch
them):

* **train**: ``launch/train.build_train_step``'s loss under the fake-quant
  policy, its gradients (``optim.value_and_grad``; accumulated over
  ``--microbatch`` slices as JAX's scan does) and Adam (``optim.
  adam_update``); ``--distill`` adds the fp teacher and MINI (or the
  hidden-state loss). On ``multi`` the step is rank 0's of the sharded
  step over data 2 x model 2 (``TrainGroups``): tensor parallel by JAX's
  rules, the batch split over the data ranks, their gradients averaged;
  ``--fsdp`` cuts the layer stacks and their Adam moments over the data
  ranks too, ``--attn-seq-shard`` runs the chunk branch context-parallel.
  The fp teacher is whole on every rank (JAX shards it as the student).
* **prefill**: ``models.api.forward`` on the deployed integer tree.
* **decode**: one token over ``api.decode_state`` (and
  ``api.decode_extra_inputs``) at the shape's length.

The layouts (``launch.mesh.make_production_mesh``): ``single`` is one H100
on the kernel backend; ``multi`` is four, serving cells at tp 4 through the
port's tp path (the reference backend's plain integer GEMMs, int32 partial
sums all-reduced) and training data-parallel over 4. A tp or dp group of
four is torch's ``fake`` process group, so one process plays rank 0 and
its collectives are counted, not run. A cell the port cannot build is
written with ``status: "skipped"`` and the port's reason: a tp plan that
``_validate_tp`` refuses (serving the token-mode families at tp 4, as JAX
refuses it), or JAX's own ``shape_applicable``. Every family's train cells
build on ``multi``, the token-mode ones (xlstm, hybrid, encdec) through
their model-parallel layers; under ``--fsdp`` a stack whose leading dim
does not divide over the data ranks stays whole (zamba2-2.7b's 9 groups),
as JAX's ``param_specs`` leaves it.

Each JSON has the JAX dry run's schema with three changes: ``op_analysis``
holds what ``hlo_analysis`` held (plus each kernel's ``launches`` and the
eager ops' count, ``torch_ops``), ``memory.fits_80g`` replaces
``fits_16g``, and the roofline terms use the H100's rates
(``benchmarks/timing.py``). ``lower_s`` is the seconds spent building the
cell's arguments, ``compile_s`` those of the analysed step; there is no
XLA, so ``xla_cost_analysis`` is null. Results go to
``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``.

Usage (the CPU suffices; nothing runs on a device):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b \\
      --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback

import torch

from ..benchmarks.timing import (BF16_OPS_PER_S, HBM_BYTES_PER_S,
                                 INT8_OPS_PER_S, NVLINK_BYTES_PER_S)
from .op_analysis import analyze, storage_bytes

#: device memory of one H100 (80 GB HBM3)
HBM_CAPACITY = 80e9
META = torch.device("meta")
KV_DTYPES = {"bfloat16": (16, torch.bfloat16), "float32": (16, torch.float32),
             "int8": (8, torch.bfloat16), "int4": (4, torch.bfloat16)}


def _cfg_for(arch: str, extra: dict):
    from ..configs import get_config
    cfg = get_config(arch)
    if extra.get("attn_chunk"):
        cfg = cfg.replace(attn_chunk=extra["attn_chunk"])
    if extra.get("moe_group_size"):
        cfg = cfg.replace(moe_group_size=extra["moe_group_size"])
    if extra.get("remat") is not None:
        cfg = cfg.replace(remat=bool(extra["remat"]))
    if extra.get("fused_proj"):
        cfg = cfg.replace(fused_proj=True)
    if extra.get("moe_sorted"):
        cfg = cfg.replace(moe_impl="sorted")
    return cfg


@contextlib.contextmanager
def fake_group(world: int):
    """The default process group as torch's ``fake`` backend of ``world``
    ranks, this process rank 0, for the cell's duration (nothing at 1)."""
    import torch.distributed as dist
    if world == 1:
        yield
        return
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already initialised; "
                           "the analysis plays rank 0 of its own fake group")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _train_cell(cfg, shape, mesh, *, policy, distill: bool, extra: dict):
    from ..configs import TrainHParams, input_specs
    from ..deploy import ExecutionPlan
    from ..distributed import training_specs
    from ..models import api
    from ..optim import adam_init, adam_update, linear_warmup_decay, value_and_grad
    from .mesh import make_train_groups
    from .train import (_mean_over_data, _norm_reduce, _plan_mode, _rows_of,
                        build_train_step, shard_state)

    data, model = mesh.shape["data"], mesh.shape["model"]
    if extra.get("attn_seq_shard"):
        cfg = cfg.replace(attn_seq_shard=True, dp_axes=("data",))
    plan = ExecutionPlan.build(cfg, policy, mode=_plan_mode(cfg), tp=model)
    params = api.init_model(cfg, torch.Generator(), META)
    state = {"params": params, "opt": adam_init(params)}
    groups = specs = None
    if data * model > 1:
        groups = make_train_groups(data, model)
        specs = training_specs(params, cfg, data=data, fsdp=bool(extra.get("fsdp")))
        state = shard_state(state, specs, groups)
    batch = input_specs(cfg, shape)
    teacher = teacher_plan = None
    if distill:
        teacher = api.init_model(cfg, torch.Generator(), META)
        teacher_plan = ExecutionPlan.build(cfg, None, mode=_plan_mode(cfg))
    hp = TrainHParams()
    train_step = build_train_step(plan, hp, teacher, teacher_plan, groups=groups,
                                  specs=specs)
    n_micro = int(extra.get("microbatch") or 1)
    lr = {"weights": hp.lr_weights, "act_scale": hp.lr_act_scale,
          "weight_scale": hp.lr_weight_scale}
    sched = linear_warmup_decay(10000)

    def step(params, opt, batch):
        if n_micro == 1:
            return train_step(params, opt, batch)
        # JAX's accumulation: the mean of the slices' grads
        if groups is not None:
            batch = _rows_of(batch, groups)
        grads = loss = None
        for i in range(n_micro):
            part = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])[i]
                    for k, v in batch.items()}
            l_i, _, g_i = value_and_grad(train_step.loss_fn, params, part)
            grads = g_i if grads is None else _add(grads, g_i)
            loss = l_i if loss is None else loss + l_i
        grads = _scale(grads, 1.0 / n_micro)
        parts = {"loss/train": loss / n_micro}
        norm_reduce = None
        if groups is not None:
            grads, parts = _mean_over_data(grads, parts, specs, groups)
            norm_reduce = _norm_reduce(specs, groups)
        params, opt = adam_update(params, grads, opt, lr_by_group=lr,
                                  schedule_fn=sched, grad_clip=hp.grad_clip,
                                  norm_reduce=norm_reduce)
        return params, opt, parts

    # the argument bytes are one rank's: its slices and its rows (the step
    # takes the whole batch, as a rank's data loader would offer it)
    rows = type(shape)(shape.name, shape.seq_len, shape.global_batch // data, shape.kind)
    args = (state["params"], state["opt"], batch)
    return step, args, storage_bytes(state["params"], state["opt"],
                                     input_specs(cfg, rows), teacher)


def _add(a, b):
    """Leaf-wise ``a + b`` of two gradient trees of one structure."""
    from ..core.tree import tree_leaves_with_path, tree_map_with_path
    flat = dict(tree_leaves_with_path(b))
    return tree_map_with_path(lambda path, x: x + flat[path], a)


def _scale(a, f: float):
    from ..core.tree import tree_map
    return tree_map(lambda x: x * f, a)


def _serve_cell(cfg, shape, mesh, *, policy, extra: dict):
    from ..configs import input_specs
    from ..core.qat import deploy_params
    from ..deploy import ExecutionPlan
    from ..deploy.artifact import _place
    from ..models import api

    tp = mesh.shape["model"]
    kv_bits, kv_dtype = KV_DTYPES[extra.get("kv_dtype") or "bfloat16"]
    prefill_mode = "token" if cfg.family in ("xlstm", "hybrid", "encdec") else "chunked"
    plan = ExecutionPlan.build(cfg, policy, backend="cuda" if tp == 1 else "reference",
                               kv_bits=kv_bits, prefill_mode=prefill_mode, tp=tp)
    params = _place(deploy_params(api.init_model(cfg, torch.Generator(), META),
                                  cfg, plan.segments), plan, META)
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape)

        def step(params, batch):
            with torch.no_grad():
                return api.forward(params, plan, **batch)[0]
        return step, (params, batch), storage_bytes(params, batch)
    B, S = shape.global_batch, shape.seq_len
    state = api.decode_state(cfg, B, S, kv_dtype, kv_bits=kv_bits, device=META,
                             kv_heads=plan.kv_heads if tp > 1 else None)
    tokens = input_specs(cfg, shape)["tokens"]
    extra_in = api.decode_extra_inputs(cfg, B, S, dtype=cfg.torch_dtype, device=META)

    def step(params, state, tokens, extra_in):
        with torch.no_grad():
            return api.forward(params, plan, state=state, tokens=tokens, **extra_in)
    args = (params, state, tokens, extra_in)
    return step, args, storage_bytes(*args)


def _build_cell(arch: str, shape_name: str, mesh, *, policy_kind: str,
                distill: bool, grad_mode: str, extra: dict):
    """``((step, args, argument_bytes), None)`` for a cell the port builds,
    ``(None, reason)`` for one it skips."""
    from ..configs import SHAPES, shape_applicable
    from ..core.policy import QuantPolicy

    cfg = _cfg_for(arch, extra)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return None, why
    n_units = cfg.dec_layers if cfg.family == "encdec" else cfg.num_layers
    k_int4 = {"mkq50": n_units // 2, "int8": 0, "int4": n_units}[policy_kind]
    mode = "fake" if shape.kind == "train" else "int"
    policy = QuantPolicy(num_layers=n_units, mode=mode, last_k_int4=k_int4,
                         grad_mode=grad_mode)
    try:
        if shape.kind == "train":
            return _train_cell(cfg, shape, mesh, policy=policy, distill=distill,
                               extra=extra), None
        return _serve_cell(cfg, shape, mesh, policy=policy, extra=extra), None
    except ValueError as e:          # a plan the port refuses (tp, layout)
        return None, f"{type(e).__name__}: {e}"


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             policy_kind="mkq50", distill=False, grad_mode="mse",
             tag="", extra=None) -> dict:
    from ..configs import SHAPES
    from .mesh import make_production_mesh

    extra = extra or {}
    multi = mesh_kind == "multi"
    serving = SHAPES[shape_name].kind != "train"
    mesh = make_production_mesh(multi=multi, serving=serving)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "chips": mesh.chips, "policy": policy_kind,
              "grad_mode": grad_mode, "tag": tag}
    t0 = time.time()
    with fake_group(mesh.chips):
        built, skip = _build_cell(arch, shape_name, mesh, policy_kind=policy_kind,
                                  distill=distill, grad_mode=grad_mode, extra=extra)
        if built is None:
            result["status"] = "skipped"
            result["reason"] = skip
            _dump(result, out_dir)
            return result
        step, args, arg_bytes = built
        t1 = time.time()
        h = analyze(step, *args)
        t2 = time.time()
    terms = {
        "compute_s": h["float_flops"] / BF16_OPS_PER_S + h["int_flops"] / INT8_OPS_PER_S,
        "memory_s": h["hbm_bytes"] / HBM_BYTES_PER_S,
        "collective_s": h["collective_bytes_total"] / NVLINK_BYTES_PER_S,
    }
    dom = max(terms, key=terms.get)
    result.update({
        "status": "ok",
        "lower_s": round(t1 - t0, 2),
        "compile_s": round(t2 - t1, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": h["end_bytes"],
            "temp_bytes": h["temp_bytes"],
            "total_bytes": arg_bytes + h["temp_bytes"],
            "fits_80g": bool(arg_bytes + h["temp_bytes"] < HBM_CAPACITY),
        },
        "xla_cost_analysis": None,
        "op_analysis": {k: h[k] for k in
                        ("flops", "int_flops", "float_flops", "hbm_bytes",
                         "collective_bytes", "collective_bytes_total",
                         "launches", "torch_ops")},
        "top_collectives": h["top_collectives"],
        "top_dots": h["top_dots"][:6],
        "top_hbm": h["top_hbm"],
        "roofline_terms_s": terms,
        "dominant": dom,
    })
    _dump(result, out_dir)
    return result


def _dump(result: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    tag = f"__{result['tag']}" if result.get("tag") else ""
    path = os.path.join(out_dir, f"{result['arch']}__{result['shape']}__"
                                 f"{result['mesh']}{tag}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    if result["status"] == "ok":
        t = result["roofline_terms_s"]
        print(f"[dryrun] {result['arch']} {result['shape']} {result['mesh']} "
              f"OK step={result['compile_s']}s "
              f"mem={result['memory']['total_bytes']/1e9:.2f}GB "
              f"compute={t['compute_s']*1e3:.2f}ms mem={t['memory_s']*1e3:.2f}ms "
              f"coll={t['collective_s']*1e3:.2f}ms dom={result['dominant']}",
              flush=True)
    else:
        print(f"[dryrun] {result['arch']} {result['shape']} {result['mesh']} "
              f"{result['status']}: {result.get('reason', '')}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default="experiments/dryrun_torch")
    p.add_argument("--policy", default="mkq50", choices=["mkq50", "int8", "int4"])
    p.add_argument("--grad-mode", default="mse", choices=["mse", "ste"])
    p.add_argument("--tag", default="")
    p.add_argument("--kv-dtype", default="bfloat16", choices=sorted(KV_DTYPES),
                   help="the decode cache: an fp one (bfloat16, float32, JAX's "
                        "default) or the port's quantized layout (int8, int4)")
    p.add_argument("--attn-chunk", type=int, default=0)
    p.add_argument("--moe-group-size", type=int, default=0)
    p.add_argument("--remat", type=int, default=-1)
    p.add_argument("--microbatch", type=int, default=0)
    p.add_argument("--attn-seq-shard", action="store_true")
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--fused-proj", action="store_true")
    p.add_argument("--distill", action="store_true")
    p.add_argument("--moe-sorted", action="store_true")
    args = p.parse_args(argv)

    from ..configs import ASSIGNED, SHAPES

    extra = {"kv_dtype": args.kv_dtype, "attn_chunk": args.attn_chunk,
             "moe_group_size": args.moe_group_size,
             "remat": None if args.remat < 0 else args.remat,
             "microbatch": args.microbatch,
             "attn_seq_shard": args.attn_seq_shard,
             "fsdp": args.fsdp, "fused_proj": args.fused_proj,
             "moe_sorted": args.moe_sorted}
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in ASSIGNED for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            p.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    failures = 0
    for arch, shape in cells:
        for mk in meshes:
            try:
                run_cell(arch, shape, mk, args.out, policy_kind=args.policy,
                         grad_mode=args.grad_mode, tag=args.tag, extra=extra,
                         distill=args.distill)
            except Exception:
                failures += 1
                print(f"[dryrun] {arch} {shape} {mk} FAILED", flush=True)
                traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
