"""Device layouts of the port: the (data, model) layout of a training
restart (``make_mesh_for_devices``, the counterpart of the JAX package's)
and tensor-parallel process groups (the counterpart of its
``make_tp_mesh``).

``make_mesh_for_devices`` keeps JAX's arithmetic, error text and
``degraded`` flag and returns a :class:`MeshLayout` with no mesh object:
the port places training state per device (``launch/elastic.py``).

A tp plan runs one process per rank. Every rank serves the same requests
in the same order (the sampler's inputs are replicated), holds its slices
of the weights and KV heads, and meets the others in one int32 all-reduce
per row-parallel linear. On the CPU the ranks talk over gloo; on the card
over NCCL, one card a rank.

``make_production_mesh`` is the dry run's layout, device-free: where the
JAX package targets (16, 16) and (2, 16, 16) TPU v5e meshes, the port's
cells run on one H100 (``single``) or four (``multi``: serving at tp 4,
training data-parallel over 4). On the ``meta`` device (the dry run's
analysis) a tp group is torch's ``fake`` process group: one process plays
rank 0 and its collectives move nothing.

``spawn_tp(fn, tp, *args)`` starts ``tp`` ranks with
``torch.multiprocessing`` and a ``torch.distributed.FileStore`` in a
temporary directory (no port, no network), runs ``fn(*args)`` in each and
returns rank 0's result.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
from typing import Callable

import torch

__all__ = ["MeshLayout", "make_mesh_for_devices", "ProductionMesh",
           "make_production_mesh", "TPGroup", "make_tp_group", "spawn_tp"]


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A (data, model) split of the live devices. ``requested_model`` is
    the caller's ask (0 = auto); ``degraded`` is True when an explicit
    request was halved down to a divisor (only with
    ``allow_degrade=True``)."""
    data: int
    model: int
    requested_model: int
    degraded: bool

    @property
    def shape(self) -> tuple[int, int]:
        return (self.data, self.model)


def make_mesh_for_devices(n_devices: int, model_parallel: int = 0, *,
                          allow_degrade: bool = False) -> MeshLayout:
    """Whatever devices are alive -> a (data, model) layout.

    ``model_parallel <= 0`` picks min(16, n) halved to the nearest divisor.
    An explicit degree that does not divide ``n_devices`` raises a
    ValueError naming both numbers, unless ``allow_degrade=True`` (the
    elastic restart's contract: preserved if possible, else halved), which
    records the halving in ``degraded``."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    requested = model_parallel
    if model_parallel <= 0:
        model_parallel = min(16, n_devices)
        while n_devices % model_parallel:
            model_parallel //= 2
    elif n_devices % model_parallel:
        if not allow_degrade:
            raise ValueError(
                f"model_parallel={model_parallel} does not divide "
                f"n_devices={n_devices}; pick a divisor, or pass "
                f"allow_degrade=True to halve to the nearest one")
        while n_devices % model_parallel:
            model_parallel //= 2
    return MeshLayout(data=n_devices // model_parallel, model=model_parallel,
                      requested_model=requested,
                      degraded=requested > 0 and model_parallel != requested)


@dataclasses.dataclass(frozen=True)
class ProductionMesh:
    """A device-free layout of H100 cards: the axis names and sizes the
    shard rules read (``distributed.sharding``), as JAX's mesh offers
    them."""
    name: str               #: single | multi
    axis_names: tuple
    shape: dict

    @property
    def chips(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n


def make_production_mesh(*, multi: bool = False, serving: bool = False
                         ) -> ProductionMesh:
    """One H100 (``single``) or four (``multi``). Serving cells put the
    four on "model" (the port's tp path); training cells on "data" (data
    parallelism, the gradient mean over the four)."""
    n = 4 if multi else 1
    shape = {"data": 1, "model": n} if serving else {"data": n, "model": 1}
    return ProductionMesh("multi" if multi else "single", ("data", "model"), shape)


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """This process's place in a tensor-parallel group: ``rank`` of
    ``tp``; the collectives use the default process group."""
    tp: int
    rank: int


def make_tp_group(tp: int, device) -> TPGroup:
    """The group a tp plan serves in. The caller (``spawn_tp``, or its own
    launcher) has initialised the default process group with ``tp`` ranks:
    gloo for CPU tensors, NCCL for CUDA ones with one card a rank, torch's
    ``fake`` group for meta tensors (the dry run). A host
    with fewer than ``tp`` cards raises, as JAX's ``make_tp_mesh`` does for
    devices; so does a missing or differently sized group."""
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if have < tp:
            raise RuntimeError(f"tp={tp} needs {tp} devices, host has {have} "
                               "(the CPU runs any tp over gloo: --device cpu)")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"tp={tp} needs a process group of {tp} ranks, this process has 1 "
            "(no group: start the ranks with repro_torch.launch.mesh.spawn_tp, "
            f"or init_process_group with world_size={tp})")
    world = dist.get_world_size()
    if world != tp:
        raise RuntimeError(f"tp={tp} needs a process group of {tp} ranks, "
                           f"this one has {world}")
    want = {"cuda": "nccl", "meta": "fake"}.get(dev.type, "gloo")
    backend = dist.get_backend()
    if backend != want:
        raise RuntimeError(f"tp={tp} on {dev.type} runs over {want}, the "
                           f"process group uses {backend}")
    return TPGroup(tp=tp, rank=dist.get_rank())


def _rank_main(rank: int, tp: int, store_dir: str, backend: str,
               fn: Callable, args: tuple) -> None:
    import torch.distributed as dist
    if backend == "nccl":
        torch.cuda.set_device(rank)
    store = dist.FileStore(os.path.join(store_dir, "store"), tp)
    dist.init_process_group(backend, store=store, rank=rank, world_size=tp)
    try:
        out = fn(*args)
        if rank == 0:
            with open(os.path.join(store_dir, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_tp(fn: Callable, tp: int, *args, device="cpu"):
    """Run ``fn(*args)`` on ``tp`` freshly spawned ranks in one process
    group (gloo on the CPU, NCCL on the card) and return rank 0's result.
    ``fn`` must be importable by name (a module-level function). A rank
    that raises makes this raise once every rank has ended."""
    import torch.multiprocessing as mp
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < tp:
        raise RuntimeError(f"tp={tp} needs {tp} devices, host has "
                           f"{torch.cuda.device_count()}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="repro_torch_tp_") as d:
        mp.start_processes(_rank_main, args=(tp, d, backend, fn, args),
                           nprocs=tp, join=True, start_method="spawn")
        with open(os.path.join(d, "result.pkl"), "rb") as f:
            return pickle.load(f)
