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

A sharded training step runs ``data x model`` ranks (``TrainGroups``):
rank ``r`` is data rank ``r // model`` and model rank ``r % model``, so the
model ranks of one data rank are adjacent; each has a model group (the
tensor- and context-parallel collectives) and a data group (the gradient
mean and FSDP's per-layer broadcasts).

``make_production_mesh`` is the dry run's layout, device-free: where the
JAX package targets (16, 16) and (2, 16, 16) TPU v5e meshes, the port's
cells run on one H100 (``single``) or four (``multi``: serving at tp 4,
training on data 2 x model 2, as JAX trains every cell on both axes). On
the ``meta`` device (the dry run's analysis) a group is torch's ``fake``
process group: one process plays rank 0 and its collectives move nothing.

``spawn_ranks(fn, data, model, *args)`` starts ``data * model`` ranks with
``torch.multiprocessing`` and a ``torch.distributed.FileStore`` in a
temporary directory (no port, no network), runs ``fn(*args)`` in each and
returns rank 0's result; ``spawn_tp(fn, tp, *args)`` is its ``data = 1``
case. Both run on the card (NCCL, one card a rank) unless the caller asks
for the CPU (gloo).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
from typing import Callable

import torch

__all__ = ["MeshLayout", "make_mesh_for_devices", "ProductionMesh",
           "make_production_mesh", "TPGroup", "make_tp_group", "TrainGroups",
           "make_train_groups", "spawn_ranks", "spawn_tp"]


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
    four on "model" (the port's tp path); training cells split them 2 x 2
    over "data" and "model", as JAX's (16, 16) mesh trains on both axes."""
    if not multi:
        shape = {"data": 1, "model": 1}
    else:
        shape = {"data": 1, "model": 4} if serving else {"data": 2, "model": 2}
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


@dataclasses.dataclass(frozen=True)
class TrainGroups:
    """This process's place in a ``data x model`` training layout: its
    global ``rank``, its data and model ranks, and the two process groups
    it meets the others in (``dp_group``: the ranks of its model rank,
    ``mp_group``: those of its data rank)."""
    data: int
    model: int
    rank: int
    dp_group: object
    mp_group: object
    dp_rank: int
    mp_rank: int

    def dp_global_rank(self, dp_rank: int) -> int:
        """The global rank of data rank ``dp_rank`` in this model rank's
        data group."""
        return dp_rank * self.model + self.mp_rank


def make_train_groups(data: int, model: int) -> TrainGroups:
    """The groups of a ``data x model`` layout over the default process
    group (``data * model`` ranks; gloo, NCCL or the dry run's ``fake``).
    Every rank creates every group, in one order, as ``new_group`` asks."""
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"data={data} x model={model} needs a process group of "
            f"{data * model} ranks, this process has none (start the ranks "
            "with repro_torch.launch.mesh.spawn_ranks)")
    world = dist.get_world_size()
    if world != data * model:
        raise RuntimeError(f"data={data} x model={model} needs "
                           f"{data * model} ranks, the process group has {world}")
    rank = dist.get_rank()
    dp_rank, mp_rank = divmod(rank, model)
    mp_group = dp_group = None
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if d == dp_rank:
            mp_group = g
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if m == mp_rank:
            dp_group = g
    return TrainGroups(data=data, model=model, rank=rank, dp_group=dp_group,
                       mp_group=mp_group, dp_rank=dp_rank, mp_rank=mp_rank)


def _rank_main(rank: int, world: int, store_dir: str, backend: str,
               fn: Callable, args: tuple, cards: int) -> None:
    import torch.distributed as dist
    if backend == "nccl" or cards:
        torch.cuda.set_device(rank % cards if cards else rank)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        out = fn(*args)
        if rank == 0:
            with open(os.path.join(store_dir, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, data: int, model: int, *args, device="cuda",
                backend=None):
    """Run ``fn(*args)`` on ``data * model`` freshly spawned ranks in one
    process group and return rank 0's result. ``fn`` must be importable by
    name (a module-level function) and builds its ``TrainGroups`` with
    ``make_train_groups(data, model)``. On the card each rank takes its
    own card over NCCL, and a host with fewer cards raises; ``backend=
    "gloo"`` instead runs every rank over gloo on the cards there are
    (ranks share a card, which NCCL refuses). On the CPU the ranks run
    over gloo. A rank that raises makes this raise once every rank has
    ended. Arguments travel by ``torch.multiprocessing``'s pickler, so CPU
    tensors among them are shared, not copied."""
    import torch.multiprocessing as mp
    world = data * model
    dev = torch.device(device)
    cards = 0
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if backend != "gloo" and cards < world:
            raise RuntimeError(f"data={data} x model={model} needs {world} "
                               f"devices, host has {cards}")
        if cards == 0:
            raise RuntimeError("no CUDA device (pass device='cpu' to run the "
                               "ranks on the CPU)")
        backend = backend or "nccl"
    else:
        backend = "gloo"
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as d:
        mp.start_processes(_rank_main, args=(world, d, backend, fn, args,
                                             cards if backend == "gloo" else 0),
                           nprocs=world, join=True, start_method="spawn")
        with open(os.path.join(d, "result.pkl"), "rb") as f:
            return pickle.load(f)


def spawn_tp(fn: Callable, tp: int, *args, device="cuda"):
    """Run ``fn(*args)`` on ``tp`` freshly spawned ranks in one process
    group (NCCL on the cards, one card a rank; gloo on the CPU) and return
    rank 0's result: ``spawn_ranks`` with one data rank. A host with fewer
    than ``tp`` cards raises unless the caller asks for the CPU."""
    have = torch.cuda.device_count()
    if torch.device(device).type == "cuda" and have < tp:
        raise RuntimeError(f"tp={tp} needs {tp} devices, host has {have}")
    return spawn_ranks(fn, 1, tp, *args, device=device)
