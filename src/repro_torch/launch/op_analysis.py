"""Per-step FLOPs, HBM bytes, collective bytes, kernel launches and peak
memory of one step of the port, counted on the ``meta`` device.

The counterpart of the JAX package's ``launch/hlo_analysis``, which walks a
compiled XLA module. The port runs eagerly, so :func:`analyze` runs the
step itself, once, on meta tensors (shapes and dtypes, no storage, nothing
computed) under a ``TorchDispatchMode`` that sees every ATen and c10d op:

* **dots**: ``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot`` and
  ``_int_mm`` cost ``2 M N K`` FLOPs (batched by the leading dim), split
  into integer and float by the result's dtype, as JAX's ``s32`` dots are;
* **HBM bytes**: operand bytes plus result bytes of every op that is not a
  view (``empty`` and its kin move nothing), the eager counterpart of JAX's
  "every fusion reads and writes HBM once": each eager op is one kernel
  that reads its inputs and writes its outputs. A row read (``index``,
  ``embedding``, ``gather``) moves the rows it reads and an in-place row
  write (``index_put_``, a cache append) the rows it writes, not their
  buffer, as JAX charges a ``gather`` or a ``dynamic-update-slice``;
* **collectives**: ``c10d`` ops by kind, the input's bytes, an all-reduce
  twice (reduce and broadcast phases, as ``hlo_analysis`` counts it);
* **kernels**: the hand-written kernels the card would launch, which
  ``kernels/ops`` charges from its meta branch (one launch each, with the
  bytes and operations its bound reckons: the GEMM's ``2 M N K`` integer
  FLOPs, attention's float ones);
* **memory**: the peak, over the step, of the bytes of the storages the
  step itself allocated and still holds (``temp``); arguments are the
  caller's to count.

Every number is per device: the caller hands in one device's arguments
(one rank's shard under tp). Meta tensors hold no values, so what depends
on data is charged at its extent: decode attention reads the whole cache,
every MoE expert runs at full capacity (as the card's per-expert launches
do).
"""
from __future__ import annotations

import collections
import weakref
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["analyze", "storage_bytes", "KERNELS"]

#: the hand-written kernels whose launches :func:`analyze` counts
KERNELS = ("act_quant", "int8_matmul", "int4_matmul", "int4_matmul_fused",
           "decode_attention", "decode_attention_paged", "flash_attention")

_DOTS = {"mm", "addmm", "bmm", "baddbmm", "mv", "dot", "_int_mm"}
#: ops that allocate without writing or only re-describe a storage
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "detach", "alias", "_unsafe_view", "lift_fresh", "_local_scalar_dense",
         "set_", "resize_", "_reshape_alias"}
#: row reads out of a buffer (the first operand); the other operands index it
_GATHERS = {"index", "index_select", "embedding", "gather", "take_along_dim"}
#: in-place row writes: their operands past the buffer are indices and the
#: rows written (of the buffer's dtype)
_SCATTERS = {"index_put_", "index_copy_", "scatter_", "scatter_add_", "index_add_",
             "masked_scatter_"}
#: c10d op -> (kind, the index of its input argument)
_COLLECTIVES = {"allreduce_": ("all-reduce", 0), "allreduce_coalesced_": ("all-reduce", 0),
                "allgather_": ("all-gather", 1), "_allgather_base_": ("all-gather", 1),
                "allgather_into_tensor_coalesced_": ("all-gather", 1),
                "reduce_scatter_": ("reduce-scatter", 1),
                "_reduce_scatter_base_": ("reduce-scatter", 1),
                "alltoall_": ("all-to-all", 1), "alltoall_base_": ("all-to-all", 1),
                "broadcast_": ("collective-permute", 0), "send": ("collective-permute", 0)}


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def storage_bytes(*trees) -> int:
    """Bytes of the distinct storages the trees' tensors lie in (a step's
    argument bytes; meta tensors count as their card copies would)."""
    seen = {}
    for t in _tensors(list(trees)):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(name: str, args) -> float:
    if name in ("mm", "_int_mm"):
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "addmm":
        a, b = args[1], args[2]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "mv":
        return 2.0 * args[0].shape[0] * args[0].shape[1]
    return 2.0 * args[0].shape[0]                                   # dot


class _Counter(TorchDispatchMode):
    """The dispatch mode behind :func:`analyze` (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = self.int_flops = 0.0
        self.hbm = 0.0
        self.ops = 0
        self.coll = collections.Counter()
        self.dots = collections.defaultdict(lambda: [0, 0.0])
        self.hbm_items = collections.defaultdict(lambda: [0, 0.0])
        self.colls = collections.defaultdict(lambda: [0, 0.0])
        self.kernels = {k: {"launches": 0, "bytes": 0.0, "dot_flops": 0.0}
                        for k in KERNELS}
        self.live: dict = {}
        self.cur = self.peak = 0

    # -------------------------------------------------- the kernels' charges
    def charge(self, kernel: str, *, nbytes: float, dot_flops: float,
               integer: bool) -> None:
        k = self.kernels[kernel]
        k["launches"] += 1
        k["bytes"] += nbytes
        k["dot_flops"] += dot_flops
        self.hbm += nbytes
        self.flops += dot_flops
        if integer:
            self.int_flops += dot_flops
        if dot_flops:
            self.dots[(kernel, "")][0] += 1
            self.dots[(kernel, "")][1] += dot_flops
        self.hbm_items[(kernel, "")][0] += 1
        self.hbm_items[(kernel, "")][1] += nbytes

    # ----------------------------------------------------------- the memory
    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                continue
            n = st.nbytes()
            self.cur += n
            self.peak = max(self.peak, self.cur)
            self.live[key] = weakref.ref(st, lambda _, key=key, n=n: self._free(key, n))

    def _free(self, key, n: int) -> None:
        if self.live.pop(key, None) is not None:
            self.cur -= n

    # ------------------------------------------------------------- the ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace == "c10d":
            kind, idx = _COLLECTIVES.get(name, (name, 0))
            b = sum(_nbytes(t) for t in _tensors(args[idx]))
            factor = 2.0 if kind == "all-reduce" else 1.0
            self.coll[kind] += b * factor
            self.colls[(kind, self._shapes(args[idx]))][0] += 1
            self.colls[(kind, self._shapes(args[idx]))][1] += b
            return out
        if not (func.is_view or func._schema.is_mutable):
            self._track(out)        # a new storage (in-place ops write the caller's)
        if func.is_view or name in _FREE:
            return out
        self.ops += 1
        if name in _GATHERS:
            # rows read out of a buffer: the rows and the indices, not the
            # buffer, as JAX charges a gather or a dynamic-slice
            b = 2 * sum(_nbytes(t) for t in _tensors(out)) + sum(
                _nbytes(t) for t in _tensors(args[1:]) if not t.is_floating_point())
        elif name in _SCATTERS:
            # an in-place write of rows: read and write the rows it writes
            # (and read the indices), not the whole buffer it writes into
            b = sum(_nbytes(t) + (_nbytes(t) if t.dtype == args[0].dtype else 0)
                    for t in _tensors(args[1:]))
        elif name == "copy_":
            b = 2 * _nbytes(args[1])
        else:
            b = (sum(_nbytes(t) for t in _tensors(args))
                 + sum(_nbytes(t) for t in _tensors(kwargs))
                 + sum(_nbytes(t) for t in _tensors(out)))
        self.hbm += b
        key = (name, self._shapes(args))
        self.hbm_items[key][0] += 1
        self.hbm_items[key][1] += b
        if name in _DOTS:
            f = _dot_flops(name, args)
            self.flops += f
            res = next(_tensors(out))
            if not (res.is_floating_point() or res.is_complex()):
                self.int_flops += f
            self.dots[key][0] += 1
            self.dots[key][1] += f
        return out

    @staticmethod
    def _shapes(args) -> str:
        return " ".join(f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"
                        for t in _tensors(args))

    def result(self) -> dict:
        top = lambda items, key: [
            {key: v[1], "count": v[0], "op": k[0], "operands": k[1]}
            for k, v in sorted(items.items(), key=lambda kv: -kv[1][1])[:12]]
        return {
            "flops": self.flops,
            "int_flops": self.int_flops,
            "float_flops": self.flops - self.int_flops,
            "hbm_bytes": self.hbm,
            "collective_bytes": dict(self.coll),
            "collective_bytes_total": float(sum(self.coll.values())),
            "launches": {k: v["launches"] for k, v in self.kernels.items()},
            "kernels": self.kernels,
            "torch_ops": self.ops,
            "temp_bytes": self.peak,
            "top_dots": top(self.dots, "flops"),
            "top_hbm": top(self.hbm_items, "bytes"),
            "top_collectives": top(self.colls, "bytes"),
        }


def analyze(step: Callable, *args, **kwargs) -> dict:
    """Run ``step(*args, **kwargs)`` once under the counter and return JAX's
    keys (``flops``, ``int_flops``, ``float_flops``, ``hbm_bytes``,
    ``collective_bytes``, ``collective_bytes_total``, ``top_dots``,
    ``top_hbm``, ``top_collectives``) plus ``launches`` (each kernel's
    count for the step), ``kernels`` (their bytes and FLOPs),
    ``torch_ops`` (the other ops, each an eager launch on the card),
    ``temp_bytes`` (the step's peak of live storages it allocated) and
    ``end_bytes`` (those its results still hold when it returns). The
    arguments must lie on the ``meta`` device: a step on real tensors would
    compute, and the kernels' charges come only from meta tensors."""
    for t in _tensors((args, kwargs)):
        if not t.is_meta:
            raise ValueError(f"analyze: the step's tensors must lie on the meta "
                             f"device, got one on {t.device}")
    from ..kernels import ops
    counter = _Counter()
    ops.ANALYSIS.append(counter.charge)
    try:
        with counter:
            out = step(*args, **kwargs)
            end = counter.cur       # what the step's results still hold
            del out
    finally:
        ops.ANALYSIS.remove(counter.charge)
    return {**counter.result(), "end_bytes": end}
