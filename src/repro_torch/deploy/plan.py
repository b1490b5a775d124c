"""ExecutionPlan: the resolved, validated execution recipe.

Built once:

    plan = ExecutionPlan.build(cfg, policy, backend="cuda", mode="decode",
                               kv_bits=8, prefill_batch=4)

it resolves the per-segment ``QuantSpec`` list (kernel selection included),
the KV-cache precision, the decode dtype and the serving sampling defaults,
and validates the knob combinations up front. ``plan_to_meta`` /
``plan_from_meta`` round-trip it through the artifact meta shared with the
JAX package: the meta names the kernel backend ``"pallas"``, which the port
loads as ``"cuda"`` and writes back as ``"pallas"``, so an artifact moves
between the two packages unchanged.

Two modes are served: ``"encoder"`` (the bert family, prefill-only) and
``"decode"`` (the dense decoder family over a dense slot KV cache at
kv_bits 16, 8 or 4, chunked prefill). What later slices add raises
``ValueError`` naming that slice: paged KV, tensor parallelism, token-mode
prefill, the shared-prefix cache and the other model families.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..core.policy import QuantPolicy
from ..models.layers import QuantSpec
from ..models.transformer import segments_from_policy

__all__ = ["ExecutionPlan", "resolve_segments", "plan_to_meta",
           "plan_from_meta", "BACKENDS", "MODES"]

#: 'cuda' routes int matmuls through the hand-written kernels (their plain
#: versions for CPU tensors); 'reference' is the plain integer path.
BACKENDS = ("reference", "cuda")
MODES = ("decode", "encoder")

#: the artifact meta's name for the kernel backend
_META_BACKEND = {"cuda": "pallas"}
_FROM_META_BACKEND = {"pallas": "cuda"}

#: ``decode_dtype`` names -> the torch dtype of the fp decode state
_DECODE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_segments(cfg: ModelConfig, policy: Optional[QuantPolicy],
                     use_kernels: bool = False, fuse_epilogue: bool = False,
                     act_bits: Optional[int] = None
                     ) -> list[tuple[int, int, QuantSpec]]:
    """Policy -> contiguous (start, end, QuantSpec) runs. ``act_bits``: None
    keeps the policy's per-layer assignment, 4/8 forces that grid on every
    quantized layer, 0 keeps activations in floating point."""
    if policy is None:
        return [(0, cfg.num_layers, QuantSpec())]
    return segments_from_policy(policy, use_kernels, fuse_epilogue,
                                act_bits=act_bits)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Everything the forward and serving path need, resolved once. Use
    :meth:`build`; the constructor performs no validation."""

    cfg: ModelConfig
    policy: Optional[QuantPolicy]
    backend: str                 # 'reference' | 'cuda'
    kv_bits: int
    prefill_mode: str            # resolved, never 'auto'
    decode_dtype: str
    fuse_epilogue: bool
    segments: tuple              # ((start, end, QuantSpec), ...)
    #: resolved serving sampling defaults (``serving.api.SamplingParams``):
    #: generation requests that carry ``sampling=None`` inherit these
    default_sampling: object = None
    prefix_cache: int = 0
    #: max admissions grouped into ONE batch-N forward
    prefill_batch: int = 1
    act_bits: Optional[int] = None
    mode: str = "decode"
    kv_paging: str = "dense"
    tp: int = 1

    @classmethod
    def build(cls, cfg: ModelConfig, policy: Optional[QuantPolicy] = None, *,
              backend: str = "reference", kv_bits: Optional[int] = None,
              prefill_mode: str = "auto", decode_dtype: str = "float32",
              fuse_epilogue: Optional[bool] = None,
              sampling=None, prefix_cache: int = 0,
              prefill_batch: int = 1,
              act_bits: Optional[int] = None,
              mode: str = "decode",
              kv_paging: str = "dense",
              tp: int = 1) -> "ExecutionPlan":
        """Resolve + validate a plan. Arguments as in the JAX package's
        ``ExecutionPlan.build``; ``backend='cuda'`` selects the kernels and
        ``fuse_epilogue=None`` fuses whenever it does."""
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if decode_dtype not in _DECODE_DTYPES:
            raise ValueError(f"decode_dtype must be one of "
                             f"{sorted(_DECODE_DTYPES)}, got {decode_dtype!r}")
        kv_bits = cfg.kv_bits if kv_bits is None else kv_bits
        if kv_bits not in (16, 8, 4):
            raise ValueError(f"kv_bits must be 16, 8 or 4, got {kv_bits}")
        if prefill_mode == "auto":
            prefill_mode = "chunked"
        if prefill_mode not in ("chunked", "token"):
            raise ValueError(f"prefill_mode must be 'auto', 'chunked' or "
                             f"'token', got {prefill_mode!r}")
        if kv_paging not in ("dense", "paged"):
            raise ValueError(f"kv_paging must be 'dense' or 'paged', "
                             f"got {kv_paging!r}")
        if kv_paging != "dense":
            raise ValueError(f"kv_paging={kv_paging!r}: paged KV is a later "
                             "slice of the port")
        tp = int(tp)
        if tp != 1:
            raise ValueError(f"tp={tp}: tensor parallelism is a later slice "
                             "of the port")
        prefix_cache = int(prefix_cache)
        prefill_batch = int(prefill_batch)
        if prefix_cache < 0:
            raise ValueError(f"prefix_cache must be >= 0 (bytes; 0 "
                             f"disables), got {prefix_cache}")
        if prefill_batch < 1:
            raise ValueError(f"prefill_batch must be >= 1, "
                             f"got {prefill_batch}")
        if mode == "encoder":
            if cfg.family != "bert":
                raise ValueError(
                    f"mode='encoder' needs a bidirectional encode path "
                    f"(family 'bert'), got family {cfg.family!r}")
            if kv_bits != 16:
                raise ValueError(
                    "mode='encoder' retains no KV cache; kv_bits must stay "
                    f"16 (got {kv_bits})")
            if prefill_mode != "chunked":
                raise ValueError(
                    "mode='encoder' runs the batched bucketed forward; "
                    f"prefill_mode={prefill_mode!r} does not apply")
            if prefix_cache:
                raise ValueError(
                    "mode='encoder' computes every request in one forward; "
                    "prefix_cache has no KV rows to reuse")
        else:
            if cfg.family != "dense":
                raise ValueError(
                    f"mode='decode' serves the dense decoder family; family "
                    f"{cfg.family!r} arrives with a later slice of the port")
            if prefill_mode == "token":
                raise ValueError(
                    "prefill_mode='token': token-mode prefill is a later "
                    "slice of the port; decode plans prefill chunked")
            if prefix_cache:
                raise ValueError(
                    f"prefix_cache={prefix_cache}: the shared-prefix KV cache "
                    "is a later slice of the port")
        if act_bits is not None:
            act_bits = int(act_bits)
            if act_bits not in (0, 4, 8):
                raise ValueError(f"act_bits must be None, 0, 4 or 8, "
                                 f"got {act_bits}")
            if policy is None:
                raise ValueError(
                    "act_bits: nothing to retarget without a policy "
                    "(fp plans have no quantized segments)")
            if act_bits == 0 and backend != "reference":
                raise ValueError(
                    "act_bits=0 (fp activations) is the reference-backend "
                    "parity path; the int kernels consume activation codes")
        use_kernels = backend == "cuda"
        if fuse_epilogue is None:
            fuse_epilogue = use_kernels
        segments = resolve_segments(cfg, policy, use_kernels, fuse_epilogue,
                                    act_bits=act_bits)
        # lazy: repro_torch.serving imports deploy at module load
        from ..serving.api import SamplingParams
        sampling = SamplingParams.resolve(sampling)
        return cls(cfg=cfg, policy=policy, backend=backend, kv_bits=kv_bits,
                   prefill_mode=prefill_mode, decode_dtype=decode_dtype,
                   fuse_epilogue=bool(fuse_epilogue),
                   segments=tuple(segments), default_sampling=sampling,
                   prefix_cache=prefix_cache, prefill_batch=prefill_batch,
                   act_bits=act_bits, mode=mode, kv_paging=kv_paging, tp=tp)

    @property
    def use_kernels(self) -> bool:
        return self.backend == "cuda"

    @property
    def torch_dtype(self) -> torch.dtype:
        """The one fp dtype of the serving decode state."""
        return _DECODE_DTYPES[self.decode_dtype]

    def decode_state(self, batch: int, max_len: int, *,
                     per_slot_len: bool = False,
                     kv_bits: Optional[int] = None, device=None) -> dict:
        """The decode state with the plan's dtype and kv_bits on ``device``.
        The ``kv_bits`` override is for the engine's fp prefill scratch
        cache: prefill runs at full precision and quantizes on slot
        insert."""
        from ..models import api
        return api.decode_state(
            self.cfg, batch, max_len, self.torch_dtype,
            per_slot_len=per_slot_len,
            kv_bits=self.kv_bits if kv_bits is None else kv_bits,
            device=device)

    @property
    def deployed(self) -> bool:
        """True when the segments carry deployed-int QuantSpecs."""
        return self.policy is not None and self.policy.mode == "int"

    def build_kwargs(self) -> dict:
        """The exact ``build`` inputs needed to reconstruct this plan."""
        return {"backend": self.backend, "kv_bits": self.kv_bits,
                "prefill_mode": self.prefill_mode,
                "decode_dtype": self.decode_dtype,
                "fuse_epilogue": self.fuse_epilogue,
                "sampling": (None if self.default_sampling is None
                             else dataclasses.asdict(self.default_sampling)),
                "prefix_cache": self.prefix_cache,
                "prefill_batch": self.prefill_batch,
                "act_bits": self.act_bits,
                "mode": self.mode,
                "kv_paging": self.kv_paging,
                "tp": self.tp}

    def describe(self) -> str:
        segs = ", ".join(f"[{s}:{e}) w{sp.w_bits or 'fp'}/a{sp.a_bits or 'fp'}"
                         for s, e, sp in self.segments)
        kv = "" if self.mode == "encoder" else (
            f"kv_bits={self.kv_bits}, prefill={self.prefill_mode}, "
            f"dtype={self.decode_dtype}, ")
        return (f"ExecutionPlan({self.cfg.name}, mode={self.mode}, "
                f"backend={self.backend}, {kv}segments=({segs}))")


def plan_to_meta(plan: ExecutionPlan) -> dict:
    """JSON-serializable description from which ``plan_from_meta`` (of
    either package) rebuilds an identical plan."""
    build = plan.build_kwargs()
    build["backend"] = _META_BACKEND.get(build["backend"], build["backend"])
    return {
        "cfg": dataclasses.asdict(plan.cfg),
        "policy": (None if plan.policy is None
                   else dataclasses.asdict(plan.policy)),
        "build": build,
    }


def plan_from_meta(meta: dict) -> ExecutionPlan:
    cfg = ModelConfig.from_dict(meta["cfg"])
    policy = (None if meta["policy"] is None
              else QuantPolicy.from_dict(meta["policy"]))
    build = dict(meta["build"])
    build["backend"] = _FROM_META_BACKEND.get(build.get("backend"),
                                              build.get("backend", "reference"))
    return ExecutionPlan.build(cfg, policy, **build)
