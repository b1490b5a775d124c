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
``"decode"``. A decode plan prefills ``"chunked"`` (the dense decoder, vlm
and moe families over a dense slot KV cache or a paged block pool,
``kv_paging``, at kv_bits 16, 8 or 4, with the shared-prefix cache when
``prefix_cache > 0``) or ``"token"``: the JAX package's seed semantics,
prompts fed one token per batched step through a shared cursor over an fp
decode state (kv_bits 16), which ``"auto"`` picks for the families without
a KV slot cache (``TOKEN_ONLY_FAMILIES``: hybrid and encdec here) and
which the other decode families may ask for. A ``tp > 1`` plan shards the
deployed integer weights and the KV heads over ``tp`` ranks
(``_validate_tp``: JAX's rules, in JAX's order; MoE experts shard as the
FFN does) and runs the plain integer path, whose row-parallel int32 sums
keep every stream byte-identical to tp=1; ``make_group`` checks the ranks
when a model is placed, not at build. A fake-quant (training) plan takes
``tp`` as the model ranks of a sharded training step (``with_groups``);
it trains every family and refuses, by name, a dim the rules cut that
``tp`` does not divide (``_validate_train_tp``). Serving the token-mode
families at ``tp > 1`` stays refused, as JAX refuses it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..core.policy import QuantPolicy
from ..models.layers import QuantSpec
from ..models.transformer import segments_from_policy

__all__ = ["ExecutionPlan", "resolve_segments", "validate_cache_layout",
           "plan_to_meta", "plan_from_meta", "BACKENDS", "MODES",
           "TOKEN_ONLY_FAMILIES"]

#: 'cuda' routes int matmuls through the hand-written kernels (their plain
#: versions for CPU tensors); 'reference' is the plain integer path.
BACKENDS = ("reference", "cuda")
MODES = ("decode", "encoder")
#: families whose decode plans the port builds (the vlm is served on tokens,
#: as the JAX engine serves it; MoE keeps the transformer's KV slot cache;
#: xlstm, hybrid and encdec keep an fp decode state and prefill in token mode)
DECODE_FAMILIES = ("dense", "vlm", "moe", "xlstm", "hybrid", "encdec")

#: families whose decode state is not a KV slot cache (JAX's list): no
#: chunked prefill, no slot table, no quantized KV, and no sharding rules
#: for their fp recurrent state
TOKEN_ONLY_FAMILIES = ("xlstm", "hybrid", "encdec")


def validate_cache_layout(cfg: ModelConfig, *, per_slot_len: bool = False,
                          kv_bits: int = 16) -> None:
    """Family-compatibility of the decode-state layout (JAX's
    ``validate_cache_layout``; ``api.decode_state`` defers here)."""
    if kv_bits not in (16, 8, 4):
        raise ValueError(f"kv_bits must be 16, 8 or 4, got {kv_bits}")
    if cfg.family in TOKEN_ONLY_FAMILIES and (per_slot_len or kv_bits != 16):
        raise ValueError(
            "per_slot_len/kv_bits: transformer-family caches only "
            f"({cfg.family} keeps the fp decode state)")

#: the artifact meta's name for the kernel backend
_META_BACKEND = {"cuda": "pallas"}
_FROM_META_BACKEND = {"pallas": "cuda"}

#: ``decode_dtype`` names -> the torch dtype of the fp decode state
_DECODE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_segments(cfg: ModelConfig, policy: Optional[QuantPolicy],
                     use_kernels: bool = False, fuse_epilogue: bool = False,
                     act_bits: Optional[int] = None, tp: int = 1
                     ) -> list[tuple[int, int, QuantSpec]]:
    """Policy -> contiguous (start, end, QuantSpec) runs for ``cfg``'s
    family: layers, a hybrid stack's groups (``hybrid.group_segments``) or
    an encoder-decoder's decoder layers. ``act_bits``: None keeps the
    policy's per-layer assignment, 4/8 forces that grid on every quantized
    layer, 0 keeps activations in floating point. ``tp`` is the
    tensor-parallel degree the row-parallel linears sum over."""
    if policy is None:
        return [(0, _segment_units(cfg), QuantSpec())]
    if cfg.family in ("xlstm", "hybrid"):
        from ..models.hybrid import group_segments
        per = cfg.slstm_every if cfg.family == "xlstm" else cfg.attn_every
        return group_segments(policy, cfg.num_layers // per, use_kernels,
                              act_bits=act_bits)
    if cfg.family == "encdec" and policy.num_layers != cfg.dec_layers:
        raise ValueError(
            f"encdec policy covers decoder layers ({cfg.dec_layers}), "
            f"got num_layers={policy.num_layers}")
    return segments_from_policy(policy, use_kernels, fuse_epilogue,
                                act_bits=act_bits, tp=tp)


def _segment_units(cfg: ModelConfig) -> int:
    """What a policy's layers count: groups of a hybrid (or xlstm) stack,
    decoder layers of an encoder-decoder, layers otherwise."""
    if cfg.family == "xlstm":
        return cfg.num_layers // cfg.slstm_every
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    if cfg.family == "encdec":
        return cfg.dec_layers
    return cfg.num_layers


def _validate_tp(cfg: ModelConfig, policy: Optional[QuantPolicy], backend: str,
                 act_bits: Optional[int], segments, tp: int) -> None:
    """Structural checks of a tensor-parallel plan, the JAX package's
    ``_validate_tp``: the same conditions in the same order, each naming
    the knob that caused it, then the port's own for MoE: the experts' FFN
    widths must divide as d_ff does (their w1 / w3 shard column-parallel,
    their w2 row-parallel with int32 sums, the router is replicated)."""
    if backend != "reference":
        raise ValueError(
            f"tp={tp}: the hand-written kernels are single-device; shard on "
            "backend='reference' (the plain integer path)")
    if policy is not None and policy.mode == "fake":
        _validate_train_tp(cfg, tp)
        return
    if cfg.family in TOKEN_ONLY_FAMILIES:
        raise ValueError(
            f"tp={tp}: no sharding rules for family {cfg.family!r}'s fp "
            "recurrent decode state; transformer-cache families only")
    if policy is None or policy.mode != "int":
        raise ValueError(
            f"tp={tp} shards DEPLOYED integer weights (row-parallel partial "
            "sums stay exact in int32); build from a mode='int' policy")
    if act_bits == 0:
        raise ValueError(
            f"tp={tp} needs integer accumulation for byte-identical streams; "
            "act_bits=0 contracts in floating point over the sharded axis")
    for dim_name, dim in (("num_heads", cfg.num_heads),
                          ("num_kv_heads", cfg.num_kv_heads),
                          ("d_ff", cfg.d_ff)):
        if dim % tp:
            raise ValueError(
                f"tp={tp} does not divide {dim_name}={dim}; pick a tp that "
                "divides the attention-head and FFN dims")
    # the port's own: the experts' (and the shared expert's) FFN widths
    # shard like d_ff (JAX leaves their divisibility to GSPMD's padding)
    moe_dims = ((("expert_d_ff", cfg.expert_d_ff),
                 ("shared_expert_d_ff", cfg.shared_expert_d_ff))
                if cfg.family == "moe" else ())
    for dim_name, dim in moe_dims:
        if dim % tp:
            raise ValueError(
                f"tp={tp} does not divide {dim_name}={dim}; pick a tp that "
                "divides the experts' FFN dims")
    # int4 codes pack two values a byte along the contracting axis, so a
    # row-parallel int4 weight shards its packed K/2 rows
    if any(sp.w_bits == 4 for _, _, sp in segments):
        for dim_name, dim in (("num_heads*head_dim", cfg.num_heads * cfg.hd),
                              ("d_ff", cfg.d_ff), *moe_dims):
            if dim % (2 * tp):
                raise ValueError(
                    f"tp={tp} with int4 segments: packed codes shard the K/2 "
                    f"nibble-pair rows, so {dim_name}={dim} must divide by "
                    f"2*tp={2 * tp}")


def _validate_train_tp(cfg: ModelConfig, tp: int) -> None:
    """A fake-quant (training) plan at ``tp`` model ranks: the sharded
    training step (``launch/train.build_train_step`` with ``TrainGroups``)
    cuts heads and FFN widths over the model ranks by JAX's rules; every
    dim they cut must divide. The hybrid's Mamba2 layers cut their SSM heads
    (``ssm_expand * d_model / ssm_head_dim``) and its shared block its heads
    and FFN; the xLSTM cuts its mLSTM and sLSTM heads (``num_heads``)."""
    heads = [("num_heads", cfg.num_heads), ("num_kv_heads", cfg.num_kv_heads)]
    if cfg.family == "xlstm":
        dims = [("num_heads", cfg.num_heads)]
    elif cfg.family == "moe":
        dims = heads + [("expert_d_ff", cfg.expert_d_ff),
                        ("shared_expert_d_ff", cfg.shared_expert_d_ff)]
    else:
        dims = heads + [("d_ff", cfg.d_ff)]
    if cfg.family == "hybrid":
        dims = [("ssm_expand*d_model/ssm_head_dim",
                 cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim)] + dims
    for dim_name, dim in dims:
        if dim % tp:
            raise ValueError(
                f"tp={tp} does not divide {dim_name}={dim}: the sharded "
                f"training step of {cfg.name} ({cfg.family}) cuts heads and "
                "FFN widths over the model ranks")


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
        if mode == "decode" and cfg.family not in DECODE_FAMILIES:
            raise ValueError(
                f"mode='decode' serves the {DECODE_FAMILIES} families, "
                f"not {cfg.family!r}")
        if prefill_mode == "auto":
            prefill_mode = ("token" if cfg.family in TOKEN_ONLY_FAMILIES
                            else "chunked")
        if prefill_mode not in ("chunked", "token"):
            raise ValueError(f"prefill_mode must be 'auto', 'chunked' or "
                             f"'token', got {prefill_mode!r}")
        if prefill_mode == "chunked" and cfg.family in TOKEN_ONLY_FAMILIES:
            raise ValueError(
                f"{cfg.family}: no KV slot cache; use prefill_mode='token'")
        validate_cache_layout(cfg, kv_bits=kv_bits)
        if prefill_mode == "token" and kv_bits != 16:
            raise ValueError(
                "kv_bits < 16 needs the chunked slot cache; token-mode "
                "prefill keeps the fp decode state")
        prefix_cache = int(prefix_cache)
        prefill_batch = int(prefill_batch)
        if prefix_cache < 0:
            raise ValueError(f"prefix_cache must be >= 0 (bytes; 0 "
                             f"disables), got {prefix_cache}")
        if prefill_batch < 1:
            raise ValueError(f"prefill_batch must be >= 1, "
                             f"got {prefill_batch}")
        if prefix_cache and prefill_mode != "chunked":
            raise ValueError(
                "prefix_cache needs the chunked slot-cache prefill path; "
                f"prefill_mode={prefill_mode!r} has no KV rows to reuse")
        if prefix_cache and cfg.learned_pos:
            raise ValueError(
                "prefix_cache: block-chunked prefill derives positions from "
                "the KV cursor (RoPE); learned-pos embeddings index from 0 "
                "and would disagree between chunked and whole-prompt runs")
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
        if kv_paging not in ("dense", "paged"):
            raise ValueError(f"kv_paging must be 'dense' or 'paged', "
                             f"got {kv_paging!r}")
        if kv_paging == "paged":
            if mode != "decode":
                raise ValueError(
                    "kv_paging='paged' pages the decode KV cache; "
                    f"mode={mode!r} retains none")
            if prefill_mode != "chunked":
                raise ValueError(
                    "kv_paging='paged' needs the chunked slot-cache prefill "
                    f"path; prefill_mode={prefill_mode!r} has no KV rows "
                    "to page")
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
        # lazy: repro_torch.serving imports deploy at module load
        from ..serving.api import SamplingParams
        sampling = SamplingParams.resolve(sampling)
        tp = int(tp)
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        segments = resolve_segments(cfg, policy, use_kernels, fuse_epilogue,
                                    act_bits=act_bits, tp=tp)
        if tp > 1:
            _validate_tp(cfg, policy, backend, act_bits, segments, tp)
        return cls(cfg=cfg, policy=policy, backend=backend, kv_bits=kv_bits,
                   prefill_mode=prefill_mode, decode_dtype=decode_dtype,
                   fuse_epilogue=bool(fuse_epilogue),
                   segments=tuple(segments), default_sampling=sampling,
                   prefix_cache=prefix_cache, prefill_batch=prefill_batch,
                   act_bits=act_bits, mode=mode, kv_paging=kv_paging, tp=tp)

    def with_groups(self, groups) -> "ExecutionPlan":
        """This plan with a sharded training step's ``TrainGroups`` on every
        segment's ``QuantSpec`` (the forward reads them there)."""
        if groups.model != self.tp:
            raise ValueError(f"a plan built at tp={self.tp} runs over "
                             f"model={groups.model} ranks")
        segs = tuple((s, e, dataclasses.replace(sp, groups=groups))
                     for s, e, sp in self.segments)
        return dataclasses.replace(self, segments=segs)

    @property
    def use_kernels(self) -> bool:
        return self.backend == "cuda"

    @property
    def torch_dtype(self) -> torch.dtype:
        """The one fp dtype of the serving decode state."""
        return _DECODE_DTYPES[self.decode_dtype]

    @property
    def kv_heads(self) -> int:
        """KV heads one rank holds: ``num_kv_heads / tp``."""
        return self.cfg.num_kv_heads // self.tp

    def make_group(self, device):
        """This process's ``launch.mesh.TPGroup`` for the plan's tp degree,
        or None at tp=1. Lazy on purpose, as JAX's ``make_mesh``: the ranks
        are checked when a model is placed, not at build, so a tp=4 plan
        builds (for inspection, or to reload at another tp) on a host with
        one device and no process group."""
        if self.tp == 1:
            return None
        from ..launch.mesh import make_tp_group
        return make_tp_group(self.tp, device)

    def decode_state(self, batch: int, max_len: int, *,
                     per_slot_len: bool = False,
                     kv_bits: Optional[int] = None, device=None) -> dict:
        """The decode state with the plan's dtype and kv_bits on ``device``,
        this rank's ``kv_heads`` of it. The ``kv_bits`` override is for the
        engine's fp prefill scratch cache: prefill runs at full precision
        and quantizes on slot insert."""
        from ..models import api
        return api.decode_state(
            self.cfg, batch, max_len, self.torch_dtype,
            per_slot_len=per_slot_len,
            kv_bits=self.kv_bits if kv_bits is None else kv_bits,
            device=device, kv_heads=self.kv_heads)

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
            ("" if self.kv_paging == "dense" else "kv_paging=paged, ")
            + f"kv_bits={self.kv_bits}, prefill={self.prefill_mode}, "
            f"dtype={self.decode_dtype}, ")
        tp = "" if self.tp == 1 else f"tp={self.tp}, "
        return (f"ExecutionPlan({self.cfg.name}, mode={self.mode}, {tp}"
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
