"""DeployedModel: the self-contained serving artifact.

``deploy(params, plan)`` packs the int4/int8 weight codes + scales once;
``DeployedModel.save/load`` round-trip the packed tree and the plan through
``checkpoint/manager.py`` in the format the JAX package writes, so an
artifact saved by either package serves in the other.

Layout:  <dir>/ARTIFACT.json   (format+version, cfg, policy, plan build args)
         <dir>/arrays.npz      (flattened deployed-int leaves)

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
on a host without CUDA; pass ``device="cpu"`` for the plain CPU path.

Tensor parallelism (a ``tp > 1`` plan): ``deploy`` and ``load`` run on
every rank of a process group of ``tp`` ranks and keep this rank's shard
(``distributed.shard_serving``); ``save`` gathers the full logical arrays
(``gather_serving``) and rank 0 writes them, so an artifact's arrays never
depend on the tp it was saved at, and ``load(tp=...)`` reshards it to any
other degree.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..checkpoint import manager as ckpt
from ..core import qat
from ..core.quantizer import qrange
from ..core.tree import tree_map
from ..device import resolve_device
from .plan import ExecutionPlan, plan_from_meta, plan_to_meta, resolve_segments

__all__ = ["DeployedModel", "deploy", "params_from_numpy", "retarget_act_bits",
           "ARTIFACT_FORMAT", "ARTIFACT_VERSION"]

ARTIFACT_FORMAT = "mkq-deployed-model"
ARTIFACT_VERSION = 1


def params_from_numpy(tree, device=None):
    """A nested dict/list of numpy arrays (JAX params through
    ``jax.tree.map(np.asarray, ...)``, or a loaded ``arrays.npz``) -> the
    port's tensor tree on ``device``, dtypes kept (uint8 packed nibbles,
    int8 codes, f32 scales and weights). A named tuple with the fields of
    an Adam state (JAX's ``AdamState``: step, m, v) becomes the port's
    ``optim.AdamState``, so an optimizer step can resume from JAX's."""
    from ..optim import AdamState
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if getattr(node, "_fields", None) == AdamState._fields:
            return AdamState(*(conv(v) for v in node))
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(np.array(node, copy=True)).to(dev)
    return conv(tree)


def deploy(params, plan: ExecutionPlan, calib_batches: Optional[list] = None,
           *, recalibrate: bool = True, device=None) -> "DeployedModel":
    """fp params -> packed int artifact under ``plan``, on ``device``.

    params         fp parameter tree (tensors, or numpy arrays).
    calib_batches  optional list of ``{'tokens': ...}`` batches: runs
                   activation-scale calibration (percentile-of-|input|,
                   paper §3.1) through an fp forward before packing: the
                   unmasked encoder forward for encoder plans, the
                   cacheless LM forward (``models.api.forward`` on an fp
                   plan) for decoder plans.
    recalibrate    recompute weight scales abs-max/qmax (paper §3.1). Pass
                   False for QAT params whose ``s_w`` were learned.
    """
    if not plan.deployed:
        raise ValueError(
            "deploy() needs a plan built from a mode='int' QuantPolicy; "
            f"got policy={plan.policy!r}")
    dev = resolve_device(device)
    params = tree_map(lambda a: torch.as_tensor(a).to(dev), params)
    cfg = plan.cfg
    if recalibrate:
        params = qat.calibrate_weight_scales(
            params, qat.default_bits_fn(cfg, plan.policy))
    if calib_batches:
        if plan.mode == "encoder":
            from ..models.bert import bert_encode
            fp_plan = ExecutionPlan.build(cfg, None, backend="reference",
                                          mode="encoder")
            # the quantized-site records come from the layer stack alone,
            # so the unmasked encoder forward records the same sites in the
            # same order as a full-model forward would
            fwd = lambda p, b: bert_encode(p, fp_plan, b["tokens"])
        else:
            from ..models import api
            fp_plan = ExecutionPlan.build(cfg, None, backend="reference",
                                          kv_bits=16,
                                          prefill_mode=plan.prefill_mode,
                                          decode_dtype=plan.decode_dtype)
            # an encoder-decoder's batches carry the encoder's input too
            fwd = lambda p, b: api.forward(p, fp_plan, tokens=b["tokens"],
                                           src_embeds=b.get("src_embeds"))[0]
        with torch.no_grad():
            params = qat.calibrate_act_scales(params, cfg, plan.policy, fwd,
                                              calib_batches)
    params_int = qat.deploy_params(params, cfg, plan.segments)
    if plan.act_bits is not None:
        # calibration learned s_a on the POLICY grid; the plan override
        # retargets the stored scales onto its grid
        params_int = _rescale_act_scales(
            params_int, cfg, _act_scale_factors(plan, None, plan.act_bits))
    return DeployedModel(plan=plan, params=_place(params_int, plan, dev))


def _place(params_int, plan: ExecutionPlan, dev):
    """This rank's shard of a full deployed tree under a tp plan (the tree
    itself at tp=1); raises outside a process group of ``plan.tp`` ranks."""
    group = plan.make_group(dev)
    if group is None:
        return params_int
    from ..distributed import serving_param_specs, shard_serving
    return shard_serving(params_int, serving_param_specs(params_int, plan.cfg),
                         group.rank, group.tp)


# ------------------------------------------------------ act-grid retargeting
def _act_scale_factors(plan: ExecutionPlan, old_act_bits, new_act_bits
                       ) -> list[float]:
    """Per-segment multipliers moving stored ``s_a`` leaves between
    activation grids: the MKQ grid pins the clip point ``s * qmax(bits)``,
    so ``s_new = s_old * qmax(old)/qmax(new)``. Scales of fp-activation
    segments (a_bits 0) stay on the policy grid."""
    cfg, policy = plan.cfg, plan.policy
    segs = lambda ab: resolve_segments(cfg, policy, plan.use_kernels,
                                       plan.fuse_epilogue, act_bits=ab)
    old, new, pol = segs(old_act_bits), segs(new_act_bits), segs(None)
    factors = []
    for (so, eo, spo), (sn, en, spn), (_, _, spp) in zip(old, new, pol):
        if (so, eo) != (sn, en):
            raise AssertionError(
                "act_bits override moved a segment boundary "
                f"([{so}:{eo}) vs [{sn}:{en}))")
        go = spo.a_bits or spp.a_bits   # grid the scales are stored on
        gn = spn.a_bits or spp.a_bits   # grid they must land on
        factors.append(1.0 if go == gn
                       else float(qrange(go)[1]) / float(qrange(gn)[1]))
    return factors


def _rescale_act_scales(params_int, cfg, factors: list[float]):
    """Multiply every linear's ``s_a`` by its segment's factor, in the
    per-family layout of ``qat.deploy_params``."""
    def scale_tree(tree, f):
        if f == 1.0:
            return tree

        def walk(node):
            if isinstance(node, dict):
                if "s_a" in node and ("wq" in node or "w" in node):
                    new = dict(node)
                    new["s_a"] = (node["s_a"].to(torch.float32)
                                  * f).to(node["s_a"].dtype)
                    return new
                return {k: walk(v) for k, v in node.items()}
            return node
        return walk(tree)

    out = dict(params_int)
    if cfg.family == "xlstm":
        for key in ("mlstm", "slstm"):
            out[key] = [scale_tree(t, f) for t, f in zip(params_int[key], factors)]
        return out
    if cfg.family == "hybrid":
        out["mamba"] = [scale_tree(t, f)
                        for t, f in zip(params_int["mamba"], factors)]
        out["shared"] = scale_tree(params_int["shared"], factors[-1])
        return out
    if cfg.family == "encdec":
        out["enc"] = scale_tree(params_int["enc"], factors[0])
        out["dec"] = [scale_tree(t, f)
                      for t, f in zip(params_int["dec"], factors)]
        return out
    out["layers"] = [scale_tree(t, f)
                     for t, f in zip(params_int["layers"], factors)]
    return out


def retarget_act_bits(model: "DeployedModel", act_bits) -> "DeployedModel":
    """A new DeployedModel serving the same packed weights at another
    activation precision (DESIGN.md §13), as the JAX package's: ``act_bits``
    4/8 pick that grid for every quantized segment, 0 runs fp activations
    (on the reference backend), None returns to the policy's per-layer
    grid. Stored ``s_a`` scales are rescaled by the qmax ratio; codes and
    every other plan knob stay."""
    plan = model.plan
    if not plan.deployed:
        raise ValueError("retarget_act_bits needs a deployed (mode='int') "
                         "artifact")
    kw = plan.build_kwargs()
    kw["act_bits"] = act_bits
    if act_bits == 0:
        kw["backend"] = "reference"   # fp activations: the parity path
    if kw["backend"] == "reference":
        kw["fuse_epilogue"] = False   # fusing is a kernel-backend notion
    new_plan = ExecutionPlan.build(plan.cfg, plan.policy, **kw)
    params = _rescale_act_scales(
        model.params, plan.cfg, _act_scale_factors(plan, plan.act_bits, act_bits))
    return DeployedModel(plan=new_plan, params=params)


@dataclasses.dataclass
class DeployedModel:
    """Packed int4/int8 weights + scales bound to their ExecutionPlan."""

    plan: ExecutionPlan
    params: dict          # deployed-int tree (per-segment layer stacks)

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def save(self, path: str) -> str:
        """Write the artifact. Under a tp plan every rank must call this:
        the shards are gathered to the full logical arrays and rank 0
        writes them (the meta keeps the plan's tp); the others wait for
        it."""
        meta = {"format": ARTIFACT_FORMAT, "version": ARTIFACT_VERSION,
                **plan_to_meta(self.plan)}
        group = self.plan.make_group(self.device)
        if group is None:
            return ckpt.save_artifact(path, self.params, meta)
        import torch.distributed as dist

        from ..distributed import gather_serving, serving_param_specs
        full = gather_serving(self.params,
                              serving_param_specs(self.params, self.plan.cfg),
                              group.tp)
        if group.rank == 0:
            path = ckpt.save_artifact(path, full, meta)
        dist.barrier()
        return os.path.abspath(path)

    @classmethod
    def load(cls, path: str, *, tp: Optional[int] = None,
             device=None) -> "DeployedModel":
        """Load a saved artifact (either package's) onto ``device``.
        ``tp`` overrides the recorded tensor-parallel degree (the arrays
        are full logical arrays, so resharding is placement); a tp > 1
        layout loads only in a process group of that many ranks."""
        dev = resolve_device(device)
        arrays, meta = ckpt.load_artifact(path)
        if meta.get("format") != ARTIFACT_FORMAT:
            raise ValueError(f"{path}: not a {ARTIFACT_FORMAT} artifact "
                             f"(format={meta.get('format')!r})")
        if meta.get("version", 0) > ARTIFACT_VERSION:
            raise ValueError(
                f"{path}: artifact version {meta['version']} is newer than "
                f"this build understands ({ARTIFACT_VERSION})")
        if tp is not None:
            meta = {**meta, "build": {**meta["build"], "tp": int(tp)}}
        plan = plan_from_meta(meta)
        return cls(plan=plan,
                   params=_place(params_from_numpy(arrays, dev), plan, dev))
