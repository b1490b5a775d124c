"""QAT pipeline: calibration -> fake-quant training -> int deployment.

Calibration (paper §3.1):
* weight scales: abs-max per output channel / l_max(bits-of-that-layer),
  a pure tree transform over stacked (layer-leading) leaves;
* activation scales: run N forward batches in ``calibration_mode``; every
  quantizable matmul reports percentile(|input|) in call order, and the
  stream is folded back onto the ``s_a`` leaves by the family's site order
  (or, with ``calibrate_act_scales_global``, one global percentile drives
  every ``s_a``).

Training runs ``qlinear``'s fake mode (``launch/train``, ``benchmarks/
common``). Deployment: ``deploy_params`` splits stacked layers at segment
boundaries and replaces every fp weight with packed int4 / int8 codes.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..configs.base import ModelConfig
from . import calibration
from .packing import quantize_weight
from .policy import QuantPolicy
from .quantizer import qrange
from .tree import slice_stack


def _is_linear(node) -> bool:
    return isinstance(node, dict) and "w" in node and "s_w" in node


def calibrate_weight_scales(params, bits_for_leaf: Callable[[tuple], np.ndarray]):
    """Set every linear's s_w = absmax_per_outchannel / l_max(bits).

    ``bits_for_leaf(shape_prefix)`` returns per-layer bits broadcastable to
    the leaf's leading (stacked) dims; scalar for unstacked.
    """
    def walk(node):
        if _is_linear(node):
            w, s_w = node["w"], node["s_w"]
            absmax = torch.amax(torch.abs(w), dim=-2, keepdim=True)  # K axis
            bits = np.asarray(bits_for_leaf(tuple(w.shape[:-2])), np.float32)
            # qrange-consistent l_max: 2^{k-1} for k<8, 127 for the int8 carrier
            qmax = np.where(bits >= 8, 2.0 ** (bits - 1) - 1, 2.0 ** (bits - 1))
            qmax = qmax.reshape(qmax.shape + (1,) * (absmax.dim() - qmax.ndim))
            qmax = torch.as_tensor(qmax, dtype=torch.float32, device=w.device)
            new = dict(node)
            new["s_w"] = torch.clamp_min(absmax / qmax, 1e-8).to(s_w.dtype)
            return new
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node
    return walk(params)


def default_bits_fn(cfg: ModelConfig, policy: QuantPolicy):
    """Per-leaf bits resolver honoring stacked layer leading dims: a leaf
    stacked over the layers gets each layer's bits, broadcast over any
    further leading dims (an MoE leaf's experts, (L, E, ...)). A hybrid's
    group-stacked leaf, (G, per, ...), gets each group's bits (its first
    layer's); an unstacked leaf (the hybrid's shared block) the policy's
    default bits, as in the JAX package."""
    n_units = policy.num_layers
    per = {"xlstm": cfg.slstm_every, "hybrid": cfg.attn_every}.get(cfg.family)
    bits_vec = np.array([policy.weight_bits(l) or 32 for l in range(n_units)],
                        np.float32)

    def fn(shape_prefix: tuple) -> np.ndarray:
        if len(shape_prefix) == 0:
            return np.float32(policy.default_bits)
        L = shape_prefix[0]
        if per is not None:  # group-stacked (G, ...) or (G, per, ...)
            G = n_units // per
            out = (np.array([policy.weight_bits(g * per) or 32 for g in range(G)],
                            np.float32) if L == G
                   else np.full(L, policy.default_bits, np.float32))
        elif L == n_units:
            out = bits_vec
        else:  # any other stacked dim: default bits
            out = np.full(L, policy.default_bits, np.float32)
        return out.reshape((L,) + (1,) * (len(shape_prefix) - 1))
    return fn


SITE_ORDERS = {
    # per-layer quantized-matmul input records, in model code order
    "attn": ["attn/wq", "attn/wk", "attn/wv", "attn/wo"],
    "attn_fused": ["attn/wqkv", "attn/wo"],
    "ffn_swiglu": ["ffn/w1", "ffn/w3", "ffn/w2"],
    "ffn_fused": ["ffn/w13", "ffn/w2"],
    "ffn_gelu": ["ffn/w1", "ffn/w2"],
    "moe": ["moe/w1", "moe/w3", "moe/w2"],
}


def site_order(cfg: ModelConfig) -> list[str]:
    """The quantized-matmul sites of one layer in the order the forward
    records them: attention, then the FFN, or the experts and the shared
    expert for MoE (whose expert sites record one value per expert). Under
    ``fused_proj`` the fused ``wqkv`` and ``w13`` are one site each, so
    each holds one activation scale (the JAX package's ``site_order`` knows
    no fused site: its calibration refuses a ``fused_proj`` model)."""
    fused = cfg.fused_proj
    attn = SITE_ORDERS["attn_fused" if fused else "attn"]
    swiglu = SITE_ORDERS["ffn_fused" if fused else "ffn_swiglu"]
    if cfg.family == "moe":
        sites = attn + SITE_ORDERS["moe"]
        if cfg.shared_expert_d_ff:
            sites = sites + ["moe/shared/" + s.split("/")[1] for s in swiglu]
        return sites
    return attn + (swiglu if cfg.act == "swiglu" else SITE_ORDERS["ffn_gelu"])


def calibrate_act_scales(params, cfg: ModelConfig, policy: QuantPolicy,
                         forward_fn: Callable, batches: list[dict],
                         percentile: float = 99.99):
    """Per-site activation calibration for the stacked-layer families. An
    MoE expert site records (E,) per call, which lands in ``s_a`` of shape
    (L, E, 1, 1). The token-mode families (xlstm, hybrid, encdec) take
    :func:`calibrate_act_scales_global`, as in the JAX package."""
    if cfg.family in ("xlstm", "hybrid", "encdec"):
        return calibrate_act_scales_global(params, cfg, policy, forward_fn,
                                           batches, percentile)
    sites = site_order(cfg)
    K = len(sites)
    L = cfg.num_layers
    with calibration.calibration_mode(percentile) as cm:
        for b in batches:
            forward_fn(params, b)
    rec = cm.records
    if len(rec) % (L * K) != 0:
        raise RuntimeError(
            f"calibration records {len(rec)} not divisible by L*K={L * K}; "
            "site order out of sync with model code")
    nb = len(rec) // (L * K)
    # aggregate max over batches -> per (layer, site)
    agg: list[list] = [[None] * K for _ in range(L)]
    i = 0
    for _ in range(nb):
        for l in range(L):
            for k in range(K):
                v = rec[i]
                i += 1
                agg[l][k] = v if agg[l][k] is None else np.maximum(agg[l][k], v)
    qmax = np.array([float(qrange(policy.act_bits(l) or 32)[1])
                     for l in range(L)], np.float32)

    def set_in(d, parts, k):
        d = dict(d)
        if len(parts) == 1:
            lin = dict(d[parts[0]])
            s_a = lin["s_a"]
            per_layer = np.stack([np.asarray(agg[l][k], np.float32)
                                  for l in range(L)])
            q = qmax.reshape((L,) + (1,) * (per_layer.ndim - 1))
            val = np.maximum(per_layer / q, 1e-8)
            lin["s_a"] = torch.as_tensor(val.reshape(tuple(s_a.shape)),
                                         dtype=s_a.dtype, device=s_a.device)
            d[parts[0]] = lin
            return d
        d[parts[0]] = set_in(d[parts[0]], parts[1:], k)
        return d

    new_params = dict(params)
    layers = dict(new_params["layers"])
    for k, site in enumerate(sites):
        layers = set_in(layers, site.split("/"), k)
    new_params["layers"] = layers
    return new_params


def calibrate_act_scales_global(params, cfg: ModelConfig, policy: QuantPolicy,
                                forward_fn: Callable, batches: list[dict],
                                percentile: float = 99.99):
    """Fallback: one global percentile drives every s_a (documented approx)."""
    with calibration.calibration_mode(percentile) as cm:
        for b in batches:
            forward_fn(params, b)
    stat = float(max(np.max(r) for r in cm.records)) if cm.records else 1.0
    _, qmax = qrange(policy.default_bits)

    def walk(node):
        if _is_linear(node):
            new = dict(node)
            new["s_a"] = torch.full_like(node["s_a"], max(stat / qmax, 1e-8))
            return new
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node
    return walk(params)


def _quantize_stack(tree, w_bits: int):
    """Replace every linear's 'w' with packed codes 'wq' (segment-sliced;
    int4 packs along K, so an expert stack (L, E, K, N) packs each expert's
    own K rows)."""
    def walk(node):
        if _is_linear(node):
            new = {k: v for k, v in node.items() if k != "w"}
            new["wq"], _ = quantize_weight(node["w"], node["s_w"], w_bits)
            return new
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node
    return walk(tree)


def _segment_stacks(tree, segments) -> list:
    return [_quantize_stack(slice_stack(tree, s, e), spec.w_bits)
            if spec.enabled else slice_stack(tree, s, e)
            for (s, e, spec) in segments]


def deploy_params(params, cfg: ModelConfig, segments) -> dict:
    """QAT params -> deployed int params: a LIST of per-segment stacks
    (packed weights cannot share one stacked array across bit-width
    segments) of ``params['layers']``, of a hybrid's group-stacked
    ``params['mamba']`` (its shared block quantized once, at the last
    segment's bits), of xLSTM's group-stacked ``params['mlstm']`` (G, per
    - 1, ...) and ``params['slstm']`` (G, ...), or of an encoder-decoder's
    ``params['dec']`` (its encoder stack quantized at the first segment's
    bits)."""
    out = dict(params)
    if cfg.family == "xlstm":
        out["mlstm"] = _segment_stacks(params["mlstm"], segments)
        out["slstm"] = _segment_stacks(params["slstm"], segments)
        return out
    if cfg.family == "hybrid":
        out["mamba"] = _segment_stacks(params["mamba"], segments)
        last = segments[-1][2]
        out["shared"] = (_quantize_stack(params["shared"], last.w_bits)
                         if last.enabled else params["shared"])
        return out
    if cfg.family == "encdec":
        first = segments[0][2]
        out["enc"] = (_quantize_stack(params["enc"], first.w_bits)
                      if first.enabled else params["enc"])
        out["dec"] = _segment_stacks(params["dec"], segments)
        return out
    out["layers"] = _segment_stacks(params["layers"], segments)
    return out
