"""The decoder-only LM (dense, vlm and MoE families) and the BERT subset of
the shared transformer stack.

Layer parameters are stacked (leading dim = layers), as in the JAX package.
The MKQ mixed-precision policy (int4 from the last layer backwards, int8
elsewhere) yields CONTIGUOUS bit-segments, and the stack runs as one Python
loop per segment with a static ``QuantSpec``.

MoE layers route each token to its top-k experts under a capacity of C
slots an expert: the grouped one-hot dispatch (``moe_apply``, GShard
style) or the gather / scatter one (``moe_apply_sorted``,
``moe_impl="sorted"``), the JAX package's two. Expert weights are
quantized per expert (``_expert_matmul``); on the kernel backend each
expert's product is one integer GEMM launch (``kernels.ops.expert_matmul``).

KV caches are updated in place (the JAX package returns new arrays and
lets XLA alias them): ``lm_forward`` writes each layer's new rows into the
cache buffers and returns the same buffers with the advanced cursor. The
decode forward makes no host synchronisation, MoE routing included, so one
decode step can be captured in a CUDA graph.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

import dataclasses

from ..configs.base import ModelConfig
from ..core import calibration
from ..core.packing import unpack_int4
from ..core.policy import QuantPolicy
from ..core.quantizer import fake_quant
from ..core.tree import slice_stack, tree_map
from ..kernels.int8_matmul import expert_matmul_exact
from .attention import attention_block
from .layers import QuantSpec, act_fn, layernorm, qlinear, rmsnorm


def segments_from_policy(policy: QuantPolicy, use_kernels: bool = False,
                         fuse_epilogue: bool = False,
                         act_bits: Optional[int] = None, tp: int = 1
                         ) -> list[tuple[int, int, QuantSpec]]:
    """Contiguous (start, end, QuantSpec) runs of equal bit-width.

    ``act_bits`` is the plan-level activation override: applied to every
    quantized layer, so it can never merge or split the policy's segment
    boundaries. ``tp`` rides every spec (the row-parallel sums)."""
    segs: list[tuple[int, int, QuantSpec]] = []
    for l in range(policy.num_layers):
        wb, ab = policy.weight_bits(l) or 0, policy.act_bits(l) or 0
        if act_bits is not None and wb:
            ab = act_bits
        spec = QuantSpec(mode=policy.mode, w_bits=wb, a_bits=ab,
                         grad_mode=policy.grad_mode, use_kernels=use_kernels,
                         fuse_epilogue=fuse_epilogue, tp=tp)
        if segs and segs[-1][2] == spec:
            segs[-1] = (segs[-1][0], l + 1, spec)
        else:
            segs.append((l, l + 1, spec))
    return segs


def _norm(x, p, kind):
    return (rmsnorm(x, p["scale"]) if kind == "rms"
            else layernorm(x, p["scale"], p["bias"]))


def ffn_apply(x, p, cfg: ModelConfig, spec: QuantSpec):
    if cfg.act == "swiglu":
        h = F.silu(qlinear(x, p["w1"], spec).to(torch.float32)).to(x.dtype)
        h = h * qlinear(x, p["w3"], spec)
        return qlinear(h, p["w2"], spec, row_parallel=True)
    # non-gated FFN: the activation can ride the int4 kernel's fused
    # dequant+bias+GELU epilogue (one write of the output instead of three)
    fused = (spec.mode == "int" and spec.use_kernels and spec.fuse_epilogue
             and spec.w_bits == 4 and cfg.act in ("gelu", "relu"))
    h1 = qlinear(x, p["w1"], spec, act=cfg.act if fused else None)
    h = h1 if fused else act_fn(cfg.act)(h1)
    return qlinear(h, p["w2"], spec, row_parallel=True)


# ------------------------------------------------------------------ MoE
def _expert_matmul(x_ecd: torch.Tensor, p: dict, spec: QuantSpec) -> torch.Tensor:
    """x (E, C, K) @ w (E, K, N) with per-expert quantization: expert e's
    activations on its own scale ``s_a[e]`` ((E, 1, 1)), its weight on its
    own per-channel ``s_w[e]`` ((E, 1, N)). Under calibration the input's
    |x| percentile is recorded per expert (empty slots' zero rows
    included, as in the JAX package)."""
    if calibration.active():
        calibration.record_input(x_ecd, per_axis0=True)
    if spec.mode == "int":
        if spec.a_bits and spec.use_kernels:
            from ..kernels import ops as kops
            return kops.expert_matmul(x_ecd, p, spec)
        if spec.a_bits:
            return expert_matmul_exact(x_ecd, p["wq"], p["s_a"], p["s_w"],
                                       spec.w_bits, spec.a_bits)
        assert not spec.use_kernels, \
            "fp-activation fallback is reference-backend only"
        w8 = unpack_int4(p["wq"], axis=-2) if spec.w_bits == 4 else p["wq"]
        k = x_ecd.shape[-1]
        if w8.shape[-2] != k:
            w8 = w8.narrow(-2, 0, k)
        w = (w8.to(torch.float32) * p["s_w"]).to(x_ecd.dtype)
        return torch.matmul(x_ecd, w)
    w = p["w"]
    if spec.mode == "fake" and spec.enabled:
        w = fake_quant(w, p["s_w"], spec.w_bits, spec.grad_mode)
        if spec.a_bits:
            x_ecd = fake_quant(x_ecd, p["s_a"], spec.a_bits, spec.grad_mode)
    return torch.matmul(x_ecd, w.to(x_ecd.dtype))


def top_k(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest gates and their experts along the last axis, the
    lower index first among equal gates (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none): a stable descending sort, cut to k."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """f32 router logits -> softmax gates, the top-k experts and their gates
    renormalised to sum to 1: (gates, top_vals, top_idx)."""
    logits = x.to(torch.float32) @ router.to(torch.float32)
    gates = torch.softmax(logits, dim=-1)
    top_vals, top_idx = top_k(gates, k)
    top_vals = top_vals / torch.clamp_min(top_vals.sum(-1, keepdim=True), 1e-9)
    return gates, top_vals, top_idx


def _experts(xe: torch.Tensor, p: dict, spec: QuantSpec, dtype) -> torch.Tensor:
    """The gated SwiGLU experts on their (E, rows, d) slots."""
    h1 = _expert_matmul(xe, p["w1"], spec)
    h3 = _expert_matmul(xe, p["w3"], spec)
    h = F.silu(h1.to(torch.float32)).to(dtype) * h3
    return _expert_matmul(h, p["w2"], spec)


def _shared_expert(x: torch.Tensor, p: dict, cfg: ModelConfig,
                   spec: QuantSpec) -> torch.Tensor:
    """The always-on shared expert behind its sigmoid gate (qwen2-moe)."""
    gate = torch.sigmoid(x.to(torch.float32) @ p["shared_gate"]).to(x.dtype)
    sub = dataclasses.replace(cfg, d_ff=cfg.shared_expert_d_ff)
    return gate * ffn_apply(x, p["shared"], sub, spec)


def _aux_loss(gates: torch.Tensor, first: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balance loss: ``coef * E * sum(frac * prob)``, frac
    the share of tokens whose first choice is each expert, prob the mean
    gate; means over every axis but the experts'."""
    E = cfg.num_experts
    lead = tuple(range(gates.dim() - 1))
    frac = torch.mean(F.one_hot(first, E).to(torch.float32), dim=lead)
    prob = torch.mean(gates, dim=lead)
    return cfg.router_aux_coef * E * torch.sum(frac * prob)


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots an expert has for ``tokens`` routed tokens (JAX's formula)."""
    return max(1, int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts))


def dense_dispatch(top_vals: torch.Tensor, top_idx: torch.Tensor, E: int, C: int,
                   dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The grouped one-hot dispatch of (G, Sg, K) choices onto E experts of
    C slots: ``dispatch`` (G, Sg, E, C) in ``dtype``, 1 where a token's
    choice sits, and ``combine``, the same places holding that choice's
    gate, in f32. Slots fill in token order, choice by choice (all first
    choices, then the second ...); a choice past its expert's C slots is
    dropped."""
    G, Sg, K = top_idx.shape
    f32, dev = torch.float32, top_idx.device
    counts = torch.zeros((G, 1, E), dtype=f32, device=dev)
    dispatch = torch.zeros((G, Sg, E, C), dtype=dtype, device=dev)
    combine = torch.zeros((G, Sg, E, C), dtype=f32, device=dev)
    slots = torch.arange(C, device=dev)
    for j in range(K):       # K is small (4 / 8); unrolled
        m_j = F.one_hot(top_idx[..., j], E).to(f32)                 # (G,Sg,E)
        pos = torch.cumsum(m_j, dim=1) - 1.0 + counts
        keep = (pos < C).to(f32) * m_j
        counts = counts + m_j.sum(dim=1, keepdim=True)
        # one_hot(pos, C): an out-of-range position is a row of zeros
        oh = (pos.to(torch.int32)[..., None] == slots).to(f32)
        d_j = keep[..., None] * oh                                  # (G,Sg,E,C)
        dispatch = dispatch + d_j.to(dtype)
        combine = combine + d_j * top_vals[..., j, None, None]
    return dispatch, combine


def moe_apply(x: torch.Tensor, p: dict, cfg: ModelConfig, spec: QuantSpec):
    """Grouped dense one-hot dispatch: x (B, S, d) -> (out, aux_loss).

    The B*S tokens form G = max(1, B*S // moe_group_size) groups (G must
    divide B*S: raised, never padded); each group gives every expert C
    slots, filled in token order, choice by choice (all first choices, then
    the second ...); a token past its expert's capacity is dropped for that
    choice (:func:`dense_dispatch`). Dispatch runs in x's dtype, the combine
    weights are built in f32 and cast to it, as in the JAX package."""
    if cfg.moe_impl == "sorted":
        return moe_apply_sorted(x, p, cfg, spec)
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    T = B * S
    G = max(1, T // cfg.moe_group_size)
    if T % G:
        raise ValueError(f"moe_apply: {T} tokens do not split into {G} groups "
                         f"of moe_group_size={cfg.moe_group_size}")
    xg = x.reshape(G, T // G, d)
    Sg = xg.shape[1]
    C = capacity(Sg, cfg)
    gates, top_vals, top_idx = route(xg, p["router"], K)

    dispatch, combine = dense_dispatch(top_vals, top_idx, E, C, x.dtype)
    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)               # (G,E,C,d)
    xe = xe.permute(1, 0, 2, 3).reshape(E, G * C, d)
    ye = _experts(xe, p, spec, x.dtype)
    ye = ye.reshape(E, G, C, d).permute(1, 0, 2, 3)                  # (G,E,C,d)
    out = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), ye)
    if "shared" in p:
        out = (out.reshape(B, S, d) + _shared_expert(x, p, cfg, spec)).reshape(G, Sg, d)
    return out.reshape(B, S, d), _aux_loss(gates, top_idx[..., 0], cfg)


def moe_apply_sorted(x: torch.Tensor, p: dict, cfg: ModelConfig, spec: QuantSpec):
    """Sort-based dispatch: the (token, choice) pairs sorted by expert
    (stably), each expert's first C kept, gathered into (E, C, d) slots, the
    experts run, and each token's kept rows, weighted by their gates, summed
    back. Equal to :func:`moe_apply` wherever no expert overflows; under
    overflow the two drop different tokens (the priority orders differ).

    JAX scatter-adds the rows back (``.at[tok].add``); ``index_add_`` on the
    card sums with atomics, whose order moves from run to run. Each token
    has exactly K rows, so they are summed here in a fixed order instead:
    by ascending expert, the order of the sorted pairs, so two calls and a
    CUDA-graph replay are bit-equal."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    T = B * S
    xf = x.reshape(T, d)
    C = capacity(T, cfg)
    dev = x.device
    gates, top_vals, top_idx = route(xf, p["router"], K)

    e_flat = top_idx.reshape(-1)                                    # (T*K,)
    g_flat = top_vals.reshape(-1)
    order = torch.sort(e_flat, stable=True).indices
    e_sorted = e_flat[order]
    tok_sorted = order // K
    seg_start = torch.searchsorted(e_sorted, torch.arange(E, device=dev))
    pos_in_e = torch.arange(T * K, device=dev) - seg_start[e_sorted]
    keep = pos_in_e < C
    slot = torch.where(keep, e_sorted * C + pos_in_e, E * C)        # drop -> pad

    # gather the tokens into expert slots (one extra pad row takes the drops)
    src = torch.zeros(E * C + 1, dtype=torch.int64, device=dev)
    src.scatter_(0, slot, tok_sorted + 1)
    src = src[:E * C]
    xe = torch.where((src > 0)[:, None], xf[torch.clamp_min(src - 1, 0)], 0.0)
    ye = _experts(xe.reshape(E, C, d), p, spec, x.dtype).reshape(E * C, d)

    y_rows = torch.where(keep[:, None],
                         ye[torch.clamp_max(slot, E * C - 1)]
                         * g_flat[order][:, None].to(ye.dtype), 0.0)
    y_tok = torch.empty_like(y_rows)
    y_tok[order] = y_rows                  # row t*K + j: token t's choice j
    y_tok = y_tok.reshape(T, K, d)
    by_expert = torch.sort(top_idx, dim=-1, stable=True).indices
    y_tok = torch.gather(y_tok, 1, by_expert[..., None].expand(T, K, d))
    out = y_tok[:, 0]
    for j in range(1, K):
        out = out + y_tok[:, j]
    if "shared" in p:
        out = out + _shared_expert(xf, p, cfg, spec)
    return out.reshape(B, S, d).to(x.dtype), _aux_loss(gates, top_idx[:, 0], cfg)


def block_apply(x, p, cfg: ModelConfig, spec: QuantSpec, *,
                cache: Optional[dict] = None, kv_len=None,
                want_taps: bool = False, want_aux: bool = False):
    """One block. Pre-LN (decoders): x += attn(LN(x)); x += ffn(LN(x)).
    Post-LN (BERT): x = LN(x + attn(x)); x = LN(x + ffn(x)). A MoE block
    runs ``moe_apply`` where the others run the FFN. Returns ``(x,
    new_kv)``, then the attention's q/k/v taps with ``want_taps`` and the
    block's load-balance loss (0 outside MoE) with ``want_aux``; ``new_kv``
    is the new tokens' (k, v) when ``cache`` is given, else None. Forwards
    longer than ``cfg.attn_chunk_threshold`` offer attention the chunk
    ``cfg.attn_chunk``."""
    pre = cfg.norm == "rms" or not cfg.learned_pos  # BERT uses post-LN
    chunk = cfg.attn_chunk if x.shape[1] > cfg.attn_chunk_threshold else 0
    n_heads = p["attn"]["wq"]["s_w"].shape[-1] // cfg.hd
    n_kv = p["attn"]["wk"]["s_w"].shape[-1] // cfg.hd
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def attn(h):
        return attention_block(
            h, p["attn"], n_heads=n_heads, n_kv=n_kv,
            hd=cfg.hd, spec=spec, causal=cfg.causal, rope=cfg.rope,
            rope_theta=cfg.rope_theta, cache=cache, kv_len=kv_len,
            chunk=chunk, want_taps=True)

    def ffn(h):
        nonlocal aux
        if cfg.family == "moe":
            out, aux = moe_apply(h, p["moe"], cfg, spec)
            return out
        return ffn_apply(h, p["ffn"], cfg, spec)

    if pre:
        a, new_kv, taps = attn(_norm(x, p["ln1"], cfg.norm))
        x = x + a
        x = x + ffn(_norm(x, p["ln2"], cfg.norm))
    else:
        a, new_kv, taps = attn(x)
        x = _norm(x + a, p["ln1"], cfg.norm)
        x = _norm(x + ffn(x), p["ln2"], cfg.norm)
    return (x, new_kv) + ((taps,) if want_taps else ()) + ((aux,) if want_aux else ())


# ------------------------------------------------------------------ init
def _normal(g: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32) * 0.02


def init_linear(g, k: int, n: int, bias: bool, stacked: Optional[int],
                device) -> dict:
    """fp linear params (+ unit quant scales, calibrated later); a leading
    layer dim of ``stacked`` unless it is None."""
    lead = () if stacked is None else (stacked,)
    p = {"w": _normal(g, lead + (k, n), device),
         "s_w": torch.ones(lead + (1, n), device=device),
         "s_a": torch.ones(lead, device=device)}
    if bias:
        p["b"] = torch.zeros(lead + (n,), device=device)
    return p


def init_norm(d: int, stacked: Optional[int], device, kind: str = "ln") -> dict:
    shape = (d,) if stacked is None else (stacked, d)
    p = {"scale": torch.ones(shape, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros(shape, device=device)
    return p


def init_expert_linear(g, e: int, k: int, n: int, stacked: Optional[int],
                       device) -> dict:
    """``e`` experts' fp (K, N) weights with per-expert unit scales: s_w (e,
    1, n), s_a (e, 1, 1); a leading layer dim of ``stacked`` unless None."""
    lead = () if stacked is None else (stacked,)
    return {"w": _normal(g, lead + (e, k, n), device),
            "s_w": torch.ones(lead + (e, 1, n), device=device),
            "s_a": torch.ones(lead + (e, 1, 1), device=device)}


def init_moe(g, cfg: ModelConfig, stacked: Optional[int], device) -> dict:
    """The JAX ``init_moe`` tree: the f32 router (d, E), the experts' w1 /
    w3 (d -> expert_d_ff) and w2, and, with a shared expert, its SwiGLU FFN
    and its (d, 1) sigmoid gate."""
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    lead = () if stacked is None else (stacked,)
    p = {"router": _normal(g, lead + (d, e), device),
         "w1": init_expert_linear(g, e, d, f, stacked, device),
         "w3": init_expert_linear(g, e, d, f, stacked, device),
         "w2": init_expert_linear(g, e, f, d, stacked, device)}
    if cfg.shared_expert_d_ff:
        sf = cfg.shared_expert_d_ff
        lin = lambda k, n: init_linear(g, k, n, False, stacked, device)
        p["shared"] = {"w1": lin(d, sf), "w3": lin(d, sf), "w2": lin(sf, d)}
        p["shared_gate"] = _normal(g, lead + (d, 1), device)
    return p


def init_block(g: torch.Generator, cfg: ModelConfig, stacked: Optional[int],
               device) -> dict:
    """One transformer block's fp params (``stacked`` of them along a
    leading layer dim, or one unstacked block when None): the JAX
    ``init_block`` tree, same keys, shapes and init scales (weights
    N(0, 0.02), biases 0, norms 1 / 0, quant scales 1). Values come from
    ``g``; ``jax.random``'s cannot be reproduced, so parity tests carry
    JAX's arrays across instead."""
    if cfg.family not in ("bert", "dense", "vlm", "moe") or cfg.fused_proj:
        raise ValueError(f"init_block: family {cfg.family!r} (fused_proj="
                         f"{cfg.fused_proj}) arrives with a later slice of "
                         "the port")
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv = cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
    lin = lambda k, n, bias: init_linear(g, k, n, bias, stacked, device)
    p = {"ln1": init_norm(d, stacked, device, cfg.norm),
         "attn": {"wq": lin(d, hq, cfg.qkv_bias), "wk": lin(d, hkv, cfg.qkv_bias),
                  "wv": lin(d, hkv, cfg.qkv_bias), "wo": lin(hq, d, cfg.out_bias)},
         "ln2": init_norm(d, stacked, device, cfg.norm)}
    if cfg.family == "moe":
        p["moe"] = init_moe(g, cfg, stacked, device)
    elif cfg.act == "swiglu":
        p["ffn"] = {"w1": lin(d, f, False), "w3": lin(d, f, False),
                    "w2": lin(f, d, False)}
    else:
        p["ffn"] = {"w1": lin(d, f, True), "w2": lin(f, d, True)}
    return p


def init_lm(cfg: ModelConfig, g: torch.Generator, device) -> dict:
    """The JAX ``init_lm`` tree (same keys and shapes) for the bert, dense,
    vlm and moe families. Values come from ``g``, so they differ from
    ``jax.random``'s; parity tests carry JAX's arrays across instead
    (``deploy.params_from_numpy``)."""
    if cfg.family not in ("bert", "dense", "vlm", "moe"):
        raise ValueError(f"init_lm: family {cfg.family!r} arrives with a "
                         "later slice of the port")
    d, V = cfg.d_model, cfg.padded_vocab
    params = {"embed": _normal(g, (V, d), device)}
    params["layers"] = init_block(g, cfg, cfg.num_layers, device)
    params["final_norm"] = init_norm(d, None, device, cfg.norm)
    if cfg.learned_pos:
        params["pos_embed"] = _normal(g, (8192, d), device)
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(g, (d, V), device)
    return params


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor,
           patch_embeds: Optional[torch.Tensor] = None,
           patch_mask: Optional[torch.Tensor] = None, offset: int = 0):
    # F.embedding, not indexing: its backward sums the rows of repeated
    # tokens in a fixed order (indexing's accumulates in parallel on the
    # CPU), so training runs repeat bit for bit
    x = F.embedding(tokens, params["embed"]).to(cfg.torch_dtype)
    if patch_embeds is not None:
        # the anyres stub: the k-th masked position takes patch row k
        # (clipped to the last row when more positions are masked)
        d = x.shape[-1]
        npatch = patch_embeds.shape[1]
        idx = torch.cumsum(patch_mask.to(torch.int32), dim=1) - 1
        idx = torch.clamp(idx, 0, npatch - 1).to(torch.int64)
        gathered = torch.gather(patch_embeds, 1,
                                idx[..., None].expand(*idx.shape, d))
        x = torch.where(patch_mask[..., None], gathered.to(x.dtype), x)
    if cfg.learned_pos:
        S = x.shape[1]
        x = x + params["pos_embed"][offset:offset + S][None].to(x.dtype)
    return x


# ------------------------------------------------------------ decoder LM
#: keys of the paged cache dict that are per step, not per layer
PAGED_STEP_KEYS = ("len", "tables", "write_block", "write_off")


def layer_cache(cs: dict, idx: int) -> dict:
    """Layer ``idx`` of the stacked cache (views, not copies); works for the
    fp {'k','v'} and the quantized {'k_q','v_q','k_scale','v_scale'}
    layouts alike, dense (L, B, S, ...) or paged (L, NB, block, ...). The
    cursors, and a paged cache's tables and write targets, pass through."""
    return {key: (val if key in PAGED_STEP_KEYS else val[idx])
            for key, val in cs.items()}


def write_new_kv(cs: dict, idx: int, new_kv) -> None:
    """Write the new tokens' (B, Sq, Hkv, dh) k/v into layer ``idx`` of the
    stacked cache at each slot's cursor, in place.

    Quantized caches quantize on append: the fp rows become codes plus one
    scale per (token, head) row, so a token's scale never aliases another
    token's. A 0-d cursor writes rows ``len .. len+Sq`` of every slot (the
    prefill scratch cache). Per-slot cursors (the serving slot table) take
    one token per step; a slot whose cursor reached the end of the buffer
    (an idle slot that keeps decoding) writes nothing: the JAX package drops
    such writes with ``mode='drop'``, and here the index is clamped and the
    old row written back, with no host synchronisation. A paged cache (a
    ``tables`` key, see ``serving/block_pool.py``) takes each slot's row at
    its own ``(write_block, write_off)``, which the host aimed at the
    slot's cursor or, for an idle slot, at the pool's trash block."""
    k_new, v_new = new_kv
    if "k_q" in cs:
        from ..kernels.kv_pack import quantize_kv
        bits = 4 if cs["k_q"].dtype == torch.uint8 else 8
        kq, ks = quantize_kv(k_new, bits)
        vq, vs = quantize_kv(v_new, bits)
        rows = {"k_q": kq, "v_q": vq, "k_scale": ks, "v_scale": vs}
    else:
        rows = {"k": k_new.to(cs["k"].dtype), "v": v_new.to(cs["v"].dtype)}
    lens = cs["len"]
    B, Sq = k_new.shape[0], k_new.shape[1]
    dev = k_new.device
    if not lens.dim():
        cols = lens.to(torch.int64) + torch.arange(Sq, device=dev)
        for key, val in rows.items():
            cs[key][idx][:, cols] = val
        return
    if Sq != 1:
        raise NotImplementedError(
            "per-slot cursors take one token per step; multi-token writes "
            "(prefill, the prefix-cache chunks) run on a scratch cache with "
            "a 0-d cursor")
    if "tables" in cs:
        wb, wo = cs["write_block"], cs["write_off"]
        for key, val in rows.items():
            cs[key][idx][wb, wo] = val[:, 0]
        return
    S = cs[next(iter(rows))].shape[2]
    pos = lens.to(torch.int64)
    keep = pos < S
    pos = torch.clamp(pos, max=S - 1)
    r = torch.arange(B, device=dev)
    for key, val in rows.items():
        buf = cs[key][idx]
        new = val[:, 0]
        mask = keep.reshape(B, *([1] * (new.dim() - 1)))
        buf[r, pos] = torch.where(mask, new, buf[r, pos])


def lm_forward(params, cfg: ModelConfig, segments, *, tokens,
               patch_embeds=None, patch_mask=None,
               caches: Optional[dict] = None, want_taps: bool = False,
               want_aux: bool = False):
    """Returns ``(logits, new_caches)``, then ``taps`` with ``want_taps``
    (the last layer's q/k/v, as the JAX package taps only the last layer)
    and ``aux`` with ``want_aux`` (the MoE layers' summed load-balance
    loss, a 0-d f32 tensor; 0 for the other families); logits (B, S,
    padded_vocab) in the activation dtype, padded-vocab entries at -1e9.

    patch_embeds / patch_mask (vlm): (B, P, d) patch embeddings placed, in
    order, at the True positions of the (B, S) bool mask.

    caches: stacked per-layer KV caches ``{'k': (L,B,Smax,Hkv,hd), ...,
    'len'}`` or the quantized layout, or a paged cache dict
    (``serving/block_pool.PagedKVCache.decode_state``), or None. They are
    updated in place; ``new_caches`` holds the same buffers and
    ``len + S``."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    if patch_embeds is not None:
        patch_embeds = torch.as_tensor(patch_embeds, device=dev)
        patch_mask = torch.as_tensor(patch_mask, dtype=torch.bool, device=dev)
    x = _embed(params, cfg, tokens, patch_embeds, patch_mask)
    layers = params["layers"]
    # deployed int mode: layers arrive as a per-segment list (packed
    # weights cannot live in one stacked array across bit-width segments)
    presliced = isinstance(layers, (list, tuple))
    taps = None
    moe = cfg.family == "moe"
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    last = segments[-1][1] - 1
    for si, (start, end, spec) in enumerate(segments):
        seg = layers[si] if presliced else slice_stack(layers, start, end)
        auxs = []
        for i in range(end - start):
            lp = tree_map(lambda a: a[i], seg)
            cache_l = None if caches is None else layer_cache(caches, start + i)
            tap = want_taps and start + i == last
            out = block_apply(x, lp, cfg, spec, cache=cache_l, want_taps=tap,
                              want_aux=moe)
            x, new_kv = out[0], out[1]
            if tap:
                taps = out[2]
            if moe:
                auxs.append(out[-1])
            if caches is not None:
                write_new_kv(caches, start + i, new_kv)
        if auxs:         # JAX sums a segment's layers, then the segments
            aux_total = aux_total + torch.sum(torch.stack(auxs))
    new_caches = None
    if caches is not None:
        new_caches = {**caches, "len": caches["len"] + x.shape[1]}
    x = _norm(x, params["final_norm"], cfg.norm)
    head = params.get("lm_head")
    if head is None:
        logits = x @ params["embed"].T.to(x.dtype)
    else:
        logits = x @ head.to(x.dtype)
    logits = mask_padded_vocab(logits, cfg)
    return ((logits, new_caches) + ((taps,) if want_taps else ())
            + ((aux_total,) if want_aux else ()))


def lm_caches(cfg: ModelConfig, batch: int, max_len: int,
              dtype: torch.dtype = torch.bfloat16, *, per_slot_len: bool = False,
              kv_bits: int = 16, device=None,
              kv_heads: Optional[int] = None) -> dict:
    """kv_bits 16: fp {'k','v','len'}. kv_bits 8/4: the packed quantized
    layout {'k_q','v_q','k_scale','v_scale','len'}: integer codes (int4
    nibble-packed along head_dim) plus per-(token, head) f32 scales. ``len``
    is a 0-d cursor, or (batch,) with ``per_slot_len``. ``kv_heads``: the
    heads held here (a tensor-parallel rank's share; default all)."""
    L = cfg.num_layers
    Hkv = cfg.num_kv_heads if kv_heads is None else kv_heads
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    length = z((batch,) if per_slot_len else (), torch.int32)
    if kv_bits in (8, 4):
        from ..kernels.kv_pack import kv_code_dtype, kv_code_shape
        dhp = kv_code_shape(cfg.hd, kv_bits)
        cdt = kv_code_dtype(kv_bits)
        return {"k_q": z((L, batch, max_len, Hkv, dhp), cdt),
                "v_q": z((L, batch, max_len, Hkv, dhp), cdt),
                "k_scale": z((L, batch, max_len, Hkv), torch.float32),
                "v_scale": z((L, batch, max_len, Hkv), torch.float32),
                "len": length}
    if kv_bits != 16:
        raise ValueError(f"kv_bits must be 16, 8 or 4, got {kv_bits}")
    return {"k": z((L, batch, max_len, Hkv, cfg.hd), dtype),
            "v": z((L, batch, max_len, Hkv, cfg.hd), dtype),
            "len": length}


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token CE in fp32; labels already shifted by the data pipeline
    (entries below 0 are ignored)."""
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp_min(0).to(torch.int64)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1.0)


def mask_padded_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """-1e9 for the vocab-padding logits (embedding rows padded to 256)."""
    V = cfg.padded_vocab
    if V == cfg.vocab_size:
        return logits
    ids = torch.arange(V, device=logits.device)
    return torch.where(ids < cfg.vocab_size, logits,
                       torch.full((), -1e9, dtype=logits.dtype,
                                  device=logits.device))
