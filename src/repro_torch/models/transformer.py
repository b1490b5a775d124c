"""The decoder-only LM (dense and vlm families) and the BERT subset of the
shared transformer stack.

Layer parameters are stacked (leading dim = layers), as in the JAX package.
The MKQ mixed-precision policy (int4 from the last layer backwards, int8
elsewhere) yields CONTIGUOUS bit-segments, and the stack runs as one Python
loop per segment with a static ``QuantSpec``.

KV caches are updated in place (the JAX package returns new arrays and
lets XLA alias them): ``lm_forward`` writes each layer's new rows into the
cache buffers and returns the same buffers with the advanced cursor. The
decode forward makes no host synchronisation, so one decode step can be
captured in a CUDA graph.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.policy import QuantPolicy
from ..core.tree import slice_stack, tree_map
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


def block_apply(x, p, cfg: ModelConfig, spec: QuantSpec, *,
                cache: Optional[dict] = None, kv_len=None,
                want_taps: bool = False):
    """One block. Pre-LN (decoders): x += attn(LN(x)); x += ffn(LN(x)).
    Post-LN (BERT): x = LN(x + attn(x)); x = LN(x + ffn(x)). Returns
    ``(x, new_kv)``, or ``(x, new_kv, taps)`` with ``want_taps`` (the
    attention's q/k/v taps); ``new_kv`` is the new tokens' (k, v) when
    ``cache`` is given, else None. Forwards longer than
    ``cfg.attn_chunk_threshold`` offer attention the chunk
    ``cfg.attn_chunk``."""
    if cfg.family == "moe":
        raise NotImplementedError("MoE layers arrive with a later slice")
    pre = cfg.norm == "rms" or not cfg.learned_pos  # BERT uses post-LN
    chunk = cfg.attn_chunk if x.shape[1] > cfg.attn_chunk_threshold else 0
    n_heads = p["attn"]["wq"]["s_w"].shape[-1] // cfg.hd
    n_kv = p["attn"]["wk"]["s_w"].shape[-1] // cfg.hd

    def attn(h):
        return attention_block(
            h, p["attn"], n_heads=n_heads, n_kv=n_kv,
            hd=cfg.hd, spec=spec, causal=cfg.causal, rope=cfg.rope,
            rope_theta=cfg.rope_theta, cache=cache, kv_len=kv_len,
            chunk=chunk, want_taps=True)

    if pre:
        a, new_kv, taps = attn(_norm(x, p["ln1"], cfg.norm))
        x = x + a
        x = x + ffn_apply(_norm(x, p["ln2"], cfg.norm), p["ffn"], cfg, spec)
    else:
        a, new_kv, taps = attn(x)
        x = _norm(x + a, p["ln1"], cfg.norm)
        f = ffn_apply(x, p["ffn"], cfg, spec)
        x = _norm(x + f, p["ln2"], cfg.norm)
    return (x, new_kv, taps) if want_taps else (x, new_kv)


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


def init_block(g: torch.Generator, cfg: ModelConfig, stacked: Optional[int],
               device) -> dict:
    """One transformer block's fp params (``stacked`` of them along a
    leading layer dim, or one unstacked block when None): the JAX
    ``init_block`` tree, same keys, shapes and init scales (weights
    N(0, 0.02), biases 0, norms 1 / 0, quant scales 1). Values come from
    ``g``; ``jax.random``'s cannot be reproduced, so parity tests carry
    JAX's arrays across instead."""
    if cfg.family not in ("bert", "dense", "vlm") or cfg.fused_proj:
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
    if cfg.act == "swiglu":
        p["ffn"] = {"w1": lin(d, f, False), "w3": lin(d, f, False),
                    "w2": lin(f, d, False)}
    else:
        p["ffn"] = {"w1": lin(d, f, True), "w2": lin(f, d, True)}
    return p


def init_lm(cfg: ModelConfig, g: torch.Generator, device) -> dict:
    """The JAX ``init_lm`` tree (same keys and shapes) for the bert, dense
    and vlm families. Values come from ``g``, so they differ from
    ``jax.random``'s; parity tests carry JAX's arrays across instead
    (``deploy.params_from_numpy``)."""
    if cfg.family not in ("bert", "dense", "vlm"):
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
               caches: Optional[dict] = None, want_taps: bool = False):
    """Returns ``(logits, new_caches)``, or ``(logits, new_caches, taps)``
    with ``want_taps`` (the last layer's q/k/v, as the JAX package taps
    only the last layer); logits (B, S, padded_vocab) in the activation
    dtype, padded-vocab entries at -1e9.

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
    last = segments[-1][1] - 1
    for si, (start, end, spec) in enumerate(segments):
        seg = layers[si] if presliced else slice_stack(layers, start, end)
        for i in range(end - start):
            lp = tree_map(lambda a: a[i], seg)
            cache_l = None if caches is None else layer_cache(caches, start + i)
            tap = want_taps and start + i == last
            out = block_apply(x, lp, cfg, spec, cache=cache_l, want_taps=tap)
            x, new_kv = out[0], out[1]
            if tap:
                taps = out[2]
            if caches is not None:
                write_new_kv(caches, start + i, new_kv)
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
    return (logits, new_caches, taps) if want_taps else (logits, new_caches)


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
