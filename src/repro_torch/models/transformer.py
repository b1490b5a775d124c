"""The decoder-only LM (dense family) and the BERT subset of the shared
transformer stack.

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
                         act_bits: Optional[int] = None
                         ) -> list[tuple[int, int, QuantSpec]]:
    """Contiguous (start, end, QuantSpec) runs of equal bit-width.

    ``act_bits`` is the plan-level activation override: applied to every
    quantized layer, so it can never merge or split the policy's segment
    boundaries."""
    segs: list[tuple[int, int, QuantSpec]] = []
    for l in range(policy.num_layers):
        wb, ab = policy.weight_bits(l) or 0, policy.act_bits(l) or 0
        if act_bits is not None and wb:
            ab = act_bits
        spec = QuantSpec(mode=policy.mode, w_bits=wb, a_bits=ab,
                         grad_mode=policy.grad_mode, use_kernels=use_kernels,
                         fuse_epilogue=fuse_epilogue)
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
        return qlinear(h, p["w2"], spec)
    # non-gated FFN: the activation can ride the int4 kernel's fused
    # dequant+bias+GELU epilogue (one write of the output instead of three)
    fused = (spec.mode == "int" and spec.use_kernels and spec.fuse_epilogue
             and spec.w_bits == 4 and cfg.act in ("gelu", "relu"))
    h1 = qlinear(x, p["w1"], spec, act=cfg.act if fused else None)
    h = h1 if fused else act_fn(cfg.act)(h1)
    return qlinear(h, p["w2"], spec)


def block_apply(x, p, cfg: ModelConfig, spec: QuantSpec, *,
                cache: Optional[dict] = None, kv_len=None):
    """One block. Pre-LN (decoders): x += attn(LN(x)); x += ffn(LN(x)).
    Post-LN (BERT): x = LN(x + attn(x)); x = LN(x + ffn(x)). Returns
    ``(x, new_kv)``; ``new_kv`` is the new tokens' (k, v) when ``cache``
    is given, else None."""
    if cfg.family == "moe":
        raise NotImplementedError("MoE layers arrive with a later slice")
    pre = cfg.norm == "rms" or not cfg.learned_pos  # BERT uses post-LN

    def attn(h):
        return attention_block(
            h, p["attn"], n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
            hd=cfg.hd, spec=spec, causal=cfg.causal, rope=cfg.rope,
            rope_theta=cfg.rope_theta, cache=cache, kv_len=kv_len)

    if pre:
        a, new_kv = attn(_norm(x, p["ln1"], cfg.norm))
        x = x + a
        x = x + ffn_apply(_norm(x, p["ln2"], cfg.norm), p["ffn"], cfg, spec)
    else:
        a, new_kv = attn(x)
        x = _norm(x + a, p["ln1"], cfg.norm)
        f = ffn_apply(x, p["ffn"], cfg, spec)
        x = _norm(x + f, p["ln2"], cfg.norm)
    return x, new_kv


# ------------------------------------------------------------------ init
def _normal(g: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32) * 0.02


def init_linear(g, k: int, n: int, bias: bool, stacked: int, device) -> dict:
    """fp linear params (+ unit quant scales, calibrated later)."""
    p = {"w": _normal(g, (stacked, k, n), device),
         "s_w": torch.ones((stacked, 1, n), device=device),
         "s_a": torch.ones((stacked,), device=device)}
    if bias:
        p["b"] = torch.zeros((stacked, n), device=device)
    return p


def init_norm(d: int, stacked: Optional[int], device, kind: str = "ln") -> dict:
    shape = (d,) if stacked is None else (stacked, d)
    p = {"scale": torch.ones(shape, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros(shape, device=device)
    return p


def init_lm(cfg: ModelConfig, g: torch.Generator, device) -> dict:
    """The JAX ``init_lm`` tree (same keys and shapes) for the bert and
    dense families. Values come from ``g``, so they differ from
    ``jax.random``'s; parity tests carry JAX's arrays across instead
    (``deploy.params_from_numpy``)."""
    if cfg.family not in ("bert", "dense"):
        raise ValueError(f"init_lm: family {cfg.family!r} arrives with a "
                         "later slice of the port")
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    hq, hkv = cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
    V = cfg.padded_vocab

    def ffn():   # drawn after the attention weights, as before
        if cfg.act == "swiglu":
            return {"w1": init_linear(g, d, f, False, L, device),
                    "w3": init_linear(g, d, f, False, L, device),
                    "w2": init_linear(g, f, d, False, L, device)}
        return {"w1": init_linear(g, d, f, True, L, device),
                "w2": init_linear(g, f, d, True, L, device)}

    params = {
        "embed": _normal(g, (V, d), device),
        "layers": {
            "ln1": init_norm(d, L, device, cfg.norm),
            "attn": {"wq": init_linear(g, d, hq, cfg.qkv_bias, L, device),
                     "wk": init_linear(g, d, hkv, cfg.qkv_bias, L, device),
                     "wv": init_linear(g, d, hkv, cfg.qkv_bias, L, device),
                     "wo": init_linear(g, hq, d, cfg.out_bias, L, device)},
            "ln2": init_norm(d, L, device, cfg.norm),
            "ffn": ffn(),
        },
        "final_norm": init_norm(d, None, device, cfg.norm),
    }
    if cfg.learned_pos:
        params["pos_embed"] = _normal(g, (8192, d), device)
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(g, (d, V), device)
    return params


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor, offset: int = 0):
    x = params["embed"][tokens].to(cfg.torch_dtype)
    if cfg.learned_pos:
        S = x.shape[1]
        x = x + params["pos_embed"][offset:offset + S][None].to(x.dtype)
    return x


# ------------------------------------------------------------ decoder LM
def layer_cache(cs: dict, idx: int) -> dict:
    """Layer ``idx`` of the stacked cache (views, not copies); works for the
    fp {'k','v'} and the quantized {'k_q','v_q','k_scale','v_scale'}
    layouts alike."""
    return {key: (val if key == "len" else val[idx]) for key, val in cs.items()}


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
    old row written back, with no host synchronisation."""
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
            "multi-token writes at per-slot cursors belong to the prefix "
            "cache path, a later slice of the port")
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
               caches: Optional[dict] = None):
    """Returns ``(logits, new_caches)``; logits (B, S, padded_vocab) in the
    activation dtype, padded-vocab entries at -1e9.

    caches: stacked per-layer KV caches ``{'k': (L,B,Smax,Hkv,hd), ...,
    'len'}`` or the quantized layout, or None. They are updated in place;
    ``new_caches`` holds the same buffers and ``len + S``."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    x = _embed(params, cfg, tokens)
    layers = params["layers"]
    # deployed int mode: layers arrive as a per-segment list (packed
    # weights cannot live in one stacked array across bit-width segments)
    presliced = isinstance(layers, (list, tuple))
    for si, (start, end, spec) in enumerate(segments):
        seg = layers[si] if presliced else slice_stack(layers, start, end)
        for i in range(end - start):
            lp = tree_map(lambda a: a[i], seg)
            cache_l = None if caches is None else layer_cache(caches, start + i)
            x, new_kv = block_apply(x, lp, cfg, spec, cache=cache_l)
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
    return mask_padded_vocab(logits, cfg), new_caches


def lm_caches(cfg: ModelConfig, batch: int, max_len: int,
              dtype: torch.dtype = torch.bfloat16, *, per_slot_len: bool = False,
              kv_bits: int = 16, device=None) -> dict:
    """kv_bits 16: fp {'k','v','len'}. kv_bits 8/4: the packed quantized
    layout {'k_q','v_q','k_scale','v_scale','len'}: integer codes (int4
    nibble-packed along head_dim) plus per-(token, head) f32 scales. ``len``
    is a 0-d cursor, or (batch,) with ``per_slot_len``."""
    L, Hkv = cfg.num_layers, cfg.num_kv_heads
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


def mask_padded_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """-1e9 for the vocab-padding logits (embedding rows padded to 256)."""
    V = cfg.padded_vocab
    if V == cfg.vocab_size:
        return logits
    ids = torch.arange(V, device=logits.device)
    return torch.where(ids < cfg.vocab_size, logits,
                       torch.full((), -1e9, dtype=logits.dtype,
                                  device=logits.device))
