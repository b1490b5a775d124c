"""The BERT subset of the shared transformer stack.

Layer parameters are stacked (leading dim = layers), as in the JAX package.
The MKQ mixed-precision policy (int4 from the last layer backwards, int8
elsewhere) yields CONTIGUOUS bit-segments, and the stack runs as one Python
loop per segment with a static ``QuantSpec``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..core.policy import QuantPolicy
from .attention import attention_block
from .layers import QuantSpec, act_fn, layernorm, qlinear


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
    if kind != "ln":
        raise NotImplementedError("RMSNorm families arrive with a later slice")
    return layernorm(x, p["scale"], p["bias"])


def ffn_apply(x, p, cfg: ModelConfig, spec: QuantSpec):
    if cfg.act == "swiglu":
        raise NotImplementedError("gated FFNs arrive with a later slice")
    # non-gated FFN: the activation can ride the int4 kernel's fused
    # dequant+bias+GELU epilogue (one write of the output instead of three)
    fused = (spec.mode == "int" and spec.use_kernels and spec.fuse_epilogue
             and spec.w_bits == 4 and cfg.act in ("gelu", "relu"))
    h1 = qlinear(x, p["w1"], spec, act=cfg.act if fused else None)
    h = h1 if fused else act_fn(cfg.act)(h1)
    return qlinear(h, p["w2"], spec)


def block_apply(x, p, cfg: ModelConfig, spec: QuantSpec, *, kv_len=None):
    """One post-LN (BERT) block: x = LN(x + attn(x)); x = LN(x + ffn(x))."""
    if cfg.norm == "rms" or not cfg.learned_pos:
        raise NotImplementedError("pre-LN families arrive with a later slice")
    a = attention_block(x, p["attn"], n_heads=cfg.num_heads,
                        n_kv=cfg.num_kv_heads, hd=cfg.hd, spec=spec,
                        causal=cfg.causal, rope=cfg.rope, kv_len=kv_len)
    x = _norm(x + a, p["ln1"], cfg.norm)
    f = ffn_apply(x, p["ffn"], cfg, spec)
    return _norm(x + f, p["ln2"], cfg.norm)


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


def init_norm(d: int, stacked: Optional[int], device) -> dict:
    shape = (d,) if stacked is None else (stacked, d)
    return {"scale": torch.ones(shape, device=device),
            "bias": torch.zeros(shape, device=device)}


def init_lm(cfg: ModelConfig, g: torch.Generator, device) -> dict:
    """The JAX ``init_lm`` tree (same keys and shapes) for the post-LN,
    learned-position, non-gated families. Values come from ``g``, so they
    differ from ``jax.random``'s; parity tests carry JAX's arrays across
    instead (``deploy.params_from_numpy``)."""
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    hq, hkv = cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
    V = cfg.padded_vocab
    params = {
        "embed": _normal(g, (V, d), device),
        "layers": {
            "ln1": init_norm(d, L, device),
            "attn": {"wq": init_linear(g, d, hq, cfg.qkv_bias, L, device),
                     "wk": init_linear(g, d, hkv, cfg.qkv_bias, L, device),
                     "wv": init_linear(g, d, hkv, cfg.qkv_bias, L, device),
                     "wo": init_linear(g, hq, d, cfg.out_bias, L, device)},
            "ln2": init_norm(d, L, device),
            "ffn": {"w1": init_linear(g, d, f, True, L, device),
                    "w2": init_linear(g, f, d, True, L, device)},
        },
        "final_norm": init_norm(d, None, device),
        "pos_embed": _normal(g, (8192, d), device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(g, (d, V), device)
    return params


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor, offset: int = 0):
    x = params["embed"][tokens].to(cfg.torch_dtype)
    if cfg.learned_pos:
        S = x.shape[1]
        x = x + params["pos_embed"][offset:offset + S][None].to(x.dtype)
    return x
