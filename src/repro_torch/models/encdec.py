"""Encoder-decoder backbone (the Seamless-M4T medium shape), the counterpart
of the JAX package's ``models/encdec.py``.

The modality frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings ``src_embeds`` (B, S_src, d_model). The
decoder is a causal stack with cross-attention onto the encoder output.
The policy's segments apply to the decoder (the deployed half); the encoder
runs at the first segment's spec throughout. A forward longer than
``attn_chunk_threshold`` takes the chunk branch in its self-attention,
which for the bidirectional encoder is the flash kernel with
``causal=False``; cross-attention never does.

Decode state: one fp ``{'k', 'v', 'len'}`` cache over the decoder layers,
(L_dec, B, S, Hkv, hd) with a 0-d cursor, updated in place (the JAX package
returns new arrays). A decode step takes ``enc_out`` instead of
``src_embeds`` (``api.decode_extra_inputs``): the encoder runs once. With
``cfg.remat`` each encoder layer and each decoder layer but a tapped one
runs under activation checkpointing in training (``layers.remat``), at the
JAX package's ``jax.checkpoint`` places.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.tree import slice_stack, tree_map
from .attention import attention_block
from .layers import QuantSpec, remat
from .transformer import (_norm, _normal, ffn_apply, init_attention, init_ffn,
                          init_norm, layer_cache, mask_padded_vocab,
                          write_new_kv)


def init_encdec(cfg: ModelConfig, g: torch.Generator, device) -> dict:
    """The JAX ``init_encdec`` tree (same keys, shapes and init scales);
    values come from ``g``, so parity tests carry JAX's arrays across."""
    d = cfg.d_model
    norm = lambda stacked: init_norm(d, stacked, device, cfg.norm)
    E, D = cfg.enc_layers, cfg.dec_layers
    return {
        "embed": _normal(g, (cfg.padded_vocab, d), device),
        "enc": {"ln1": norm(E), "attn": init_attention(g, cfg, E, device),
                "ln2": norm(E), "ffn": init_ffn(g, cfg, E, device)},
        "dec": {"ln1": norm(D), "self": init_attention(g, cfg, D, device),
                "ln2": norm(D), "cross": init_attention(g, cfg, D, device),
                "ln3": norm(D), "ffn": init_ffn(g, cfg, D, device)},
        "enc_norm": norm(None),
        "final_norm": norm(None),
        "lm_head": _normal(g, (d, cfg.padded_vocab), device),
    }


def _chunk(cfg: ModelConfig, S: int) -> int:
    return cfg.attn_chunk if S > cfg.attn_chunk_threshold else 0


def _enc_block(x, p, cfg: ModelConfig, spec: QuantSpec):
    a, _ = attention_block(
        _norm(x, p["ln1"], cfg.norm), p["attn"], n_heads=cfg.num_heads,
        n_kv=cfg.num_kv_heads, hd=cfg.hd, spec=spec, causal=False,
        rope=cfg.rope, rope_theta=cfg.rope_theta, chunk=_chunk(cfg, x.shape[1]))
    x = x + a
    return x + ffn_apply(_norm(x, p["ln2"], cfg.norm), p["ffn"], cfg, spec)


def _dec_block(x, enc_out, p, cfg: ModelConfig, spec: QuantSpec, cache=None,
               want_taps: bool = False):
    """Self-attention (causal, over ``cache`` when given), cross-attention
    onto ``enc_out``, FFN. Returns (x, new_kv, taps)."""
    a, new_kv, taps = attention_block(
        _norm(x, p["ln1"], cfg.norm), p["self"], n_heads=cfg.num_heads,
        n_kv=cfg.num_kv_heads, hd=cfg.hd, spec=spec, causal=True,
        rope=cfg.rope, rope_theta=cfg.rope_theta, cache=cache,
        chunk=_chunk(cfg, x.shape[1]), want_taps=True)
    x = x + a
    c, _ = attention_block(
        _norm(x, p["ln2"], cfg.norm), p["cross"], n_heads=cfg.num_heads,
        n_kv=cfg.num_kv_heads, hd=cfg.hd, spec=spec, causal=False, rope=False,
        kv_input=enc_out)
    x = x + c
    x = x + ffn_apply(_norm(x, p["ln3"], cfg.norm), p["ffn"], cfg, spec)
    return x, new_kv, (taps if want_taps else None)


def encode(params, cfg: ModelConfig, segments, src_embeds) -> torch.Tensor:
    """The encoder over ``src_embeds`` (B, S_src, d) at the first segment's
    spec, normed: the ``enc_out`` a decode step attends."""
    enc_spec = segments[0][2]
    dev = params["embed"].device
    h = torch.as_tensor(src_embeds, device=dev).to(cfg.torch_dtype)
    enc = params["enc"]
    n = enc["ln1"]["scale"].shape[0]
    for i in range(n):      # JAX checkpoints the encoder's body
        h = remat(cfg.remat, lambda h, i=i: _enc_block(
            h, tree_map(lambda a: a[i], enc), cfg, enc_spec), h)
    return _norm(h, params["enc_norm"], cfg.norm)


def encdec_forward(params, cfg: ModelConfig, segments, *, tokens,
                   src_embeds=None, enc_out=None, caches: Optional[dict] = None,
                   want_taps: bool = False, want_aux: bool = False):
    """Train / prefill: ``src_embeds`` + ``tokens``. Decode: ``tokens`` (B,
    1) + ``caches`` + ``enc_out``. Returns ``(logits, new_caches)``, then
    the last decoder layer's self-attention taps with ``want_taps`` and a
    0 load-balance loss with ``want_aux``. The caches are written in place;
    ``new_caches`` holds the same buffers and ``len + S``."""
    dev = params["embed"].device
    if enc_out is None:
        if src_embeds is None:
            raise ValueError("encdec_forward needs src_embeds (the encoder's "
                             "input) or enc_out (its output)")
        enc_out = encode(params, cfg, segments, src_embeds)
    else:
        enc_out = torch.as_tensor(enc_out, device=dev)
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    x = F.embedding(tokens, params["embed"]).to(cfg.torch_dtype)
    dec = params["dec"]
    presliced = isinstance(dec, (list, tuple))
    last = segments[-1][1] - 1
    taps = None
    for si, (start, end, spec) in enumerate(segments):
        seg = dec[si] if presliced else slice_stack(dec, start, end)
        for i in range(end - start):
            lp = tree_map(lambda a: a[i], seg)
            cache_l = None if caches is None else layer_cache(caches, start + i)
            tap = want_taps and start + i == last
            if tap or caches is not None:
                x, new_kv, t = _dec_block(x, enc_out, lp, cfg, spec,
                                          cache=cache_l, want_taps=tap)
            else:   # JAX checkpoints every decoder layer but the tapped one
                x, new_kv, t = remat(cfg.remat, lambda h, e, lp=lp, spec=spec:
                                     _dec_block(h, e, lp, cfg, spec), x, enc_out)
            if tap:
                taps = t
            if caches is not None:
                write_new_kv(caches, start + i, new_kv)
    new_caches = None
    if caches is not None:
        new_caches = {**caches, "len": caches["len"] + x.shape[1]}
    x = _norm(x, params["final_norm"], cfg.norm)
    logits = mask_padded_vocab(x @ params["lm_head"].to(x.dtype), cfg)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return ((logits, new_caches) + ((taps,) if want_taps else ())
            + ((aux,) if want_aux else ()))


def encdec_caches(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype, device) -> dict:
    """The fp decode cache over the decoder layers, a 0-d cursor."""
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    shape = (cfg.dec_layers, batch, max_len, cfg.num_kv_heads, cfg.hd)
    return {"k": z(shape, dtype), "v": z(shape, dtype), "len": z((), torch.int32)}
