"""GQA multi-head attention: cacheless (encoder, prefill), chunked (long
cacheless forwards), KV-cache decode and the cross-attention of an
encoder-decoder (``kv_input``).

All projections route through ``qlinear`` (quantizable per the MKQ policy);
the scores and the softmax stay in fp32 (paper §5). The cacheless and the
fp-cache branches are plain PyTorch, as the JAX package computes them
outside any Pallas kernel. A cacheless forward longer than the config's
``attn_chunk_threshold`` whose length the chunk divides takes
``chunked_attention``, the flash pattern that never holds the (S, S) score
tensor: under a kernel plan it runs the hand-written flash-attention kernel
(``ops.flash_attention``), otherwise the kernel's plain version at
chunk-sized blocks. One-token decode steps over a quantized cache under a
kernel plan go through ``ops.decode_attention`` (the hand-written
decode-attention kernel), or ``ops.decode_attention_paged`` over a paged
block pool; every other quantized-cache step dequantizes and attends in
PyTorch, and every other paged step first gathers the slots' blocks
through their tables (``gather_kv_blocks``), as the JAX engine does.

Under tensor parallelism (``spec.tp > 1``, the plain path only) a rank
holds ``num_heads / tp`` query and ``num_kv_heads / tp`` KV heads.
``rank_attention`` widens its heads to the model's full head count with
zeros before each plain attention and narrows the result: every
contraction then runs at tp=1's shapes, so its per-head bits cannot depend
on how many heads a rank holds (a batched contraction over heads may split
its sums differently at another head count). tp=1 runs exactly as it did.

A sharded training step (``spec.groups``, ``model > 1``) attends over its
model rank's heads as they are (its bits are held to a tolerance, not to
tp=1's), and with ``seq_shard`` (``cfg.attn_seq_shard``) its chunk branch
is context-parallel, as JAX's ``chunked_attention`` with
``seq_shard_axes``: every model rank takes a stripe of ``chunk / model``
rows of each ``chunk``-row query block, with all heads, against all keys
and values (``seq_shard_attention``); the outputs go back head-sharded to
``wo``. The MINI taps are gathered over the heads first, since their
relation heads cut across the ranks' shards.
"""
from __future__ import annotations

from typing import Optional

import torch

from .layers import QuantSpec, apply_rope, qlinear, rope_tables

NEG_INF = -2.0e38


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, n, -1)


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def full_attention(q, k, v, *, causal: bool,
                   kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,Sq,H,dh), k/v: (B,Skv,H,dh) -> (B,Sq,H,dh). fp32 softmax.

    ``kv_len`` broadcasts against (B, H, Sq, Skv): keys at or past it are
    set to ``NEG_INF`` before the softmax."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    # a tensor divisor (made by a fill, no host copy): PyTorch turns a
    # Python-float divisor on the card into a multiply by its reciprocal
    scores = scores / torch.sqrt(torch.full((), float(dh), dtype=torch.float32,
                                            device=scores.device))
    Sq, Skv = q.shape[1], k.shape[1]
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(Skv, device=q.device)[None, :]
        scores = torch.where((ki <= qi)[None, None], scores, NEG_INF)
    if kv_len is not None:  # mask key positions beyond each row's length
        valid = torch.arange(Skv, device=q.device)[None, None, None, :] < kv_len
        scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def chunked_attention(q, k, v, *, causal: bool, chunk: int,
                      use_kernel: bool) -> torch.Tensor:
    """Flash-style attention, the counterpart of the JAX package's
    ``chunked_attention``: q (B, S, H, dh), k/v (B, S, Hkv, dh) unrepeated,
    S a multiple of ``chunk``. ``use_kernel`` (a kernel plan) runs
    ``ops.flash_attention``; otherwise the kernel's plain version walks
    ``chunk``-sized query and key blocks with an online softmax."""
    if use_kernel:
        from ..kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal)
    from ..kernels.flash_attention import flash_attention_plain
    return flash_attention_plain(q, k, v, causal=causal, bq=chunk, bk=chunk)


def _stripe_attention(q, k, v, *, causal: bool, chunk: int, row0: int):
    """q (B, nb, r, H, dh): rows ``row0 .. row0 + r`` of each of the ``nb``
    ``chunk``-row query blocks; k/v (B, S, Hkv, dh), every row. Each
    block's rows attend the keys up to its end (all keys if not causal) in
    one f32 softmax under the finite ``NEG_INF`` mask: the same function as
    the plain flash version's online softmax over key blocks -> (B, nb, r,
    H, dh) in q's dtype."""
    B, nb, r, H, dh = q.shape
    groups = H // k.shape[2]
    kf = _repeat_kv(k, groups).to(torch.float32)
    vf = _repeat_kv(v, groups).to(torch.float32)
    scale = torch.sqrt(torch.full((), float(dh), dtype=torch.float32,
                                  device=q.device))
    outs = []
    for b in range(nb):
        end = (b + 1) * chunk if causal else k.shape[1]
        qb = q[:, b].to(torch.float32)
        s = torch.einsum("bqhd,bkhd->bhqk", qb, kf[:, :end]) / scale
        if causal:
            qi = b * chunk + row0 + torch.arange(r, device=q.device)[:, None]
            ki = torch.arange(end, device=q.device)[None, :]
            s = torch.where((ki <= qi)[None, None], s, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", pr, vf[:, :end]))
    return torch.stack(outs, dim=1).to(q.dtype)


def seq_shard_attention(q, k, v, *, causal: bool, chunk: int, groups):
    """Context-parallel chunked attention over ``groups``' model ranks
    (JAX's ``chunked_attention`` with ``seq_shard_axes``). q (B, S, h, dh)
    and k/v (B, S, hkv, dh) hold this rank's heads, every row; S a
    multiple of ``chunk``, ``chunk`` of the ranks. The rank's stripe of
    every query block, all heads (an all-to-all), attends every key and
    value (gathered over the heads, their gradients summed); the output
    returns head-sharded (the all-to-all back): (B, S, h, dh)."""
    from ..distributed.collectives import all_to_all_model, gather_from_model
    B, S, h, dh = q.shape
    n = groups.model
    if chunk % n:
        raise ValueError(f"attn_seq_shard: chunk {chunk} does not split into "
                         f"model={n} stripes")
    r, nb = chunk // n, S // chunk
    qs = all_to_all_model(q.reshape(B, nb, n, r, h, dh), 2, 4, groups)
    kk = gather_from_model(k, 2, groups, sum_grad=True)
    vv = gather_from_model(v, 2, groups, sum_grad=True)
    out = _stripe_attention(qs.reshape(B, nb, r, n * h, dh), kk, vv,
                            causal=causal, chunk=chunk, row0=groups.mp_rank * r)
    out = all_to_all_model(out.reshape(B, nb, 1, r, n * h, dh), 4, 2, groups)
    return out.reshape(B, S, h, dh)


def cached_decode_attention(q, k_cache, v_cache, k_new, v_new, length):
    """Decode attention: q (B,Sq,H,dh) over cache (B,Smax,H,dh) masked to
    ``length`` plus the Sq new tokens (causal among themselves), fp32
    softmax. ``length`` is a 0-d tensor (one cursor) or (B,) per-slot
    lengths: each serving slot masks its own prefix of the cache."""
    B, Sq, H, dh = q.shape
    Smax = k_cache.shape[1]
    scale = 1.0 / torch.sqrt(torch.full((), float(dh), dtype=torch.float32,
                                        device=q.device))
    s1 = torch.einsum("bqhd,bkhd->bhqk", q, k_cache).to(torch.float32) * scale
    lb = length.reshape(-1, 1, 1, 1) if length.dim() else length
    valid = torch.arange(Smax, device=q.device)[None, None, None, :] < lb
    s1 = torch.where(valid, s1, NEG_INF)
    s2 = torch.einsum("bqhd,bkhd->bhqk", q, k_new).to(torch.float32) * scale
    if Sq > 1:
        qi = torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(Sq, device=q.device)[None, :]
        s2 = torch.where((ki <= qi)[None, None], s2, NEG_INF)
    s = torch.softmax(torch.cat([s1, s2], dim=-1), dim=-1)
    p1, p2 = s[..., :Smax].to(q.dtype), s[..., Smax:].to(q.dtype)
    return (torch.einsum("bhqk,bkhd->bqhd", p1, v_cache)
            + torch.einsum("bhqk,bkhd->bqhd", p2, v_new))


def _widen(x: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """A rank's heads (axis 2 of a (B, S, h, dh) tensor) at their place
    among all ``tp * h`` heads, zeros elsewhere: tp=1's shape and strides."""
    B, S, h, dh = x.shape
    out = x.new_zeros((B, S, h * tp, dh))
    out[:, :, rank * h:(rank + 1) * h] = x
    return out


def rank_attention(attn, rank: int, tp: int, q, *args, **kwargs):
    """``attn`` (a plain attention of this module) over rank ``rank``'s
    heads of ``tp``: every positional (B, S, heads, dh) operand widened to
    the model's full head count (``_widen``), the (B, Sq, H, dh) result
    narrowed back to the rank's query heads. At tp=1 it is ``attn``."""
    if tp == 1:
        return attn(q, *args, **kwargs)
    wide = [_widen(a, rank, tp) if isinstance(a, torch.Tensor) and a.dim() == 4
            else a for a in (q, *args)]
    h = q.shape[2]
    return attn(*wide, **kwargs)[:, :, rank * h:(rank + 1) * h]


def attention_block(x: torch.Tensor, p: dict, *, n_heads: int, n_kv: int,
                    hd: int, spec: QuantSpec, causal: bool = True,
                    rope: bool = False, rope_theta: float = 10000.0,
                    cache: Optional[dict] = None,
                    kv_input: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None, chunk: int = 0,
                    want_taps: bool = False, seq_shard: bool = False):
    """One attention sublayer (the residual is the caller's). ``p`` holds
    wq / wk / wv / wo, or the fused ``wqkv`` and wo (``fused_proj``, which
    the JAX package gives only the transformer blocks: never a
    cross-attention). Returns
    ``(out, new_kv)``, or ``(out, new_kv, taps)`` with ``want_taps``: the
    projected q, k and v before RoPE, each (B, S, heads * hd), which MINI
    distillation reads.

    cache: one layer's decode cache, fp ``{'k', 'v', 'len'}`` or quantized
        ``{'k_q', 'v_q', 'k_scale', 'v_scale', 'len'}``; ``len`` is a 0-d
        cursor or (B,) per-slot lengths. A paged cache also holds
        ``tables`` (B, nb), and its buffers are one layer of the block pool,
        (NB, block, ...). With a cache the new tokens sit at positions
        ``len ...`` and attend the cache masked to ``len`` plus themselves;
        ``new_kv`` is their (k, v), which the caller writes (quantizing on
        append), so a token attends itself at full precision.
    kv_input: the cross-attention source (B, S_src, d) of an
        encoder-decoder: keys and values come from it, with no RoPE, no
        causal mask and never the chunk branch (the JAX package's rules).
    kv_len: (B,) per-row valid lengths for the cacheless path: keys at or
        past a row's length are masked before the softmax, which keeps
        bucket-padded bidirectional (encoder) rows independent of their
        zero tail.
    chunk: the block of ``chunked_attention`` (0: off). The cacheless path
        takes it, as the JAX package does, when ``Sq > chunk``, ``Sq %
        chunk == 0`` and no ``kv_len`` is given.
    seq_shard: in a sharded training step, the chunk branch runs
        context-parallel (``seq_shard_attention``).
    """
    B, Sq, _ = x.shape
    src = x if kv_input is None else kv_input
    if "wqkv" in p:
        # fused (``fused_proj``): one matmul, split at [H hd, (H + Hkv) hd]
        # as the JAX package splits it; each part contiguous, as the
        # unfused products are, so every later op sees the same layout
        q, k, v = (t.contiguous() for t in torch.split(
            qlinear(x, p["wqkv"], spec), [n_heads * hd, n_kv * hd, n_kv * hd], -1))
        q, k, v = _split_heads(q, n_heads), _split_heads(k, n_kv), _split_heads(v, n_kv)
    else:
        q = _split_heads(qlinear(x, p["wq"], spec), n_heads)
        k = _split_heads(qlinear(src, p["wk"], spec), n_kv)
        v = _split_heads(qlinear(src, p["wv"], spec), n_kv)
    mp = spec.model_groups
    taps = None
    if want_taps:
        taps = {"q": q.reshape(B, Sq, -1), "k": k.reshape(B, k.shape[1], -1),
                "v": v.reshape(B, v.shape[1], -1)}
        if mp is not None:
            from ..distributed.collectives import gather_from_model
            taps = {key: gather_from_model(t, 2, mp) for key, t in taps.items()}
    if rope and kv_input is None:
        positions = torch.arange(Sq, device=x.device)[None, :]
        if cache is not None:
            off = cache["len"]
            positions = positions + (off[:, None] if off.dim() else off)
        cos, sin = rope_tables(positions, hd, rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    groups = n_heads // n_kv
    new_kv = None
    tp, rank = spec.tp, 0
    if mp is not None:          # training: the rank's heads, as they are
        tp = 1
    elif tp > 1:
        import torch.distributed as dist
        rank = dist.get_rank()
    attend = lambda fn, *a, **kw: rank_attention(fn, rank, tp, *a, **kw)
    paged = cache is not None and "tables" in cache
    if paged and not ("k_q" in cache and spec.use_kernels and Sq == 1):
        # no kernel for this step: gather the dense layout the tables
        # describe and attend as the dense cache would
        from ..kernels.decode_attention import gather_kv_blocks
        cache = {key: (gather_kv_blocks(val, cache["tables"])
                       if key in ("k", "v", "k_q", "v_q", "k_scale",
                                  "v_scale") else val)
                 for key, val in cache.items()}
        paged = False
    if cache is not None and "k_q" in cache:
        if spec.use_kernels and Sq == 1:
            from ..kernels import ops as kops
            if paged:
                out = kops.decode_attention_paged(
                    q[:, 0], cache["k_q"], cache["v_q"], cache["k_scale"],
                    cache["v_scale"], cache["tables"], k[:, 0], v[:, 0],
                    cache["len"])[:, None]
            else:
                out = kops.decode_attention(
                    q[:, 0], cache["k_q"], cache["v_q"], cache["k_scale"],
                    cache["v_scale"], k[:, 0], v[:, 0], cache["len"])[:, None]
        else:
            from ..kernels.kv_pack import dequantize_kv
            kk_c = _repeat_kv(dequantize_kv(cache["k_q"], cache["k_scale"],
                                            q.dtype), groups)
            vv_c = _repeat_kv(dequantize_kv(cache["v_q"], cache["v_scale"],
                                            q.dtype), groups)
            out = attend(cached_decode_attention, q, kk_c, vv_c,
                         _repeat_kv(k, groups), _repeat_kv(v, groups), cache["len"])
        new_kv = (k, v)
    elif cache is not None:
        out = attend(cached_decode_attention,
                     q, _repeat_kv(cache["k"].to(q.dtype), groups),
                     _repeat_kv(cache["v"].to(q.dtype), groups),
                     _repeat_kv(k, groups), _repeat_kv(v, groups), cache["len"])
        new_kv = (k, v)
    elif (chunk and Sq > chunk and Sq % chunk == 0 and kv_len is None
          and kv_input is None):
        if seq_shard and mp is not None:
            out = seq_shard_attention(q, k, v, causal=causal, chunk=chunk,
                                      groups=mp)
        else:
            out = attend(chunked_attention, q, k, v, causal=causal, chunk=chunk,
                         use_kernel=spec.use_kernels)
    else:
        out = attend(full_attention, q, _repeat_kv(k, groups), _repeat_kv(v, groups),
                     causal=causal and kv_input is None,
                     kv_len=(None if kv_len is None else kv_len.reshape(-1, 1, 1, 1)))
    out = qlinear(out.reshape(B, Sq, n_heads * hd), p["wo"], spec,
                  row_parallel=True)
    return (out, new_kv, taps) if want_taps else (out, new_kv)
