"""One-token decode attention over a quantized (int8 / packed int4) KV cache,
dense or paged.

``decode_attention_cuda`` replaces
``src/repro/kernels/decode_attention.py::decode_attention_pallas`` (its
``pl.pallas_call`` at decode_attention.py:102); ``decode_attention_paged_cuda``
replaces ``decode_attention_paged`` (decode_attention.py:143, which reaches
that ``pallas_call`` through a gather of the pool's blocks). CUDA source:
``csrc/decode_attention.cu``. Bound on H100 by bytes: a decode step reads
each slot's codes and scales once, a quarter (int8) or an eighth (int4) of
an f32 cache. The kernel splits each slot's cache into chunks of
:data:`SPLIT_ROWS` rows counted from position 0 (flash-decoding): one block
per (chunk, KV head, slot) copies the chunk's raw codes into shared memory
and dequantizes them at use, so neither the dequantized cache nor the
(B, S) score matrix exists in device memory; each block leaves its
unnormalised (acc, m, l) in a workspace, and a second kernel of the same
launch merges the chunks in order with the current token's fp K/V last (it
attends itself at full precision). The paged kernel looks each row up
through the slot's block table inside the kernel, so no dense copy of the
pool is gathered.
"""
from __future__ import annotations

import torch

from . import build
from .kv_pack import dequantize_kv

NEG_INF = -2.0e38

#: q / k_new / v_new / output dtypes, by the flag the C entry takes
IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's limits (one block holds a chunk's scores for G query heads)
MAX_HEAD_DIM = 128
MAX_GROUP = 8
#: cache rows per split (``kSplit`` in ``csrc/decode_attention.cu``; the C
#: entries refuse a workspace sized for another value)
SPLIT_ROWS = 256


def split_plan(B: int, H: int, dh: int, S: int) -> tuple[int, tuple]:
    """The split kernels' sizing from shapes alone: ``(n_split, workspace
    shape)`` for ``B`` slots, ``H`` query heads of ``dh`` over a cache of
    extent ``S`` (paged: ``nb * block``). Split ``i`` covers rows
    ``[i * SPLIT_ROWS, (i + 1) * SPLIT_ROWS)`` whatever ``S`` is, so two
    extents share their common splits; the workspace holds per (slot, head,
    split) the unnormalised sum of ``dh`` and its ``m`` and ``l``. Never
    reads the lengths: a call stays free of host syncs and capturable."""
    n_split = -(-S // SPLIT_ROWS)
    return n_split, (B, H, n_split, dh + 2)


def _scale(dh: int) -> float:
    """1/sqrt(dh) as the reference forms it: in double, then f32."""
    return 1.0 / float(dh) ** 0.5


def decode_attention_plain(q: torch.Tensor, k_q: torch.Tensor,
                           v_q: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Plain version: dequantize the cache to f32, one softmax over
    [cache masked to ``lengths`` ; new token], cast to ``q.dtype``.
    Shapes as :func:`decode_attention_cuda`."""
    build.note_plain(q, "decode_attention")
    return _attend(q, k_q, v_q, k_scale, v_scale, k_new, v_new, lengths)


def _attend(q, k_q, v_q, k_scale, v_scale, k_new, v_new, lengths):
    B, H, dh = q.shape
    S, Hkv = k_q.shape[1], k_q.shape[2]
    g = H // Hkv
    qf = q.to(torch.float32) * torch.full((), _scale(dh), dtype=torch.float32,
                                          device=q.device)
    qg = qf.reshape(B, Hkv, g, dh)
    k = dequantize_kv(k_q, k_scale)                    # (B, S, Hkv, dh) f32
    v = dequantize_kv(v_q, v_scale)
    s1 = torch.einsum("bhgd,bshd->bhgs", qg, k)
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] < lengths.to(torch.int64).reshape(B, 1)
    s1 = torch.where(valid[:, None, None, :], s1, NEG_INF)
    kn = k_new.to(torch.float32)
    vn = v_new.to(torch.float32)
    s2 = torch.einsum("bhgd,bhd->bhg", qg, kn)[..., None]
    p = torch.softmax(torch.cat([s1, s2], dim=-1), dim=-1)
    out = (torch.einsum("bhgs,bshd->bhgd", p[..., :S], v)
           + p[..., S:] * vn[:, :, None, :])
    return out.reshape(B, H, dh).to(q.dtype)


def decode_attention_cuda(q: torch.Tensor, k_q: torch.Tensor,
                          v_q: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, dh) f32 or bf16; k_q/v_q: (B, S, Hkv, dhp) int8 (dhp = dh)
    or uint8 nibbles (dhp = dh/2); k_scale/v_scale: (B, S, Hkv) f32;
    k_new/v_new: (B, Hkv, dh) in q's dtype; lengths: (B,) int32. Returns
    (B, H, dh) in q's dtype."""
    dev = q.device
    if q.dim() != 3 or k_q.dim() != 4:
        raise ValueError(f"q must be (B, H, dh) and k_q (B, S, Hkv, dhp), got "
                         f"{tuple(q.shape)} and {tuple(k_q.shape)}")
    B, H, dh = q.shape
    S, Hkv, dhp = k_q.shape[1], k_q.shape[2], k_q.shape[3]
    bits = _check_codes(q, k_q)
    build.check(q, "q", q.dtype, (B, H, dh), dev)
    build.check(k_q, "k_q", k_q.dtype, (B, S, Hkv, dhp), dev)
    build.check(v_q, "v_q", k_q.dtype, (B, S, Hkv, dhp), dev)
    build.check(k_scale, "k_scale", torch.float32, (B, S, Hkv), dev)
    build.check(v_scale, "v_scale", torch.float32, (B, S, Hkv), dev)
    build.check(k_new, "k_new", q.dtype, (B, Hkv, dh), dev)
    build.check(v_new, "v_new", q.dtype, (B, Hkv, dh), dev)
    build.check(lengths, "lengths", torch.int32, (B,), dev)
    out = torch.empty((B, H, dh), dtype=q.dtype, device=dev)
    if out.numel():
        n_split, ws_shape = split_plan(B, H, dh, S)
        ws = torch.empty(ws_shape, dtype=torch.float32, device=dev)
        build.launch("decode_attention", dev, q.data_ptr(), k_q.data_ptr(),
                     v_q.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                     k_new.data_ptr(), v_new.data_ptr(), lengths.data_ptr(),
                     out.data_ptr(), ws.data_ptr(), B, S, H, Hkv, dh,
                     n_split, bits, IN_DTYPES[q.dtype], _scale(dh))
    return out


def _check_codes(q: torch.Tensor, k_q: torch.Tensor) -> int:
    """The kernels' limits on q and the codes; returns kv_bits."""
    B, H, dh = q.shape
    Hkv, dhp = k_q.shape[-2], k_q.shape[-1]
    if q.dtype not in IN_DTYPES:
        raise TypeError(f"q: expected one of {list(IN_DTYPES)}, got {q.dtype}")
    if k_q.dtype == torch.int8:
        bits, want_dhp = 8, dh
    elif k_q.dtype == torch.uint8:
        bits, want_dhp = 4, dh // 2
    else:
        raise TypeError(f"k_q: expected int8 or uint8 codes, got {k_q.dtype}")
    if dhp != want_dhp or (bits == 4 and dh % 2):
        raise ValueError(f"k_q: head_dim extent {dhp} does not fit dh={dh} "
                         f"at {bits} bits")
    if H % Hkv or H // Hkv > MAX_GROUP or dh > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention kernel takes H % Hkv == 0, "
                         f"H/Hkv <= {MAX_GROUP}, dh <= {MAX_HEAD_DIM}; got "
                         f"H={H}, Hkv={Hkv}, dh={dh}")
    return bits


# ------------------------------------------------------- paged indirection
def gather_kv_blocks(buf: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Block-pool buffer (NB, block, ...) + per-slot tables (B, nb) ->
    dense-layout view (B, nb * block, ...). Entries out of [0, NB) clamp to
    it (``jnp.take(mode="clip")``): the pool pads tables with a sentinel,
    and clamped positions lie at or past each slot's length, where the
    attention masks them to exact zeros."""
    idx = tables.to(torch.int64).clamp(0, buf.shape[0] - 1)
    g = buf.index_select(0, idx.reshape(-1))
    return g.reshape(tables.shape[0], tables.shape[1] * buf.shape[1],
                     *buf.shape[2:])


def decode_attention_paged_plain(q: torch.Tensor, k_q: torch.Tensor,
                                 v_q: torch.Tensor, k_scale: torch.Tensor,
                                 v_scale: torch.Tensor, tables: torch.Tensor,
                                 k_new: torch.Tensor, v_new: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of the paged kernel: gather the slots' blocks through
    the tables (clamped), then the dense plain version. Shapes as
    :func:`decode_attention_paged_cuda`."""
    build.note_plain(q, "decode_attention_paged")
    return _attend(q, *(gather_kv_blocks(b, tables)
                        for b in (k_q, v_q, k_scale, v_scale)),
                   k_new, v_new, lengths)


def decode_attention_paged_cuda(q: torch.Tensor, k_q: torch.Tensor,
                                v_q: torch.Tensor, k_scale: torch.Tensor,
                                v_scale: torch.Tensor, tables: torch.Tensor,
                                k_new: torch.Tensor, v_new: torch.Tensor,
                                lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, dh) f32 or bf16; k_q/v_q: (NB, block, Hkv, dhp) codes of one
    layer of the pool; k_scale/v_scale: (NB, block, Hkv) f32; tables: (B,
    nb) int32 block ids; k_new/v_new: (B, Hkv, dh) in q's dtype; lengths:
    (B,) int32. The dense extent is nb * block. Returns (B, H, dh) in q's
    dtype, bit-equal to :func:`decode_attention_cuda` on
    ``gather_kv_blocks`` of the same tables."""
    dev = q.device
    if q.dim() != 3 or k_q.dim() != 4 or tables.dim() != 2:
        raise ValueError(f"q must be (B, H, dh), k_q (NB, block, Hkv, dhp) and "
                         f"tables (B, nb), got {tuple(q.shape)}, "
                         f"{tuple(k_q.shape)} and {tuple(tables.shape)}")
    B, H, dh = q.shape
    NB, blk, Hkv, dhp = k_q.shape
    nb = tables.shape[1]
    bits = _check_codes(q, k_q)
    build.check(q, "q", q.dtype, (B, H, dh), dev)
    build.check(k_q, "k_q", k_q.dtype, (NB, blk, Hkv, dhp), dev)
    build.check(v_q, "v_q", k_q.dtype, (NB, blk, Hkv, dhp), dev)
    build.check(k_scale, "k_scale", torch.float32, (NB, blk, Hkv), dev)
    build.check(v_scale, "v_scale", torch.float32, (NB, blk, Hkv), dev)
    build.check(tables, "tables", torch.int32, (B, nb), dev)
    build.check(k_new, "k_new", q.dtype, (B, Hkv, dh), dev)
    build.check(v_new, "v_new", q.dtype, (B, Hkv, dh), dev)
    build.check(lengths, "lengths", torch.int32, (B,), dev)
    if NB < 1 or nb < 1:
        raise ValueError(f"decode_attention_paged needs a pool of at least one "
                         f"block and tables of at least one entry, got "
                         f"NB={NB}, nb={nb}")
    out = torch.empty((B, H, dh), dtype=q.dtype, device=dev)
    if out.numel():
        n_split, ws_shape = split_plan(B, H, dh, nb * blk)
        ws = torch.empty(ws_shape, dtype=torch.float32, device=dev)
        build.launch("decode_attention_paged", dev, q.data_ptr(),
                     k_q.data_ptr(), v_q.data_ptr(), k_scale.data_ptr(),
                     v_scale.data_ptr(), tables.data_ptr(), k_new.data_ptr(),
                     v_new.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                     ws.data_ptr(), B, nb, blk, NB, H, Hkv, dh, n_split, bits,
                     IN_DTYPES[q.dtype], _scale(dh))
    return out


def bound_bytes(B: int, S: int, Hkv: int, H: int, dh: int, bits: int,
                lengths, elem_bytes: int) -> int:
    """Bytes one call must move: each slot's min(len, S) code rows and
    scales of K and V, q and the new K/V, the lengths, and the output."""
    dhp = dh if bits == 8 else dh // 2
    rows = sum(min(max(int(n), 0), S) for n in lengths)
    cache = 2 * rows * Hkv * (dhp + 4)
    return (cache + B * H * dh * elem_bytes * 2 + 2 * B * Hkv * dh * elem_bytes
            + 4 * B)


def bound_bytes_paged(B: int, nb: int, block: int, Hkv: int, H: int, dh: int,
                      bits: int, lengths, elem_bytes: int) -> int:
    """Bytes one paged call must move: the dense call's over the extent
    nb * block, plus the (B, nb) int32 tables."""
    return (bound_bytes(B, nb * block, Hkv, H, dh, bits, lengths, elem_bytes)
            + 4 * B * nb)


__all__ = ["NEG_INF", "SPLIT_ROWS", "split_plan", "decode_attention_plain",
           "decode_attention_cuda",
           "gather_kv_blocks", "decode_attention_paged_plain",
           "decode_attention_paged_cuda", "bound_bytes", "bound_bytes_paged",
           "MAX_HEAD_DIM", "MAX_GROUP"]
