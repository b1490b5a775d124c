"""Paged KV block pool: ONE block-table memory subsystem for serving slots,
shared prefixes and copy-on-write sampling forks (DESIGN.md §15).

``SlotKVCache`` allocates dense ``slots × max_len`` buffers, so every request
pays worst-case memory whether it uses it or not. This module replaces
dense preallocation with a vLLM-style paged layout:

* **BlockPool** — the physical store: per-buffer-key device tensors shaped
  ``(L, num_blocks + 1, block, ...)`` in the plan's KV precision
  (``kv_pack`` layouts, ``PREFIX_BLOCK``-token blocks), plus host-side free
  list, per-block refcounts, per-request block tables and a digest-keyed
  prefix registry. ONE byte budget sizes the pool and drives both admission
  (a request admits only if its worst-case block need fits) and eviction
  (LRU over refcount-0 registry blocks). The registry absorbs
  ``prefix_cache.py``'s role: a prefix hit attaches resident blocks by
  REFERENCE (refcount++) instead of copying rows into a slot. Block
  ``num_blocks`` is a trash block: never allocated, never counted, it is
  where the table sentinel points and where idle slots' decode writes land.
* **PagedKVCache** — the engine-facing slot view: per-slot block tables and
  host cursors. ``decode_state()`` hands the decode step a paged cache dict
  (the pool buffers, the tables, the lengths and each slot's write target);
  the model attends straight from the pool through the tables
  (``kernels/ops.decode_attention_paged`` on the card) and writes each
  active slot's new row to its own (block, offset) in place. No dense copy
  of the cache is gathered.

Bit-identity with the dense layout is by construction: the rows a slot's
table reaches below its length hold the values the dense slot buffer would
hold (the same quantize calls on the same rows), and every position at or
past the length — including rows surfaced by clamped out-of-range table
entries — is masked to exact zeros before the softmax, in the kernel and
in the reference path alike.

Copy-on-write fork (``SamplingParams.n > 1``): samples of one prompt share
the full prompt blocks by reference; each sample owns its partial tail
block and decode blocks privately, so divergent generations never write
into shared memory. Shared blocks are only ever written once (at prefill,
before sharing), which is what makes attach-by-reference safe.

Host bookkeeping is authoritative: the lengths live on the host and are
uploaded each step; the device ``len`` of a step is never read back. The
buffers are updated in place (where the JAX package donates them).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.kv_pack import (kv_buffer_keys, kv_code_dtype, kv_code_shape,
                               kv_row_bytes, quantize_kv)
from .prefix_cache import HASH_SEED, PREFIX_BLOCK, rolling_hash

__all__ = ["BlockPool", "PagedKVCache", "blocks_needed"]


def blocks_needed(prompt_len: int, max_new_tokens: int,
                  block: int = PREFIX_BLOCK) -> int:
    """Worst-case block demand of a request: every prompt and generated
    token, rounded up to whole blocks. Admission reserves this much so a
    request can NEVER run out of KV memory mid-decode — the paged analogue
    of the dense layout's up-front ``max_len`` row reservation."""
    return -(-(prompt_len + max_new_tokens) // block)


def _block_shape(rows: torch.Tensor, nb: int, block: int) -> torch.Tensor:
    """(L, nb * block, ...) token rows -> (L, nb, block, ...) blocks."""
    return rows.reshape(rows.shape[0], nb, block, *rows.shape[2:])


class BlockPool:
    """Refcounted block-table allocator over quantized KV device blocks.

    One pool = one byte budget = ``num_blocks`` physical blocks. Every
    block is in exactly one of three states:

    * **free** — on the free list, refcount 0, not in the registry;
    * **held** — refcount >= 1: reachable from one or more live request
      tables (a block in two tables is always in ``shared`` — registry
      residents attached by reference, or fork-shared prompt blocks);
    * **resident** — refcount 0 but registered under a prefix digest:
      evictable, LRU-ordered (deepest chain blocks evict first).

    The buffers live on ``device`` (``None`` means the card; pass
    ``device='cpu'`` for the CPU). All mutation is host-side bookkeeping
    plus in-place writes into the device buffers; the pool is
    single-threaded like the engine. Under a tensor-parallel plan (``tp``
    ranks) each rank's buffers hold ``num_kv_heads / tp`` heads, while
    the budget, the block count and every table are those of the whole
    model, so every rank admits, allocates and evicts as tp=1 does.
    """

    def __init__(self, cfg: ModelConfig, budget_bytes: int, *,
                 dtype: torch.dtype = torch.float32, kv_bits: int = 16,
                 block: int = PREFIX_BLOCK, device=None, tp: int = 1):
        from ..device import resolve_device
        if budget_bytes <= 0:
            raise ValueError(f"budget_bytes must be > 0, got {budget_bytes}")
        self.cfg = cfg
        self.block = int(block)
        self.kv_bits = int(kv_bits)
        self.dtype = dtype
        self.device = resolve_device(device)
        L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads // tp, cfg.hd
        self.block_nbytes = self.block_bytes(cfg, self.kv_bits, dtype,
                                             self.block)
        self.num_blocks = int(budget_bytes) // self.block_nbytes
        if self.num_blocks < 1:
            raise ValueError(
                f"kv budget {budget_bytes} B < one {self.block}-token block "
                f"({self.block_nbytes} B at kv_bits={self.kv_bits})")
        self.budget_bytes = int(budget_bytes)
        self.keys = kv_buffer_keys(self.kv_bits)
        NB = self.num_blocks + 1                     # + the trash block
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=self.device)
        if self.kv_bits in (8, 4):
            dhp = kv_code_shape(hd, self.kv_bits)
            cdt = kv_code_dtype(self.kv_bits)
            self.bufs = {
                "k_q": z((L, NB, self.block, Hkv, dhp), cdt),
                "v_q": z((L, NB, self.block, Hkv, dhp), cdt),
                "k_scale": z((L, NB, self.block, Hkv), torch.float32),
                "v_scale": z((L, NB, self.block, Hkv), torch.float32)}
        else:
            self.bufs = {
                "k": z((L, NB, self.block, Hkv, hd), dtype),
                "v": z((L, NB, self.block, Hkv, hd), dtype)}
        # host structures; allocation order is deterministic (ascending ids)
        self._free: list[int] = list(range(self.num_blocks - 1, -1, -1))
        self.refs = np.zeros(self.num_blocks, np.int64)
        self._tables: dict[int, list[int]] = {}       # rid -> block ids
        self.shared: set[int] = set()                 # multi-ref-legal blocks
        # prefix registry: chained digest -> resident block (LRU order);
        # reverse map + per-digest tokens for the defense-in-depth check
        self._registry: "OrderedDict[bytes, int]" = OrderedDict()
        self._digest_of: dict[int, bytes] = {}
        self._tokens: dict[bytes, np.ndarray] = {}
        # counters (host ints, never grow)
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.evictions = 0
        self.cow_forks = 0
        self.prefix_attached = 0      # blocks attached by reference, total

    @staticmethod
    def block_bytes(cfg: ModelConfig, kv_bits: int, dtype: torch.dtype,
                    block: int = PREFIX_BLOCK) -> int:
        """Bytes of one block: ``block`` token rows of every layer at
        ``kv_bits`` (fp rows in ``dtype`` at 16)."""
        fp_bytes = torch.empty((), dtype=dtype).element_size()
        return block * cfg.num_layers * kv_row_bytes(
            cfg.num_kv_heads, cfg.hd, kv_bits, fp_bytes=fp_bytes)

    @property
    def trash_block(self) -> int:
        """The block past the budget: the tables' sentinel, and the write
        target of idle slots."""
        return self.num_blocks

    # --------------------------------------------------------- allocation
    def available(self) -> int:
        """Blocks an admission decision may count on: free now, or
        evictable (refcount-0 registry residents)."""
        evictable = sum(1 for b in self._registry.values()
                        if self.refs[b] == 0)
        return len(self._free) + evictable

    def _evict_one(self) -> bool:
        """Pop the least-recently-used refcount-0 registry block back onto
        the free list. Pinned blocks (refcount > 0: in-flight requests, or
        the publisher itself) are never evicted."""
        victim = next((d for d, b in self._registry.items()
                       if self.refs[b] == 0), None)
        if victim is None:
            return False
        b = self._registry.pop(victim)
        del self._digest_of[b]
        del self._tokens[victim]
        self.shared.discard(b)
        self._free.append(b)
        self.evictions += 1
        return True

    def alloc(self, rid: int, n: int) -> list[int]:
        """Allocate ``n`` private blocks for request ``rid`` (evicting
        resident prefix blocks as needed). The engine's admission check
        (``blocks_needed`` vs ``available``) makes failure a logic error,
        not a runtime condition."""
        ids = []
        for _ in range(n):
            if not self._free and not self._evict_one():
                raise RuntimeError(
                    f"BlockPool exhausted: {self.num_blocks} blocks, "
                    f"{len(self._tables)} live tables — admission gating "
                    "should have prevented this")
            b = self._free.pop()
            self.refs[b] += 1
            ids.append(b)
        if ids:
            self._tables.setdefault(rid, []).extend(ids)
        return ids

    def attach(self, rid: int, ids) -> None:
        """Attach already-written blocks to ``rid`` BY REFERENCE (prefix
        hits, copy-on-write fork shares): refcount++ per block, appended to
        the request's table in sequence order. Never copies rows."""
        ids = list(ids)
        for b in ids:
            self.refs[b] += 1
        self.shared.update(ids)
        if ids:
            self._tables.setdefault(rid, []).extend(ids)

    def release(self, rid: int) -> None:
        """Drop every reference request ``rid`` holds. Blocks reaching
        refcount 0 return to the free list unless registry-resident (those
        stay evictable under LRU)."""
        for b in self._tables.pop(rid, ()):  # idempotent: second call no-ops
            self.refs[b] -= 1
            if self.refs[b] == 0 and b not in self._digest_of:
                self.shared.discard(b)
                self._free.append(b)

    def table(self, rid: int) -> list[int]:
        return self._tables.get(rid, [])

    # ------------------------------------------------------------- prefix
    def match(self, prompt) -> tuple[int, list[int]]:
        """Longest registry-resident block-aligned prefix of ``prompt``,
        capped at ``len(prompt) - 1`` (the last token must be computed for
        first-output logits — same contract as ``PrefixCache.match``).
        Returns ``(m, block_ids)``; the caller must ``attach`` the ids in
        the same engine round (nothing else runs in between — the pool is
        single-threaded), which is what pins them against eviction."""
        B = self.block
        h = HASH_SEED
        walked: list[bytes] = []
        ids: list[int] = []
        m = 0
        j = 0
        while (j + 1) * B <= len(prompt) - 1:
            blk = np.asarray(prompt[j * B:(j + 1) * B], np.int32)
            h = rolling_hash(h, blk)
            b = self._registry.get(h)
            if b is None or not np.array_equal(self._tokens[h], blk):
                break                      # first miss (or hash collision)
            walked.append(h)
            ids.append(b)
            m = (j + 1) * B
            j += 1
        # LRU touch DEEPEST-FIRST so chain tails evict before their roots:
        # a chain broken in the middle strands its unreachable tail at the
        # cold end of the LRU instead of pinning it behind hot roots.
        for d in reversed(walked):
            self._registry.move_to_end(d)
        if m:
            self.hits += 1
            self.prefix_attached += len(ids)
        else:
            self.misses += 1
        self.tokens_reused += m
        return m, ids

    def gather_rows(self, ids) -> dict:
        """Resident blocks -> contiguous (L, len(ids)*block, ...) device
        rows per buffer key (prefix restore into the prefill scratch)."""
        idx = torch.as_tensor(list(ids), dtype=torch.int64, device=self.device)
        out = {}
        for key in self.keys:
            g = self.bufs[key].index_select(1, idx)      # (L, nb, B, ...)
            out[key] = g.reshape(g.shape[0], g.shape[1] * g.shape[2],
                                 *g.shape[3:])
        return out

    def publish(self, rid: int, prompt, upto: int) -> int:
        """Register request ``rid``'s own full prompt blocks covering
        ``prompt[:upto]`` under their chain digests — the paged analogue of
        ``PrefixCache.insert``, with NO row copy: the request's blocks
        simply become registry residents (shared, evictable once every
        holder releases). Returns blocks newly registered."""
        B = self.block
        table = self._tables.get(rid, [])
        h = HASH_SEED
        walked: list[bytes] = []
        added = 0
        for j in range(upto // B):
            blk = np.asarray(prompt[j * B:(j + 1) * B], np.int32)
            h = rolling_hash(h, blk)
            existing = self._registry.get(h)
            if existing is not None:
                if not np.array_equal(self._tokens[h], blk):
                    break       # digest collision: stop publishing the chain
                walked.append(h)
                continue
            if j >= len(table):
                break
            b = table[j]
            if b in self._digest_of:        # already published under another
                break                       # chain (shared fork blocks)
            self._registry[h] = b
            self._digest_of[b] = h
            self._tokens[h] = blk
            self.shared.add(b)
            walked.append(h)
            added += 1
        for d in reversed(walked):
            self._registry.move_to_end(d)
        return added

    # -------------------------------------------------------------- stats
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def stats(self) -> dict:
        """KV memory gauges (ServeMetrics surfaces these — DESIGN.md §15)."""
        lookups = self.hits + self.misses
        return {
            "blocks_total": self.num_blocks,
            "blocks_free": len(self._free),
            "blocks_in_use": self.blocks_in_use(),
            "kv_bytes_in_use": self.blocks_in_use() * self.block_nbytes,
            "budget_bytes": self.budget_bytes,
            "block_bytes": self.block_nbytes,
            "prefix_blocks": len(self._registry),
            "prefix_attached": self.prefix_attached,
            "cow_forks": self.cow_forks,
            "evictions": self.evictions,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / lookups if lookups else 0.0,
            "tokens_reused": self.tokens_reused,
        }


class PagedKVCache:
    """Engine-facing slot view over a :class:`BlockPool`.

    Keeps per-slot block tables (padded with the pool's ``num_blocks``
    sentinel, the trash block: reads of it are masked, writes to it are
    dropped) and HOST-side cursors (the authoritative per-slot lengths,
    uploaded with every decode step).
    """

    def __init__(self, pool: BlockPool, slots: int, max_len: int):
        if max_len % pool.block:
            raise ValueError(
                f"paged KV needs max_len % {pool.block} == 0, got {max_len}")
        self.pool = pool
        self.slots = slots
        self.max_len = max_len
        self.kv_bits = pool.kv_bits
        self.nb_max = max_len // pool.block
        self._tables = np.full((slots, self.nb_max), pool.num_blocks,
                               np.int32)
        self._nb = np.zeros(slots, np.int32)       # entries used per slot
        self._lengths = np.zeros(slots, np.int32)
        self._rids: list[Optional[int]] = [None] * slots

    # ------------------------------------------------------------- slots
    def open_slot(self, slot: int, rid: int) -> None:
        """Bind ``rid`` to ``slot`` with an empty table (prefill fills it)."""
        self.release_slot(slot)                    # belt and braces
        self._rids[slot] = rid

    def extend_table(self, slot: int, ids) -> None:
        n = len(ids)
        if n:
            at = int(self._nb[slot])
            self._tables[slot, at:at + n] = ids
            self._nb[slot] = at + n

    def set_length(self, slot: int, length: int) -> None:
        self._lengths[slot] = length

    def block_ids(self, slot: int) -> list[int]:
        return [int(b) for b in self._tables[slot, :int(self._nb[slot])]]

    def release_slot(self, slot: int) -> None:
        """Return every block reference the slot's request holds (request
        finished, cancelled, or the slot is being rebound). Idempotent."""
        rid = self._rids[slot]
        if rid is not None:
            self.pool.release(rid)
            self._rids[slot] = None
        self._tables[slot] = self.pool.num_blocks
        self._nb[slot] = 0
        self._lengths[slot] = 0

    # engine-compat alias (cancel() calls kv.reset_slot on both layouts)
    reset_slot = release_slot

    def lengths(self) -> np.ndarray:
        return self._lengths.copy()

    # ------------------------------------------------------------ decode
    def write_targets(self, active) -> tuple[np.ndarray, np.ndarray]:
        """Where this step's new row of each slot goes: an active slot's row
        lands at its cursor, block ``table[len // block]`` offset ``len %
        block``; every other slot writes into the trash block, which no
        live table reaches (a clamped sentinel of a live block could be
        another slot's row)."""
        B = self.pool.block
        wb = np.full(self.slots, self.pool.trash_block, np.int64)
        wo = np.zeros(self.slots, np.int64)
        for s in active:
            ln = int(self._lengths[s])
            wb[s] = self._tables[s, ln // B]
            wo[s] = ln % B
        return wb, wo

    def decode_state(self, active) -> dict:
        """The paged cache dict one decode step runs on: the pool buffers
        (updated in place by the step), ``tables`` (slots, nb_max) int32,
        ``len`` (slots,) int32 from the host cursors, and each slot's write
        target ``write_block``/``write_off`` (slots,) int64."""
        dev = self.pool.device
        wb, wo = self.write_targets(active)
        return {**self.pool.bufs,
                "tables": torch.as_tensor(self._tables, device=dev),
                "len": torch.as_tensor(self._lengths, device=dev),
                "write_block": torch.as_tensor(wb, device=dev),
                "write_off": torch.as_tensor(wo, device=dev)}

    def advance(self, active) -> None:
        """After a decode step: the active slots' cursors move past the row
        the step wrote; idle slots stay where they are."""
        for s in active:
            self._lengths[s] += 1

    # ----------------------------------------------------------- prefill
    def write_fp_blocks(self, ids, pstate: dict, row: int, lo: int,
                        nb: int) -> None:
        """Blocks ``[lo, lo+nb)`` of fp prefill row ``row`` -> pool blocks
        ``ids`` (quantize-on-insert at kv_bits < 16). The FULL bucket row
        quantizes in one call: per-(token, head) scales make the result
        row-independent, so the blocks equal the dense path's insert."""
        assert len(ids) == nb, (ids, nb)
        B = self.pool.block
        if self.kv_bits in (8, 4):
            kq, ks = quantize_kv(pstate["k"][:, row], self.kv_bits)
            vq, vs = quantize_kv(pstate["v"][:, row], self.kv_bits)
            rows = {"k_q": kq, "v_q": vq, "k_scale": ks, "v_scale": vs}
        else:
            rows = {key: pstate[key][:, row] for key in ("k", "v")}
        idx = torch.as_tensor(list(ids), dtype=torch.int64,
                              device=self.pool.device)
        for key in self.pool.keys:
            r = rows[key][:, lo * B:(lo + nb) * B]
            self.pool.bufs[key][:, idx] = _block_shape(r, nb, B)

    def write_state_blocks(self, ids, state: dict, row: int, start: int,
                           nb: int) -> None:
        """Token rows ``[start, start+nb*B)`` of plan-precision scratch row
        ``row`` -> pool blocks ``ids`` (the prefix-chunked path: no
        requantization)."""
        assert len(ids) == nb, (ids, nb)
        B = self.pool.block
        idx = torch.as_tensor(list(ids), dtype=torch.int64,
                              device=self.pool.device)
        for key in self.pool.keys:
            r = state[key][:, row, start:start + nb * B]
            self.pool.bufs[key][:, idx] = _block_shape(r, nb, B)
