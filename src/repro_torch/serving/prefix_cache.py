"""Shared-prefix KV reuse for the serving engine (DESIGN.md §11).

Under repeated-prefix traffic (system prompts, few-shot templates) every
admission used to recompute the same leading prompt tokens from scratch.
This module caches the QUANTIZED KV rows those tokens produce — codes plus
per-(token, head) scales, the DESIGN.md §8 layout — so a later request that
shares the prefix scatters the cached rows straight into its slot and only
prefills the suffix. Per-(token, head) scales make the rows slot-portable by
construction: no other row's scale is involved, so no requantization happens
on either side of the copy.

Structure:

* **block granularity** — prefixes are cached in fixed ``block``-token units
  (``PREFIX_BLOCK``, aligned with the engine's minimum prefill bucket). A
  block entry covers prompt tokens ``[j*B, (j+1)*B)`` and is keyed by a
  rolling hash of the FULL prefix ``prompt[:(j+1)*B]`` — a chained blake2b
  digest (``key_j = H(key_{j-1} || block_tokens)``), so extending a prefix
  by one block is O(block) and a key commits to EVERY token before it, not
  just the newest block. Lookups walk the chain block by block and stop at
  the first miss. Collisions would require breaking the digest; as belt and
  braces every entry also stores its block's tokens and a match requires
  them to compare equal — a mismatch degrades to a miss, never to wrong KV.
* **refcounts** — ``match()`` pins the blocks it returns; the engine releases
  them when the request finishes (complete / stop / cancel). Pinned blocks
  are never evicted, so a hot prefix cannot be evicted out from under an
  in-flight admission (the budget may transiently overshoot instead).
* **LRU + byte budget** — entries account their exact host bytes
  (``kernels/kv_pack.kv_row_bytes`` is the per-row arithmetic); once the
  budget is exceeded, unpinned entries evict oldest-use first. int4 KV
  compounds here: ~7x smaller rows than f32 mean ~7x more cacheable prefix
  tokens per byte.

The cache stores host (numpy) copies — it lives across engine steps and must
not pin device buffers. Byte-identity of hit-vs-cold streams is the engine's
contract (DESIGN.md §11): prefill quantizes block-by-block, so the rows a
cold run attends to are bit-equal to the rows a hit copies out of the cache.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict

import numpy as np

__all__ = ["PrefixCache", "PREFIX_BLOCK", "rolling_hash", "HASH_SEED"]

#: prefix granularity in tokens; equals the engine's minimum prefill bucket
#: so block boundaries always align with bucket boundaries.
PREFIX_BLOCK = 8

#: initial value of the chained prefix digest (the empty prefix)
HASH_SEED = b""


def rolling_hash(h: bytes, tokens) -> bytes:
    """Extend prefix digest ``h`` by one block of ``tokens``.

    ``key_j = blake2b(key_{j-1} || tokens_le32)``: incremental like a
    polynomial rolling hash, but each key commits to the ENTIRE prefix — a
    weaker hash verified only against the final block's tokens would let a
    constructible full-prefix collision serve another prompt's KV."""
    return hashlib.blake2b(
        h + np.asarray(tokens, np.int32).tobytes(),
        digest_size=16).digest()


@dataclasses.dataclass
class _Entry:
    key: bytes               # chained digest of the whole prefix ending here
    tokens: np.ndarray       # this block's tokens (defense-in-depth check)
    rows: dict               # buffer key -> (L, block, ...) host array
    nbytes: int
    refs: int = 0


class PrefixCache:
    """Refcounted, LRU-evicted, byte-budgeted store of quantized KV blocks."""

    def __init__(self, budget_bytes: int, block: int = PREFIX_BLOCK):
        if budget_bytes <= 0:
            raise ValueError(f"budget_bytes must be > 0, got {budget_bytes}")
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.budget = int(budget_bytes)
        self.block = int(block)
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self.bytes = 0
        # counters (host ints, never grow): per-request hit/miss plus token
        # totals; the engine mirrors these into ServeMetrics.
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.tokens_reused = 0

    # ---------------------------------------------------------------- lookup
    def match(self, prompt) -> tuple[int, tuple[bytes, ...]]:
        """Longest cached block-aligned prefix of ``prompt``, capped at
        ``len(prompt) - 1`` tokens — the last prompt token must always be
        computed to produce the first output logits.

        Returns ``(m, keys)``: ``m`` reusable tokens and the pinned block
        keys (refcount incremented; pass to :meth:`release` when the request
        finishes, hit or not)."""
        B = self.block
        h = HASH_SEED
        keys: list[bytes] = []
        m = 0
        j = 0
        while (j + 1) * B <= len(prompt) - 1:
            blk = np.asarray(prompt[j * B:(j + 1) * B], np.int32)
            h = rolling_hash(h, blk)
            entry = self._entries.get(h)
            if entry is None or not np.array_equal(entry.tokens, blk):
                break                      # first miss (or hash collision)
            self._entries.move_to_end(h)   # LRU touch
            entry.refs += 1
            keys.append(h)
            m = (j + 1) * B
            j += 1
        if m:
            self.hits += 1
        else:
            self.misses += 1
        self.tokens_reused += m
        return m, tuple(keys)

    def gather(self, keys) -> dict:
        """Concatenate pinned block rows into one ``(L, m, ...)`` array per
        buffer key, in prefix order."""
        entries = [self._entries[k] for k in keys]
        return {bk: np.concatenate([e.rows[bk] for e in entries], axis=1)
                for bk in entries[0].rows}

    def release(self, keys) -> None:
        """Unpin blocks acquired by :meth:`match`; runs deferred eviction."""
        for k in keys:
            entry = self._entries.get(k)
            if entry is not None and entry.refs > 0:
                entry.refs -= 1
        self._evict()

    # ---------------------------------------------------------------- insert
    def insert(self, prompt, upto: int, rows_for_block) -> int:
        """Publish the blocks covering ``prompt[:upto]`` that are not cached
        yet. ``rows_for_block(lo, hi)`` must return the host-array dict for
        token rows ``[lo, hi)`` — it is only called for missing blocks, so
        hits never pay the device→host copy. Returns blocks inserted."""
        B = self.block
        h = HASH_SEED
        added = 0
        for j in range(upto // B):
            blk = np.asarray(prompt[j * B:(j + 1) * B], np.int32)
            h = rolling_hash(h, blk)
            entry = self._entries.get(h)
            if entry is not None:
                if np.array_equal(entry.tokens, blk):
                    self._entries.move_to_end(h)
                    continue
                if entry.refs > 0:
                    # hash collision with a pinned entry: leave it alone; the
                    # chain for THIS prompt simply stops being cacheable here
                    break
                self.bytes -= entry.nbytes     # unpinned collision: replace
                del self._entries[h]
            rows = {bk: np.asarray(a) for bk, a in
                    rows_for_block(j * B, (j + 1) * B).items()}
            nbytes = sum(a.nbytes for a in rows.values()) + blk.nbytes
            self._entries[h] = _Entry(h, blk, rows, nbytes)
            self.bytes += nbytes
            added += 1
        self._evict()
        return added

    # --------------------------------------------------------------- queries
    def _evict(self) -> None:
        while self.bytes > self.budget:
            victim = next((k for k, e in self._entries.items()
                           if e.refs == 0), None)
            if victim is None:       # everything pinned: transient overshoot
                break
            self.bytes -= self._entries.pop(victim).nbytes
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        lookups = self.hits + self.misses
        return {
            "blocks": len(self._entries),
            "bytes": self.bytes,
            "budget_bytes": self.budget,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / lookups if lookups else 0.0,
            "tokens_reused": self.tokens_reused,
            "evictions": self.evictions,
        }
