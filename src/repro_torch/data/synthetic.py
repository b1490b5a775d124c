"""Deterministic synthetic data pipelines: no dataset is fetched.

Tasks have LEARNABLE structure (not pure noise) so QAT/distill quality
benchmarks are meaningful:

* ``SyntheticLM``: order-2 Markov token stream from a seeded random transition
  table with temperature — a model must learn real conditional structure.
* ``SyntheticClassification``: GLUE-like sentence classification; the label is
  a seeded linear readout of bag-of-token-embedding features + label noise.

Both shard by (host_index, num_hosts) and prefetch with a background thread,
the same interface a real tokenized-corpus loader would expose. Numpy only,
the JAX package's generators line for line: batch ``step`` is bit-equal on
both sides.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    branching: int = 32          # out-degree of the Markov table
    host_index: int = 0
    num_hosts: int = 1

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = self.vocab_size
        self._table = rng.integers(0, V, size=(min(V, 4096), self.branching))

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed, step, self.host_index, 0xA11CE))
        B, S = self.batch_size // self.num_hosts, self.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, self._table.shape[0], size=B)
        choices = rng.integers(0, self.branching, size=(B, S))
        for t in range(S):
            toks[:, t + 1] = self._table[toks[:, t] % self._table.shape[0],
                                         choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass
class SyntheticClassification:
    """GLUE-like task: y = argmax(W_cls @ mean(embed[tokens]) + noise)."""
    vocab_size: int
    seq_len: int
    batch_size: int
    num_classes: int = 2
    seed: int = 0
    label_noise: float = 0.05
    host_index: int = 0
    num_hosts: int = 1

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._embed = rng.standard_normal((self.vocab_size, 16)).astype(np.float32)
        self._readout = rng.standard_normal((16, self.num_classes)).astype(np.float32)

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step, self.host_index, 0xBEEF))
        B = self.batch_size // self.num_hosts
        toks = rng.integers(1, self.vocab_size, size=(B, self.seq_len)).astype(np.int32)
        toks[:, 0] = 0  # [CLS]
        feats = self._embed[toks].mean(axis=1)
        logits = feats @ self._readout
        labels = logits.argmax(-1)
        flip = rng.random(B) < self.label_noise
        labels = np.where(flip, rng.integers(0, self.num_classes, B), labels)
        return {"tokens": toks, "labels": labels.astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (host-side overlap with device compute)."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for item in self._it:
            if self._stop:
                return
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        """Stop the producer: it exits at its next item (a slot is freed so
        a producer blocked on a full queue can reach that check)."""
        self._stop = True
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass


def lm_batches(vocab, seq, batch, seed=0, prefetch=True, **kw):
    it = iter(SyntheticLM(vocab, seq, batch, seed=seed, **kw))
    return Prefetcher(it) if prefetch else it


def classification_batches(vocab, seq, batch, num_classes=2, seed=0,
                           prefetch=False, **kw):
    it = iter(SyntheticClassification(vocab, seq, batch, num_classes,
                                      seed=seed, **kw))
    return Prefetcher(it) if prefetch else it
