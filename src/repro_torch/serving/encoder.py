"""Prefill-only encoder requests: classify / embed / score (DESIGN.md §14).

MKQ-BERT's deployment target is an *encoder* — the paper's end-to-end claim
is int4 BERT classification, not autoregressive decode. This module is the
request surface for that workload: an :class:`EncodeRequest` resolves to
logits, a pooled embedding, or a scalar score from ONE batched bucketed
forward through the deployed int4/int8 plan — no KV retention, no decode
loop. Requests ride the SAME scheduler machinery as generation traffic
(priority heap, bounded queue, deadline shedding, cancellation, Clock,
ServeMetrics): the engine duck-types on the fields both request classes
share (``rid``/``priority``/``deadline_s``/submit/admit stamps), so encode
and decode requests coexist in one ``engine_step()`` pump.

Tasks (family-dependent — validated at ``submit_encode``):

* ``classify`` — (num_classes,) logits from the CLS pool + classifier head
  (bert classifier artifacts).
* ``embed``    — (d_model,) tanh-pooled CLS embedding (bert).
* ``score``    — one scalar: bert artifacts return the positive-class
  log-probability (relevance scoring); DECODER artifacts return the
  prompt's total log-likelihood ``sum_i log p(t_i | t_<i)`` — which is how
  a decode engine serves encode traffic through the same slot table.

Exactness: encoder attention is bidirectional, so bucket padding is NOT
free the way it is for causal prefill — padded keys are masked per row
(``bert_encode(lengths=...)``), which makes a padded batch row bit-identical
to the unpadded forward. Batch rows are independent, so results never
depend on which other requests share the group (the PR-5 property, now for
encoders).

Like ``api``, this module is a leaf: the engine imports it, never the
reverse.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

__all__ = ["EncodeRequest", "EncodeResult", "EncodeHandle", "ENCODE_TASKS",
           "ENCODE_FINISH_REASONS"]

#: what an EncodeRequest may ask for (validated again per-family at submit)
ENCODE_TASKS = ("classify", "embed", "score")

#: terminal states: completed / cancelled while queued / deadline-shed
ENCODE_FINISH_REASONS = ("done", "cancelled", "shed")


@dataclasses.dataclass
class EncodeRequest:
    """A prefill-only job: tokens + task + admission policy.

    tokens      (plen,) int32 — the full input; there is no generation side.
    task        'classify' | 'embed' | 'score' (ENCODE_TASKS).
    priority    higher admits first; shares the heap with generation traffic.
    deadline_s  seconds after submit by which the request must be ADMITTED;
                past it the scheduler sheds it (``finish_reason='shed'``,
                result None) — same semantics as GenerationRequest.
    """

    tokens: np.ndarray
    task: str = "classify"
    priority: int = 0
    deadline_s: Optional[float] = None
    result: Optional[np.ndarray] = None
    rid: int = -1                   # assigned by the scheduler on submit
    finish_reason: Optional[str] = None
    # monotonic-clock stamps, filled in by scheduler/engine (repr noise)
    submit_t: Optional[float] = dataclasses.field(default=None, repr=False)
    admit_t: Optional[float] = dataclasses.field(default=None, repr=False)
    finish_t: Optional[float] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.task not in ENCODE_TASKS:
            raise ValueError(f"task must be one of {ENCODE_TASKS}, "
                             f"got {self.task!r}")
        self.tokens = np.asarray(self.tokens, np.int32)

    # the scheduler reads ``prompt`` for nothing, but the engine's length
    # validation and the load generator both key on it — alias the tokens
    @property
    def prompt(self) -> np.ndarray:
        return self.tokens

    # ------------------------------------------------------------- timing
    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.submit_t is None or self.admit_t is None:
            return None
        return self.admit_t - self.submit_t

    @property
    def latency_s(self) -> Optional[float]:
        """Submit → result (the encode analogue of TTFT)."""
        if self.submit_t is None or self.finish_t is None:
            return None
        return self.finish_t - self.submit_t

    def to_result(self) -> "EncodeResult":
        assert self.finish_reason is not None, \
            f"encode request {self.rid} has not finished"
        return EncodeResult(rid=self.rid, task=self.task, value=self.result,
                            finish_reason=self.finish_reason,
                            latency_s=self.latency_s,
                            queue_wait_s=self.queue_wait_s)


@dataclasses.dataclass(frozen=True)
class EncodeResult:
    """Terminal snapshot of a finished encode request."""

    rid: int
    task: str
    value: Optional[np.ndarray]     # logits (C,) / embedding (d,) / score ();
    finish_reason: str              # None for shed/cancelled
    latency_s: Optional[float]
    queue_wait_s: Optional[float]


class EncodeHandle:
    """Future-style handle to a submitted encode request.

    Mirrors the generation ``TokenStream`` handle: the engine is
    single-threaded, so ``result()`` pumps ``engine_step()`` until this
    request resolves. ``on_result(rid, value)`` fires from inside the
    engine's step when the forward completes (None for shed/cancel).
    """

    def __init__(self, engine, request: EncodeRequest,
                 on_result: Optional[Callable[[int, object], None]] = None):
        self._engine = engine
        self.request = request
        self.on_result = on_result
        self.finished = False

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def finish_reason(self) -> Optional[str]:
        return self.request.finish_reason

    # ------------------------------------------------- engine-facing hook
    def _finish(self) -> None:
        self.finished = True
        if self.on_result is not None:
            self.on_result(self.request.rid, self.request.result)

    # ---------------------------------------------------------- user side
    def result(self) -> EncodeResult:
        """Pump the engine until this request finishes."""
        while not self.finished:
            if not self._engine.scheduler.has_work:
                raise RuntimeError(
                    f"encode request {self.rid} unfinished but engine is "
                    "drained")
            self._engine.engine_step()
        return self.request.to_result()

    def cancel(self) -> bool:
        return self._engine.cancel(self.rid)
