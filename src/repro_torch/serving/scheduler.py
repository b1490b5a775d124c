"""Request scheduler: priority queue + fixed slot table with continuous
refill (DESIGN.md §7, admission policy §10).

Continuous-batching-lite: the engine decodes one token per step for every
occupied slot; whenever a request finishes, its slot is refilled from the
queue on the next ``admit`` — no global batch barrier, so short requests
never wait for long ones.

Admission policy (DESIGN.md §10):

* **priority** — higher ``GenerationRequest.priority`` admits first; FIFO
  within a priority level (a monotone sequence number breaks heap ties).
* **bounded queue** — ``max_queue`` caps pending depth; ``submit`` raises
  :class:`~repro_torch.serving.api.QueueFullError` (backpressure) instead of
  growing without bound under overload.
* **deadline shedding** — a request whose ``deadline_s`` elapsed before a
  slot freed up is shed at ``admit`` time (never decoded); the engine drains
  ``pop_shed()`` each step and finalizes those with ``finish_reason='shed'``.
* **drain semantics** — completed requests accumulate in ``done`` only until
  ``pop_done()`` is called, so a long-lived engine does not leak every
  request it ever served.
"""
from __future__ import annotations

import heapq
import itertools
import time
from typing import Callable, Optional

from .api import QueueFullError

#: what the scheduler queues: any request object carrying ``rid``,
#: ``priority``, ``deadline_s`` and the submit/admit stamps
#: (``api.GenerationRequest`` and ``encoder.EncodeRequest``)
GenerationRequest = Request = object


class Scheduler:
    """Owns the queue, the slot table and request lifecycle bookkeeping."""

    def __init__(self, slots: int, max_queue: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 or None, "
                             f"got {max_queue}")
        self.slots = slots
        self.max_queue = max_queue
        self._clock = clock
        self._heap: list[tuple[int, int, GenerationRequest]] = []
        self._seq = itertools.count()        # FIFO within a priority level
        self.active: list[Optional[GenerationRequest]] = [None] * slots
        self.done: list[GenerationRequest] = []
        self._shed: list[GenerationRequest] = []
        # rid source: a shareable counter OBJECT, not a plain int — a
        # ReplicaSet (serving/replicas.py) points every member engine's
        # scheduler at ONE counter so a rid names a request fleet-wide
        # (n>1 fanout children draw from a member's own scheduler, so an
        # unshared per-engine int would collide across replicas).
        self._ids = itertools.count()

    # ------------------------------------------------------------- lifecycle
    def assign_id(self, req: GenerationRequest) -> GenerationRequest:
        """Give a request its rid without enqueueing it (the engine assigns
        before validation so rejections reference a real request id)."""
        if req.rid < 0:
            req.rid = next(self._ids)
        return req

    def submit(self, req: GenerationRequest) -> GenerationRequest:
        self.assign_id(req)
        if self.max_queue is not None and self.queue_depth >= self.max_queue:
            # deadline-expired entries waiting for a slot are already dead —
            # shed them NOW instead of letting them hold queue_depth and
            # bounce live traffic with QueueFullError (they used to be shed
            # only inside admit(), which never runs while every slot is busy)
            self._shed_expired()
        if self.max_queue is not None and self.queue_depth >= self.max_queue:
            raise QueueFullError(
                f"request {req.rid}: queue full ({self.queue_depth}/"
                f"{self.max_queue} pending) — retry or raise max_queue")
        req.submit_t = self._clock()
        heapq.heappush(self._heap, (-req.priority, next(self._seq), req))
        return req

    def _expired(self, req: GenerationRequest, now: float) -> bool:
        return (req.deadline_s is not None and req.submit_t is not None
                and now - req.submit_t > req.deadline_s)

    def _shed_expired(self) -> int:
        """Move every deadline-expired queued request into ``pop_shed()``;
        returns how many were shed. The engine finalizes them on its next
        step."""
        now = self._clock()
        keep = [item for item in self._heap if not self._expired(item[2], now)]
        shed = len(self._heap) - len(keep)
        if shed:
            self._shed.extend(item[2] for item in self._heap
                              if self._expired(item[2], now))
            self._heap = keep
            heapq.heapify(self._heap)
        return shed

    def cancel(self, rid: int) -> Optional[GenerationRequest]:
        """Cancel a QUEUED request: the heap entry is removed EAGERLY (a
        lazy tombstone would outlive ``max_queue`` accounting and leak
        prompts while every slot is busy). Returns the request, or None when
        ``rid`` is not queued — active-slot cancellation is the engine's job
        (it owns the KV state that must be freed)."""
        for i, (_, _, req) in enumerate(self._heap):
            if req.rid == rid:
                self._heap[i] = self._heap[-1]
                self._heap.pop()
                heapq.heapify(self._heap)
                return req
        return None

    def admit(self, fits: Optional[Callable[[GenerationRequest], bool]] = None
              ) -> list[tuple[int, GenerationRequest]]:
        """Fill free slots from the queue in priority order; returns the new
        placements. Requests whose deadline elapsed are shed into
        ``pop_shed()`` instead of placed.

        ``fits`` (optional) is an engine-side capacity predicate checked
        against the HIGHEST-priority pending request before it is popped:
        admission stops at the first request that does not fit (it stays
        queued, in order), letting token-mode engines refuse admission when
        the shared cache cursor cannot cover prompt + max_new_tokens."""
        placed = []
        now = self._clock()
        free = [s for s, r in enumerate(self.active) if r is None]
        while free and self._heap:
            req = self._heap[0][2]
            if self._expired(req, now):
                heapq.heappop(self._heap)
                self._shed.append(req)
                continue
            if fits is not None and not fits(req):
                break
            heapq.heappop(self._heap)
            slot = free.pop(0)
            req.admit_t = now
            self.active[slot] = req
            placed.append((slot, req))
        return placed

    def complete(self, slot: int) -> GenerationRequest:
        req = self.active[slot]
        assert req is not None, f"slot {slot} is empty"
        self.active[slot] = None
        self.done.append(req)
        return req

    # --------------------------------------------------------------- drains
    def pop_done(self) -> list[GenerationRequest]:
        """Return-and-clear the completed list (the non-leaking way to
        consume results from a long-lived engine; ``done`` keeps
        accumulating otherwise)."""
        drained, self.done = self.done, []
        return drained

    def pop_shed(self) -> list[GenerationRequest]:
        """Return-and-clear requests shed at admission (deadline expired);
        the engine finalizes these with ``finish_reason='shed'``."""
        drained, self._shed = self._shed, []
        return drained

    # ------------------------------------------------------------- queries
    def peek(self) -> Optional[GenerationRequest]:
        """The next request ``admit`` would consider (highest priority),
        without popping it."""
        return self._heap[0][2] if self._heap else None

    @property
    def queue(self) -> list[GenerationRequest]:
        """Pending requests in admission order (a snapshot — the live
        structure is a heap; supports ``len``/iteration like the old
        deque)."""
        return [req for _, _, req in sorted(self._heap)]

    @property
    def queue_depth(self) -> int:
        return len(self._heap)

    @property
    def has_work(self) -> bool:
        # _shed counts as work: entries shed at submit() time (not just
        # inside admit()) still need the engine's pop_shed() drain to be
        # finalized — otherwise an emptied queue could strand them with no
        # finish_reason and a stream that never resolves
        return (self.queue_depth > 0 or len(self._shed) > 0
                or any(r is not None for r in self.active))

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.active)

    def active_slots(self) -> list[int]:
        return [s for s, r in enumerate(self.active) if r is not None]


def group_admits(placed: list, key_fn: Callable, max_batch: int
                 ) -> list[tuple[object, list]]:
    """Group one admission round's placements for batched prefill.

    Placements with equal ``key_fn(item)`` (the engine keys on (bucket,
    cached-prefix identity)) batch into ONE prefill forward, chunked to
    ``max_batch`` rows each. Deterministic: groups appear in first-seen
    order, items keep their admission order within a group — so a given
    submit sequence always yields the same batches, and ``max_batch=1``
    degenerates to the serial one-forward-per-request schedule."""
    groups: dict = {}
    order: list = []
    for item in placed:
        key = key_fn(item)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(item)
    out = []
    for key in order:
        members = groups[key]
        for i in range(0, len(members), max_batch):
            out.append((key, members[i:i + max_batch]))
    return out
