"""Data-parallel engine replicas of the port: N engines behind ONE
admission surface, the counterpart of the JAX package's
``serving/replicas.py`` (DESIGN.md §16).

Tensor parallelism (the plan's ``tp``) splits one model's weights and KV
heads over ranks; a :class:`ReplicaSet` is the other scale axis: N
engines over the SAME :class:`~repro_torch.deploy.DeployedModel` tensors
(never copied per replica; each member owns only its slots, queue bound
and KV state) serve independent request batches. On one card the members
share the device and run one after another within a step.

The set mirrors the :class:`~repro_torch.serving.tenants.MultiTenantEngine`
surface: one ``submit``/``engine_step()`` pump, a scheduler-shaped facade
for handles and load generators, one shared
:class:`~repro_torch.serving.metrics.ServeMetrics` and clock, with two
deliberate differences:

* **dispatch, not fair share**: replicas are interchangeable, so
  ``submit`` routes each request to the least-loaded member (fewest queued
  + active; ties to the lowest index, so virtual-clock runs replay
  byte-identically);
* **every replica pumps per step**: ``engine_step()`` steps ALL members, as
  concurrent hardware would; under the virtual cost model one
  ``engine_step`` charges one ``decode_step_s``, which is what makes N
  replicas N times the capacity there. (The DRR loop in tenants.py steps
  one member per pump: one process time-slicing shared compute.)

Request ids come from ONE shared counter: every member scheduler is pointed
at replica 0's ``itertools.count``, so a rid names a request set-wide and
``cancel(rid)``/``pop_done()`` need no replica argument; ``n > 1`` fanout
children (which draw rids from their member's scheduler) never collide.

Determinism: a request's tokens are a function of (prompt, seed) only,
never of which replica, slot or batch serves it, so a ReplicaSet's streams
are byte-identical to a single engine serving the same requests.
"""
from __future__ import annotations

from typing import Callable, Optional

from .api import GenerationRequest, TokenStream
from .clock import SYSTEM_CLOCK, Clock
from .encoder import EncodeHandle, EncodeRequest
from .engine import ServingEngine
from .metrics import ServeMetrics

__all__ = ["ReplicaSet"]


class _SchedView:
    """Scheduler-shaped facade (the tenants.py idiom): handles pump their
    ``_engine`` while ``_engine.scheduler.has_work`` — for a replica set
    that means "any member has work"."""

    def __init__(self, rs: "ReplicaSet"):
        self._rs = rs

    @property
    def has_work(self) -> bool:
        return any(e.scheduler.has_work for e in self._rs.engines)

    @property
    def queue_depth(self) -> int:
        return sum(e.scheduler.queue_depth for e in self._rs.engines)

    @property
    def num_active(self) -> int:
        return sum(e.scheduler.num_active for e in self._rs.engines)


class ReplicaSet:
    """N :class:`ServingEngine` replicas over one deployed model.

    All members share the model tensors (nothing is copied per replica),
    the metrics object, the clock and the rid space; each owns its slots,
    queue bound and KV state.
    """

    def __init__(self, model, *, replicas: int = 2, slots: int = 8,
                 max_len: int = 512, max_queue: Optional[int] = None,
                 metrics: Optional[ServeMetrics] = None,
                 clock: Clock = SYSTEM_CLOCK,
                 kv_budget_bytes: Optional[int] = None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.clock = clock
        self.metrics = (metrics if metrics is not None
                        else ServeMetrics(clock=clock))
        self.engines = [
            ServingEngine(model, slots=slots, max_len=max_len,
                          max_queue=max_queue, metrics=self.metrics,
                          clock=clock, kv_budget_bytes=kv_budget_bytes)
            for _ in range(replicas)]
        # ONE rid space: every member scheduler draws from replica 0's
        # counter object (see Scheduler._ids) — including the rids member
        # engines assign internally to n>1 fanout children.
        ids = self.engines[0].scheduler._ids
        for e in self.engines[1:]:
            e.scheduler._ids = ids
        self.scheduler = _SchedView(self)
        self.last_step_tokens = 0
        self.last_step_encode_tokens = 0

    @property
    def replicas(self) -> int:
        return len(self.engines)

    # --------------------------------------------------------------- submit
    def _least_loaded(self) -> ServingEngine:
        """Fewest (queued + active); ties break to the lowest index, so
        dispatch is a pure function of submit order and member load —
        virtual-clock runs replay byte-identically."""
        return min(self.engines,
                   key=lambda e: e.scheduler.queue_depth
                   + e.scheduler.num_active)

    def submit(self, req: GenerationRequest, *,
               on_token: Optional[Callable[[int, int], None]] = None
               ) -> TokenStream:
        out = self._least_loaded().submit(req, on_token=on_token)
        # iteration must pump the whole set (this member's work may depend
        # on nothing, but the handle's drain loop polls scheduler.has_work)
        for stream in (out if isinstance(out, list) else (out,)):
            stream._engine = self
        return out

    def submit_encode(self, req: EncodeRequest, *,
                      on_result: Optional[Callable[[int, object], None]] = None
                      ) -> EncodeHandle:
        handle = self._least_loaded().submit_encode(req, on_result=on_result)
        handle._engine = self
        return handle

    # ----------------------------------------------------------------- pump
    def engine_step(self) -> list[tuple[int, int]]:
        """Pump EVERY replica once (concurrent hardware — see module
        docstring); events concatenate in member order, token counters sum."""
        self.last_step_tokens = 0
        self.last_step_encode_tokens = 0
        events: list[tuple[int, int]] = []
        for e in self.engines:
            events.extend(e.engine_step())
            self.last_step_tokens += e.last_step_tokens
            self.last_step_encode_tokens += e.last_step_encode_tokens
        return events

    def run_until_drained(self, max_steps: int = 10000) -> int:
        steps = 0
        while self.scheduler.has_work:
            if steps >= max_steps:
                raise RuntimeError(
                    f"ReplicaSet: hit max_steps={max_steps} with "
                    f"{self.scheduler.queue_depth} queued and "
                    f"{self.scheduler.num_active} active")
            self.engine_step()
            steps += 1
        return steps

    # ------------------------------------------------------------ lifecycle
    def cancel(self, rid: int) -> bool:
        return any(e.cancel(rid) for e in self.engines)

    def pop_done(self) -> list:
        """Drain every member's finished requests in rid order, so the
        merged stream is deterministic regardless of member interleave."""
        out: list = []
        for e in self.engines:
            out.extend(e.pop_done())
        out.sort(key=lambda r: r.rid)
        return out

    @property
    def done(self) -> list:
        return sorted((r for e in self.engines for r in e.done),
                      key=lambda r: r.rid)
