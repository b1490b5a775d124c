"""Multi-tenant serving of the port: several deployed artifacts, one
process, fair-share admission; the counterpart of the JAX package's
``serving/tenants.py`` (DESIGN.md §14).

A :class:`MultiTenantEngine` hosts a registry of named tenants, each a
:class:`~repro_torch.serving.engine.ServingEngine` over its own
:class:`~repro_torch.deploy.DeployedModel` (an int4 W4A4 BERT classifier
and an int4 decoder can share the process and the card), behind one
submit surface and one ``engine_step()`` pump, so the load generator, the
CLI and the virtual-clock harness drive a fleet exactly like one engine.

Isolation is per tenant; scheduling is shared:

* **bounded queues**: each tenant keeps its own ``max_queue``
  (backpressure rejects that tenant's submits without touching its
  neighbours);
* **token-budget quotas**: an optional cap on a tenant's OUTSTANDING tokens
  (prompt + requested output of everything queued or running); a submit
  past it raises :class:`QuotaExceededError` (a ``QueueFullError``, so load
  generators count it as ``rejected``); finishing or cancelling releases
  the request's tokens;
* **deficit round-robin**: each ``engine_step()`` runs ONE tenant's step.
  A tenant's deficit gains ``weight * quantum_tokens`` when its turn starts
  and pays the tokens the step processed (prefill + decode + encode,
  ``engine.last_step_tokens``); the turn ends when the deficit is spent or
  the tenant drains. Work is conserved (an idle tenant's turn costs
  nothing) and no tenant starves: a backlogged tenant's turn comes around
  after every other tenant spends at most one quantum. The shared
  :class:`~repro_torch.serving.metrics.ServeMetrics` rolls the events up
  per tenant.

Request ids come from ONE shared counter at submit (the per-tenant
``Scheduler.assign_id`` keeps pre-assigned ids), so a rid names a request
process-wide: ``cancel(rid)``/``pop_done()`` need no tenant argument.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from .api import GenerationRequest, QueueFullError, TokenStream
from .clock import SYSTEM_CLOCK, Clock
from .encoder import EncodeHandle, EncodeRequest
from .engine import ServingEngine
from .metrics import ServeMetrics

__all__ = ["MultiTenantEngine", "QuotaExceededError", "TenantState"]


class QuotaExceededError(QueueFullError):
    """A tenant's outstanding-token budget is spent; submit again after some
    of its work finishes. Subclasses ``QueueFullError`` so existing
    backpressure handling (load generators, CLI) already treats it as a
    rejection."""


@dataclasses.dataclass
class TenantState:
    """Registry entry: the tenant's engine + its fair-share accounting."""

    name: str
    engine: ServingEngine
    weight: int = 1                       # DRR share multiplier
    token_budget: Optional[int] = None    # cap on outstanding tokens
    deficit: float = 0.0                  # DRR credit (tokens)
    outstanding: dict = dataclasses.field(default_factory=dict)  # rid -> cost

    @property
    def outstanding_tokens(self) -> int:
        return sum(self.outstanding.values())


class _SchedView:
    """The scheduler-shaped facade handles and load generators poll:
    ``TokenStream``/``EncodeHandle`` pump their ``_engine`` while
    ``_engine.scheduler.has_work`` — for a multi-tenant engine that means
    "any tenant has work"."""

    def __init__(self, mt: "MultiTenantEngine"):
        self._mt = mt

    @property
    def has_work(self) -> bool:
        return any(t.engine.scheduler.has_work
                   for t in self._mt.tenants.values())

    @property
    def queue_depth(self) -> int:
        return sum(t.engine.scheduler.queue_depth
                   for t in self._mt.tenants.values())

    @property
    def num_active(self) -> int:
        return sum(t.engine.scheduler.num_active
                   for t in self._mt.tenants.values())


class MultiTenantEngine:
    """Deficit-round-robin multiplexer over named :class:`ServingEngine`\\ s.

    Tenants share the clock and the metrics object (per-tenant rollups land
    under the summary's ``by_label`` key); everything else — model, slots,
    queue bound, quota, weight — is per tenant.
    """

    def __init__(self, *, clock: Clock = SYSTEM_CLOCK,
                 metrics: Optional[ServeMetrics] = None,
                 quantum_tokens: int = 64):
        if quantum_tokens <= 0:
            raise ValueError(f"quantum_tokens must be positive, "
                             f"got {quantum_tokens}")
        self.clock = clock
        self.metrics = (metrics if metrics is not None
                        else ServeMetrics(clock=clock))
        self.quantum_tokens = quantum_tokens
        self.tenants: dict[str, TenantState] = {}
        self._order: list[str] = []       # round-robin visiting order
        self._rr = 0                      # index into _order
        self._next_rid = 0                # ONE rid space across tenants
        self.scheduler = _SchedView(self)
        self.last_step_tokens = 0
        self.last_step_encode_tokens = 0

    # ------------------------------------------------------------- registry
    def add_tenant(self, name: str, model, *, slots: int = 4,
                   max_len: int = 512, max_queue: Optional[int] = None,
                   weight: int = 1, token_budget: Optional[int] = None
                   ) -> TenantState:
        """Register ``name`` over ``model`` (a DeployedModel). The tenant's
        engine shares the process clock and metrics; ``weight`` scales its
        DRR share, ``token_budget`` caps its outstanding tokens."""
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} already registered")
        if weight <= 0:
            raise ValueError(f"tenant {name!r}: weight must be positive")
        engine = ServingEngine(model, slots=slots, max_len=max_len,
                               max_queue=max_queue, metrics=self.metrics,
                               clock=self.clock, tenant=name)
        t = TenantState(name=name, engine=engine, weight=weight,
                        token_budget=token_budget)
        self.tenants[name] = t
        self._order.append(name)
        return t

    def _tenant(self, name: str) -> TenantState:
        t = self.tenants.get(name)
        if t is None:
            raise KeyError(f"unknown tenant {name!r}; registered: "
                           f"{sorted(self.tenants)}")
        return t

    # --------------------------------------------------------------- submit
    def _charge(self, t: TenantState, req, cost: int) -> None:
        """Quota check + rid assignment, BEFORE the engine sees the request
        (a quota rejection must not consume a queue slot)."""
        if t.token_budget is not None and \
                t.outstanding_tokens + cost > t.token_budget:
            raise QuotaExceededError(
                f"tenant {t.name!r}: outstanding {t.outstanding_tokens} + "
                f"{cost} tokens exceeds budget {t.token_budget}")
        if req.rid < 0:                   # shared rid space (assign_id
            req.rid = self._next_rid      # keeps pre-assigned ids)
            self._next_rid += 1
        t.outstanding[req.rid] = cost

    def submit(self, req: GenerationRequest, *, tenant: str,
               on_token: Optional[Callable[[int, int], None]] = None
               ) -> TokenStream:
        t = self._tenant(tenant)
        cost = len(req.prompt) + req.max_new_tokens
        self._charge(t, req, cost)
        try:
            stream = t.engine.submit(req, on_token=on_token)
        except Exception:
            t.outstanding.pop(req.rid, None)
            raise
        stream._engine = self       # iteration pumps the DRR loop, not
        return stream               # just this tenant

    def submit_encode(self, req: EncodeRequest, *, tenant: str,
                      on_result: Optional[Callable[[int, object], None]] = None
                      ) -> EncodeHandle:
        t = self._tenant(tenant)
        self._charge(t, req, len(req.tokens))
        try:
            handle = t.engine.submit_encode(req, on_result=on_result)
        except Exception:
            t.outstanding.pop(req.rid, None)
            raise
        handle._engine = self
        return handle

    # ----------------------------------------------------------------- pump
    def _release_finished(self, t: TenantState) -> None:
        """Return finished requests' tokens to the tenant's quota. The done
        list persists until ``pop_done`` drains it, so releasing is keyed on
        the outstanding map (each rid releases once)."""
        if not t.outstanding:
            return
        for req in t.engine.scheduler.done:
            t.outstanding.pop(req.rid, None)

    def engine_step(self) -> list[tuple[int, int]]:
        """ONE tenant's ``engine_step`` under deficit round-robin; returns
        that step's ``(rid, token)`` events. Idle tenants are skipped at
        zero cost (their deficit resets — credit must not accumulate while
        there is nothing to spend it on)."""
        self.last_step_tokens = 0
        self.last_step_encode_tokens = 0
        n = len(self._order)
        for _ in range(n):
            t = self.tenants[self._order[self._rr]]
            if not t.engine.scheduler.has_work:
                t.deficit = 0.0
                self._rr = (self._rr + 1) % n
                continue
            if t.deficit <= 0:
                t.deficit += t.weight * self.quantum_tokens
            events = t.engine.engine_step()
            # a step that only sheds/admits still pays 1 so a turn always
            # terminates
            t.deficit -= max(t.engine.last_step_tokens, 1)
            self.last_step_tokens = t.engine.last_step_tokens
            self.last_step_encode_tokens = t.engine.last_step_encode_tokens
            self._release_finished(t)
            if t.deficit <= 0 or not t.engine.scheduler.has_work:
                self._rr = (self._rr + 1) % n     # turn over
            return events
        return []

    def run_until_drained(self, max_steps: int = 100_000) -> int:
        steps = 0
        while self.scheduler.has_work:
            if steps >= max_steps:
                raise RuntimeError(
                    f"MultiTenantEngine: hit max_steps={max_steps} with "
                    f"{self.scheduler.queue_depth} queued and "
                    f"{self.scheduler.num_active} active")
            self.engine_step()
            steps += 1
        return steps

    # ------------------------------------------------------------ lifecycle
    def cancel(self, rid: int) -> bool:
        for t in self.tenants.values():
            if t.engine.cancel(rid):
                t.outstanding.pop(rid, None)
                return True
        return False

    def pop_done(self) -> list:
        """Drain every tenant's finished requests (quota released), in rid
        order so mixed-tenant consumers see one deterministic stream."""
        out = []
        for t in self.tenants.values():
            self._release_finished(t)
            out.extend(t.engine.pop_done())
        out.sort(key=lambda r: r.rid)
        return out
