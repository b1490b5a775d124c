"""Trace-driven closed-loop load generator + SLO-goodput reporting
(DESIGN.md §12), the port of the JAX package's ``serving/loadgen.py``.

It replays an **arrival process** — Poisson with mixed prompt/output
length distributions, shared-prefix mix, priority levels, deadline traffic
and mid-flight cancellations, or a recorded trace — against a
:class:`~repro_torch.serving.ServingEngine` through the streaming API
(``submit`` → ``TokenStream``, ``submit_encode`` → ``EncodeHandle``),
stamps every token against the engine's clock, and reports **SLO
goodput**: the fraction of offered requests that completed within a TTFT +
inter-token-latency SLO, alongside p50/p99 TTFT, inter-token gap, queue
wait, and shed/cancel/reject counts.

The same generator runs in two modes:

* **wall-clock** — the engine keeps its default ``time.monotonic`` clock;
  arrivals are released as real time passes (the pump sleeps while idle).
  ``repro_torch.benchmarks.serve_load`` runs this mode on the card.
* **virtual-clock** — the engine is built with a
  :class:`~repro_torch.serving.clock.VirtualClock` and a
  :class:`VirtualCost` model is supplied: the generator advances the clock
  itself (a fixed cost per engine step plus a per-prompt-token prefill
  surcharge), so every deadline / TTFT / queue-wait / shedding path is a
  pure function of the op sequence.

Arrivals are drawn from numpy's generator exactly as the JAX package draws
them, so one (workload, seed) gives both packages the same requests.
Statistics: :func:`run_trials` repeats a workload over per-trial seeds and
:func:`bootstrap_summary` pools the per-request samples, attaching
bootstrap confidence intervals to goodput and to each latency percentile.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Optional, Sequence

import numpy as np

from .api import GenerationRequest, QueueFullError, SamplingParams
from .clock import VirtualClock
from .encoder import EncodeRequest

__all__ = ["SLO", "Workload", "Arrival", "VirtualCost", "RequestRecord",
           "LoadResult", "make_arrivals", "trace_arrivals", "load_trace",
           "run_load", "run_trials", "bootstrap_summary"]


# ------------------------------------------------------------------- specs
@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request service-level objective.

    A request is **good** when it completed normally (``length``/``stop``)
    with ``ttft <= ttft_s`` and every inter-token gap ``<= itl_s``. Shed,
    rejected, and SLO-missing requests all count against goodput; requests
    the generator itself cancels are excluded from the denominator (their
    failure is injected, not the engine's).
    """

    ttft_s: float
    itl_s: float


@dataclasses.dataclass(frozen=True)
class VirtualCost:
    """Deterministic time model for virtual-clock runs: each ``engine_step``
    costs ``decode_step_s`` plus ``prefill_per_token_s`` for every prompt
    token whose request produced its FIRST token this step (prefill happens
    in the step that emits a request's first token)."""

    decode_step_s: float = 0.01
    prefill_per_token_s: float = 0.001
    #: per-token surcharge for prefill-only encode work resolved this step
    #: (read off ``engine.last_step_encode_tokens`` — encode requests emit
    #: no token events to infer it from)
    encode_per_token_s: float = 0.001


@dataclasses.dataclass(frozen=True)
class Workload:
    """Distributional description of an offered load.

    rate_rps            Poisson arrival rate (exponential inter-arrival
                        gaps); ignored when replaying an explicit trace.
    prompt_len          inclusive (lo, hi) uniform range of prompt lengths.
    new_tokens          inclusive (lo, hi) uniform range of max_new_tokens.
    shared_prefix_frac  fraction of requests whose prompt starts with ONE
                        workload-wide ``shared_prefix_len``-token prefix
                        (exercises the PR-5 prefix cache under load).
    sampled_frac        fraction decoding at temperature 0.8 (per-request
                        seed = arrival index); the rest run greedy.
    priorities          admission priority levels, sampled uniformly.
    deadline_frac/deadline_s   fraction carrying an admission deadline.
    cancel_frac         fraction the GENERATOR cancels mid-flight, after
                        ``cancel_after_tokens`` emitted tokens (uniform in
                        [1, cancel_after_tokens]) — exercises slotted
                        cancellation; queued cancels come out of deadline +
                        overload mixes.
    encode_frac         fraction offered as prefill-only EncodeRequests
                        (task ``encode_task``, DESIGN.md §14); 1.0 is a
                        pure encoder workload. The extra RNG draw only
                        happens when the fraction is nonzero, so existing
                        workloads replay bit-identically.
    tenant              route every request of this workload to the named
                        tenant of a ``MultiTenantEngine`` (None: the plain
                        single-engine submit surface).
    """

    n_requests: int = 32
    rate_rps: float = 10.0
    vocab: int = 256
    prompt_len: tuple[int, int] = (4, 12)
    new_tokens: tuple[int, int] = (2, 8)
    shared_prefix_frac: float = 0.0
    shared_prefix_len: int = 16
    sampled_frac: float = 0.0
    priorities: tuple[int, ...] = (0,)
    deadline_frac: float = 0.0
    deadline_s: Optional[float] = None
    cancel_frac: float = 0.0
    cancel_after_tokens: int = 2
    encode_frac: float = 0.0
    encode_task: str = "classify"
    tenant: Optional[str] = None


@dataclasses.dataclass
class Arrival:
    """One request of the arrival process: absolute release time + the
    fully-resolved request fields (so a trace replays bit-identically)."""

    t: float
    prompt: np.ndarray
    max_new_tokens: int
    sampling: Optional[SamplingParams] = None
    priority: int = 0
    deadline_s: Optional[float] = None
    cancel_after_tokens: Optional[int] = None
    task: Optional[str] = None      # encode task; None = generation request
    tenant: Optional[str] = None    # multi-tenant routing label

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


def make_arrivals(w: Workload, seed: int = 0) -> list[Arrival]:
    """Sample a concrete arrival list from ``w`` — deterministic per
    (workload, seed), so a virtual-clock replay is exactly repeatable."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, w.vocab, w.shared_prefix_len).astype(np.int32)
    t = 0.0
    out: list[Arrival] = []
    for i in range(w.n_requests):
        t += float(rng.exponential(1.0 / w.rate_rps))
        plen = int(rng.integers(w.prompt_len[0], w.prompt_len[1] + 1))
        if rng.random() < w.shared_prefix_frac:
            tail = rng.integers(1, w.vocab, max(plen, 1)).astype(np.int32)
            prompt = np.concatenate([shared, tail])
        else:
            prompt = rng.integers(1, w.vocab, max(plen, 1)).astype(np.int32)
        sampling = None
        if rng.random() < w.sampled_frac:
            sampling = SamplingParams(temperature=0.8, top_k=20, top_p=0.95,
                                      seed=i)
        deadline = (w.deadline_s if w.deadline_s is not None
                    and rng.random() < w.deadline_frac else None)
        cancel = (int(rng.integers(1, w.cancel_after_tokens + 1))
                  if rng.random() < w.cancel_frac else None)
        # guarded draw: workloads with encode_frac=0 consume the exact RNG
        # sequence they did before encode traffic existed
        task = (w.encode_task if w.encode_frac
                and rng.random() < w.encode_frac else None)
        out.append(Arrival(
            t=t, prompt=prompt,
            max_new_tokens=int(rng.integers(w.new_tokens[0],
                                            w.new_tokens[1] + 1)),
            sampling=sampling,
            priority=int(rng.choice(w.priorities)),
            deadline_s=deadline, cancel_after_tokens=cancel,
            task=task, tenant=w.tenant))
    return out


def trace_arrivals(trace: Sequence, w: Workload, seed: int = 0
                   ) -> list[Arrival]:
    """Recorded-trace arrival process: ``trace`` is a sequence of floats
    (arrival offsets in seconds) or dicts with ``t`` plus optional
    per-request overrides (``prompt_len``, ``max_new_tokens``, ``priority``,
    ``deadline_s``, ``cancel_after_tokens``, ``temperature``). Fields a
    trace entry does not pin are sampled from ``w`` (seeded) — replaying the
    same trace with the same workload + seed yields identical requests."""
    rng = np.random.default_rng(seed)
    out: list[Arrival] = []
    for i, entry in enumerate(trace):
        e = {"t": float(entry)} if not isinstance(entry, dict) else dict(entry)
        plen = int(e.get("prompt_len",
                         rng.integers(w.prompt_len[0], w.prompt_len[1] + 1)))
        prompt = rng.integers(1, w.vocab, max(plen, 1)).astype(np.int32)
        temp = e.get("temperature", 0.0)
        sampling = (SamplingParams(temperature=float(temp), seed=i)
                    if temp else None)
        out.append(Arrival(
            t=float(e["t"]), prompt=prompt,
            max_new_tokens=int(e.get("max_new_tokens",
                                     rng.integers(w.new_tokens[0],
                                                  w.new_tokens[1] + 1))),
            sampling=sampling,
            priority=int(e.get("priority", 0)),
            deadline_s=e.get("deadline_s"),
            cancel_after_tokens=e.get("cancel_after_tokens")))
    out.sort(key=lambda a: a.t)
    return out


def load_trace(path: str) -> list:
    """Read a recorded trace (JSON list of offsets or entry dicts)."""
    with open(path) as f:
        trace = json.load(f)
    if not isinstance(trace, list):
        raise ValueError(f"trace {path} must be a JSON list, "
                         f"got {type(trace).__name__}")
    return trace


# ----------------------------------------------------------------- records
#: terminal states a record can reach; engine FINISH_REASONS plus the
#: encode-path ``done`` and the generator-side ``rejected`` (QueueFullError
#: backpressure — including tenant quota — at submit).
RECORD_OUTCOMES = ("length", "stop", "done", "cancelled", "shed", "rejected")


@dataclasses.dataclass
class RequestRecord:
    """Everything the generator observed about one offered request."""

    index: int                       # position in the arrival list
    arrival_t: float                 # intended release time
    submit_t: float                  # actual submit stamp (engine clock)
    prompt_len: int
    max_new_tokens: int
    priority: int
    deadline_s: Optional[float]
    injected_cancel: bool            # generator planned to cancel this one
    task: Optional[str] = None       # encode task; None = generation
    tenant: Optional[str] = None
    rid: int = -1
    token_times: list = dataclasses.field(default_factory=list)
    tokens: list = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    finish_t: Optional[float] = None
    queue_wait_s: Optional[float] = None
    # wall-clock replay: when the request was due (start + arrival offset).
    # The pump submits between engine steps, so a request due during a step
    # is submitted after it; latencies count that wait from here. None on a
    # VirtualClock, where they run from the submit stamp as in JAX's.
    due_t: Optional[float] = None

    @property
    def start_t(self) -> float:
        """The stamp TTFT and encode latency are measured from."""
        return self.submit_t if self.due_t is None else self.due_t

    @property
    def ttft_s(self) -> Optional[float]:
        if not self.token_times:
            return None
        return self.token_times[0] - self.start_t

    @property
    def gaps_s(self) -> list[float]:
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]

    @property
    def encode_latency_s(self) -> Optional[float]:
        """Due (or submit) → result for encode records (the one-shot TTFT
        analogue)."""
        if self.task is None or self.finish_t is None:
            return None
        return self.finish_t - self.start_t

    def slo_ok(self, slo: SLO) -> bool:
        if self.task is not None:    # encode: one result, judged like a TTFT
            return (self.finish_reason == "done"
                    and self.encode_latency_s is not None
                    and self.encode_latency_s <= slo.ttft_s)
        if self.finish_reason not in ("length", "stop"):
            return False
        if self.ttft_s is None or self.ttft_s > slo.ttft_s:
            return False
        return all(g <= slo.itl_s for g in self.gaps_s)


def _pcts_ms(samples: list[float]) -> dict:
    if not samples:
        return {}
    arr = np.asarray(samples, np.float64) * 1e3
    if len(arr) < 2:                 # match ServeMetrics' sub-2-sample guard
        return {"p50_ms": float(arr[0]), "p99_ms": float(arr[0])}
    return {"p50_ms": float(np.percentile(arr, 50)),
            "p99_ms": float(np.percentile(arr, 99))}


@dataclasses.dataclass
class LoadResult:
    """One trial's outcome: per-request records + pump accounting."""

    records: list[RequestRecord]
    duration_s: float
    steps: int

    def counted(self) -> list[RequestRecord]:
        """Records in the goodput denominator (injected cancels excluded)."""
        return [r for r in self.records if not r.injected_cancel]

    def summary(self, slo: SLO) -> dict:
        recs = self.records
        counted = self.counted()
        good = [r for r in counted if r.slo_ok(slo)]
        by = {k: sum(r.finish_reason == k for r in recs)
              for k in RECORD_OUTCOMES}
        out = {
            "n_offered": len(recs),
            "n_counted": len(counted),
            "n_good": len(good),
            "goodput": len(good) / max(len(counted), 1),
            "n_completed": by["length"] + by["stop"] + by["done"],
            "n_shed": by["shed"],
            "n_cancelled": by["cancelled"],
            "n_rejected": by["rejected"],
            "duration_s": self.duration_s,
            "steps": self.steps,
        }
        if self.duration_s > 0:
            out["goodput_rps"] = len(good) / self.duration_s
        for name, samples in (
                ("ttft", [r.ttft_s for r in recs if r.ttft_s is not None]),
                ("itl", [g for r in recs for g in r.gaps_s]),
                ("queue_wait", [r.queue_wait_s for r in recs
                                if r.queue_wait_s is not None]),
                ("encode_latency", [r.encode_latency_s for r in recs
                                    if r.encode_latency_s is not None])):
            for k, v in _pcts_ms(samples).items():
                out[f"{name}_{k}"] = v
        return out


# -------------------------------------------------------------------- pump
def run_load(engine, arrivals: Sequence[Arrival], *,
             cost: Optional[VirtualCost] = None,
             max_steps: int = 200_000,
             idle_sleep_s: float = 0.002,
             sleep: Callable[[float], None] = time.sleep) -> LoadResult:
    """Closed-loop replay of ``arrivals`` against ``engine``.

    With ``cost=None`` (wall-clock mode) the engine's own clock advances by
    itself and the pump sleeps while waiting for the next arrival. With a
    :class:`VirtualCost` the engine MUST have been built with a
    :class:`VirtualClock` — the generator advances it deterministically:
    idle gaps jump straight to the next arrival, and each ``engine_step``
    charges the cost model. Token stamps are taken AFTER the step's cost is
    applied, so a virtual TTFT includes the prefill step that produced the
    first token, exactly like a wall-clock TTFT includes its real duration.

    Arrival times are offsets from the clock's reading when the replay
    starts: arrival ``a`` is released at ``start + a.t``. (The JAX
    package's generator compares the offsets with the clock itself, so on
    ``time.monotonic`` it releases every arrival at once; on a
    ``VirtualClock`` that starts at 0, as every virtual replay's does, the
    two agree.) On the wall clock, TTFT and encode latency run from that
    due time, so the wait for the step boundary at which the pump submits
    counts; on a ``VirtualClock`` they run from the submit stamp, as in the
    JAX package.
    """
    clock = engine.clock
    virtual = cost is not None
    if virtual and not isinstance(clock, VirtualClock):
        raise TypeError("virtual-clock mode needs an engine built with "
                        "clock=VirtualClock(...); this engine's clock is "
                        f"{clock!r}")
    arrivals = sorted(arrivals, key=lambda a: a.t)
    records: list[RequestRecord] = []
    by_rid: dict[int, RequestRecord] = {}
    streams: dict[int, object] = {}
    cancel_at: dict[int, int] = {}       # rid -> cancel after N tokens
    idx, steps = 0, 0
    t_start = clock()

    def submit_due(now: float) -> None:
        nonlocal idx
        while idx < len(arrivals) and t_start + arrivals[idx].t <= now:
            a = arrivals[idx]
            idx += 1
            if a.task is not None:
                req = EncodeRequest(tokens=a.prompt, task=a.task,
                                    priority=a.priority,
                                    deadline_s=a.deadline_s)
            else:
                req = GenerationRequest(
                    prompt=a.prompt, max_new_tokens=a.max_new_tokens,
                    sampling=a.sampling, priority=a.priority,
                    deadline_s=a.deadline_s)
            rec = RequestRecord(
                index=idx - 1, arrival_t=a.t, submit_t=clock(),
                prompt_len=a.prompt_len, max_new_tokens=a.max_new_tokens,
                priority=a.priority, deadline_s=a.deadline_s,
                injected_cancel=a.cancel_after_tokens is not None,
                task=a.task, tenant=a.tenant,
                due_t=None if virtual else t_start + a.t)
            records.append(rec)
            # multi-tenant engines take the routing label; the single-engine
            # surface has no tenant kwarg, so only pass it when set
            kw = {} if a.tenant is None else {"tenant": a.tenant}
            try:
                if a.task is not None:
                    stream = engine.submit_encode(req, **kw)
                else:
                    stream = engine.submit(req, **kw)
            except QueueFullError:
                rec.rid = req.rid
                rec.finish_reason = "rejected"
                rec.finish_t = clock()
                continue
            rec.rid = req.rid
            by_rid[req.rid] = rec
            streams[req.rid] = stream
            if a.cancel_after_tokens is not None:
                cancel_at[req.rid] = a.cancel_after_tokens

    while True:
        now = clock()
        submit_due(now)
        if not engine.scheduler.has_work:
            if idx >= len(arrivals):
                break                      # drained and nothing left to offer
            due = t_start + arrivals[idx].t
            gap = due - now
            if virtual:
                clock.advance_to(due)
            elif gap > 0:
                sleep(min(gap, idle_sleep_s))
            continue
        if steps >= max_steps:
            raise RuntimeError(
                f"run_load: exceeded max_steps={max_steps} with "
                f"{len(arrivals) - idx} arrival(s) unreleased and work "
                "still pending — engine stalled or cost/rate mismatch")
        events = engine.engine_step()
        steps += 1
        if virtual:
            prefill_tokens = sum(
                rec.prompt_len for rid in {r for r, _ in events}
                if (rec := by_rid.get(rid)) is not None
                and not rec.token_times)
            encode_tokens = getattr(engine, "last_step_encode_tokens", 0)
            clock.advance(cost.decode_step_s
                          + cost.prefill_per_token_s * prefill_tokens
                          + cost.encode_per_token_s * encode_tokens)
        now = clock()
        for rid, tok in events:
            rec = by_rid.get(rid)
            if rec is None:        # warmup leftovers: not ours to score
                continue
            rec.token_times.append(now)
            rec.tokens.append(int(tok))
        for rid, after in list(cancel_at.items()):
            rec = by_rid[rid]
            if rec.finish_reason is None and len(rec.token_times) >= after:
                streams[rid].cancel()
                del cancel_at[rid]
        for req in engine.pop_done():
            rec = by_rid.get(req.rid)
            if rec is None:        # e.g. warmup leftovers: not ours to score
                continue
            rec.finish_reason = req.finish_reason
            rec.finish_t = now
            rec.queue_wait_s = req.queue_wait_s
            streams.pop(req.rid, None)
            cancel_at.pop(req.rid, None)
    return LoadResult(records=records, duration_s=clock() - t_start,
                      steps=steps)


def run_trials(make_engine: Callable[[], object], w: Workload, *,
               n_trials: int, cost: Optional[VirtualCost] = None,
               base_seed: int = 0, trace: Optional[Sequence] = None,
               max_steps: int = 200_000) -> list[LoadResult]:
    """Repeat the workload over per-trial arrival seeds, each against a
    fresh engine from ``make_engine`` (which must install a VirtualClock
    when ``cost`` is given). Trial ``i`` uses seed ``base_seed + i`` — the
    trial set is reproducible as a whole."""
    results = []
    for i in range(n_trials):
        arrivals = (trace_arrivals(trace, w, seed=base_seed + i)
                    if trace is not None
                    else make_arrivals(w, seed=base_seed + i))
        results.append(run_load(make_engine(), arrivals, cost=cost,
                                max_steps=max_steps))
    return results


# ---------------------------------------------------------------- boot CIs
def _boot_ci(samples: np.ndarray, stat: Callable[[np.ndarray], float],
             rng: np.random.Generator, n_boot: int, level: float) -> dict:
    """Percentile-bootstrap CI of ``stat`` over ``samples``."""
    point = float(stat(samples))
    n = len(samples)
    stats = np.array([stat(samples[rng.integers(0, n, n)])
                      for _ in range(n_boot)])
    alpha = 100.0 * (1.0 - level) / 2.0
    return {"mean": point,
            "lo": float(np.percentile(stats, alpha)),
            "hi": float(np.percentile(stats, 100.0 - alpha))}


def bootstrap_summary(results: Sequence[LoadResult], slo: SLO, *,
                      n_boot: int = 400, seed: int = 0,
                      level: float = 0.95) -> dict:
    """Pool per-request samples across trials and attach bootstrap CIs.

    ``goodput`` resamples the per-request SLO indicators; each latency
    percentile resamples its pooled sample set and recomputes the
    percentile. Deterministic per (results, seed) — the CI gate can be
    re-run bit-identically."""
    rng = np.random.default_rng(seed)
    indicators = np.array([1.0 if r.slo_ok(slo) else 0.0
                           for res in results for r in res.counted()])
    out: dict = {
        "n_trials": len(results),
        "slo": {"ttft_s": slo.ttft_s, "itl_s": slo.itl_s},
        "n_boot": n_boot,
        "level": level,
    }
    for k in ("n_offered", "n_counted", "n_good", "n_completed", "n_shed",
              "n_cancelled", "n_rejected", "steps"):
        out[k] = int(sum(res.summary(slo)[k] for res in results))
    out["duration_s"] = float(sum(res.duration_s for res in results))
    if len(indicators):
        out["goodput"] = _boot_ci(indicators, np.mean, rng, n_boot, level)
    tenants = sorted({r.tenant for res in results for r in res.records
                      if r.tenant is not None})
    if tenants:
        # per-tenant point estimates (no CIs: the fair-share gate compares
        # whole-tenant counts, which are deterministic per seed set)
        out["by_tenant"] = {}
        for name in tenants:
            cnt = [r for res in results for r in res.counted()
                   if r.tenant == name]
            good = sum(r.slo_ok(slo) for r in cnt)
            comp = sum(r.finish_reason in ("length", "stop", "done")
                       for r in cnt)
            out["by_tenant"][name] = {
                "n_counted": len(cnt), "n_completed": comp, "n_good": good,
                "goodput": good / max(len(cnt), 1)}
    pools = {
        "ttft": [r.ttft_s for res in results for r in res.records
                 if r.ttft_s is not None],
        "itl": [g for res in results for r in res.records for g in r.gaps_s],
        "queue_wait": [r.queue_wait_s for res in results for r in res.records
                       if r.queue_wait_s is not None],
        "encode_latency": [r.encode_latency_s for res in results
                           for r in res.records
                           if r.encode_latency_s is not None],
    }
    for name, samples in pools.items():
        if not samples:
            continue
        arr = np.asarray(samples, np.float64) * 1e3
        for p in (50, 99):
            out[f"{name}_p{p}_ms"] = _boot_ci(
                arr, lambda a, p=p: float(np.percentile(a, p))
                if len(a) > 1 else float(a[0]), rng, n_boot, level)
    return out
