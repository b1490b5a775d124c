"""Injectable clocks for the serving stack (DESIGN.md §12).

Every time-dependent decision in serving — deadline shedding, queue-wait /
TTFT stamps, metrics wall time — reads ONE injected clock instead of calling
``time.monotonic()`` inline. A clock is just a zero-argument callable
returning monotonic seconds, so the default (``time.monotonic`` itself) adds
no wrapper object and no behavior change for existing callers.

:class:`VirtualClock` is the deterministic implementation: time advances only
when the owner (the load generator, or a test) says so, via ``advance``/
``advance_to``. Threading it through ``ServingEngine`` + ``Scheduler`` +
``ServeMetrics`` makes every deadline/TTFT/shedding path a pure function of
the op sequence — simulation tests assert EXACT timings with zero sleeps and
zero wall-clock dependence (``tests/test_loadgen.py``).
"""
from __future__ import annotations

import time
from typing import Callable

__all__ = ["Clock", "SYSTEM_CLOCK", "VirtualClock"]

#: A clock is any zero-argument callable returning monotonic seconds.
Clock = Callable[[], float]

#: The default wall clock (what every serving component used inline before).
SYSTEM_CLOCK: Clock = time.monotonic


class VirtualClock:
    """Deterministic simulated clock: ``clock()`` reads, ``advance`` writes.

    Starts at ``start`` seconds and only ever moves forward — rewinding a
    monotonic clock would silently un-expire deadlines mid-flight, so
    ``advance`` rejects negative steps and ``advance_to`` clamps to now.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    @property
    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` seconds; returns the new now."""
        if dt < 0:
            raise ValueError(f"cannot rewind a monotonic clock (dt={dt})")
        self._now += float(dt)
        return self._now

    def advance_to(self, t: float) -> float:
        """Move time forward to ``t`` (no-op when ``t`` is in the past)."""
        self._now = max(self._now, float(t))
        return self._now

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"VirtualClock(now={self._now:.6f})"
