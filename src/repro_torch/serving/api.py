"""Serving API surface of the port: what the scheduler needs.

The generation half (``GenerationRequest``, ``SamplingParams``,
``TokenStream``, the sampler) arrives with the decode serving slice.
"""
from __future__ import annotations

__all__ = ["QueueFullError"]


class QueueFullError(RuntimeError):
    """Raised by ``submit`` when the bounded pending queue is at capacity
    (backpressure: the caller should retry later or shed load)."""
