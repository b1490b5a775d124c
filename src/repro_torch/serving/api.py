"""Generation API of the port: requests, sampling, token streams.

The request/response surface of the decode engine, as in the JAX package:

* **request types**: :class:`GenerationRequest` (prompt + sampling + stop
  conditions + priority/deadline) and :class:`SamplingParams`;
* **handles**: ``engine.submit(req)`` returns a :class:`TokenStream` that
  yields tokens as the engine produces them (iterator form) and/or calls a
  per-token callback; ``stream.result()`` pumps to completion and returns a
  :class:`GenerationResult`;
* **sampling**: :func:`sample_token` (one logits row) and
  :func:`sample_batch` (a (B, vocab) batch with per-row parameters).

Greedy decoding (``temperature=0``) is ``argmax`` over the f32 logits, the
first maximum winning ties as in ``jnp.argmax``. Otherwise: temperature ->
top-k mask -> top-p (nucleus) mask -> a Gumbel-max draw whose noise comes
from a ``torch.Generator`` seeded from ``(seed, step)``, where ``step`` is
the request's own generated-token index. A request's stream therefore
depends only on (prompt, seed) on a given device, never on the batch it
shares. The JAX PRNG cannot be reproduced here, so non-greedy streams
differ from the JAX package's.

This module is a leaf: the engine and the scheduler import it, never the
reverse.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Iterator, Optional

import numpy as np
import torch

__all__ = ["SamplingParams", "GenerationRequest", "GenerationResult",
           "TokenStream", "QueueFullError", "FINISH_REASONS",
           "sample_token", "sample_batch", "sample_seed"]

#: Terminal states of a request: hit ``max_new_tokens`` / emitted a stop
#: token / cancelled via ``cancel(rid)`` / shed at admission past deadline.
FINISH_REASONS = ("length", "stop", "cancelled", "shed")


class QueueFullError(RuntimeError):
    """Raised by ``submit`` when the bounded pending queue is at capacity
    (backpressure: the caller should retry later or shed load)."""


# --------------------------------------------------------------- parameters
@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding knobs. The default is greedy decoding.

    temperature  0 (default) is greedy argmax; > 0 scales logits before the
                 draw.
    top_k        keep only the k highest logits (0 disables).
    top_p        nucleus sampling: keep the smallest prefix of the sorted
                 distribution with cumulative probability >= top_p
                 (1.0 disables).
    seed         sampling seed; a request's stream is a function of
                 (prompt, seed) regardless of batch composition.
    n            independent samples from ONE prompt: ``submit`` fans an
                 ``n > 1`` request into ``n`` children, sample ``i`` with
                 seed ``sample_seed(seed, i)`` (sample 0 keeps the seed).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    n: int = 1

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), "
                             f"got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    @classmethod
    def resolve(cls, value) -> "SamplingParams":
        """None -> greedy defaults; dict -> kwargs (artifact meta round
        trip); SamplingParams -> itself."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(f"sampling must be SamplingParams, dict or None, "
                        f"got {type(value).__name__}")


def sample_seed(seed: int, index: int) -> int:
    """Per-sample decode seed for ``SamplingParams.n`` fanout: sample 0
    keeps the request's seed; sample i > 0 derives a distinct seed by a
    golden-ratio stride, kept positive (the JAX package's arithmetic)."""
    if index == 0:
        return seed
    return (seed + 0x9E3779B9 * index) & 0x7FFFFFFF


# ----------------------------------------------------------------- requests
@dataclasses.dataclass
class GenerationRequest:
    """A generation job: prompt + sampling + stop conditions + admission.

    sampling     None inherits the plan's ``default_sampling`` at submit.
    stop_tokens  emitting any of these ends the request early
                 (``finish_reason='stop'``); the stop token IS the stream's
                 final token.
    priority     higher admits first; FIFO within a priority level.
    deadline_s   seconds after submit by which the request must be ADMITTED;
                 past it the scheduler sheds it (``finish_reason='shed'``,
                 empty output).
    """

    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int = 16
    sampling: Optional[SamplingParams] = None
    stop_tokens: frozenset = frozenset()
    priority: int = 0
    deadline_s: Optional[float] = None
    out: Optional[np.ndarray] = None
    rid: int = -1                   # assigned by the scheduler on submit
    finish_reason: Optional[str] = None
    # clock stamps, filled in by scheduler/engine (repr noise)
    submit_t: Optional[float] = dataclasses.field(default=None, repr=False)
    admit_t: Optional[float] = dataclasses.field(default=None, repr=False)
    first_token_t: Optional[float] = dataclasses.field(default=None,
                                                       repr=False)
    finish_t: Optional[float] = dataclasses.field(default=None, repr=False)
    # n>1 fanout bookkeeping (set by submit)
    fork_group: Optional[int] = dataclasses.field(default=None, repr=False)
    sample_index: int = dataclasses.field(default=0, repr=False)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        self.stop_tokens = frozenset(int(t) for t in self.stop_tokens)
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {self.max_new_tokens}")

    # ------------------------------------------------------------- timing
    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.submit_t is None or self.admit_t is None:
            return None
        return self.admit_t - self.submit_t

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token (submit -> first emitted token)."""
        if self.submit_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    def result(self) -> "GenerationResult":
        assert self.finish_reason is not None, \
            f"request {self.rid} has not finished"
        return GenerationResult(rid=self.rid, tokens=self.out,
                                finish_reason=self.finish_reason,
                                ttft_s=self.ttft_s,
                                queue_wait_s=self.queue_wait_s)


@dataclasses.dataclass(frozen=True)
class GenerationResult:
    """Terminal snapshot of a finished request."""

    rid: int
    tokens: np.ndarray              # trimmed output (empty for shed/queued-
    finish_reason: str              # cancel); one of FINISH_REASONS
    ttft_s: Optional[float]
    queue_wait_s: Optional[float]


# ------------------------------------------------------------------ streams
class TokenStream:
    """Live handle to a submitted request: iterate tokens as produced.

    The engine is single-threaded and callers pump it: the iterator form
    calls ``engine.engine_step()`` whenever no token is buffered; the
    callback form (``on_token(rid, token)``) fires from inside the step.
    ``result()`` pumps to completion; ``cancel()`` frees the request's slot
    and KV rows mid-flight.
    """

    def __init__(self, engine, request: GenerationRequest,
                 on_token: Optional[Callable[[int, int], None]] = None):
        self._engine = engine
        self.request = request
        self.on_token = on_token
        self.tokens: list[int] = []           # everything emitted so far
        self._pending: deque[int] = deque()   # emitted, not yet iterated
        self.finished = False

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def finish_reason(self) -> Optional[str]:
        return self.request.finish_reason

    # ------------------------------------------------- engine-facing hooks
    def _push(self, token: int) -> None:
        self.tokens.append(token)
        self._pending.append(token)
        if self.on_token is not None:
            self.on_token(self.request.rid, token)

    def _finish(self) -> None:
        self.finished = True

    # ---------------------------------------------------------- user side
    def __iter__(self) -> Iterator[int]:
        return self

    def __next__(self) -> int:
        while not self._pending:
            if self.finished:
                raise StopIteration
            if not self._engine.scheduler.has_work:
                raise RuntimeError(
                    f"request {self.rid} unfinished but engine is drained")
            self._engine.engine_step()
        return self._pending.popleft()

    def result(self) -> GenerationResult:
        """Pump the engine until this request finishes."""
        while not self.finished:
            if not self._engine.scheduler.has_work:
                raise RuntimeError(
                    f"request {self.rid} unfinished but engine is drained")
            self._engine.engine_step()
        return self.request.result()

    def cancel(self) -> bool:
        return self._engine.cancel(self.rid)


# ----------------------------------------------------------------- sampling
_M64 = (1 << 64) - 1


def _generator_seed(seed: int, step: int) -> int:
    """One 64-bit generator seed per (request seed, token index): the pair
    packed into 64 bits and mixed by splitmix64's finalizer, so that the
    low 32 bits, all the CPU generator keeps, depend on both."""
    z = ((int(seed) & 0x7FFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def sample_token(logits: torch.Tensor, seed: int, step: int,
                 temperature: float, top_k: int, top_p: float) -> torch.Tensor:
    """Sample one token id from a (vocab,) logits row; returns a 0-d int64
    tensor on the logits' device (no host synchronisation).

    ``temperature <= 0`` is the exact argmax of the f32 logits. Otherwise:
    temperature scaling -> top-k mask -> top-p mask -> Gumbel-max draw with
    noise from a generator seeded from ``(seed, step)``. Every mask keeps
    the argmax, so the draw is over a non-empty support."""
    logits = logits.to(torch.float32)
    if temperature <= 0.0:
        return torch.argmax(logits)
    vocab = logits.shape[-1]
    scaled = logits / torch.full((), max(float(temperature), 1e-6),
                                 device=logits.device)
    neg_inf = torch.full((), float("-inf"), device=logits.device)
    # top-k: mask everything below the k-th largest (k <= 0 disables)
    k = top_k if top_k > 0 else vocab
    desc = torch.sort(scaled, descending=True).values
    kth = desc[min(max(k - 1, 0), vocab - 1)]
    scaled = torch.where(scaled < kth, neg_inf, scaled)
    # top-p: smallest sorted prefix with cumulative probability >= top_p (a
    # token survives iff the mass strictly before it is < top_p, so the
    # argmax always survives; ties at the threshold are all kept)
    probs = torch.softmax(scaled, dim=-1)
    psort = torch.sort(probs, descending=True).values
    keep = (torch.cumsum(psort, dim=-1) - psort) < top_p
    thresh = torch.min(torch.where(keep, psort, torch.full((), float("inf"),
                                                           device=logits.device)))
    scaled = torch.where(probs < thresh, neg_inf, scaled)
    g = torch.Generator(device=logits.device)
    g.manual_seed(_generator_seed(seed, step))
    u = torch.rand(vocab, generator=g, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(scaled + gumbel)


def sample_batch(logits: torch.Tensor, seeds, steps, temps, top_ks,
                 top_ps) -> torch.Tensor:
    """(B, vocab) logits + per-row (seed, step, temperature, top_k, top_p)
    host arrays -> (B,) int64 token ids on the logits' device. Greedy rows
    take one batched argmax; each sampled row draws from its own
    request-derived generator, so determinism is per request."""
    out = torch.argmax(logits.to(torch.float32), dim=-1)
    for b in range(logits.shape[0]):
        if temps[b] > 0.0:
            out[b] = sample_token(logits[b], int(seeds[b]), int(steps[b]),
                                  float(temps[b]), int(top_ks[b]),
                                  float(top_ps[b]))
    return out
