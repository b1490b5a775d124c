"""Serving engine, encoder mode: prefill-only classify / embed / score.

Requests ride the scheduler (priority heap, bounded queue, deadline
shedding, cancellation, injectable clock). Each ``engine_step()`` admits
what the free slots allow, groups the admissions by pow2 bucket (8, 16, ...
up to ``max_len``) into batches of at most ``plan.prefill_batch`` rows (the
row count padded to a power of two), and runs ONE bidirectional forward per
group with per-row length masking. Every request resolves, and frees its
slot, inside the step that admits it.

The forward is a plain call on the artifact's device; on the card it runs
through the hand-written kernels when the plan's backend is ``"cuda"``.
Decode serving (generation requests, KV caches, sampling) is a later slice.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..deploy import DeployedModel, ExecutionPlan
from ..models.bert import bert_encode, bert_pool
from .clock import SYSTEM_CLOCK, Clock
from .encoder import EncodeHandle, EncodeRequest
from .metrics import ServeMetrics
from .scheduler import Scheduler, group_admits


def _bucket_for(plen: int, max_len: int, min_bucket: int = 8) -> int:
    b = min_bucket
    while b < plen:
        b *= 2
    return min(b, max_len)


def _pow2_ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class ServingEngine:
    """Encoder-mode engine over a deployed quantized BERT.

    ``model`` is a :class:`DeployedModel` (plan included), or a raw params
    tree with ``plan`` passed explicitly. ``max_queue`` bounds the pending
    queue (``submit_encode`` raises ``QueueFullError`` past it).
    """

    def __init__(self, model, plan: Optional[ExecutionPlan] = None, *,
                 slots: int = 8, max_len: int = 512,
                 max_queue: Optional[int] = None,
                 clock: Clock = SYSTEM_CLOCK):
        if isinstance(model, DeployedModel):
            if plan is not None and plan != model.plan:
                raise ValueError(
                    "pass either a DeployedModel (plan included) or raw "
                    "params + plan, not a conflicting pair")
            params, plan = model.params, model.plan
        else:
            params = model
            if plan is None:
                raise TypeError("raw params need an ExecutionPlan; build one "
                                "with repro_torch.deploy.ExecutionPlan.build")
        if plan.mode != "encoder":
            raise ValueError("decode serving is a later slice of the port; "
                             "build the plan with mode='encoder'")
        self.plan = plan
        self.params = params
        self.max_len = max_len
        self.prefill_batch = max(1, plan.prefill_batch)
        # one clock for deadlines, wait stamps and step timings
        self.clock = clock
        self.scheduler = Scheduler(slots, max_queue=max_queue, clock=clock)
        self.metrics = ServeMetrics(clock=clock)
        self._streams: dict[int, EncodeHandle] = {}

    # ------------------------------------------------------------------ API
    def submit_encode(self, req: EncodeRequest, *,
                      on_result: Optional[Callable[[int, object], None]] = None
                      ) -> EncodeHandle:
        """Enqueue a prefill-only request; the result lands on the returned
        :class:`EncodeHandle`."""
        self.scheduler.assign_id(req)      # so rejections carry a real rid
        plen = len(req.tokens)
        if plen <= 0:
            raise ValueError(f"request {req.rid}: empty input")
        if plen > self.max_len:
            raise ValueError(
                f"request {req.rid}: input ({plen}) exceeds engine max_len "
                f"({self.max_len})")
        needs = ("classifier",) if req.task in ("classify", "score") \
            else ("pooler",)
        for head in needs:
            if head not in self.params:
                raise ValueError(
                    f"request {req.rid}: task={req.task!r} needs a "
                    f"{head!r} head the deployed artifact does not have")
        handle = EncodeHandle(self, req, on_result=on_result)
        self._streams[req.rid] = handle
        try:
            self.scheduler.submit(req)     # may raise QueueFullError
        except Exception:
            self._streams.pop(req.rid, None)
            raise
        return handle

    def cancel(self, rid: int) -> bool:
        """Cancel a queued request (encode requests hold a slot only within
        the step that admits them). False when ``rid`` is unknown or
        already finished."""
        req = self.scheduler.cancel(rid)
        if req is not None:
            self._finalize_unslotted(req, "cancelled")
            return True
        for s, req in enumerate(self.scheduler.active):
            if req is not None and req.rid == rid:
                self._finalize_slotted(s, req, "cancelled")
                return True
        return False

    def pop_done(self) -> list:
        """Drain completed requests (see ``Scheduler.pop_done``)."""
        return self.scheduler.pop_done()

    @property
    def done(self) -> list:
        return self.scheduler.done

    def run_until_drained(self, max_steps: int = 10000) -> int:
        """Pump ``engine_step`` until no work remains; raises RuntimeError
        instead of silently stranding requests when ``max_steps`` hits."""
        steps = 0
        while self.scheduler.has_work:
            if steps >= max_steps:
                q = self.scheduler.queue_depth
                a = self.scheduler.num_active
                raise RuntimeError(
                    f"run_until_drained: hit max_steps={max_steps} with "
                    f"{q + a} request(s) stranded ({q} queued, {a} active)")
            self.engine_step()
            steps += 1
        return steps

    def engine_step(self) -> None:
        """The public pump: admit, then one batched encode per group."""
        placed = self.scheduler.admit()
        for _, req in placed:
            if req.queue_wait_s is not None:
                self.metrics.record_wait("queue_wait", req.queue_wait_s)
        if placed:
            self._encode_admitted(placed)
        for req in self.scheduler.pop_shed():
            self._finalize_unslotted(req, "shed")

    # ------------------------------------------------------------ lifecycle
    def _close_stream(self, req) -> None:
        handle = self._streams.pop(req.rid, None)
        if handle is not None:
            handle._finish()

    def _finalize_unslotted(self, req, reason: str) -> None:
        """Finish a request that never occupied a slot (queued-cancel or
        deadline shed): no result, straight to done."""
        req.result = None
        req.finish_reason = reason
        req.finish_t = self.clock()
        self.scheduler.done.append(req)
        self._close_stream(req)

    def _finalize_slotted(self, slot: int, req, reason: str) -> None:
        req.finish_reason = reason
        req.finish_t = self.clock()
        self.scheduler.complete(slot)
        self._close_stream(req)

    # -------------------------------------------------------------- encode
    def encode_batch(self, tokens, lengths) -> dict[str, torch.Tensor]:
        """One bidirectional forward over a padded (n, bucket) batch with
        per-row ``lengths``; returns every head the artifact carries."""
        with torch.no_grad():
            h = bert_encode(self.params, self.plan, tokens, lengths=lengths)
            out = {"embed": bert_pool(self.params, h)}
            if "classifier" in self.params:
                logits = (out["embed"] @ self.params["classifier"]["w"]
                          + self.params["classifier"]["b"])
                logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
                out["classify"] = logits
                # relevance score: positive-class log-probability
                out["score"] = logp[:, 1] if logits.shape[-1] >= 2 else logp[:, 0]
        return out

    def _encode_admitted(self, placed) -> None:
        jobs = [(s, req, _bucket_for(len(req.tokens), self.max_len))
                for s, req in placed]
        groups = group_admits(jobs, key_fn=lambda j: j[2],
                              max_batch=self.prefill_batch)
        for bucket, members in groups:
            group = [(s, req) for s, req, _ in members
                     if self.scheduler.active[s] is req]
            if not group:      # cancelled by a callback mid-round
                continue
            self._encode_group(bucket, group)

    def _encode_group(self, bucket: int, group) -> None:
        """One batched forward; every request resolves (and frees its slot)
        before this returns."""
        n = _pow2_ceil(len(group))
        toks = np.zeros((n, bucket), np.int64)
        lens = np.ones(n, np.int32)      # padding rows: length-1, masked
        total = 0
        for i, (s, req) in enumerate(group):
            plen = len(req.tokens)
            toks[i, :plen] = req.tokens
            lens[i] = plen
            total += plen
        t0 = self.clock()
        out = self.encode_batch(toks, lens)
        out = {task: v.cpu().numpy() for task, v in out.items()}
        self.metrics.record("encode", self.clock() - t0, total)
        for i, (s, req) in enumerate(group):
            if self.scheduler.active[s] is not req:
                continue   # an earlier on_result callback cancelled it
            req.result = out[req.task][i]
            self._finalize_slotted(s, req, "done")
            if req.latency_s is not None:
                self.metrics.record_wait("encode_latency", req.latency_s)
