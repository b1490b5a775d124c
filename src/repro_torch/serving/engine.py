"""Serving engine: generation over a dense slot KV cache (decode mode) and
prefill-only classify / embed / score (encoder mode).

Requests ride the scheduler (priority heap, bounded queue, deadline
shedding, cancellation, injectable clock). ``engine_step()`` is the public
pump; it returns the ``(rid, token)`` pairs it emitted.

* **decode mode** (a ``mode='decode'`` plan over a dense decoder): each step
  admits what the free slots allow, groups the admissions by pow2 bucket (8,
  16, ... up to ``max_len``) into batches of at most ``plan.prefill_batch``
  rows (padded to a power of two), and runs ONE fp-cache prefill forward
  per group; each request samples its first token from its own logits row
  and its KV rows scatter into its slot, quantized on insert at kv_bits
  8/4. Then one batched decode step runs every slot (idle slots included,
  their cache writes dropped), quantizing each new row on append. On the
  card, with the plan's ``"cuda"`` backend, the integer linears and the
  one-token attention over the quantized cache run through the
  hand-written kernels, and the decode forward makes no host
  synchronisation until the sampled ids are read back.
* **encoder mode** (a ``mode='encoder'`` plan over bert): admissions are
  grouped the same way and resolved by ONE bidirectional forward with
  per-row length masking; every request frees its slot inside the step
  that admits it.

Greedy streams are ``argmax``; sampled ones draw from a per-request
generator seeded from (seed, token index), so a request's tokens depend on
(prompt, seed) only. Left for later slices: the shared-prefix cache, paged
KV, token-mode prefill and the decoder ``score`` task.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..deploy import DeployedModel, ExecutionPlan
from ..models import api as model_api
from ..models.bert import bert_encode, bert_pool
from .api import (GenerationRequest, SamplingParams, TokenStream,
                  sample_batch, sample_seed, sample_token)
from .clock import SYSTEM_CLOCK, Clock
from .encoder import EncodeHandle, EncodeRequest
from .kv_cache import SlotKVCache
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
    """Continuous-batching engine over a deployed quantized model.

    ``model`` is a :class:`DeployedModel` (plan included), or a raw params
    tree with ``plan`` passed explicitly. The engine runs where the params
    lie (a deployed model on the card serves on the card). ``max_queue``
    bounds the pending queue (``submit``/``submit_encode`` raise
    ``QueueFullError`` past it).
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
        if plan.mode not in ("decode", "encoder"):
            raise ValueError(f"unknown plan mode {plan.mode!r}")
        self.plan = plan
        self.cfg = plan.cfg
        self.params = params
        self.device = params["embed"].device
        self.slots = slots
        self.max_len = max_len
        self.mode = plan.mode
        self.prefill_batch = max(1, plan.prefill_batch)
        self.default_sampling = SamplingParams.resolve(plan.default_sampling)
        # one clock for deadlines, wait stamps and step timings
        self.clock = clock
        self.scheduler = Scheduler(slots, max_queue=max_queue, clock=clock)
        self.metrics = ServeMetrics(clock=clock)
        self.generated: list[list[int]] = [[] for _ in range(slots)]
        self._streams: dict = {}              # rid -> TokenStream|EncodeHandle
        self._events: list[tuple[int, int]] = []
        self._next_fork = 0
        # per-slot sampling state, set at admit; the step index is the
        # slot's generated-token count
        self._seed = np.zeros(slots, np.int64)
        self._temp = np.zeros(slots, np.float32)
        self._topk = np.zeros(slots, np.int32)
        self._topp = np.ones(slots, np.float32)
        self.kv = (None if self.mode == "encoder"
                   else SlotKVCache.from_plan(plan, slots, max_len,
                                              device=self.device))

    # ------------------------------------------------------------------ API
    def submit(self, req: GenerationRequest, *,
               on_token: Optional[Callable[[int, int], None]] = None):
        """Validate + enqueue; returns the request's :class:`TokenStream`.
        Malformed requests are rejected here, before any KV row is written.

        ``sampling.n > 1`` fans out into ``n`` child requests (sample ``i``
        decodes with seed ``sample_seed(seed, i)``) in plain slots and
        returns a LIST of ``n`` streams. A ``QueueFullError`` mid-fanout
        propagates; children already enqueued stay queued."""
        if self.mode == "encoder":
            raise ValueError(
                "this engine serves a mode='encoder' plan: no decode loop "
                "exists; submit EncodeRequests via submit_encode")
        self.scheduler.assign_id(req)      # so rejections carry a real rid
        plen = len(req.prompt)
        if plen <= 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if plen + req.max_new_tokens > self.max_len:
            # past max_len the cache writes drop: decode would keep emitting
            # tokens that cannot see recent context
            raise ValueError(
                f"request {req.rid}: prompt ({plen}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds engine max_len "
                f"({self.max_len})")
        req.sampling = SamplingParams.resolve(
            req.sampling if req.sampling is not None
            else self.default_sampling)
        sp = req.sampling
        if sp.n > 1:
            gid = self._next_fork
            self._next_fork += 1
            streams = []
            for i in range(sp.n):
                child = dataclasses.replace(
                    req,
                    sampling=dataclasses.replace(
                        sp, n=1, seed=sample_seed(sp.seed, i)),
                    rid=-1, out=None, finish_reason=None)
                child.fork_group = gid
                child.sample_index = i
                streams.append(self.submit(child, on_token=on_token))
            return streams
        stream = TokenStream(self, req, on_token=on_token)
        self._streams[req.rid] = stream
        try:
            self.scheduler.submit(req)     # may raise QueueFullError
        except Exception:
            self._streams.pop(req.rid, None)
            raise
        return stream

    def submit_encode(self, req: EncodeRequest, *,
                      on_result: Optional[Callable[[int, object], None]] = None
                      ) -> EncodeHandle:
        """Enqueue a prefill-only request on an encoder engine; the result
        lands on the returned :class:`EncodeHandle`."""
        if self.mode != "encoder":
            raise ValueError(
                "this engine serves a mode='decode' plan; the decoder "
                "'score' task (prompt log-likelihood) is a later slice of "
                "the port: submit GenerationRequests via submit")
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
        """Cancel a queued or mid-flight request. An occupied slot is freed
        at once (its KV rows zeroed, its cursor rewound); tokens already
        generated stay on ``req.out``. False when ``rid`` is unknown or
        already finished."""
        req = self.scheduler.cancel(rid)
        if req is not None:                      # still queued: never ran
            self._finalize_unslotted(req, "cancelled")
            return True
        for s, req in enumerate(self.scheduler.active):
            if req is not None and req.rid == rid:
                self._finalize_slotted(s, req, "cancelled")
                if self.kv is not None:
                    self.kv.reset_slot(s)
                return True
        return False

    def pop_done(self) -> list:
        """Drain completed requests (see ``Scheduler.pop_done``)."""
        return self.scheduler.pop_done()

    @property
    def done(self) -> list:
        return self.scheduler.done

    @property
    def queue(self):
        return self.scheduler.queue

    @property
    def active(self):
        return self.scheduler.active

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

    def engine_step(self) -> list[tuple[int, int]]:
        """The public pump: admit, then prefill + one batched decode step
        (decode mode) or one batched encode per group (encoder mode).
        Returns the ``(rid, token)`` pairs emitted this step."""
        self._events = []
        placed = self._admit()
        if self.mode == "encoder":
            if placed:
                self._encode_admitted(placed)
        else:
            if placed:
                self._prefill_admitted(placed)
            self._decode_active()
        for req in self.scheduler.pop_shed():
            self._finalize_unslotted(req, "shed")
        return self._events

    # ------------------------------------------------------------ lifecycle
    def _admit(self) -> list:
        """Scheduler admit + per-slot sampling state + queue-wait metric.
        Clears the slot's stale token tally up front."""
        placed = self.scheduler.admit()
        for s, req in placed:
            self.generated[s] = []
            sp = getattr(req, "sampling", None)  # EncodeRequests don't sample
            if sp is not None:
                self._seed[s] = sp.seed & 0x7FFFFFFF
                self._temp[s] = sp.temperature
                self._topk[s] = sp.top_k
                self._topp[s] = sp.top_p
            if req.queue_wait_s is not None:
                self.metrics.record_wait("queue_wait", req.queue_wait_s)
        return placed

    def _emit(self, req: GenerationRequest, token: int) -> None:
        if req.first_token_t is None:
            req.first_token_t = self.clock()
            if req.ttft_s is not None:
                self.metrics.record_wait("ttft", req.ttft_s)
        stream = self._streams.get(req.rid)
        if stream is not None:
            stream._push(token)
        self._events.append((req.rid, token))

    def _close_stream(self, req) -> None:
        handle = self._streams.pop(req.rid, None)
        if handle is not None:
            handle._finish()

    def _finalize_unslotted(self, req, reason: str) -> None:
        """Finish a request that never occupied a slot (queued-cancel or
        deadline shed): empty output, straight to done."""
        if isinstance(req, EncodeRequest):
            req.result = None
        else:
            req.out = np.zeros(0, np.int32)
        req.finish_reason = reason
        req.finish_t = self.clock()
        self.scheduler.done.append(req)
        self._close_stream(req)

    def _finalize_slotted(self, slot: int, req, reason: str) -> None:
        """The one exit path for slotted requests (length/stop/cancel):
        output truncated to the request's own ``max_new_tokens``, slot
        returned to the scheduler, stream closed."""
        if not isinstance(req, EncodeRequest):
            req.out = np.array(self.generated[slot][:req.max_new_tokens],
                               np.int32)
        req.finish_reason = reason
        req.finish_t = self.clock()
        self.scheduler.complete(slot)
        self._close_stream(req)

    def _maybe_complete(self, slot: int, req: GenerationRequest) -> None:
        toks = self.generated[slot]
        if toks and toks[-1] in req.stop_tokens:
            self._finalize_slotted(slot, req, "stop")  # stop token stays
        elif len(toks) >= req.max_new_tokens:
            self._finalize_slotted(slot, req, "length")

    # ------------------------------------------------------------- prefill
    def prefill_forward(self, tokens: torch.Tensor):
        """One batch-n fp-cache forward over padded (n, bucket) prompts:
        prefill always runs on an fp scratch cache whatever the plan's
        kv_bits; the rows quantize on slot insert. Returns (logits,
        scratch state)."""
        n, bucket = tokens.shape
        with torch.no_grad():
            st = self.plan.decode_state(n, bucket, kv_bits=16,
                                        device=self.device)
            return model_api.forward(self.params, self.plan, state=st,
                                     tokens=tokens)

    def _sample_first(self, logits_row: torch.Tensor, slot: int) -> int:
        return int(sample_token(logits_row, int(self._seed[slot]), 0,
                                float(self._temp[slot]), int(self._topk[slot]),
                                float(self._topp[slot])))

    def _emit_first_tokens(self, group, firsts) -> None:
        for (s, req), first in zip(group, firsts):
            if self.scheduler.active[s] is not req:
                continue   # an earlier emit's callback cancelled it
            self.generated[s] = [first]
            self._emit(req, first)
            if self.scheduler.active[s] is req:   # ... or a self-cancel
                self._maybe_complete(s, req)

    def _prefill_admitted(self, placed) -> None:
        """Group this round's admissions by bucket (``prefill_batch`` caps
        a group) and prefill each group in one forward."""
        jobs = [(s, req, _bucket_for(len(req.prompt), self.max_len))
                for s, req in placed]
        groups = group_admits(jobs, key_fn=lambda j: j[2],
                              max_batch=self.prefill_batch)
        for bucket, members in groups:
            group = [(s, req) for s, req, _ in members
                     if self.scheduler.active[s] is req]
            if group:      # empty when cancelled by a callback mid-round
                self._prefill_group(bucket, group)

    def _prefill_group(self, bucket: int, group) -> None:
        """One batch-n fp forward covering every request in ``group``; each
        request's first token samples from its own logits row and its KV
        rows scatter (quantize-on-insert) into its own slot."""
        n = _pow2_ceil(len(group))
        toks = np.zeros((n, bucket), np.int64)
        for i, (s, req) in enumerate(group):
            toks[i, :len(req.prompt)] = req.prompt
        t0 = self.clock()
        logits, pstate = self.prefill_forward(
            torch.as_tensor(toks, device=self.device))
        firsts, total = [], 0
        for i, (s, req) in enumerate(group):
            plen = len(req.prompt)
            total += plen
            firsts.append(self._sample_first(logits[i, plen - 1], s))
            self.kv.reset_slot(s)
            self.kv.insert_prefill(s, pstate, plen, bucket, row=i)
        self.metrics.record("prefill", self.clock() - t0, total)
        self._emit_first_tokens(group, firsts)

    # -------------------------------------------------------------- decode
    def _gen_steps(self) -> np.ndarray:
        """Per-slot index of the NEXT generated token (the sampling step),
        so token i of a request always draws from the same generator
        regardless of batch composition."""
        return np.array([len(self.generated[s]) for s in range(self.slots)],
                        np.int64)

    def decode_forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """One batched decode step over every slot: tokens (slots, 1) on
        the engine's device -> sampled ids (slots,) on that device. The
        slot cache is updated in place (idle slots' writes drop); nothing
        here waits for the device."""
        with torch.no_grad():
            logits, self.kv.state = model_api.forward(
                self.params, self.plan, state=self.kv.state, tokens=tokens)
            return sample_batch(logits[:, -1], self._seed, self._gen_steps(),
                                self._temp, self._topk, self._topp)

    def _decode_active(self) -> None:
        active = self.scheduler.active_slots()
        if not active:
            return
        toks = np.zeros((self.slots, 1), np.int64)
        for s in active:
            toks[s, 0] = self.generated[s][-1]
        t0 = self.clock()
        next_tok = self.decode_forward(
            torch.as_tensor(toks, device=self.device)).cpu().numpy()
        self.metrics.record("decode", self.clock() - t0, len(active))
        for s in active:
            req = self.scheduler.active[s]
            if req is None:    # freed mid-step by an on_token cancel()
                continue
            self.generated[s].append(int(next_tok[s]))
            self._emit(req, int(next_tok[s]))
            if self.scheduler.active[s] is req:   # ... or a self-cancel
                self._maybe_complete(s, req)

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
            if group:      # empty when cancelled by a callback mid-round
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
