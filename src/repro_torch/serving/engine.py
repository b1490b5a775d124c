"""Serving engine: generation over a dense slot KV cache or a paged block
pool (decode mode), with shared-prefix KV reuse, and prefill-only classify /
embed / score (encoder mode).

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
* **paged KV** (``plan.kv_paging='paged'``, DESIGN.md §15): the slot cache
  is a refcounted block pool (``serving/block_pool.py``) under ONE byte
  budget (``kv_budget_bytes``, by default the bytes the dense layout would
  preallocate). A request admits only if its worst-case block need fits;
  prompt blocks are written once at prefill; ``n > 1`` samples share their
  full prompt blocks copy-on-write; each decode step attends straight from
  the pool through the slots' block tables (on the card, the paged
  decode-attention kernel) and writes each active slot's new row to its
  own block. Streams are byte-identical to the dense layout's.
* **shared prefix** (``plan.prefix_cache > 0``, DESIGN.md §11): the longest
  cached block-aligned prefix of a prompt is restored — quantized codes
  and scales copy directly, from the host ``PrefixCache`` on a dense
  engine, or by attaching the pool's resident blocks by reference on a
  paged one — and only the suffix is computed, one ``PREFIX_BLOCK`` chunk
  per forward, so the rows a cold run attends to are bit-equal to the rows
  a hit restores.
* **encoder mode** (a ``mode='encoder'`` plan over bert): admissions are
  grouped the same way and resolved by ONE bidirectional forward with
  per-row length masking; every request frees its slot inside the step
  that admits it.
* **decoder score** (``submit_encode(task='score')`` on a decode engine,
  DESIGN.md §14): the prompt's log-likelihood ``sum_i log p(t_i | t_<i)``
  from ONE batched, bucketed causal forward per (bucket, n) over a kv-16
  scratch state (the prefill forward). Score requests ride the same
  scheduler as generation traffic and resolve in the step that admits
  them, before that step's decode.

* **token mode** (``plan.prefill_mode='token'``, the JAX package's seed
  semantics and the only mode of the families without a KV slot cache):
  prompts are fed one token per batched step through ONE shared cursor
  over an fp decode state (the hybrid's Mamba2 states and shared-block KV,
  or a dense decoder's fp cache with a 0-d cursor). A slot emits once it
  has consumed its prompt. The cursor only advances, so admission is gated
  on the live cursor (``_token_fits``) and an idle engine whose cursor
  cannot fit the next request starts a fresh state at cursor 0. A request
  admitted into a freed slot resets only that slot's prompt position: the
  slot's recurrent state and the KV rows the earlier occupant and the idle
  steps wrote stay, as in the JAX engine. xLSTM's state is recurrent and
  holds no positions, so, as in the JAX engine, its requests are not held
  to ``max_len`` and its admission is not gated on the cursor. An encoder-decoder plan is
  refused: the JAX engine's step passes no encoder input and cannot serve
  it either (decode it through ``models.api.forward`` with
  ``decode_extra_inputs``).

* **tensor parallelism** (a ``tp > 1`` plan, DESIGN.md §16): one engine
  per rank, each over its rank's shard of the weights and
  ``num_kv_heads / tp`` heads of the KV state. Every rank is given the same
  requests in the same order; the sampler's inputs (embedding, lm_head,
  norms, residuals) are replicated and the row-parallel linears sum exact
  int32 partials, so every rank runs the same schedule and samples the same
  tokens as tp=1. Rank 0's streams are the ones a caller reports.

Greedy streams are ``argmax``; sampled ones draw from a per-request
generator seeded from (seed, token index), so a request's tokens depend on
(prompt, seed) only. ``last_step_tokens`` (prompt, decode and encode tokens
of the last ``engine_step``) is what the multi-tenant deficit round-robin
pays with.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..deploy import DeployedModel, ExecutionPlan
from ..kernels.kv_pack import kv_buffer_keys
from ..models import api as model_api
from ..models.bert import bert_encode, bert_pool
from .api import (GenerationRequest, SamplingParams, TokenStream,
                  sample_batch, sample_seed, sample_token)
from .block_pool import BlockPool, PagedKVCache, blocks_needed
from .clock import SYSTEM_CLOCK, Clock
from .encoder import EncodeHandle, EncodeRequest
from .kv_cache import SlotKVCache
from .metrics import ServeMetrics
from .prefix_cache import PREFIX_BLOCK, PrefixCache
from .scheduler import Scheduler, group_admits


def _bucket_for(plen: int, max_len: int, min_bucket: int = 8) -> int:
    b = min_bucket
    while b < plen:
        b *= 2
    return min(b, max_len)


def _pow2_ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _host_bits(t: torch.Tensor) -> np.ndarray:
    """A host copy for the prefix store; bf16 keeps its bits as int16."""
    t = t.cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


class ServingEngine:
    """Continuous-batching engine over a deployed quantized model.

    ``model`` is a :class:`DeployedModel` (plan included), or a raw params
    tree with ``plan`` passed explicitly. The engine runs where the params
    lie (a deployed model on the card serves on the card). ``max_queue``
    bounds the pending queue (``submit``/``submit_encode`` raise
    ``QueueFullError`` past it). ``kv_budget_bytes`` sizes the block pool
    of a ``kv_paging='paged'`` plan (default: the dense layout's bytes).
    ``metrics`` is the recorder the engine writes to (default: a fresh
    :class:`ServeMetrics` on the engine's clock); ``tenant`` labels every
    event it records (the multi-tenant rollups). A ``tp > 1`` plan needs
    this process to be one rank of a process group of ``tp`` ranks holding
    that rank's shard (``deploy`` / ``DeployedModel.load`` place it).
    """

    def __init__(self, model, plan: Optional[ExecutionPlan] = None, *,
                 slots: int = 8, max_len: int = 512,
                 max_queue: Optional[int] = None,
                 metrics: Optional[ServeMetrics] = None,
                 clock: Clock = SYSTEM_CLOCK,
                 tenant: Optional[str] = None,
                 kv_budget_bytes: Optional[int] = None):
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
        if plan.mode == "decode" and plan.cfg.family == "encdec":
            raise ValueError(
                f"{plan.cfg.name}: the serving engine cannot serve an "
                "encoder-decoder plan. Its token step feeds tokens only, and "
                "an encdec forward needs the encoder's input (src_embeds) or "
                "output (enc_out); the JAX package's engine has the same "
                "limit (its step passes neither, models/encdec.py:95). "
                "Decode it through models.api.forward with "
                "api.decode_state and api.decode_extra_inputs")
        self.plan = plan
        self.cfg = plan.cfg
        self.params = params
        self.device = params["embed"].device
        # a tp plan: this process must be one of the plan's ranks, and the
        # params this rank's shard (checked on one head-sharded leaf)
        if plan.make_group(self.device) is not None:
            attn, cfg = params["layers"][0]["attn"], self.cfg
            if "wqkv" in attn:      # q | k | v: the KV heads' share of its width
                kv = (attn["wqkv"]["s_w"].shape[-1] // cfg.hd * cfg.num_kv_heads
                      // (cfg.num_heads + 2 * cfg.num_kv_heads))
            else:
                kv = attn["wk"]["s_w"].shape[-1] // cfg.hd
            if kv != plan.kv_heads:
                raise ValueError(
                    f"tp={plan.tp}: the params hold {kv} KV "
                    f"heads a layer, a rank's shard holds {plan.kv_heads}; "
                    "place them with deploy() or DeployedModel.load(tp=...)")
        self.tenant = tenant                  # metrics label
        self.slots = slots
        self.max_len = max_len
        self.mode = plan.mode
        self.prefill_batch = max(1, plan.prefill_batch)
        self.default_sampling = SamplingParams.resolve(plan.default_sampling)
        # one clock for deadlines, wait stamps and step timings
        self.clock = clock
        self.scheduler = Scheduler(slots, max_queue=max_queue, clock=clock)
        self.metrics = (metrics if metrics is not None
                        else ServeMetrics(clock=clock))
        self.generated: list[list[int]] = [[] for _ in range(slots)]
        self._streams: dict = {}              # rid -> TokenStream|EncodeHandle
        self._events: list[tuple[int, int]] = []
        self._next_fork = 0
        # per-step work counters, reset by engine_step: the multi-tenant
        # deficit accounting reads the first, the load generator's
        # virtual-cost model the second
        self.last_step_tokens = 0
        self.last_step_encode_tokens = 0
        # per-slot sampling state, set at admit; the step index is the
        # slot's generated-token count
        self._seed = np.zeros(slots, np.int64)
        self._temp = np.zeros(slots, np.float32)
        self._topk = np.zeros(slots, np.int32)
        self._topp = np.ones(slots, np.float32)
        self.prefix_cache: Optional[PrefixCache] = None
        self._prefix_refs: dict[int, tuple] = {}   # rid -> pinned block keys
        # paged KV layout (DESIGN.md §15): plan.kv_paging='paged' routes the
        # slot cache through the refcounted block pool
        self.paged = plan.kv_paging == "paged"
        self.pool: Optional[BlockPool] = None
        self._prefix_on = False    # paged-mode prefix registry switch
        self._reserved = 0         # blocks reserved within one admit round
        if kv_budget_bytes is not None and not self.paged:
            raise ValueError(
                "kv_budget_bytes applies to kv_paging='paged' plans only "
                "(the dense layout preallocates slots*max_len rows)")
        self.token_mode = self.mode == "decode" and plan.prefill_mode == "token"
        if self.mode == "encoder":
            self.kv = None
        elif self.token_mode:
            self.kv = None
            self.state = plan.decode_state(slots, max_len, device=self.device)
            self.pos = np.zeros(slots, np.int64)   # per-slot prompt cursor
            self._cursor = 0   # host mirror of the shared token-mode cursor
        elif self.paged:
            if max_len % PREFIX_BLOCK:
                raise ValueError(
                    f"kv_paging='paged' needs max_len % {PREFIX_BLOCK} "
                    f"== 0 (block granularity), got {max_len}")
            if kv_budget_bytes is None:
                # dense-equivalent default: exactly the bytes the dense
                # layout would preallocate, so flipping kv_paging alone
                # changes the layout, never the capacity
                kv_budget_bytes = slots * (max_len // PREFIX_BLOCK) * \
                    BlockPool.block_bytes(self.cfg, plan.kv_bits,
                                          plan.torch_dtype)
            self.pool = BlockPool(self.cfg, kv_budget_bytes,
                                  dtype=plan.torch_dtype, kv_bits=plan.kv_bits,
                                  device=self.device, tp=plan.tp)
            self.kv = PagedKVCache(self.pool, slots, max_len)
            # plan.prefix_cache > 0 switches prefix reuse on; the BYTE value
            # is absorbed by the pool budget (the registry shares the pool's
            # blocks instead of owning a second store)
            self._prefix_on = plan.prefix_cache > 0
        else:
            self.kv = SlotKVCache.from_plan(plan, slots, max_len,
                                            device=self.device)
            if plan.prefix_cache:
                self.prefix_cache = PrefixCache(plan.prefix_cache)

    # ------------------------------------------------------------------ API
    def submit(self, req: GenerationRequest, *,
               on_token: Optional[Callable[[int, int], None]] = None):
        """Validate + enqueue; returns the request's :class:`TokenStream`.
        Malformed requests are rejected here, before any KV row is written;
        on a paged engine, so is a request whose worst-case block need
        exceeds the whole pool.

        ``sampling.n > 1`` fans out into ``n`` child requests (sample ``i``
        decodes with seed ``sample_seed(seed, i)``) and returns a LIST of
        ``n`` streams. On a paged engine the children share the prompt's KV
        blocks copy-on-write; on a dense engine they expand into plain
        slots — the streams are identical either way. A ``QueueFullError``
        mid-fanout propagates; children already enqueued stay queued."""
        if self.mode == "encoder":
            raise ValueError(
                "this engine serves a mode='encoder' plan: no decode loop "
                "exists; submit EncodeRequests via submit_encode")
        self.scheduler.assign_id(req)      # so rejections carry a real rid
        plen = len(req.prompt)
        if plen <= 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if plen + req.max_new_tokens > self.max_len and \
                self.cfg.family != "xlstm":
            # past max_len the cache writes drop: decode would keep emitting
            # tokens that cannot see recent context. (xLSTM's state is
            # recurrent: no positional cache to overflow. Token mode's
            # shared cursor also gates admission on the live cursor:
            # _token_fits.)
            raise ValueError(
                f"request {req.rid}: prompt ({plen}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds engine max_len "
                f"({self.max_len})")
        if self.paged:
            need = blocks_needed(plen, req.max_new_tokens)
            if need > self.pool.num_blocks:
                raise ValueError(
                    f"request {req.rid}: needs {need} KV blocks but the "
                    f"pool budget holds {self.pool.num_blocks} total — "
                    "raise kv_budget_bytes or shrink the request")
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
        """Enqueue a prefill-only request; the result lands on the
        returned :class:`EncodeHandle`. An encoder plan serves classify /
        embed / score from its heads; a decode engine serves ``score``
        only (the prompt's log-likelihood through the batched bucketed
        prefill forward), interleaved with its generation traffic."""
        self.scheduler.assign_id(req)      # so rejections carry a real rid
        plen = len(req.tokens)
        if plen <= 0:
            raise ValueError(f"request {req.rid}: empty input")
        if plen > self.max_len:
            raise ValueError(
                f"request {req.rid}: input ({plen}) exceeds engine max_len "
                f"({self.max_len})")
        if self.mode == "encoder":
            needs = ("classifier",) if req.task in ("classify", "score") \
                else ("pooler",)
            for head in needs:
                if head not in self.params:
                    raise ValueError(
                        f"request {req.rid}: task={req.task!r} needs a "
                        f"{head!r} head the deployed artifact does not have")
        else:
            if self.plan.prefill_mode != "chunked":
                raise ValueError(
                    f"request {req.rid}: token-mode engines feed prompts "
                    "through a shared cursor and cannot serve prefill-only "
                    "requests")
            if req.task != "score":
                raise ValueError(
                    f"request {req.rid}: a decoder artifact serves only "
                    f"task='score' (prompt log-likelihood), got "
                    f"{req.task!r}")
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
        at once (its KV rows zeroed, or its pool blocks released, and its
        cursor rewound); tokens already generated stay on ``req.out``.
        False when ``rid`` is unknown or already finished."""
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
        (decode mode), one batched token step (token mode) or one batched
        encode per group (encoder mode). Returns the ``(rid, token)`` pairs
        emitted this step."""
        self._events = []
        self.last_step_tokens = 0
        self.last_step_encode_tokens = 0
        if self.token_mode:
            self._token_step()
        else:
            self._slot_step()
        for req in self.scheduler.pop_shed():
            self._finalize_unslotted(req, "shed")
        if self.paged:
            self.metrics.update_kv(self.pool.stats())
        return self._events

    def _slot_step(self) -> None:
        fits = None
        if self.paged:
            # ONE byte budget drives admission: reservations are per round
            # (prefill below turns them into real allocations)
            self._reserved = 0
            fits = self._paged_fits
        placed = self._admit(fits)
        # encode and generation traffic arrive through one admit round:
        # encode jobs resolve at once (freeing their slots), then the
        # generation jobs prefill and join the decode batch below
        enc = [(s, r) for s, r in placed if isinstance(r, EncodeRequest)]
        gen = [(s, r) for s, r in placed if not isinstance(r, EncodeRequest)]
        if enc:
            self._encode_admitted(enc)
        if gen:
            self._prefill_admitted(gen)
        if self.mode == "decode":
            self._decode_active()

    # ------------------------------------------------------------ lifecycle
    def _admit(self, fits: Optional[Callable] = None) -> list:
        """Scheduler admit (``fits``: the paged engine's budget predicate) +
        per-slot sampling state + queue-wait metric. Clears the slot's
        stale token tally up front."""
        placed = self.scheduler.admit(fits=fits)
        for s, req in placed:
            self.generated[s] = []
            sp = getattr(req, "sampling", None)  # EncodeRequests don't sample
            if sp is not None:
                self._seed[s] = sp.seed & 0x7FFFFFFF
                self._temp[s] = sp.temperature
                self._topk[s] = sp.top_k
                self._topp[s] = sp.top_p
            if req.queue_wait_s is not None:
                self.metrics.record_wait("queue_wait", req.queue_wait_s,
                                         tenant=self.tenant)
        return placed

    def _emit(self, req: GenerationRequest, token: int) -> None:
        if req.first_token_t is None:
            req.first_token_t = self.clock()
            if req.ttft_s is not None:
                self.metrics.record_wait("ttft", req.ttft_s,
                                         tenant=self.tenant)
        stream = self._streams.get(req.rid)
        if stream is not None:
            stream._push(token)
        self._events.append((req.rid, token))

    def _close_stream(self, req) -> None:
        handle = self._streams.pop(req.rid, None)
        if handle is not None:
            handle._finish()

    def _release_prefix(self, req) -> None:
        keys = self._prefix_refs.pop(req.rid, None)
        if keys and self.prefix_cache is not None:
            self.prefix_cache.release(keys)

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
        self._release_prefix(req)
        self._close_stream(req)

    def _finalize_slotted(self, slot: int, req, reason: str) -> None:
        """The one exit path for slotted requests (length/stop/cancel):
        output truncated to the request's own ``max_new_tokens``, slot
        returned to the scheduler, prefix pins and pool blocks released,
        stream closed."""
        if not isinstance(req, EncodeRequest):
            req.out = np.array(self.generated[slot][:req.max_new_tokens],
                               np.int32)
        if self.paged:
            # drop every block reference the request holds (shared blocks
            # survive under their other holders / the prefix registry)
            self.kv.release_slot(slot)
        req.finish_reason = reason
        req.finish_t = self.clock()
        self.scheduler.complete(slot)
        self._release_prefix(req)
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

    def chunk_forward(self, state: dict, tokens: torch.Tensor):
        """One prefix-block forward over a plan-precision scratch cache
        (``plan.decode_state(n, S)``, a 0-d cursor): the (n, block) tokens
        attend the quantized rows of every earlier block (exactly what a
        prefix hit restores) and fp rows within their own block; their rows
        quantize on append. Returns (logits, the advanced scratch)."""
        with torch.no_grad():
            return model_api.forward(self.params, self.plan, state=state,
                                     tokens=tokens)

    def _prefill_admitted(self, placed) -> None:
        """Group this round's admissions and prefill each group in one
        forward. The group key is (bucket, prefix-hit length, prefix block
        keys): same-bucket requests sharing a cached prefix (or sharing
        none) batch together; ``prefill_batch`` caps the group size."""
        jobs = []
        for s, req in placed:
            plen = len(req.prompt)
            bucket = _bucket_for(plen, self.max_len)
            m, keys = 0, ()
            if self.paged:
                self.kv.open_slot(s, req.rid)
                if self._prefix_on:
                    # registry hit: attach resident blocks BY REFERENCE —
                    # refcount++ pins them, no row copy ever happens
                    m, ids = self.pool.match(req.prompt)
                    if m:
                        self.pool.attach(req.rid, ids)
                        self.kv.extend_table(s, ids)
                    keys = tuple(ids)
                    self.metrics.record_prefix(m, plen)
            elif self.prefix_cache is not None:
                m, keys = self.prefix_cache.match(req.prompt)
                self._prefix_refs[req.rid] = keys
                self.metrics.record_prefix(m, plen)
            jobs.append((s, req, bucket, m, keys))
        groups = group_admits(jobs, key_fn=lambda j: (j[2], j[3], j[4]),
                              max_batch=self.prefill_batch)
        blocks_path = (self._prefix_on if self.paged
                       else self.prefix_cache is not None)
        for (bucket, m, keys), members in groups:
            group = [(s, req) for s, req, *_ in members
                     if self.scheduler.active[s] is req]
            if not group:      # cancelled by a callback mid-round
                continue
            if blocks_path:
                self._prefill_group_blocks(bucket, m, keys, group)
            else:
                self._prefill_group(bucket, group)

    def _prefill_group(self, bucket: int, group) -> None:
        """One batch-n fp forward covering every request in ``group``; each
        request's first token samples from its own logits row and its KV
        rows scatter (quantize-on-insert) into its own slot or blocks."""
        n = _pow2_ceil(len(group))
        toks = np.zeros((n, bucket), np.int64)
        for i, (s, req) in enumerate(group):
            toks[i, :len(req.prompt)] = req.prompt
        t0 = self.clock()
        logits, pstate = self.prefill_forward(
            torch.as_tensor(toks, device=self.device))
        firsts, total = [], 0
        fork_leaders: dict = {}
        for i, (s, req) in enumerate(group):
            plen = len(req.prompt)
            total += plen
            firsts.append(self._sample_first(logits[i, plen - 1], s))
            if self.paged:
                self._paged_insert_fp(s, req, pstate, i, fork_leaders)
            else:
                self.kv.reset_slot(s)
                self.kv.insert_prefill(s, pstate, plen, bucket, row=i)
        self.metrics.record("prefill", self.clock() - t0, total,
                            tenant=self.tenant)
        self.last_step_tokens += total
        self._emit_first_tokens(group, firsts)

    def _prefill_group_blocks(self, bucket: int, m: int, keys, group) -> None:
        """Prefix-reuse prefill (DESIGN.md §11): restore the ``m`` cached
        prefix tokens (codes + scales copy straight into the scratch cache,
        no requantization) and compute only the suffix, one prefix block per
        forward so hit and cold runs attend bit-identical rows.

        Serves both layouts: dense restores host rows from the PrefixCache
        store; paged gathers the resident pool blocks on the device (the
        same values: the pool's blocks hold exactly the rows a dense publish
        would have copied out)."""
        B = self.pool.block if self.paged else self.prefix_cache.block
        n = _pow2_ceil(len(group))
        t0 = self.clock()
        # scratch capacity on the BLOCK grid: a bucket capped at a
        # non-multiple-of-B max_len would make the last chunk's write run
        # past the buffer. Rounding up keeps every chunk write in bounds;
        # the slot insert below copies only the first min(S, max_len) rows.
        S = -(-bucket // B) * B
        state = self.plan.decode_state(n, S, device=self.device)
        if m:
            if self.paged:
                rows = self.pool.gather_rows(list(keys))
            else:
                # host rows hold raw bits (bf16 has no numpy dtype)
                rows = {key: torch.as_tensor(val, device=self.device).view(
                            state[key].dtype)
                        for key, val in self.prefix_cache.gather(keys).items()}
            for key, val in rows.items():
                state[key][:, :, :m] = val[:, None]
            state["len"] = torch.tensor(m, dtype=torch.int32,
                                        device=self.device)
        max_plen = max(len(req.prompt) for _, req in group)
        n_chunks = -(-(max_plen - m) // B)
        toks = np.zeros((n, n_chunks * B), np.int64)
        for i, (s, req) in enumerate(group):
            toks[i, :len(req.prompt) - m] = req.prompt[m:]
        toks = torch.as_tensor(toks, device=self.device)
        first_logits = [None] * len(group)
        for c in range(n_chunks):
            logits, state = self.chunk_forward(state, toks[:, c * B:(c + 1) * B])
            for i, (s, req) in enumerate(group):
                ci, pi = divmod(len(req.prompt) - 1 - m, B)
                if ci == c:    # this chunk holds the request's last token
                    first_logits[i] = logits[i, pi]
        firsts, total = [], 0
        copy = min(S, self.max_len)     # slot rows past plen stay masked
        fork_leaders: dict = {}
        for i, (s, req) in enumerate(group):
            plen = len(req.prompt)
            total += plen - m
            firsts.append(self._sample_first(first_logits[i], s))
            if self.paged:
                self._paged_insert_state(s, req, state, i, m, fork_leaders)
                self._paged_publish(req)
            else:
                self.kv.reset_slot(s)
                self.kv.insert_rows(s, state, plen, copy, row=i)
                self._publish_prefix(req, m, state, i)
        self.metrics.record("prefill", self.clock() - t0, total,
                            tenant=self.tenant)
        self.last_step_tokens += total
        self._emit_first_tokens(group, firsts)

    def _publish_prefix(self, req, m: int, state: dict, row: int) -> None:
        """Insert the request's newly computed full blocks into the prefix
        cache (lazy device→host copy: hits never pay it)."""
        plen = len(req.prompt)
        upto = (plen // self.prefix_cache.block) * self.prefix_cache.block
        if upto <= m:
            return
        buf_keys = kv_buffer_keys(self.kv.kv_bits)
        host: dict = {}

        def rows_for_block(lo, hi):
            if not host:
                host.update({key: _host_bits(state[key][:, row])
                             for key in buf_keys})
            return {key: host[key][:, lo:hi].copy() for key in buf_keys}

        self.prefix_cache.insert(req.prompt, upto, rows_for_block)

    # --------------------------------------------------------------- paged
    def _paged_fits(self, req) -> bool:
        """Admission predicate (DESIGN.md §15): a request admits only if
        its WORST-CASE block need — every prompt + generated token, whole
        blocks — fits in free + evictable pool blocks, minus what this
        round's earlier admissions already reserved. Prefix hits only ever
        reduce the blocks actually allocated, so a reservation can never be
        exceeded. Encode requests retain no KV and always fit."""
        if isinstance(req, EncodeRequest):
            return True
        need = blocks_needed(len(req.prompt), req.max_new_tokens)
        if self.pool.available() - self._reserved < need:
            return False
        self._reserved += need
        return True

    def _fork_share(self, slot: int, req, fork_leaders: dict, lo: int,
                    nb_full: int) -> int:
        """Copy-on-write fork bookkeeping for one prefill-group member.

        The first member of a fork group in this prefill group is the
        leader (recorded); later members attach the leader's FULL prompt
        blocks ``[lo, nb_full)`` by reference and only write their own tail
        block + decode blocks — prompt KV is stored once per group, decode
        divergence stays private. (Fork members split across prefill groups
        fall back to private blocks here; with the prefix registry on they
        still converge to shared blocks via ``match`` on later arrivals.)
        Returns the first block index this member must WRITE itself."""
        if req.fork_group is None:
            return lo
        leader = fork_leaders.get(req.fork_group)
        if leader is None or leader[1] != len(req.prompt):
            fork_leaders[req.fork_group] = (slot, len(req.prompt))
            return lo
        share = self.kv.block_ids(leader[0])[lo:nb_full]
        if not share:
            return lo
        self.pool.attach(req.rid, share)
        self.kv.extend_table(slot, share)
        self.pool.cow_forks += 1
        return nb_full

    def _paged_insert_fp(self, slot: int, req, pstate: dict, row: int,
                         fork_leaders: dict) -> None:
        """Paged analogue of ``insert_prefill``: allocate the request's
        worst-case block need up front (admission already reserved it) and
        write the prompt blocks from the fp prefill row, quantize-on-insert
        at kv_bits < 16. Decode blocks are allocated NOW and written by the
        decode steps — a request can never run out of KV mid-decode."""
        B = self.pool.block
        plen = len(req.prompt)
        nb_full, nb_fill = plen // B, -(-plen // B)
        start = self._fork_share(slot, req, fork_leaders, 0, nb_full)
        own = self.pool.alloc(req.rid,
                              blocks_needed(plen, req.max_new_tokens) - start)
        self.kv.extend_table(slot, own)
        write_n = nb_fill - start
        if write_n:
            self.kv.write_fp_blocks(own[:write_n], pstate, row, start, write_n)
        self.kv.set_length(slot, plen)

    def _paged_insert_state(self, slot: int, req, state: dict, row: int,
                            m: int, fork_leaders: dict) -> None:
        """Paged analogue of ``insert_rows`` (the prefix-chunked path):
        blocks ``[0, m/B)`` are already attached by reference, so only the
        computed-suffix blocks copy out of the plan-precision scratch —
        same precision, no requantization."""
        B = self.pool.block
        plen = len(req.prompt)
        nb_full, nb_fill = plen // B, -(-plen // B)
        start = self._fork_share(slot, req, fork_leaders, m // B, nb_full)
        own = self.pool.alloc(req.rid,
                              blocks_needed(plen, req.max_new_tokens) - start)
        self.kv.extend_table(slot, own)
        write_n = nb_fill - start
        if write_n:
            self.kv.write_state_blocks(own[:write_n], state, row, start * B,
                                       write_n)
        self.kv.set_length(slot, plen)

    def _paged_publish(self, req) -> None:
        """Register the request's full prompt blocks in the pool's prefix
        registry (pure bookkeeping — the blocks ARE the cache; no device→
        host copy)."""
        plen = len(req.prompt)
        upto = (plen // self.pool.block) * self.pool.block
        if upto:
            self.pool.publish(req.rid, req.prompt, upto)

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
        slot cache is updated in place (idle slots' writes drop) and the
        cursors advance; nothing here waits for the device. A paged engine
        uploads the host's tables, cursors and write targets and attends
        straight from the pool (``PagedKVCache.decode_state``)."""
        with torch.no_grad():
            if self.token_mode:
                logits, self.state = model_api.forward(
                    self.params, self.plan, state=self.state, tokens=tokens)
            elif self.paged:
                active = self.scheduler.active_slots()
                logits, _ = model_api.forward(
                    self.params, self.plan,
                    state=self.kv.decode_state(active), tokens=tokens)
                self.kv.advance(active)
            else:
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
        self.metrics.record("decode", self.clock() - t0, len(active),
                            tenant=self.tenant)
        self.last_step_tokens += len(active)
        for s in active:
            req = self.scheduler.active[s]
            if req is None:    # freed mid-step by an on_token cancel()
                continue
            self.generated[s].append(int(next_tok[s]))
            self._emit(req, int(next_tok[s]))
            if self.scheduler.active[s] is req:   # ... or a self-cancel
                self._maybe_complete(s, req)

    # --------------------------------------------------------------- token
    def _token_fits(self, req) -> bool:
        """Token mode shares ONE cursor across slots: a request admitted at
        cursor c takes positions [c, c + plen + max_new), so it fits iff
        that span ends inside max_len."""
        return (self._cursor + len(req.prompt) + req.max_new_tokens
                <= self.max_len)

    def _token_step(self) -> None:
        """The JAX engine's token step: prompts fed one token per batched
        step at the shared cursor, every slot in the batch (an idle slot
        feeds token 0). The cursor only advances, so admission is gated on
        the live cursor, and an idle engine whose cursor cannot fit the next
        request takes a fresh decode state at cursor 0 instead of admitting
        work whose writes would fall past max_len. An admitted request
        resets only its slot's prompt position (``pos``), as JAX does: the
        slot's recurrent state and KV rows carry over. xLSTM's state is
        recurrent and holds no positions: nothing gates its admission and
        its cursor cannot run out, as in the JAX engine."""
        fits = None
        recurrent = self.cfg.family == "xlstm"
        if not recurrent:
            fits = self._token_fits
            head = self.scheduler.peek()
            if (head is not None and self.scheduler.num_active == 0
                    and self._cursor > 0 and not fits(head)):
                # drained but the cursor is spent: fresh state, cursor 0;
                # submit() guarantees every queued request fits from there
                self.state = self.plan.decode_state(self.slots, self.max_len,
                                                    device=self.device)
                self._cursor = 0
        for s, _req in self._admit(fits=fits):
            self.pos[s] = 0
        active = self.scheduler.active_slots()
        if not active:
            return
        if not recurrent and self._cursor >= self.max_len:
            raise RuntimeError(
                f"token-mode cache cursor exhausted mid-flight (cursor "
                f"{self._cursor} >= max_len {self.max_len}) with "
                f"{len(active)} active request(s): admission gating should "
                "have prevented this")
        toks = np.zeros((self.slots, 1), np.int64)
        for s in active:
            req = self.scheduler.active[s]
            if self.pos[s] < len(req.prompt):      # still feeding the prompt
                toks[s, 0] = req.prompt[self.pos[s]]
            else:                                  # submit() bans empty
                toks[s, 0] = self.generated[s][-1]  # prompts: always filled
        t0 = self.clock()
        next_tok = self.decode_forward(
            torch.as_tensor(toks, device=self.device)).cpu().numpy()
        self._cursor += 1
        # a slot emits a generated token this step once it has consumed its
        # last prompt token, i.e. pos >= plen - 1 before the increment
        n_decoding = sum(
            int(self.pos[s] >= len(self.scheduler.active[s].prompt) - 1)
            for s in active)
        self.metrics.record("decode", self.clock() - t0, n_decoding,
                            tenant=self.tenant)
        self.last_step_tokens += len(active)
        for s in active:
            req = self.scheduler.active[s]
            if req is None:    # freed mid-step by an on_token cancel()
                continue
            self.pos[s] += 1
            if self.pos[s] >= len(req.prompt):
                self.generated[s].append(int(next_tok[s]))
                self._emit(req, int(next_tok[s]))
                if self.scheduler.active[s] is req:   # ... or a self-cancel
                    self._maybe_complete(s, req)

    # -------------------------------------------------------------- encode
    def encode_batch(self, tokens, lengths) -> dict[str, torch.Tensor]:
        """One forward over a padded (n, bucket) batch with per-row
        ``lengths``. Encoder plans run the bidirectional stack and return
        every head the artifact carries; decode plans return ``score``, the
        prompt's log-likelihood (``score_batch``)."""
        if self.mode == "decode":
            return {"score": self.score_batch(tokens, lengths)}
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

    def score_batch(self, tokens, lengths) -> torch.Tensor:
        """The decoder ``score`` task: ``sum_{i>=1} log p(t_i | t_<i)`` of
        each row's first ``lengths[i]`` tokens, from the causal prefill
        forward over a kv-16 scratch state (padded tails sit after every
        real token, so they change nothing a real token attends to)."""
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        lengths = torch.as_tensor(lengths, device=self.device)
        logits, _ = self.prefill_forward(tokens)
        with torch.no_grad():
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            ll = torch.gather(logp[:, :-1], -1, tokens[:, 1:, None])[..., 0]
            pos = torch.arange(1, tokens.shape[1], device=self.device)
            mask = pos[None, :] < lengths[:, None]
            return torch.where(mask, ll, torch.zeros_like(ll)).sum(dim=1)

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
        self.metrics.record("encode", self.clock() - t0, total,
                            tenant=self.tenant)
        self.last_step_encode_tokens += total
        self.last_step_tokens += total
        for i, (s, req) in enumerate(group):
            if self.scheduler.active[s] is not req:
                continue   # an earlier on_result callback cancelled it
            req.result = out[req.task][i]
            self._finalize_slotted(s, req, "done")
            if req.latency_s is not None:
                self.metrics.record_wait("encode_latency", req.latency_s,
                                         tenant=self.tenant)
