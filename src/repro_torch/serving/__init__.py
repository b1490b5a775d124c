"""Serving of the port: the scheduler, clock, metrics, the generation and
encode request surfaces, the slot KV cache, the paged block pool, the
shared-prefix cache, the engine (decode and encoder modes, the decoder
``score`` task) and the trace-driven load generator (``loadgen``)."""
from .api import (FINISH_REASONS, GenerationRequest, GenerationResult,
                  QueueFullError, SamplingParams, TokenStream, sample_batch,
                  sample_seed, sample_token)
from .block_pool import BlockPool, PagedKVCache, blocks_needed
from .clock import SYSTEM_CLOCK, Clock, VirtualClock
from .encoder import ENCODE_TASKS, EncodeHandle, EncodeRequest, EncodeResult
from .engine import ServingEngine
from .kv_cache import SlotKVCache
from .loadgen import (SLO, Arrival, LoadResult, VirtualCost, Workload,
                      bootstrap_summary, make_arrivals, run_load, run_trials,
                      trace_arrivals)
from .metrics import ServeMetrics
from .prefix_cache import PREFIX_BLOCK, PrefixCache
from .scheduler import Scheduler

__all__ = ["Arrival", "BlockPool", "Clock", "ENCODE_TASKS", "EncodeHandle",
           "EncodeRequest", "EncodeResult", "FINISH_REASONS",
           "GenerationRequest", "GenerationResult", "LoadResult",
           "PREFIX_BLOCK", "PagedKVCache", "PrefixCache", "QueueFullError",
           "SLO", "SYSTEM_CLOCK", "SamplingParams", "Scheduler",
           "ServeMetrics", "ServingEngine", "SlotKVCache", "TokenStream",
           "VirtualClock", "VirtualCost", "Workload", "blocks_needed",
           "bootstrap_summary", "make_arrivals", "run_load", "run_trials",
           "sample_batch", "sample_seed", "sample_token", "trace_arrivals"]
