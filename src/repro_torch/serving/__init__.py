"""Serving of the port: the scheduler, clock, metrics, the generation and
encode request surfaces, the slot KV cache and the engine (decode and
encoder modes)."""
from .api import (FINISH_REASONS, GenerationRequest, GenerationResult,
                  QueueFullError, SamplingParams, TokenStream, sample_batch,
                  sample_seed, sample_token)
from .clock import SYSTEM_CLOCK, Clock, VirtualClock
from .encoder import ENCODE_TASKS, EncodeHandle, EncodeRequest, EncodeResult
from .engine import ServingEngine
from .kv_cache import SlotKVCache
from .metrics import ServeMetrics
from .scheduler import Scheduler

__all__ = ["Clock", "ENCODE_TASKS", "EncodeHandle", "EncodeRequest",
           "EncodeResult", "FINISH_REASONS", "GenerationRequest",
           "GenerationResult", "QueueFullError", "SYSTEM_CLOCK",
           "SamplingParams", "Scheduler", "ServeMetrics", "ServingEngine",
           "SlotKVCache", "TokenStream", "VirtualClock", "sample_batch",
           "sample_seed", "sample_token"]
