"""Encoder serving of the port: the scheduler, clock, metrics and encode
request surface copied from the JAX package, and the encoder mode of the
engine."""
from .api import QueueFullError
from .clock import SYSTEM_CLOCK, Clock, VirtualClock
from .encoder import ENCODE_TASKS, EncodeHandle, EncodeRequest, EncodeResult
from .engine import ServingEngine
from .metrics import ServeMetrics
from .scheduler import Scheduler

__all__ = ["Clock", "ENCODE_TASKS", "EncodeHandle", "EncodeRequest",
           "EncodeResult", "QueueFullError", "SYSTEM_CLOCK", "Scheduler",
           "ServeMetrics", "ServingEngine", "VirtualClock"]
