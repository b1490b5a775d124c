"""Device timing and the least-time bound of a piece of work on one H100.

``cuda_ms`` times a callable between CUDA events, as a CUDA-graph replay
(the device time, without the host's launch gaps) or as the eager path
issues it. ``bound`` is the least time the card could take for the same
work: the larger of the bytes it must move over the memory rate and the
operations it does over the peak rate of their type (NVIDIA's data sheet,
SXM part, dense rates, at the full 700 W power limit).
"""
from __future__ import annotations

import statistics
from typing import Callable, Sequence, Union

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak
TF32_OPS_PER_S = 495e12        # dense TF32 tensor-core peak
FP32_OPS_PER_S = 67e12         # fp32 outside the tensor cores


def cuda_ms(fn: Callable[[], object], samples: int = 20, reps: int = 10,
            warmup: int = 3, graph: bool = True) -> float:
    """Median over ``samples`` of the mean time of ``reps`` back-to-back
    calls, between CUDA events. ``graph=True`` captures the ``reps`` calls
    in a CUDA graph and times its replay: the device time, without the
    host's launch overhead between calls; ``graph=False`` times the calls
    as the eager path issues them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if graph:
        # warm up on the capture stream too (library handles and workspaces
        # are per stream), then capture there
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            for _ in range(reps):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(reps):
                fn()
    times = []
    for _ in range(samples):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


Ops = Union[float, Sequence[float]]


def bound(nbytes: float, ops: Ops, peak_ops: Ops) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` over the
    memory rate and ``ops`` over ``peak_ops``. Work done at several rates
    (integer GEMMs beside fp32 attention) passes matching sequences, whose
    times add up."""
    if isinstance(ops, (int, float)):
        ops, peak_ops = (ops,), (peak_ops,)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(o / p for o, p in zip(ops, peak_ops))
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
