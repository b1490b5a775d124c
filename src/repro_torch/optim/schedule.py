"""LR schedules. Paper §5.2: grow linearly for 10% of steps, decay to 0."""
from __future__ import annotations

import torch


def linear_warmup_decay(total_steps: int, warmup_frac: float = 0.10):
    """``fn(step)`` -> the LR multiplier, a 0-d f32 tensor on the step's
    device."""
    warmup = max(1, int(total_steps * warmup_frac))

    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        # tensor divisors: the IEEE division the reference performs
        div = lambda v: torch.full((), float(v), dtype=torch.float32, device=s.device)
        up = s / div(warmup)
        down = (total_steps - s) / div(max(1, total_steps - warmup))
        return torch.clamp(torch.minimum(up, down), 0.0, 1.0)

    return fn
