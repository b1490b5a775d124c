"""Nibble helpers shared with the int4 matmul kernel.

Same byte layout as ``core/packing``: two int4 codes per byte along the
contracting (K) axis, biased by +7 into unsigned nibbles. The quantized
KV-cache helpers arrive with the decode serving slice.
"""
from __future__ import annotations

import torch

INT4_BIAS = 7  # maps [-7, 8] -> [0, 15]; mirrors core.packing.INT4_BIAS


def unpack_nibbles_rows(wp: torch.Tensor) -> torch.Tensor:
    """(K/2, N) uint8 -> (K, N) int8 in [-7, 8]; row 2i from the low nibble."""
    lo = (wp & 0xF).to(torch.int8) - INT4_BIAS
    hi = (wp >> 4).to(torch.int8) - INT4_BIAS
    kk, n = wp.shape
    return torch.stack([lo, hi], dim=1).reshape(kk * 2, n)
