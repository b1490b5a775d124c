"""int4 nibble packing and deploy-time weight quantization.

Values live in the paper's k=4 grid [-7, 8], stored biased by +7 into
unsigned nibbles [0, 15], two per byte along the contracting (K) axis:

    packed[k, n] = (code[2k, n] & 0xF) | (code[2k+1, n] << 4)

so a (K, N) int-code matrix becomes a (K/2, N) uint8 matrix. The Hopper
int4 kernel unpacks the nibbles in shared memory and feeds the int8 tensor
cores (Hopper has no int4 rate).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .quantizer import quantize_to_int

INT4_BIAS = 7  # maps [-7, 8] -> [0, 15]


def pack_int4(codes: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Pack int4 codes (int8 carrier, values in [-7, 8]) into uint8 nibbles.

    ``axis`` is the packing axis (must have even extent; pad beforehand).
    """
    axis = axis % codes.dim()
    if codes.shape[axis] % 2 != 0:
        raise ValueError(f"pack axis extent must be even, got {codes.shape[axis]}")
    biased = (codes.to(torch.int32) + INT4_BIAS).to(torch.uint8)
    even = [slice(None)] * codes.dim()
    odd = list(even)
    even[axis], odd[axis] = slice(0, None, 2), slice(1, None, 2)
    lo, hi = biased[tuple(even)], biased[tuple(odd)]
    return (lo | (hi << 4)).contiguous()


def unpack_int4(packed: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_int4`; returns int8 codes in [-7, 8]."""
    axis = axis % packed.dim()
    lo = (packed & 0xF).to(torch.int8) - INT4_BIAS
    hi = (packed >> 4).to(torch.int8) - INT4_BIAS
    stacked = torch.stack([lo, hi], dim=axis + 1)  # (..., K/2, 2, ...)
    new_shape = list(packed.shape)
    new_shape[axis] = packed.shape[axis] * 2
    return stacked.reshape(new_shape)


def quantize_weight(w: torch.Tensor, s: torch.Tensor, bits: int,
                    pack_axis: Optional[int] = -2):
    """Quantize one weight for deployment. Returns (codes_or_packed, s).

    ``w`` is (..., K, N) with per-out-channel scales (..., 1, N) or scalar.
    bits=4 packs along K = axis -2 (pads K to even); bits=8 stores int8.
    Leading dims cover stacked layers.
    """
    codes = quantize_to_int(w, s, bits)
    if bits == 4 and pack_axis is not None:
        axis = pack_axis % codes.dim()
        if codes.shape[axis] % 2 != 0:
            # F.pad lists (before, after) pairs from the LAST axis backwards
            pad = [0, 0] * (codes.dim() - 1 - axis) + [0, 1]
            codes = F.pad(codes, pad)
        return pack_int4(codes, axis=axis), s
    return codes, s
