"""KV-cache quantization and nibble helpers shared with the kernels.

The serving KV cache stores K/V as integer codes with per-head, per-token
scales:

    codes[..., h, :] = round(x[..., h, :] / s[..., h])    s = amax_hd(|x|) / qmax

* ``kv_bits=8``: int8 codes on the symmetric [-127, 127] grid.
* ``kv_bits=4``: the paper's k=4 grid clamped symmetric to [-7, 7] and packed
  two codes per byte along head_dim (bias +7 into unsigned nibbles, the byte
  layout of the int4 weight packing in ``core/packing``; only the packing
  axis differs: head_dim here, the contracting K axis there).

``torch.round`` rounds half to even as ``jnp.round`` does, so codes and
scales are bit-equal to the JAX package's. Per-token scales mean that
appending one decode step's K/V never touches another row's scale.
"""
from __future__ import annotations

import torch

INT4_BIAS = 7  # maps [-7, 8] -> [0, 15]; mirrors core.packing.INT4_BIAS


def kv_qmax(bits: int) -> int:
    """Symmetric clamp bound: 127 for int8, 7 for int4."""
    if bits == 8:
        return 127
    if bits == 4:
        return 7
    raise ValueError(f"kv_bits must be 4 or 8, got {bits}")


def unpack_nibbles_rows(wp: torch.Tensor) -> torch.Tensor:
    """(K/2, N) uint8 -> (K, N) int8 in [-7, 8]; row 2i from the low nibble."""
    lo = (wp & 0xF).to(torch.int8) - INT4_BIAS
    hi = (wp >> 4).to(torch.int8) - INT4_BIAS
    kk, n = wp.shape
    return torch.stack([lo, hi], dim=1).reshape(kk * 2, n)


def pack_nibbles_last(codes: torch.Tensor) -> torch.Tensor:
    """(..., d) int codes in [-7, 8] -> (..., d/2) uint8; element 2i in the
    low nibble. ``d`` must be even."""
    d = codes.shape[-1]
    if d % 2:
        raise ValueError(f"pack axis extent must be even, got {d}")
    biased = (codes.to(torch.int32) + INT4_BIAS).to(torch.uint8)
    return biased[..., 0::2] | (biased[..., 1::2] << 4)


def unpack_nibbles_last(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles_last`: (..., d/2) uint8 -> (..., d) int8."""
    lo = (packed & 0xF).to(torch.int8) - INT4_BIAS
    hi = (packed >> 4).to(torch.int8) - INT4_BIAS
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1],
                                                 packed.shape[-1] * 2)


def quantize_kv(x: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize K or V rows with per-head, per-token scales.

    x: (..., H, hd) float -> (codes, scales) with codes (..., H, hd) int8
    for bits=8 or (..., H, hd/2) uint8 packed nibbles for bits=4, and
    scales (..., H) f32 = amax over head_dim / qmax, floored at 1e-8 so
    all-zero rows (cache padding) quantize to exact zeros.
    """
    qmax = kv_qmax(bits)
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    # tensor divisors: PyTorch turns a Python-float divisor on the card into
    # a multiply by its reciprocal, which is not the reference's division
    scales = torch.clamp_min(amax / torch.full((), float(qmax), device=x.device),
                             1e-8)
    codes = torch.clamp(torch.round(xf / scales[..., None]), -qmax, qmax
                        ).to(torch.int8)
    if bits == 4:
        return pack_nibbles_last(codes), scales
    return codes, scales


def dequantize_kv(codes: torch.Tensor, scales: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(codes, scales) -> (..., H, hd) float. The code dtype carries the bit
    width: uint8 rows are packed int4 nibbles, int8 rows are bare codes."""
    if codes.dtype == torch.uint8:
        codes = unpack_nibbles_last(codes)
    return (codes.to(torch.float32) * scales[..., None]).to(dtype)


def kv_code_shape(hd: int, bits: int) -> int:
    """Trailing (head_dim) extent of the code buffer for one K/V row."""
    if bits == 4:
        if hd % 2:
            raise ValueError(f"int4 KV packing needs even head_dim, got {hd}")
        return hd // 2
    return hd


def kv_code_dtype(bits: int) -> torch.dtype:
    return torch.uint8 if bits == 4 else torch.int8


def kv_buffer_keys(bits: int) -> tuple[str, ...]:
    """The K/V buffer names of a cache state at this precision (the keys a
    slot scatter carries alongside 'len')."""
    if bits in (8, 4):
        return ("k_q", "v_q", "k_scale", "v_scale")
    if bits == 16:
        return ("k", "v")
    raise ValueError(f"kv_bits must be 16, 8 or 4, got {bits}")


def kv_row_bytes(n_kv: int, hd: int, bits: int, *, fp_bytes: int = 4) -> int:
    """Bytes one cached token row costs across K+V per layer: codes plus
    per-(token, head) f32 scales for bits 8/4, plain fp rows for 16."""
    if bits == 16:
        return 2 * n_kv * hd * fp_bytes
    return 2 * (n_kv * kv_code_shape(hd, bits) + n_kv * 4)
