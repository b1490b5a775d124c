"""LSQ quantizers with MSE-based (MKQ-BERT) and STE-based (LSQ/KDLSQ) scale
gradients (paper §4.1), and their deploy-time half:

  Q[x] = s * round(clamp(x / s, l_min, l_max)),   l_min = -2^{k-1}+1, l_max = 2^{k-1}

Scale gradient modes
--------------------
``ste``  (LSQ / KDLSQ-BERT baseline, Esser et al. 2019):
    dQ/ds per element = round(x/s) - x/s      (in range)
                      = l_min / l_max         (clipped)
    and the incoming gradient is applied:  ds = sum(g * dQ/ds) / sqrt(n * l_max).

``mse``  (MKQ-BERT, §4.1.2): the scale's gradient is *redefined* as the
    gradient of the quantization error itself, independent of the task
    gradient:  ds = 2 * sum((Q[x]-x) * round(clamp(x/s))) / n.

Both modes pass the gradient of ``x`` straight through inside the clip range
and give zero outside. A scale used by several calls accumulates one ``ds``
per call, as autograd sums the gradients of a shared input.

``torch.round`` rounds half to even, as ``jnp.round`` does, so integer codes
are bit-identical to the JAX package's. Scales are per-tensor (scalar) or
per-channel along one axis, shaped to broadcast against ``x``
(:func:`scale_shape`).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["qrange", "scale_shape", "reduce_axes_for_scale", "lsq_quantize",
           "fake_quant", "quantize_to_int", "dequantize"]


def qrange(bits: int) -> tuple[int, int]:
    """Clamp bounds. Paper: l_min = -2^{k-1}+1, l_max = 2^{k-1} (k=4: [-7, 8]).

    For k=8 the paper's l_max = 128 cannot live in the int8 deployment carrier
    (it wraps to -128), so the 8-bit grid is [-127, 127]; k=4 keeps the
    paper's exact asymmetric grid.
    """
    if bits >= 8:
        return -(2 ** (bits - 1)) + 1, 2 ** (bits - 1) - 1
    return -(2 ** (bits - 1)) + 1, 2 ** (bits - 1)


def scale_shape(x_shape: tuple[int, ...], axis: Optional[int]) -> tuple[int, ...]:
    """Broadcastable shape for a scale: all-ones except ``axis`` (None => scalar ())."""
    if axis is None:
        return ()
    axis = axis % len(x_shape)
    return tuple(x_shape[i] if i == axis else 1 for i in range(len(x_shape)))


def reduce_axes_for_scale(x_ndim: int, s_shape: tuple[int, ...]) -> tuple[int, ...]:
    """Axes of x to sum over when reducing an elementwise grad to the scale's shape."""
    if s_shape == ():
        return tuple(range(x_ndim))
    # s broadcasts against x: sum over axes where s has extent 1 (plus leading axes)
    lead = x_ndim - len(s_shape)
    axes = list(range(lead))
    for i, d in enumerate(s_shape):
        if d == 1:
            axes.append(lead + i)
    return tuple(axes)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor on ``like``'s device: dividing by a tensor keeps the
    IEEE division (a Python-float divisor on a CUDA tensor becomes a
    multiply by its reciprocal)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


class LSQQuantize(torch.autograd.Function):
    """``s * round(clip(x / s))`` with the LSQ / MKQ backward; saves only
    (x, s)."""

    @staticmethod
    def forward(ctx, x, s, bits: int, grad_mode: str):
        if grad_mode not in ("mse", "ste"):
            raise ValueError(f"unknown grad_mode {grad_mode!r}")
        ctx.save_for_backward(x, s)
        ctx.bits, ctx.grad_mode = bits, grad_mode
        qmin, qmax = qrange(bits)
        # JAX promotes bf16 / f32 to f32 whatever the ranks; PyTorch would
        # keep bf16 against a 0-d f32 scale, so promote explicitly
        dt = torch.promote_types(x.dtype, s.dtype)
        xs, ss = x.to(dt), s.to(dt)
        zq = torch.round(torch.clamp(xs / ss, qmin, qmax))
        return (ss * zq).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        qmin, qmax = qrange(ctx.bits)
        f32 = torch.float32
        xf, sf = x.to(f32), s.to(f32)
        z = xf / sf
        zq = torch.round(torch.clamp(z, qmin, qmax))
        in_range = (z >= qmin) & (z <= qmax)
        dx = torch.where(in_range, g.to(f32), 0.0).to(x.dtype)
        axes = reduce_axes_for_scale(x.dim(), tuple(s.shape))
        # torch.sum over dim=() would reduce every axis
        red = (lambda t: torch.sum(t, dim=axes)) if axes else (lambda t: t)
        n = x.numel() / max(s.numel(), 1)
        if ctx.grad_mode == "ste":
            elem = torch.where(in_range, zq - z, torch.clamp(z, qmin, qmax))
            ds = red(g.to(f32) * elem).reshape(s.shape)
            ds = ds / torch.sqrt(_f32(n * qmax, x))    # LSQ's 1/sqrt(N * qmax)
        else:
            # the task gradient is deliberately not applied: the scale
            # descends the quantization MSE, averaged per element
            q = sf * zq
            ds = 2.0 * red((q - xf) * zq).reshape(s.shape) / _f32(n, x)
        return dx, ds.to(s.dtype), None, None


def lsq_quantize(x: torch.Tensor, s: torch.Tensor, bits: int,
                 grad_mode: str) -> torch.Tensor:
    """Fake-quantize ``x`` with learned scale ``s`` (broadcastable against x)."""
    return LSQQuantize.apply(x, s, int(bits), grad_mode)


def fake_quant(x: torch.Tensor, s: torch.Tensor, bits: Optional[int],
               grad_mode: str = "mse", enabled: bool = True) -> torch.Tensor:
    """QAT fake-quantization entry point (identity when disabled or bits is None)."""
    if not enabled or bits is None:
        return x
    return lsq_quantize(x, s, int(bits), grad_mode)


def quantize_to_int(x: torch.Tensor, s: torch.Tensor, bits: int) -> torch.Tensor:
    """Deploy-time quantization to int8-carried codes on the qrange grid,
    the grid QAT trained on.

    ``s`` must be a tensor on ``x``'s device: a Python-float divisor on a
    CUDA tensor is turned into a multiply by its reciprocal by PyTorch,
    which is not the IEEE division the reference performs."""
    qmin, qmax = qrange(bits)
    z = torch.round(torch.clamp(x.to(torch.float32) / s, qmin, qmax))
    return z.to(torch.int8)


def dequantize(q: torch.Tensor, s: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * s).to(dtype)
