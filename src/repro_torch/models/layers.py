"""Shared layer primitives: the quantizable linear, norms, activations.

Structural quantization rule (paper §5): ONLY matmul inputs/weights are
quantized. Norms, softmax, GELU/SiLU and RoPE run in fp32. The embedding table is
never quantized.

``qlinear`` is the single quantized-matmul primitive:

  mode 'none'  : x @ w            (fp baseline / teacher / calibration forward)
  mode 'fake'  : Q_a[x] @ Q_w[w]  (QAT; LSQ with 'mse' or 'ste' scale grads,
                 ``core.quantizer.lsq_quantize``): plain PyTorch with
                 autograd, as the JAX package computes it outside any kernel
  mode 'int'   : int8 codes matmul'd with an int32 accumulator and a fused
                 dequant; weights arrive pre-quantized (packed int4 or int8)
                 via core.packing. ``use_kernels`` dispatches to the
                 hand-written kernels (``kernels.ops``); otherwise the plain
                 integer path below runs. Under tensor parallelism
                 (``spec.tp > 1``) a row-parallel linear holds a slice of K
                 and sums its int32 accumulator over the ranks before the
                 dequantization, so the result is tp=1's to the bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..core import calibration
from ..core.packing import unpack_int4
from ..core.quantizer import fake_quant, quantize_to_int
from ..kernels.int4_matmul import gelu_tanh
from ..kernels.int8_matmul import int_matmul_exact

__all__ = ["QuantSpec", "qlinear", "fake_matmul", "rmsnorm", "layernorm", "gelu_f32",
           "act_fn", "rope_tables", "apply_rope", "remat"]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static per-call quantization spec (bits vary per layer-SEGMENT)."""
    mode: str = "none"          # none | fake | int
    w_bits: int = 0             # 0 = unquantized
    a_bits: int = 0
    grad_mode: str = "mse"
    use_kernels: bool = False   # int mode: hand-written kernels vs plain int path
    fuse_epilogue: bool = False  # int4 kernels: fold bias+act into the matmul
    tp: int = 1                 # tensor-parallel ranks a row-parallel sum spans
    #: a sharded training step's ``TrainGroups`` (None: one device, or the
    #: serving tp path over the default group)
    groups: object = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def enabled(self) -> bool:
        return self.mode != "none" and self.w_bits > 0

    @property
    def model_groups(self):
        """``groups`` where they span more than one model rank, else None:
        the forward's model-parallel branch."""
        g = self.groups
        return g if g is not None and g.model > 1 else None


def qlinear(x: torch.Tensor, p: dict, spec: QuantSpec,
            act: Optional[str] = None, row_parallel: bool = False) -> torch.Tensor:
    """Quantizable linear. p holds either fp or deployed-int parameters.

    fp params:  {'w': (K, N), 'b': (N,)?, 's_w': (1, N), 's_a': ()}
    int params: {'wq': packed, 's_w': (1, N), 's_a': (), 'b': (N,)?}

    ``act`` (fused-epilogue callers only): fold this activation into the
    int4 kernel's epilogue together with dequant+bias. ``row_parallel``
    marks the linears whose K a tp plan shards (wo, w2): at ``spec.tp > 1``
    their int32 partial sums are all-reduced over the ranks.
    """
    if calibration.active():
        calibration.record_input(x)
    if spec.mode == "int":
        return _qlinear_int(x, p, spec, act=act,
                            reduce=row_parallel and spec.tp > 1)
    assert act is None, "fused act requires the deployed int4 kernel path"
    out = fake_matmul(x, p, spec, row_parallel)
    b = p.get("b")
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def fake_matmul(x: torch.Tensor, p: dict, spec: QuantSpec,
                row_parallel: bool = False) -> torch.Tensor:
    """``Q_a[x] @ Q_w[w]`` (mode 'fake'; ``x @ w`` unquantized), a linear's
    or the experts' (E, C, K) @ (E, K, N); under sharded training on this
    model rank's slices, as the module docstring says (no bias)."""
    g = spec.model_groups
    if g is not None:
        from ..distributed.collectives import copy_to_model, reduce_from_model
    w = p["w"]
    if spec.mode == "fake" and spec.enabled:
        s_w, s_a, count = p["s_w"], p["s_a"], 1
        if g is not None and row_parallel:
            s_w, s_a, count = copy_to_model(s_w, g), copy_to_model(s_a, g), g.model
        w = fake_quant(w, s_w, spec.w_bits, spec.grad_mode, count=count)
        if spec.a_bits:
            x = fake_quant(x, s_a, spec.a_bits, spec.grad_mode, count=count)
    if g is not None and not row_parallel:
        x = copy_to_model(x, g)
    out = torch.matmul(x, w.to(x.dtype))
    return reduce_from_model(out, g) if g is not None and row_parallel else out


def _qlinear_int(x: torch.Tensor, p: dict, spec: QuantSpec,
                 act: Optional[str] = None, reduce: bool = False) -> torch.Tensor:
    """Deployed integer path. Activations quantized on the fly (per-tensor
    scale); ``a_bits == 0`` keeps them fp against dequantized weights, the
    weight-only parity baseline (reference backend only). ``reduce``: sum
    the int32 accumulator over the tensor-parallel ranks, before the
    dequantization and the replicated bias (the plain integer path only,
    which is what a tp plan runs)."""
    s_a, s_w = p["s_a"], p["s_w"]
    a_bits = spec.a_bits
    b = p.get("b")
    if reduce and (a_bits == 0 or spec.use_kernels):
        raise ValueError("a tensor-parallel row-parallel linear sums int32 "
                         "partials on the plain integer path only (backend "
                         "'reference', integer activations)")
    if a_bits == 0:
        assert not spec.use_kernels and act is None, \
            "fp-activation fallback is reference-backend only"
        w8 = unpack_int4(p["wq"], axis=-2) if spec.w_bits == 4 else p["wq"]
        k = x.shape[-1]
        if w8.shape[-2] != k:  # drop int4 pack padding row if any
            w8 = w8.narrow(-2, 0, k)
        w = (w8.to(torch.float32) * s_w).to(x.dtype)
        out = x @ w
        if b is not None:
            out = out + b.to(out.dtype)
        return out
    if spec.use_kernels:
        from ..kernels import ops as kops
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if spec.w_bits == 4:
            if act is not None:
                # fused: dequant + bias + activation inside the kernel
                # epilogue, no materialized (M, N) intermediate
                out = kops.int4_matmul(x2, p["wq"], s_a, s_w, a_bits=a_bits,
                                       bias=b, act=act)
                return out.reshape(*lead, -1)
            out = kops.int4_matmul(x2, p["wq"], s_a, s_w, a_bits=a_bits)
        else:
            assert act is None, "fused epilogue is int4-only"
            out = kops.int8_matmul(x2, p["wq"], s_a, s_w, a_bits=a_bits)
        # the kernels return x.dtype, so the bias below adds in it as well
        out = out.reshape(*lead, -1)
    else:
        assert act is None, "fused act requires the int4 kernel path"
        x8 = quantize_to_int(x, s_a, a_bits)
        w8 = unpack_int4(p["wq"], axis=-2) if spec.w_bits == 4 else p["wq"]
        k = x.shape[-1]
        if w8.shape[-2] != k:  # drop int4 pack padding row if any
            w8 = w8.narrow(-2, 0, k)
        acc = int_matmul_exact(x8, w8)
        if reduce:
            import torch.distributed as dist
            group = None if spec.groups is None else spec.groups.mp_group
            dist.all_reduce(acc, group=group)     # int32: exact in any order
        out = (acc.to(torch.float32) * (s_a * s_w)).to(x.dtype)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def remat(enabled: bool, fn, *args):
    """``fn(*args)``, under activation checkpointing when ``enabled`` (a
    config's ``remat``) and autograd records: the layer body's activations
    are dropped after the forward and recomputed in the backward, where the
    JAX package wraps the body in ``jax.checkpoint``. The values and the
    gradients are the same; the memory held between forward and backward is
    one layer's input. A forward under ``no_grad`` (serving) runs as it is.
    The bodies draw no random numbers, so no RNG state is kept."""
    if enabled and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


# ---------------------------------------------------------------- norms/acts
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.to(torch.float32)).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def gelu_f32(x: torch.Tensor) -> torch.Tensor:
    return gelu_tanh(x.to(torch.float32)).to(x.dtype)


def silu_f32(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.to(torch.float32)).to(x.dtype)


def act_fn(name: str):
    return {"gelu": gelu_f32, "silu": silu_f32, "relu": torch.relu}[name]


# ---------------------------------------------------------------------- RoPE
def rope_tables(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """cos/sin tables for positions: (..., S) -> (..., S, dim/2) each, f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                     device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, dh); cos/sin: (B_or_1, S, dh/2) broadcast over heads
    (the non-interleaved half split of the JAX package)."""
    xf = x.to(torch.float32)
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
