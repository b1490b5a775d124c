"""Mamba2 (SSD) blocks, the counterpart of the JAX package's
``models/mamba2.py``.

A cacheless forward runs the chunked SSD algorithm (the Mamba2 paper's
minimal form): the intra-chunk quadratic term plus the inter-chunk state
recurrence, a loop over chunks. Decode is the O(1) per-token recurrence on
the state (B, H, P, N).

Quantization (MKQ): the in / out projections (``in_z``, ``in_x``,
``in_bc``, ``in_dt``, ``out_proj``) go through ``qlinear``, so a deployed
model on the card runs them through the integer kernels; the SSM internals
(gates, scan, conv) stay f32, the same structural rule as LayerNorm and
softmax in the paper. None of this is a Pallas kernel in the JAX package,
so it is plain PyTorch here. Where JAX's ``jnp.einsum`` promotes mixed
operands to their common dtype, the operands are promoted here before the
contraction, after the same roundings (``L``, the carried states) to the
scores' dtype.

In a sharded training step (``spec.groups``, ``model > 1``) a rank holds
``H / model`` SSM heads, as JAX's rules cut the block: ``in_z`` and
``in_x`` column-parallel (the rank's columns of ``d_inner``),
``out_proj`` row-parallel. ``in_bc`` and ``in_dt`` are replicated: every
rank computes them whole and takes all of B and C and its heads of dt; the
conv runs on the rank's ``d_inner`` columns and the ``2N`` B / C ones.
``a_log``, ``dt_bias``, ``d_skip`` and ``ssm_norm`` are sliced to the
rank's heads. ``ssm_norm`` stays one RMSNorm over the whole ``d_inner``:
its sum of squares is summed over the model ranks. A replicated tensor a
rank uses only in part has its gradient summed over the model ranks
(``collectives.model_slice`` / ``copy_to_model``), once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import QuantSpec, qlinear, rmsnorm
from .transformer import _normal, init_linear, init_norm

CONV_K = 4


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` on operands promoted to their common dtype."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ------------------------------------------------------------------ SSD core
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """log-space segment sums: out[..., i, j] = sum_{j<k<=i} x[..., k],
    -inf above the diagonal."""
    T = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    d = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, torch.full((), float("-inf"), dtype=d.dtype,
                                           device=x.device))


def ssd_chunked(x, dt, a_log, b, c, chunk: int):
    """Chunked SSD. x (B, S, H, P), dt (B, S, H), a_log (H,), b / c (B, S,
    N) -> (y (B, S, H, P), the final state (B, H, P, N) in f32). One B / C
    group shared across the heads; S must be a multiple of ``chunk``."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = chunk
    if S % Q:
        raise ValueError(f"ssd_chunked: length {S} is not a multiple of the "
                         f"chunk {Q}")
    nc = S // Q
    xd = x * dt[..., None]                                   # dt-weighted input
    dA = dt * (-torch.exp(a_log))[None, None, :]             # (B,S,H) <= 0
    xc = xd.reshape(B, nc, Q, H, P)
    bc = b.reshape(B, nc, Q, N)
    cc = c.reshape(B, nc, Q, N)
    dAc = dA.reshape(B, nc, Q, H)
    cum = torch.cumsum(dAc, dim=2)                           # (B,nc,Q,H)
    # 1) intra-chunk (diagonal) term
    L = torch.exp(_segsum(dAc.permute(0, 1, 3, 2)))          # (B,nc,H,Q,Q)
    scores = _einsum("bcqn,bckn->bcqk", cc, bc)              # (B,nc,Q,Q)
    y_diag = _einsum("bcqk,bchqk,bckhp->bcqhp", scores, L.to(scores.dtype), xc)
    # 2) per-chunk input states
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)        # (B,nc,Q,H)
    states = _einsum("bcqn,bcqh,bcqhp->bchpn", bc, decay_states, xc)
    # 3) inter-chunk recurrence
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (B,nc,H)
    s = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    prev = []
    states = states.to(torch.float32)
    for ci in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                   # (B,nc,H,P,N)
    # 4) state -> output within the chunk
    state_decay = torch.exp(cum)                             # (B,nc,Q,H)
    y_off = _einsum("bcqn,bchpn,bcqh->bcqhp", cc, prev_states.to(cc.dtype),
                    state_decay)
    y = (y_diag + y_off).reshape(B, S, H, P)
    return y, s


def ssd_decode_step(state, x, dt, a_log, b, c):
    """One-token recurrence. state (B, H, P, N) f32, x (B, 1, H, P), dt (B,
    1, H), b / c (B, 1, N) -> (y (B, 1, H, P), the new state)."""
    dA = torch.exp(dt[:, 0] * (-torch.exp(a_log))[None, :])  # (B,H)
    xd = (x * dt[..., None])[:, 0]                           # (B,H,P)
    new_state = state * dA[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", xd.to(torch.float32), b[:, 0].to(torch.float32))
    y = torch.einsum("bhpn,bn->bhp", new_state.to(c.dtype), c[:, 0])
    return y[:, None], new_state


# ------------------------------------------------------------------ block
def init_mamba2_block(g, cfg: ModelConfig, stacked: Optional[int], device) -> dict:
    """The JAX ``init_mamba2_block`` tree (same keys, shapes and init
    scales), ``stacked`` along a leading dim unless None; values from
    ``g``."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = di // cfg.ssm_head_dim
    N = cfg.ssm_state
    lead = () if stacked is None else (stacked,)
    lin = lambda k, n: init_linear(g, k, n, False, stacked, device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": init_norm(d, stacked, device, "rms"),
        "in_z": lin(d, di),
        "in_x": lin(d, di),
        "in_bc": lin(d, 2 * N),
        "in_dt": lin(d, H),
        "conv_w": _normal(g, lead + (CONV_K, di + 2 * N), device) * 5.0,
        "a_log": torch.zeros(lead + (H,), **f32),
        "dt_bias": torch.zeros(lead + (H,), **f32),
        "d_skip": torch.ones(lead + (H,), **f32),
        "ssm_norm": init_norm(di, stacked, device, "rms"),
        "out_proj": lin(di, d),
    }


def _causal_conv(u, w, cache=None):
    """Depthwise causal conv. u (B, S, C), w (K, C); ``cache`` (B, K-1, C)
    for decode. Returns (out, new cache or None)."""
    if cache is not None:
        u_ext = torch.cat([cache.to(u.dtype), u], dim=1)
        new_cache = u_ext[:, -(CONV_K - 1):]
    else:
        u_ext = F.pad(u, (0, 0, CONV_K - 1, 0))
        new_cache = None
    S = u.shape[1]
    out = sum(u_ext[:, i:i + S] * w[i] for i in range(CONV_K))
    return out, new_cache


def _rmsnorm_over_model(x, scale, width: int, groups, eps: float = 1e-6):
    """``rmsnorm`` over a last dim of ``width`` that the model ranks cut:
    ``x`` and ``scale`` hold this rank's columns, the mean of squares is
    the whole dim's (summed over the ranks, forward and backward)."""
    from ..distributed.collectives import sum_over_model
    xf = x.to(torch.float32)
    ss = sum_over_model(torch.sum(torch.square(xf), dim=-1, keepdim=True), groups)
    return ((xf * torch.rsqrt(ss / width + eps)) * scale.to(torch.float32)).to(x.dtype)


def mamba2_block(x, p, cfg: ModelConfig, spec: QuantSpec,
                 state: Optional[dict] = None):
    """Pre-norm residual Mamba2 block: ``(x + out, new_state)``. ``state``
    {'ssm': (B, H, P, N), 'conv': (B, K-1, C)} takes the one-token decode
    recurrence; None the chunked forward (and returns None). Under a
    sharded step's model ranks the rank's heads, as the module docstring
    says (no decode state)."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = di // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    B_, S, _ = x.shape
    mp = spec.model_groups

    h = rmsnorm(x, p["norm"]["scale"])
    z = qlinear(h, p["in_z"], spec)
    xs = qlinear(h, p["in_x"], spec)
    conv_w, a_log, dt_bias, d_skip = p["conv_w"], p["a_log"], p["dt_bias"], p["d_skip"]
    if mp is None:
        bc = qlinear(h, p["in_bc"], spec)
        dt = qlinear(h, p["in_dt"], spec)
    else:
        from ..distributed.collectives import copy_to_model, model_slice
        rep = dataclasses.replace(spec, groups=None)     # replicated linears
        bc = copy_to_model(qlinear(h, p["in_bc"], rep), mp)
        dt = model_slice(qlinear(h, p["in_dt"], rep), -1, mp)
        cw = copy_to_model(conv_w, mp)
        dl = di // mp.model
        conv_w = torch.cat([cw[:, mp.mp_rank * dl:(mp.mp_rank + 1) * dl], cw[:, di:]], -1)
        a_log, dt_bias, d_skip = (model_slice(t, -1, mp) for t in (a_log, dt_bias, d_skip))
        di, H = dl, H // mp.model
    conv_in = torch.cat([xs, bc], dim=-1)
    conv_out, new_conv = _causal_conv(
        conv_in, conv_w, None if state is None else state["conv"])
    conv_out = F.silu(conv_out.to(torch.float32)).to(x.dtype)
    xs, b, c = torch.split(conv_out, [di, N, N], dim=-1)
    xs = xs.reshape(B_, S, H, P)
    dt = _softplus(dt.to(torch.float32) + dt_bias)           # (B,S,H)

    if state is None:
        y, _ = ssd_chunked(xs, dt, a_log, b, c, cfg.ssm_chunk)
        new_state = None
    else:
        y, new_ssm = ssd_decode_step(state["ssm"], xs, dt, a_log, b, c)
        new_state = {"ssm": new_ssm, "conv": new_conv}
    y = y.to(x.dtype) + xs * d_skip[None, None, :, None].to(xs.dtype)
    y = y.reshape(B_, S, di)
    y = y * F.silu(z.to(torch.float32)).to(x.dtype)
    if mp is None:
        y = rmsnorm(y, p["ssm_norm"]["scale"])
    else:
        y = _rmsnorm_over_model(y, model_slice(p["ssm_norm"]["scale"], -1, mp),
                                cfg.ssm_expand * d, mp)
    return x + qlinear(y, p["out_proj"], spec, row_parallel=True), new_state


def mamba2_state_init(cfg: ModelConfig, batch: int, device) -> dict:
    """One block's zero decode state, f32: 'ssm' (B, H, P, N) and the conv
    window 'conv' (B, K-1, di + 2N)."""
    di = cfg.ssm_expand * cfg.d_model
    H = di // cfg.ssm_head_dim
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"ssm": z(batch, H, cfg.ssm_head_dim, cfg.ssm_state),
            "conv": z(batch, CONV_K - 1, di + 2 * cfg.ssm_state)}
