"""xLSTM (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar
memory) blocks, the counterpart of the JAX package's ``models/xlstm.py``.

The mLSTM's cacheless forward is the stabilized chunkwise form: within a
chunk a decay matrix (masked to -inf above the diagonal) and a log-space
running max ``m``, across chunks the carried ``(C, n, m)``, a loop over
chunks. Decode is the O(1) stabilized recurrence. The sLSTM is a true time
recurrence with per-head block-diagonal hidden-to-hidden matrices, one step
a token.

Stack layout: ``G = L / slstm_every`` groups of ``slstm_every - 1`` mLSTM
layers (stacked (G, per - 1, ...)) and one sLSTM layer (stacked (G, ...)).
The policy's granularity is the group (``hybrid.group_segments``).

Quantization (MKQ): the mLSTM's ``up``, ``wq``, ``wk``, ``wv`` and
``down`` and the sLSTM's ``w_in`` and ``down`` go through ``qlinear``, so a
deployed model on the card runs them through the integer kernels. Gates
(the mLSTM's gate matmul included), norms and recurrences stay f32 plain
PyTorch, as in the JAX package, where none of them is a Pallas kernel.

Decode state (``xlstm_states``): always f32, ``m`` at -1e30. It is updated
in place, one layer at a time (the JAX package returns new arrays), so a
step holds at most one layer's new ``C`` beside the state. With
``cfg.remat`` a stateless group runs under activation checkpointing in
training (``layers.remat``), where JAX checkpoints the group's body.

A sharded training step (``spec.groups``, ``model > 1``) cuts both blocks
by heads, as JAX's rules cut them. The mLSTM's ``up`` is column-parallel
part by part (the rank's heads of ``xi`` and of ``z``); the conv runs on
the rank's ``xi`` columns; ``wq`` / ``wk`` (on the conv output) and
``wv`` (on ``xi``) are column-parallel over the whole input, so the conv
output and ``xi`` are gathered first; the replicated ``w_gates`` runs
whole and the rank takes its heads' input and forget gates; ``headnorm``
is per head; ``down`` is row-parallel. The sLSTM's ``w_in`` is
column-parallel part by part (the rank's heads of each gate), ``b`` and
the recurrent ``r`` are sliced to the rank's heads (the recurrence is
head-local), ``down`` is row-parallel. A replicated tensor a rank uses
only in part has its gradient summed over the model ranks
(``collectives.model_slice``). The embedding and the head are cut over
the vocabulary, and under FSDP each group's layers are taken from the
data rank that owns them (``transformer.take_layer``).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.tree import slice_stack, tree_map
from .layers import QuantSpec, qlinear, remat, rmsnorm
from .mamba2 import CONV_K, _causal_conv, _softplus
from .transformer import (_embed, _normal, init_linear, init_norm, lm_head_logits,
                          take_layer)

__all__ = ["mlstm_chunked", "mlstm_decode_step", "mlstm_block", "slstm_block",
           "init_xlstm", "xlstm_forward", "xlstm_states", "CONV_K"]

_NEG = -1e30          # the log-space max of an empty memory


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    per = cfg.slstm_every
    if cfg.num_layers % per:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not split "
                         f"into groups of slstm_every={per}")
    return cfg.num_layers // per, per


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -_softplus(-x)


@functools.lru_cache(maxsize=None)
def _inv_sqrt(dh: int) -> float:
    """1 / sqrt(dh) rounded as JAX computes it, in f32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


# ------------------------------------------------------------------ mLSTM core
def _headnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm over dh: x (B, S, H, dh), scale (H * dh,)."""
    B, S, H, dh = x.shape
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + 1e-6)
    return (y.reshape(B, S, H * dh) * scale).to(x.dtype)


def mlstm_chunked(q, k, v, i_pre, f_pre, chunk: int, state=None):
    """Stabilized chunkwise mLSTM. q, k, v (B, S, H, dh); i_pre, f_pre (B,
    S, H) raw gate pre-activations; ``state`` an optional (C (B, H, dh,
    dh), n (B, H, dh), m (B, H)). Returns y (B, S, H, dh) in q's dtype and
    the final state (f32)."""
    B, S, H, dh = q.shape
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"mlstm_chunked: length {S} is not a multiple of "
                         f"the chunk {Q}")
    nc = S // Q
    scale = _inv_sqrt(dh)
    lf = _log_sigmoid(f_pre.to(torch.float32))               # (B,S,H)
    li = i_pre.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=q.device)

    def chunks(t):                                           # -> (nc,B,H,Q,...)
        t = t.reshape(B, nc, Q, H, *t.shape[3:]).transpose(2, 3)
        return t.transpose(0, 1)
    qc, kc, vc, lfc, lic = map(chunks, (q, k, v, lf, li))
    if state is None:
        C = torch.zeros((B, H, dh, dh), **f32)
        n = torch.zeros((B, H, dh), **f32)
        m = torch.full((B, H), _NEG, **f32)
    else:
        C, n, m = state
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    neg_inf = torch.full((), float("-inf"), **f32)
    ys = []
    for c in range(nc):
        lf_i, li_i = lfc[c], lic[c]                          # (B,H,Q)
        b = torch.cumsum(lf_i, dim=-1)
        total = b[..., -1]
        # intra-chunk log decay D_ij = b_i - b_j + li_j (j <= i)
        D = b[..., :, None] - b[..., None, :] + li_i[..., None, :]
        D = torch.where(tri, D, neg_inf)
        m_intra = torch.amax(D, dim=-1)                      # (B,H,Q)
        m_comb = torch.maximum(m[..., None] + b, m_intra)
        inter_coef = torch.exp(m[..., None] + b - m_comb)    # (B,H,Q)
        W = torch.exp(D - m_comb[..., None])                 # (B,H,Q,Q)
        qf, kf, vf = (t.to(torch.float32) for t in (qc[c], kc[c], vc[c]))
        S_mat = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale * W
        h = (torch.einsum("bhqd,bhde->bhqe", qf * inter_coef[..., None] * scale, C)
             + torch.einsum("bhqk,bhkd->bhqd", S_mat, vf))
        denom_raw = (torch.einsum("bhqd,bhd->bhq", qf * scale, n) * inter_coef
                     + torch.sum(S_mat, dim=-1))
        denom = torch.maximum(torch.abs(denom_raw), torch.exp(-m_comb))
        ys.append(h / denom[..., None])
        # state update
        m_next = torch.maximum(m + total, torch.amax(
            total[..., None] - b + li_i, dim=-1))
        sdec = torch.exp(total[..., None] - b + li_i - m_next[..., None])  # (B,H,Q)
        carry = torch.exp(m + total - m_next)
        C = (carry[..., None, None] * C
             + torch.einsum("bhqd,bhqe->bhde", sdec[..., None] * kf, vf))
        n = carry[..., None] * n + torch.einsum("bhq,bhqd->bhd", sdec, kf)
        m = m_next
    y = torch.stack(ys, dim=0)                               # (nc,B,H,Q,dh)
    y = y.permute(1, 0, 3, 2, 4).reshape(B, S, H, dh)
    return y.to(q.dtype), (C, n, m)


def mlstm_decode_step(state, q, k, v, i_pre, f_pre):
    """One-token mLSTM. q, k, v (B, 1, H, dh), i_pre / f_pre (B, 1, H);
    returns y (B, 1, H, dh) in q's dtype and the new (C, n, m)."""
    C, n, m = state
    dh = q.shape[-1]
    scale = _inv_sqrt(dh)
    lf = _log_sigmoid(f_pre.to(torch.float32))[:, 0]        # (B,H)
    li = i_pre.to(torch.float32)[:, 0]
    m_new = torch.maximum(lf + m, li)
    i_s = torch.exp(li - m_new)
    f_s = torch.exp(lf + m - m_new)
    qf, kf, vf = (t.to(torch.float32)[:, 0] for t in (q, k, v))  # (B,H,dh)
    C_new = f_s[..., None, None] * C + i_s[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", kf, vf)
    n_new = f_s[..., None] * n + i_s[..., None] * kf
    qs = qf * scale
    h = torch.einsum("bhd,bhde->bhe", qs, C_new)
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qs, n_new)),
                          torch.exp(-m_new))
    y = (h / denom[..., None])[:, None]
    return y.to(q.dtype), (C_new, n_new, m_new)


# ------------------------------------------------------------------ blocks
def init_mlstm_block(g, cfg: ModelConfig, stacked: Optional[int], device) -> dict:
    """The JAX ``init_mlstm_block`` tree (same keys, shapes and init
    scales), ``stacked`` along a leading dim unless None; values from
    ``g``."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = cfg.num_heads
    lead = () if stacked is None else (stacked,)
    lin = lambda k, n: init_linear(g, k, n, False, stacked, device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": init_norm(d, stacked, device, "rms"),
        "up": lin(d, 2 * di),
        "conv_w": _normal(g, lead + (CONV_K, di), device) * 5.0,
        "wq": lin(di, di),
        "wk": lin(di, di),
        "wv": lin(di, di),
        "w_gates": {"w": _normal(g, lead + (di, 2 * H), device),
                    "b": torch.cat([torch.zeros(lead + (H,), **f32),
                                    torch.full(lead + (H,), 3.0, **f32)], -1)},
        "headnorm": torch.ones(lead + (di,), **f32),
        "down": lin(di, d),
    }


def mlstm_block(x, p, cfg: ModelConfig, spec: QuantSpec,
                state: Optional[dict] = None):
    """Pre-norm residual mLSTM block: ``(x + out, new_state)``. ``state``
    {'C', 'n', 'm', 'conv'} takes the one-token decode recurrence; None the
    chunked forward (and returns None). Under a sharded step's model ranks
    the rank's heads, as the module docstring says (no decode state)."""
    B, S, d = x.shape
    di = cfg.ssm_expand * d
    H = cfg.num_heads
    dh = di // H
    mp = spec.model_groups
    h = rmsnorm(x, p["norm"]["scale"])
    xz = qlinear(h, p["up"], spec)
    xi, z = torch.chunk(xz, 2, dim=-1)
    conv_w, headnorm = p["conv_w"], p["headnorm"]
    if mp is not None:
        from ..distributed.collectives import gather_from_model, model_slice
        conv_w, headnorm = model_slice(conv_w, -1, mp), model_slice(headnorm, -1, mp)
        H = H // mp.model
    conv_out, new_conv = _causal_conv(
        xi, conv_w, None if state is None else state["conv"])
    conv_out = F.silu(conv_out.to(torch.float32)).to(x.dtype)
    conv_in, v_in = conv_out, xi
    if mp is not None:      # wq / wk / wv take the whole input
        conv_in, v_in = gather_from_model(conv_out, -1, mp), gather_from_model(xi, -1, mp)
    q = qlinear(conv_in, p["wq"], spec).reshape(B, S, H, dh)
    k = qlinear(conv_in, p["wk"], spec).reshape(B, S, H, dh)
    v = qlinear(v_in, p["wv"], spec).reshape(B, S, H, dh)
    gates = (conv_in.to(torch.float32) @ p["w_gates"]["w"]
             + p["w_gates"]["b"])                            # (B,S,2H)
    if mp is not None:      # the rank's heads of i and of f
        gates = model_slice(gates, -1, mp, parts=2)
    i_pre, f_pre = torch.chunk(gates, 2, dim=-1)
    if state is None:
        y, _ = mlstm_chunked(q, k, v, i_pre, f_pre, cfg.ssm_chunk)
        new_state = None
    else:
        y, (C, n, m) = mlstm_decode_step(
            (state["C"], state["n"], state["m"]), q, k, v, i_pre, f_pre)
        new_state = {"C": C, "n": n, "m": m, "conv": new_conv}
    y = _headnorm(y, headnorm)
    y = y * F.silu(z.to(torch.float32)).to(x.dtype)
    return x + qlinear(y, p["down"], spec, row_parallel=True), new_state


def init_slstm_block(g, cfg: ModelConfig, stacked: Optional[int], device) -> dict:
    """The JAX ``init_slstm_block`` tree; values from ``g``."""
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    lead = () if stacked is None else (stacked,)
    return {
        "norm": init_norm(d, stacked, device, "rms"),
        "w_in": init_linear(g, d, 4 * d, False, stacked, device),
        "r": _normal(g, lead + (4, H, dh, dh), device),
        "b": torch.zeros(lead + (4 * d,), dtype=torch.float32, device=device),
        "down": init_linear(g, d, d, False, stacked, device),
    }


def slstm_block(x, p, cfg: ModelConfig, spec: QuantSpec,
                state: Optional[dict] = None):
    """Scalar-memory LSTM with a per-head block-diagonal recurrence, one
    step a token: ``(x + out, new_state)``. ``state`` {'c', 'n', 'm', 'h'},
    each (B, d) f32, for decode; None starts from zeros (and returns
    None). Under a sharded step's model ranks the rank's heads."""
    B, S, d = x.shape
    H = cfg.num_heads
    dh = d // H
    mp = spec.model_groups
    b, r = p["b"], p["r"]
    if mp is not None:      # the rank's heads of each gate
        from ..distributed.collectives import model_slice
        b, r = model_slice(b, -1, mp, parts=4), model_slice(r, 1, mp)
        H, d = H // mp.model, d // mp.model
    hin = rmsnorm(x, p["norm"]["scale"])
    wx = qlinear(hin, p["w_in"], spec).to(torch.float32) + b      # (B,S,4d)
    zi, zf, zz, zo = torch.chunk(wx, 4, dim=-1)
    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        c = torch.zeros((B, d), **f32)
        n = torch.zeros((B, d), **f32)
        m = torch.full((B, d), _NEG, **f32)
        h = torch.zeros((B, d), **f32)
    else:
        c, n, m, h = (state[k] for k in ("c", "n", "m", "h"))
    # the recurrent matrices laid out once as (H, dh, 4 dh) for a batched
    # product over the heads: an einsum a step would copy (and keep for the
    # backward) its own permuted r every token
    rr = r.to(torch.float32).permute(1, 2, 0, 3).reshape(H, dh, 4 * dh)
    ys = []
    for t in range(S):
        rec = torch.bmm(h.reshape(B, H, dh).transpose(0, 1), rr)        # (H,B,4dh)
        rec = rec.reshape(H, B, 4, dh).permute(2, 1, 0, 3).reshape(4, B, d)
        i_pre = zi[:, t] + rec[0]
        f_pre = zf[:, t] + rec[1]
        zt = torch.tanh(zz[:, t] + rec[2])
        ot = torch.sigmoid(zo[:, t] + rec[3])
        lf = _log_sigmoid(f_pre)
        m_new = torch.maximum(lf + m, i_pre)
        i_s = torch.exp(i_pre - m_new)
        f_s = torch.exp(lf + m - m_new)
        c = f_s * c + i_s * zt
        n = torch.clamp_min(f_s * n + i_s, 1e-6)
        h = ot * c / n
        m = m_new
        ys.append(h)
    y = torch.stack(ys, dim=1).to(x.dtype)                   # (B,S,d)
    new_state = None if state is None else {"c": c, "n": n, "m": m, "h": h}
    return x + qlinear(y, p["down"], spec, row_parallel=True), new_state


# ------------------------------------------------------------------ full stack
def init_xlstm(cfg: ModelConfig, g: torch.Generator, device) -> dict:
    """The JAX ``init_xlstm`` tree: the mLSTM layers stacked (G, per - 1,
    ...), the sLSTM layers (G, ...), the embedding, final norm and head;
    values from ``g``."""
    G, per = _groups(cfg)
    flat = init_mlstm_block(g, cfg, G * (per - 1), device)
    return {
        "embed": _normal(g, (cfg.padded_vocab, cfg.d_model), device),
        "mlstm": tree_map(lambda a: a.reshape(G, per - 1, *a.shape[1:]), flat),
        "slstm": init_slstm_block(g, cfg, G, device),
        "final_norm": init_norm(cfg.d_model, None, device, "rms"),
        "lm_head": _normal(g, (cfg.d_model, cfg.padded_vocab), device),
    }


def _group(x, mp, sp, cfg: ModelConfig, spec: QuantSpec):
    """One stateless group: its mLSTM layers (``mp`` stacked (per - 1,
    ...)) and then its sLSTM layer ``sp``."""
    for li in range(_groups(cfg)[1] - 1):
        x, _ = mlstm_block(x, tree_map(lambda a: a[li], mp), cfg, spec)
    return slstm_block(x, sp, cfg, spec)[0]


def xlstm_forward(params, cfg: ModelConfig, segments, *, tokens,
                  states: Optional[dict] = None, want_taps: bool = False,
                  want_aux: bool = False):
    """The group loop over ``segments``: (per - 1) mLSTM layers and one
    sLSTM a group. Returns ``(logits, new_states)``, then with
    ``want_taps`` ``{'hidden': x}`` (the stack's output before the final
    norm, JAX's taps) and with ``want_aux`` a 0 load-balance loss.
    ``states`` (``xlstm_states``) is updated in place, one layer at a time;
    ``new_states`` is the same dict."""
    G, per = _groups(cfg)
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    groups = segments[0][2].groups
    x = _embed(params, cfg, tokens, groups=groups)
    presliced = isinstance(params["mlstm"], (list, tuple))
    for si, (start, end, spec) in enumerate(segments):
        mseg = (params["mlstm"][si] if presliced
                else slice_stack(params["mlstm"], start, end))
        sseg = (params["slstm"][si] if presliced
                else slice_stack(params["slstm"], start, end))
        for gi in range(end - start):
            grp = start + gi
            if states is None:      # JAX checkpoints the group's body; FSDP's
                # take runs inside it, so it is recomputed too
                if presliced:
                    take = lambda gi=gi, mseg=mseg, sseg=sseg: (
                        tree_map(lambda a: a[gi], mseg), tree_map(lambda a: a[gi], sseg))
                else:
                    take = lambda grp=grp: (take_layer(params["mlstm"], grp, G, groups),
                                            take_layer(params["slstm"], grp, G, groups))
                x = remat(cfg.remat, lambda h, take=take, spec=spec: _group(
                    h, *take(), cfg, spec), x)
                continue
            for li in range(per - 1):
                lp = tree_map(lambda a: a[gi, li], mseg)
                st = {k: v[grp, li] for k, v in states["mlstm"].items()}
                x, ns = mlstm_block(x, lp, cfg, spec, state=st)
                for k, v in ns.items():
                    st[k].copy_(v)
                del ns
            sp = tree_map(lambda a: a[gi], sseg)
            st = {k: v[grp] for k, v in states["slstm"].items()}
            x, ns = slstm_block(x, sp, cfg, spec, state=st)
            for k, v in ns.items():
                st[k].copy_(v)
    taps = {"hidden": x} if want_taps else None
    x = rmsnorm(x, params["final_norm"]["scale"])
    logits = lm_head_logits(x, params["lm_head"], cfg, groups)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return ((logits, states) + ((taps,) if want_taps else ())
            + ((aux,) if want_aux else ()))


def xlstm_states(cfg: ModelConfig, batch: int, device) -> dict:
    """The decode state of ``batch`` rows, always f32: every mLSTM layer's
    C (B, H, dh, dh), n, m (at -1e30) and conv window (B, K - 1, di),
    stacked (G, per - 1, ...), and every sLSTM layer's c, n, m (at -1e30)
    and h, stacked (G, ...)."""
    G, per = _groups(cfg)
    n_m = per - 1
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = cfg.num_heads
    dh = di // H
    f32 = dict(dtype=torch.float32, device=device)
    z = lambda *s: torch.zeros(s, **f32)
    neg = lambda *s: torch.full(s, _NEG, **f32)
    return {
        "mlstm": {"C": z(G, n_m, batch, H, dh, dh), "n": z(G, n_m, batch, H, dh),
                  "m": neg(G, n_m, batch, H),
                  "conv": z(G, n_m, batch, CONV_K - 1, di)},
        "slstm": {"c": z(G, batch, d), "n": z(G, batch, d),
                  "m": neg(G, batch, d), "h": z(G, batch, d)},
    }
