"""Zamba2-style hybrid stack: a Mamba2 backbone and ONE shared attention
block, the counterpart of the JAX package's ``models/hybrid.py``.

The shared attention + FFN block (a single weight set) is invoked after
every ``attn_every``-th Mamba2 layer (arXiv:2411.15242). The stack is
``G = L / attn_every`` groups; a group is ``attn_every`` stacked Mamba2
layers followed by one invocation of the shared block, each invocation
with its own KV slot of the decode state (stacked over G). The policy's
granularity is the group (``group_segments``); the shared block runs at the
last segment's spec.

Decode state (``hybrid_states``): {'mamba': {'ssm', 'conv'} stacked (G,
per, ...) in f32, 'attn': {'k', 'v'} (G, B, S, Hkv, hd) and ONE 0-d
cursor 'len'} shared by every slot, the token-mode layout. It is updated
in place (the JAX package returns new arrays). With ``cfg.remat`` a
stateless group (its Mamba2 layers and the shared block) runs under
activation checkpointing in training (``layers.remat``), where JAX
checkpoints the group's body. Under ``fused_proj`` the shared block's
SwiGLU FFN is one ``w13``; its attention stays unfused, as JAX builds it.

A sharded training step (``spec.groups``) runs the Mamba2 layers
model-parallel (``mamba2.mamba2_block``), the shared block as the
transformer's (its heads and FFN columns per model rank, one gradient
summed over its G calls by autograd), the embedding and the head over the
vocabulary (``transformer._embed`` / ``lm_head_logits``), and under FSDP
takes each group's Mamba2 layers from the data rank that owns them
(``transformer.take_layer``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..core.policy import QuantPolicy
from ..core.tree import slice_stack, tree_map
from .attention import attention_block
from .layers import QuantSpec, remat, rmsnorm
from .mamba2 import init_mamba2_block, mamba2_block, mamba2_state_init
from .transformer import (_embed, _normal, ffn_apply, init_attention, init_ffn,
                          init_norm, lm_head_logits, rank_heads, take_layer)


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    per = cfg.attn_every
    if cfg.num_layers % per:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not split "
                         f"into groups of attn_every={per}")
    return cfg.num_layers // per, per


def group_segments(policy: QuantPolicy, num_groups: int,
                   use_kernels: bool = False, act_bits: Optional[int] = None
                   ) -> list[tuple[int, int, QuantSpec]]:
    """The policy at group granularity: group g takes the bits of its first
    layer. ``act_bits`` is the plan-level activation override."""
    per = policy.num_layers // num_groups
    segs: list[tuple[int, int, QuantSpec]] = []
    for g in range(num_groups):
        wb = policy.weight_bits(g * per) or 0
        ab = policy.act_bits(g * per) or 0
        if act_bits is not None and wb:
            ab = act_bits
        spec = QuantSpec(mode=policy.mode, w_bits=wb, a_bits=ab,
                         grad_mode=policy.grad_mode, use_kernels=use_kernels)
        if segs and segs[-1][2] == spec:
            segs[-1] = (segs[-1][0], g + 1, spec)
        else:
            segs.append((g, g + 1, spec))
    return segs


def init_hybrid(cfg: ModelConfig, g: torch.Generator, device) -> dict:
    """The JAX ``init_hybrid`` tree: the Mamba2 layers stacked (G, per,
    ...), the shared block, the final norm and the head; values from
    ``g``."""
    G, per = _groups(cfg)
    d = cfg.d_model
    flat = init_mamba2_block(g, cfg, G * per, device)
    mamba = tree_map(lambda a: a.reshape(G, per, *a.shape[1:]), flat)
    return {
        "embed": _normal(g, (cfg.padded_vocab, d), device),
        "mamba": mamba,
        "shared": {"ln1": init_norm(d, None, device, "rms"),
                   "attn": init_attention(g, cfg, None, device),
                   "ln2": init_norm(d, None, device, "rms"),
                   "ffn": init_ffn(g, cfg, None, device)},
        "final_norm": init_norm(d, None, device, "rms"),
        "lm_head": _normal(g, (d, cfg.padded_vocab), device),
    }


def _shared_block(x, p, cfg: ModelConfig, spec: QuantSpec, cache=None,
                  want_taps: bool = False):
    """The shared attention + FFN block: ``(x, new_kv)`` (and the
    attention's taps with ``want_taps``). A cacheless forward past
    ``attn_chunk_threshold`` takes the chunk branch (the flash kernel under
    a kernel plan)."""
    h = rmsnorm(x, p["ln1"]["scale"])
    chunk = cfg.attn_chunk if x.shape[1] > cfg.attn_chunk_threshold else 0
    a, new_kv, *taps = attention_block(
        h, p["attn"], **rank_heads(cfg, spec), spec=spec, causal=True, rope=True,
        rope_theta=cfg.rope_theta, cache=cache, chunk=chunk, want_taps=want_taps)
    x = x + a
    x = x + ffn_apply(rmsnorm(x, p["ln2"]["scale"]), p["ffn"], cfg, spec)
    return (x, new_kv, *taps)


def _group(x, gp, shared, cfg: ModelConfig, spec: QuantSpec,
           shared_spec: QuantSpec):
    """One cacheless group: its Mamba2 layers (``gp`` stacked (per, ...))
    and then the shared block."""
    for li in range(_groups(cfg)[1]):
        x, _ = mamba2_block(x, tree_map(lambda a: a[li], gp), cfg, spec)
    return _shared_block(x, shared, cfg, shared_spec)[0]


def hybrid_forward(params, cfg: ModelConfig, segments, *, tokens,
                   states: Optional[dict] = None, want_taps: bool = False,
                   want_aux: bool = False):
    """Returns ``(logits, new_states)``, then with ``want_taps`` the last
    shared-attention invocation's taps plus the final hidden state
    (``'hidden'``), and with ``want_aux`` a 0 load-balance loss. ``states``
    (``hybrid_states``) is updated in place; ``new_states`` holds the same
    buffers with the cursor advanced by S."""
    G, per = _groups(cfg)
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    groups = segments[0][2].groups
    x = _embed(params, cfg, tokens, groups=groups)
    presliced = isinstance(params["mamba"], (list, tuple))
    shared, shared_spec = params["shared"], segments[-1][2]
    for si, (start, end, spec) in enumerate(segments):
        seg = (params["mamba"][si] if presliced
               else slice_stack(params["mamba"], start, end))
        for gi in range(end - start):
            grp = start + gi
            if states is None:      # JAX checkpoints the group's body; FSDP's
                # take runs inside it, so it is recomputed too
                take = ((lambda gi=gi, seg=seg: tree_map(lambda a: a[gi], seg))
                        if presliced else
                        (lambda grp=grp: take_layer(params["mamba"], grp, G, groups)))
                x = remat(cfg.remat, lambda h, take=take, spec=spec: _group(
                    h, take(), shared, cfg, spec, shared_spec), x)
                continue
            for li in range(per):
                lp = tree_map(lambda a: a[gi, li], seg)
                mst = {k: v[grp, li] for k, v in states["mamba"].items()}
                x, ns = mamba2_block(x, lp, cfg, spec, state=mst)
                for k, v in ns.items():
                    mst[k].copy_(v)
            ac = states["attn"]
            cache = {"k": ac["k"][grp], "v": ac["v"][grp], "len": ac["len"]}
            x, (k_new, v_new) = _shared_block(x, shared, cfg, shared_spec,
                                              cache=cache)
            cols = ac["len"].to(torch.int64) + torch.arange(x.shape[1], device=dev)
            ac["k"][grp][:, cols] = k_new.to(ac["k"].dtype)
            ac["v"][grp][:, cols] = v_new.to(ac["v"].dtype)
    taps = None
    if want_taps:      # the last shared-attention invocation (attention only)
        h = rmsnorm(x, shared["ln1"]["scale"])
        _, _, taps = attention_block(
            h, shared["attn"], **rank_heads(cfg, shared_spec), spec=shared_spec,
            causal=True, rope=True,
            rope_theta=cfg.rope_theta, want_taps=True)
        taps["hidden"] = x
    new_states = None
    if states is not None:
        new_states = {**states, "attn": {**states["attn"],
                                         "len": states["attn"]["len"] + x.shape[1]}}
    x = rmsnorm(x, params["final_norm"]["scale"])
    logits = lm_head_logits(x, params["lm_head"], cfg, groups)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return ((logits, new_states) + ((taps,) if want_taps else ())
            + ((aux,) if want_aux else ()))


def hybrid_states(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype, device) -> dict:
    """The token-mode decode state of ``batch`` rows: every Mamba2 layer's
    f32 ssm / conv state, stacked (G, per, ...), and every shared-block
    invocation's fp KV rows (G, B, max_len, Hkv, hd) in ``dtype`` behind one
    0-d cursor."""
    G, per = _groups(cfg)
    one = mamba2_state_init(cfg, batch, device)
    mamba = {k: torch.zeros((G, per) + tuple(v.shape), dtype=v.dtype, device=device)
             for k, v in one.items()}
    kv = (G, batch, max_len, cfg.num_kv_heads, cfg.hd)
    attn = {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}
    return {"mamba": mamba, "attn": attn}
