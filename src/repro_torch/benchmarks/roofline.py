"""Roofline aggregation over the port's dry run: reads
``experiments/dryrun_torch/*.json`` (``launch/dryrun``) and prints, per
(arch x shape x layout):

  compute_ms / memory_ms / collective_ms  (per device, from the step's
  meta-device analysis on the H100's rates), the dominant term,
  MODEL_FLOPS = 6 N D (train) or 2 N_active D (prefill, decode), and the
  usefulness ratio MODEL_FLOPS / counted dot FLOPs (remat and MoE
  dispatch waste).

An ANALYTIC bytes column cross-checks the memory term of decode cells
(weights + KV-cache reads, over the card's memory rate). ``param_count``,
``model_flops`` and ``analytic_decode_bytes`` are the JAX package's
``benchmarks/roofline.py`` arithmetic, copied.

``python -m repro_torch.benchmarks.roofline [--dir DIR]`` (no device).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs import SHAPES, get_config
from .timing import HBM_BYTES_PER_S

DEFAULT_DIR = "experiments/dryrun_torch"


def param_count(cfg, active_only=False):
    """Non-embedding parameter count from the config (analytic)."""
    d, L = cfg.d_model, cfg.num_layers
    H, Hkv, hd, f = cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_ff
    attn = d * H * hd + 2 * d * Hkv * hd + H * hd * d
    if cfg.family == "moe":
        fe = cfg.expert_d_ff
        e_used = cfg.top_k if active_only else cfg.num_experts
        ffn = 3 * d * fe * e_used
        if cfg.shared_expert_d_ff:
            ffn += 3 * d * cfg.shared_expert_d_ff
        return L * (attn + ffn)
    if cfg.family == "xlstm":
        di = cfg.ssm_expand * d
        G = L // cfg.slstm_every
        n_m = L - G
        m = 2 * d * di + 3 * di * di + di * d
        s = 4 * d * d + d * d
        return n_m * m + G * s
    if cfg.family == "hybrid":
        di = cfg.ssm_expand * d
        Hs = di // cfg.ssm_head_dim
        N = cfg.ssm_state
        mamba = 2 * d * di + d * (2 * N + Hs) + di * d
        G = L // cfg.attn_every
        shared = attn + 3 * d * f
        # shared block: ONE weight set, applied G times (compute counts Gx)
        return L * mamba + shared * (G if active_only else 1)
    if cfg.family == "encdec":
        ffn = 2 * d * f if cfg.act == "gelu" else 3 * d * f
        return cfg.enc_layers * (attn + ffn) + cfg.dec_layers * (
            2 * attn + ffn)
    ffn = 3 * d * f if cfg.act == "swiglu" else 2 * d * f
    return L * (attn + ffn)


def model_flops(cfg, shape, chips):
    """Per-device useful model FLOPs for the cell."""
    D = shape.global_batch * shape.seq_len
    n = param_count(cfg, active_only=True)
    if shape.kind == "train":
        return 6 * n * D / chips
    if shape.kind == "prefill":
        return 2 * n * D / chips
    # decode: one token per sequence; active params only
    return 2 * n * shape.global_batch / chips


def analytic_decode_bytes(cfg, shape, chips, policy="mkq50"):
    """weights (mixed int4/int8) + KV reads per decode step, per device."""
    n = param_count(cfg)
    wbytes = n * 0.75  # 50% int4 (0.5 B) + 50% int8 (1 B)
    B, S = shape.global_batch, shape.seq_len
    if cfg.family in ("xlstm", "hybrid"):
        kv = 0
        if cfg.family == "hybrid":
            G = cfg.num_layers // cfg.attn_every
            kv = G * B * S * cfg.num_kv_heads * cfg.hd * 2 * 2
        di = cfg.ssm_expand * cfg.d_model
        state = cfg.num_layers * B * (di // cfg.ssm_head_dim) * \
            cfg.ssm_head_dim * cfg.ssm_state * 4 * 2
        return (wbytes + kv + state) / chips
    L = cfg.dec_layers if cfg.family == "encdec" else cfg.num_layers
    kv = L * B * S * cfg.num_kv_heads * cfg.hd * 2 * 2
    return (wbytes + kv) / chips


def load_cells(out_dir=DEFAULT_DIR):
    cells = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def main(out_dir=DEFAULT_DIR) -> list:
    """Print the CSV; returns its rows (dicts)."""
    rows = []
    print("roofline,arch,shape,mesh,status,compute_ms,memory_ms,"
          "collective_ms,dominant,model_tflops,useful_ratio,"
          "analytic_mem_ms,fits_80g")
    for c in load_cells(out_dir):
        if c.get("tag"):
            continue
        if c["status"] != "ok":
            rows.append({"arch": c["arch"], "shape": c["shape"],
                         "mesh": c["mesh"], "status": c["status"]})
            print(f"roofline,{c['arch']},{c['shape']},{c['mesh']},"
                  f"{c['status']},,,,,,,,")
            continue
        cfg = get_config(c["arch"])
        shape = SHAPES[c["shape"]]
        chips = c["chips"]
        t = c["roofline_terms_s"]
        mf = model_flops(cfg, shape, chips)
        ratio = mf / max(c["op_analysis"]["flops"], 1)
        amem = None
        if shape.kind == "decode":
            amem = analytic_decode_bytes(cfg, shape, chips) / HBM_BYTES_PER_S * 1e3
        rows.append({"arch": c["arch"], "shape": c["shape"], "mesh": c["mesh"],
                     "status": "ok", "compute_ms": t["compute_s"] * 1e3,
                     "memory_ms": t["memory_s"] * 1e3,
                     "collective_ms": t["collective_s"] * 1e3,
                     "dominant": c["dominant"], "model_tflops": mf / 1e12,
                     "useful_ratio": ratio, "analytic_mem_ms": amem,
                     "fits_80g": c["memory"]["fits_80g"]})
        print(f"roofline,{c['arch']},{c['shape']},{c['mesh']},ok,"
              f"{t['compute_s'] * 1e3:.2f},{t['memory_s'] * 1e3:.2f},"
              f"{t['collective_s'] * 1e3:.2f},{c['dominant']},"
              f"{mf / 1e12:.3f},{ratio:.3f},"
              f"{'' if amem is None else f'{amem:.3f}'},"
              f"{c['memory']['fits_80g']}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=DEFAULT_DIR)
    main(ap.parse_args().dir)
