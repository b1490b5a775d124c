"""The paper's Table 2 on the card: one transformer layer at float32, int8
and int4.

The paper reports one int4 layer 15x faster than a float32 layer on a T4
(its abstract; the JAX package's ``benchmarks/table2_speedup.py`` reads its
Table 2 as 15x over fp32 and 1.25x over int8). This runner asks the same
question of the port on the card: one ``bert-base`` layer (d 768, 12 heads,
d_ff 3072, post-LN, GELU, bidirectional) from ``transformer.init_block``,
weight scales from ``qat.calibrate_weight_scales``, packed codes from
``qat._quantize_stack`` (activation scales stay at their init value of 1,
as in the JAX spec), run through ``transformer.block_apply`` on the grid
of the JAX file: (batch, tokens) in (16, 110), (16, 168), (64, 26), (64,
36), (16, 1), (64, 1). Rows M = 1664-2688 take the wgmma GEMMs behind
act_quant; M = 16 and 64 take split-K, which quantizes inside the GEMM
(``kernels/gemm_plan.py``).

Rows per grid point:

* ``float32``: ``qlinear`` mode none with TF32 off, as the port sets it at
  import (``repro_torch/__init__.py``);
* ``float32_tf32`` (card only): the same with TF32 matmuls on, the flag
  restored afterwards;
* ``int8``: W8A8 through ``int8_matmul``;
* ``int4``: W4A4 through ``int4_matmul`` with a separate GELU, the JAX
  spec (``fuse_epilogue`` off);
* ``int4_fused``: the same with FFN-up on ``int4_matmul_fused`` (bias +
  GELU in the epilogue).

Each row reports the device ms of one layer call replayed from a CUDA
graph, the eager ms of the calls as the host issues them, and the least
time the card could take (``timing.bound``: every weight, bias, scale and
the layer's input read once and its output written once, over 3.35 TB/s;
the GEMM operations at the int8, TF32 or fp32 peak and the attention's two
fp32 products at the fp32 peak). Each grid point reports fp32 / int4 and
int8 / int4 on the device and on the eager times. On the CPU (``--device
cpu``, for tests) the rows carry host wall-clock ms of the plain versions
and no device time.

``python -m repro_torch.benchmarks.table2_speedup [--quick] [--device cpu]
[--out PATH]``
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Optional

import torch

from ..configs import get_config, reduced
from ..core.qat import _quantize_stack, calibrate_weight_scales
from ..device import resolve_device
from ..kernels.gemm_plan import gemm_plan
from ..models.layers import QuantSpec
from ..models.transformer import block_apply, init_block
from .timing import (FP32_OPS_PER_S, INT8_OPS_PER_S, TF32_OPS_PER_S, bound,
                     cuda_ms)

#: the JAX file's grid (``benchmarks/table2_speedup.py:86-87``)
GRID = ((16, 110), (16, 168), (64, 26), (64, 36), (16, 1), (64, 1))
#: ``--quick``: the JAX file's quick grid at the reduced bert-base width
QUICK_GRID = ((4, 110), (4, 168), (16, 1))
#: (row, qlinear mode, bits, fuse_epilogue, TF32)
ROWS = (("float32", "none", 0, False, False),
        ("float32_tf32", "none", 0, False, True),
        ("int8", "int", 8, False, False),
        ("int4", "int", 4, False, False),
        ("int4_fused", "int", 4, True, False))
#: the paper's per-layer ratios, quoted (T4, its own kernels)
PAPER = {"float32_over_int4": 15.0, "int8_over_int4": 1.25}


def layer_config(quick: bool = False):
    cfg = get_config("bert-base").replace(dtype="float32", remat=False)
    return reduced(cfg) if quick else cfg


def layer_params(cfg, bits: int, g: torch.Generator, device) -> dict:
    """One unstacked block: fp for ``bits == 0``, else calibrated weight
    scales and packed ``bits``-bit codes."""
    p = init_block(g, cfg, None, device)
    if bits:
        p = calibrate_weight_scales({"layers": p}, lambda prefix: float(bits))["layers"]
        p = _quantize_stack(p, bits)
    return p


def layer_spec(mode: str, bits: int, fuse: bool) -> QuantSpec:
    """The row's QuantSpec: the kernels' dispatch (``kernels/ops``), which
    CPU tensors take to the plain versions."""
    if mode == "none":
        return QuantSpec()
    return QuantSpec(mode="int", w_bits=bits, a_bits=bits, use_kernels=True,
                     fuse_epilogue=fuse)


def linears(cfg) -> list[tuple[int, int]]:
    """(K, N) of the layer's six GEMMs: q, k, v, o, FFN-up, FFN-down."""
    d, q, kv, f = (cfg.d_model, cfg.num_heads * cfg.hd,
                   cfg.num_kv_heads * cfg.hd, cfg.d_ff)
    return [(d, q), (d, kv), (d, kv), (q, d), (d, f), (f, d)]


def layer_bound(cfg, batch: int, seq: int, bits: int, tf32: bool) -> dict:
    """Bytes and operations of one layer call and the least time they take.
    Bytes: the input and output (f32), every weight at its width, the
    biases, weight scales (f32 a column) and norm parameters. Operations:
    2MKN a GEMM, at the int8 peak for integer rows, else TF32 or fp32; the
    attention's QK^T and PV, 2 * B * H * S^2 * hd each, at the fp32 peak
    (they stay fp32 einsums)."""
    M, d = batch * seq, cfg.d_model
    lin = linears(cfg)
    w_bytes = sum(K * N for K, N in lin) * (bits / 8 if bits else 4)
    side = sum(N for _, N in lin) * 4 * (2 if bits else 1) + 4 * d * 4
    nbytes = 2 * M * d * 4 + w_bytes + side
    gemm_ops = sum(2 * M * K * N for K, N in lin)
    attn_ops = 2 * 2 * batch * cfg.num_heads * seq * seq * cfg.hd
    peak = INT8_OPS_PER_S if bits else (TF32_OPS_PER_S if tf32 else FP32_OPS_PER_S)
    ms, by = bound(nbytes, (gemm_ops, attn_ops), (peak, FP32_OPS_PER_S))
    return {"bytes": nbytes, "gemm_ops": gemm_ops, "attention_ops": attn_ops,
            "bound_ms": ms, "bound_by": by}


def _host_ms(fn, iters: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


@contextlib.contextmanager
def tf32_matmuls(on: bool):
    """TF32 matmuls on or off inside the block, the flags restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def run(quick: bool = False, device=None, iters: int = 3) -> dict:
    """Every grid point x row: times, bounds and the GEMM paths, plus the
    ratios per grid point. ``iters``: host-timed calls a CPU row averages."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cfg = layer_config(quick)
    grid = QUICK_GRID if quick else GRID
    g = torch.Generator(device=dev).manual_seed(0)
    params = {bits: layer_params(cfg, bits, g, dev) for bits in (0, 8, 4)}
    rows, ratios = [], []
    for batch, seq in grid:
        M = batch * seq
        x = torch.randn((batch, seq, cfg.d_model), generator=g, device=dev)
        point = {}
        for name, mode, bits, fuse, tf32 in ROWS:
            if tf32 and not on_card:
                continue        # TF32 is a tensor-core mode of the card
            p, spec = params[bits], layer_spec(mode, bits, fuse)

            def fn(p=p, spec=spec):
                with torch.no_grad():
                    return block_apply(x, p, cfg, spec)[0]

            row = {"batch": batch, "tokens": seq, "M": M, "row": name,
                   "tf32": tf32, **layer_bound(cfg, batch, seq, bits, tf32)}
            if bits:
                row["paths"] = {f"{K}x{N}": gemm_plan(M, N, K, bits).name
                                for K, N in linears(cfg)}
            if on_card:
                with tf32_matmuls(tf32):
                    row["device_ms"] = cuda_ms(fn)
                    row["eager_ms"] = cuda_ms(fn, graph=False)
            else:
                row["device_ms"] = row["eager_ms"] = None   # not measured
                row["cpu_ms"] = _host_ms(fn, iters)
            rows.append(row)
            point[name] = row
        ratio = {"batch": batch, "tokens": seq, "M": M}
        for a in ("float32", "int8"):
            for key in (("device_ms", "eager_ms") if on_card else ("cpu_ms",)):
                ratio[f"{a}_over_int4_{key}"] = point[a][key] / point["int4"][key]
                ratio[f"{a}_over_int4_fused_{key}"] = (point[a][key]
                                                      / point["int4_fused"][key])
        ratios.append(ratio)
    out = {"bench": "table2_speedup", "quick": quick, "device": str(dev),
           "config": {"name": cfg.name, "d_model": cfg.d_model,
                      "num_heads": cfg.num_heads, "d_ff": cfg.d_ff},
           "rows": rows, "ratios": ratios, "paper": PAPER}
    if on_card:
        out["card"] = torch.cuda.get_device_name(dev)
    return out


def table(result: dict) -> str:
    """The rows as CSV lines, device and eager ms beside the bound."""
    key = "device_ms" if result["rows"] and result["rows"][0]["device_ms"] is not None \
        else "cpu_ms"
    lines = [f"table2,batch,tokens,row,{key},eager_ms,bound_ms,bound_by"]
    for r in result["rows"]:
        lines.append(f"table2,{r['batch']},{r['tokens']},{r['row']},{r[key]},"
                     f"{r['eager_ms']},{r['bound_ms']},{r['bound_by']}")
    for r in result["ratios"]:
        lines.append("table2_ratio," + ",".join(f"{k}={v}" for k, v in r.items()))
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the JAX quick grid at the reduced bert-base width")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args(argv)
    result = run(quick=args.quick, device=args.device)
    print(table(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
