#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. device and build: the card's name and power limit, the torch and CUDA
   versions, and the build of the four integer kernels from
   ``src/repro_torch/kernels/csrc`` with nvcc (timed);
2. every kernel against its plain PyTorch version on the card, at the
   serving shapes: M in {37, 512, 4096}, (K, N) in {(312, 312), (312, 1200),
   (1200, 312)}, both activation grids, plus an odd-K int4 case. Codes and
   unfused outputs must be bit-equal; the fused GELU epilogue must agree
   within rtol = atol = 1e-6;
3. end to end at the full tinybert4 width (vocab 30522, d 312, 12 heads,
   d_ff 1200, 4 layers) under the paper's mixed policy (W8A8 layers 0-1,
   W4A4 layers 2-3): fp params from a seeded generator on the card ->
   ``deploy`` with 4 calibration batches -> ``save`` -> ``load`` -> an
   encoder ``ServingEngine`` answering 16 classify/embed/score requests of
   4-128 tokens. Every request must finish, match the direct forward on
   the card (rtol 1e-5, atol 1e-6), equal the same artifact served on the
   card by the plain integer reference backend (every activation code
   equal, results within 1e-6), and match it served on the CPU: the first
   linear's codes equal, results within rtol = atol = 1e-4 for requests
   none of whose codes changed (atol 5e-2 for the others: a code that
   lands on the other side of a rounding boundary moves its row), the same
   argmax. The launch counts
   over that run must be 24/12/10/2 per forward, and no plain version may
   run on a CUDA tensor;
4. times with CUDA events (median of 20 samples after warm-up) of every
   kernel at M = 4096 (32 requests x 128 tokens) and each (K, N) of the
   path, beside its plain version, the library call where one exists
   (``torch._int_mm``; fp32 ``torch.matmul`` as the paper's float
   baseline) and its bound (bytes over 3.35 TB/s or operations over the
   published peak), plus a direct forward of 32 x 128 tokens.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
MATMUL_SHAPES = ((312, 312), (312, 1200), (1200, 312))
M_TIMED = 4096                 # 32 requests x 128 tokens
#: per forward of the mixed tinybert4 plan: (K, N) -> calls, per kernel
PER_FORWARD = {
    "act_quant": {(312, 8): 10, (1200, 8): 2, (312, 4): 10, (1200, 4): 2},
    "int8_matmul": {(312, 312): 8, (312, 1200): 2, (1200, 312): 2},
    "int4_matmul": {(312, 312): 8, (1200, 312): 2},
    "int4_matmul_fused": {(312, 1200): 2},
}
SOURCES = {
    "act_quant": ("src/repro_torch/kernels/csrc/act_quant.cu",
                  "src/repro/kernels/act_quant.py:42"),
    "int8_matmul": ("src/repro_torch/kernels/csrc/int8_matmul.cu",
                    "src/repro/kernels/int8_matmul.py:59"),
    "int4_matmul": ("src/repro_torch/kernels/csrc/int4_matmul.cu",
                    "src/repro/kernels/int4_matmul.py:105"),
    "int4_matmul_fused": ("src/repro_torch/kernels/csrc/int4_matmul.cu",
                          "src/repro/kernels/int4_matmul.py:143"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


# ------------------------------------------------------------------ phase 2
def check_kernels(dev) -> dict:
    """Each kernel against its plain version on the same inputs; returns
    the largest absolute difference per kernel."""
    import torch.nn.functional as F

    from repro_torch.core.packing import pack_int4
    from repro_torch.core.quantizer import qrange
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import int8_matmul as i8

    g = torch.Generator(device=dev).manual_seed(1234)
    err = {name: 0.0 for name in SOURCES}

    def same(name, got, want):
        if not torch.equal(got, want):
            diff = (got.double() - want.double()).abs().max().item()
            raise AssertionError(f"{name}: kernel != plain (max |diff| {diff})")

    def note(name, got, want):
        d = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
        err[name] = max(err[name], d)

    cases = [(M, K, N) for M in (37, 512, M_TIMED) for K, N in MATMUL_SHAPES]
    for M, K, N in cases:
        x = torch.randn((M, K), generator=g, device=dev) * 3.0
        s_w = torch.rand((1, N), generator=g, device=dev) * 0.01 + 1e-3
        bias = torch.randn((1, N), generator=g, device=dev)
        codes = {}
        for bits in (8, 4):
            # a scale that clips the tails, so both grid edges are exercised
            s = (x.abs().amax() * 0.6 / qrange(bits)[1]).reshape(())
            got, want = aq.act_quant_cuda(x, s, bits), aq.act_quant_plain(x, s, bits)
            same(f"act_quant M={M} K={K} bits={bits}", got, want)
            note("act_quant", got, want)
            codes[bits] = (got, s)
        x8, s_a = codes[8]
        w8 = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                           dtype=torch.int8)
        got, want = i8.int8_matmul_cuda(x8, w8, s_a, s_w), i8.int8_matmul_plain(x8, w8, s_a, s_w)
        same(f"int8_matmul M={M} K={K} N={N}", got, want)
        note("int8_matmul", got, want)
        x4, s_a4 = codes[4]
        wp = pack_int4(torch.randint(-7, 9, (K, N), generator=g, device=dev,
                                     dtype=torch.int8))
        got, want = i4.int4_matmul_cuda(x4, wp, s_a4, s_w), i4.int4_matmul_plain(x4, wp, s_a4, s_w)
        same(f"int4_matmul M={M} K={K} N={N}", got, want)
        note("int4_matmul", got, want)
        for act in ("none", "gelu", "relu"):
            got = i4.int4_matmul_fused_cuda(x4, wp, s_a4, s_w, bias, act)
            want = i4.int4_matmul_fused_plain(x4, wp, s_a4, s_w, bias, act)
            if act == "gelu":
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
            else:
                same(f"int4_matmul_fused[{act}] M={M} K={K} N={N}", got, want)
            note("int4_matmul_fused", got, want)
    # odd K: packing pads K to even and the activation codes get a zero column
    M, K, N = 37, 313, 200
    x4 = torch.randint(-7, 9, (M, K), generator=g, device=dev, dtype=torch.int8)
    x4 = F.pad(x4, (0, 1))
    wp = pack_int4(F.pad(torch.randint(-7, 9, (K, N), generator=g, device=dev,
                                       dtype=torch.int8), (0, 0, 0, 1)))
    s_a = torch.tensor(0.05, device=dev)
    s_w = torch.rand((1, N), generator=g, device=dev) * 0.01 + 1e-3
    got, want = i4.int4_matmul_cuda(x4, wp, s_a, s_w), i4.int4_matmul_plain(x4, wp, s_a, s_w)
    same("int4_matmul odd K", got, want)
    note("int4_matmul", got, want)
    torch.cuda.synchronize()
    return err


# ------------------------------------------------------------------ phase 3
def end_to_end(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.deploy import DeployedModel, ExecutionPlan, deploy
    from repro_torch.kernels import build
    from repro_torch.models.bert import init_bert_classifier
    from repro_torch.serving import EncodeRequest, ServingEngine

    cfg = get_config("tinybert4")
    policy = QuantPolicy(num_layers=cfg.num_layers, mode="int", last_k_int4=2)
    plan = ExecutionPlan.build(cfg, policy, backend="cuda", mode="encoder",
                               prefill_batch=4)
    g = torch.Generator(device=dev).manual_seed(0)
    fp = init_bert_classifier(cfg, 2, g, dev)
    rng = np.random.default_rng(0)
    calib = [{"tokens": rng.integers(1, cfg.vocab_size, (4, 16)).astype(np.int32)}
             for _ in range(4)]
    t0 = time.perf_counter()
    model = deploy(fp, plan, calib, device=dev)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    art = ROOT / "build" / "chip_smoke_artifact"
    model.save(str(art))
    loaded = DeployedModel.load(str(art), device=dev)
    if loaded.plan != plan:
        raise AssertionError("plan did not round-trip through the artifact")

    lengths = [4, 7, 8, 12, 16, 21, 31, 32, 40, 57, 64, 77, 96, 111, 127, 128]
    tasks = ("classify", "embed", "score")
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in lengths]

    def serve(m, on_batch=None):
        eng = ServingEngine(m, slots=8, max_len=128)
        if on_batch is not None:               # record each padded batch
            encode = eng.encode_batch

            def recorded(toks, lens):
                on_batch((np.array(toks), np.array(lens)))
                return encode(toks, lens)
            eng.encode_batch = recorded
        hs = [eng.submit_encode(EncodeRequest(tokens=p, task=tasks[i % 3]))
              for i, p in enumerate(prompts)]
        eng.run_until_drained()
        return eng, [h.result() for h in hs]

    serve(loaded)                                   # warm-up
    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.perf_counter()
    eng, results = serve(loaded)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    plain_on_cuda = dict(build.PLAIN_ON_CUDA)
    forwards = eng.metrics.summary()["encode_steps"]
    per_fwd = {name: sum(calls.values()) for name, calls in PER_FORWARD.items()}
    for name, n in per_fwd.items():
        if launches[name] != n * forwards:
            raise AssertionError(f"{name}: {launches[name]} launches over "
                                 f"{forwards} forwards, expected {n} each")
    if any(plain_on_cuda.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors: {plain_on_cuda}")

    want_shape = {"classify": (2,), "embed": (cfg.d_model,), "score": ()}
    err_direct = 0.0
    for p, r in zip(prompts, results):
        if r.finish_reason != "done":
            raise AssertionError(f"request {r.rid} finished {r.finish_reason!r}")
        val = np.asarray(r.value)
        if val.shape != want_shape[r.task] or not np.all(np.isfinite(val)):
            raise AssertionError(f"request {r.rid}: bad {r.task} result {val!r}")
        direct = eng.encode_batch(p[None], np.array([len(p)]))[r.task][0]
        direct = direct.cpu().numpy()
        np.testing.assert_allclose(val, direct, rtol=1e-5, atol=1e-6)
        err_direct = max(err_direct, float(np.abs(val - direct).max()))

    # Kernels vs the plain integer path, end to end on the card: the same
    # artifact under the reference backend (quantize_to_int + exact integer
    # matmul in PyTorch) must quantize the same codes and give the same
    # results as the kernel backend.
    ref_model = DeployedModel(plan=ExecutionPlan.build(
        cfg, policy, backend="reference", mode="encoder", prefill_batch=4),
        params=loaded.params)
    card_run, card_codes = served_codes(serve, loaded)
    ref_run, ref_codes = served_codes(serve, ref_model)
    for r, again, ref in zip(results, card_run["results"], ref_run["results"]):
        if not np.array_equal(np.asarray(r.value), np.asarray(again.value)):
            raise AssertionError(f"request {r.rid}: serving on the card is not "
                                 "deterministic")
        np.testing.assert_allclose(r.value, ref.value, rtol=1e-6, atol=1e-6,
                                   err_msg=f"request {r.rid}: kernels vs reference")
    flips_ref, _, _ = compare_codes(card_run["batches"], card_codes, ref_codes, prompts)
    if any(flips_ref):
        raise AssertionError(f"codes differ between the kernel and the reference "
                             f"backend on the card: {flips_ref}")
    err_ref = max(float(np.abs(np.asarray(r.value) - f.value).max())
                  for r, f in zip(results, ref_run["results"]))

    # The same artifact served on the CPU. Float results of the two devices
    # differ in the last bits; an activation whose x / s lies that close to
    # a rounding boundary gets another code, and through attention that one
    # code moves every later activation of its row (by s_a, about 0.5 in the
    # int4 layers). So: the first linear of every forward (it reads the
    # embeddings) quantizes identically; results of requests with no
    # changed code agree within rtol = atol = 1e-4; all agree within
    # atol 5e-2, and classify keeps its argmax.
    cpu_run, cpu_codes = served_codes(
        serve, DeployedModel.load(str(art), device="cpu"))
    flips, first_equal, n_codes = compare_codes(card_run["batches"], card_codes,
                                       cpu_codes, prompts)
    if not first_equal:
        raise AssertionError("first-linear codes differ between card and CPU")
    err_cpu = {"no_code_changed": 0.0, "codes_changed": 0.0}
    for r, c, nflip in zip(results, cpu_run["results"], flips):
        key = "codes_changed" if nflip else "no_code_changed"
        tol = dict(rtol=0.0, atol=5e-2) if nflip else dict(rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r.value, c.value, **tol,
                                   err_msg=f"request {r.rid}, {nflip} codes changed")
        err_cpu[key] = max(err_cpu[key], float(np.abs(np.asarray(r.value) - c.value).max()))
        if r.task == "classify" and np.argmax(r.value) != np.argmax(c.value):
            raise AssertionError(f"request {r.rid}: argmax differs from the CPU")
    return {"model": cfg.name, "policy": policy.describe(),
            "plan": plan.describe(), "requests": len(results),
            "forwards": forwards, "launches": launches,
            "per_forward": per_fwd, "plain_on_cuda": plain_on_cuda,
            "deploy_s": deploy_s, "serve_s": serve_s,
            "max_abs_err_vs_direct": err_direct,
            "max_abs_err_vs_reference_backend": err_ref,
            "codes_changed_card_vs_cpu": int(sum(flips)),
            "codes_compared_card_vs_cpu": n_codes,
            "requests_with_changed_codes": int(sum(1 for f in flips if f)),
            "max_abs_err_vs_cpu": err_cpu,
            "engine": eng, "plan_obj": plan}


def served_codes(serve, model):
    """Serve once more, recording every activation-code tensor the forwards
    quantize (kernel or reference backend) and every padded batch they run,
    in order."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    codes, batches = [], []
    originals = {(ops, "act_quant"): ops.act_quant,
                 (layers, "quantize_to_int"): layers.quantize_to_int}

    def spy(fn):
        def recorded(x, s, bits=8):
            out = fn(x, s, bits)
            codes.append(out.reshape(-1, out.shape[-1]).cpu().numpy())
            return out
        return recorded

    for (mod, name), fn in originals.items():
        setattr(mod, name, spy(fn))
    try:
        _, results = serve(model, on_batch=batches.append)
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    return {"results": results, "batches": batches}, codes


def compare_codes(batches, codes_a, codes_b, prompts):
    """Changed activation codes per request over the real (unpadded)
    positions of its row in each of the 24 quantized linears, whether the
    first linear of every forward agrees on all of them, and how many codes
    were compared."""
    if len(codes_a) != len(codes_b) or len(codes_a) != 24 * len(batches):
        raise AssertionError("the two runs quantized different linears")
    flips, rows, first_equal, total = [0] * len(prompts), [0] * len(prompts), True, 0
    for f, (toks, lens) in enumerate(batches):
        n, bucket = toks.shape
        for i in range(n):
            match = [r for r, p in enumerate(prompts)
                     if len(p) == lens[i] and np.array_equal(toks[i, :len(p)], p)]
            if not match:
                continue                       # a padding row
            rows[match[0]] += 1
            for j in range(24 * f, 24 * f + 24):
                a = codes_a[j].reshape(n, bucket, -1)[i, :lens[i]]
                b = codes_b[j].reshape(n, bucket, -1)[i, :lens[i]]
                changed = int((a != b).sum())
                total += a.size
                flips[match[0]] += changed
                first_equal &= not (j == 24 * f and changed)
    if rows != [1] * len(prompts):
        raise AssertionError(f"batch rows per request: {rows}")
    return flips, first_equal, total


# ------------------------------------------------------------------ phase 4
def cuda_ms(fn, samples: int = 20, reps: int = 10, warmup: int = 3,
            graph: bool = True) -> float:
    """Median over ``samples`` of the mean time of ``reps`` back-to-back
    calls, between CUDA events. ``graph=True`` captures the ``reps`` calls
    in a CUDA graph and times its replay: the device time, without the
    host's launch overhead between calls; ``graph=False`` times the calls
    as the eager path issues them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if graph:
        # warm up on the capture stream too (library handles and workspaces
        # are per stream), then capture there
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            for _ in range(reps):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(reps):
                fn()
    times = []
    for _ in range(samples):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def time_kernels(dev) -> list[dict]:
    from repro_torch.core.packing import pack_int4
    from repro_torch.core.quantizer import qrange
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import int8_matmul as i8

    g = torch.Generator(device=dev).manual_seed(7)
    M = M_TIMED
    rows = []

    def row(kernel, shape, calls, fn, plain_fn, nbytes, ops, peak,
            library_fn=None, fp32_fn=None):
        """Device times (CUDA-graph replay) of the kernel, its plain version
        and the library calls, plus the kernel's eager per-call time."""
        b_ms, b_by = bound(nbytes, ops, peak)
        rows.append({"kernel": kernel, "M": M, "shape": shape, "calls": calls,
                     "ms": cuda_ms(fn), "eager_ms": cuda_ms(fn, graph=False),
                     "plain_ms": cuda_ms(plain_fn),
                     "library_ms": None if library_fn is None else cuda_ms(library_fn),
                     "fp32_matmul_ms": None if fp32_fn is None else cuda_ms(fp32_fn),
                     "bound_ms": b_ms, "bound_by": b_by})

    for (K, bits), calls in PER_FORWARD["act_quant"].items():
        x = torch.randn((M, K), generator=g, device=dev)
        s = (x.abs().amax() / qrange(bits)[1]).reshape(())
        row("act_quant", [K, bits], calls,
            lambda: aq.act_quant_cuda(x, s, bits),
            lambda: aq.act_quant_plain(x, s, bits),
            M * K * 4 + 4 + M * K, 4 * M * K, FP32_OPS_PER_S)

    def operands(K, N):
        x8 = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
        x4 = torch.randint(-7, 9, (M, K), generator=g, device=dev, dtype=torch.int8)
        w8 = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
        wp = pack_int4(torch.randint(-7, 9, (K, N), generator=g, device=dev,
                                     dtype=torch.int8))
        s_a = torch.tensor(0.02, device=dev)
        s_w = torch.rand((1, N), generator=g, device=dev) * 0.01 + 1e-3
        bias = torch.randn((1, N), generator=g, device=dev)
        xf = torch.randn((M, K), generator=g, device=dev)
        wf = torch.randn((K, N), generator=g, device=dev)
        return x8, x4, w8, wp, s_a, s_w, bias, xf, wf

    for (K, N), calls in PER_FORWARD["int8_matmul"].items():
        x8, _, w8, _, s_a, s_w, _, xf, wf = operands(K, N)
        row("int8_matmul", [K, N], calls,
            lambda: i8.int8_matmul_cuda(x8, w8, s_a, s_w),
            lambda: i8.int8_matmul_plain(x8, w8, s_a, s_w),
            M * K + K * N + 4 + 4 * N + 4 * M * N, 2 * M * K * N, INT8_OPS_PER_S,
            library_fn=lambda: torch._int_mm(x8, w8),
            fp32_fn=lambda: torch.matmul(xf, wf))
    for (K, N), calls in PER_FORWARD["int4_matmul"].items():
        _, x4, _, wp, s_a, s_w, _, xf, wf = operands(K, N)
        row("int4_matmul", [K, N], calls,
            lambda: i4.int4_matmul_cuda(x4, wp, s_a, s_w),
            lambda: i4.int4_matmul_plain(x4, wp, s_a, s_w),
            M * K + K // 2 * N + 4 + 4 * N + 4 * M * N, 2 * M * K * N,
            INT8_OPS_PER_S, fp32_fn=lambda: torch.matmul(xf, wf))
    for (K, N), calls in PER_FORWARD["int4_matmul_fused"].items():
        _, x4, _, wp, s_a, s_w, bias, xf, wf = operands(K, N)
        row("int4_matmul_fused", [K, N], calls,
            lambda: i4.int4_matmul_fused_cuda(x4, wp, s_a, s_w, bias, "gelu"),
            lambda: i4.int4_matmul_fused_plain(x4, wp, s_a, s_w, bias, "gelu"),
            M * K + K // 2 * N + 4 + 8 * N + 4 * M * N, 2 * M * K * N,
            INT8_OPS_PER_S, fp32_fn=lambda: torch.matmul(xf, wf))
    return rows


def kernel_entries(rows, launches, errors) -> list[dict]:
    """One entry per kernel; times and bounds summed over the calls one
    forward of 32 x 128 tokens makes (per-shape numbers under 'per_shape')."""
    out = []
    for name, (src, replaces) in SOURCES.items():
        mine = [r for r in rows if r["kernel"] == name]
        lib = [r["library_ms"] for r in mine]
        total = lambda key: sum(r[key] * r["calls"] for r in mine)
        b_bytes = [r for r in mine if r["bound_by"] == "bytes"]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errors[name],
            "ms": total("ms"), "eager_ms": total("eager_ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "bytes" if len(b_bytes) * 2 >= len(mine) else "operations",
            "library_ms": (None if any(v is None for v in lib)
                           else sum(r["library_ms"] * r["calls"] for r in mine)),
            "per_shape": mine,
        })
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device_count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

    errors = check_kernels(dev)
    emit({"phase": "kernels_vs_plain", "max_abs_err": errors})

    e2e = end_to_end(dev)
    eng, plan = e2e.pop("engine"), e2e.pop("plan_obj")
    emit({"phase": "end_to_end", **e2e})

    rows = time_kernels(dev)
    for r in rows:
        emit({"phase": "kernel_time", **r})
    # a direct forward of 32 x 128 tokens: as the eager path runs it, and
    # replayed from a CUDA graph (device time, no host launch overhead)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        1, plan.cfg.vocab_size, (32, 128)), device=dev)
    lens = torch.full((32,), 128, dtype=torch.int32, device=dev)
    fwd = lambda: eng.encode_batch(toks, lens)
    eager_ms, device_ms = cuda_ms(fwd, reps=1, graph=False), cuda_ms(fwd, reps=1)
    kernels_ms = sum(r["ms"] * r["calls"] for r in rows)
    emit({"phase": "forward_32x128", "eager_ms": eager_ms,
          "eager_tokens_per_s": 32 * 128 / (eager_ms / 1e3),
          "device_ms": device_ms, "device_tokens_per_s": 32 * 128 / (device_ms / 1e3),
          "kernels_device_ms": kernels_ms, "kernels_share_of_device": kernels_ms / device_ms,
          "device_idle_share_eager": 1.0 - device_ms / eager_ms})

    entries = kernel_entries(rows, e2e["launches"], errors)
    report = ROOT / "chiprun_out" / "chip_smoke_report.json"
    report.parent.mkdir(exist_ok=True)
    report.write_text(json.dumps({"card": card, "kernels": entries,
                                  "end_to_end": e2e}, indent=2))
    emit({"kernels": entries})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
