#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. device and build: the card's name and power limit, the torch and CUDA
   versions, and the build of the five kernels from
   ``src/repro_torch/kernels/csrc`` with nvcc (one process per source, timed);
2. the four integer kernels against their plain PyTorch versions on the
   card, at the encoder shapes (M in {37, 512, 4096}, (K, N) in {(312, 312),
   (312, 1200), (1200, 312)}, both activation grids, an odd-K int4 case) and
   at the decode shapes with bf16 activations (M = 8, (K, N) in {(2560,
   2560), (2560, 6912), (6912, 2560)}). Codes and unfused outputs must be
   bit-equal, f32 and bf16 alike; the fused GELU epilogue within rtol = atol
   = 1e-6;
3. the encoder path end to end at the full tinybert4 width (vocab 30522, d
   312, 12 heads, d_ff 1200, 4 layers; W8A8 layers 0-1, W4A4 layers 2-3):
   fp params from a seeded generator on the card -> ``deploy`` with 4
   calibration batches -> ``save`` -> ``load`` -> an encoder
   ``ServingEngine`` answering 16 classify/embed/score requests of 4-128
   tokens, held against the direct forward, the plain reference backend on
   the card and the CPU (codes and tolerances as documented there); 24/12/10/2
   launches per forward and no plain version on a CUDA tensor;
4. encoder times with CUDA events (median of 20 samples after warm-up) at M
   = 4096 (32 requests x 128 tokens), beside the plain versions, the
   library calls and the bounds, and a direct forward of 32 x 128 tokens;
5. ``decode_attention`` against its plain version on the card: kv_bits 8
   and 4, q in f32 and bf16, (H, Hkv, dh) in {(32, 32, 80) stablelm-3b,
   (48, 8, 128) internlm2-20b}, B = 8, S in {64, 512, 520}, lengths
   including 0, 1, S and S + 37 (an idle slot). Within atol 1e-5 (rtol 0)
   for f32 and one bf16 ulp plus 1e-5 for bf16; poisoning every row past
   each slot's length must leave the kernel's output bit-unchanged;
6. the decoder path end to end at the full stablelm-3b width and depth (32
   layers, d 2560, 32 heads of 80, d_ff 6912 SwiGLU, vocab 50304 padded to
   50432, bf16 activations) under the JAX serve CLI's policy (W8A8 layers
   0-15, W4A4 layers 16-31): fp params from a seeded generator on the card
   -> ``deploy`` with 4 calibration batches of (4, 32) tokens -> ``save``
   under ``build/`` -> ``load`` -> ``ServingEngine(slots=8, max_len=512)``
   at kv_bits 8 and at kv_bits 4 (a second plan over the same params),
   serving 16 greedy requests (prompts of 5-384 tokens, 16-64 new tokens)
   and one sampled request (temperature 0.8, top_k 50, top_p 0.9, n = 2).
   Every request must finish and a repeated run must give the same tokens;
   every decode step must launch act_quant 224, int8_matmul 112,
   int4_matmul 112 and decode_attention 32 times, prefill no
   decode_attention, and no plain version may run on a CUDA tensor. The
   same artifact under the plain reference backend on the card must give
   the same first tokens (prefill runs no decode kernel and the integer
   GEMMs are exact), and each greedy stream must equal it or first differ
   at a near-tie: there, the reference run's logit of the kernel's token
   is below its top logit by at most twice the largest logit difference
   (over the whole vocabulary) the two backends show on the steps where
   their histories agree, plus one bf16 ulp. (The reference path attends
   in bf16: it rounds the dequantized cache, the scores and the
   probabilities to bf16, the kernel keeps f32 until its one rounding. The
   random-weight W4A4 stack amplifies such a difference: one changed
   activation code moves every later one of its row. That measured
   difference is the noise a tie is held against.) Then one decode step
   from one cache of 8 x 256 prefilled tokens under the kernels, under the
   kernels with decode attention's plain f32 version, and under the
   reference backend, which shows where the backends part; the prefill
   logits of the two backends must be bit-equal;
7. decode times: one decode step with 8 active slots at cache length 448,
   eager and replayed from a CUDA graph (tokens/s, the device's idle
   share), a prefill forward of 4 x 256 tokens, and each kernel at its
   decode shapes beside its plain version, the library call
   (``torch._int_mm`` where it accepts M = 8; SDPA over a cache already
   dequantized to bf16, which excludes the dequantization) and its bound.

The line before the last holds the five kernels; the last line of standard
output is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero before printing any result.
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
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
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
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:102"),
}
#: kernels each main path must launch
ENCODER_KERNELS = ("act_quant", "int8_matmul", "int4_matmul", "int4_matmul_fused")
DECODER_KERNELS = ("act_quant", "int8_matmul", "int4_matmul", "decode_attention")
#: stablelm-3b decode shapes: (K, N) -> calls per decode step, per kernel
DECODE_MATMULS = {(2560, 2560): 4 * 16, (2560, 6912): 2 * 16, (6912, 2560): 1 * 16}
DECODE_ACT_QUANT = {2560: 6 * 32, 6912: 1 * 32}
PER_DECODE_STEP = {"act_quant": 224, "int8_matmul": 112, "int4_matmul": 112,
                   "decode_attention": 32}
DECODE_SLOTS, DECODE_MAX_LEN, DECODE_LEN = 8, 512, 448



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
    # the decode shapes, bf16 activations: codes and bf16 outputs bit-equal
    bf = dict(out_dtype=torch.bfloat16)
    for K, N in DECODE_MATMULS:
        x = (torch.randn((8, K), generator=g, device=dev) * 3.0).to(torch.bfloat16)
        s_w = torch.rand((1, N), generator=g, device=dev) * 0.01 + 1e-3
        bias = torch.randn((1, N), generator=g, device=dev)
        codes = {}
        for bits in (8, 4):
            s = (x.float().abs().amax() * 0.6 / qrange(bits)[1]).reshape(())
            got, want = aq.act_quant_cuda(x, s, bits), aq.act_quant_plain(x, s, bits)
            same(f"act_quant bf16 K={K} bits={bits}", got, want)
            note("act_quant", got, want)
            codes[bits] = (got, s)
        x8, s_a = codes[8]
        w8 = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                           dtype=torch.int8)
        got = i8.int8_matmul_cuda(x8, w8, s_a, s_w, **bf)
        want = i8.int8_matmul_plain(x8, w8, s_a, s_w, **bf)
        same(f"int8_matmul bf16 M=8 K={K} N={N}", got, want)
        note("int8_matmul", got, want)
        x4, s_a4 = codes[4]
        wp = pack_int4(torch.randint(-7, 9, (K, N), generator=g, device=dev,
                                     dtype=torch.int8))
        got = i4.int4_matmul_cuda(x4, wp, s_a4, s_w, **bf)
        want = i4.int4_matmul_plain(x4, wp, s_a4, s_w, **bf)
        same(f"int4_matmul bf16 M=8 K={K} N={N}", got, want)
        note("int4_matmul", got, want)
        for act in ("none", "relu"):
            got = i4.int4_matmul_fused_cuda(x4, wp, s_a4, s_w, bias, act, **bf)
            want = i4.int4_matmul_fused_plain(x4, wp, s_a4, s_w, bias, act, **bf)
            same(f"int4_matmul_fused[{act}] bf16 M=8 K={K} N={N}", got, want)
            note("int4_matmul_fused", got, want)
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


def _sums(rows) -> dict:
    """Times and bounds of ``rows`` summed over their calls per unit of work
    (one forward, or one decode step)."""
    total = lambda key: sum(r[key] * r["calls"] for r in rows)
    lib = [r["library_ms"] for r in rows]
    n_bytes = sum(1 for r in rows if r["bound_by"] == "bytes")
    return {"ms": total("ms"), "eager_ms": total("eager_ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "bytes" if n_bytes * 2 >= len(rows) else "operations",
            "library_ms": (None if any(v is None for v in lib)
                           else sum(r["library_ms"] * r["calls"] for r in rows))}


def kernel_entries(enc_rows, dec_rows, launches_by_path, errors) -> list[dict]:
    """One entry per kernel. Kernels on the decoder path report their time
    per decode step (8 slots, cache length 448, stablelm-3b) and carry the
    encoder forward's numbers under 'encoder_forward'; int4_matmul_fused,
    on the encoder path only, reports per forward of 32 x 128 tokens.
    ``launches`` sums the main-path runs (``launches_by_path``)."""
    out = []
    for name, (src, replaces) in SOURCES.items():
        enc = [r for r in enc_rows if r["kernel"] == name]
        dec_all = [r for r in dec_rows if r["kernel"] == name]
        dec = [r for r in dec_all if r["kv_bits"] in (None, 8)]
        by_path = {path: counts[name] for path, counts in launches_by_path.items()
                   if counts[name]}
        main = _sums(dec) if dec else _sums(enc)
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": sum(by_path.values()), "launches_by_path": by_path,
                 "max_abs_err": errors[name], **main,
                 "per": ("decode step at kv_bits 8, 8 slots at cache length 448"
                         if dec else "encoder forward of 32 x 128 tokens"),
                 "per_shape": dec_all or enc}
        if dec and enc:
            entry["encoder_forward"] = {**_sums(enc), "per_shape": enc}
        out.append(entry)
    return out


# ------------------------------------------------------------------ phase 5
def decode_inputs(dev, g, B, S, H, Hkv, dh, bits, dtype, lengths):
    """Random K/V quantized by the port's own ``quantize_kv``, q and the
    new token's K/V in ``dtype``, per-slot ``lengths``."""
    from repro_torch.kernels import kv_pack
    k_q, k_s = kv_pack.quantize_kv(torch.randn((B, S, Hkv, dh), generator=g, device=dev), bits)
    v_q, v_s = kv_pack.quantize_kv(torch.randn((B, S, Hkv, dh), generator=g, device=dev), bits)
    q = torch.randn((B, H, dh), generator=g, device=dev).to(dtype)
    kn = torch.randn((B, Hkv, dh), generator=g, device=dev).to(dtype)
    vn = torch.randn((B, Hkv, dh), generator=g, device=dev).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return [q, k_q, v_q, k_s, v_s, kn, vn, lens]


def decode_close(got, want) -> float:
    """f32: atol 1e-5, rtol 0. bf16: one ulp of the output plus 1e-5 (the
    two softmax orders differ in f32 by up to 1e-5, which outputs near zero
    keep after rounding). Returns the largest |difference|."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if got.dtype == torch.float32:
        ok = bool((diff <= 1e-5).all())
    else:
        ulp = 2.0 ** (torch.frexp(torch.maximum(g.abs(), w.abs())).exponent - 8)
        ok = bool((diff <= ulp + 1e-5).all())
    if not ok:
        raise AssertionError(f"decode_attention: kernel != plain (max |diff| "
                             f"{diff.max().item()})")
    return diff.max().item()


def check_decode_attention(dev) -> float:
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain)
    g = torch.Generator(device=dev).manual_seed(77)
    err, cases = 0.0, 0
    for H, Hkv, dh in ((32, 32, 80), (48, 8, 128)):
        for S in (64, 512, 520):
            lengths = [0, 1, 7, 33, S // 2, S - 1, S, S + 37]
            for bits in (8, 4):
                for dtype in (torch.float32, torch.bfloat16):
                    args = decode_inputs(dev, g, 8, S, H, Hkv, dh, bits, dtype, lengths)
                    got = decode_attention_cuda(*args)
                    err = max(err, decode_close(got, decode_attention_plain(*args)))
                    for i, n in enumerate(lengths):        # poison past the length
                        args[1][i, n:] = 0x5A if bits == 8 else 0xF3
                        args[2][i, n:] = 0x5A if bits == 8 else 0xF3
                        args[3][i, n:] = 3.0e4
                        args[4][i, n:] = 3.0e4
                    if not torch.equal(decode_attention_cuda(*args), got):
                        raise AssertionError(
                            f"decode_attention H={H} Hkv={Hkv} dh={dh} S={S} "
                            f"bits={bits} {dtype}: rows past the length moved "
                            "the output")
                    cases += 1
    torch.cuda.synchronize()
    return err, cases


# ------------------------------------------------------------------ phase 6
def decode_traffic(vocab: int):
    """16 greedy requests (prompts of 5-384 tokens, 16-64 new tokens) and
    one sampled request with n = 2, from a fixed seed."""
    from repro_torch.serving import GenerationRequest, SamplingParams
    rng = np.random.default_rng(12)
    plens = [5, 9, 17, 24, 33, 48, 64, 80, 100, 128, 160, 200, 256, 300, 350, 384]
    news = [16, 64, 32, 48, 64, 16, 40, 24, 64, 32, 48, 16, 56, 24, 40, 64]
    reqs = [GenerationRequest(prompt=rng.integers(1, vocab, n).astype(np.int32),
                              max_new_tokens=m) for n, m in zip(plens, news)]
    reqs.append(GenerationRequest(
        prompt=rng.integers(1, vocab, 40).astype(np.int32), max_new_tokens=32,
        sampling=SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=7, n=2)))
    return reqs


def serve_decode(model, *, launches=None, tops=None, other=None):
    """Serve the decode traffic on a fresh engine; returns the results in
    submission order (the sampled request's two samples last).
    ``launches`` (a dict) collects the kernel launches of every prefill and
    decode forward. ``tops`` (a dict) collects, per request, one record per
    decode-sampled position: the top-eight logits and token ids and, unless
    ``other`` is given, the logits row itself (kept on the card). ``other``
    = (results, tops) of an earlier run: each record then also holds the
    logit here of the token that run sampled at that position, and the
    largest |logit difference| over the vocabulary to that run's row."""
    import copy

    import repro_torch.serving.engine as engine_mod
    from repro_torch.kernels import build
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(model, slots=DECODE_SLOTS, max_len=DECODE_MAX_LEN)
    if launches is not None:
        launches.update(prefill=[], decode=[])

        def delta(fn, kind):
            def wrapped(*a, **k):
                before = dict(build.LAUNCHES)
                out = fn(*a, **k)
                launches[kind].append({n: build.LAUNCHES[n] - before[n] for n in before})
                return out
            return wrapped
        eng.prefill_forward = delta(eng.prefill_forward, "prefill")
        eng.decode_forward = delta(eng.decode_forward, "decode")
    streams = []
    for req in decode_traffic(model.plan.cfg.vocab_size):
        out = eng.submit(copy.deepcopy(req))
        streams += out if isinstance(out, list) else [out]
    orig = engine_mod.sample_batch
    if tops is not None:
        other_tokens = {} if other is None else {r.rid: r.tokens for r in other[0]}

        def spy(logits, *a):
            lf = logits.float()
            v, i = torch.topk(lf, 8, dim=-1)
            v, i = v.cpu().tolist(), i.cpu().tolist()
            for s, req in enumerate(eng.scheduler.active):
                if req is None:
                    continue
                seen = tops.setdefault(req.rid, [])
                j = len(seen)        # this samples token j + 1 of the request
                rec = {"vals": v[s], "ids": i[s]}
                if other is None:
                    rec["row"] = lf[s].clone()
                else:
                    toks, rows = other_tokens[req.rid], other[1][req.rid]
                    if j + 1 < len(toks):
                        rec["other_token_logit"] = lf[s, int(toks[j + 1])].item()
                    if j < len(rows):
                        rec["max_diff"] = (lf[s] - rows[j]["row"]).abs().max().item()
                seen.append(rec)
            return orig(logits, *a)
        engine_mod.sample_batch = spy
    try:
        eng.run_until_drained()
    finally:
        engine_mod.sample_batch = orig
    results = [st.result() for st in streams]
    for r in results:
        if r.finish_reason not in ("length", "stop"):
            raise AssertionError(f"request {r.rid} finished {r.finish_reason!r}")
    return eng, results


def compare_streams(kv, results, ref, ref_tops, n_greedy) -> dict:
    """Kernel backend vs reference backend, request by request (see phase 6
    in the module docstring). Token j >= 1 of a request is sampled at its
    decode step j - 1; ``ref_tops`` are the reference run's records, taken
    against the kernel run (``serve_decode(other=...)``)."""
    noise = 0.0    # largest |logit difference| on steps with equal histories
    parted = []
    for i, (r, f) in enumerate(zip(results, ref)):
        if r.tokens[0] != f.tokens[0]:
            raise AssertionError(f"kv{kv} request {i}: first token "
                                 f"{r.tokens[0]} vs reference {f.tokens[0]}")
        if i >= n_greedy:
            continue
        n = min(len(r.tokens), len(f.tokens))
        diff = np.nonzero(r.tokens[:n] != f.tokens[:n])[0]
        upto = int(diff[0]) if len(diff) else n
        for j in range(1, upto):
            noise = max(noise, ref_tops[f.rid][j - 1]["max_diff"])
        if len(diff):
            rec = ref_tops[f.rid][upto - 1]
            gap = rec["vals"][0] - rec["other_token_logit"]
            parted.append({"request": i, "step": upto,
                           "kernel_token": int(r.tokens[upto]),
                           "reference_top8": rec["ids"],
                           "reference_top8_logits": rec["vals"],
                           "gap": gap, "max_diff_there": rec["max_diff"],
                           "ulp": bf16_ulp(rec["vals"][0])})
    for p in parted:
        if p["gap"] > 2 * noise + p["ulp"]:
            raise AssertionError(
                f"kv{kv} request {p['request']}: the streams part at step "
                f"{p['step']} on token {p['kernel_token']} (reference top 8: "
                f"{p['reference_top8']}, logits {p['reference_top8_logits']}), "
                f"{p['gap']} below the reference's top logit > 2 x {noise} + "
                f"{p['ulp']}, the backends' largest logit difference on equal "
                "histories plus one bf16 ulp")
    return {"greedy_equal_to_reference": n_greedy - len(parted),
            "greedy_streams": n_greedy, "logit_diff_max": noise,
            "parted_at_near_ties": parted}


def one_step_agreement(model, ref_model, dev) -> dict:
    """Where the kernel and reference backends part: prefill 8 prompts of
    256 tokens under both (the same code but for the integer linears), then
    one decode step from the same quantized cache under (a) the kernels,
    (b) the kernels with decode attention's plain f32 version and (c) the
    reference backend, which attends in bf16. The prefill logits must be
    bit-equal (the integer GEMMs are exact). Returns the largest |logit
    difference| of each pair and how many of the 8 argmaxes agree."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.serving import SlotKVCache

    plan = model.plan
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        1, plan.cfg.vocab_size, (DECODE_SLOTS, 256)), device=dev)
    with torch.no_grad():
        pre = {}
        for name, m in (("kernels", model), ("reference", ref_model)):
            st = m.plan.decode_state(DECODE_SLOTS, 256, kv_bits=16, device=dev)
            pre[name] = api.forward(m.params, m.plan, state=st, tokens=toks)
        cache = SlotKVCache.from_plan(plan, DECODE_SLOTS, DECODE_MAX_LEN, device=dev)
        for s in range(DECODE_SLOTS):
            cache.insert_prefill(s, pre["kernels"][1], 256, 256, row=s)
        nxt = pre["kernels"][0][:, -1].float().argmax(-1, keepdim=True)

        def step(m):
            st = {k: v.clone() for k, v in cache.state.items()}
            return api.forward(m.params, m.plan, state=st, tokens=nxt)[0][:, -1].float()
        kern, ref = step(model), step(ref_model)
        orig = ops.decode_attention
        ops.decode_attention = lambda q, *a: da.decode_attention_plain(
            q, *a[:-1], a[-1].to(torch.int32))
        try:
            plain = step(model)
        finally:
            ops.decode_attention = orig
    pk, pr = pre["kernels"][0].float(), pre["reference"][0].float()
    if not torch.equal(pk, pr):
        raise AssertionError(f"{plan.describe()}: prefill logits differ between "
                             "the kernel and the reference backend")

    def agree(a, b):
        return int((a.argmax(-1) == b.argmax(-1)).sum())
    return {"prefill_logits_max_diff": (pk - pr).abs().max().item(),
            "prefill_argmax_equal": agree(pk[:, -1], pr[:, -1]),
            "step_kernels_vs_plain_attention": {
                "max_diff": (kern - plain).abs().max().item(),
                "argmax_equal": agree(kern, plain)},
            "step_kernels_vs_reference": {
                "max_diff": (kern - ref).abs().max().item(),
                "argmax_equal": agree(kern, ref)}}


def bf16_ulp(x: float) -> float:
    import math
    return 2.0 ** (math.frexp(abs(x))[1] - 8) if x else 2.0 ** -133


def decode_end_to_end(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.deploy import DeployedModel, ExecutionPlan, deploy
    from repro_torch.kernels import build
    from repro_torch.models import api

    cfg = get_config("stablelm-3b")
    n = cfg.num_layers
    policy = QuantPolicy(num_layers=n, mode="int", last_k_int4=n // 2)
    plans = {kv: ExecutionPlan.build(cfg, policy, backend="cuda", mode="decode",
                                     kv_bits=kv, prefill_batch=4) for kv in (8, 4)}
    t0 = time.perf_counter()
    fp = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    fp_params = sum(int(t.numel()) for t in _leaves(fp))
    rng = np.random.default_rng(0)
    calib = [{"tokens": rng.integers(1, cfg.vocab_size, (4, 32)).astype(np.int32)}
             for _ in range(4)]
    model = deploy(fp, plans[8], calib, device=dev)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    del fp
    torch.cuda.empty_cache()
    art = ROOT / "build" / "chip_smoke_decode_artifact"
    t0 = time.perf_counter()
    model.save(str(art))
    del model
    loaded = DeployedModel.load(str(art), device=dev)
    torch.cuda.synchronize()
    save_load_s = time.perf_counter() - t0
    if loaded.plan != plans[8]:
        raise AssertionError("decode plan did not round-trip through the artifact")
    art_bytes = sum(f.stat().st_size for f in art.iterdir())
    out = {"model": cfg.name, "policy": policy.describe(), "fp_params": fp_params,
           "deploy_s": deploy_s, "save_load_s": save_load_s,
           "artifact_bytes": art_bytes, "per_kv": {}}
    models = {}
    for kv, plan in plans.items():
        model = DeployedModel(plan=plan, params=loaded.params)
        models[kv] = model
        serve_decode(model)                         # warm-up
        torch.cuda.synchronize()
        record = {}
        build.reset_counts()
        t0 = time.perf_counter()
        eng, results = serve_decode(model, launches=record)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches, plain = dict(build.LAUNCHES), dict(build.PLAIN_ON_CUDA)
        if any(plain.values()):
            raise AssertionError(f"plain versions ran on CUDA tensors: {plain}")
        for step in record["decode"]:
            if {k: step[k] for k in PER_DECODE_STEP} != PER_DECODE_STEP:
                raise AssertionError(f"kv{kv}: decode step launched {step}, "
                                     f"expected {PER_DECODE_STEP}")
        for step in record["prefill"]:
            if step["decode_attention"] or step["act_quant"] != PER_DECODE_STEP["act_quant"]:
                raise AssertionError(f"kv{kv}: prefill launched {step}")
        tops, ref_tops = {}, {}
        _, again = serve_decode(model, tops=tops)
        for r, a in zip(results, again):
            if not np.array_equal(r.tokens, a.tokens):
                raise AssertionError(f"kv{kv} request {r.rid}: serving is not "
                                     "deterministic")
        # the plain reference backend on the card, same artifact
        ref_plan = ExecutionPlan.build(cfg, policy, backend="reference",
                                       mode="decode", kv_bits=kv, prefill_batch=4)
        _, ref = serve_decode(DeployedModel(plan=ref_plan, params=loaded.params),
                              tops=ref_tops, other=(again, tops))
        del tops                                    # the logits rows on the card
        cmp = compare_streams(kv, again, ref, ref_tops, n_greedy=16)
        build.reset_counts()
        cmp["one_step"] = one_step_agreement(
            model, DeployedModel(plan=ref_plan, params=loaded.params), dev)
        summary = eng.metrics.summary()
        out["per_kv"][kv] = {
            "plan": plan.describe(), "requests": len(results),
            "tokens": int(sum(len(r.tokens) for r in results)),
            "decode_steps": len(record["decode"]), "prefill_forwards": len(record["prefill"]),
            "launches": launches, "plain_on_cuda": plain, "serve_s": serve_s,
            **cmp,
            "decode_p50_ms": summary.get("decode_p50_ms"),
            "prefill_p50_ms": summary.get("prefill_p50_ms"),
            "ttft_p50_ms": summary.get("ttft_p50_ms")}
    out["models"] = models
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------------ phase 7
def decode_state_at(model, dev, length: int):
    """A full slot cache of ``model``'s plan with every slot at ``length``
    and random codes and scales."""
    st = model.plan.decode_state(DECODE_SLOTS, DECODE_MAX_LEN, per_slot_len=True,
                                 device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    for key in ("k_q", "v_q"):
        st[key].copy_(torch.randint(0, 255, st[key].shape, generator=g, device=dev,
                                    dtype=torch.int32).to(st[key].dtype))
    for key in ("k_scale", "v_scale"):
        st[key].copy_(torch.rand(st[key].shape, generator=g, device=dev) * 0.05)
    st["len"].fill_(length)
    return st


def time_decode(models, dev) -> dict:
    """One decode step with 8 active slots at cache length 448 (eager and
    CUDA-graph replay) and a prefill forward of 4 x 256 tokens."""
    from repro_torch.models import api
    from repro_torch.serving import ServingEngine, sample_batch

    out = {}
    zeros = np.zeros(DECODE_SLOTS)
    for kv, model in models.items():
        st = decode_state_at(model, dev, DECODE_LEN)
        toks = torch.randint(1, model.plan.cfg.vocab_size, (DECODE_SLOTS, 1),
                             device=dev)

        def step():
            # the engine's decode step on a fixed state: the cursors stay at
            # 448 because forward returns the advanced cursor as a new tensor
            with torch.no_grad():
                logits, _ = api.forward(model.params, model.plan, state=st, tokens=toks)
                return sample_batch(logits[:, -1], zeros, zeros, zeros, zeros,
                                    np.ones(DECODE_SLOTS))
        eager = cuda_ms(step, reps=1, samples=10, graph=False)
        device = cuda_ms(step, reps=1, samples=10)
        out[f"decode_step_kv{kv}"] = {
            "slots": DECODE_SLOTS, "cache_len": DECODE_LEN,
            "eager_ms": eager, "device_ms": device,
            "eager_tokens_per_s": DECODE_SLOTS / (eager / 1e3),
            "device_tokens_per_s": DECODE_SLOTS / (device / 1e3),
            "device_idle_share_eager": 1.0 - device / eager}
    model = models[8]
    eng = ServingEngine(model, slots=DECODE_SLOTS, max_len=DECODE_MAX_LEN)
    ptoks = torch.randint(1, model.plan.cfg.vocab_size, (4, 256), device=dev)
    fwd = lambda: eng.prefill_forward(ptoks)
    eager = cuda_ms(fwd, reps=1, samples=5, graph=False)
    device = cuda_ms(fwd, reps=1, samples=5)
    out["prefill_4x256"] = {"eager_ms": eager, "device_ms": device,
                            "eager_tokens_per_s": 1024 / (eager / 1e3),
                            "device_idle_share_eager": 1.0 - device / eager}
    return out


def time_decode_kernels(dev) -> list[dict]:
    """Each kernel at the stablelm-3b decode shapes (M = 8, bf16
    activations), beside its plain version, the library call and its bound."""
    import torch.nn.functional as F

    from repro_torch.core.packing import pack_int4
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import kv_pack

    g = torch.Generator(device=dev).manual_seed(9)
    M, bf = DECODE_SLOTS, torch.bfloat16
    rows = []

    def row(kernel, shape, calls, fn, plain_fn, nbytes, ops, peak, library_fn=None,
            library_note=None, kv_bits=None):
        b_ms, b_by = bound(nbytes, ops, peak)
        lib = None
        if library_fn is not None:
            try:
                lib = cuda_ms(library_fn)
            except RuntimeError as e:            # the library refuses the shape
                library_note = f"refused: {str(e).splitlines()[0][:120]}"
        rows.append({"kernel": kernel, "M": M, "shape": shape, "calls": calls,
                     "ms": cuda_ms(fn), "eager_ms": cuda_ms(fn, graph=False),
                     "plain_ms": cuda_ms(plain_fn), "library_ms": lib,
                     "library_note": library_note, "bound_ms": b_ms, "bound_by": b_by,
                     "kv_bits": kv_bits})

    for K, calls in DECODE_ACT_QUANT.items():
        x = torch.randn((M, K), generator=g, device=dev).to(bf)
        s = (x.float().abs().amax() / 127).reshape(())
        row("act_quant", [K, 8], calls, lambda: aq.act_quant_cuda(x, s, 8),
            lambda: aq.act_quant_plain(x, s, 8), M * K * 2 + 4 + M * K, 4 * M * K,
            FP32_OPS_PER_S)
    for (K, N), calls in DECODE_MATMULS.items():
        x8 = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
        w8 = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
        wp = pack_int4(torch.randint(-7, 9, (K, N), generator=g, device=dev,
                                     dtype=torch.int8))
        s_a = torch.tensor(0.02, device=dev)
        s_w = torch.rand((1, N), generator=g, device=dev) * 0.01 + 1e-3
        out_b = M * N * 2 + 4 + 4 * N
        row("int8_matmul", [K, N], calls,
            lambda: i8.int8_matmul_cuda(x8, w8, s_a, s_w, out_dtype=bf),
            lambda: i8.int8_matmul_plain(x8, w8, s_a, s_w, out_dtype=bf),
            M * K + K * N + out_b, 2 * M * K * N, INT8_OPS_PER_S,
            library_fn=lambda: torch._int_mm(x8, w8))
        row("int4_matmul", [K, N], calls,
            lambda: i4.int4_matmul_cuda(x8, wp, s_a, s_w, out_dtype=bf),
            lambda: i4.int4_matmul_plain(x8, wp, s_a, s_w, out_dtype=bf),
            M * K + K // 2 * N + out_b, 2 * M * K * N, INT8_OPS_PER_S,
            library_note="no int4 library call")
    B, S, H, Hkv, dh = DECODE_SLOTS, DECODE_MAX_LEN, 32, 32, 80
    for bits in (8, 4):
        args = decode_inputs(dev, g, B, S, H, Hkv, dh, bits, bf, [DECODE_LEN] * B)
        kd = kv_pack.dequantize_kv(args[1], args[3], bf).transpose(1, 2)  # (B,H,S,dh)
        vd = kv_pack.dequantize_kv(args[2], args[4], bf).transpose(1, 2)
        qd = args[0][:, :, None, :]
        mask = (torch.arange(S, device=dev) < DECODE_LEN)[None, None, None, :]
        nbytes = da.bound_bytes(B, S, Hkv, H, dh, bits, [DECODE_LEN] * B, 2)
        ops = 4 * B * H * (DECODE_LEN + 1) * dh
        row("decode_attention", [B, S, DECODE_LEN, H, Hkv, dh],
            PER_DECODE_STEP["decode_attention"], lambda: da.decode_attention_cuda(*args),
            lambda: da.decode_attention_plain(*args), nbytes, ops, FP32_OPS_PER_S,
            library_fn=lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask),
            library_note="SDPA over a cache already dequantized to bf16 "
                         "(excludes the dequantization)", kv_bits=bits)
    return rows


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
    seconds = {}
    t0 = time.perf_counter()
    build.library()
    seconds["build"] = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds["build"], "ptxas": ptxas})

    t0 = time.perf_counter()
    errors = check_kernels(dev)
    seconds["kernels_vs_plain"] = time.perf_counter() - t0
    emit({"phase": "kernels_vs_plain", "max_abs_err": errors,
          "seconds": seconds["kernels_vs_plain"]})

    t0 = time.perf_counter()
    e2e = end_to_end(dev)
    eng, plan = e2e.pop("engine"), e2e.pop("plan_obj")
    seconds["end_to_end"] = time.perf_counter() - t0
    emit({"phase": "end_to_end", **e2e, "seconds": seconds["end_to_end"]})

    t0 = time.perf_counter()
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
    seconds["encoder_times"] = time.perf_counter() - t0
    enc_fwd = {"eager_ms": eager_ms, "eager_tokens_per_s": 32 * 128 / (eager_ms / 1e3),
               "device_ms": device_ms, "device_tokens_per_s": 32 * 128 / (device_ms / 1e3),
               "kernels_device_ms": kernels_ms,
               "kernels_share_of_device": kernels_ms / device_ms,
               "device_idle_share_eager": 1.0 - device_ms / eager_ms}
    emit({"phase": "forward_32x128", **enc_fwd, "seconds": seconds["encoder_times"]})
    del eng
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    errors["decode_attention"], cases = check_decode_attention(dev)
    seconds["decode_attention_vs_plain"] = time.perf_counter() - t0
    emit({"phase": "decode_attention_vs_plain", "cases": cases,
          "max_abs_err": errors["decode_attention"],
          "seconds": seconds["decode_attention_vs_plain"]})

    t0 = time.perf_counter()
    dec = decode_end_to_end(dev)
    models = dec.pop("models")
    seconds["decode_end_to_end"] = time.perf_counter() - t0
    emit({"phase": "decode_end_to_end", **dec, "seconds": seconds["decode_end_to_end"]})

    t0 = time.perf_counter()
    dec_times = time_decode(models, dev)
    emit({"phase": "decode_times", **dec_times})
    dec_rows = time_decode_kernels(dev)
    for r in dec_rows:
        emit({"phase": "decode_kernel_time", **r})
    dec_kernels_ms = sum(r["ms"] * r["calls"] for r in dec_rows
                         if r["kv_bits"] in (None, 8))
    step8 = dec_times["decode_step_kv8"]
    emit({"phase": "decode_step_breakdown_kv8",
          "kernels_device_ms": dec_kernels_ms, "step_device_ms": step8["device_ms"],
          "kernels_share_of_device": dec_kernels_ms / step8["device_ms"]})
    seconds["decode_times"] = time.perf_counter() - t0

    launches_by_path = {"encoder": e2e["launches"],
                        **{f"decode_kv{kv}": v["launches"]
                           for kv, v in dec["per_kv"].items()}}
    for path, need in (("encoder", ENCODER_KERNELS), ("decode_kv8", DECODER_KERNELS),
                       ("decode_kv4", DECODER_KERNELS)):
        idle = [k for k in need if not launches_by_path[path][k]]
        if idle:
            raise AssertionError(f"{path}: kernels never launched on the main "
                                 f"path: {idle}")
    entries = kernel_entries(rows, dec_rows, launches_by_path, errors)
    emit({"phase": "seconds", **seconds})
    report = ROOT / "chiprun_out" / "chip_smoke_report.json"
    report.parent.mkdir(exist_ok=True)
    report.write_text(json.dumps({"card": card, "kernels": entries,
                                  "end_to_end": e2e, "forward_32x128": enc_fwd,
                                  "decode_end_to_end": dec,
                                  "decode_times": dec_times, "seconds": seconds},
                                 indent=2, default=str))
    emit({"kernels": entries})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
