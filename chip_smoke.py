#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. device and build: the card's name and power limit, the torch and CUDA
   versions, and the build of the seven kernels from
   ``src/repro_torch/kernels/csrc`` with nvcc (one process per source, timed);
2. the four integer kernels against their plain PyTorch versions on the
   card, at the encoder shapes (M in {37, 512, 4096}, (K, N) in {(312, 312),
   (312, 1200), (1200, 312)}, both activation grids, an odd-K int4 case) and
   at the decode shapes with bf16 activations (M = 8, (K, N) in {(2560,
   2560), (2560, 6912), (6912, 2560)}). Codes and outputs must be
   bit-equal, f32 and bf16 alike, the fused GELU epilogue too (the kernel's
   tanhf and PyTorch's tanh on the card agree to the bit). Then int8_matmul and int4_matmul on the paths the shape plan
   (``kernels/gemm_plan.py``) names: split-K at M in {1, 8, 9, 64} for the
   decode (K, N) and at M = 8, N = 2560 with K at and one word around the
   64-row stage edges (188, 192, 196, 380, 384, 388); wgmma at M in {128,
   1000, 8192} for every (K, N) of stablelm-3b and llava-next-mistral-7b;
   f32 and bf16 out, each bit-equal to the plain version and to a second
   call; and one split-K and one wgmma call of each replayed twice from a
   CUDA graph, bit-equal to the eager calls. The split-K cases again with
   f32 and bf16 activations, which the GEMM quantizes as it loads them
   (a_bits 8 and 4, values exactly half-way between two codes and past
   +-qmax): each call bit-equal to act_quant's plain version followed by the
   plain GEMM, to a second call and to two CUDA-graph replays, launching the
   GEMM once and act_quant never. int4_matmul_fused (none, GELU, ReLU; f32
   and bf16 out) on each path: tiled, split-K (on codes and on f32 / bf16
   activations) and wgmma at tinybert4's ragged K = 312 and bert-base's
   (768, 3072), each bit-equal to the plain version. act_quant at a padded
   row pitch (K = 312 at 320): the real columns bit-equal, the wgmma GEMMs
   on that buffer bit-equal, and bit-unchanged after its pad bytes are
   poisoned;
3. the encoder path end to end at the full tinybert4 width (vocab 30522, d
   312, 12 heads, d_ff 1200, 4 layers; W8A8 layers 0-1, W4A4 layers 2-3):
   fp params from a seeded generator on the card -> ``deploy`` with 4
   calibration batches -> ``save`` -> ``load`` -> an encoder
   ``ServingEngine`` answering 16 classify/embed/score requests of 4-128
   tokens, held against the direct forward, the plain reference backend on
   the card and the CPU (codes and tolerances as documented there); 12 / 10
   / 2 int8 / int4 / fused GEMM launches per forward, and act_quant 24 but
   for the linears whose plan at the forward's rows quantizes inside the
   GEMM (split-K: a batch of at most 64 rows, N = 1200), as
   ``gemm_launches`` derives from ``kernels/gemm_plan.py``; no plain version
   on a CUDA tensor;
4. encoder times with CUDA events (median of 20 samples after warm-up) at M
   = 4096 (32 requests x 128 tokens), beside the plain versions, the
   library calls and the bounds (the GEMM rows with their path;
   int4_matmul_fused beside ``torch._int_mm`` on the same int8 codes, the
   weight row-major and column-major), int4_matmul_fused also at M = 8 and
   64 (split-K) and at bert-base's (768, 3072), and a direct forward of 32
   x 128 tokens;
5. ``decode_attention`` against its plain version on the card: kv_bits 8
   and 4, q in f32 and bf16, (H, Hkv, dh) in {(32, 32, 80) stablelm-3b,
   (48, 8, 128) internlm2-20b, and the groups of phase 21}, S in {64, 512, 520} with one slot at each
   of the lengths 0, 1, 7, 33, S/2, S - 1, S, S + 37 (an idle slot) and the
   kernel's split edges C - 1, C, C + 1, 2C + 1 (C rows a split), then a
   long cache: B = 2, S = 4096, lengths 4000 and 4096. Within atol 1e-5
   (rtol 0) for f32 and one bf16 ulp plus 1e-5 for bf16; two calls must be
   bit-equal, and poisoning every row past each slot's length must leave
   the kernel's output bit-unchanged;
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
   every decode step must launch int8_matmul 112, int4_matmul 112 and
   decode_attention 32 times and act_quant never (every GEMM of 8 rows is
   split-K and quantizes its activations), each prefill forward the
   GEMMs and the act_quant launches ``gemm_launches`` derives for its rows
   and no decode_attention, and no plain version may run on a CUDA tensor. The
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
   share), one eager kv8 step under ``torch.profiler`` (the top device
   kernels by name and the device-busy share), a prefill forward of 4 x
   256 tokens, and each kernel at its decode shapes beside its plain
   version, the library call (``torch._int_mm`` on the codes zero-padded
   to M = 32, as it refuses M = 8, with the weight row-major and
   column-major, the faster as ``library_ms``; SDPA over a cache already
   dequantized to bf16, which excludes the dequantization) and its bound;
   the integer GEMMs on bf16 activations, which they quantize, as the step
   calls them, and on codes (``ms_codes``), also cold (rotating over weight
   sets past the L2, as a step finds each layer's weights), with the path
   each shape takes; act_quant at the decode shapes, timed only.
   ``decode_attention`` and SDPA are timed warm (the same cache every
   call) and cold (rotating over caches that exceed the 50 MB L2, as a step
   finds each layer's cache), and once more, timed only, at B = 1 and cache
   length 8192;
8. ``decode_attention_paged`` against its plain version on the card, over
   phase 5's cases (kv_bits 8 and 4, f32 and bf16, the two head shapes,
   the same extents and lengths, the long cache) and over tables of 512 +
   128 rows against a dense extent of 512 (lengths up to 512), with tables
   that permute a pool's blocks, share blocks between slots and carry the
   sentinel and entries past it: within phase 5's tolerances of the plain
   version, bit-equal over two calls, bit-equal to the dense kernel on the
   layout the tables describe (cut to the dense extent), and bit-unchanged
   when every pool row no table reaches below its slot's length is poisoned
   (NaN scales, garbage codes);
9. phase 6's traffic through a paged engine (``kv_paging="paged"``, the
   dense-equivalent budget, prefix off) over phase 6's artifact at
   kv_bits 8 and 4: every stream byte-identical to phase 6's dense run;
   every decode step launches act_quant 0, int8_matmul 112, int4_matmul
   112, decode_attention_paged 32 and decode_attention 0 times, prefill no
   decode attention, no plain version on a CUDA tensor; every block
   released after draining;
10. shared-prefix traffic at kv_bits 8 (13 requests: one sampled, n = 2,
   on a 200-token prompt; 8 sharing a 256-token system prompt followed by
   8-72 distinct tokens; 4 unique prompts of 100-300 tokens) on phase 6's
   artifact cut to 16 layers (``PREFIX_LAYERS``: layers 0-7 of its W8A8
   segment and 0-7 of its W4A4 one, as one W8A8 0-7 / W4A4 8-15 model;
   the depth cut keeps the script within its time) through (i) a
   dense engine with a 256 MiB prefix cache, (ii) a paged engine with the
   prefix registry at the dense-equivalent budget, (iii) the paged engine
   at 60 % of that budget, served twice in a row. Every request finishes;
   (ii) equals (i) byte for byte with the same hit count; in (iii) round 2
   hits at least 8 times, a fork shares its prompt blocks and the
   refcounts drain after each round, and each greedy stream equals (i)'s
   or first differs at a near-tie under phase 6's rule (the noise taken
   on the positions where the histories agree, the parting one included);
11. paged times: a paged decode step (8 slots at length 448, a permuted
   pool) eager and replayed from a CUDA graph, and
   ``decode_attention_paged`` at that shape, each timed in turns with its
   dense counterpart (dense, paged, paged, dense), the kernel beside its
   plain version, SDPA over the gathered and dequantized bf16 cache (the
   kernel and SDPA warm and cold, as in phase 7) and its bound;
12. ``flash_attention`` against its plain version on the card: (B, S, H,
   Hkv, dh) in {(2, 256, 4, 2, 16), (1, 512, 8, 8, 64), (1, 4096, 32, 32,
   80) stablelm-3b, (1, 4096, 32, 8, 128) llava-next-mistral-7b}, and for
   the bf16 kernel's tiles S = 1, 200 and 4097 at dh 80 and 128 and GQA
   groups 1, 2 and 4, then phase 21's groups 3, 5 and 8 at S = 1024 and
   1000; causal and not, f32 (the SIMT kernel) and bf16 (the
   tensor-core kernel), the plain version at blocks (64, 64), (128, 64)
   and (1024, 1024) where they tile S, else at (S, S): f32 within |diff|
   <= 1e-5 + 1e-5 |plain|, bf16 within one bf16 ulp plus 1e-5; a causal
   row 0 equals row 0 of v in its KV head exactly;
13. long-context prefill at full width and depth: phase 6's stablelm-3b
   artifact (not deployed or saved again) and llava-next-mistral-7b (32
   layers, d 4096, 32 query and 8 KV heads of 128, d_ff 14336 SwiGLU, vocab
   32000; fp params from a seeded generator on the card -> ``deploy`` with 4
   calibration batches of (4, 32) tokens, W8A8 layers 0-15 and W4A4 16-31,
   bf16 activations; the fp params freed, nothing saved). One cacheless
   forward of B = 1, S = 8192 tokens each, the vlm with (1, 1152, 4096)
   bf16 patch embeddings at positions 32-1183: each launches flash_attention
   32 times, act_quant 224, int8_matmul 112, int4_matmul 112 (every GEMM on
   wgmma behind its act_quant, as ``gemm_launches`` derives) and no decode
   attention, runs no plain version on a CUDA tensor and never calls
   ``full_attention`` (no (S, S) score tensor). Gates: every layer's
   kernel output within phase 12's tolerances of the plain version on that
   layer's own q, k and v; and the first act_quant, int8_matmul and
   int4_matmul call of each shape (one qlinear of each width per W8A8 and
   W4A4 segment, bf16, M = 8192) bit-equal to the plain version on its own
   inputs. Then the same artifact under the reference plan on the card:
   the largest logit difference and the share of equal argmaxes, held
   against the same readings between two runs of the reference plan that
   differ only in the plain version's blocks (chunk 512 against 1024): the
   difference at most twice, the share at least half of theirs (the
   random-weight stack amplifies a change in the order of attention's f32
   sums to logit differences of about 3); peak device memory;
14. flash_attention alone at (1, S, 32, 32, 80) and (1, S, 32, 8, 128),
   causal, bf16, S in {4096, 8192, 32768}, held against its plain version
   at phase 12's tolerances and timed beside it, SDPA on the same tensors
   (timed only) and its bound; int8_matmul and int4_matmul (bf16 out) at M
   = 8192 and 32768 for every (K, N) of the two long forwards, timed only
   (phase 2 holds them bit-equal at M = 8192), with the path each takes,
   beside ``torch._int_mm`` on the same int8 operands with the weight
   row-major and column-major (the faster as ``library_ms``) and the op
   bound at 1979 TOPS; act_quant alone on bf16 at the same M for K in
   {2560, 6912, 4096, 14336} beside its byte bound; then one forward of each
   model at S = 32768
   (the JAX system's prefill_32k length) with phase 13's launch checks:
   eager ms, the flash kernels' device ms, tokens/s, peak memory; and a
   second such forward that records the first layer's flash attention and
   the first int-kernel call of each shape, each held against its plain
   version as in phase 13;
15. the paper's Table 2 on the card (``repro_torch/benchmarks/
   table2_speedup.py``): one bert-base layer through ``block_apply`` on the
   grid (batch, tokens) in (16, 110), (16, 168), (64, 26), (64, 36), (16,
   1), (64, 1) at float32 (TF32 off), float32 with TF32, int8, int4 (JAX's
   spec: separate GELU) and int4 with the fused epilogue. Each grid point x
   row is first called once eagerly: the integer kernels' launches as the
   shape plan names them and no plain version on a CUDA tensor; the first
   call of each integer kernel at each (M, K, N, path) bit-equal to its
   plain version (a GEMM that quantized its own float activations against
   act_quant's plain version followed by the plain GEMM); the integer rows
   within 1e-5 of the same layer on the plain integer path on the card,
   the float32 row within 1e-4 of the same layer on the CPU (the TF32 row
   within 2e-2). Then the runner's rows: device ms (one call in a CUDA
   graph), eager ms and the bound, fp32 / int4 and int8 / int4 on both;
   and each integer kernel alone at each bert-base shape beside
   ``torch._int_mm`` on the same codes, with its path and bound;
16. the serve CLI in-process (``repro_torch.launch.serve.main``) on its
   default stablelm-3b and policy: kv8 dense deployed and exported, the
   artifact served (streams byte-equal), kv8 paged (byte-equal to dense),
   ``--mode encoder`` on tinybert4 exported and served back (results
   equal). Then decoder ``score`` requests interleaved with phase 6's
   traffic, dense and paged: four of bucket 128 in one batched forward and
   four more one at a time between decode steps; the decode streams
   byte-identical to phase 6's, every step and forward launching what the
   plan names, each score bit-equal to the prompt scored alone and within
   1e-4 (relative) of the reference backend on the card;
17. load: a short Poisson workload through ``serving.run_load`` on the
   system clock for the decoder (phase 6's kv8 model, a quarter of the
   requests scores) and the encoder (phase 3's artifact): tokens/s, TTFT
   and inter-token p50/p99, SLO goodput, launches per engine step (smoke
   readings at fixed rates, not end-to-end metrics); then
   ``benchmarks/serve_latency`` and ``serve_load`` (``--quick``, their
   reduced configuration) on the card, their JSON printed and written to
   ``chiprun_out/``;
18. the paper's QAT recipe at full tinybert4 width (``benchmarks/common``):
   a bert-base fp teacher and the fp student trained 8 steps each on
   ``SyntheticClassification(30522, 64, 32)``, the student calibrated
   (``build_qat_student``) and trained 30 steps W4A4 in every layer (mse
   scale gradients, MINI + output KD); every loss finite, the learned
   activation scales moved. The first quantized linear's fake-quant codes
   ``round(clip(x / s_a))`` bit-equal to act_quant's kernel on the same
   embeddings, and ``lsq_quantize`` equal to ``s_a`` times those codes.
   ``deploy(recalibrate=False)`` keeps the learned scales (checked) ->
   ``save`` -> ``load`` -> an encoder ``ServingEngine`` answering 16
   classify requests of 4-128 tokens, each forward launching the integer
   kernels as ``gemm_launches`` derives for its rows, no plain version on
   a CUDA tensor, each result within rtol 1e-5 / atol 1e-6 of the direct
   forward. The deployed forward against the fake-quant one on 4 x 32
   rows under phase 3's noise rule, each row's activation codes recorded
   on both paths: the first linear's codes equal, at most half the rows
   with a changed code, rows with none within rtol = atol = 1e-4, rows
   with one within ``QAT_LOGIT_ATOL``, argmax equal on every row; step times (eager) and peak device memory;
19. the train CLI's default at full width: ``launch.train.main(["--steps",
   "3", "--batch", "8", "--seq", "128"])`` on stablelm-3b (fake-quant W8A8
   layers 0-15 and W4A4 16-31, mse scale gradients, no teacher, f32
   params and Adam state, bf16 activations): finite losses, each step's
   eager ms, peak device memory, no checkpoint (``--ckpt-every`` 50).
   Then ``--reduced --ckpt-every 2``: 4 steps uninterrupted bit-equal, on
   every leaf, to a run stopped by SIGTERM after 2 steps (the CLI's
   preemption path: it checkpoints and exits) and resumed for 2 more.
   Then ``benchmarks/table1_glue.run(quick=True)``, ``run_artifact(quick=
   True)`` (deployed on the cuda backend: scored through the integer
   kernels, no plain version on a CUDA tensor) and
   ``table3_ablation.run(quick=True)``, the two tables on one trained fp
   teacher and student (``teacher_and_student``): their rows and the quality payload
   printed, the payload written to ``chiprun_out/BENCH_quality.json`` and
   read by ``tools/check_quality.py``, which must pass: against itself,
   since the committed baseline is the JAX package's, so what it gates is
   the paper's claim (the W4A4 artifact within 5 points of the fp
   student);
20. the fleet, over phase 6's kv8 and phase 3's tinybert4 artifacts
   reloaded from ``build/``: (a) a ``ReplicaSet`` of two engines (8 slots,
   max_len 512 each), dense and paged, serving phase 6's requests of at
   most 32 new tokens and its sampled one (n = 2): streams
   byte-identical to phase 6's single engine, every member's decode step
   and prefill launching what the plan names, no plain version on a CUDA
   tensor, device memory grown by the members' KV (plus 64 MiB each) and
   never by the weights; tokens/s beside phase 6's single engine (a smoke
   reading); (b) one ``MultiTenantEngine``: a flood of 48 classify / embed
   / score requests on ``cls`` (tinybert4) submitted before four of phase
   6's generation requests (16-24 new tokens) on ``gen``: every request finishes, each
   tenant's results byte-equal to the same requests served alone, a quota
   rejection raised and then released; (c) the serve CLI in-process with
   ``--replicas 2 --artifact`` (streams equal to one engine serving its
   burst) and with two ``--tenant``s, then ``--tp 2``, refused for want of
   a second card; (d) ``serve_load``'s ``mixed_tenant`` and
   ``replica_scale`` (``--quick``), the JSON in
   ``chiprun_out/BENCH_load_fleet.json``: the classify tenant's goodput
   1.0 beside the flood, two replicas at least 1.8x one engine's virtual
   capacity with byte-identical streams;
21. the MoE family: (a) granite-moe-3b-a800m at full width and depth (32
   layers, d 1536, 24 heads of 64 on 8 KV heads, 40 experts of d_ff 512,
   top-8; W8A8 layers 0-15, W4A4 16-31, bf16 activations) from a seeded
   generator on the card -> ``deploy`` with 4 calibration batches ->
   ``save`` -> ``load``, serving 8 greedy requests (prompts of 5-256
   tokens, 4-12 new tokens) and one sampled (n = 2) on 8 slots at kv8
   dense, kv8 paged and kv4 dense: every request finishes with finite
   logits, every decode step and prefill launches the integer GEMMs
   ``moe_launches`` derives (one launch an expert at its capacity C, empty
   slots included) and one attention kernel a layer, and no plain version
   runs on a CUDA tensor; (b) the first layer of each bit-width segment,
   ``cuda`` against ``reference`` backend on the card, at 8 and 1024
   tokens (two groups), dense and sorted dispatch: routing and output
   bit-equal, the first call of each expert / shared GEMM shape bit-equal
   to its plain version; (c) one kv8 decode step captured in a CUDA graph
   and replayed twice, byte-equal to the eager step, with eager and
   graphed ms, the GEMM launches a step and the idle share; (d) one
   cacheless forward of 4096 tokens (flash attention at GQA group 3, dh
   64; the experts on wgmma at 1024 rows), layer 0's flash output within
   phase 12's tolerances and the first GEMM of each shape bit-equal; (e)
   qwen2-moe-a2.7b at full width (shared expert with its sigmoid gate, QKV
   bias), its depth cut to 8 of 24 layers (``MOE_QWEN_LAYERS``), deployed
   on the card (not saved), serving 4 requests at kv8 dense with (a)'s
   checks and (b)'s layer check at its shapes. Phases 5, 8 and 12 also run
   the attention kernels at GQA groups 3, 5 and 8 ((24, 8, 64), (40, 8,
   128), (64, 8, 128): granite-moe-3b-a800m, qwen2.5-32b, qwen1.5-110b).

The line before the last holds the seven kernels; the last line of standard
output is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
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

# the card's rates, CUDA-event timing and the least-time bound live in the
# port (a checkout without it fails here, before anything runs)
from repro_torch.benchmarks.timing import (  # noqa: E402
    BF16_OPS_PER_S, FP32_OPS_PER_S, INT8_OPS_PER_S, bound, cuda_ms)

MATMUL_SHAPES = ((312, 312), (312, 1200), (1200, 312))
M_TIMED = 4096                 # 32 requests x 128 tokens
#: the quantized linears of one forward of the mixed tinybert4 plan (W8A8
#: layers 0-1, W4A4 layers 2-3): (K, N, weight bits, fused) -> calls
ENCODER_LINEARS = {(312, 312, 8, False): 8, (312, 1200, 8, False): 2,
                   (1200, 312, 8, False): 2, (312, 312, 4, False): 8,
                   (312, 1200, 4, True): 2, (1200, 312, 4, False): 2}
GEMM_NAMES = ("act_quant", "int8_matmul", "int4_matmul", "int4_matmul_fused")
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
    "decode_attention_paged": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:143"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:68"),
}
#: kernels each main path must launch
ENCODER_KERNELS = ("act_quant", "int8_matmul", "int4_matmul", "int4_matmul_fused")
DECODER_KERNELS = ("act_quant", "int8_matmul", "int4_matmul", "decode_attention")
PAGED_KERNELS = ("act_quant", "int8_matmul", "int4_matmul", "decode_attention_paged")
#: stablelm-3b decode shapes: (K, N) -> calls per decode step, per kernel
DECODE_MATMULS = {(2560, 2560): 4 * 16, (2560, 6912): 2 * 16, (6912, 2560): 1 * 16}
#: act_quant at the decode shapes, K -> calls a step had before the split-K
#: GEMMs took the quantization over (timed only now: a step launches none)
DECODE_ACT_QUANT = {2560: 6 * 32, 6912: 1 * 32}
#: a decode step (8 rows): every GEMM on split-K, which quantizes its own
#: activations; ``decode_end_to_end`` checks this against ``gemm_launches``
PER_DECODE_STEP = {"act_quant": 0, "int8_matmul": 112, "int4_matmul": 112,
                   "decode_attention": 32}
#: a paged decode step: the same linears, attention straight from the pool
PAGED_DECODE_STEP = {**PER_DECODE_STEP, "decode_attention": 0,
                     "decode_attention_paged": 32}
BLOCK = 8                      # rows per KV block (serving/prefix_cache.PREFIX_BLOCK)
LONG_CACHE = 8192              # the timed-only decode-attention row: B = 1 at this length
DECODE_SLOTS, DECODE_MAX_LEN, DECODE_LEN = 8, 512, 448



def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def decoder_linears(cfg) -> dict:
    """The quantized linears of one forward of a decoder under the serve
    CLI's policy (W8A8 in the first half of the layers, W4A4 in the rest):
    (K, N, weight bits, fused) -> calls. q, k, v, o and the SwiGLU's gate,
    up and down projections, one GEMM each."""
    d, q, kv = cfg.d_model, cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
    out: dict = {}
    for bits in (8, 4):
        for K, N in ((d, q), (d, kv), (d, kv), (q, d), (d, cfg.d_ff), (d, cfg.d_ff),
                     (cfg.d_ff, d)):
            key = (K, N, bits, False)
            out[key] = out.get(key, 0) + cfg.num_layers // 2
    return out


def gemm_launches(linears: dict, M: int) -> dict:
    """The integer kernels' launches of one forward of ``M`` rows through
    ``linears``: one GEMM launch per linear, and one act_quant launch per
    linear whose plan does not quantize inside the GEMM (every path but
    split-K), from the shapes alone."""
    from repro_torch.kernels.gemm_plan import quantizes_in_gemm
    out = dict.fromkeys(GEMM_NAMES, 0)
    for (K, N, bits, fused), calls in linears.items():
        out["int4_matmul_fused" if fused else f"int{bits}_matmul"] += calls
        if not quantizes_in_gemm(M, N, K, bits):
            out["act_quant"] += calls
    return out


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
    err["gemm_path_calls_bit_equal"] = check_gemm_paths(dev, g, same)
    err["gemm_path_calls_bit_equal"]["splitk_quantizing"] = check_folded_gemms(dev, g, same)
    err["gemm_path_calls_bit_equal"]["fused"] = check_fused_paths(dev, g, same)
    err["gemm_path_calls_bit_equal"]["padded_pitch"] = check_padded_pitch(dev, g, same)
    torch.cuda.synchronize()
    return err


#: phase 2's cases of the integer GEMMs' split-K and wgmma paths: (M, K, N)
SPLITK_CASES = ([(M, K, N) for M in (1, 8, 9, 64) for K, N in DECODE_MATMULS]
                # K at and one word around the 64-row stage edges
                + [(8, K, 2560) for K in (188, 192, 196, 380, 384, 388)])
WGMMA_MS = (128, 1000, 8192)


def check_gemm_paths(dev, g, same) -> dict:
    """int8_matmul and int4_matmul on their split-K and wgmma paths, f32 and
    bf16 out: each call bit-equal to the plain version and to a second
    call, on the path the plan names; then split-K and wgmma calls replayed
    from a CUDA graph, bit-equal to the eager calls. Returns the calls
    checked per path."""
    from repro_torch.core.packing import pack_int4
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels.gemm_plan import gemm_plan

    def operands(M, K, N):
        x8 = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
        w8 = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
        wp = pack_int4(torch.randint(-7, 9, (K, N), generator=g, device=dev,
                                     dtype=torch.int8))
        s_w = torch.rand((1, N), generator=g, device=dev) * 0.01 + 1e-3
        return x8, w8, wp, torch.tensor(0.02, device=dev), s_w

    wgmma_cases = [(M, K, N) for M in WGMMA_MS
                   for shapes in LONG_GEMMS.values() for K, N in shapes]
    checked = {"splitk": 0, "wgmma": 0, "graph_replays": 0}
    for path, cases in (("splitk", SPLITK_CASES), ("wgmma", wgmma_cases)):
        for M, K, N in cases:
            x8, w8, wp, s_a, s_w = operands(M, K, N)
            for bits, fn, plain, w in ((8, i8.int8_matmul_cuda, i8.int8_matmul_plain, w8),
                                       (4, i4.int4_matmul_cuda, i4.int4_matmul_plain, wp)):
                name = f"int{bits}_matmul"
                if gemm_plan(M, N, K, bits).name != path:
                    raise AssertionError(f"{name} M={M} K={K} N={N}: plan "
                                         f"{gemm_plan(M, N, K, bits)}, not {path}")
                for dt in (torch.float32, torch.bfloat16):
                    tag = f"{name} {path} M={M} K={K} N={N} {dt}"
                    got = fn(x8, w, s_a, s_w, out_dtype=dt)
                    same(tag, got, plain(x8, w, s_a, s_w, out_dtype=dt))
                    same(f"{tag} (second call)", fn(x8, w, s_a, s_w, out_dtype=dt), got)
                    checked[path] += 1
            del x8, w8, wp
    torch.cuda.empty_cache()
    # a CUDA-graph replay (split-K's workspace from the graph's pool)
    for M, K, N in ((8, 2560, 2560), (1000, 2560, 2560)):
        x8, w8, wp, s_a, s_w = operands(M, K, N)
        calls = (lambda: i8.int8_matmul_cuda(x8, w8, s_a, s_w, out_dtype=torch.bfloat16),
                 lambda: i4.int4_matmul_cuda(x8, wp, s_a, s_w, out_dtype=torch.bfloat16))
        eager = [fn() for fn in calls]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for fn in calls:
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            outs = [fn() for fn in calls]
        for rep in range(2):
            for o in outs:
                o.zero_()
            graph.replay()
            torch.cuda.synchronize()
            for bits, o, e in zip((8, 4), outs, eager):
                same(f"int{bits}_matmul M={M} K={K} N={N} graph replay {rep}", o, e)
                checked["graph_replays"] += 1
        del graph, outs, eager
    return checked


def replay_twice(calls, wants, same, tag: str) -> int:
    """``calls`` captured in one CUDA graph (outputs and split-K workspaces
    from the graph's pool), replayed twice: each output bit-equal to
    ``wants``. Returns the outputs checked."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [fn() for fn in calls]
    for rep in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for i, (o, w) in enumerate(zip(outs, wants)):
            same(f"{tag} call {i} graph replay {rep}", o, w)
    return 2 * len(outs)


def grid_inputs(g, M: int, K: int, a_bits: int, dtype, dev):
    """(M, K) activations on the grid of s = 1/16, so that x / s is exact:
    random values, a quarter exactly half-way between two codes (x / s = k
    + 0.5, which rint takes to the even k), and one in twenty past +-qmax
    (clamped); then cast to ``dtype`` (the half-way points stay exact in
    bf16 up to |x / s| = 127.5)."""
    from repro_torch.core.quantizer import qrange
    qmin, qmax = qrange(a_bits)
    s = 0.0625
    x = torch.randn((M, K), generator=g, device=dev) * (0.6 * qmax * s)
    k = torch.randint(qmin - 4, qmax + 4, (M, K), generator=g, device=dev)
    pick = torch.rand((M, K), generator=g, device=dev)
    x = torch.where(pick < 0.25, (k.float() + 0.5) * s, x)
    x = torch.where(pick > 0.95, torch.sign(x) * (qmax + 30) * s, x)
    return x.to(dtype), torch.tensor(s, device=dev)


def check_folded_gemms(dev, g, same) -> int:
    """int8_matmul and int4_matmul on the split-K path handed f32 or bf16
    activations, which the GEMM quantizes as it loads them: at phase 2's
    split-K shapes (M in {1, 8, 9, 64} at the decode (K, N), and K = 188..388
    around the stage edges), a_bits 8 and 4, on ``grid_inputs`` (ties and
    clamps); each call bit-equal to act_quant's plain version followed by
    the plain GEMM and to a second call, launching the GEMM once and
    act_quant never; then each dtype's calls replayed twice from a CUDA
    graph. Returns the calls checked."""
    from repro_torch.core.packing import pack_int4
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import build
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels.gemm_plan import quantizes_in_gemm

    checked = 0
    for M, K, N in SPLITK_CASES:
        w8 = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
        wp = pack_int4(torch.randint(-7, 9, (K, N), generator=g, device=dev,
                                     dtype=torch.int8))
        s_w = torch.rand((1, N), generator=g, device=dev) * 0.01 + 1e-3
        for dt in (torch.float32, torch.bfloat16):
            calls, wants = [], []
            for a_bits in (8, 4):
                x, s_a = grid_inputs(g, M, K, a_bits, dt, dev)
                x8 = aq.act_quant_plain(x, s_a, a_bits)
                for bits, fn, plain, w in ((8, i8.int8_matmul_cuda, i8.int8_matmul_plain, w8),
                                           (4, i4.int4_matmul_cuda, i4.int4_matmul_plain, wp)):
                    name = f"int{bits}_matmul"
                    tag = f"{name} quantizing M={M} K={K} N={N} {dt} a_bits={a_bits}"
                    if not quantizes_in_gemm(M, N, K, bits):
                        raise AssertionError(f"{tag}: the plan does not quantize")
                    call = (lambda fn=fn, w=w, x=x, s_a=s_a, a_bits=a_bits:
                            fn(x, w, s_a, s_w, out_dtype=dt, a_bits=a_bits))
                    want = plain(x8, w, s_a, s_w, out_dtype=dt)
                    before = dict(build.LAUNCHES)
                    got = call()
                    delta = {k: build.LAUNCHES[k] - before[k] for k in before}
                    if delta[name] != 1 or delta["act_quant"]:
                        raise AssertionError(f"{tag}: launched {delta}")
                    same(tag, got, want)
                    same(f"{tag} (second call)", call(), got)
                    calls.append(call)
                    wants.append(want)
                    checked += 1
            replay_twice(calls, wants, same, f"quantizing M={M} K={K} N={N} {dt}")
    return checked


#: int4_matmul_fused's phase 2 cases on each path, (M, K, N): tinybert4's
#: FFN-up (K = 312, N = 1200: the wgmma rows at a padded pitch) and
#: bert-base's (768, 3072); tiled for N = 312 and 64 < M < 128
FUSED_CASES = {"tiled": ((37, 312, 312), (100, 312, 1200)),
               "splitk": ((8, 312, 1200), (64, 312, 1200), (8, 768, 3072)),
               "wgmma": ((128, 312, 1200), (300, 312, 1200), (M_TIMED, 312, 1200),
                         (M_TIMED, 768, 3072))}


def check_fused_paths(dev, g, same) -> dict:
    """int4_matmul_fused on each path of ``FUSED_CASES``, on the path the
    plan names: act none, GELU and ReLU, f32 and bf16 out, on int8 codes
    (contiguous; the wrapper lays ragged-K codes at wgmma's pitch) and, on
    split-K, on f32 and bf16 activations the GEMM quantizes; each bit-equal
    to the plain version and to a second call. Returns the calls checked
    per path."""
    from repro_torch.core.packing import pack_int4
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels.gemm_plan import gemm_plan

    checked = dict.fromkeys(FUSED_CASES, 0)
    for path, cases in FUSED_CASES.items():
        for M, K, N in cases:
            if gemm_plan(M, N, K, 4).name != path:
                raise AssertionError(f"int4_matmul_fused M={M} K={K} N={N}: plan "
                                     f"{gemm_plan(M, N, K, 4)}, not {path}")
            wp = pack_int4(torch.randint(-7, 9, (K, N), generator=g, device=dev,
                                         dtype=torch.int8))
            s_w = torch.rand((1, N), generator=g, device=dev) * 0.01 + 1e-3
            bias = torch.randn((1, N), generator=g, device=dev)
            x, s_a = grid_inputs(g, M, K, 4, torch.float32, dev)
            x4 = aq.act_quant_plain(x, s_a, 4)
            inputs = [("codes", x4)]
            if path == "splitk":
                inputs += [("f32", x), ("bf16", x.to(torch.bfloat16))]
            for kind, xin in inputs:
                codes = x4 if kind != "bf16" else aq.act_quant_plain(xin, s_a, 4)
                for act in ("none", "gelu", "relu"):
                    for dt in (torch.float32, torch.bfloat16):
                        tag = (f"int4_matmul_fused[{act}] {path} M={M} K={K} N={N} "
                               f"{kind} -> {dt}")
                        got = i4.int4_matmul_fused_cuda(xin, wp, s_a, s_w, bias, act,
                                                        out_dtype=dt, a_bits=4)
                        same(tag, got, i4.int4_matmul_fused_plain(codes, wp, s_a, s_w,
                                                                  bias, act, out_dtype=dt))
                        same(f"{tag} (second call)", i4.int4_matmul_fused_cuda(
                            xin, wp, s_a, s_w, bias, act, out_dtype=dt, a_bits=4), got)
                        checked[path] += 1
            del wp, x, x4
    return checked


def check_padded_pitch(dev, g, same) -> int:
    """act_quant writing its codes at a row pitch of 320 for K = 312 (as
    ``ops`` asks for a wgmma GEMM), f32 and bf16, a_bits 8 and 4: the real
    columns bit-equal to the plain version; the wgmma GEMMs (int8_matmul,
    int4_matmul, int4_matmul_fused GELU) read that buffer as it is and are
    bit-equal to the plain versions; and poisoning the pad bytes leaves
    their outputs bit-unchanged (TMA reads only the K real columns).
    Returns the outputs checked."""
    from repro_torch.core.packing import pack_int4
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels.gemm_plan import code_pitch, gemm_plan

    M, K, N = 1000, 312, 1200
    pitch = code_pitch(gemm_plan(M, N, K, 8), K)
    if pitch != 320:
        raise AssertionError(f"K = {K}: pitch {pitch}, expected 320")
    w8 = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    wp = pack_int4(torch.randint(-7, 9, (K, N), generator=g, device=dev, dtype=torch.int8))
    s_w = torch.rand((1, N), generator=g, device=dev) * 0.01 + 1e-3
    bias = torch.randn((1, N), generator=g, device=dev)
    checked = 0
    for dt in (torch.float32, torch.bfloat16):
        for a_bits in (8, 4):
            x, s_a = grid_inputs(g, M, K, a_bits, dt, dev)
            codes = aq.act_quant_cuda(x, s_a, a_bits, pitch=pitch)
            tag = f"act_quant pitch {pitch} K={K} {dt} a_bits={a_bits}"
            if codes.shape != (M, K) or codes.stride() != (pitch, 1):
                raise AssertionError(f"{tag}: shape {codes.shape} strides {codes.stride()}")
            plain_codes = aq.act_quant_plain(x, s_a, a_bits)
            same(tag, codes, plain_codes)
            if i8.gemm_input(codes, gemm_plan(M, N, K, 8), K)[0].data_ptr() \
                    != codes.data_ptr():
                raise AssertionError(f"{tag}: the wrapper re-laid codes at its own pitch")
            calls = (("int8_matmul", lambda: i8.int8_matmul_cuda(codes, w8, s_a, s_w),
                      i8.int8_matmul_plain(plain_codes, w8, s_a, s_w)),
                     ("int4_matmul", lambda: i4.int4_matmul_cuda(codes, wp, s_a, s_w),
                      i4.int4_matmul_plain(plain_codes, wp, s_a, s_w)),
                     ("int4_matmul_fused[gelu]",
                      lambda: i4.int4_matmul_fused_cuda(codes, wp, s_a, s_w, bias, "gelu"),
                      i4.int4_matmul_fused_plain(plain_codes, wp, s_a, s_w, bias, "gelu")))
            outs = []
            for name, fn, want in calls:
                outs.append(fn())
                same(f"{name} on {tag}", outs[-1], want)
            rows = codes.as_strided((M, pitch), (pitch, 1))
            rows[:, K:] = torch.randint(-128, 128, (M, pitch - K), generator=g,
                                        device=dev, dtype=torch.int8)
            for (name, fn, _), before in zip(calls, outs):
                same(f"{name} on {tag}, pad bytes poisoned", fn(), before)
                checked += 1
    return checked


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
    counted = []                                    # the counted run's batches
    build.reset_counts()
    t0 = time.perf_counter()
    eng, results = serve(loaded, on_batch=counted.append)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    del eng.encode_batch          # the recorder; main times this engine's forward
    launches = dict(build.LAUNCHES)
    plain_on_cuda = dict(build.PLAIN_ON_CUDA)
    forwards = eng.metrics.summary()["encode_steps"]
    # each forward's launches from the plan of each linear at its rows
    # (batch x bucket): act_quant only where the GEMM does not quantize
    rows = [int(toks.size) for toks, _ in counted]
    expected = dict.fromkeys(GEMM_NAMES, 0)
    for M in rows:
        for name, n in gemm_launches(ENCODER_LINEARS, M).items():
            expected[name] += n
    if len(rows) != forwards or {k: launches[k] for k in expected} != expected:
        raise AssertionError(f"{ {k: launches[k] for k in GEMM_NAMES} } launches over "
                             f"{forwards} forwards of rows {rows}, expected {expected}")
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
            "forwards": forwards, "forward_rows": rows, "launches": launches,
            "expected_launches": expected, "plain_on_cuda": plain_on_cuda,
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
    quantize (``recording_codes``) and every padded batch they run, in
    order."""
    codes, batches = [], []
    with recording_codes(codes):
        _, results = serve(model, on_batch=batches.append)
    return {"results": results, "batches": batches}, codes


@contextlib.contextmanager
def recording_codes(codes: list):
    """Append to ``codes``, as (rows, K) int8 arrays in call order, every
    activation-code tensor a forward quantizes: on the deployed paths the
    kernel's or the reference backend's (a split-K GEMM quantizes inside
    its kernel, which keeps no codes: for such a call the spy records
    act_quant's kernel on the same activations, the same arithmetic, held
    bit-equal to the GEMM's in phase 2); on the fake-quant path
    ``round(clip(x / s_a))``, ``lsq_quantize``'s forward, for each
    activation (0-d scale; weights carry per-channel scales)."""
    from repro_torch.core.quantizer import quantize_to_int
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    # ops.act_quant on the CPU, act_quant_cuda on the card (ops calls it
    # directly for every GEMM that does not quantize)
    originals = {(ops, "act_quant"): ops.act_quant,
                 (ops, "act_quant_cuda"): ops.act_quant_cuda,
                 (layers, "quantize_to_int"): layers.quantize_to_int,
                 (layers, "fake_quant"): layers.fake_quant,
                 **{(ops, name): getattr(ops, name) for name in (
                     "int8_matmul_cuda", "int4_matmul_cuda", "int4_matmul_fused_cuda")}}

    def spy(fn):
        def recorded(x, s, bits=8, **kw):
            out = fn(x, s, bits, **kw)
            codes.append(out.reshape(-1, out.shape[-1]).cpu().numpy())
            return out
        return recorded

    def gemm_spy(fn):
        def recorded(x, w, s_a, *a, a_bits=8, **kw):
            if x.dtype != torch.int8:
                codes.append(aq.act_quant_cuda(x, s_a, a_bits).cpu().numpy())
            return fn(x, w, s_a, *a, a_bits=a_bits, **kw)
        return recorded

    def fake_spy(fn):
        def recorded(x, s, bits, *a, **kw):
            if bits is not None and s.dim() == 0:
                z = quantize_to_int(x.detach(), s.detach(), bits)
                codes.append(z.reshape(-1, z.shape[-1]).cpu().numpy())
            return fn(x, s, bits, *a, **kw)
        return recorded

    for (mod, name), fn in originals.items():
        setattr(mod, name, fake_spy(fn) if name == "fake_quant"
                else gemm_spy(fn) if name.endswith(("matmul_cuda", "fused_cuda"))
                else spy(fn))
    try:
        yield codes
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)


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
def time_kernels(dev) -> list[dict]:
    """The encoder's kernels at M = 4096 (32 requests x 128 tokens), each
    (K, N) with its calls per forward from ``gemm_launches``, on the path
    the plan names; GEMM codes laid at that path's row pitch outside the
    timing, as ``ops`` has act_quant write them."""
    from repro_torch.core.packing import pack_int4
    from repro_torch.core.quantizer import qrange
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels.gemm_plan import gemm_plan, quantizes_in_gemm

    g = torch.Generator(device=dev).manual_seed(7)
    rows = []

    def row(kernel, shape, calls, fn, plain_fn, nbytes, ops, peak,
            library_fn=None, fp32_fn=None, M=M_TIMED):
        """Device times (CUDA-graph replay) of the kernel, its plain version
        and the library calls, plus the kernel's eager per-call time."""
        b_ms, b_by = bound(nbytes, ops, peak)
        rows.append({"kernel": kernel, "M": M, "shape": shape, "calls": calls,
                     "ms": cuda_ms(fn), "eager_ms": cuda_ms(fn, graph=False),
                     "plain_ms": cuda_ms(plain_fn),
                     "library_ms": None if library_fn is None else cuda_ms(library_fn),
                     "fp32_matmul_ms": None if fp32_fn is None else cuda_ms(fp32_fn),
                     "bound_ms": b_ms, "bound_by": b_by})

    M = M_TIMED
    quant_calls: dict = {}
    for (K, N, bits, _), calls in ENCODER_LINEARS.items():
        if not quantizes_in_gemm(M, N, K, bits):
            quant_calls[(K, bits)] = quant_calls.get((K, bits), 0) + calls
    for (K, bits), calls in quant_calls.items():
        x = torch.randn((M, K), generator=g, device=dev)
        s = (x.abs().amax() / qrange(bits)[1]).reshape(())
        row("act_quant", [K, bits], calls,
            lambda: aq.act_quant_cuda(x, s, bits),
            lambda: aq.act_quant_plain(x, s, bits),
            M * K * 4 + 4 + M * K, 4 * M * K, FP32_OPS_PER_S)

    def operands(K, N, bits, M=M):
        """Codes at the path's pitch (and contiguous), weights, scales, bias
        and f32 operands of the same shapes for torch.matmul."""
        plan = gemm_plan(M, N, K, bits)
        lo, hi = qrange(bits)
        x8 = torch.randint(lo, hi + 1, (M, K), generator=g, device=dev, dtype=torch.int8)
        xp = i8.gemm_input(x8, plan, K)[0]
        w8 = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
        wp = pack_int4(torch.randint(-7, 9, (K, N), generator=g, device=dev,
                                     dtype=torch.int8))
        s_a = torch.tensor(0.02, device=dev)
        s_w = torch.rand((1, N), generator=g, device=dev) * 0.01 + 1e-3
        bias = torch.randn((1, N), generator=g, device=dev)
        xf = torch.randn((M, K), generator=g, device=dev)
        wf = torch.randn((K, N), generator=g, device=dev)
        return plan, x8, xp, w8, wp, s_a, s_w, bias, xf, wf

    for (K, N, bits, fused), calls in ENCODER_LINEARS.items():
        plan, x8, xp, w8, wp, s_a, s_w, bias, xf, wf = operands(K, N, bits)
        common = dict(fp32_fn=lambda: torch.matmul(xf, wf))
        if bits == 8:
            row("int8_matmul", [K, N], calls,
                lambda: i8.int8_matmul_cuda(xp, w8, s_a, s_w),
                lambda: i8.int8_matmul_plain(x8, w8, s_a, s_w),
                M * K + K * N + 4 + 4 * N + 4 * M * N, 2 * M * K * N, INT8_OPS_PER_S,
                library_fn=lambda: torch._int_mm(x8, w8), **common)
        elif not fused:
            row("int4_matmul", [K, N], calls,
                lambda: i4.int4_matmul_cuda(xp, wp, s_a, s_w),
                lambda: i4.int4_matmul_plain(x8, wp, s_a, s_w),
                M * K + K // 2 * N + 4 + 4 * N + 4 * M * N, 2 * M * K * N,
                INT8_OPS_PER_S, **common)
        else:
            row("int4_matmul_fused", [K, N], calls,
                lambda: i4.int4_matmul_fused_cuda(xp, wp, s_a, s_w, bias, "gelu"),
                lambda: i4.int4_matmul_fused_plain(x8, wp, s_a, s_w, bias, "gelu"),
                M * K + K // 2 * N + 4 + 8 * N + 4 * M * N, 2 * M * K * N,
                INT8_OPS_PER_S, **common)
            rows[-1].update(int_mm_yardsticks(x8, w8))
            rows[-1]["library_note"] = (
                "torch._int_mm on the same int8 codes (int32 out, no epilogue), the "
                "faster of the weight row-major and column-major: the int8 yardstick")
            # the floor of its output bytes: PyTorch filling an (M, N) f32
            # tensor, a write of the same 19.7 MB and nothing else
            out = torch.empty((M, N), device=dev)
            rows[-1]["store_only_ms"] = cuda_ms(lambda: out.fill_(1.0))
        rows[-1]["path"] = plan.name
        del x8, xp, w8, wp, xf, wf
    return rows


#: int4_matmul_fused timed (only) off the encoder's M = 4096: a short batch
#: (split-K, f32 activations quantized in the GEMM) and bert-base's FFN-up
FUSED_TIMED = ((8, 312, 1200), (64, 312, 1200), (M_TIMED, 768, 3072))


def time_fused_paths(dev) -> list[dict]:
    """int4_matmul_fused (GELU, f32 out) at ``FUSED_TIMED`` as ``ops`` calls
    it (split-K on the f32 activations, which it quantizes; wgmma on
    codes), beside its plain version, ``torch._int_mm`` on the int8 codes
    (padded to 32 rows where it refuses fewer) and its bound."""
    import torch.nn.functional as F

    from repro_torch.core.packing import pack_int4
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels.gemm_plan import quantizes_in_gemm

    g = torch.Generator(device=dev).manual_seed(17)
    rows = []
    for M, K, N in FUSED_TIMED:
        x = torch.randn((M, K), generator=g, device=dev)
        s_a = (x.abs().amax() / 8).reshape(())
        x4 = aq.act_quant_plain(x, s_a, 4)
        wp = pack_int4(torch.randint(-7, 9, (K, N), generator=g, device=dev,
                                     dtype=torch.int8))
        w8 = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
        s_w = torch.rand((1, N), generator=g, device=dev) * 0.01 + 1e-3
        bias = torch.randn((1, N), generator=g, device=dev)
        folded = quantizes_in_gemm(M, N, K, 4)
        xin = x if folded else x4
        fn = lambda: i4.int4_matmul_fused_cuda(xin, wp, s_a, s_w, bias, "gelu", a_bits=4)
        in_bytes = M * K * (4 if folded else 1)
        b_ms, b_by = bound(in_bytes + K // 2 * N + 4 + 8 * N + 4 * M * N, 2 * M * K * N,
                           INT8_OPS_PER_S)
        rows.append({"kernel": "int4_matmul_fused", "M": M, "shape": [K, N], "calls": 0,
                     "per": "one call (timed only)",
                     "input": "f32, quantized in the GEMM" if folded else "int8 codes",
                     "path": "splitk" if folded else "wgmma",
                     "ms": cuda_ms(fn), "eager_ms": cuda_ms(fn, graph=False),
                     "plain_ms": cuda_ms(lambda: i4.int4_matmul_fused_plain(
                         x4, wp, s_a, s_w, bias, "gelu")),
                     **int_mm_yardsticks(F.pad(x4, (0, 0, 0, max(0, 32 - M))), w8),
                     "library_note": "torch._int_mm on the int8 codes (zero-padded to "
                                     "32 rows where fewer), no epilogue: the faster layout",
                     "bound_ms": b_ms, "bound_by": b_by})
        del x, x4, wp, w8
    torch.cuda.empty_cache()
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
    on the encoder path only, reports per forward of 32 x 128 tokens;
    flash_attention and act_quant (which a decode step no longer launches)
    per cacheless forward of stablelm-3b at S = 32768 (their rows name
    their unit under 'per'; rows of no calls are timed only).
    ``launches`` sums the main-path runs (``launches_by_path``)."""
    out = []
    for name, (src, replaces) in SOURCES.items():
        enc = [r for r in enc_rows if r["kernel"] == name]
        dec_all = [r for r in dec_rows if r["kernel"] == name]
        dec = [r for r in dec_all if r["kv_bits"] in (None, 8)]
        by_path = {path: counts[name] for path, counts in launches_by_path.items()
                   if counts[name]}
        main = _sums(dec) if dec else _sums(enc)
        per = (([r for r in dec if r["calls"]] or dec)[0].get(
                   "per", "decode step at kv_bits 8, 8 slots at cache length 448")
               if dec else "encoder forward of 32 x 128 tokens")
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": sum(by_path.values()), "launches_by_path": by_path,
                 "max_abs_err": errors[name], **main, "per": per,
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


def decode_close(got, want, name: str = "decode_attention",
                 rtol: float = 0.0) -> float:
    """f32: atol 1e-5 plus ``rtol`` |want|. bf16: one ulp of the output plus
    1e-5 (the two softmax orders differ in f32 by up to 1e-5, which outputs
    near zero keep after rounding). Returns the largest |difference|."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if got.dtype == torch.float32:
        ok = bool((diff <= 1e-5 + rtol * w.abs()).all())
    else:
        ulp = 2.0 ** (torch.frexp(torch.maximum(g.abs(), w.abs())).exponent - 8)
        ok = bool((diff <= ulp + 1e-5).all())
    if not ok:
        raise AssertionError(f"{name}: kernel != plain (max |diff| "
                             f"{diff.max().item()})")
    return diff.max().item()


#: head shapes of the decode-attention checks: stablelm-3b's, internlm2-20b's
#: (GQA group 6, dh 128), and GQA groups 3, 5 and 8: granite-moe-3b-a800m's
#: (dh 64), qwen2.5-32b's and qwen1.5-110b's (dh 128)
DECODE_HEADS = ((32, 32, 80), (48, 8, 128), (24, 8, 64), (40, 8, 128), (64, 8, 128))
#: the long-cache case: (B, S, lengths)
LONG_DECODE = (2, 4096, [4000, 4096])


def decode_lengths(S: int) -> list[int]:
    """Per-slot lengths of the decode-attention grid at extent ``S``: empty,
    short, ragged, full and idle (past S) slots, and the edges of the
    kernel's splits (C - 1, C, C + 1, 2C + 1 for C rows a split)."""
    from repro_torch.kernels.decode_attention import SPLIT_ROWS as C
    return [0, 1, 7, 33, S // 2, S - 1, S, S + 37, C - 1, C, C + 1, 2 * C + 1]


def decode_cases():
    """(H, Hkv, dh, B, S, lengths) of phases 5 and 8: the grid at S in {64,
    512, 520} with :func:`decode_lengths`, then the long cache."""
    for H, Hkv, dh in DECODE_HEADS:
        for S in (64, 512, 520):
            lengths = decode_lengths(S)
            yield H, Hkv, dh, len(lengths), S, lengths
    for H, Hkv, dh in DECODE_HEADS:
        yield H, Hkv, dh, *LONG_DECODE


def check_decode_attention(dev) -> float:
    """Each case of :func:`decode_cases` at kv_bits 8 and 4, f32 and bf16:
    within phase 5's tolerances of the plain version, bit-equal over two
    calls, and bit-unchanged when every row past each slot's length is
    poisoned (garbage codes, scales of 3e4)."""
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain)
    g = torch.Generator(device=dev).manual_seed(77)
    err, cases = 0.0, 0
    for H, Hkv, dh, B, S, lengths in decode_cases():
        for bits in (8, 4):
            for dtype in (torch.float32, torch.bfloat16):
                name = (f"decode_attention B={B} H={H} Hkv={Hkv} dh={dh} S={S} "
                        f"bits={bits} {dtype}")
                args = decode_inputs(dev, g, B, S, H, Hkv, dh, bits, dtype, lengths)
                got = decode_attention_cuda(*args)
                err = max(err, decode_close(got, decode_attention_plain(*args), name))
                if not torch.equal(decode_attention_cuda(*args), got):
                    raise AssertionError(f"{name}: two calls differ")
                for i, n in enumerate(lengths):        # poison past the length
                    args[1][i, n:] = 0x5A if bits == 8 else 0xF3
                    args[2][i, n:] = 0x5A if bits == 8 else 0xF3
                    args[3][i, n:] = 3.0e4
                    args[4][i, n:] = 3.0e4
                if not torch.equal(decode_attention_cuda(*args), got):
                    raise AssertionError(f"{name}: rows past the length moved the "
                                         "output")
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


def record_forwards(eng, record: dict) -> None:
    """Wrap ``eng``'s prefill and decode forwards: each call appends its
    kernel launches, with its token rows under "rows", to
    ``record["prefill"]`` or ``record["decode"]`` (a decoder score runs the
    prefill forward)."""
    from repro_torch.kernels import build
    record.update(prefill=[], decode=[])

    def delta(fn, kind):
        def wrapped(tokens, *a, **k):
            before = dict(build.LAUNCHES)
            out = fn(tokens, *a, **k)
            record[kind].append({**{n: build.LAUNCHES[n] - before[n] for n in before},
                                 "rows": int(tokens.numel())})
            return out
        return wrapped
    eng.prefill_forward = delta(eng.prefill_forward, "prefill")
    eng.decode_forward = delta(eng.decode_forward, "decode")


def serve_decode(model, *, launches=None, tops=None, other=None):
    """Serve the decode traffic on a fresh engine; returns the results in
    submission order (the sampled request's two samples last).
    ``launches`` (a dict) collects the kernel launches of every prefill and
    decode forward, with its token rows under "rows". ``tops`` (a dict) collects, per request, one record per
    decode-sampled position: the top-eight logits and token ids and, unless
    ``other`` is given, the logits row itself (kept on the card). ``other``
    = (results, tops) of an earlier run: each record then also holds the
    logit here of the token that run sampled at that position, and the
    largest |logit difference| over the vocabulary to that run's row."""
    import copy

    import repro_torch.serving.engine as engine_mod
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(model, slots=DECODE_SLOTS, max_len=DECODE_MAX_LEN)
    if launches is not None:
        record_forwards(eng, launches)
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
    linears = decoder_linears(cfg)
    step_table = {**gemm_launches(linears, DECODE_SLOTS), "decode_attention": n}
    if {k: step_table[k] for k in PER_DECODE_STEP} != PER_DECODE_STEP:
        raise AssertionError(f"PER_DECODE_STEP {PER_DECODE_STEP} != the plan's {step_table}")
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
    models, streams = {}, {}
    for kv, plan in plans.items():
        model = DeployedModel(plan=plan, params=loaded.params)
        models[kv] = model
        if kv == 8:
            serve_decode(model)                     # warm-up (kv4 reuses it)
        torch.cuda.synchronize()
        record = {}
        build.reset_counts()
        t0 = time.perf_counter()
        eng, results = serve_decode(model, launches=record)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches, plain = dict(build.LAUNCHES), dict(build.PLAIN_ON_CUDA)
        # every decode step as PER_DECODE_STEP; each prefill's act_quant
        # wherever a linear's plan at its rows does not quantize in the GEMM
        planned = check_launches(f"kv{kv}", record, PER_DECODE_STEP, linears)
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
        streams[kv] = [list(map(int, r.tokens)) for r in results]
        cmp = compare_streams(kv, again, ref, ref_tops, n_greedy=16)
        build.reset_counts()
        cmp["one_step"] = one_step_agreement(
            model, DeployedModel(plan=ref_plan, params=loaded.params), dev)
        summary = eng.metrics.summary()
        out["per_kv"][kv] = {
            "plan": plan.describe(), "requests": len(results),
            "tokens": int(sum(len(r.tokens) for r in results)),
            "decode_steps": len(record["decode"]), "prefill_forwards": len(record["prefill"]),
            "launches": launches, "act_quant_planned": planned,
            "plain_on_cuda": plain, "serve_s": serve_s,
            **cmp,
            "decode_p50_ms": summary.get("decode_p50_ms"),
            "prefill_p50_ms": summary.get("prefill_p50_ms"),
            "ttft_p50_ms": summary.get("ttft_p50_ms")}
    out["models"] = models
    out["streams"] = streams
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


def profile_step(step, top: int = 12) -> dict:
    """One eager call of ``step`` under ``torch.profiler``: the device
    kernels' summed time by name (``key_averages``), the top ``top`` of them,
    and the device-busy share (summed kernel time over the step's host-clock
    time to a synchronise; kernels that overlap count twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        kernels.append({"name": e.key[:160], "count": e.count, "device_us": us})
    kernels.sort(key=lambda k: -k["device_us"])
    busy = sum(k["device_us"] for k in kernels)
    if not busy:
        return {"note": "no device time in the trace", "wall_us": wall_us}
    return {"wall_us": wall_us, "device_us": busy, "device_busy_share": busy / wall_us,
            "kernels": len(kernels), "top": kernels[:top]}


def rotating(sets: list):
    """A call over ``sets`` in turn, one set a call: each set comes back only
    after the others have passed through the 50 MB L2 (cold timing)."""
    state = {"i": 0}

    def next_set():
        state["i"] = (state["i"] + 1) % len(sets)
        return sets[state["i"]]
    return next_set


def cold_sets(nbytes: int) -> int:
    """How many distinct input sets of ``nbytes`` a cold timing rotates over:
    enough that the others exceed the L2 (50 MB) with room."""
    return max(2, -(-60_000_000 // max(nbytes, 1)) + 1)


def int_mm_yardsticks(x8: torch.Tensor, w8: torch.Tensor, timer=None) -> dict:
    """``torch._int_mm`` on the same int8 codes, timed with the weight
    row-major as the port keeps it and column-major (a (N, K) contiguous
    copy passed as ``.t()``, the layout cuBLASLt's int8 kernels take);
    ``library_ms`` is the faster. Timed only: the port never calls it."""
    timer = timer or cuda_ms
    w8c = w8.t().contiguous().t()
    out = {}
    for key, w in (("library_ms_row_major", w8), ("library_ms_col_major", w8c)):
        try:
            out[key] = timer(lambda: torch._int_mm(x8, w))
        except RuntimeError as e:      # the library refuses the layout
            out[key] = None
            out[key.replace("_ms_", "_note_")] = f"refused: {str(e).splitlines()[0][:120]}"
    times = [v for k, v in out.items() if k.startswith("library_ms_") and v is not None]
    out["library_ms"] = min(times) if times else None
    return out


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
        if kv == 8:
            out["decode_step_profile_kv8"] = profile_step(step)
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
    from repro_torch.kernels.gemm_plan import gemm_plan

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

    # timed only: the split-K GEMMs quantize a step's activations themselves
    for K, calls in DECODE_ACT_QUANT.items():
        x = torch.randn((M, K), generator=g, device=dev).to(bf)
        s = (x.float().abs().amax() / 127).reshape(())
        row("act_quant", [K, 8], 0, lambda: aq.act_quant_cuda(x, s, 8),
            lambda: aq.act_quant_plain(x, s, 8), M * K * 2 + 4 + M * K, 4 * M * K,
            FP32_OPS_PER_S)
        rows[-1].update(per=f"one call (timed only): the {calls} calls a step had before "
                            "split-K quantized its own activations")
    for (K, N), calls in DECODE_MATMULS.items():
        # the step's bf16 activations, which split-K quantizes as it loads
        # them, and their codes (the GEMM alone, as timed before)
        x = torch.randn((M, K), generator=g, device=dev).to(bf)
        s_x = (x.float().abs().amax() / 127).reshape(())
        x8 = aq.act_quant_plain(x, s_x, 8)
        w8s = [torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
               for _ in range(cold_sets(K * N))]
        wps = [pack_int4(torch.randint(-7, 9, (K, N), generator=g, device=dev,
                                       dtype=torch.int8))
               for _ in range(cold_sets(K * N // 2))]
        w8, wp = w8s[0], wps[0]
        s_a = torch.tensor(0.02, device=dev)
        s_w = torch.rand((1, N), generator=g, device=dev) * 0.01 + 1e-3
        out_b = M * N * 2 + 4 + 4 * N
        lib = int_mm_yardsticks(F.pad(x8, (0, 0, 0, 32 - M)), w8)
        lib_note = ("torch._int_mm on the codes zero-padded to M = 32 (it refuses M "
                    "= 8), int32 out, no epilogue: the faster of the weight row-major "
                    "and column-major")
        for kernel, fn, plain, ws, wbytes, bits in (
                ("int8_matmul", i8.int8_matmul_cuda, i8.int8_matmul_plain, w8s, K * N, 8),
                ("int4_matmul", i4.int4_matmul_cuda, i4.int4_matmul_plain, wps,
                 K // 2 * N, 4)):
            nxt = rotating(ws)
            row(kernel, [K, N], calls,
                lambda: fn(x, ws[0], s_x, s_w, out_dtype=bf),
                lambda: plain(aq.act_quant_plain(x, s_x, 8), ws[0], s_x, s_w, out_dtype=bf),
                M * K * 2 + wbytes + out_b, 2 * M * K * N, INT8_OPS_PER_S,
                library_note=lib_note if bits == 8 else "no int4 library call")
            rows[-1].update(
                input="bf16, quantized in the GEMM",
                ms_cold=cuda_ms(lambda: fn(x, nxt(), s_x, s_w, out_dtype=bf)),
                ms_codes=cuda_ms(lambda: fn(x8, ws[0], s_a, s_w, out_dtype=bf)),
                ms_codes_cold=cuda_ms(lambda: fn(x8, nxt(), s_a, s_w, out_dtype=bf)),
                cold_sets=len(ws), path=gemm_plan(M, N, K, bits).name,
                **(lib if bits == 8 else {}))
        del w8s, wps, w8, wp
        torch.cuda.empty_cache()
    def attention_rows(B, S, L, bits, calls, **extra):
        """decode_attention at (B, S, len L), stablelm-3b heads, bf16: warm
        (the same cache every call, as the earlier designs were timed) and
        cold (rotating over caches that exceed the L2), beside its plain
        version, SDPA on a cache already dequantized to bf16 (warm and
        cold) and its bound."""
        H, Hkv, dh = 32, 32, 80
        nbytes = da.bound_bytes(B, S, Hkv, H, dh, bits, [L] * B, 2)
        sets = [decode_inputs(dev, g, B, S, H, Hkv, dh, bits, bf, [L] * B)
                for _ in range(cold_sets(2 * B * S * Hkv * ((dh if bits == 8 else dh // 2) + 4)))]
        mask = (torch.arange(S, device=dev) < L)[None, None, None, :]

        def sdpa_inputs(a):
            return (a[0][:, :, None, :],
                    kv_pack.dequantize_kv(a[1], a[3], bf).transpose(1, 2),   # (B,H,S,dh)
                    kv_pack.dequantize_kv(a[2], a[4], bf).transpose(1, 2))
        sd = [sdpa_inputs(a) for a in sets[:cold_sets(4 * B * S * H * dh)]]
        kern, lib = rotating(sets), rotating(sd)
        b_ms, b_by = bound(nbytes, 4 * B * H * (L + 1) * dh, FP32_OPS_PER_S)
        rows.append({
            "kernel": "decode_attention", "M": B, "shape": [B, S, L, H, Hkv, dh],
            "calls": calls, "kv_bits": bits, **extra,
            "ms": cuda_ms(lambda: da.decode_attention_cuda(*sets[0])),
            "ms_cold": cuda_ms(lambda: da.decode_attention_cuda(*kern())),
            "eager_ms": cuda_ms(lambda: da.decode_attention_cuda(*sets[0]), graph=False),
            "plain_ms": cuda_ms(lambda: da.decode_attention_plain(*sets[0])),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                *sd[0], attn_mask=mask)),
            "library_ms_cold": cuda_ms(lambda: F.scaled_dot_product_attention(
                *lib(), attn_mask=mask)),
            "library_note": "SDPA over a cache already dequantized to bf16 "
                            "(excludes the dequantization)",
            "cold_sets": [len(sets), len(sd)], "bound_ms": b_ms, "bound_by": b_by})
        del sets, sd
        torch.cuda.empty_cache()

    for bits in (8, 4):
        attention_rows(DECODE_SLOTS, DECODE_MAX_LEN, DECODE_LEN, bits,
                       PER_DECODE_STEP["decode_attention"])
    # timed only: one slot with a long cache, where a grid of (heads, slots)
    # would fill a quarter of the SMs
    attention_rows(1, LONG_CACHE, LONG_CACHE, 8, 0,
                   per="one call, B = 1 at cache length 8192 (timed only)")
    return rows


# ------------------------------------------------------------------ phase 8
def paged_inputs(dev, g, B, S, H, Hkv, dh, bits, dtype, lengths, extra: int = 0):
    """A pool of B * nb + 8 blocks of random K/V (the port's quantize_kv)
    and (B, nb) tables over it, nb = S / 8 + ``extra``: a permutation of the
    pool's blocks, the leading blocks of slot 4 shared with slot 3, and the
    sentinel (the pool size) or an entry past it wherever a table runs past
    its slot's length. Returns the paged kernel's arguments."""
    from repro_torch.kernels import kv_pack
    nb = S // BLOCK + extra
    NB = B * nb + 8
    k_q, k_s = kv_pack.quantize_kv(
        torch.randn((NB, BLOCK, Hkv, dh), generator=g, device=dev), bits)
    v_q, v_s = kv_pack.quantize_kv(
        torch.randn((NB, BLOCK, Hkv, dh), generator=g, device=dev), bits)
    q = torch.randn((B, H, dh), generator=g, device=dev).to(dtype)
    kn = torch.randn((B, Hkv, dh), generator=g, device=dev).to(dtype)
    vn = torch.randn((B, Hkv, dh), generator=g, device=dev).to(dtype)
    perm = np.random.default_rng(S + bits).permutation(NB)[:B * nb]
    tables = perm.reshape(B, nb).astype(np.int32)
    for i, n in enumerate(lengths):
        used = -(-min(max(n, 0), nb * BLOCK) // BLOCK)
        tables[i, used:] = NB if i % 2 else NB + 5
    if B > 4:
        tables[4, :2] = tables[3, :2]             # blocks shared between slots
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return [q, k_q, v_q, k_s, v_s, torch.as_tensor(tables, device=dev), kn, vn, lens]


def live_rows(tables: np.ndarray, lengths, NB: int) -> np.ndarray:
    """(NB, BLOCK) mask of the pool rows some table reaches below its
    slot's length (entries clamped to [0, NB - 1], as the kernel does)."""
    live = np.zeros((NB, BLOCK), bool)
    S = tables.shape[1] * BLOCK
    for b, n in enumerate(lengths):
        pos = np.arange(min(max(n, 0), S))
        live[np.clip(tables[b, pos // BLOCK], 0, NB - 1), pos % BLOCK] = True
    return live


#: the wider-table case: tables of S / 8 + WIDE_EXTRA entries against the
#: dense kernel over extent S = WIDE_S (512 against 640 rows), lengths <= S
WIDE_S, WIDE_EXTRA = 512, 16


def check_decode_attention_paged(dev) -> tuple[float, int]:
    """Phase 5's cases through the paged kernel, then tables wider than the
    dense extent they are compared with: within phase 5's tolerances of
    the plain version, bit-equal over two calls, bit-equal to the dense
    kernel on the layout the tables describe (cut to the dense extent), and
    bit-unchanged when every pool row no table reaches below its slot's
    length is poisoned (NaN scales, garbage codes)."""
    from repro_torch.kernels.decode_attention import (
        SPLIT_ROWS, decode_attention_cuda, decode_attention_paged_cuda,
        decode_attention_paged_plain, gather_kv_blocks)
    g = torch.Generator(device=dev).manual_seed(78)
    err, cases = 0.0, 0
    C = SPLIT_ROWS
    # lengths up to the dense extent: past it the dense call attends S rows
    # and the wider tables more, by definition
    wide = sorted({n for n in (0, 1, 7, C - 1, C, C + 1, 2 * C - 1, 2 * C + 1,
                               WIDE_S // 2, WIDE_S - 1, WIDE_S) if n <= WIDE_S})
    grid = [(*case, 0) for case in decode_cases()]
    grid += [(H, Hkv, dh, len(wide), WIDE_S, wide, WIDE_EXTRA)
             for H, Hkv, dh in DECODE_HEADS]
    for H, Hkv, dh, B, S, lengths, extra in grid:
        for bits in (8, 4):
            for dtype in (torch.float32, torch.bfloat16):
                args = paged_inputs(dev, g, B, S, H, Hkv, dh, bits, dtype, lengths,
                                    extra)
                q, pool, tables, (kn, vn, lens) = args[0], args[1:5], args[5], args[6:]
                name = (f"decode_attention_paged B={B} H={H} Hkv={Hkv} dh={dh} "
                        f"S={S} extent={tables.shape[1] * BLOCK} bits={bits} {dtype}")
                got = decode_attention_paged_cuda(*args)
                err = max(err, decode_close(
                    got, decode_attention_paged_plain(*args), name))
                if not torch.equal(decode_attention_paged_cuda(*args), got):
                    raise AssertionError(f"{name}: two calls differ")
                dense = [gather_kv_blocks(b, tables[:, :S // BLOCK]).contiguous()
                         for b in pool]
                if not torch.equal(got, decode_attention_cuda(q, *dense, kn, vn, lens)):
                    raise AssertionError(f"{name}: != the dense kernel on the "
                                         "gathered layout")
                dead = torch.as_tensor(~live_rows(tables.cpu().numpy(), lengths,
                                                  pool[0].shape[0]), device=dev)
                for codes in pool[:2]:
                    codes[dead] = 0x5A if bits == 8 else 0xF3
                for scales in pool[2:]:
                    scales[dead] = float("nan")
                if not torch.equal(decode_attention_paged_cuda(*args), got):
                    raise AssertionError(f"{name}: rows no table reaches moved "
                                         "the output")
                cases += 1
    torch.cuda.synchronize()
    return err, cases


# ------------------------------------------------------------------ phase 9
def paged_model(model, kv_paging: str = "paged", prefix_cache: int = 0,
                kv_bits=None):
    """``model``'s artifact under the same plan with another KV layout (or
    another KV precision)."""
    from repro_torch.deploy import DeployedModel, ExecutionPlan
    p = model.plan
    plan = ExecutionPlan.build(p.cfg, p.policy, backend=p.backend, mode=p.mode,
                               kv_bits=kv_bits or p.kv_bits,
                               prefill_batch=p.prefill_batch,
                               kv_paging=kv_paging, prefix_cache=prefix_cache)
    return DeployedModel(plan=plan, params=model.params)


def check_launches(tag: str, record: dict, per_step: dict, linears: dict) -> int:
    """Every decode step launched ``per_step``; every prefill forward (and
    prefix chunk forward) the GEMMs and act_quant launches
    ``gemm_launches(linears, rows)`` names for its rows and no decode
    attention of either kind; no plain version ran on a CUDA tensor.
    Returns the act_quant launches the plan called for."""
    from repro_torch.kernels import build
    for step in record["decode"]:
        if {k: step[k] for k in per_step} != per_step:
            raise AssertionError(f"{tag}: decode step launched {step}, "
                                 f"expected {per_step}")
    planned = 0
    for step in record["prefill"] + record.get("chunk", []):
        want = gemm_launches(linears, step["rows"])
        planned += want["act_quant"]
        if (step["decode_attention"] or step["decode_attention_paged"]
                or any(step[k] != want[k] for k in GEMM_NAMES)):
            raise AssertionError(f"{tag}: a forward of {step['rows']} rows launched "
                                 f"{step}, expected {want}")
    if any(build.PLAIN_ON_CUDA.values()):
        raise AssertionError(f"{tag}: plain versions ran on CUDA tensors: "
                             f"{build.PLAIN_ON_CUDA}")
    return planned


def paged_end_to_end(models: dict, dense_streams: dict) -> dict:
    """Phase 6's traffic through a paged engine (dense-equivalent budget,
    prefix off) at kv_bits 8 and 4: byte-identical streams to phase 6's
    dense run, and every decode step through the paged kernel."""
    from repro_torch.kernels import build
    out = {}
    for kv, model in models.items():
        pm = paged_model(model)
        record = {}
        build.reset_counts()
        t0 = time.perf_counter()
        eng, results = serve_decode(pm, launches=record)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        planned = check_launches(f"paged kv{kv}", record, PAGED_DECODE_STEP,
                                 decoder_linears(model.plan.cfg))
        got = [list(map(int, r.tokens)) for r in results]
        equal = sum(a == b for a, b in zip(got, dense_streams[kv]))
        if equal != len(got):
            raise AssertionError(f"paged kv{kv}: {len(got) - equal} of {len(got)} "
                                 "streams differ from the dense engine's")
        st = eng.pool.stats()
        if (eng.pool.refs != 0).any() or st["blocks_in_use"]:
            raise AssertionError(f"paged kv{kv}: blocks still held after draining: {st}")
        summary = eng.metrics.summary()
        out[kv] = {"plan": pm.plan.describe(), "streams": len(got),
                   "streams_equal_to_dense": equal,
                   "decode_steps": len(record["decode"]),
                   "prefill_forwards": len(record["prefill"]),
                   "launches": launches, "act_quant_planned": planned,
                   "plain_on_cuda": dict(build.PLAIN_ON_CUDA),
                   "pool": st, "serve_s": serve_s,
                   "decode_p50_ms": summary.get("decode_p50_ms"),
                   "prefill_p50_ms": summary.get("prefill_p50_ms")}
    return out


# ----------------------------------------------------------------- phase 10
def prefix_traffic(vocab: int):
    """13 requests from a fixed seed: one sampled (T 0.8, top-k 50, top-p
    0.9, n = 2) on a 200-token prompt, submitted first so its two samples
    prefill together; 8 that share a 256-token system prompt followed by
    8-72 distinct tokens (16-48 new tokens); 4 unique prompts of 100-300
    tokens. Returns the requests and the indices of the greedy ones."""
    from repro_torch.serving import GenerationRequest, SamplingParams
    rng = np.random.default_rng(21)
    ints = lambda n: rng.integers(1, vocab, n).astype(np.int32)
    reqs = [GenerationRequest(prompt=ints(200), max_new_tokens=32, sampling=SamplingParams(
        temperature=0.8, top_k=50, top_p=0.9, seed=11, n=2))]
    system = ints(256)
    for tail, new in zip((8, 17, 24, 33, 40, 51, 64, 72), (16, 48, 24, 40, 32, 16, 48, 24)):
        reqs.append(GenerationRequest(prompt=np.concatenate([system, ints(tail)]),
                                      max_new_tokens=new))
    for n, new in zip((100, 150, 220, 300), (32, 16, 48, 24)):
        reqs.append(GenerationRequest(prompt=ints(n), max_new_tokens=new))
    return reqs, list(range(1, len(reqs)))


def serve_prefix(model, *, rounds: int = 1, kv_budget_bytes=None, ref_rows=None):
    """Serve the prefix traffic ``rounds`` times on one engine. Per round:
    the streams in submission order (the sampled request's samples as a
    list), the launches of every forward, the pool's or prefix cache's
    stats, the peak number of concurrent requests, and, per greedy
    request and sampled position, the logits row (kept on the card) or,
    given ``ref_rows`` of an earlier run, the largest |logit difference|
    to that run's row at the same position."""
    import copy

    import repro_torch.serving.engine as engine_mod
    from repro_torch.kernels import build
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(model, slots=DECODE_SLOTS, max_len=DECODE_MAX_LEN,
                        kv_budget_bytes=kv_budget_bytes)
    record = {"prefill": [], "decode": [], "chunk": []}

    def delta(fn, kind):
        def wrapped(*a):           # (tokens) or, for a chunk, (state, tokens)
            before = dict(build.LAUNCHES)
            out = fn(*a)
            record[kind].append({**{n: build.LAUNCHES[n] - before[n] for n in before},
                                 "rows": int(a[-1].numel())})
            return out
        return wrapped
    for kind in ("prefill", "decode", "chunk"):
        setattr(eng, f"{kind}_forward", delta(getattr(eng, f"{kind}_forward"), kind))
    rows: dict = {}        # rid -> per position: logits row, or |diff| to ref_rows
    index: dict = {}       # rid -> index of its greedy request

    def note(rid, row):
        if rid not in index:
            return
        seen = rows.setdefault(rid, [])
        if ref_rows is None:
            seen.append(row.float().clone())
        else:
            ref = ref_rows[index[rid]]
            seen.append((row.float() - ref[len(seen)]).abs().max()
                        if len(seen) < len(ref) else None)
    sample_first = eng._sample_first

    def first_spy(logits_row, slot):
        note(eng.scheduler.active[slot].rid, logits_row)
        return sample_first(logits_row, slot)
    eng._sample_first = first_spy
    orig = engine_mod.sample_batch

    def batch_spy(logits, *a):
        for s, req in enumerate(eng.scheduler.active):
            if req is not None:
                note(req.rid, logits[s])
        return orig(logits, *a)
    engine_mod.sample_batch = batch_spy
    reqs, greedy = prefix_traffic(model.plan.cfg.vocab_size)
    out = []
    try:
        for _ in range(rounds):
            for key in record:
                record[key] = []
            rows.clear()
            index.clear()
            streams = []
            for i, req in enumerate(reqs):
                st = eng.submit(copy.deepcopy(req))
                streams.append(st)
                if i in greedy:
                    index[st.rid] = i
            peak = 0
            while eng.scheduler.has_work:
                eng.engine_step()
                peak = max(peak, eng.scheduler.num_active)
            torch.cuda.synchronize()
            results = [[s.result() for s in st] if isinstance(st, list) else st.result()
                       for st in streams]
            for r in results:
                for x in r if isinstance(r, list) else [r]:
                    if x.finish_reason not in ("length", "stop"):
                        raise AssertionError(f"request {x.rid} finished "
                                             f"{x.finish_reason!r}")
            tokens = [[list(map(int, x.tokens)) for x in r] if isinstance(r, list)
                      else list(map(int, r.tokens)) for r in results]
            if eng.pool is not None:
                stats = eng.pool.stats()
                if (eng.pool.refs != 0).any():
                    raise AssertionError(f"refcounts did not drain: {stats}")
            else:
                stats = eng.prefix_cache.stats()
            by_index = {index[rid]: v for rid, v in rows.items()}
            out.append({"tokens": tokens, "rows": by_index, "peak": peak,
                        "stats": stats, "record": {k: list(v) for k, v in record.items()},
                        "decode_p50_ms": eng.metrics.summary().get("decode_p50_ms")})
    finally:
        engine_mod.sample_batch = orig
    return out


def compare_prefix(ref, run) -> dict:
    """Greedy streams of ``run`` against ``ref`` (both one round of
    ``serve_prefix``; ``run`` recorded against ``ref``'s rows): equal, or
    first differing at a near-tie under phase 6's rule, with the noise
    taken over the positions up to and including the parting one (their
    histories agree)."""
    equal, parted = 0, []
    for i, want in enumerate(ref["tokens"]):
        if i not in ref["rows"]:
            continue                                   # the sampled request
        got = run["tokens"][i]
        diff = [j for j, (a, b) in enumerate(zip(got, want)) if a != b]
        if not diff:
            equal += 1
            continue
        j = diff[0]
        noise = max(float(d) for d in run["rows"][i][:j + 1])
        row = ref["rows"][i][j]
        top = float(row.max())
        gap = top - float(row[got[j]])
        parted.append({"request": i, "step": j, "token": got[j], "ref_token": want[j],
                       "gap": gap, "noise": noise, "ulp": bf16_ulp(top)})
        if gap > 2 * noise + bf16_ulp(top):
            raise AssertionError(f"prefix request {i}: the streams part at token {j} "
                                 f"({got[j]} vs {want[j]}), {gap} below the top logit "
                                 f"> 2 x {noise} + one bf16 ulp")
    return {"greedy_equal": equal, "greedy": len(ref["rows"]),
            "parted_at_near_ties": parted}


#: phase 10's depth: the first PREFIX_LAYERS / 2 layers of each of phase
#: 6's two bit-width segments
PREFIX_LAYERS = 16


def depth_cut(model, layers: int):
    """``model`` cut to ``layers`` layers: the first ``layers / 2`` of each
    of its two bit-width segments (views of its tensors, nothing copied),
    under the same policy shape (W8A8, then W4A4) at that depth."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.tree import tree_map
    from repro_torch.deploy import DeployedModel, ExecutionPlan
    p, half = model.plan, layers // 2
    if len(p.segments) != 2:
        raise ValueError(f"depth_cut takes a two-segment plan, got {p.describe()}")
    cfg = p.cfg.replace(num_layers=layers)
    policy = QuantPolicy(num_layers=layers, mode="int", last_k_int4=half)
    plan = ExecutionPlan.build(cfg, policy, backend=p.backend, mode=p.mode,
                               kv_bits=p.kv_bits, prefill_batch=p.prefill_batch)
    params = {**model.params, "layers": [tree_map(lambda a: a[:half], seg)
                                         for seg in model.params["layers"]]}
    return DeployedModel(plan=plan, params=params)


def step_launches(cfg, paged: bool) -> dict:
    """The launches of one decode step (8 slots) of ``cfg`` under the serve
    CLI's policy: ``gemm_launches`` of its linears and one attention kernel
    a layer, dense or paged (``PER_DECODE_STEP``'s keys)."""
    out = {**gemm_launches(decoder_linears(cfg), DECODE_SLOTS),
           "decode_attention": 0, "decode_attention_paged": 0}
    out["decode_attention_paged" if paged else "decode_attention"] = cfg.num_layers
    return {k: out[k] for k in (PAGED_DECODE_STEP if paged else PER_DECODE_STEP)}


def prefix_end_to_end(models: dict) -> dict:
    """The shared-prefix traffic at kv_bits 8, on phase 6's artifact cut to
    ``PREFIX_LAYERS`` layers, through (i) a dense engine with a 256 MiB
    prefix cache, (ii) a paged engine with the prefix registry at the
    dense-equivalent budget, (iii) the same paged engine at 60 % of that
    budget, served twice in a row."""
    from repro_torch.kernels import build
    model = depth_cut(models[8], PREFIX_LAYERS)
    linears = decoder_linears(model.plan.cfg)
    dense_step = step_launches(model.plan.cfg, paged=False)
    paged_step = step_launches(model.plan.cfg, paged=True)
    dense = paged_model(model, "dense", 256 << 20)
    paged = paged_model(model, "paged", 256 << 20)
    out = {}
    build.reset_counts()
    t0 = time.perf_counter()
    (ref,) = serve_prefix(dense)
    out["dense_prefix"] = {"seconds": time.perf_counter() - t0,
                           "launches": dict(build.LAUNCHES)}
    out["dense_prefix"]["act_quant_planned"] = check_launches(
        "prefix dense", ref["record"], dense_step, linears)
    build.reset_counts()
    t0 = time.perf_counter()
    (full,) = serve_prefix(paged, ref_rows=ref["rows"])
    out["paged_prefix"] = {"seconds": time.perf_counter() - t0,
                           "launches": dict(build.LAUNCHES)}
    out["paged_prefix"]["act_quant_planned"] = check_launches(
        "prefix paged", full["record"], paged_step, linears)
    if full["tokens"] != ref["tokens"]:
        bad = [i for i, (a, b) in enumerate(zip(full["tokens"], ref["tokens"])) if a != b]
        raise AssertionError(f"paged prefix streams differ from the dense prefix "
                             f"engine's: requests {bad}")
    if full["stats"]["hits"] != ref["stats"]["hits"]:
        raise AssertionError(f"hits differ: paged {full['stats']['hits']}, dense "
                             f"{ref['stats']['hits']}")
    from repro_torch.serving import BlockPool
    block_bytes = BlockPool.block_bytes(paged.plan.cfg, 8, paged.plan.torch_dtype)
    budget = int(0.6 * DECODE_SLOTS * (DECODE_MAX_LEN // BLOCK) * block_bytes)
    build.reset_counts()
    t0 = time.perf_counter()
    tight = serve_prefix(paged, rounds=2, kv_budget_bytes=budget, ref_rows=ref["rows"])
    out["paged_prefix_60pct"] = {"seconds": time.perf_counter() - t0,
                                 "launches": dict(build.LAUNCHES),
                                 "budget_bytes": budget}
    hits_before, planned = 0, 0
    for r, rnd in enumerate(tight):
        planned += check_launches(f"prefix paged 60% round {r + 1}", rnd["record"],
                                  paged_step, linears)
        rnd["hits_this_round"] = rnd["stats"]["hits"] - hits_before
        hits_before = rnd["stats"]["hits"]
    out["paged_prefix_60pct"]["act_quant_planned"] = planned
    if tight[1]["hits_this_round"] < 8:
        raise AssertionError(f"60% budget, round 2: {tight[1]['hits_this_round']} hits, "
                             "expected at least 8")
    if tight[1]["stats"]["cow_forks"] < 1:
        raise AssertionError("60% budget: no copy-on-write fork")
    cmp = [compare_prefix(ref, rnd) for rnd in tight]

    def summary(run):
        return {"peak_concurrent": run["peak"], "stats": run["stats"],
                "decode_steps": len(run["record"]["decode"]),
                "prefill_forwards": len(run["record"]["prefill"]),
                "chunk_forwards": len(run["record"]["chunk"]),
                "decode_p50_ms": run["decode_p50_ms"]}
    out["layers"] = PREFIX_LAYERS
    out["dense_prefix"].update(summary(ref))
    out["paged_prefix"].update(summary(full), streams_equal_to_dense_prefix=len(ref["tokens"]))
    out["paged_prefix_60pct"]["rounds"] = [
        {**summary(rnd), "hits_this_round": rnd["hits_this_round"], **c}
        for rnd, c in zip(tight, cmp)]
    return out


# ----------------------------------------------------------------- phase 11
def time_paged_decode(models, dev) -> dict:
    """One paged decode step with 8 active slots at cache length 448 (a
    permuted pool; the tables, lengths and write targets in static device
    tensors), eager and replayed from a CUDA graph, timed in turns with
    phase 7's dense step in the same call: dense, paged, paged, dense."""
    from repro_torch.models import api
    from repro_torch.serving import BlockPool, sample_batch

    out = {}
    zeros = np.zeros(DECODE_SLOTS)
    nb = DECODE_MAX_LEN // BLOCK
    for kv, model in models.items():
        pm = paged_model(model)
        pool = BlockPool(pm.plan.cfg, DECODE_SLOTS * nb * BlockPool.block_bytes(
            pm.plan.cfg, kv, pm.plan.torch_dtype), dtype=pm.plan.torch_dtype,
            kv_bits=kv, device=dev)
        g = torch.Generator(device=dev).manual_seed(4)
        for key in ("k_q", "v_q"):
            pool.bufs[key].copy_(torch.randint(0, 255, pool.bufs[key].shape, generator=g,
                                               device=dev, dtype=torch.int32)
                                 .to(pool.bufs[key].dtype))
        for key in ("k_scale", "v_scale"):
            pool.bufs[key].copy_(torch.rand(pool.bufs[key].shape, generator=g, device=dev)
                                 * 0.05)
        tables = np.random.default_rng(kv).permutation(pool.num_blocks).reshape(
            DECODE_SLOTS, nb).astype(np.int32)
        paged_st = {**pool.bufs, "tables": torch.as_tensor(tables, device=dev),
                    "len": torch.full((DECODE_SLOTS,), DECODE_LEN, dtype=torch.int32,
                                      device=dev),
                    "write_block": torch.as_tensor(tables[:, DECODE_LEN // BLOCK],
                                                   dtype=torch.int64, device=dev),
                    "write_off": torch.full((DECODE_SLOTS,), DECODE_LEN % BLOCK,
                                            dtype=torch.int64, device=dev)}
        dense_st = decode_state_at(model, dev, DECODE_LEN)
        toks = torch.randint(1, pm.plan.cfg.vocab_size, (DECODE_SLOTS, 1), device=dev)

        def stepper(m, st):
            def step():
                with torch.no_grad():
                    logits, _ = api.forward(m.params, m.plan, state=st, tokens=toks)
                    return sample_batch(logits[:, -1], zeros, zeros, zeros, zeros,
                                        np.ones(DECODE_SLOTS))
            return step
        runs = {"dense": [], "paged": []}
        for name in ("dense", "paged", "paged", "dense"):
            step = stepper(pm, paged_st) if name == "paged" else stepper(model, dense_st)
            runs[name].append((cuda_ms(step, reps=1, samples=10, graph=False),
                               cuda_ms(step, reps=1, samples=10)))
        for name, pairs in runs.items():
            eager = statistics.mean(e for e, _ in pairs)
            device = statistics.mean(d for _, d in pairs)
            out[f"{name}_decode_step_kv{kv}"] = {
                "slots": DECODE_SLOTS, "cache_len": DECODE_LEN,
                "eager_ms": eager, "device_ms": device,
                "eager_ms_runs": [e for e, _ in pairs],
                "device_ms_runs": [d for _, d in pairs],
                "eager_tokens_per_s": DECODE_SLOTS / (eager / 1e3),
                "device_tokens_per_s": DECODE_SLOTS / (device / 1e3),
                "device_idle_share_eager": 1.0 - device / eager}
        del pool, paged_st, dense_st
        torch.cuda.empty_cache()
    return out


def time_paged_kernel(dev) -> list[dict]:
    """``decode_attention_paged`` at the decode shape (8 slots at length
    448, S 512, a permuted pool), timed in turns with the dense kernel on
    the gathered layout (dense, paged, paged, dense), beside its plain
    version, SDPA over the already gathered and dequantized bf16 cache and
    its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import kv_pack

    g = torch.Generator(device=dev).manual_seed(10)
    B, S, H, Hkv, dh = DECODE_SLOTS, DECODE_MAX_LEN, 32, 32, 80
    rows = []
    for bits in (8, 4):
        dhp = dh if bits == 8 else dh // 2
        sets = [paged_inputs(dev, g, B, S, H, Hkv, dh, bits, torch.bfloat16,
                             [DECODE_LEN] * B)
                for _ in range(cold_sets(2 * (B * S + 8 * BLOCK) * Hkv * (dhp + 4)))]
        args = sets[0]
        q, tables, (kn, vn, lens) = args[0], args[5], args[6:]
        dense = [da.gather_kv_blocks(b, tables).contiguous() for b in args[1:5]]
        mask = (torch.arange(S, device=dev) < DECODE_LEN)[None, None, None, :]

        def sdpa_inputs(a):
            gathered = [da.gather_kv_blocks(b, a[5]) for b in a[1:5]]
            return (a[0][:, :, None, :],
                    kv_pack.dequantize_kv(gathered[0], gathered[2],
                                          torch.bfloat16).transpose(1, 2),
                    kv_pack.dequantize_kv(gathered[1], gathered[3],
                                          torch.bfloat16).transpose(1, 2))
        sd = [sdpa_inputs(a) for a in sets[:cold_sets(4 * B * S * H * dh)]]
        kern, lib = rotating(sets), rotating(sd)
        nbytes = da.bound_bytes_paged(B, S // BLOCK, BLOCK, Hkv, H, dh, bits,
                                      [DECODE_LEN] * B, 2)
        b_ms, b_by = bound(nbytes, 4 * B * H * (DECODE_LEN + 1) * dh, FP32_OPS_PER_S)
        fns = {"paged": lambda: da.decode_attention_paged_cuda(*args),
               "dense": lambda: da.decode_attention_cuda(q, *dense, kn, vn, lens)}
        runs = {"dense": [], "paged": []}
        for name in ("dense", "paged", "paged", "dense"):
            runs[name].append(cuda_ms(fns[name]))
        rows.append({"kernel": "decode_attention_paged", "M": B,
                     "shape": [B, S, DECODE_LEN, H, Hkv, dh],
                     "calls": PAGED_DECODE_STEP["decode_attention_paged"],
                     "ms": statistics.mean(runs["paged"]), "ms_runs": runs["paged"],
                     "ms_cold": cuda_ms(lambda: da.decode_attention_paged_cuda(*kern())),
                     "dense_kernel_ms": statistics.mean(runs["dense"]),
                     "dense_kernel_ms_runs": runs["dense"],
                     "eager_ms": cuda_ms(fns["paged"], graph=False),
                     "plain_ms": cuda_ms(lambda: da.decode_attention_paged_plain(*args)),
                     "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                         *sd[0], attn_mask=mask)),
                     "library_ms_cold": cuda_ms(lambda: F.scaled_dot_product_attention(
                         *lib(), attn_mask=mask)),
                     "library_note": "SDPA over the cache already gathered and "
                                     "dequantized to bf16 (excludes both)",
                     "cold_sets": [len(sets), len(sd)],
                     "bound_ms": b_ms, "bound_by": b_by, "kv_bits": bits})
        del sets, sd, args, dense
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------ phase 12
#: (B, S, H, Hkv, dh) of the flash-attention checks: small GQA and MHA
#: shapes, stablelm-3b's and llava-next-mistral-7b's heads at S = 4096, then
#: the bf16 kernel's tiles (128 query rows, 128 keys at dh <= 80 and 64 at
#: dh = 128): S = 1, S = 200 and 4097 (ragged), dh 80 and 128 at GQA groups
#: 1, 2 and 4; then GQA groups 3 (granite-moe-3b-a800m, dh 64), 5
#: (qwen2.5-32b) and 8 (qwen1.5-110b) at their full head counts
FLASH_CASES = ((2, 256, 4, 2, 16), (1, 512, 8, 8, 64), (1, 4096, 32, 32, 80),
               (1, 4096, 32, 8, 128), (1, 1, 4, 2, 80), (1, 1, 4, 1, 128),
               (1, 200, 8, 2, 80), (1, 200, 8, 4, 128), (1, 4097, 8, 4, 80),
               (1, 4097, 8, 8, 128), (1, 1024, 24, 8, 64), (1, 1000, 40, 8, 128),
               (1, 1024, 64, 8, 128))
FLASH_PLAIN_BLOCKS = ((64, 64), (128, 64), (1024, 1024))


def flash_plain_blocks(S: int) -> list:
    """The blocks of ``FLASH_PLAIN_BLOCKS`` that tile S (the plain version
    cuts each to S), or the whole length as one block where none does."""
    fits = [(bq, bk) for bq, bk in FLASH_PLAIN_BLOCKS
            if S % min(bq, S) == 0 and S % min(bk, S) == 0]
    return fits or [(S, S)]


def flash_inputs(dev, g, B, S, H, Hkv, dh, dtype):
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((B, S, H, dh), (B, S, Hkv, dh), (B, S, Hkv, dh))]


def check_flash_attention(dev) -> tuple[float, int]:
    """``flash_attention`` against its plain version on the card at
    ``FLASH_CASES``, causal and not, f32 and bf16, the plain version at each
    of ``flash_plain_blocks(S)``, within ``decode_close`` with rtol 1e-5 (the
    tiles sum in another order than the plain version's blocks); a causal
    row 0 must equal row 0 of v in its KV head exactly (it attends key 0
    alone)."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    g = torch.Generator(device=dev).manual_seed(14)
    err, cases = 0.0, 0
    for B, S, H, Hkv, dh in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(dev, g, B, S, H, Hkv, dh, dtype)
            for causal in (True, False):
                got = flash_attention_cuda(q, k, v, causal=causal)
                for bq, bk in flash_plain_blocks(S):
                    want = flash_attention_plain(q, k, v, causal=causal, bq=bq, bk=bk)
                    err = max(err, decode_close(
                        got, want, f"flash_attention {(B, S, H, Hkv, dh)} "
                        f"{dtype} causal={causal} plain at ({bq}, {bk})", rtol=1e-5))
                if causal:
                    heads = torch.arange(H, device=dev) // (H // Hkv)
                    if not torch.equal(got[:, 0], v[:, 0, heads]):
                        raise AssertionError(f"flash_attention {(B, S, H, Hkv, dh)} "
                                             f"{dtype}: causal row 0 != v row 0")
                cases += 1
    torch.cuda.synchronize()
    return err, cases


# ------------------------------------------------------------------ phase 13
#: launches of one long (S > 2048) forward of a 32-layer W8A8/W4A4 model:
#: 7 quantized linears a layer, half the layers int8 and half int4, each on
#: wgmma behind an act_quant launch, and one flash attention a layer
#: (``long_forward`` checks it against ``gemm_launches``)
PER_LONG_FORWARD = {"act_quant": 224, "int8_matmul": 112, "int4_matmul": 112,
                    "int4_matmul_fused": 0, "decode_attention": 0,
                    "decode_attention_paged": 0, "flash_attention": 32}
PREFILL_KERNELS = ("act_quant", "int8_matmul", "int4_matmul", "flash_attention")
#: the int kernels a long forward runs, spied by their ``ops`` names
GEMM_KERNELS = ("act_quant", "int8_matmul", "int4_matmul")
PREFILL_LENGTHS = (8192, 32768)
FLASH_TIMED_LENGTHS = (4096, 8192, 32768)
PATCH_START = 32                 # llava: a text prefix, 2 x 576 patch rows, text


def llava_model(dev) -> tuple:
    """llava-next-mistral-7b at full width and depth: fp params from a
    seeded generator on the card, deployed with 4 calibration batches of (4,
    32) tokens under the serve CLI's policy (W8A8 layers 0-15, W4A4 16-31),
    bf16 activations; the fp params are freed, nothing is saved."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.deploy import ExecutionPlan, deploy
    from repro_torch.models import api

    cfg = get_config("llava-next-mistral-7b")
    n = cfg.num_layers
    policy = QuantPolicy(num_layers=n, mode="int", last_k_int4=n // 2)
    plan = ExecutionPlan.build(cfg, policy, backend="cuda", mode="decode")
    t0 = time.perf_counter()
    fp = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    fp_params = sum(int(t.numel()) for t in _leaves(fp))
    rng = np.random.default_rng(0)
    calib = [{"tokens": rng.integers(1, cfg.vocab_size, (4, 32)).astype(np.int32)}
             for _ in range(4)]
    model = deploy(fp, plan, calib, device=dev)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    del fp
    torch.cuda.empty_cache()
    return model, {"fp_params": fp_params, "deploy_s": deploy_s,
                   "policy": policy.describe(), "plan": plan.describe()}


def prefill_inputs(cfg, S: int, dev) -> dict:
    """One forward of B = 1 and ``S`` tokens from a seed; for the vlm also
    (1, 1152, d) bf16 patch embeddings at positions 32-1183."""
    toks = torch.as_tensor(np.random.default_rng(S).integers(
        1, cfg.vocab_size, (1, S)), device=dev)
    if cfg.family != "vlm":
        return {"tokens": toks}
    g = torch.Generator(device=dev).manual_seed(S)
    pe = (torch.randn((1, cfg.num_patches, cfg.d_model), generator=g, device=dev)
          * 0.02).to(torch.bfloat16)
    mask = torch.zeros((1, S), dtype=torch.bool, device=dev)
    mask[:, PATCH_START:PATCH_START + cfg.num_patches] = True
    return {"tokens": toks, "patch_embeds": pe, "patch_mask": mask}


class GemmSpies:
    """Patch ``ops.<kernel>_cuda`` for the integer kernels (``GEMM_NAMES``):
    the first call
    of each (kernel, operand shapes and dtypes, keyword arguments) keeps
    clones of its inputs and output, to be held against the plain version
    (``check_kept_calls``)."""

    def __init__(self):
        self.kept: dict = {}

    def __enter__(self):
        from repro_torch.kernels import ops
        self.orig = {name: getattr(ops, f"{name}_cuda") for name in GEMM_NAMES}
        for name, fn in self.orig.items():
            setattr(ops, f"{name}_cuda", self._spy(name, fn))
        return self

    def _spy(self, name, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            key = (name, *((tuple(t.shape), t.dtype) if torch.is_tensor(t) else t
                           for t in a), *sorted(kw.items()))
            if key not in self.kept:
                self.kept[key] = (name, [t.clone() if torch.is_tensor(t) else t for t in a],
                                  dict(kw), out.clone())
            return out
        return call

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for name, fn in self.orig.items():
            setattr(ops, f"{name}_cuda", fn)


def check_kept_calls(kept: dict, tag: str) -> list:
    """Each kept call bit-equal to its plain version on the same inputs (a
    GEMM that quantized its own float activations against act_quant's plain
    version followed by the plain GEMM); returns [kernel, x shape and dtype,
    weight shape, path] of each."""
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels.gemm_plan import gemm_plan
    plain = {"int8_matmul": i8.int8_matmul_plain, "int4_matmul": i4.int4_matmul_plain,
             "int4_matmul_fused": i4.int4_matmul_fused_plain}
    checked = []
    for name, args, kw, out in kept.values():
        kw = dict(kw)
        a_bits = kw.pop("a_bits", 8)
        kw.pop("pitch", None)
        x = args[0]
        if name == "act_quant":
            want = aq.act_quant_plain(*args)
            shape = [name, list(x.shape), str(x.dtype), args[2]]
        else:
            codes = x if x.dtype == torch.int8 else aq.act_quant_plain(x, args[2], a_bits)
            want = plain[name](codes, *args[1:], **kw)
            M, K = x.shape
            N = args[1].shape[1]
            bits = 8 if name == "int8_matmul" else 4
            shape = [name, [M, K], str(x.dtype), [K, N], gemm_plan(M, N, K, bits).name]
        if not torch.equal(out, want):
            diff = (out.double() - want.double()).abs().max().item()
            raise AssertionError(f"{tag}: {shape}: kernel != plain (max |diff| {diff})")
        checked.append(shape)
    return checked


def long_forward(model, inputs: dict, *, flash_layers: int = 0,
                 gemms: bool = False, expected=None) -> dict:
    """One cacheless forward under the model's kernel plan with every count
    at 0 just before it. Spies: ``full_attention`` must never be called;
    each ``ops.flash_attention`` call is timed between CUDA events and the
    first ``flash_layers`` keep their q, k, v and output; with ``gemms``,
    the first act_quant, int8_matmul and int4_matmul kernel call of each
    shape keeps clones of its inputs and output. Returns the logits, the
    launches, the plain versions on CUDA tensors, eager ms, the flash
    kernels' device ms, the device memory allocated just before it (after
    a garbage collection) and the peak (the kept tensors included).
    ``expected``: the launches the forward must make (default
    ``PER_LONG_FORWARD``, checked against the dense plan's linears)."""
    from repro_torch.kernels import build, ops
    from repro_torch.models import api, attention

    calls = {"full_attention": 0}
    events, taken = [], []
    orig_full, orig_flash = attention.full_attention, ops.flash_attention
    spies = GemmSpies()

    def full(*a, **kw):
        calls["full_attention"] += 1
        return orig_full(*a, **kw)

    def flash(q, k, v, *, causal):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig_flash(q, k, v, causal=causal)
        e1.record()
        events.append((e0, e1))
        if len(taken) < flash_layers:
            taken.append((q, k, v, out, causal))
        return out

    attention.full_attention, ops.flash_attention = full, flash
    if gemms:
        spies.__enter__()
    try:
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        build.reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = api.forward(model.params, model.plan, **inputs)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        launches, plain = dict(build.LAUNCHES), dict(build.PLAIN_ON_CUDA)
    finally:
        attention.full_attention, ops.flash_attention = orig_full, orig_flash
        if gemms:
            spies.__exit__(None, None, None)
    S = int(inputs["tokens"].shape[1])
    tag = f"{model.plan.cfg.name} S={S}"
    if expected is None:
        expected = PER_LONG_FORWARD
        planned = gemm_launches(decoder_linears(model.plan.cfg), S)
        if {k: PER_LONG_FORWARD[k] for k in planned} != planned:
            raise AssertionError(f"{tag}: PER_LONG_FORWARD {PER_LONG_FORWARD} != the "
                                 f"plan's {planned}")
    if launches != expected:
        raise AssertionError(f"{tag}: launched {launches}, expected {expected}")
    if any(plain.values()):
        raise AssertionError(f"{tag}: plain versions ran on CUDA tensors: {plain}")
    if calls["full_attention"]:
        raise AssertionError(f"{tag}: full_attention ran {calls['full_attention']} times")
    V = model.plan.cfg.padded_vocab
    if tuple(logits.shape) != (1, S, V) or not bool(torch.isfinite(
            logits[..., :model.plan.cfg.vocab_size]).all()):
        raise AssertionError(f"{tag}: logits {tuple(logits.shape)} not finite "
                             f"(1, {S}, {V})")
    flash_ms = sum(e0.elapsed_time(e1) for e0, e1 in events)
    return {"logits": logits, "taken": taken, "kept": spies.kept, "S": S,
            "launches": launches, "plain_on_cuda": plain,
            "full_attention_calls": calls["full_attention"],
            "eager_ms": eager_ms, "tokens_per_s": S / (eager_ms / 1e3),
            "flash_attention_ms": flash_ms, "flash_attention_share": flash_ms / eager_ms,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "resident_bytes_before": resident}


def compare_logits(kern: torch.Tensor, ref: torch.Tensor, vocab: int) -> dict:
    """Two forwards' logits over every position: the largest |logit
    difference| and the share of equal argmaxes."""
    n = kern.shape[1]
    max_diff, equal = 0.0, 0
    for s0 in range(0, n, 1024):
        kf = kern[0, s0:s0 + 1024, :vocab].float()
        rf = ref[0, s0:s0 + 1024, :vocab].float()
        max_diff = max(max_diff, (kf - rf).abs().max().item())
        equal += int((kf.argmax(-1) == rf.argmax(-1)).sum())
    return {"logits_max_diff": max_diff, "argmax_equal_share": equal / n,
            "positions": n}


def check_layers(taken, tag: str) -> float:
    """Each recorded layer's kernel output against the plain version on the
    same q, k and v on the card, at the chunk's blocks, within phase 12's
    tolerances."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    err = 0.0
    for i, (q, k, v, out, causal) in enumerate(taken):
        want = flash_attention_plain(q, k, v, causal=causal, bq=1024, bk=1024)
        err = max(err, decode_close(out, want, f"{tag}: flash_attention layer {i}",
                                    rtol=1e-5))
    return err


def check_gemms(kept: dict, tag: str) -> dict:
    """Each kept int-kernel call of a long forward bit-equal to its plain
    version (``check_kept_calls``), every GEMM on act_quant's codes (none of
    these rows quantizes inside the GEMM); returns the shapes checked per
    kernel."""
    shapes = {name: [] for name in GEMM_KERNELS}
    for name, x_shape, x_dtype, *rest in check_kept_calls(kept, tag):
        if name != "act_quant" and x_dtype != "torch.int8":
            raise AssertionError(f"{tag}: {name} quantized inside the GEMM at {x_shape}")
        shapes.setdefault(name, []).append([x_shape, *rest])
    missing = [name for name, s in shapes.items() if not s]
    if missing:
        raise AssertionError(f"{tag}: no call of {missing} was checked")
    return shapes


def long_prefill(models: dict, dev) -> dict:
    """Phase 13 at S = 8192 for each model: the kernel plan's forward
    (launches, no full attention, no plain version on the card), each
    layer's flash attention and each int-kernel shape against the plain
    version, and the whole forward against the same artifact under the
    reference plan on the card, held against two reference runs that differ
    only in the chunk."""
    from repro_torch.deploy import ExecutionPlan
    from repro_torch.models import api

    out = {}
    for name, model in models.items():
        cfg = model.plan.cfg
        S = PREFILL_LENGTHS[0]
        inputs = prefill_inputs(cfg, S, dev)
        t0 = time.perf_counter()
        run = long_forward(model, inputs, flash_layers=cfg.num_layers, gemms=True)
        tag = f"{name} S={S}"
        layer_err = check_layers(run.pop("taken"), tag)
        gemm_shapes = check_gemms(run.pop("kept"), tag)
        ref_plan = ExecutionPlan.build(cfg, model.plan.policy, backend="reference",
                                       mode="decode")
        ref512_plan = ExecutionPlan.build(cfg.replace(attn_chunk=512),
                                          model.plan.policy, backend="reference",
                                          mode="decode")
        with torch.no_grad():
            ref, _ = api.forward(model.params, ref_plan, **inputs)
            ref512, _ = api.forward(model.params, ref512_plan, **inputs)
        cmp = compare_logits(run.pop("logits"), ref, cfg.vocab_size)
        blocks = compare_logits(ref512, ref, cfg.vocab_size)
        del ref, ref512
        torch.cuda.empty_cache()
        limit = {"logits_max_diff": 2 * blocks["logits_max_diff"],
                 "argmax_equal_share": blocks["argmax_equal_share"] / 2}
        if (cmp["logits_max_diff"] > limit["logits_max_diff"]
                or cmp["argmax_equal_share"] < limit["argmax_equal_share"]):
            raise AssertionError(
                f"{tag}: kernel vs reference plan {cmp} outside {limit} (twice the "
                f"difference, half the share of chunk 512 vs 1024: {blocks})")
        out[name] = {**run, "layers_max_abs_err_vs_plain": layer_err,
                     "gemm_shapes_bit_equal": gemm_shapes,
                     "vs_reference_plan": cmp,
                     "reference_chunk512_vs_reference": blocks,
                     "vs_reference_plan_limit": limit,
                     "seconds": time.perf_counter() - t0}
    return out


# ------------------------------------------------------------------ phase 14
def time_flash_kernel(dev) -> list[dict]:
    """``flash_attention`` alone at stablelm-3b's and llava's heads, causal,
    bf16, S in ``FLASH_TIMED_LENGTHS``: held against the plain version at
    the chunk's blocks within phase 12's tolerances, then device ms (CUDA
    events, median after warm-up) beside the plain version's, SDPA on the
    same bf16 tensors (timed only; ``vs_library`` is the kernel's time over
    SDPA's) and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(15)
    rows = []
    for S in FLASH_TIMED_LENGTHS:
        for arch, H, Hkv, dh in (("stablelm-3b", 32, 32, 80),
                                 ("llava-next-mistral-7b", 32, 8, 128)):
            q, k, v = flash_inputs(dev, g, 1, S, H, Hkv, dh, torch.bfloat16)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            if S > 4096:      # a call takes 0.1-0.3 s: timed as issued
                timer = lambda fn: cuda_ms(fn, samples=3, reps=1, warmup=1, graph=False)
                eager = timer
            else:
                timer = lambda fn: cuda_ms(fn, samples=10, reps=3)
                eager = lambda fn: cuda_ms(fn, samples=10, reps=3, graph=False)
            kern = lambda: fa.flash_attention_cuda(q, k, v, causal=True)
            plain = lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                                     bq=1024, bk=1024)
            err = decode_close(kern(), plain(), f"flash_attention {(1, S, H, Hkv, dh)} "
                               "bf16 causal", rtol=1e-5)
            b_ms, b_by = bound(fa.bound_bytes(1, S, H, Hkv, dh, 2),
                               fa.bound_flops(1, S, H, dh, True), BF16_OPS_PER_S)
            rows.append({
                "kernel": "flash_attention", "model": arch, "M": S,
                "shape": [1, S, H, Hkv, dh], "kv_bits": None,
                "calls": 32 if (S == PREFILL_LENGTHS[-1] and arch == "stablelm-3b") else 0,
                "per": "cacheless forward of stablelm-3b at S = 32768, B = 1 "
                       "(32 layers, bf16, causal)",
                "ms": timer(kern), "eager_ms": eager(kern),
                "max_abs_err": err, "plain_ms": timer(plain),
                "library_ms": timer(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)),
                "library_note": "scaled_dot_product_attention(is_causal=True, "
                                "enable_gqa=True) on the same bf16 tensors",
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_ms_f32_rate": fa.bound_flops(1, S, H, dh, True) / FP32_OPS_PER_S * 1e3})
            rows[-1]["vs_library"] = rows[-1]["ms"] / rows[-1]["library_ms"]
            del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


#: (K, N) of the integer GEMMs of the two long forwards: stablelm-3b's
#: attention, up/gate and down projections, llava-next-mistral-7b's q/o,
#: k/v, up/gate and down
LONG_GEMMS = {"stablelm-3b": ((2560, 2560), (2560, 6912), (6912, 2560)),
              "llava-next-mistral-7b": ((4096, 4096), (4096, 1024), (4096, 14336),
                                        (14336, 4096))}
LONG_GEMM_M = (8192, 32768)


def time_long_gemms(dev) -> list[dict]:
    """int8_matmul and int4_matmul (bf16 out, as the long forwards call them)
    at M in ``LONG_GEMM_M`` for each (K, N) of ``LONG_GEMMS``, timed only,
    beside torch._int_mm on the same int8 operands, weight row-major and
    column-major (the int8 yardstick for both: there is no int4 library
    call) and the op bound at 1979 TOPS. Device time: one call captured in
    a CUDA graph, median of 3 replays after one; the kernels also as
    issued (``eager_ms``, with the host's launch work)."""
    from repro_torch.core.packing import pack_int4
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels.gemm_plan import gemm_plan

    g = torch.Generator(device=dev).manual_seed(16)
    bf = torch.bfloat16
    # device time (one call a CUDA graph, replayed), and the time as issued
    timer = lambda fn: cuda_ms(fn, samples=3, reps=1, warmup=1)
    eager = lambda fn: cuda_ms(fn, samples=3, reps=1, warmup=1, graph=False)
    rows = []
    for arch, shapes in LONG_GEMMS.items():
        for K, N in shapes:
            w8 = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
            wp = pack_int4(torch.randint(-7, 9, (K, N), generator=g, device=dev,
                                         dtype=torch.int8))
            s_w = torch.rand((1, N), generator=g, device=dev) * 0.01 + 1e-3
            s_a = torch.tensor(0.02, device=dev)
            for M in LONG_GEMM_M:
                x8 = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                                   dtype=torch.int8)
                ops = 2 * M * K * N
                libs = int_mm_yardsticks(x8, w8, timer)
                lib = libs["library_ms"]
                for kernel, fn, wbytes in (
                        ("int8_matmul", lambda: i8.int8_matmul_cuda(
                            x8, w8, s_a, s_w, out_dtype=bf), K * N),
                        ("int4_matmul", lambda: i4.int4_matmul_cuda(
                            x8, wp, s_a, s_w, out_dtype=bf), K // 2 * N)):
                    b_ms, b_by = bound(M * K + wbytes + 4 + 4 * N + 2 * M * N, ops,
                                       INT8_OPS_PER_S)
                    ms = timer(fn)
                    rows.append({"kernel": kernel, "model": arch, "M": M, "shape": [K, N],
                                 "eager_ms": eager(fn),
                                 "path": gemm_plan(M, N, K, 8 if kernel == "int8_matmul"
                                                   else 4).name,
                                 "ms": ms, **libs,
                                 "library_note": "torch._int_mm on the same int8 operands "
                                                 "(int32 out, no epilogue), the faster of "
                                                 "the weight row-major and column-major; "
                                                 "the int8 yardstick for both kernels",
                                 "vs_library": ms / lib, "tops": ops / ms / 1e9,
                                 "bound_ms": b_ms, "bound_by": b_by})
                del x8
            del w8, wp
            torch.cuda.empty_cache()
    return rows


def time_long_act_quant(dev) -> list[dict]:
    """act_quant alone on bf16 activations at the long forwards' rows (M in
    ``LONG_GEMM_M``) and K of their GEMMs (stablelm-3b's 2560 and 6912,
    llava's 4096 and 14336), where it stays a kernel of its own in front of
    the wgmma GEMMs: device time (one call a CUDA graph, median of 3
    replays), as issued, the plain version's, and the byte bound (2 bytes
    read and 1 written an element). ``calls`` counts the calls of one
    stablelm-3b forward at S = 32768 (from ``gemm_launches``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import act_quant as aq

    g = torch.Generator(device=dev).manual_seed(18)
    timer = lambda fn: cuda_ms(fn, samples=3, reps=1, warmup=1)
    calls = {}
    for (K, N, bits, _), n in decoder_linears(get_config("stablelm-3b")).items():
        calls[K] = calls.get(K, 0) + n
    rows = []
    for arch, ks in (("stablelm-3b", (2560, 6912)), ("llava-next-mistral-7b", (4096, 14336))):
        for K in ks:
            for M in LONG_GEMM_M:
                x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
                s = (x.float().abs().amax() / 127).reshape(())
                fn = lambda: aq.act_quant_cuda(x, s, 8)
                b_ms, b_by = bound(3 * M * K + 4, 4 * M * K, FP32_OPS_PER_S)
                ms = timer(fn)
                rows.append({"kernel": "act_quant", "model": arch, "M": M, "shape": [K, 8],
                             "calls": calls[K] if (arch == "stablelm-3b"
                                                   and M == PREFILL_LENGTHS[-1]) else 0,
                             "per": "cacheless forward of stablelm-3b at S = 32768, B = 1",
                             "kv_bits": None, "ms": ms, "eager_ms": cuda_ms(
                                 fn, samples=3, reps=1, warmup=1, graph=False),
                             "plain_ms": timer(lambda: aq.act_quant_plain(x, s, 8)),
                             "library_ms": None,
                             "library_note": "no single PyTorch call quantizes",
                             "bound_ms": b_ms, "bound_by": b_by,
                             "share_of_bound": b_ms / ms,
                             "bytes_per_s": 3 * M * K / (ms / 1e3)})
                del x
            torch.cuda.empty_cache()
    return rows


def time_long_forwards(models: dict, dev) -> dict:
    """One forward of each model at S = 32768, B = 1 (the JAX system's
    prefill_32k length), with phase 13's launch checks: eager ms, the flash
    kernels' device ms, tokens/s and peak memory. Then a second forward
    that keeps the first layer's flash attention and the first int-kernel
    call of each shape, each held against its plain version."""
    out = {}
    for name, model in models.items():
        inputs = prefill_inputs(model.plan.cfg, PREFILL_LENGTHS[-1], dev)
        run = long_forward(model, inputs)
        del run["logits"], run["taken"], run["kept"]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        checked = long_forward(model, inputs, flash_layers=1, gemms=True)
        del checked["logits"]
        tag = f"{name} S={PREFILL_LENGTHS[-1]}"
        run["layer0_max_abs_err_vs_plain"] = check_layers(checked["taken"], tag)
        run["gemm_shapes_bit_equal"] = check_gemms(checked["kept"], tag)
        run["check_seconds"] = time.perf_counter() - t0
        del checked
        torch.cuda.empty_cache()
        out[name] = run
    return out


# ----------------------------------------------------------------- phase 15
#: Table 2's float rows against the same layer on the CPU
TABLE2_TOL = {"float32": 1e-4, "float32_tf32": 2e-2}


def table2_linears(cfg, bits: int, fused: bool) -> dict:
    """(K, N, bits, fused) -> calls of one Table 2 layer call."""
    from repro_torch.benchmarks.table2_speedup import linears
    out: dict = {}
    for i, (K, N) in enumerate(linears(cfg)):
        key = (K, N, bits, fused and i == 4)       # FFN-up takes the fused epilogue
        out[key] = out.get(key, 0) + 1
    return out


def table2_phase(dev) -> dict:
    """The paper's Table 2 on the card (``benchmarks/table2_speedup.py``):
    one eager call of every grid point x row checked first (the launches
    the shape plan names and no plain version on a CUDA tensor; the first
    call of each integer kernel at each (M, K, N, path) bit-equal to its
    plain version; each integer row within 1e-5 of the same layer on the
    plain integer path on the card (the reference backend); the float32 row
    within 1e-4 of the same layer on the CPU, the TF32 row within 2e-2),
    then the runner's timed rows, and each integer kernel alone at each
    bert-base shape beside ``torch._int_mm`` on the same codes."""
    from repro_torch.benchmarks import table2_speedup as t2
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import build
    from repro_torch.models.transformer import block_apply

    cfg = t2.layer_config()
    g = torch.Generator(device=dev).manual_seed(0)
    params = {bits: t2.layer_params(cfg, bits, g, dev) for bits in (0, 8, 4)}
    cpu_fp = tree_map(lambda a: a.cpu(), params[0])
    layers, launches = [], dict.fromkeys(GEMM_NAMES, 0)
    spies = GemmSpies()
    for batch, seq in t2.GRID:
        M = batch * seq
        x = torch.randn((batch, seq, cfg.d_model), generator=g, device=dev)
        with torch.no_grad():
            ref_cpu = block_apply(x.cpu(), cpu_fp, cfg, t2.layer_spec("none", 0, False))[0]
        for name, mode, bits, fuse, tf32 in t2.ROWS:
            spec = t2.layer_spec(mode, bits, fuse)
            build.reset_counts()
            with t2.tf32_matmuls(tf32), spies, torch.no_grad():
                out = block_apply(x, params[bits], cfg, spec)[0]
            torch.cuda.synchronize()
            got, plain = dict(build.LAUNCHES), dict(build.PLAIN_ON_CUDA)
            want = (gemm_launches(table2_linears(cfg, bits, fuse), M) if bits
                    else dict.fromkeys(GEMM_NAMES, 0))
            if {k: got[k] for k in GEMM_NAMES} != want or any(plain.values()):
                raise AssertionError(f"table2 {batch}x{seq} {name}: launched {got}, "
                                     f"expected {want}; plain on CUDA {plain}")
            for k in GEMM_NAMES:
                launches[k] += got[k]
            if bits:
                with torch.no_grad():
                    ref = block_apply(x, params[bits], cfg,
                                      dataclasses.replace(spec, use_kernels=False))[0]
                err, tol, against = (out - ref).abs().max().item(), 1e-5, "reference backend"
            else:
                err = (out.cpu() - ref_cpu).abs().max().item()
                tol, against = TABLE2_TOL[name], "cpu"
            if not (err <= tol and bool(torch.isfinite(out).all())):
                raise AssertionError(f"table2 {batch}x{seq} {name}: max |diff| {err} "
                                     f"against the {against} > {tol}")
            layers.append({"batch": batch, "tokens": seq, "row": name,
                           "max_abs_err": err, "against": against, "tol": tol,
                           "launches": {k: v for k, v in got.items() if v}})
    calls = check_kept_calls(spies.kept, "table2")
    timed = t2.run(device=dev)
    return {"layers_checked": layers, "gemm_calls_bit_equal": calls,
            "launches": {**dict.fromkeys(build.LAUNCHES, 0), **launches},
            "rows": timed["rows"], "ratios": timed["ratios"], "paper": timed["paper"],
            "gemm_times": time_table2_gemms(spies.kept)}


def time_table2_gemms(kept: dict) -> list:
    """Each kept integer-kernel call timed alone (device time of one call
    in a CUDA graph, and eager), beside ``torch._int_mm`` on the same int8
    codes (weights unpacked for int4; codes zero-padded to 32 rows where
    the library refuses fewer) and the call's bound: its operands read and
    its output written once, 2MKN operations at the int8 peak (act_quant:
    4 operations an element at the fp32 peak)."""
    import torch.nn.functional as F

    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import ops
    from repro_torch.kernels.gemm_plan import gemm_plan
    from repro_torch.kernels.kv_pack import unpack_nibbles_rows

    rows = []
    for name, args, kw, out in kept.values():
        fn = getattr(ops, f"{name}_cuda")
        call = lambda fn=fn, args=args, kw=kw: fn(*args, **kw)
        x = args[0]
        M, K = x.shape
        row = {"kernel": name, "M": M, "K": K, "x_dtype": str(x.dtype),
               "ms": cuda_ms(call), "eager_ms": cuda_ms(call, graph=False)}
        if name == "act_quant":
            row["bound_ms"], row["bound_by"] = bound(M * K * x.element_size() + M * K,
                                                     4 * M * K, FP32_OPS_PER_S)
            row["library_ms"] = None
        else:
            w = args[1]
            bits = 8 if name == "int8_matmul" else 4
            N = w.shape[1]
            w8 = w if bits == 8 else unpack_nibbles_rows(w)
            codes = x if x.dtype == torch.int8 else aq.act_quant_plain(
                x, args[2], kw.get("a_bits", 8))
            nbytes = (M * K * x.element_size() + w.numel() + 4 + 4 * N
                      + (4 * N if name == "int4_matmul_fused" else 0)
                      + M * N * out.element_size())
            row["N"] = N
            row["path"] = gemm_plan(M, N, K, bits).name
            row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * M * K * N, INT8_OPS_PER_S)
            row.update(int_mm_yardsticks(F.pad(codes, (0, 0, 0, max(0, 32 - M))), w8))
            row["library_note"] = ("torch._int_mm on the same int8 codes (int32 out, "
                                   "no epilogue; zero-padded to 32 rows where fewer), "
                                   "the faster weight layout")
        rows.append(row)
    return rows


# ----------------------------------------------------------------- phase 16
CLI_BURST = ["--requests", "16", "--slots", "8", "--max-len", "128"]
#: decoder score prompts: four of bucket 128 submitted together (one
#: batched forward), then one alone every few decode steps
SCORE_BATCHED = (100, 112, 120, 128)
SCORE_LATER = (8, 33, 300, 512)
SCORE_TOL = 1e-4       # relative, against the plain integer path on the card


def serve_cli(dev) -> dict:
    """The serve CLI in-process (``repro_torch.launch.serve.main``) on its
    default arch and policy, stablelm-3b with W8A8 layers 0-15 and W4A4
    16-31: kv8 dense deployed in-process and exported, the artifact served
    (streams byte-equal), kv8 paged deployed in-process (streams byte-equal
    to dense); then ``--mode encoder`` on tinybert4, exported and served
    back (results equal). Each run's launches are counted from 0."""
    import shutil

    from repro_torch.kernels import build
    from repro_torch.launch import serve

    art = ROOT / "build" / "chip_smoke_cli_artifact"
    enc_art = ROOT / "build" / "chip_smoke_cli_encoder"
    runs = {"decode_kv8": ["--kv-bits", "8", "--export", str(art)],
            "decode_kv8_artifact": ["--artifact", str(art)],
            "paged_kv8": ["--kv-bits", "8", "--kv-paging", "paged"],
            "encoder": ["--mode", "encoder", "--export", str(enc_art)],
            "encoder_artifact": ["--mode", "encoder", "--artifact", str(enc_art)]}
    out = {}
    for name, argv in runs.items():
        gc.collect()
        torch.cuda.empty_cache()
        build.reset_counts()
        t0 = time.perf_counter()
        res = serve.main([*argv, *CLI_BURST])
        torch.cuda.synchronize()
        res["seconds"] = time.perf_counter() - t0
        res["launches"], plain = dict(build.LAUNCHES), dict(build.PLAIN_ON_CUDA)
        if any(plain.values()):
            raise AssertionError(f"serve CLI {name}: plain versions on CUDA {plain}")
        out[name] = res
    shutil.rmtree(art, ignore_errors=True)
    for a, b in (("decode_kv8", "decode_kv8_artifact"), ("decode_kv8", "paged_kv8")):
        if out[a]["streams"] != out[b]["streams"]:
            raise AssertionError(f"serve CLI: {b} streams differ from {a}")
    if out["encoder"]["results"] != out["encoder_artifact"]["results"]:
        raise AssertionError("serve CLI: encoder artifact results differ")
    for name, res in out.items():
        done = set(res["finish_reasons"])
        if len(res["finish_reasons"]) != 16 or not done <= {"length", "stop", "done"}:
            raise AssertionError(f"serve CLI {name}: finished {res['finish_reasons']}")
        res.pop("results", None)
    return out


def score_prompts(vocab: int) -> tuple[list, list]:
    rng = np.random.default_rng(21)
    draw = lambda n: rng.integers(1, vocab, n).astype(np.int32)
    return [draw(n) for n in SCORE_BATCHED], [draw(n) for n in SCORE_LATER]


def score_end_to_end(models: dict, dense_streams: dict) -> dict:
    """Decoder ``score`` requests interleaved with phase 6's decode traffic
    through one scheduler, dense and paged (kv8): once no generation
    request waits, four prompts of bucket 128 together (one batched forward
    of n = 4) and four more one at a time between decode steps. Every decode stream must be
    byte-identical to phase 6's dense run; every decode step and forward
    must launch what the plan names; each score bit-equal to the same
    prompt scored alone, and within ``SCORE_TOL`` (relative) of the plain
    integer path on the card (the reference backend)."""
    import copy

    from repro_torch.deploy import DeployedModel, ExecutionPlan
    from repro_torch.kernels import build
    from repro_torch.serving import EncodeRequest, ServingEngine

    model = models[8]
    cfg = model.plan.cfg
    batched, later = score_prompts(cfg.vocab_size)
    prompts = batched + later
    linears = decoder_linears(cfg)

    def alone(m):
        eng = ServingEngine(m, slots=DECODE_SLOTS, max_len=DECODE_MAX_LEN)
        vals = []
        for p in prompts:
            vals.append(float(eng.submit_encode(EncodeRequest(tokens=p, task="score"))
                              .result().value))
        return vals

    p = model.plan
    ref_plan = ExecutionPlan.build(cfg, p.policy, backend="reference", mode="decode",
                                   kv_bits=8, prefill_batch=p.prefill_batch)
    solo = alone(model)
    ref = alone(DeployedModel(plan=ref_plan, params=model.params))
    rel = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(solo, ref))
    if rel > SCORE_TOL:
        raise AssertionError(f"scores vs the reference backend: relative {rel} > "
                             f"{SCORE_TOL}")
    out = {"scores_solo": solo, "scores_reference": ref,
           "max_rel_err_vs_reference": rel}
    for paging, per_step in (("dense", PER_DECODE_STEP), ("paged", PAGED_DECODE_STEP)):
        m = model if paging == "dense" else paged_model(model)
        eng = ServingEngine(m, slots=DECODE_SLOTS, max_len=DECODE_MAX_LEN)
        record: dict = {}
        record_forwards(eng, record)
        gc.collect()
        torch.cuda.empty_cache()
        build.reset_counts()
        t0 = time.perf_counter()
        streams = []
        for req in decode_traffic(cfg.vocab_size):
            res = eng.submit(copy.deepcopy(req))
            streams += res if isinstance(res, list) else [res]
        # scores enter only once no generation request waits, so they never
        # move one: the batch when four slots are free, the rest one at a
        # time every 8 steps
        handles, pending, steps = [], list(later), 0
        while eng.scheduler.has_work or pending or not handles:
            if not eng.scheduler.queue_depth:
                free = DECODE_SLOTS - eng.scheduler.num_active
                if not handles and free >= len(batched):
                    handles = [eng.submit_encode(EncodeRequest(tokens=q, task="score"))
                               for q in batched]
                elif handles and pending and steps % 8 == 0:
                    handles.append(eng.submit_encode(EncodeRequest(
                        tokens=pending.pop(0), task="score")))
            eng.engine_step()
            steps += 1
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        planned = check_launches(f"score {paging}", record, per_step, linears)
        got = [list(map(int, s.result().tokens)) for s in streams]
        if got != dense_streams[8]:
            raise AssertionError(f"score {paging}: decode streams changed by the "
                                 "score traffic")
        scores = [float(h.result().value) for h in handles]
        if scores != solo:
            diff = max(abs(a - b) for a, b in zip(scores, solo))
            raise AssertionError(f"score {paging}: batched/interleaved scores != solo "
                                 f"(max |diff| {diff})")
        s = eng.metrics.summary()
        if s["encode_steps"] != 1 + len(later):     # the four in ONE forward
            raise AssertionError(f"score {paging}: {s['encode_steps']} score forwards "
                                 f"for {len(prompts)} scores, expected {1 + len(later)}")
        out[paging] = {"streams_equal_to_phase6": len(got), "scores": scores,
                       "score_forwards": s["encode_steps"],
                       "launches": launches, "act_quant_planned": planned,
                       "serve_s": serve_s, "steps": steps,
                       "encode_p50_ms": s.get("encode_p50_ms"),
                       "decode_p50_ms": s.get("decode_p50_ms")}
    return out


# ----------------------------------------------------------------- phase 17
def load_phase(models: dict, dev) -> dict:
    """Short Poisson workloads through ``serving.run_load`` on the system
    clock: the decoder (phase 6's kv8 stablelm-3b, 8 slots; a quarter of the
    requests decoder scores) and the encoder (phase 3's tinybert4 artifact;
    classify). Tokens/s, TTFT (from when each request was due),
    inter-token p50/p99, SLO goodput and kernel launches per engine step.
    The rates, mixes and SLOs are fixed smoke settings that no source or
    knee sweep backs: these are smoke readings, not the port's end-to-end
    metrics. Then the serve benchmarks' JSON (``benchmarks/serve_latency.py``,
    ``serve_load.py``, ``--quick``) into ``chiprun_out/``: their reduced
    ``bench_config`` checks the schema on the card and seeds no cell."""
    from repro_torch.benchmarks import serve_latency, serve_load
    from repro_torch.deploy import DeployedModel
    from repro_torch.kernels import build
    from repro_torch.serving import (SLO, GenerationRequest, ServingEngine, Workload,
                                     make_arrivals, run_load)

    cells = {
        "decoder": (models[8], DECODE_SLOTS, DECODE_MAX_LEN,
                    Workload(n_requests=24, rate_rps=4.0,
                             vocab=models[8].plan.cfg.vocab_size, prompt_len=(16, 128),
                             new_tokens=(8, 32), encode_frac=0.25, encode_task="score"),
                    SLO(ttft_s=1.0, itl_s=0.25)),
        "encoder": (DeployedModel.load(str(ROOT / "build" / "chip_smoke_artifact"),
                                       device=dev), 8, 128,
                    Workload(n_requests=64, rate_rps=100.0, vocab=30522,
                             prompt_len=(4, 128), encode_frac=1.0,
                             encode_task="classify"),
                    SLO(ttft_s=0.1, itl_s=0.1)),
    }
    out = {}
    for name, (model, slots, max_len, w, slo) in cells.items():
        eng = ServingEngine(model, slots=slots, max_len=max_len)
        if model.plan.mode == "decode":          # first calls allocate
            eng.submit(GenerationRequest(prompt=np.arange(1, 40, dtype=np.int32),
                                         max_new_tokens=4))
            eng.run_until_drained()
            eng.pop_done()
        gc.collect()
        build.reset_counts()
        res = run_load(eng, make_arrivals(w, seed=0))
        torch.cuda.synchronize()
        launches, plain = dict(build.LAUNCHES), dict(build.PLAIN_ON_CUDA)
        if any(plain.values()):
            raise AssertionError(f"load {name}: plain versions on CUDA {plain}")
        s = res.summary(slo)
        if s["n_completed"] != w.n_requests:
            raise AssertionError(f"load {name}: {s['n_completed']} of {w.n_requests} "
                                 "requests completed")
        tokens = sum(len(r.tokens) for r in res.records)
        prompt_tokens = sum(r.prompt_len for r in res.records)
        out[name] = {"workload": dataclasses.asdict(w),
                     "slo": dataclasses.asdict(slo), **s, "tokens": tokens,
                     "tokens_per_s": tokens / s["duration_s"],
                     "prompt_tokens_per_s": prompt_tokens / s["duration_s"],
                     "launches": launches,
                     "launches_per_step": {k: v / res.steps for k, v in launches.items()
                                           if v}}
    bench = ROOT / "chiprun_out"
    bench.mkdir(exist_ok=True)
    out["serve_latency"] = serve_latency.main(quick=True, out=str(bench / "BENCH_serve.json"),
                                              device=dev)
    out["serve_load"] = serve_load.main(quick=True, out=str(bench / "BENCH_load.json"),
                                        device=dev)
    return out


# ----------------------------------------------------------------- phase 18
#: the quantized linears of one forward of the QAT student deployed W4A4 in
#: every layer (tinybert4): (K, N, weight bits, fused) -> calls
QAT_LINEARS = {(312, 312, 4, False): 16, (312, 1200, 4, True): 4,
               (1200, 312, 4, False): 4}
#: the paper's recipe at full tinybert4 width: steps of the bert-base
#: teacher, the fp student and the QAT student (MINI + output KD)
TEACHER_STEPS, STUDENT_STEPS, QAT_STEPS = 8, 8, 30
QAT_TASK = (30522, 64, 32)       # SyntheticClassification(vocab, seq, batch)
#: deployed vs fake-quant logits: phase 3's bound for forwards in which
#: float noise moved an activation code
QAT_LOGIT_ATOL = 5e-2


def qat_end_to_end(dev) -> dict:
    """The paper's recipe at full tinybert4 width on the card: a bert-base fp
    teacher and the fp student trained a few steps, the student calibrated
    (``build_qat_student``) and trained W4A4 (every layer int4, 4-bit
    activations, mse scale gradients, MINI + output KD), deployed with its
    learned scales, saved, loaded and served through the integer kernels."""
    import dataclasses as dc

    from repro_torch.benchmarks import common
    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.quantizer import lsq_quantize, qrange
    from repro_torch.data import SyntheticClassification
    from repro_torch.deploy import DeployedModel, ExecutionPlan, deploy
    from repro_torch.kernels import build
    from repro_torch.kernels.act_quant import act_quant_cuda
    from repro_torch.models.bert import bert_classify_logits, init_bert_classifier
    from repro_torch.models.transformer import _embed
    from repro_torch.serving import EncodeRequest, ServingEngine

    torch.cuda.reset_peak_memory_stats()
    cfg, tcfg = get_config("tinybert4"), get_config("bert-base")
    vocab, seq, batch = QAT_TASK
    data = SyntheticClassification(vocab, seq, batch, num_classes=2, seed=0)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    runs = {}

    def train(name, params, plan, steps, **kw):
        losses, stamps = [], []

        def on_step(i, loss):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            losses.append(loss)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = common.train_classifier(params, plan, data, steps=steps, lr=1e-4,
                                      on_step=on_step, **kw)
        vals = torch.stack(losses).cpu()
        if not bool(torch.isfinite(vals).all()):
            raise AssertionError(f"{name}: non-finite losses {vals.tolist()}")
        ms = [1e3 * (b - a) for a, b in zip([t0] + stamps[:-1], stamps)]
        runs[name] = {"steps": steps, "first_step_eager_ms": ms[0],
                      "step_eager_ms_median": statistics.median(ms[1:]),
                      "loss_first": float(vals[0]), "loss_last": float(vals[-1])}
        return out

    tplan, fplan = common.plan_for(tcfg), common.plan_for(cfg)
    teacher = train("teacher_fp32_bert_base", init_bert_classifier(tcfg, 2, gen(1), dev),
                    tplan, TEACHER_STEPS)
    fp_student = train("student_fp32", init_bert_classifier(cfg, 2, gen(2), dev),
                       fplan, STUDENT_STEPS)
    policy = QuantPolicy(num_layers=cfg.num_layers, mode="fake",
                         last_k_int4=cfg.num_layers, grad_mode="mse")
    qplan = common.plan_for(cfg, policy)
    calibrated = common.build_qat_student(cfg, policy, data, fp_student)
    student = train("qat_w4a4_mse_mini_output_kd", calibrated, qplan, QAT_STEPS,
                    teacher=teacher, teacher_plan=tplan)
    moved = {key: float(torch.mean(torch.abs(student["layers"]["attn"]["wq"][key]
                                             / calibrated["layers"]["attn"]["wq"][key] - 1)))
             for key in ("s_a", "s_w")}
    if not moved["s_a"] > 0:
        raise AssertionError("QAT left the activation scales where calibration put them")

    # the first quantized linear (layer 0's wq reads the embeddings): the
    # fake-quant codes round(clip(x / s_a)) against act_quant's kernel
    qmin, qmax = qrange(4)
    toks = torch.as_tensor(data.batch(9000)["tokens"], device=dev)
    with torch.no_grad():
        x = _embed(student, cfg, toks).reshape(-1, cfg.d_model).contiguous()
        s_a = student["layers"]["attn"]["wq"]["s_a"][0]
        fake = torch.round(torch.clamp(x / s_a, qmin, qmax)).to(torch.int8)
        kern = act_quant_cuda(x, s_a, 4)
        if not torch.equal(fake, kern):
            raise AssertionError(f"first-linear codes: {int((fake != kern).sum())} of "
                                 f"{fake.numel()} differ from act_quant's")
        if not torch.equal(lsq_quantize(x, s_a, 4, "mse"), s_a * kern.to(torch.float32)):
            raise AssertionError("lsq_quantize's output is not s_a x act_quant's codes")

    plan = ExecutionPlan.build(cfg, dc.replace(policy, mode="int"), backend="cuda",
                               mode="encoder", prefill_batch=4)
    model = deploy(student, plan, recalibrate=False, device=dev)
    art = ROOT / "build" / "chip_smoke_qat_artifact"
    model.save(str(art))
    loaded = DeployedModel.load(str(art), device=dev)
    if loaded.plan != plan:
        raise AssertionError("plan did not round-trip through the artifact")
    for block, site in [("attn", w) for w in ("wq", "wk", "wv", "wo")] + [
            ("ffn", "w1"), ("ffn", "w2")]:     # the learned scales, not recalibrated
        for key in ("s_a", "s_w"):
            if not torch.equal(loaded.params["layers"][0][block][site][key],
                               student["layers"][block][site][key]):
                raise AssertionError(f"deploy moved the learned {site}/{key}")

    # Deployed vs fake-quant forward, phase 3's noise rule row by row: the
    # integer GEMM and the fake-quant matmul round differently, and an
    # activation whose x / s lies that close to a rounding boundary gets
    # another code on the two paths, which moves its row's later layers.
    # The first linear of every forward quantizes identically; rows with no
    # changed code agree within rtol = atol = 1e-4, rows with one within
    # QAT_LOGIT_ATOL; argmax agrees on every row. Such noise moves a code in
    # a few rows (one request of 16 in phase 3); a scale that deploy moved
    # changes codes in every row, so at most half the rows may change one.
    n_linear = sum(QAT_LINEARS.values())
    err = {"no_code_changed": 0.0, "codes_changed": 0.0}
    flipped_rows, n_flips, n_codes, rows, margins, mags = 0, 0, 0, 0, [], []
    with torch.no_grad():
        for i in range(4):
            t = torch.as_tensor(data.batch(10_000 + i)["tokens"], device=dev)
            with recording_codes([]) as fake_codes:
                want = bert_classify_logits(student, qplan, t).cpu().numpy()
            with recording_codes([]) as kern_codes:
                got = bert_classify_logits(loaded.params, loaded.plan, t).cpu().numpy()
            if not len(fake_codes) == len(kern_codes) == n_linear:
                raise AssertionError(f"{len(fake_codes)} fake-quant and {len(kern_codes)} "
                                     f"deployed quantized linears, expected {n_linear}")
            B = t.shape[0]
            flips = np.zeros(B, dtype=np.int64)
            for j, (fz, kz) in enumerate(zip(fake_codes, kern_codes)):
                changed = (fz.reshape(B, -1) != kz.reshape(B, -1)).sum(axis=1)
                if j == 0 and changed.any():
                    raise AssertionError(f"batch {i}: first-linear codes differ between "
                                         f"the fake-quant and the deployed forward")
                flips += changed
                n_codes += fz.size
            for r in range(B):
                key = "codes_changed" if flips[r] else "no_code_changed"
                tol = dict(rtol=0.0, atol=QAT_LOGIT_ATOL) if flips[r] else \
                    dict(rtol=1e-4, atol=1e-4)
                np.testing.assert_allclose(got[r], want[r], **tol, err_msg=(
                    f"batch {i} row {r}: deployed vs fake-quant, {flips[r]} codes changed"))
                err[key] = max(err[key], float(np.abs(got[r] - want[r]).max()))
                if np.argmax(got[r]) != np.argmax(want[r]):
                    raise AssertionError(f"batch {i} row {r}: argmax differs from the "
                                         f"fake-quant forward ({got[r]} vs {want[r]})")
            flipped_rows += int((flips > 0).sum())
            n_flips += int(flips.sum())
            rows += B
            mags.append(np.abs(want).ravel())
            margins.append(np.abs(want[:, 0] - want[:, 1]))
    if 2 * flipped_rows > rows:
        raise AssertionError(f"{flipped_rows} of {rows} rows changed activation codes "
                             f"({n_flips} codes) between the fake-quant and the "
                             f"deployed forward")
    logits = {"abs_median": float(np.median(np.concatenate(mags))),
              "abs_max": float(np.concatenate(mags).max()),
              "margin_median": float(np.median(np.concatenate(margins))),
              "margin_min": float(np.concatenate(margins).min())}

    rng = np.random.default_rng(3)
    lengths = [4, 7, 8, 12, 16, 21, 31, 32, 40, 57, 64, 77, 96, 111, 127, 128]
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in lengths]

    def serve(counted=None):
        eng = ServingEngine(loaded, slots=8, max_len=128)
        if counted is not None:
            encode = eng.encode_batch

            def recorded(toks, lens):
                counted.append(int(np.asarray(toks).size))
                return encode(toks, lens)
            eng.encode_batch = recorded
        hs = [eng.submit_encode(EncodeRequest(tokens=p, task="classify")) for p in prompts]
        eng.run_until_drained()
        return eng, [h.result() for h in hs]

    serve()                                        # warm-up
    torch.cuda.synchronize()
    counted = []
    build.reset_counts()
    eng, results = serve(counted)
    torch.cuda.synchronize()
    launches, plain = dict(build.LAUNCHES), dict(build.PLAIN_ON_CUDA)
    del eng.encode_batch
    expected = dict.fromkeys(GEMM_NAMES, 0)
    for M in counted:
        for name, n in gemm_launches(QAT_LINEARS, M).items():
            expected[name] += n
    if {k: launches[k] for k in expected} != expected:
        raise AssertionError(f"{ {k: launches[k] for k in GEMM_NAMES} } launches over "
                             f"forwards of rows {counted}, expected {expected}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors: {plain}")
    for p, r in zip(prompts, results):
        val = np.asarray(r.value)
        if r.finish_reason != "done" or val.shape != (2,) or not np.all(np.isfinite(val)):
            raise AssertionError(f"request {r.rid}: {r.finish_reason} {val!r}")
        direct = eng.encode_batch(p[None], np.array([len(p)]))["classify"][0].cpu().numpy()
        np.testing.assert_allclose(val, direct, rtol=1e-5, atol=1e-6)
    return {"model": cfg.name, "teacher": tcfg.name, "task": list(QAT_TASK),
            "policy": policy.describe(), "plan": plan.describe(), "runs": runs,
            "scale_mean_rel_change_layer0_wq": moved,
            "first_linear_codes_bit_equal": int(fake.numel()),
            "logits_max_abs_diff_vs_fake_quant": err,
            "logits_tolerance": {"no_code_changed": 1e-4, "codes_changed": QAT_LOGIT_ATOL},
            "fake_quant_logits": logits, "rows_compared": rows,
            "rows_with_changed_codes": flipped_rows, "codes_changed": n_flips,
            "codes_compared": n_codes,
            "requests": len(results), "forward_rows": counted, "launches": launches,
            "expected_launches": expected, "plain_on_cuda": plain,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


# ----------------------------------------------------------------- phase 19
#: the train CLI's default at full width: stablelm-3b, 3 steps of 8 x 128
TRAIN_ARGV = ["--steps", "3", "--batch", "8", "--seq", "128"]


def preempted_after(n: int, builder):
    """``builder`` (``launch.train.build_train_step``) whose step sends
    this process SIGTERM after its ``n``-th call, as a preemption would:
    ``run_training`` checkpoints that step and returns."""
    import os
    import signal
    import threading

    if threading.current_thread() is not threading.main_thread():
        raise RuntimeError("run_training handles SIGTERM only on the main thread")

    def build(*a, **kw):
        step, done = builder(*a, **kw), []

        def run(*args):
            out = step(*args)
            done.append(1)
            if len(done) == n:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return run
    return build


def train_cli_phase(dev) -> dict:
    """``launch.train.main`` on its default (stablelm-3b, fake-quant W8A8 +
    W4A4 with mse scale gradients, no teacher) at full width; the reduced
    model's checkpoint/resume; Table 1, its deployed quality bench and
    Table 3 at ``quick`` size, the quality payload read by
    ``tools/check_quality.py``."""
    import shutil

    from repro_torch.benchmarks import table1_glue, table3_ablation
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.tree import tree_leaves_with_path
    from repro_torch.kernels import build
    from repro_torch.launch import train

    work = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 1e9
    steps, builder = [], train.build_train_step

    def timed_builder(*a, **kw):
        step = builder(*a, **kw)

        def run(params, opt, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, opt, batch)
            torch.cuda.synchronize()
            steps.append({"eager_ms": 1e3 * (time.perf_counter() - t0),
                          **{k: float(v) for k, v in out[2].items()}})
            return out
        return run

    train.build_train_step = timed_builder
    try:
        t0 = time.perf_counter()
        state, metrics = train.main(TRAIN_ARGV + ["--ckpt-dir", str(work / "full_width")])
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    finally:
        train.build_train_step = builder
    if len(steps) != 3 or int(state["opt"].step) != 3:
        raise AssertionError(f"{len(steps)} steps ran, opt at {int(state['opt'].step)}")
    if not all(np.isfinite(s["loss/train"]) for s in steps):
        raise AssertionError(f"non-finite losses: {steps}")
    if CheckpointManager(str(work / "full_width")).all_steps():
        raise AssertionError("a checkpoint was written at --ckpt-every 50")
    n_params = sum(t.numel() for _, t in tree_leaves_with_path(state["params"]))
    full = {"argv": TRAIN_ARGV, "params": n_params, "steps": steps,
            "step_eager_ms": [s["eager_ms"] for s in steps], "total_s": total_s,
            "resident_before_gb": resident,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del state
    gc.collect()
    torch.cuda.empty_cache()

    base = ["--reduced", "--steps", "4", "--ckpt-every", "2"]
    straight, _ = train.main(base + ["--ckpt-dir", str(work / "uninterrupted")])
    train.build_train_step = preempted_after(2, builder)
    try:
        part, _ = train.main(base + ["--ckpt-dir", str(work / "resumed")])
    finally:
        train.build_train_step = builder
    resumed, _ = train.main(base + ["--ckpt-dir", str(work / "resumed")])
    a = dict(tree_leaves_with_path(straight["params"]))
    b = dict(tree_leaves_with_path(resumed["params"]))
    unequal = [k for k in a if not torch.equal(a[k], b[k])]
    if int(part["opt"].step) != 2 or unequal:
        raise AssertionError(f"resumed run differs from the uninterrupted one: {unequal}")
    resume = {"leaves_bit_equal": len(a), "checkpoints": CheckpointManager(
        str(work / "resumed")).all_steps()}

    # the fp teacher and student that Table 1 and Table 3 both start from,
    # trained once for the two (each run would train the same pair)
    t0 = time.perf_counter()
    trained = table1_glue.teacher_and_student(table1_glue.QUICK_STEPS, 0, dev)
    table1 = table1_glue.run(quick=True, device=dev, trained=trained)
    table1_s = time.perf_counter() - t0
    build.reset_counts()
    t0 = time.perf_counter()
    payload = table1_glue.run_artifact(quick=True, artifact_dir=str(work / "quality_w4a4"),
                                       device=dev)
    artifact_s = time.perf_counter() - t0
    launches, plain = dict(build.LAUNCHES), dict(build.PLAIN_ON_CUDA)
    if any(plain.values()):
        raise AssertionError(f"quality bench: plain versions on CUDA {plain}")
    t0 = time.perf_counter()
    table3 = table3_ablation.run(quick=True, device=dev, trained=trained)
    table3_s = time.perf_counter() - t0
    out = ROOT / "chiprun_out" / "BENCH_quality.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(payload, indent=2, sort_keys=True))
    # the unchanged quality gate reads the payload (current against itself:
    # the committed baseline is the JAX package's, which torch cannot match),
    # so it gates the paper's claim alone: W4A4 within 5 points of fp
    gate = subprocess.run([sys.executable, str(ROOT / "tools" / "check_quality.py"),
                           "--current", str(out), "--baseline", str(out)],
                          capture_output=True, text=True)
    if gate.returncode != 0 or "W4A4 vs fp delta" not in gate.stdout:
        raise AssertionError(f"check_quality failed (rc {gate.returncode}): "
                             f"{gate.stdout}{gate.stderr}")
    return {"full_width": full, "reduced_resume": resume,
            "table1": [list(r) for r in table1], "table1_s": table1_s,
            "quality": payload, "quality_s": artifact_s,
            "quality_launches": launches, "check_quality_rc": gate.returncode,
            "check_quality": gate.stdout.strip().splitlines(),
            "table3": [list(r) for r in table3], "table3_s": table3_s}


# ----------------------------------------------------------------- phase 20
#: the CLI burst of phase 20: the serve CLI's synthetic prompts (4-11
#: tokens, 8 new each)
FLEET_CLI_BURST = ["--requests", "16", "--slots", "8", "--max-len", "128"]
#: the multi-tenant run: a classify flood of this many requests (4-128
#: tokens) beside phase 6's generation requests of these indices
TENANT_FLOOD = 48
TENANT_GEN = (0, 5, 11, 7)             # 16, 16, 16 and 24 new tokens
#: the replica sets serve phase 6's requests of these indices: those of at
#: most 32 new tokens and the sampled one (index 16, n = 2, its two
#: samples phase 6's streams 16 and 17)
FLEET_REQUESTS = (0, 2, 5, 7, 9, 11, 13, 16)
KV_SLACK = 64 << 20   # bytes of device memory a member may add past its KV


def serve_fleet(rs, record: dict):
    """Phase 6's requests ``FLEET_REQUESTS`` through the ReplicaSet ``rs``
    (each member's forwards recorded into ``record``, as
    ``record_forwards`` does for one engine); the results in submission
    order, the n = 2 samples last."""
    import copy
    records = []
    for e in rs.engines:
        records.append({})
        record_forwards(e, records[-1])
    streams = []
    traffic = decode_traffic(rs.engines[0].cfg.vocab_size)
    for req in (traffic[i] for i in FLEET_REQUESTS):
        out = rs.submit(copy.deepcopy(req))
        streams += out if isinstance(out, list) else [out]
    rs.run_until_drained()
    record.update(prefill=[f for r in records for f in r["prefill"]],
                  decode=[f for r in records for f in r["decode"]],
                  per_member_decode=[len(r["decode"]) for r in records])
    results = [st.result() for st in streams]
    for r in results:
        if r.finish_reason not in ("length", "stop"):
            raise AssertionError(f"replica request {r.rid} finished {r.finish_reason!r}")
    return results


def _bytes(tensors) -> int:
    return sum(int(t.numel()) * t.element_size() for t in tensors)


def fleet_replicas(model, dense_streams: list, single: dict) -> dict:
    """Part (a): ``ReplicaSet(2)`` over phase 6's kv8 model, dense and
    paged, serving phase 6's requests ``FLEET_REQUESTS``: streams
    byte-identical to phase 6's single engine, every member step launching what the plan names, no
    plain version on a CUDA tensor, and the device memory grown by the two
    members' KV (plus ``KV_SLACK`` each), never by a copy of the weights.
    Tokens/s of each set beside phase 6's single engine on all of phase 6's
    requests (this call): smoke readings of the system clock."""
    from repro_torch.kernels import build
    from repro_torch.serving import ReplicaSet

    weights = _bytes(_leaves(model.params))
    want = [dense_streams[i] for i in FLEET_REQUESTS if i < 16] + dense_streams[16:]
    out = {"weight_bytes": weights, "requests": list(FLEET_REQUESTS)}
    for paging, per_step, kernels in (("dense", PER_DECODE_STEP, DECODER_KERNELS),
                                      ("paged", PAGED_DECODE_STEP, PAGED_KERNELS)):
        m = model if paging == "dense" else paged_model(model)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        rs = ReplicaSet(m, replicas=2, slots=DECODE_SLOTS, max_len=DECODE_MAX_LEN)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - before
        kv = [_bytes(e.pool.bufs.values() if e.paged else e.kv.state.values())
              for e in rs.engines]
        if any(e.params is not m.params for e in rs.engines):
            raise AssertionError(f"replicas {paging}: a member holds its own params")
        if grown > sum(kv) + 2 * KV_SLACK or grown >= weights:
            raise AssertionError(f"replicas {paging}: device memory grew {grown} B for "
                                 f"{sum(kv)} B of KV ({weights} B of weights)")
        record = {}
        build.reset_counts()
        t0 = time.perf_counter()
        results = serve_fleet(rs, record)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        planned = check_launches(f"replicas {paging}", record, per_step,
                                 decoder_linears(m.plan.cfg))
        idle = [k for k in kernels if not launches[k] and (k != "act_quant" or planned)]
        if idle:
            raise AssertionError(f"replicas {paging}: kernels never launched: {idle}")
        got = [list(map(int, r.tokens)) for r in results]
        if got != want:
            bad = sum(a != b for a, b in zip(got, want))
            raise AssertionError(f"replicas {paging}: {bad} of {len(got)} streams differ "
                                 "from phase 6's single engine")
        tokens = sum(len(t) for t in got)
        out[paging] = {"streams_equal_to_phase6": len(got), "launches": launches,
                       "act_quant_planned": planned,
                       "plain_on_cuda": dict(build.PLAIN_ON_CUDA),
                       "decode_steps_per_member": record["per_member_decode"],
                       "prefill_forwards": len(record["prefill"]),
                       "memory_grown_bytes": grown, "kv_bytes_per_member": kv,
                       "serve_s": serve_s, "tokens": tokens,
                       "tokens_per_s": tokens / serve_s}
        del rs
    out["phase6_single_engine_tokens_per_s"] = single["tokens"] / single["serve_s"]
    return out


def fleet_tenants(enc, dec) -> dict:
    """Part (b): one ``MultiTenantEngine`` hosting phase 3's tinybert4
    artifact (``cls``) and phase 6's kv8 model (``gen``) on the card. A
    classify flood submitted first, phase 6's generation requests
    ``TENANT_GEN`` after it: every request finishes, each tenant's results are
    byte-equal to the same requests served alone (a tenant's engine sees
    the same admissions either way, since all are submitted before the
    first step), and a quota rejection is raised and then released."""
    import copy

    from repro_torch.kernels import build
    from repro_torch.serving import (EncodeRequest, GenerationRequest,
                                     MultiTenantEngine, QuotaExceededError,
                                     ServingEngine)

    rng = np.random.default_rng(20)
    tasks = ("classify", "embed", "score")
    flood = [EncodeRequest(tokens=rng.integers(1, enc.plan.cfg.vocab_size,
                                               int(rng.integers(4, 129))).astype(np.int32),
                           task=tasks[i % 3]) for i in range(TENANT_FLOOD)]
    traffic = decode_traffic(dec.plan.cfg.vocab_size)
    gen = [traffic[i] for i in TENANT_GEN]
    mt = MultiTenantEngine(quantum_tokens=64)
    mt.add_tenant("cls", enc, slots=8, max_len=128)
    mt.add_tenant("gen", dec, slots=DECODE_SLOTS, max_len=DECODE_MAX_LEN)
    served = []
    for name, t in mt.tenants.items():
        real = t.engine.engine_step
        t.engine.engine_step = (lambda n=name, f=real: (served.append(n), f())[1])
    gc.collect()
    build.reset_counts()
    t0 = time.perf_counter()
    hs = [mt.submit_encode(copy.deepcopy(r), tenant="cls") for r in flood]
    ss = [mt.submit(copy.deepcopy(r), tenant="gen") for r in gen]
    steps = mt.run_until_drained()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches, plain = dict(build.LAUNCHES), dict(build.PLAIN_ON_CUDA)
    if any(plain.values()):
        raise AssertionError(f"tenants: plain versions on CUDA {plain}")
    if any(h.result().finish_reason != "done" for h in hs) or \
            any(s.result().finish_reason not in ("length", "stop") for s in ss):
        raise AssertionError("tenants: a request did not finish")
    enc_alone = ServingEngine(enc, slots=8, max_len=128)
    alone_h = [enc_alone.submit_encode(copy.deepcopy(r)) for r in flood]
    enc_alone.run_until_drained()
    dec_alone = ServingEngine(dec, slots=DECODE_SLOTS, max_len=DECODE_MAX_LEN)
    alone_s = [dec_alone.submit(copy.deepcopy(r)) for r in gen]
    dec_alone.run_until_drained()
    for a, b in zip(hs, alone_h):
        if not np.array_equal(np.asarray(a.result().value), np.asarray(b.result().value)):
            raise AssertionError(f"tenants: cls request {a.rid} differs from serving alone")
    for a, b in zip(ss, alone_s):
        if not np.array_equal(a.result().tokens, b.result().tokens):
            raise AssertionError(f"tenants: gen request {a.rid} differs from serving alone")
    # the quota: a second request past the budget is refused, and fits once
    # the first has finished and released its tokens
    t = mt.tenants["gen"]
    quota_req = lambda: GenerationRequest(prompt=gen[0].prompt.copy(), max_new_tokens=8)
    t.token_budget = 2 * (len(gen[0].prompt) + 8) - 1     # one fits, two do not
    mt.submit(quota_req(), tenant="gen")
    held = t.outstanding_tokens
    try:
        mt.submit(quota_req(), tenant="gen")
        raise AssertionError("tenants: the quota did not refuse a request past it")
    except QuotaExceededError:
        pass
    mt.run_until_drained()
    released = t.outstanding_tokens
    mt.submit(quota_req(), tenant="gen")
    mt.run_until_drained()
    if released or t.outstanding_tokens:
        raise AssertionError(f"tenants: quota not released ({released}, "
                             f"{t.outstanding_tokens})")
    by_label = mt.metrics.summary()["by_label"]
    last_cls = max(i for i, n in enumerate(served[:steps]) if n == "cls")
    return {"engine_steps": steps, "steps_by_tenant": {n: served[:steps].count(n)
                                                        for n in ("cls", "gen")},
            "last_cls_step": last_cls, "serve_s": serve_s, "launches": launches,
            "plain_on_cuda": plain, "cls_equal_alone": len(hs),
            "gen_equal_alone": len(ss), "quota_held_tokens": held,
            "quota_rejected": 1, "quota_released": True,
            "gen_tokens": int(sum(len(s.result().tokens) for s in ss)),
            "by_label": by_label}


def fleet_cli(dec, enc_art: Path, dec_art: Path) -> dict:
    """Part (c): the serve CLI in-process with ``--replicas 2`` on phase 6's
    artifact (its streams equal to one engine on the same model serving the
    CLI's burst) and with ``--tenant cls=... --tenant gen=...``; then
    ``--tp 2`` on this one card, which must be refused for want of cards."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.serving import GenerationRequest, ServingEngine

    out = {}
    runs = {"replicas": ["--artifact", str(dec_art), "--replicas", "2"],
            "tenants": ["--tenant", f"cls={enc_art}", "--tenant", f"gen={dec_art}"]}
    for name, argv in runs.items():
        gc.collect()
        torch.cuda.empty_cache()
        build.reset_counts()
        t0 = time.perf_counter()
        res = serve.main([*argv, *FLEET_CLI_BURST])
        torch.cuda.synchronize()
        res["seconds"] = time.perf_counter() - t0
        res["launches"], plain = dict(build.LAUNCHES), dict(build.PLAIN_ON_CUDA)
        if any(plain.values()):
            raise AssertionError(f"serve CLI {name}: plain versions on CUDA {plain}")
        if len(res["finish_reasons"]) != 16 or \
                not set(res["finish_reasons"]) <= {"length", "stop", "done"}:
            raise AssertionError(f"serve CLI {name}: finished {res['finish_reasons']}")
        out[name] = res
    # the CLI's burst (its generator, seed 0) through one engine on the
    # model already resident: the replica set's streams must equal it
    eng = ServingEngine(dec, slots=8, max_len=128)
    rng = np.random.default_rng(0)
    streams = []
    for _ in range(16):
        plen = int(rng.integers(4, 12))
        prompt = rng.integers(1, dec.plan.cfg.vocab_size, plen).astype(np.int32)
        streams.append(eng.submit(GenerationRequest(prompt=prompt, max_new_tokens=8)))
    eng.run_until_drained()
    want = [[int(t) for t in s.result().tokens] for s in streams]
    if out["replicas"]["streams"] != want:
        raise AssertionError("serve CLI --replicas 2: streams differ from one engine")
    out["replicas"]["streams_equal_to_one_engine"] = len(want)
    out["tenants"]["tenant_of_each"] = out["tenants"].pop("tenants")
    out["tenants"].pop("outputs")
    out["replicas"].pop("streams")
    try:
        serve.main(["--tp", "2", "--backend", "reference", *FLEET_CLI_BURST])
        raise AssertionError("serve CLI --tp 2 ran on a host with one card")
    except RuntimeError as e:
        if f"tp=2 needs 2 devices, host has {torch.cuda.device_count()}" not in str(e):
            raise
        out["tp2_refused"] = str(e)
    return out


def fleet_scenarios(dev) -> dict:
    """Part (d): ``serve_load``'s ``mixed_tenant`` (with ``encoder_steady``,
    its neighbour in ``run_virtual_encoder``) and ``replica_scale``
    (``--quick``) on the card, the JSON written to
    ``chiprun_out/BENCH_load_fleet.json``: the classify tenant's goodput
    1.0 beside the flood, and two replicas at least 1.8x one engine's
    virtual capacity with byte-identical streams (``tools/check_bench.py``'s
    gate)."""
    from repro_torch.benchmarks import serve_load
    virtual = serve_load.run_virtual_encoder(True, dev)
    virtual["replica_scale"] = serve_load.run_replica_scale(dev)
    path = ROOT / "chiprun_out" / "BENCH_load_fleet.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps({"bench": "serve_load", "quick": True,
                                **serve_load.device_info(dev), "virtual": virtual},
                               indent=2, sort_keys=True))
    cls = virtual["mixed_tenant"]["summary"]["by_tenant"]["cls"]
    rep = virtual["replica_scale"]
    if cls["goodput"] != 1.0 or not rep["streams_match"] or rep["capacity_ratio"] < 1.8 \
            or rep["replicas"]["goodput"]["mean"] != 1.0:
        raise AssertionError(f"fleet scenarios: cls {cls}, replica_scale {rep}")
    return {"mixed_tenant_by_tenant": virtual["mixed_tenant"]["summary"]["by_tenant"],
            "replica_scale": rep, "json": str(path.relative_to(ROOT))}


def fleet_phase(dev, dense_streams: list, single: dict) -> dict:
    """Phase 20: replicas, tenants, the serve CLI's fleet flags and the
    fleet scenarios, over phase 6's kv8 and phase 3's tinybert4
    artifacts reloaded from ``build/``."""
    from repro_torch.deploy import DeployedModel
    dec_art = ROOT / "build" / "chip_smoke_decode_artifact"
    enc_art = ROOT / "build" / "chip_smoke_artifact"
    seconds = {}
    t0 = time.perf_counter()
    dec = DeployedModel.load(str(dec_art), device=dev)
    enc = DeployedModel.load(str(enc_art), device=dev)
    seconds["load"] = time.perf_counter() - t0
    out = {}
    for part, fn in (("replicas", lambda: fleet_replicas(dec, dense_streams, single)),
                     ("tenants", lambda: fleet_tenants(enc, dec)),
                     ("cli", lambda: fleet_cli(dec, enc_art, dec_art)),
                     ("scenarios", lambda: fleet_scenarios(dev))):
        t0 = time.perf_counter()
        out[part] = fn()
        seconds[part] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


# ----------------------------------------------------------------- phase 21
MOE_SLOTS, MOE_MAX_LEN = 8, 512
#: qwen2-moe-a2.7b's depth on the card: 8 of its 24 layers (5.2 B fp
#: params, 20.9 GB in f32; the full 14.3 B would not share the card with
#: its codes and calibration); granite-moe-3b-a800m runs at full depth
MOE_QWEN_LAYERS = 8
#: the layer checks' token counts: a decode step, and a prefill in two
#: groups of moe_group_size 512
MOE_LAYER_TOKENS = (8, 1024)
MOE_LONG = 4096                # the cacheless granite forward, past the chunk threshold
MOE_KERNELS = ("int8_matmul", "int4_matmul", "decode_attention")
MOE_PAGED_KERNELS = ("int8_matmul", "int4_matmul", "decode_attention_paged")


def moe_traffic(vocab: int):
    """Phase 6's kind of traffic, shorter: 8 greedy requests (prompts of
    5-256 tokens, 4-12 new tokens) and one sampled request with n = 2."""
    from repro_torch.serving import GenerationRequest, SamplingParams
    rng = np.random.default_rng(21)
    plens = [5, 17, 33, 64, 100, 128, 200, 256]
    news = [6, 12, 8, 12, 4, 8, 12, 6]
    reqs = [GenerationRequest(prompt=rng.integers(1, vocab, n).astype(np.int32),
                              max_new_tokens=m) for n, m in zip(plens, news)]
    reqs.append(GenerationRequest(
        prompt=rng.integers(1, vocab, 40).astype(np.int32), max_new_tokens=6,
        sampling=SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=7, n=2)))
    return reqs


def moe_launches(cfg, T: int) -> dict:
    """The integer kernels' launches of one forward of ``T`` token rows of a
    MoE decoder under the serve CLI's policy (W8A8 in the first half of the
    layers, W4A4 in the rest): q, k, v, o and the shared expert's three
    linears at T rows; each expert's w1, w3 and w2 at its G * C slot rows
    (one launch an expert, empty slots included), by ``gemm_launches``."""
    from repro_torch.models.transformer import capacity
    d, q, kv = cfg.d_model, cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
    G = max(1, T // cfg.moe_group_size)
    rows = G * capacity(T // G, cfg)
    dense, experts = {}, {}
    for bits in (8, 4):
        n = cfg.num_layers // 2
        shapes = [(d, q), (d, kv), (d, kv), (q, d)]
        if cfg.shared_expert_d_ff:
            sf = cfg.shared_expert_d_ff
            shapes += [(d, sf), (d, sf), (sf, d)]
        for K, N in shapes:
            key = (K, N, bits, False)
            dense[key] = dense.get(key, 0) + n
        for K, N in ((d, cfg.expert_d_ff), (d, cfg.expert_d_ff), (cfg.expert_d_ff, d)):
            key = (K, N, bits, False)
            experts[key] = experts.get(key, 0) + n * cfg.num_experts
    a, b = gemm_launches(dense, T), gemm_launches(experts, rows)
    return {k: a[k] + b[k] for k in a}


def moe_model(name: str, dev, layers=None, art=None) -> tuple:
    """``name`` at full width (``layers`` cuts the depth), W8A8 in the first
    half of the layers and W4A4 in the rest, bf16 activations: fp params
    from a seeded generator on the card, deployed with 4 calibration
    batches of (4, 32) tokens; with ``art``, saved there and loaded back."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.deploy import DeployedModel, ExecutionPlan, deploy
    from repro_torch.models import api

    cfg = get_config(name)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    n = cfg.num_layers
    policy = QuantPolicy(num_layers=n, mode="int", last_k_int4=n // 2)
    plan = ExecutionPlan.build(cfg, policy, backend="cuda", mode="decode",
                               kv_bits=8, prefill_batch=4)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fp = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    fp_params = sum(int(t.numel()) for t in _leaves(fp))
    rng = np.random.default_rng(0)
    calib = [{"tokens": rng.integers(1, cfg.vocab_size, (4, 32)).astype(np.int32)}
             for _ in range(4)]
    model = deploy(fp, plan, calib, device=dev)
    torch.cuda.synchronize()
    info = {"model": name, "layers": n, "fp_params": fp_params,
            "deploy_s": time.perf_counter() - t0, "policy": policy.describe()}
    del fp
    gc.collect()
    torch.cuda.empty_cache()
    if art is not None:
        t0 = time.perf_counter()
        model.save(str(art))
        del model
        model = DeployedModel.load(str(art), device=dev)
        torch.cuda.synchronize()
        if model.plan != plan:
            raise AssertionError(f"{name}: plan did not round-trip through the artifact")
        info.update(save_load_s=time.perf_counter() - t0,
                    artifact_bytes=sum(f.stat().st_size for f in art.iterdir()))
    info["deployed_bytes"] = sum(t.numel() * t.element_size()
                                 for t in _leaves(model.params))
    return model, info


def serve_moe(model, reqs) -> dict:
    """Serve ``reqs`` on a fresh 8-slot engine with every count at 0 just
    before: every request finishes, every prefill and decode logits row is
    finite, every decode step launches ``moe_launches`` at 8 rows plus one
    attention kernel a layer and each prefill forward ``moe_launches`` at
    its rows, and no plain version runs on a CUDA tensor."""
    import copy

    from repro_torch.kernels import build
    from repro_torch.serving import ServingEngine

    plan = model.plan
    cfg, V = plan.cfg, plan.cfg.vocab_size
    eng = ServingEngine(model, slots=MOE_SLOTS, max_len=MOE_MAX_LEN)
    finite = []
    orig_prefill, orig_decode = eng.prefill_forward, eng.decode_forward

    def prefill(tokens):
        logits, st = orig_prefill(tokens)
        finite.append(torch.isfinite(logits[..., :V]).all())
        return logits, st
    eng.prefill_forward = prefill
    import repro_torch.serving.engine as engine_mod
    orig_sample = engine_mod.sample_batch

    def sample(logits, *a):
        finite.append(torch.isfinite(logits[..., :V]).all())
        return orig_sample(logits, *a)
    record = {}
    record_forwards(eng, record)
    streams = []
    for req in reqs:
        out = eng.submit(copy.deepcopy(req))
        streams += out if isinstance(out, list) else [out]
    engine_mod.sample_batch = sample
    build.reset_counts()
    t0 = time.perf_counter()
    try:
        eng.run_until_drained()
    finally:
        engine_mod.sample_batch = orig_sample
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches, plain = dict(build.LAUNCHES), dict(build.PLAIN_ON_CUDA)
    tag = plan.describe()
    results = [st.result() for st in streams]
    for r in results:
        if r.finish_reason not in ("length", "stop"):
            raise AssertionError(f"{tag}: request {r.rid} finished {r.finish_reason!r}")
    if not all(bool(f) for f in finite):
        raise AssertionError(f"{tag}: non-finite logits")
    attn = "decode_attention_paged" if plan.kv_paging == "paged" else "decode_attention"
    per_step = {**moe_launches(cfg, MOE_SLOTS), attn: cfg.num_layers}
    for step in record["decode"]:
        if {k: step[k] for k in per_step} != per_step:
            raise AssertionError(f"{tag}: a decode step launched {step}, expected {per_step}")
    for fwd in record["prefill"]:
        want = moe_launches(cfg, fwd["rows"])
        if (fwd["decode_attention"] or fwd["decode_attention_paged"]
                or any(fwd[k] != want[k] for k in want)):
            raise AssertionError(f"{tag}: a prefill of {fwd['rows']} rows launched "
                                 f"{fwd}, expected {want}")
    if any(plain.values()):
        raise AssertionError(f"{tag}: plain versions ran on CUDA tensors: {plain}")
    summary = eng.metrics.summary()
    tokens = int(sum(len(r.tokens) for r in results))
    return {"plan": tag, "requests": len(results), "tokens": tokens,
            "decode_steps": len(record["decode"]),
            "prefill_forwards": len(record["prefill"]),
            "prefill_rows": [f["rows"] for f in record["prefill"]],
            "gemm_launches_per_decode_step": per_step, "launches": launches,
            "plain_on_cuda": plain, "serve_s": serve_s,
            "tokens_per_s": tokens / serve_s,
            "decode_p50_ms": summary.get("decode_p50_ms"),
            "prefill_p50_ms": summary.get("prefill_p50_ms"),
            "streams": [list(map(int, r.tokens)) for r in results]}


def moe_layer_check(model, dev) -> dict:
    """One full-width MoE layer of each bit-width segment (its first layer),
    backend against backend on the card: the same bf16 input x (N(0, 1),
    a normed hidden state's scale) through ``moe_apply`` under the
    segment's kernel spec and its reference spec, at a decode step's 8
    tokens and a prefill's 1024 (two groups), dense and sorted dispatch.
    The routing (each ``route`` call's experts) and the output must be
    bit-equal, and the first call of each (kernel, shapes) the expert and
    shared GEMMs make bit-equal to its plain version (``GemmSpies``)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.deploy import ExecutionPlan
    from repro_torch.models import transformer as tt

    plan, cfg = model.plan, model.plan.cfg
    ref = ExecutionPlan.build(cfg, plan.policy, backend="reference", mode="decode",
                              kv_bits=plan.kv_bits)
    routes = []
    orig_route = tt.route

    def route(*a):
        out = orig_route(*a)
        routes.append(out[2])
        return out
    g = torch.Generator(device=dev).manual_seed(21)
    out, kept = [], {}
    tt.route = route
    try:
        for si, (start, end, spec) in enumerate(plan.segments):
            p = tree_map(lambda a: a[0], model.params["layers"][si])["moe"]
            for T in MOE_LAYER_TOKENS:
                x = torch.randn((1, T, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
                for impl in ("dense", "sorted"):
                    c = cfg.replace(moe_impl=impl)
                    routes.clear()
                    with torch.no_grad(), GemmSpies() as spies:
                        y, aux = tt.moe_apply(x, p, c, spec)
                    kept.update(spies.kept)
                    with torch.no_grad():
                        y_ref, aux_ref = tt.moe_apply(x, p, c, ref.segments[si][2])
                    tag = f"{cfg.name} layer {start} T={T} {impl}"
                    if not torch.equal(routes[0], routes[1]):
                        raise AssertionError(f"{tag}: routing differs between backends")
                    if not torch.equal(y, y_ref) or not torch.equal(aux, aux_ref):
                        diff = (y.float() - y_ref.float()).abs().max().item()
                        raise AssertionError(f"{tag}: cuda != reference backend "
                                             f"(max |diff| {diff})")
                    if not bool(torch.isfinite(y).all()):
                        raise AssertionError(f"{tag}: non-finite output")
                    out.append({"layer": start, "w_bits": spec.w_bits, "T": T,
                                "impl": impl, "bit_equal": True,
                                "out_abs_max": y.float().abs().max().item()})
    finally:
        tt.route = orig_route
    shapes = check_kept_calls(kept, f"{cfg.name} MoE layer")
    return {"cases": out, "gemm_calls_bit_equal": shapes}


def moe_graph_step(model, dev) -> dict:
    """One kv8 decode step (8 active slots at cache length 448) eager, then
    captured in a CUDA graph and replayed twice: both replays byte-equal to
    the eager step's logits. Eager ms, graphed device ms, the idle share,
    the GEMM launches of one eager step, and the bound of reading the
    layers' weights once."""
    from repro_torch.kernels import build
    from repro_torch.models import api

    st = decode_state_at(model, dev, DECODE_LEN)
    toks = torch.randint(1, model.plan.cfg.vocab_size, (DECODE_SLOTS, 1), device=dev)

    def step():
        with torch.no_grad():
            return api.forward(model.params, model.plan, state=st, tokens=toks)[0]
    build.reset_counts()
    eager = step()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = step()
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(captured.clone())
    for i, r in enumerate(replays):
        if not torch.equal(r, eager):
            raise AssertionError(f"{model.plan.describe()}: graph replay {i} != the "
                                 "eager step")
    del graph, captured, replays
    eager_ms = cuda_ms(step, samples=5, reps=1, warmup=1, graph=False)
    device_ms = cuda_ms(step, samples=5, reps=1, warmup=1)
    gemms = launches["int8_matmul"] + launches["int4_matmul"]
    # the least time of the step's GEMMs: each layer's weight codes and
    # scales read once (the embedding and head excluded)
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(model.params["layers"]))
    bound_ms, bound_by = bound(nbytes, 0.0, 1.0)
    return {"slots": DECODE_SLOTS, "cache_len": DECODE_LEN,
            "layer_weight_bytes": nbytes, "weights_bound_ms": bound_ms,
            "weights_bound_by": bound_by,
            "replays_byte_equal": 2, "launches": launches,
            "gemm_launches_per_step": gemms, "eager_ms": eager_ms,
            "device_ms": device_ms, "device_idle_share_eager": 1.0 - device_ms / eager_ms,
            "device_us_per_gemm_launch_upper": device_ms * 1e3 / gemms}


def moe_long_forward(model, dev) -> dict:
    """One cacheless granite forward of 4096 tokens (flash attention at GQA
    group 3, dh 64; each expert's GEMMs on wgmma at G * C = 1024 rows behind
    act_quant), launching exactly ``moe_launches`` and 32 flash kernels;
    layer 0's flash output within phase 12's tolerances of the plain
    version, the first call of each GEMM shape bit-equal to its plain
    version."""
    cfg = model.plan.cfg
    inputs = prefill_inputs(cfg, MOE_LONG, dev)
    expected = {**dict.fromkeys(SOURCES, 0), **moe_launches(cfg, MOE_LONG),
                "flash_attention": cfg.num_layers}
    t0 = time.perf_counter()
    run = long_forward(model, inputs, flash_layers=1, gemms=True, expected=expected)
    tag = f"{cfg.name} S={MOE_LONG}"
    err = check_layers(run.pop("taken"), tag)
    shapes = check_gemms(run.pop("kept"), tag)
    run.pop("logits")
    return {**run, "layer0_max_abs_err_vs_plain": err, "gemm_shapes_bit_equal": shapes,
            "seconds": time.perf_counter() - t0}


def moe_phase(dev) -> dict:
    """Phase 21: the MoE family on the card (see the module docstring)."""
    t0 = time.perf_counter()
    out = {}
    granite, out["granite_deploy"] = moe_model(
        "granite-moe-3b-a800m", dev, art=ROOT / "build" / "chip_smoke_moe_artifact")
    reqs = moe_traffic(granite.plan.cfg.vocab_size)
    serve = {}
    for tag, kv, paging in (("kv8_dense", 8, "dense"), ("kv8_paged", 8, "paged"),
                            ("kv4_dense", 4, "dense")):
        serve[tag] = serve_moe(paged_model(granite, paging, kv_bits=kv), reqs)
    out["granite_serve"] = {k: {kk: vv for kk, vv in v.items() if kk != "streams"}
                            for k, v in serve.items()}
    out["granite_kv8_paged_streams_equal_dense"] = sum(
        a == b for a, b in zip(serve["kv8_paged"]["streams"], serve["kv8_dense"]["streams"]))
    out["granite_layer"] = moe_layer_check(granite, dev)
    out["granite_graph_step"] = moe_graph_step(granite, dev)
    out["granite_long_forward"] = moe_long_forward(granite, dev)
    out["granite_s"] = time.perf_counter() - t0
    del granite
    t1 = time.perf_counter()
    qwen, out["qwen_deploy"] = moe_model("qwen2-moe-a2.7b", dev, layers=MOE_QWEN_LAYERS)
    q = serve_moe(qwen, moe_traffic(qwen.plan.cfg.vocab_size)[:4])
    out["qwen_serve_kv8_dense"] = {k: v for k, v in q.items() if k != "streams"}
    out["qwen_layer"] = moe_layer_check(qwen, dev)
    out["qwen_s"] = time.perf_counter() - t1
    del qwen
    gc.collect()
    torch.cuda.empty_cache()
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
    seconds = {}
    t0 = time.perf_counter()
    build.library()
    seconds["build"] = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.build_log().splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    emit({"phase": "build", "seconds": seconds["build"], "ptxas": ptxas})

    t0 = time.perf_counter()
    errors = check_kernels(dev)
    gemm_paths = errors.pop("gemm_path_calls_bit_equal")
    seconds["kernels_vs_plain"] = time.perf_counter() - t0
    emit({"phase": "kernels_vs_plain", "max_abs_err": errors,
          "gemm_path_calls_bit_equal": gemm_paths,
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
    fused_rows = time_fused_paths(dev)
    for r in fused_rows:
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
    models, dense_streams = dec.pop("models"), dec.pop("streams")
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

    t0 = time.perf_counter()
    errors["decode_attention_paged"], cases = check_decode_attention_paged(dev)
    seconds["decode_attention_paged_vs_plain"] = time.perf_counter() - t0
    emit({"phase": "decode_attention_paged_vs_plain", "cases": cases,
          "max_abs_err": errors["decode_attention_paged"],
          "seconds": seconds["decode_attention_paged_vs_plain"]})

    t0 = time.perf_counter()
    paged = paged_end_to_end(models, dense_streams)
    seconds["paged_end_to_end"] = time.perf_counter() - t0
    emit({"phase": "paged_end_to_end", "per_kv": paged,
          "seconds": seconds["paged_end_to_end"]})

    t0 = time.perf_counter()
    prefix = prefix_end_to_end(models)
    seconds["prefix_end_to_end"] = time.perf_counter() - t0
    emit({"phase": "prefix_end_to_end", **prefix, "seconds": seconds["prefix_end_to_end"]})

    t0 = time.perf_counter()
    paged_times = time_paged_decode(models, dev)
    emit({"phase": "paged_decode_times", **paged_times})
    paged_rows = time_paged_kernel(dev)
    for r in paged_rows:
        emit({"phase": "decode_kernel_time", **r})
    dec_rows += paged_rows
    seconds["paged_times"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    errors["flash_attention"], cases = check_flash_attention(dev)
    seconds["flash_attention_vs_plain"] = time.perf_counter() - t0
    emit({"phase": "flash_attention_vs_plain", "cases": cases,
          "max_abs_err": errors["flash_attention"],
          "seconds": seconds["flash_attention_vs_plain"]})

    t0 = time.perf_counter()
    llava, llava_info = llava_model(dev)
    seconds["llava_deploy"] = time.perf_counter() - t0
    emit({"phase": "llava_deploy", **llava_info, "seconds": seconds["llava_deploy"]})
    prefill_models = {"stablelm-3b": models[8], "llava-next-mistral-7b": llava}
    t0 = time.perf_counter()
    prefill = long_prefill(prefill_models, dev)
    seconds["long_prefill"] = time.perf_counter() - t0
    emit({"phase": "long_prefill", "S": PREFILL_LENGTHS[0], "per_model": prefill,
          "seconds": seconds["long_prefill"]})

    t0 = time.perf_counter()
    flash_rows = time_flash_kernel(dev)
    for r in flash_rows:
        emit({"phase": "flash_kernel_time", **r})
    dec_rows += flash_rows
    gemm_rows = time_long_gemms(dev)
    for r in gemm_rows:
        emit({"phase": "long_gemm_time", **r})
    quant_rows = time_long_act_quant(dev)
    for r in quant_rows:
        emit({"phase": "long_act_quant_time", **r})
    dec_rows += quant_rows
    long_times = time_long_forwards(prefill_models, dev)
    seconds["long_times"] = time.perf_counter() - t0
    emit({"phase": "long_forward_times", "S": PREFILL_LENGTHS[-1],
          "per_model": long_times, "seconds": seconds["long_times"]})
    del llava, prefill_models
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    table2 = table2_phase(dev)
    seconds["table2"] = time.perf_counter() - t0
    for r in table2["rows"]:
        emit({"phase": "table2", **r})
    for r in table2["ratios"]:
        emit({"phase": "table2_ratio", **r})
    for r in table2["gemm_times"]:
        emit({"phase": "table2_gemm_time", **r})
    emit({"phase": "table2_checks", "layers_checked": table2["layers_checked"],
          "gemm_calls_bit_equal": table2["gemm_calls_bit_equal"],
          "seconds": seconds["table2"]})

    t0 = time.perf_counter()
    cli = serve_cli(dev)
    seconds["serve_cli"] = time.perf_counter() - t0
    emit({"phase": "serve_cli", "runs": {name: {k: v for k, v in res.items()
                                                if k != "streams"}
                                         for name, res in cli.items()},
          "seconds": seconds["serve_cli"]})
    t0 = time.perf_counter()
    score = score_end_to_end(models, dense_streams)
    seconds["score_end_to_end"] = time.perf_counter() - t0
    emit({"phase": "score_end_to_end", **score, "seconds": seconds["score_end_to_end"]})

    t0 = time.perf_counter()
    load = load_phase(models, dev)
    seconds["load"] = time.perf_counter() - t0
    for name in ("decoder", "encoder"):
        emit({"phase": "load", "cell": name, **load[name]})
    emit({"phase": "serve_latency_json", **load["serve_latency"]})
    emit({"phase": "serve_load_json", **load["serve_load"]})
    del models                      # phase 20 reloads the kv8 artifact
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    qat = qat_end_to_end(dev)
    seconds["qat_end_to_end"] = time.perf_counter() - t0
    emit({"phase": "qat_end_to_end", **qat, "seconds": seconds["qat_end_to_end"]})

    t0 = time.perf_counter()
    trained = train_cli_phase(dev)
    seconds["train_cli"] = time.perf_counter() - t0
    emit({"phase": "train_cli", **trained["full_width"],
          "reduced_resume": trained["reduced_resume"]})
    for name, algo, acc in trained["table1"]:
        emit({"phase": "table1", "name": name, "algo": algo, "accuracy": acc})
    for name, acc in trained["table3"]:
        emit({"phase": "table3", "name": name, "accuracy": acc})
    emit({"phase": "quality_json", **trained["quality"],
          "check_quality_rc": trained["check_quality_rc"],
          "check_quality": trained["check_quality"],
          "seconds": {k: trained[k] for k in ("table1_s", "quality_s", "table3_s")}})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fleet = fleet_phase(dev, dense_streams[8], dec["per_kv"][8])
    seconds["fleet"] = time.perf_counter() - t0
    emit({"phase": "fleet", **fleet, "seconds_total": seconds["fleet"]})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe = moe_phase(dev)
    seconds["moe"] = time.perf_counter() - t0
    emit({"phase": "moe", **{k: v for k, v in moe.items() if k not in (
        "granite_layer", "qwen_layer")}, "seconds": seconds["moe"]})
    for key in ("granite_layer", "qwen_layer"):
        emit({"phase": f"moe_{key}", **moe[key]})
    errors["flash_attention"] = max(
        errors["flash_attention"], *(r["max_abs_err"] for r in flash_rows),
        *(run["layers_max_abs_err_vs_plain"] for run in prefill.values()),
        *(run["layer0_max_abs_err_vs_plain"] for run in long_times.values()),
        moe["granite_long_forward"]["layer0_max_abs_err_vs_plain"])

    launches_by_path = {"encoder": e2e["launches"],
                        **{f"decode_kv{kv}": v["launches"]
                           for kv, v in dec["per_kv"].items()},
                        **{f"paged_kv{kv}": v["launches"] for kv, v in paged.items()},
                        "prefix_dense_kv8": prefix["dense_prefix"]["launches"],
                        "prefix_paged_kv8": prefix["paged_prefix"]["launches"],
                        "prefix_paged_60pct_kv8": prefix["paged_prefix_60pct"]["launches"],
                        **{f"prefill_{name}_{PREFILL_LENGTHS[0]}": run["launches"]
                           for name, run in prefill.items()},
                        **{f"prefill_{name}_{PREFILL_LENGTHS[-1]}": run["launches"]
                           for name, run in long_times.items()},
                        "table2": table2["launches"],
                        **{f"serve_cli_{name}": res["launches"] for name, res in cli.items()},
                        "score_dense_kv8": score["dense"]["launches"],
                        "score_paged_kv8": score["paged"]["launches"],
                        "load_decoder": load["decoder"]["launches"],
                        "load_encoder": load["encoder"]["launches"],
                        "qat_encoder": qat["launches"],
                        "table1_quality": trained["quality_launches"],
                        "fleet_replicas_dense": fleet["replicas"]["dense"]["launches"],
                        "fleet_replicas_paged": fleet["replicas"]["paged"]["launches"],
                        "fleet_tenants": fleet["tenants"]["launches"],
                        "serve_cli_replicas": fleet["cli"]["replicas"]["launches"],
                        "serve_cli_tenants": fleet["cli"]["tenants"]["launches"],
                        **{f"moe_granite_{tag}": run["launches"]
                           for tag, run in moe["granite_serve"].items()},
                        f"moe_granite_prefill_{MOE_LONG}":
                            moe["granite_long_forward"]["launches"],
                        "moe_qwen_kv8_dense": moe["qwen_serve_kv8_dense"]["launches"]}
    # act_quant is a kernel of a path where its plan calls for it: a split-K
    # GEMM (at most 64 rows) quantizes its own activations
    planned = {"encoder": e2e["expected_launches"]["act_quant"],
               **{f"decode_kv{kv}": v["act_quant_planned"] for kv, v in dec["per_kv"].items()},
               **{f"paged_kv{kv}": v["act_quant_planned"] for kv, v in paged.items()},
               "prefix_dense_kv8": prefix["dense_prefix"]["act_quant_planned"],
               "prefix_paged_kv8": prefix["paged_prefix"]["act_quant_planned"],
               "prefix_paged_60pct_kv8": prefix["paged_prefix_60pct"]["act_quant_planned"],
               "score_dense_kv8": score["dense"]["act_quant_planned"],
               "score_paged_kv8": score["paged"]["act_quant_planned"],
               "qat_encoder": qat["expected_launches"]["act_quant"],
               "fleet_replicas_dense": fleet["replicas"]["dense"]["act_quant_planned"],
               "fleet_replicas_paged": fleet["replicas"]["paged"]["act_quant_planned"]}
    # the serve CLI's and the load generator's short prompts take split-K
    # (no act_quant) or not by their draw; the CLI's encoder policy is W4A4
    cli_decode = ("int8_matmul", "int4_matmul", "decode_attention")
    for path, need in (("encoder", ENCODER_KERNELS), ("decode_kv8", DECODER_KERNELS),
                       ("decode_kv4", DECODER_KERNELS), ("paged_kv8", PAGED_KERNELS),
                       ("paged_kv4", PAGED_KERNELS), ("prefix_dense_kv8", DECODER_KERNELS),
                       ("prefix_paged_kv8", PAGED_KERNELS),
                       ("prefix_paged_60pct_kv8", PAGED_KERNELS),
                       *((path, PREFILL_KERNELS) for path in launches_by_path
                         if path.startswith("prefill_")),
                       ("table2", GEMM_NAMES), ("serve_cli_decode_kv8", cli_decode),
                       ("serve_cli_decode_kv8_artifact", cli_decode),
                       ("serve_cli_paged_kv8", ("int8_matmul", "int4_matmul",
                                                "decode_attention_paged")),
                       ("serve_cli_encoder", ("int4_matmul", "int4_matmul_fused")),
                       ("serve_cli_encoder_artifact", ("int4_matmul", "int4_matmul_fused")),
                       ("score_dense_kv8", DECODER_KERNELS),
                       ("score_paged_kv8", PAGED_KERNELS),
                       ("load_decoder", cli_decode),
                       ("load_encoder", ("int8_matmul", "int4_matmul",
                                         "int4_matmul_fused")),
                       ("qat_encoder", ("act_quant", "int4_matmul", "int4_matmul_fused")),
                       ("table1_quality", GEMM_NAMES),
                       ("fleet_replicas_dense", DECODER_KERNELS),
                       ("fleet_replicas_paged", PAGED_KERNELS),
                       ("fleet_tenants", ("int8_matmul", "int4_matmul",
                                          "int4_matmul_fused", "decode_attention")),
                       ("serve_cli_replicas", cli_decode),
                       ("serve_cli_tenants", ("int8_matmul", "int4_matmul",
                                              "int4_matmul_fused", "decode_attention")),
                       ("moe_granite_kv8_dense", MOE_KERNELS),
                       ("moe_granite_kv8_paged", MOE_PAGED_KERNELS),
                       ("moe_granite_kv4_dense", MOE_KERNELS),
                       (f"moe_granite_prefill_{MOE_LONG}", PREFILL_KERNELS),
                       ("moe_qwen_kv8_dense", MOE_KERNELS)):
        idle = [k for k in need if not launches_by_path[path][k]
                and (k != "act_quant" or planned.get(path, 1))]
        if idle:
            raise AssertionError(f"{path}: kernels never launched on the main "
                                 f"path: {idle}")
    entries = kernel_entries(rows, dec_rows, launches_by_path, errors)
    for entry in entries:
        long_rows = [r for r in gemm_rows if r["kernel"] == entry["name"]]
        if long_rows:
            entry["long_forward_gemms"] = long_rows
        if entry["name"] == "int4_matmul_fused":
            entry["other_shapes"] = fused_rows
        t2_rows = [r for r in table2["gemm_times"] if r["kernel"] == entry["name"]]
        if t2_rows:
            entry["table2_gemms"] = t2_rows
    emit({"phase": "seconds", **seconds})
    report = ROOT / "chiprun_out" / "chip_smoke_report.json"
    report.parent.mkdir(exist_ok=True)
    report.write_text(json.dumps({"card": card, "kernels": entries,
                                  "end_to_end": e2e, "forward_32x128": enc_fwd,
                                  "decode_end_to_end": dec,
                                  "decode_times": dec_times,
                                  "paged_end_to_end": paged,
                                  "prefix_end_to_end": prefix,
                                  "paged_decode_times": paged_times,
                                  "llava_deploy": llava_info,
                                  "long_prefill": prefill,
                                  "long_forward_times": long_times,
                                  "long_gemm_times": gemm_rows,
                                  "long_act_quant_times": quant_rows,
                                  "fused_times": fused_rows,
                                  "table2": table2, "serve_cli": cli,
                                  "score_end_to_end": score, "load": load,
                                  "qat_end_to_end": qat, "train_cli": trained,
                                  "fleet": fleet, "moe": moe, "seconds": seconds},
                                 indent=2, default=str))
    emit({"kernels": entries})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
