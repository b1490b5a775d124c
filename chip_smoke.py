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
   artifact cut to 4 layers (``PREFIX_LAYERS``: layers 0-1 of its W8A8
   segment and 0-1 of its W4A4 one, as one W8A8 0-1 / W4A4 2-3 model;
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
   Then ``benchmarks/table1_glue.run`` (rows 2 and 4), ``run_artifact(quick=
   True)`` (deployed on the cuda backend: scored through the integer
   kernels, no plain version on a CUDA tensor) and
   ``table3_ablation.run``, the two tables at ``TABLE_STEPS`` (30, 3/8 of
   their ``quick`` size) on one trained fp
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
21. the MoE family: (a) granite-moe-3b-a800m at full width, its depth cut
   to 4 of 32 layers for the script's time (``MOE_GRANITE_LAYERS``; d
   1536, 24 heads of 64 on 8 KV heads, 40 experts of d_ff 512, top-8; W8A8
   layers 0-1, W4A4 2-3, bf16 activations) from a seeded
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
   bias), its depth cut to 4 of 24 layers (``MOE_QWEN_LAYERS``), deployed
   on the card (not saved), serving 4 requests at kv8 dense with (a)'s
   checks and (b)'s layer check at its shapes. Phases 5, 8 and 12 also run
   the attention kernels at GQA groups 3, 5 and 8 ((24, 8, 64), (40, 8,
   128), (64, 8, 128): granite-moe-3b-a800m, qwen2.5-32b, qwen1.5-110b);
22. zamba2-2.7b (the Mamba2 hybrid) at full width, its depth cut to 12 of
   54 Mamba2 layers for the script's time (``ZAMBA_LAYERS``; d 2560, 80 SSM
   heads of 64, state 64, in 2 groups of 6, each group followed by the one
   shared attention + SwiGLU block, 32 heads of 80; vocab 32000; bf16
   activations) under the serve CLI's policy: W8A8 group 0, W4A4 group 1,
   the shared block at the last segment's 4 bits. fp params from a seeded
   generator on the card -> ``deploy`` with 2
   calibration batches of 256 tokens (a multiple of the SSD chunk) ->
   ``save`` under ``build/`` -> ``load`` -> a token-mode ``ServingEngine``
   (4 slots, max_len 512) serving 8 greedy requests (prompts of 16-48
   tokens, 16 new tokens each; freed slots refilled): every request
   finishes, every step's logits finite, every token step launches the
   integer GEMMs ``hybrid_linears`` derives at 4 rows (all split-K: no
   act_quant, no attention kernel; token mode runs no prefill forward), no
   plain version on a CUDA tensor; the streams equal the same artifact's
   under the reference backend on the card (a difference is reported with
   its first diverging step, and fails). The first call of each integer
   GEMM shape of a token step (in_bc N = 128, in_dt N = 80, out_proj K =
   5120, the shared block's) bit-equal to its plain version. One cacheless
   forward of 4096 tokens (the shared block on the causal flash kernel,
   ``ssd_chunked`` over 16 chunks; every GEMM behind act_quant), launching
   exactly what ``hybrid_linears`` and 4 flash calls make, the first flash
   call within phase 12's tolerances of the plain version, the first call
   of each GEMM shape bit-equal, the logits bit-equal to the reference
   plan's with its attention on the flash kernel too (every other part is
   exact) and within ``ZAMBA_VS_REFERENCE`` of the plain reference's. Step
   ms, launches per step, peak memory and the artifact's bytes;
23. seamless-m4t-medium (the encoder-decoder) at full width and depth (12
   encoder + 12 decoder layers, d 1024, 16 heads of 64, GELU FFN 4096,
   LayerNorm, vocab 256206; bf16 activations): W8A8 decoder layers 0-5,
   W4A4 6-11 (GELU FFN-up on the fused int4 epilogue), the encoder at the
   first segment's W8A8; deployed on the card with 2 calibration batches
   carrying (2, 256) source frames, not saved. The engine refuses the plan
   (the JAX engine cannot serve an encoder-decoder either). The encoder over
   2 rows of 4096 frames: each layer's self-attention on the flash kernel
   NOT causal (12 calls, each within phase 12's tolerances of the plain
   version on its own q, k, v), every GEMM behind act_quant and each new
   shape bit-equal, the launches exact, no full attention; the whole output
   bit-equal to the reference plan's with its attention on the flash
   kernel too, and within ``SEAMLESS_VS_REFERENCE`` of the plain
   reference's. Then 16 greedy
   tokens through ``api.forward`` over ``decode_state`` and
   ``decode_extra_inputs``: every step launches exactly what
   ``seamless_step_launches`` derives (the cross-attention's k and v over
   the 8192 encoder rows every step, as in the JAX package) and no attention
   kernel; the same decode with the unfused kernel plan and with the
   reference backend over the kernels' encoder output bit-equal; the
   greedy tokens' agreement with the reference backend over its own encoder
   output reported. Then the non-causal flash kernel alone at the encoder's
   shape beside its plain version, SDPA (``is_causal=False``) and its
   bound;
24. xlstm-1.3b at full width, its depth cut to 16 of 48 layers for the
   script's time (``XLSTM_LAYERS``; 2 groups of 7 mLSTM + 1 sLSTM, d 2048,
   4 heads, the mLSTM's head width 1024, vocab 50304; bf16 activations,
   an f32 recurrent state at 4 slots a third of the full depth's 2.83 GB)
   under the serve CLI's policy: W8A8 group 0, W4A4 group 1. fp params
   from a seeded generator on the card -> ``deploy`` with 2 calibration
   batches of 256 tokens (the mLSTM chunk) -> ``save`` under ``build/`` ->
   ``load``. The first call of each integer GEMM shape of a token step (up
   and sLSTM w_in 2048 x 8192, wq / wk / wv 4096 x 4096, down 4096 x 2048,
   sLSTM down 2048 x 2048, all split-K at 4 rows) bit-equal to its plain
   version. A token-mode ``ServingEngine`` (4 slots, max_len 512) serving
   one request of 16 prompt tokens and 500 new ones, past max_len, which
   the engine admits and finishes for this family as JAX's does, and 8
   greedy requests (prompts of 16-48 tokens, 16 new tokens; freed slots
   refilled): every request finishes, every step's logits finite, every
   token step launches exactly the 74 GEMMs ``xlstm_linears`` derives
   (int8 37, int4 37, all split-K: no act_quant, no attention kernel), no
   plain version on a CUDA tensor; the streams equal the same artifact's
   under the reference backend on the card. A token step's eager and
   CUDA-graph (device) ms. One cacheless forward of 1024 tokens
   (``mlstm_chunked`` over 4 chunks, the sLSTM loop over 1024 steps)
   launching exactly 74 act_quant and 74 GEMMs (wgmma), the first call
   of each GEMM shape bit-equal to its plain version, the logits bit-equal
   to the reference plan's; eager ms and peak memory. Then 2 training
   steps of 2 x 256 tokens on the model cut to its first group (8 layers),
   fake-quant W4A4 under an fp teacher of the same cut, with the
   hidden-state distillation: every loss finite, each step's eager ms and
   the peak memory;
25. (a) fused projections: phase 6's stablelm-3b fp params (same seed,
   full width and depth) with wq | wk | wv concatenated into ``wqkv`` (2560
   x 7680) and w1 | w3 into ``w13`` (2560 x 13824)
   (``transformer.fuse_projections``), deployed under ``fused_proj`` with
   phase 6's policy and calibration, saved, loaded and served at kv8 on
   phase 6's traffic: every decode step launches int8_matmul 64,
   int4_matmul 64 and decode_attention 32 (``FUSED_DECODE_STEP``, checked
   against ``fused_linears``) and act_quant never, each prefill forward what
   ``gemm_launches`` derives, no plain version on a CUDA tensor; the first
   call of each GEMM shape bit-equal to its plain version (the fused shapes
   among them); the streams compared with phase 6's unfused kv8 streams
   (each request's first differing token is reported); a decode step's
   eager and graphed ms, unfused and fused in turns (unfused, fused, fused,
   unfused, the card's clocks beside each), with phase 7's. (b) ``remat``: one loss and
   gradient of the train CLI's stablelm-3b (fake quant, phase 19's 8 x 128
   batch) with ``remat`` off and on: the losses bit-equal, every gradient
   leaf within ``REMAT_GRAD_RTOL`` of its largest |g| (the bit-equal leaves
   counted), eager ms and peak memory of each (phases 19 and 24 now train
   with ``remat`` on, their configs' default). (c) ``launch/op_analysis``
   on meta copies of phase 6's kv8 decode step (8 slots at 448, phase 6's
   artifact reloaded), the fused step and phase 3's 32 x 128 encoder
   forward: the predicted launches equal the launches counted on the card;
   the predicted bytes, FLOPs, the bound they give and the predicted
   memory beside the graphed device ms and the measured peak; then
   ``launch.dryrun.run_cell`` for ``DRYRUN_CELLS`` on the single layout
   (their JSON under ``chiprun_out/dryrun_torch/``);
26. (a) the sharded QAT step (``launch/train.build_train_step`` with
   ``TrainGroups``): stablelm-3b at full width, its depth cut to 2 layers
   (``SHARD_LAYERS``), fake quant W8A8 layer 0 / W4A4 layer 1, ``remat`` on,
   a batch of 2 x 4096 (past the chunk threshold: the chunk branch), the
   CPU tests' hyperparameters (``SHARD_HP``), weight and activation scales
   calibrated first (at their init of 1 no block weight gets a gradient).
   One step unsharded on the card in f32 and in bf16 activations, then
   each of ``SHARD_LAYOUTS`` as 2 ranks sharing the one card over gloo
   (NCCL refuses two ranks on one card; gloo must take ``all_reduce``,
   ``broadcast`` and ``all_gather`` on CUDA tensors, ``probe_gloo_cuda``
   raises naming any it refuses): model 2 with ``attn_seq_shard`` and data
   2 with FSDP in f32, model 2 in bf16. Each rank's loss, first Adam moment
   (the clipped gradient times 1 - b1) and Adam step (params after less
   params before), leaf by leaf, against the unsharded step of its dtype,
   at ``SHARD_TOLS`` (the CPU tests' gates: f32 rtol 1e-5, ||delta|| /
   ||m|| 1e-4, ||delta|| / ||step|| 1e-2; bf16 rtol 1e-3 and 0.5 on m, its
   step not held), the leaf that comes closest named, the chunk branch
   context-parallel under ``attn_seq_shard``; eager ms and peak memory per
   rank. (b) The four ``examples/torch_*.py`` with ``--quick`` on the card,
   each passing its own asserts (``torch_serve_sharded`` skips its tp half
   on one card), their kernel launches counted and no plain version on a
   CUDA tensor. (c) ``launch.dryrun.run_cell`` for stablelm-3b x train_4k x
   multi (data 2 x model 2) plain, with ``--fsdp`` and with
   ``--attn-seq-shard``, in three processes on the card's host while (a)
   and (b) run: every cell ``ok``, FSDP's argument bytes at most 0.55x the
   plain cell's;
27. the sharded QAT step of the token-mode families, phase 26 (a)'s method
   at full width (``FAMILY_SHARDS``): xlstm-1.3b cut to 16 layers (2
   groups) on 2 x 256 tokens, zamba2-2.7b cut to 12 (2 groups) on 2 x
   2048, seamless-m4t-medium cut to 2 + 2 on 2 x 1024 frames
   (``src_embeds`` from a seeded generator) and 2 x 1024 tokens; f32,
   ``remat`` on, scales calibrated (the token-mode families' one
   activation scale). Two ranks sharing the card over gloo, one spawn for
   the three: per family rank 0 computes the unsharded steps (rank 1 loads
   the kernels a first step needs meanwhile, on the reduced configs), then
   both run model 2 (weights and activations quantized, and weights only)
   and data 2 with FSDP (weights only, each group stack cut to one group a
   rank). The quantized step is held by its loss at 4x its noise (twins
   from the embedding table and from every activation scale times 1 + k
   e, their forwards alone), the weight-only steps leaf by leaf (first
   moment, Adam step) at the CPU tests' gates or 4x two twin steps'
   noise; the model-2 layout's gathered starting tree bit-equal to the
   full one. The zamba2 tree the model-2 quantized step trained is then
   gathered, deployed on its learned scales (bf16, the kernel backend) and
   serves 4 requests of 16 + 16 tokens in token mode: every token step
   launches the integer GEMMs ``hybrid_linears`` derives, and the streams
   equal the reference backend's. Each run's seconds and peak memory
   beside the card.

``python3 chip_smoke.py --sharded-cards 4`` runs only phase 26 (a)'s step
on four cards over NCCL (``sharded_cards``); ``python3 chip_smoke.py
--families`` runs only phase 27.

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
#: phase 6's warm-up run serves the requests of this many new tokens (3 of
#: 17, prompts of 5, 48 and 200 tokens: 16 decode steps instead of 64)
WARMUP_NEW = 16
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


def serve_decode(model, *, launches=None, tops=None, other=None, reqs=None):
    """Serve the decode traffic (or ``reqs``) on a fresh engine; returns the
    results in submission order (the sampled request's two samples last).
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
    for req in decode_traffic(model.plan.cfg.vocab_size) if reqs is None else reqs:
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
        if kv == 8:     # warm-up (kv4 reuses it): the traffic's shortest requests
            serve_decode(model, reqs=[r for r in decode_traffic(cfg.vocab_size)
                                      if r.max_new_tokens == WARMUP_NEW])
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
PREFIX_LAYERS = 4


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
#: QAT steps a row of Table 1 and Table 3 in phase 19 (3/8 of the tables'
#: ``quick`` size, ``table1_glue.QUICK_STEPS`` = 80, for the script's time;
#: at 20 the fp pair learns nothing and every row reads the majority class;
#: the quality payload keeps its own ``quick`` run)
TABLE_STEPS = 30


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
    trained = table1_glue.teacher_and_student(TABLE_STEPS, 0, dev)
    table1 = table1_glue.run(steps=TABLE_STEPS, rows=(2, 4), device=dev, trained=trained)
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
    table3 = table3_ablation.run(steps=TABLE_STEPS, device=dev, trained=trained)
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
            "table3": [list(r) for r in table3], "table3_s": table3_s,
            "table_steps": TABLE_STEPS}


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
#: qwen2-moe-a2.7b's depth on the card: 4 of its 24 layers (8 until PR 30,
#: 5.2 B fp params, 20.9 GB in f32; the full 14.3 B would not share the
#: card with its codes and calibration), for the script's time
MOE_QWEN_LAYERS = 4
#: granite-moe-3b-a800m's depth on the card: 4 of its 32 layers (8 until
#: PR 30), for the script's time (each layer's work is the same)
MOE_GRANITE_LAYERS = 4
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
        "granite-moe-3b-a800m", dev, layers=MOE_GRANITE_LAYERS,
        art=ROOT / "build" / "chip_smoke_moe_artifact")
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


# ----------------------------------------------------------------- phase 22
#: the token-mode engines of phases 22 and 24: slots, max_len, and the new
#: tokens of a request
TOKEN_SLOTS, TOKEN_MAX_LEN, TOKEN_NEW = 4, 512, 16
#: zamba2-2.7b's depth on the card: 12 of its 54 layers (2 groups of 6),
#: for the script's time
ZAMBA_LAYERS = 12
#: the cacheless forward past the chunk threshold: the shared block on the
#: flash kernel (causal), ssd_chunked over 4096 / 256 = 16 chunks
ZAMBA_LONG = 4096
#: calibration batches: (batches, rows, tokens), the length a multiple of
#: the SSD chunk (256), as a cacheless forward needs
ZAMBA_CALIB = (2, 1, 256)
HYBRID_KERNELS = ("int8_matmul", "int4_matmul")


def hybrid_linears(cfg, segments) -> dict:
    """The quantized linears of one forward of a hybrid under ``segments``
    (group granularity): each Mamba2 layer's in_z, in_x, in_bc (N = 2 x
    ssm_state), in_dt (N = heads) and out_proj (K = ssm_expand x d) at its
    group's bits, and the shared block's q, k, v, o and SwiGLU at the last
    segment's bits, once per group. (K, N, bits, fused) -> calls."""
    d, di = cfg.d_model, cfg.ssm_expand * cfg.d_model
    heads, per = di // cfg.ssm_head_dim, cfg.attn_every
    q, kv = cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
    out: dict = {}

    def add(K, N, bits, n):
        out[(K, N, bits, False)] = out.get((K, N, bits, False), 0) + n
    for s, e, spec in segments:
        for K, N in ((d, di), (d, di), (d, 2 * cfg.ssm_state), (d, heads), (di, d)):
            add(K, N, spec.w_bits, (e - s) * per)
    for K, N in ((d, q), (d, kv), (d, kv), (q, d), (d, cfg.d_ff), (d, cfg.d_ff),
                 (cfg.d_ff, d)):
        add(K, N, segments[-1][2].w_bits, cfg.num_layers // per)
    return out


def zamba_traffic(vocab: int):
    """8 greedy requests, prompts of 16-48 tokens, 16 new tokens each."""
    from repro_torch.serving import GenerationRequest
    rng = np.random.default_rng(22)
    return [GenerationRequest(prompt=rng.integers(1, vocab, n).astype(np.int32),
                              max_new_tokens=TOKEN_NEW)
            for n in (16, 48, 24, 40, 32, 20, 44, 28)]


def token_model(dev, art, name: str, calib: tuple, segments: list,
                layers: int = 0) -> tuple:
    """``name`` at full width (``layers`` cuts the depth) under the serve
    CLI's policy (the
    last half of its layers int4; a group takes its first layer's bits),
    bf16 activations: fp params from a seeded generator on the card,
    deployed with ``calib`` calibration batches ((batches, rows, tokens), a
    multiple of the model's chunk), saved under ``art`` and loaded back.
    The plan must prefill in token mode over ``segments``, [(start, end,
    weight bits)] of groups."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.deploy import DeployedModel, ExecutionPlan, deploy
    from repro_torch.models import api

    cfg = get_config(name)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    n = cfg.num_layers
    policy = QuantPolicy(num_layers=n, mode="int", last_k_int4=n // 2)
    plan = ExecutionPlan.build(cfg, policy, backend="cuda")
    if plan.prefill_mode != "token" or \
            [(s, e, sp.w_bits) for s, e, sp in plan.segments] != segments:
        raise AssertionError(f"{name} plan: {plan.describe()}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fp = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    fp_params = sum(int(t.numel()) for t in _leaves(fp))
    nb, rows, S = calib
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(1, cfg.vocab_size, (rows, S)).astype(np.int32)}
               for _ in range(nb)]
    model = deploy(fp, plan, batches, device=dev)
    torch.cuda.synchronize()
    info = {"model": cfg.name, "layers": n, "groups": segments[-1][1],
            "fp_params": fp_params, "deploy_s": time.perf_counter() - t0,
            "policy": policy.describe(), "plan": plan.describe()}
    del fp
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model.save(str(art))
    del model
    model = DeployedModel.load(str(art), device=dev)
    torch.cuda.synchronize()
    if model.plan != plan:
        raise AssertionError(f"{name}: plan did not round-trip through the artifact")
    info.update(save_load_s=time.perf_counter() - t0,
                artifact_bytes=sum(f.stat().st_size for f in art.iterdir()),
                deployed_bytes=sum(t.numel() * t.element_size()
                                   for t in _leaves(model.params)))
    return model, info


def serve_token_mode(model, reqs, per_step=None) -> dict:
    """Serve ``reqs`` on a fresh token-mode engine (``TOKEN_SLOTS`` slots,
    ``TOKEN_MAX_LEN``) with every count at 0 just before: every request
    finishes, every step's logits are finite, and with ``per_step`` every
    step launches exactly that (no prefill forward runs in token mode);
    no plain version on a CUDA tensor."""
    import copy

    import repro_torch.serving.engine as engine_mod
    from repro_torch.kernels import build
    from repro_torch.serving import ServingEngine

    plan = model.plan
    V = plan.cfg.vocab_size
    eng = ServingEngine(model, slots=TOKEN_SLOTS, max_len=TOKEN_MAX_LEN)
    if not eng.token_mode:
        raise AssertionError(f"{plan.describe()}: the engine is not in token mode")
    record, finite = {}, []
    record_forwards(eng, record)
    orig_sample = engine_mod.sample_batch

    def sample(logits, *a):
        finite.append(torch.isfinite(logits[..., :V]).all())
        return orig_sample(logits, *a)
    streams = [eng.submit(copy.deepcopy(r)) for r in reqs]
    engine_mod.sample_batch = sample
    build.reset_counts()
    t0 = time.perf_counter()
    try:
        steps = eng.run_until_drained()
    finally:
        engine_mod.sample_batch = orig_sample
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches, plain = dict(build.LAUNCHES), dict(build.PLAIN_ON_CUDA)
    tag = plan.describe()
    results = [st.result() for st in streams]
    for r, req in zip(results, reqs):
        if r.finish_reason != "length" or len(r.tokens) != req.max_new_tokens:
            raise AssertionError(f"{tag}: request {r.rid} finished {r.finish_reason!r}")
    if not all(bool(f) for f in finite):
        raise AssertionError(f"{tag}: non-finite logits")
    if record["prefill"]:
        raise AssertionError(f"{tag}: token mode ran {len(record['prefill'])} prefill forwards")
    if per_step is not None:
        for step in record["decode"]:
            if {k: step[k] for k in per_step} != per_step:
                raise AssertionError(f"{tag}: a token step launched {step}, "
                                     f"expected {per_step}")
    if any(plain.values()):
        raise AssertionError(f"{tag}: plain versions ran on CUDA tensors: {plain}")
    summary = eng.metrics.summary()
    tokens = int(sum(len(r.tokens) for r in results))
    return {"plan": tag, "requests": len(results), "tokens": tokens,
            "engine_steps": steps, "token_steps": len(record["decode"]),
            "launches_per_step": per_step, "launches": launches,
            "plain_on_cuda": plain, "serve_s": serve_s,
            "step_ms_mean": serve_s * 1e3 / max(len(record["decode"]), 1),
            "decode_p50_ms": summary.get("decode_p50_ms"),
            "tokens_per_s": tokens / serve_s,
            "streams": [list(map(int, r.tokens)) for r in results]}


def first_divergence(a: list, b: list) -> list:
    """Per request: None where two streams are equal, else the first token
    index (a decode step of that request) where they part."""
    out = []
    for x, y in zip(a, b):
        out.append(None if x == y else next(
            (i for i, (p, q) in enumerate(zip(x, y)) if p != q), min(len(x), len(y))))
    return out


def reference_twin(model):
    """The same deployed params under the plain reference backend."""
    from repro_torch.deploy import DeployedModel, ExecutionPlan
    plan = model.plan
    ref = ExecutionPlan.build(plan.cfg, plan.policy, backend="reference",
                              prefill_mode=plan.prefill_mode,
                              decode_dtype=plan.decode_dtype)
    return DeployedModel(plan=ref, params=model.params)


def one_step_calls(model, state, tokens, **inputs) -> dict:
    """One forward under ``GemmSpies`` on ``state``: each integer kernel
    call of a new shape held against its plain version."""
    from repro_torch.models import api
    with torch.no_grad(), GemmSpies() as spies:
        api.forward(model.params, model.plan, state=state, tokens=tokens, **inputs)
    torch.cuda.synchronize()
    return spies.kept


@contextlib.contextmanager
def kernel_attention():
    """Every chunked attention on the flash kernel, whatever the plan's
    backend: a reference plan then differs from the kernel plan only in its
    integer GEMMs' path, which is exact, so the two forwards must agree to
    the bit."""
    from repro_torch.models import attention
    orig = attention.chunked_attention

    def kern(q, k, v, *, causal, chunk, use_kernel):
        return orig(q, k, v, causal=causal, chunk=chunk, use_kernel=True)
    attention.chunked_attention = kern
    try:
        yield
    finally:
        attention.chunked_attention = orig


#: the kernel plan's long-forward logits against the reference plan's (the
#: plain flash version in bf16 blocks of 1024): one bf16 ulp in attention
#: moves activation codes, which the random-weight stack amplifies; the
#: bound catches a broken layer, not noise
ZAMBA_VS_REFERENCE = {"logits_max_diff": 1.0, "argmax_equal_share": 0.98}


def vs_reference_forward(model, inputs: dict, kern_logits) -> dict:
    """The kernel forward's logits against the reference plan's on the card:
    bit-equal when the reference plan's attention runs the flash kernel too,
    and within ``ZAMBA_VS_REFERENCE`` of the plain reference."""
    from repro_torch.models import api
    cfg = model.plan.cfg
    ref = reference_twin(model)
    with torch.no_grad():
        with kernel_attention():
            same = api.forward(model.params, ref.plan, **inputs)[0]
        r = api.forward(model.params, ref.plan, **inputs)[0]
    if not torch.equal(same, kern_logits):
        diff = (same.float() - kern_logits.float()).abs().max().item()
        raise AssertionError(f"{cfg.name}: the reference plan on the flash kernel != the "
                             f"kernel plan (max |diff| {diff}): a GEMM path is not exact")
    cmp = compare_logits(kern_logits, r, cfg.vocab_size)
    del r, same
    torch.cuda.empty_cache()
    lim = ZAMBA_VS_REFERENCE
    if (cmp["logits_max_diff"] > lim["logits_max_diff"]
            or cmp["argmax_equal_share"] < lim["argmax_equal_share"]):
        raise AssertionError(f"{cfg.name}: kernel vs reference plan {cmp} outside {lim}")
    return {"reference_on_flash_kernel_bit_equal": True, "vs_reference_plan": cmp,
            "vs_reference_plan_limit": lim}


def zamba_phase(dev) -> dict:
    """Phase 22: zamba2-2.7b through the token-mode engine (see the module
    docstring)."""
    from repro_torch.models import api

    t0 = time.perf_counter()
    out = {}
    # W8A8 group 0, W4A4 group 1, the shared block at 4 bits
    model, out["deploy"] = token_model(dev, ROOT / "build" / "chip_smoke_zamba2_artifact",
                                       "zamba2-2.7b", ZAMBA_CALIB, [(0, 1, 8), (1, 2, 4)],
                                       layers=ZAMBA_LAYERS)
    cfg = model.plan.cfg
    linears = hybrid_linears(cfg, model.plan.segments)
    per_step = {**dict.fromkeys(SOURCES, 0), **gemm_launches(linears, TOKEN_SLOTS)}
    reqs = zamba_traffic(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    serve = serve_token_mode(model, reqs, per_step)
    serve["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    ref = serve_token_mode(reference_twin(model), reqs)
    parted = first_divergence(serve["streams"], ref["streams"])
    if any(p is not None for p in parted):
        raise AssertionError(f"zamba2: kernel streams part from the reference "
                             f"backend's at steps {parted}")
    out["serve"] = {k: v for k, v in serve.items() if k != "streams"}
    out["reference_serve_s"] = ref["serve_s"]
    out["streams_equal_reference"] = len(parted)
    # each GEMM shape of a token step (M = 4 slots: in_bc N = 128, in_dt
    # N = 80, out_proj K = 5120) bit-equal to its plain version
    st = model.plan.decode_state(TOKEN_SLOTS, 8, device=dev)
    toks = torch.randint(1, cfg.vocab_size, (TOKEN_SLOTS, 1), device=dev)
    out["token_step_calls_bit_equal"] = check_kept_calls(
        one_step_calls(model, st, toks), "zamba2 token step")
    del st
    # one cacheless forward at S = 4096
    inputs = prefill_inputs(cfg, ZAMBA_LONG, dev)
    expected = {**dict.fromkeys(SOURCES, 0), **gemm_launches(linears, ZAMBA_LONG),
                "flash_attention": cfg.num_layers // cfg.attn_every}
    run = long_forward(model, inputs, flash_layers=1, gemms=True, expected=expected)
    tag = f"zamba2 S={ZAMBA_LONG}"
    err = check_layers(run.pop("taken"), tag)
    shapes = check_gemms(run.pop("kept"), tag)
    logits = run.pop("logits")
    out["long_forward"] = {**run, **vs_reference_forward(model, inputs, logits),
                           "layer0_max_abs_err_vs_plain": err,
                           "gemm_shapes_bit_equal": shapes}
    del logits
    out["seconds"] = time.perf_counter() - t0
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- phase 23
SEAMLESS_ROWS, SEAMLESS_SRC, SEAMLESS_NEW = 2, 4096, 16
SEAMLESS_ENC_KERNELS = ("act_quant", "int8_matmul", "flash_attention")
#: the encoder output (LayerNorm'd, |x| about 0.8 on average) against the
#: reference plan's: one bf16 ulp in attention moves W8A8 activation codes;
#: the bound catches a broken layer, not noise
SEAMLESS_VS_REFERENCE = {"max_abs_diff": 2.0, "mean_abs_diff": 0.05}
SEAMLESS_DEC_KERNELS = ("act_quant", "int8_matmul", "int4_matmul", "int4_matmul_fused")


def seamless_step_launches(cfg, segments) -> dict:
    """The launches of one decode step of ``SEAMLESS_ROWS`` rows: per decoder
    layer, self-attention's q, k, v, o, cross-attention's q and o and the
    GELU FFN at those rows (w1 on the fused int4 epilogue in W4A4 layers),
    cross-attention's k and v over the ``SEAMLESS_ROWS x SEAMLESS_SRC``
    encoder rows (recomputed every step, as the JAX package does); no
    attention kernel (the fp cache and the cross-attention are plain)."""
    d, q = cfg.d_model, cfg.num_heads * cfg.hd
    rows, src = {}, {}
    add = lambda tbl, key, n: tbl.__setitem__(key, tbl.get(key, 0) + n)
    for s, e, spec in segments:
        b, n = spec.w_bits, e - s
        fused = b == 4 and spec.fuse_epilogue
        for K, N in ((d, q), (d, q), (d, q), (q, d), (d, q), (q, d), (cfg.d_ff, d)):
            add(rows, (K, N, b, False), n)
        add(rows, (d, cfg.d_ff, b, fused), n)
        add(src, (d, q, b, False), 2 * n)
    a = gemm_launches(rows, SEAMLESS_ROWS)
    c = gemm_launches(src, SEAMLESS_ROWS * SEAMLESS_SRC)
    return {**dict.fromkeys(SOURCES, 0), **{k: a[k] + c[k] for k in a}}


def seamless_model(dev) -> tuple:
    """seamless-m4t-medium at full width and depth (12 + 12 layers, d 1024,
    vocab 256206), W8A8 decoder layers 0-5 and W4A4 6-11, the encoder at the
    first segment's W8A8: fp params from a seeded generator on the card,
    deployed with 2 calibration batches of (2, 32) tokens over (2, 256)
    source frames; not saved."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.deploy import ExecutionPlan, deploy
    from repro_torch.models import api

    cfg = get_config("seamless-m4t-medium")
    n = cfg.dec_layers
    policy = QuantPolicy(num_layers=n, mode="int", last_k_int4=n // 2)
    plan = ExecutionPlan.build(cfg, policy, backend="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fp = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    fp_params = sum(int(t.numel()) for t in _leaves(fp))
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    calib = [{"tokens": rng.integers(1, cfg.vocab_size, (2, 32)).astype(np.int32),
              "src_embeds": torch.randn((2, 256, cfg.d_model), generator=g, device=dev)}
             for _ in range(2)]
    model = deploy(fp, plan, calib, device=dev)
    torch.cuda.synchronize()
    info = {"model": cfg.name, "enc_layers": cfg.enc_layers, "dec_layers": n,
            "fp_params": fp_params, "deploy_s": time.perf_counter() - t0,
            "policy": policy.describe(), "plan": plan.describe(),
            "deployed_bytes": sum(t.numel() * t.element_size()
                                  for t in _leaves(model.params))}
    del fp
    gc.collect()
    torch.cuda.empty_cache()
    return model, info


def seamless_encode(model, src):
    """The encoder over ``src`` with every count at 0 just before: each
    flash call's q, k, v, output and CUDA events kept, each integer kernel
    call of a new shape kept (``GemmSpies``), ``full_attention`` refused.
    Returns (enc_out, launches, plain, kept calls, flash calls, eager
    ms)."""
    from repro_torch.kernels import build, ops
    from repro_torch.models import attention, encdec

    taken, full = [], []
    orig_flash, orig_full = ops.flash_attention, attention.full_attention

    def flash(q, k, v, *, causal):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        o = orig_flash(q, k, v, causal=causal)
        e1.record()
        taken.append((q, k, v, o, causal, e0, e1))
        return o

    def no_full(*a, **kw):
        full.append(1)
        return orig_full(*a, **kw)
    ops.flash_attention, attention.full_attention = flash, no_full
    spies = GemmSpies()
    try:
        torch.cuda.synchronize()
        with spies, torch.no_grad():
            build.reset_counts()
            t0 = time.perf_counter()
            enc = encdec.encode(model.params, model.plan.cfg, model.plan.segments, src)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches, plain = dict(build.LAUNCHES), dict(build.PLAIN_ON_CUDA)
    finally:
        ops.flash_attention, attention.full_attention = orig_flash, orig_full
    if full:
        raise AssertionError(f"seamless encoder: full_attention ran {len(full)} times")
    return enc, launches, plain, spies.kept, taken, ms


def seamless_decode(model, enc_out, steps: int) -> dict:
    """Greedy decode of ``steps`` tokens from token 1 through
    ``api.forward`` over ``api.decode_state`` and ``decode_extra_inputs``
    holding ``enc_out``: the tokens, each step's launches and logits."""
    from repro_torch.kernels import build
    from repro_torch.models import api

    plan, cfg = model.plan, model.plan.cfg
    dev = enc_out.device
    B = enc_out.shape[0]
    st = plan.decode_state(B, steps, device=dev)
    extra = api.decode_extra_inputs(cfg, B, enc_out.shape[1], enc_out.dtype, device=dev)
    extra["enc_out"].copy_(enc_out)
    tok = torch.ones((B, 1), dtype=torch.long, device=dev)
    toks, logits, launches = [], [], []
    build.reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(steps):
            before = dict(build.LAUNCHES)
            lg, st = api.forward(model.params, plan, state=st, tokens=tok, **extra)
            launches.append({k: build.LAUNCHES[k] - before[k] for k in before})
            logits.append(lg[:, -1, :cfg.vocab_size])
            tok = logits[-1].argmax(-1, keepdim=True)
            toks.append(tok)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return {"tokens": torch.cat(toks, 1).cpu().tolist(), "logits": torch.stack(logits),
            "launches": launches, "plain": dict(build.PLAIN_ON_CUDA), "step_ms": ms}


def time_noncausal_flash(dev, calls: int) -> dict:
    """``flash_attention`` alone at the seamless encoder's heads, bf16, not
    causal: against its plain version, timed beside it, SDPA with
    ``is_causal=False`` (timed only) and its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    B, S, H, dh = SEAMLESS_ROWS, SEAMLESS_SRC, 16, 64
    q, k, v = flash_inputs(dev, torch.Generator(device=dev).manual_seed(23),
                           B, S, H, H, dh, torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kern = lambda: fa.flash_attention_cuda(q, k, v, causal=False)
    plain = lambda: fa.flash_attention_plain(q, k, v, causal=False, bq=1024, bk=1024)
    err = decode_close(kern(), plain(), f"flash_attention {(B, S, H, H, dh)} bf16 "
                       "non-causal", rtol=1e-5)
    timer = lambda fn: cuda_ms(fn, samples=10, reps=3)
    b_ms, b_by = bound(fa.bound_bytes(B, S, H, H, dh, 2), fa.bound_flops(B, S, H, dh, False),
                       BF16_OPS_PER_S)
    row = {"kernel": "flash_attention", "model": "seamless-m4t-medium", "M": S,
           "shape": [B, S, H, H, dh], "causal": False, "kv_bits": None, "calls": 0,
           "calls_per_encoder_forward": calls,
           "per": "seamless-m4t-medium encoder layer, 2 x 4096 frames (bf16, not causal)",
           "ms": timer(kern), "eager_ms": cuda_ms(kern, samples=10, reps=3, graph=False),
           "max_abs_err": err, "plain_ms": timer(plain),
           "library_ms": timer(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=False)),
           "library_note": "scaled_dot_product_attention(is_causal=False) on the same "
                           "bf16 tensors",
           "bound_ms": b_ms, "bound_by": b_by}
    row["vs_library"] = row["ms"] / row["library_ms"]
    return row


def seamless_phase(dev) -> dict:
    """Phase 23: seamless-m4t-medium's encoder on the non-causal flash
    kernel and its decoder through ``api.forward`` (see the module
    docstring)."""
    from repro_torch.deploy import DeployedModel, ExecutionPlan
    from repro_torch.models import api, encdec
    from repro_torch.serving import ServingEngine

    t0 = time.perf_counter()
    out = {}
    model, out["deploy"] = seamless_model(dev)
    cfg = model.plan.cfg
    try:
        ServingEngine(model, slots=2, max_len=64)
        raise AssertionError("seamless: the engine served an encoder-decoder plan")
    except ValueError as e:
        if "cannot serve an encoder-decoder plan" not in str(e):
            raise
        out["engine_refusal"] = str(e)
    src = (torch.randn((SEAMLESS_ROWS, SEAMLESS_SRC, cfg.d_model),
                       generator=torch.Generator(device=dev).manual_seed(23), device=dev)
           ).to(torch.bfloat16)
    enc, launches, plain, kept, taken, ms = seamless_encode(model, src)
    d, q = cfg.d_model, cfg.num_heads * cfg.hd
    enc_linears: dict = {}    # q, k, v, o and the GELU FFN, W8A8, each layer
    for K, N in ((d, q), (d, q), (d, q), (q, d), (d, cfg.d_ff), (cfg.d_ff, d)):
        enc_linears[(K, N, 8, False)] = enc_linears.get((K, N, 8, False), 0) + cfg.enc_layers
    expected = {**dict.fromkeys(SOURCES, 0),
                **gemm_launches(enc_linears, SEAMLESS_ROWS * SEAMLESS_SRC),
                "flash_attention": cfg.enc_layers}
    if launches != expected:
        raise AssertionError(f"seamless encoder launched {launches}, expected {expected}")
    if any(plain.values()):
        raise AssertionError(f"seamless encoder: plain versions on CUDA tensors: {plain}")
    flash_err, flash_ms = 0.0, 0.0
    from repro_torch.kernels.flash_attention import flash_attention_plain
    for i, (qq, kk, vv, o, causal, e0, e1) in enumerate(taken):
        if causal:
            raise AssertionError(f"seamless encoder layer {i}: flash ran causal")
        want = flash_attention_plain(qq, kk, vv, causal=False, bq=1024, bk=1024)
        flash_err = max(flash_err, decode_close(o, want, f"seamless encoder layer {i}: "
                                                "flash_attention (non-causal)", rtol=1e-5))
        flash_ms += e0.elapsed_time(e1)
    del taken
    enc_calls = check_kept_calls(kept, "seamless encoder")
    if any(c[0] != "act_quant" and c[2] != "torch.int8" for c in enc_calls):
        raise AssertionError(f"seamless encoder: a GEMM quantized inside: {enc_calls}")
    # the whole encoder against the reference plan on the card: bit-equal
    # with the reference's attention on the flash kernel too, and within
    # SEAMLESS_VS_REFERENCE of the plain reference
    ref = reference_twin(model)
    with torch.no_grad():
        with kernel_attention():
            enc_same = encdec.encode(model.params, cfg, ref.plan.segments, src)
        enc_ref = encdec.encode(model.params, cfg, ref.plan.segments, src)
    if not torch.equal(enc_same, enc):
        diff = (enc_same.float() - enc.float()).abs().max().item()
        raise AssertionError(f"seamless encoder: the reference plan on the flash kernel != "
                             f"the kernel plan (max |diff| {diff})")
    del enc_same
    d_abs = (enc.float() - enc_ref.float()).abs()
    enc_cmp = {"max_abs_diff": d_abs.max().item(), "mean_abs_diff": d_abs.mean().item(),
               "ref_abs_mean": enc_ref.float().abs().mean().item()}
    del d_abs
    enc_limit = SEAMLESS_VS_REFERENCE
    if any(enc_cmp[k] > enc_limit[k] for k in enc_limit) or not bool(torch.isfinite(enc).all()):
        raise AssertionError(f"seamless encoder: kernel vs reference plan {enc_cmp} outside "
                             f"{enc_limit}")
    out["encoder"] = {"S_src": SEAMLESS_SRC, "rows": SEAMLESS_ROWS, "eager_ms": ms,
                      "launches": launches, "plain_on_cuda": plain,
                      "flash_calls": cfg.enc_layers, "flash_device_ms": flash_ms,
                      "flash_max_abs_err_vs_plain": flash_err,
                      "gemm_shapes_bit_equal": enc_calls,
                      "reference_on_flash_kernel_bit_equal": True,
                      "vs_reference_plan": enc_cmp, "vs_reference_plan_limit": enc_limit}
    # decode: the served (fused) plan over its own encoder output, and the
    # reference backend over its own; then the kernels without the fused
    # epilogue and the reference backend over the SAME encoder output, which
    # must agree to the bit (integer GEMMs exact, attention plain on both)
    kern = seamless_decode(model, enc, SEAMLESS_NEW)
    refd = seamless_decode(ref, enc_ref, SEAMLESS_NEW)
    unfused = DeployedModel(plan=ExecutionPlan.build(
        cfg, model.plan.policy, backend="cuda", fuse_epilogue=False), params=model.params)
    kern_nf = seamless_decode(unfused, enc, SEAMLESS_NEW)
    ref_same = seamless_decode(ref, enc, SEAMLESS_NEW)
    if not torch.equal(kern_nf["logits"], ref_same["logits"]):
        diff = (kern_nf["logits"].float() - ref_same["logits"].float()).abs().max().item()
        raise AssertionError(f"seamless decode: unfused kernels != reference backend on "
                             f"the same encoder output (max |diff| {diff})")
    V = cfg.vocab_size
    if not bool(torch.isfinite(kern["logits"]).all()):
        raise AssertionError("seamless decode: non-finite logits")
    per_step = seamless_step_launches(cfg, model.plan.segments)
    for step in kern["launches"]:
        if step != per_step:
            raise AssertionError(f"seamless decode step launched {step}, expected {per_step}")
    if any(kern["plain"].values()):
        raise AssertionError(f"seamless decode: plain versions on CUDA tensors: {kern['plain']}")
    st = model.plan.decode_state(SEAMLESS_ROWS, 4, device=dev)
    extra = api.decode_extra_inputs(cfg, SEAMLESS_ROWS, SEAMLESS_SRC, enc.dtype, device=dev)
    extra["enc_out"].copy_(enc)
    dec_calls = check_kept_calls(one_step_calls(
        model, st, torch.ones((SEAMLESS_ROWS, 1), dtype=torch.long, device=dev), **extra),
        "seamless decode step")
    agree = sum(a == b for ra, rb in zip(kern["tokens"], refd["tokens"])
                for a, b in zip(ra, rb))
    out["decode"] = {"steps": SEAMLESS_NEW, "rows": SEAMLESS_ROWS,
                     "step_ms": kern["step_ms"], "reference_step_ms": refd["step_ms"],
                     "launches_per_step": kern["launches"][-1],
                     "launches": {k: sum(s[k] for s in kern["launches"])
                                  for k in kern["launches"][0]},
                     "tokens": kern["tokens"], "reference_tokens": refd["tokens"],
                     "greedy_agreement_with_reference": agree / (SEAMLESS_NEW * SEAMLESS_ROWS),
                     "unfused_equals_reference_on_same_encoder_output": True,
                     "gemm_calls_bit_equal": dec_calls}
    out["noncausal_flash_row"] = time_noncausal_flash(dev, cfg.enc_layers)
    out["seconds"] = time.perf_counter() - t0
    del model, enc, enc_ref, kern, refd, kern_nf, ref_same
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- phase 24
#: the request past max_len: a 16-token prompt and 500 new tokens (516 >
#: 512), which the engine admits and finishes for xLSTM, as JAX's does
XLSTM_PAST = (16, 500)
XLSTM_LONG = 1024
#: xlstm-1.3b's depth on the card: 16 of its 48 layers (2 groups), for the
#: script's time: at full depth, with the request above, this phase took
#: 163.0 s on an H100 80GB HBM3 at 700 W, at 24 layers 88.1-112.6 s, most
#: of it the request's 516 token steps on both backends
XLSTM_LAYERS = 16
#: a token step's GEMMs at that depth: act_quant, int8, int4 (37 a group)
XLSTM_STEP = (0, 37, 37)
#: calibration batches: (batches, rows, tokens), a multiple of the mLSTM
#: chunk (256)
XLSTM_CALIB = (2, 1, 256)
#: training: (rows, tokens, steps) on the first group (8 layers)
XLSTM_TRAIN = (2, 256, 2)
XLSTM_TRAIN_LAYERS = 8


def xlstm_linears(cfg, segments) -> dict:
    """The quantized linears of one xLSTM forward under ``segments`` (group
    granularity): each mLSTM layer's up (N = 2 x di), wq, wk, wv (di x di)
    and down (K = di) and each sLSTM layer's w_in (N = 4d) and down (d x
    d), at the group's bits. (K, N, bits, fused) -> calls."""
    d, di, per = cfg.d_model, cfg.ssm_expand * cfg.d_model, cfg.slstm_every
    out: dict = {}

    def add(K, N, bits, n):
        out[(K, N, bits, False)] = out.get((K, N, bits, False), 0) + n
    for s, e, spec in segments:
        for K, N in ((d, 2 * di), (di, di), (di, di), (di, di), (di, d)):
            add(K, N, spec.w_bits, (e - s) * (per - 1))
        for K, N in ((d, 4 * d), (d, d)):
            add(K, N, spec.w_bits, e - s)
    return out


def xlstm_traffic(vocab: int):
    """The request past max_len first, then 8 greedy requests of 16-48
    prompt tokens and 16 new tokens each."""
    from repro_torch.serving import GenerationRequest
    rng = np.random.default_rng(24)
    first = GenerationRequest(prompt=rng.integers(1, vocab, XLSTM_PAST[0]).astype(np.int32),
                              max_new_tokens=XLSTM_PAST[1])
    return [first] + [GenerationRequest(prompt=rng.integers(1, vocab, n).astype(np.int32),
                                        max_new_tokens=TOKEN_NEW)
                      for n in (16, 48, 24, 40, 32, 20, 44, 28)]


def xlstm_step_times(model, dev) -> dict:
    """One token step of ``TOKEN_SLOTS`` rows on a fixed decode state: eager
    and replayed from a CUDA graph (device time), between CUDA events."""
    from repro_torch.models import api
    st = model.plan.decode_state(TOKEN_SLOTS, 8, device=dev)
    toks = torch.randint(1, model.plan.cfg.vocab_size, (TOKEN_SLOTS, 1), device=dev)

    def step():
        with torch.no_grad():
            api.forward(model.params, model.plan, state=st, tokens=toks)
    eager = cuda_ms(step, samples=5, reps=2, graph=False)
    device = cuda_ms(step, samples=5, reps=2)
    state_bytes = sum(t.numel() * t.element_size() for t in _leaves(st))
    del st
    return {"eager_ms": eager, "device_ms": device,
            "device_idle_share_eager": 1.0 - device / eager,
            "state_bytes": state_bytes, "slots": TOKEN_SLOTS}


def xlstm_train(dev) -> dict:
    """xlstm-1.3b at full width cut to its first group (``XLSTM_TRAIN_LAYERS``
    layers: 7 mLSTM + 1 sLSTM), fake-quant W4A4 under an fp teacher of the
    same cut, ``XLSTM_TRAIN`` steps of hidden-state distillation through
    ``launch.train.build_train_step``: every loss finite, the value part 0
    (the xLSTM's taps hold no attention), each step's eager ms and the peak
    device memory."""
    from repro_torch.configs import TrainHParams, get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.deploy import ExecutionPlan
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.optim import adam_init

    cfg = get_config("xlstm-1.3b").replace(num_layers=XLSTM_TRAIN_LAYERS)
    n = cfg.num_layers
    rows, S, n_steps = XLSTM_TRAIN
    plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=n, mode="fake", last_k_int4=n))
    if [(sp.w_bits, sp.a_bits) for _, _, sp in plan.segments] != [(4, 4)]:
        raise AssertionError(f"xlstm train plan: {plan.describe()}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    student = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    teacher = api.init_model(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    step = train.build_train_step(plan, TrainHParams(total_steps=n_steps), teacher=teacher,
                                  teacher_plan=ExecutionPlan.build(cfg, None))
    opt = adam_init(student)
    rng = np.random.default_rng(24)
    steps = []
    build.reset_counts()
    for _ in range(n_steps):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (rows, S + 1)), device=dev)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        student, opt, parts = step(student, opt, batch)
        torch.cuda.synchronize()
        steps.append({"eager_ms": 1e3 * (time.perf_counter() - t0),
                      **{k: float(v) for k, v in parts.items()}})
    if not all(np.isfinite(v) for s in steps for v in s.values()):
        raise AssertionError(f"xlstm train: non-finite losses {steps}")
    if any(s["loss/value"] != 0.0 or s["loss/attention"] <= 0.0 for s in steps):
        raise AssertionError(f"xlstm train: not the hidden-state loss {steps}")
    n_params = sum(int(t.numel()) for t in _leaves(student))
    out = {"layers": n, "plan": plan.describe(), "rows": rows, "tokens": S,
           "params": n_params, "steps": steps,
           "step_eager_ms": [s["eager_ms"] for s in steps],
           "launches": dict(build.LAUNCHES), "plain_on_cuda": dict(build.PLAIN_ON_CUDA),
           "resident_before_bytes": resident,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del student, teacher, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def xlstm_phase(dev) -> dict:
    """Phase 24: xlstm-1.3b served in token mode, one cacheless forward of
    1024 tokens and two training steps (see the module docstring)."""
    t0 = time.perf_counter()
    out = {}
    model, out["deploy"] = token_model(dev, ROOT / "build" / "chip_smoke_xlstm_artifact",
                                       "xlstm-1.3b", XLSTM_CALIB, [(0, 1, 8), (1, 2, 4)],
                                       layers=XLSTM_LAYERS)
    cfg = model.plan.cfg
    linears = xlstm_linears(cfg, model.plan.segments)
    per_step = {**dict.fromkeys(SOURCES, 0), **gemm_launches(linears, TOKEN_SLOTS)}
    if (per_step["act_quant"], per_step["int8_matmul"], per_step["int4_matmul"]) \
            != XLSTM_STEP:
        raise AssertionError(f"xlstm: a token step's planned launches {per_step}")
    # each GEMM shape of a token step (M = 4, split-K) bit-equal to its plain
    # version, on a fresh state
    st = model.plan.decode_state(TOKEN_SLOTS, 8, device=dev)
    toks = torch.randint(1, cfg.vocab_size, (TOKEN_SLOTS, 1), device=dev)
    out["token_step_calls_bit_equal"] = check_kept_calls(
        one_step_calls(model, st, toks), "xlstm token step")
    del st
    reqs = xlstm_traffic(cfg.vocab_size)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    serve = serve_token_mode(model, reqs, per_step)
    serve["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    ref = serve_token_mode(reference_twin(model), reqs)
    parted = first_divergence(serve["streams"], ref["streams"])
    if any(p is not None for p in parted):
        raise AssertionError(f"xlstm: kernel streams part from the reference "
                             f"backend's at steps {parted}")
    out["serve"] = {k: v for k, v in serve.items() if k != "streams"}
    out["past_max_len"] = {"prompt": XLSTM_PAST[0], "new_tokens": XLSTM_PAST[1],
                           "max_len": TOKEN_MAX_LEN,
                           "tokens_served": len(serve["streams"][0])}
    out["reference_serve_s"] = ref["serve_s"]
    out["reference_step_ms_mean"] = ref["step_ms_mean"]
    out["streams_equal_reference"] = len(parted)
    out["token_step"] = xlstm_step_times(model, dev)
    # one cacheless forward of 1024 tokens: every GEMM behind act_quant
    inputs = prefill_inputs(cfg, XLSTM_LONG, dev)
    expected = {**dict.fromkeys(SOURCES, 0), **gemm_launches(linears, XLSTM_LONG)}
    run = long_forward(model, inputs, gemms=True, expected=expected)
    tag = f"xlstm S={XLSTM_LONG}"
    shapes = check_gemms(run.pop("kept"), tag)
    run.pop("taken")
    logits = run.pop("logits")
    from repro_torch.models import api
    with torch.no_grad():
        ref_logits = api.forward(model.params, reference_twin(model).plan, **inputs)[0]
    if not torch.equal(ref_logits, logits):
        diff = (ref_logits.float() - logits.float()).abs().max().item()
        raise AssertionError(f"{tag}: kernel plan != reference plan (max |diff| {diff})")
    out["long_forward"] = {**run, "logits_bit_equal_reference": True,
                           "gemm_shapes_bit_equal": shapes}
    del logits, ref_logits, model
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = xlstm_train(dev)
    out["seconds"] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------- phase 25
#: a fused decode step (8 rows): four GEMMs a layer (wqkv, wo, w13, w2), all
#: split-K; ``fused_serving`` checks it against ``gemm_launches``
FUSED_DECODE_STEP = {"act_quant": 0, "int8_matmul": 64, "int4_matmul": 64,
                     "decode_attention": 32}
#: phase 25 (b): one gradient of the train CLI's stablelm-3b (phase 19's
#: batch of 8 x 128) with ``remat`` off and on: the losses bit-equal and each
#: gradient leaf within this share of its largest |g| (a backward kernel's
#: atomics may order a sum differently between two runs)
REMAT_GRAD_RTOL = 1e-5
#: phase 25 (c): the dry-run cells run on the card's host (meta device)
DRYRUN_CELLS = (("stablelm-3b", "decode_32k"), ("xlstm-1.3b", "long_500k"))


def fused_linears(cfg) -> dict:
    """The quantized linears of one forward of a ``fused_proj`` decoder under
    the serve CLI's policy: (K, N, weight bits, fused) -> calls; wqkv, wo,
    w13 and w2, one GEMM each."""
    d, q, kv = cfg.d_model, cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
    out: dict = {}
    for bits in (8, 4):
        for K, N in ((d, q + 2 * kv), (q, d), (d, 2 * cfg.d_ff), (cfg.d_ff, d)):
            key = (K, N, bits, False)
            out[key] = out.get(key, 0) + cfg.num_layers // 2
    return out


def card_clocks() -> str:
    """The card's SM clock, power draw and temperature now (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def step_times(model, dev) -> dict:
    """One decode step of ``model`` (8 slots at cache length 448), eager and
    replayed from a CUDA graph, as phase 7 times it."""
    from repro_torch.models import api
    st = decode_state_at(model, dev, DECODE_LEN)
    toks = torch.randint(1, model.plan.cfg.vocab_size, (DECODE_SLOTS, 1), device=dev)

    def step():
        with torch.no_grad():
            return api.forward(model.params, model.plan, state=st, tokens=toks)[0]
    eager = cuda_ms(step, reps=1, samples=10, graph=False)
    device = cuda_ms(step, reps=1, samples=10)
    return {"eager_ms": eager, "device_ms": device,
            "device_idle_share_eager": 1.0 - device / eager}


def fused_serving(dev, dense_streams: list, dense_step: dict) -> tuple:
    """Phase 25 (a): phase 6's fp params fused (wq | wk | wv -> wqkv, w1 | w3
    -> w13), deployed under phase 6's policy and calibration, saved, loaded
    and served at kv8 on phase 6's traffic. Returns (report, model)."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.deploy import DeployedModel, ExecutionPlan, deploy
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.models.transformer import fuse_projections

    base = get_config("stablelm-3b")
    cfg = base.replace(fused_proj=True)
    n = cfg.num_layers
    policy = QuantPolicy(num_layers=n, mode="int", last_k_int4=n // 2)
    linears = fused_linears(cfg)
    step_table = {**gemm_launches(linears, DECODE_SLOTS), "decode_attention": n}
    if {k: step_table[k] for k in FUSED_DECODE_STEP} != FUSED_DECODE_STEP:
        raise AssertionError(f"FUSED_DECODE_STEP {FUSED_DECODE_STEP} != the plan's "
                             f"{step_table}")
    plan = ExecutionPlan.build(cfg, policy, backend="cuda", mode="decode", kv_bits=8,
                               prefill_batch=4)
    t0 = time.perf_counter()
    fp = fuse_projections(api.init_model(base, torch.Generator(device=dev).manual_seed(0),
                                         dev))
    rng = np.random.default_rng(0)
    calib = [{"tokens": rng.integers(1, cfg.vocab_size, (4, 32)).astype(np.int32)}
             for _ in range(4)]
    model = deploy(fp, plan, calib, device=dev)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    del fp
    gc.collect()
    torch.cuda.empty_cache()
    art = ROOT / "build" / "chip_smoke_fused_artifact"
    t0 = time.perf_counter()
    model.save(str(art))
    del model
    model = DeployedModel.load(str(art), device=dev)
    torch.cuda.synchronize()
    save_load_s = time.perf_counter() - t0
    art_bytes = sum(f.stat().st_size for f in art.iterdir())
    shutil.rmtree(art, ignore_errors=True)
    if model.plan != plan:
        raise AssertionError("fused plan did not round-trip through the artifact")
    record = {}
    build.reset_counts()
    t0 = time.perf_counter()
    with GemmSpies() as spies:
        _, results = serve_decode(model, launches=record)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    planned = check_launches("fused kv8", record, FUSED_DECODE_STEP, linears)
    shapes = check_kept_calls(spies.kept, "fused kv8")
    new_shapes = sorted({(s[3][0], s[3][1]) for s in shapes if s[0] != "act_quant"})
    for K, N in ((cfg.d_model, (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.hd),
                 (cfg.d_model, 2 * cfg.d_ff)):
        if (K, N) not in new_shapes:
            raise AssertionError(f"fused kv8: no call of the ({K}, {N}) GEMM was checked")
    streams = [list(map(int, r.tokens)) for r in results]
    parted = first_divergence(streams, dense_streams)
    return {"model": cfg.name, "plan": plan.describe(), "deploy_s": deploy_s,
            "save_load_s": save_load_s, "artifact_bytes": art_bytes,
            "requests": len(results), "tokens": int(sum(len(s) for s in streams)),
            "decode_steps": len(record["decode"]),
            "prefill_forwards": len(record["prefill"]),
            "launches": launches, "act_quant_planned": planned,
            "per_decode_step": FUSED_DECODE_STEP, "gemm_calls_bit_equal": shapes,
            "streams_equal_unfused": sum(p is None for p in parted),
            "streams_first_parted_token": parted, "serve_s": serve_s,
            "decode_step_kv8_unfused_phase7": dense_step}, model


def remat_train(dev) -> dict:
    """Phase 25 (b): one loss and gradient of the train CLI's stablelm-3b
    (fake quant W8A8 + W4A4, phase 19's synthetic batch of 8 x 128) with
    ``remat`` off and on: eager ms and peak memory of each."""
    from repro_torch.configs import TrainHParams, get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.tree import tree_leaves_with_path
    from repro_torch.data import SyntheticLM
    from repro_torch.deploy import ExecutionPlan
    from repro_torch.launch.train import build_train_step
    from repro_torch.models import api
    from repro_torch.optim import value_and_grad

    cfg = get_config("stablelm-3b")
    n = cfg.num_layers
    policy = QuantPolicy(num_layers=n, mode="fake", last_k_int4=n // 2)
    batch = SyntheticLM(cfg.vocab_size, 128, 8).batch(0)
    params = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    runs, grads, losses = {}, {}, {}
    for remat in (False, False, True):      # the first a warm-up
        plan = ExecutionPlan.build(cfg.replace(remat=remat), policy)
        loss_fn = build_train_step(plan, TrainHParams(total_steps=3)).loss_fn
        grads.pop(remat, None)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, _, g = value_and_grad(loss_fn, params, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        losses[remat], grads[remat] = loss, dict(tree_leaves_with_path(g))
        runs[f"remat_{'on' if remat else 'off'}"] = {
            "eager_ms": ms, "loss": loss.item(), "resident_gb": resident / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_over_resident_gb": (torch.cuda.max_memory_allocated() - resident) / 1e9}
        del g
    if not torch.equal(losses[False], losses[True]):
        raise AssertionError(f"remat: losses differ {losses[False].item()} "
                             f"{losses[True].item()}")
    worst, equal = 0.0, 0
    for path, a in grads[False].items():
        b = grads[True][path]
        equal += int(torch.equal(a, b))
        scale = a.abs().max().item() or 1.0
        worst = max(worst, (a - b).abs().max().item() / scale)
    if worst > REMAT_GRAD_RTOL:
        raise AssertionError(f"remat: gradients differ by {worst} of a leaf's largest")
    leaves = len(grads[False])
    del grads, params
    gc.collect()
    torch.cuda.empty_cache()
    return {**runs, "losses_bit_equal": True, "grad_leaves": leaves,
            "grad_leaves_bit_equal": equal, "grad_max_rel_diff": worst,
            "grad_rtol": REMAT_GRAD_RTOL}


def _to_meta(tree):
    from repro_torch.core.tree import tree_map
    return tree_map(lambda t: t.to("meta") if isinstance(t, torch.Tensor) else t, tree)


def predicted_vs_card(tag: str, step, args: tuple, dev) -> dict:
    """``op_analysis`` of ``step(*args)`` on meta copies of ``args`` beside
    one eager call on the card: the predicted launches must equal the
    counted ones; the predicted bytes, FLOPs, the bound they give and the
    predicted memory are printed beside the graphed device time and the
    measured peak."""
    from repro_torch.benchmarks.timing import BF16_OPS_PER_S
    from repro_torch.kernels import build
    from repro_torch.launch.op_analysis import analyze, storage_bytes

    meta = _to_meta(args)
    pred = analyze(step, *meta)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    build.reset_counts()
    out = step(*args)
    torch.cuda.synchronize()
    counted = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - resident
    del out
    if pred["launches"] != {k: counted[k] for k in pred["launches"]}:
        raise AssertionError(f"{tag}: predicted launches {pred['launches']} != "
                             f"counted {counted}")
    graphed = cuda_ms(lambda: step(*args), reps=1, samples=10)
    b_ms, b_by = bound(pred["hbm_bytes"], (pred["int_flops"], pred["float_flops"]),
                       (INT8_OPS_PER_S, BF16_OPS_PER_S))
    kb = sum(k["bytes"] for k in pred["kernels"].values())
    kf = sum(k["dot_flops"] for k in pred["kernels"].values())
    k_ms, k_by = bound(kb, kf, INT8_OPS_PER_S)
    return {"launches": counted, "predicted_launches_equal": True,
            "predicted": {k: pred[k] for k in ("flops", "int_flops", "float_flops",
                                               "hbm_bytes", "torch_ops")},
            "bound_ms": b_ms, "bound_by": b_by,
            "kernels_bytes": kb, "kernels_bound_ms": k_ms, "kernels_bound_by": k_by,
            "graphed_device_ms": graphed,
            "argument_bytes_predicted": storage_bytes(*meta),
            "argument_bytes_on_card": storage_bytes(*args),
            "temp_bytes_predicted": pred["temp_bytes"],
            "temp_bytes_measured_peak": peak}


def analysis_vs_card(dev, models: dict) -> dict:
    """Phase 25 (c): the step analysis against the card, on phase 6's kv8
    decode step (8 slots at 448), the fused one and phase 3's 32 x 128
    encoder forward; then the dry run's cells ``DRYRUN_CELLS``."""
    from repro_torch.deploy import DeployedModel
    from repro_torch.launch import dryrun
    from repro_torch.models import api
    from repro_torch.serving import ServingEngine

    def decode_step(params, st, toks, plan):
        with torch.no_grad():
            return api.forward(params, plan, state=st, tokens=toks)[0]

    out = {}
    for tag, model in models.items():
        st = decode_state_at(model, dev, DECODE_LEN)
        toks = torch.randint(1, model.plan.cfg.vocab_size, (DECODE_SLOTS, 1), device=dev)
        out[tag] = predicted_vs_card(
            tag, lambda p, s, t, plan=model.plan: decode_step(p, s, t, plan),
            (model.params, st, toks), dev)
        del st
    enc = DeployedModel.load(str(ROOT / "build" / "chip_smoke_artifact"), device=dev)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        1, enc.plan.cfg.vocab_size, (32, 128)), device=dev)
    lens = torch.full((32,), 128, dtype=torch.int32, device=dev)

    def encode(params, toks, lens):
        return ServingEngine(DeployedModel(plan=enc.plan, params=params), slots=8,
                             max_len=128).encode_batch(toks, lens)["embed"]
    out["encoder_32x128"] = predicted_vs_card("encoder 32x128", encode,
                                              (enc.params, toks, lens), dev)
    del enc
    cells = {}
    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        r = dryrun.run_cell(arch, shape, "single", str(ROOT / "chiprun_out" / "dryrun_torch"))
        if r["status"] != "ok":
            raise AssertionError(f"dry run {arch} {shape}: {r}")
        cells[f"{arch}__{shape}"] = {**r, "seconds": time.perf_counter() - t0}
    out["dryrun_cells"] = cells
    return out


def fused_remat_analysis_phase(dev, dense_streams: list, dense_step: dict) -> dict:
    """Phase 25: fused projections served through the integer kernels,
    ``remat`` in training, and the step analysis against the card (see the
    module docstring). Phase 6's kv8 artifact is reloaded from ``build/``."""
    from repro_torch.deploy import DeployedModel
    t0 = time.perf_counter()
    fused, fused_model = fused_serving(dev, dense_streams, dense_step)
    dense_model = DeployedModel.load(str(ROOT / "build" / "chip_smoke_decode_artifact"),
                                     device=dev)
    # the unfused and the fused step in turns, on one card in one window
    turns = []
    for tag, model in (("unfused", dense_model), ("fused", fused_model),
                       ("fused", fused_model), ("unfused", dense_model)):
        turns.append({"step": tag, "clocks_before": card_clocks(),
                      **step_times(model, dev)})
    fused["decode_step_kv8_in_turns"] = turns
    analysis = analysis_vs_card(dev, {"decode_kv8": dense_model,
                                      "decode_kv8_fused": fused_model})
    del fused_model, dense_model
    gc.collect()
    torch.cuda.empty_cache()
    remat = remat_train(dev)
    return {"fused": fused, "remat": remat, "analysis": analysis,
            "seconds": time.perf_counter() - t0}


#: phase 26: stablelm-3b at full width cut to 2 layers (4 until PR 30: cut
#: for the script's time), a batch past the chunk threshold (2048), fake
#: quant with ``remat`` on
SHARD_LAYERS = 2
SHARD_BATCH = (2, 4096)
#: the CPU tests' hyperparameters (tests/test_torch_sharded_train.py):
#: lr 1e-3 for the weights, so each weight's first step (+-lr) stands far
#: above its float32 rounding
SHARD_HP = dict(total_steps=10, lr_weights=1e-3)
#: the activation scales' calibration batch: row 0's first 512 tokens
SHARD_CALIB_TOKENS = 512
#: the references: (quantized, activation dtype) -> gates (the loss's
#: rtol, each first-Adam-moment leaf's ||delta|| / ||m||, each Adam-step
#: leaf's ||delta|| / ||step||; None: not held), the CPU tests' where held
#: (tests/test_torch_sharded_train.py says why each). "wa": fake quant of
#: weights and activations, the slice's QAT. "w": of the weights only.
#: With its activations quantized a calibrated step at full width is
#: chaotic in its rounding: an activation code that a changed float sum
#: flips moves its token's later codes too, and a first-moment leaf moves
#: as far as a fault moves it (0.30 of ``lm_head`` from the embedding
#: table scaled by 1 + 1.2e-7, on the card). So that step is held by its
#: loss; the weight-only step, whose codes no sum decides, is held leaf by
#: leaf
SHARD_REFS = {("wa", "float32"): (1e-5, None, None),
              ("wa", "bfloat16"): (1e-3, None, None),
              ("w", "float32"): (1e-5, 1e-4, 1e-2)}
#: (name, data, model, fsdp, attn_seq_shard, quantized, dtype): 2 ranks
#: sharing the one card over gloo (NCCL refuses two ranks on one card)
SHARD_LAYOUTS = (("model2_seq_shard", 1, 2, False, True, "wa", "float32"),
                 ("data2_fsdp", 2, 1, True, False, "wa", "float32"),
                 ("model2_bf16", 1, 2, False, False, "wa", "bfloat16"),
                 ("model2_seq_shard_wonly", 1, 2, False, True, "w", "float32"),
                 ("data2_fsdp_wonly", 2, 1, True, False, "w", "float32"))
#: each gate is the larger of its CPU gate and SHARD_NOISE_MARGIN times the
#: unsharded step's own noise: the largest distance from it of the same
#: step run from the embedding table scaled by 1 + k e, e about one unit
#: roundoff of the dtype, for each k of its SHARD_TWINS (the weight-only
#: step's noise is rounding alone)
SHARD_TWIN_EPS = {"float32": 1.2e-7, "bfloat16": 3.9e-3}
SHARD_TWINS = {("wa", "float32"): (1, -1, 2, -2), ("wa", "bfloat16"): (1, -1),
               ("w", "float32"): (1,)}
SHARD_NOISE_MARGIN = 4
#: a held first-moment or step gate past this could not tell a fault from
#: that noise (a skipped update, a gradient summed onto the wrong FSDP rank
#: read 1.0 to 1.6 in the CPU tests): the phase fails
SHARD_GATE_CAP = 0.5
#: a first-moment leaf below this of the whole tree's norm is rounding
#: residue (a key bias's exact gradient is 0): it must be residue in both
#: runs, and its step is not held
SHARD_RESIDUE = 1e-8
SHARD_DRYRUN = ({}, {"fsdp": True}, {"attn_seq_shard": True})
EXAMPLES = ("torch_quickstart", "torch_serve_int4", "torch_serve_sharded",
            "torch_train_qat_distill")


def shard_config(dtype: str = "float32", layers: int = SHARD_LAYERS):
    """Phase 26's model: stablelm-3b at full width, cut to ``layers``, in
    ``dtype`` activations."""
    from repro_torch.configs import get_config
    return get_config("stablelm-3b").replace(num_layers=layers, dtype=dtype)


def shard_batch(cfg, batch_shape) -> dict:
    B, S = batch_shape
    toks = np.random.default_rng(26).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def shard_policy(cfg, quantized: str = "wa"):
    """W8A8 layers 0-1 / W4A4 2-3 ("wa"), or those weights with the
    activations left unquantized ("w")."""
    from repro_torch.core.policy import QuantPolicy
    n = cfg.num_layers
    return QuantPolicy(num_layers=n, mode="fake", last_k_int4=n // 2,
                       act_bits_override=0 if quantized == "w" else None)


def shard_params(cfg, batch: dict, dev):
    """fp params from a seeded generator on ``dev``, calibrated as training
    is (weight scales absmax / l_max, activation scales on row 0's first
    ``SHARD_CALIB_TOKENS``): at the scales' init of 1 every weight
    quantizes to 0 and no block weight gets a gradient."""
    from repro_torch.core import qat
    from repro_torch.deploy import ExecutionPlan
    from repro_torch.models import api
    policy = shard_policy(cfg)
    params = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    params = qat.calibrate_weight_scales(params, qat.default_bits_fn(cfg, policy))
    fp_plan = ExecutionPlan.build(cfg, None)
    fwd = lambda p, b: api.forward(p, fp_plan, tokens=torch.as_tensor(b["tokens"],
                                                                      device=dev))[0]
    with torch.no_grad():
        return qat.calibrate_act_scales(params, cfg, policy, fwd, [
            {"tokens": batch["tokens"][:1, :SHARD_CALIB_TOKENS]}])


def timed_step(step, params, opt, batch) -> tuple:
    """One step: (params, opt, loss parts, its eager ms and the card's peak
    GB; 0 on a host without a card, where only the logic is tried)."""
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, parts = step(params, opt, batch)
    if cuda:
        torch.cuda.synchronize()
    return params, opt, {k: float(v) for k, v in parts.items()}, {
        "eager_ms": (time.perf_counter() - t0) * 1e3,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0}


def shard_rank(layouts: tuple, cfg, batch_shape, ref_dir: str, device: str) -> dict:
    """One rank of phase 26's layouts (2 ranks each) on the card, over
    gloo, in turn: gloo must take the step's collectives on CUDA tensors
    (``probe_gloo_cuda`` raises otherwise), then per layout one sharded
    step from the unsharded step's starting params: its loss and, where
    the reference saved them, the distances of its first Adam moment (the
    clipped gradient times 1 - b1) and Adam step (the params after less
    the params before) from the reference's, leaf by leaf (each part's
    squares summed over the ranks that hold it). Every rank's readings,
    gathered to rank 0."""
    import torch.distributed as dist
    from repro_torch.distributed.collectives import probe_gloo_cuda
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        if dist.get_backend() == "gloo":
            probe_gloo_cuda(dev)
    out = {}
    for layout in layouts:
        t0 = time.perf_counter()
        out[layout[0]] = shard_layout(layout, cfg, batch_shape, Path(ref_dir), dev)
        out[layout[0]][0]["rank_seconds"] = time.perf_counter() - t0
    return out


def held_distances(p2, o2, ref: dict, before, specs, groups, dev, label: str) -> tuple:
    """A sharded step's distances from the reference ``ref`` (full trees,
    its first Adam moment "m" and params after "params" where it holds
    them), leaf by leaf, each part's squares summed over the ranks that
    hold it: the first moment's ||delta|| / ||m_ref|| and the Adam step's
    ||p - p_ref|| / ||p_ref - p_before||, the worst leaf of each, and the
    residue leaves (below ``SHARD_RESIDUE`` of the whole first moment's
    norm: they must be residue here too, and their step is not held)."""
    from repro_torch.core.tree import tree_leaves_with_path, tree_map
    from repro_torch.distributed import shard_training
    from repro_torch.distributed.collectives import all_reduce
    axes = dict(tree_leaves_with_path(specs))
    # cut on the card: a CPU copy of a 1.3 B-parameter tree's slices took
    # seconds a tree
    cut = lambda tree: dict(tree_leaves_with_path(
        shard_training(tree_map(lambda t: t.to(dev), tree), specs, groups)))

    def summed(path, *terms):
        """The terms' sums over this leaf's whole array, not this rank's part."""
        sq = torch.stack([t.to(torch.float32) for t in terms])
        for ax in axes[path].axes:
            all_reduce(sq, groups.mp_group if ax == "model" else groups.dp_group)
        return [float(v) for v in sq]

    worst, residue = {"m": None, "step": None}, []
    if "m" in ref:
        # (||delta||^2, ||m_ref||^2, ||m||^2) a leaf
        want_m, m_sq = cut(ref["m"]), {}
        for path, g in tree_leaves_with_path(o2.m):
            w = want_m[path]
            m_sq[path] = summed(path, torch.sum(torch.square(g - w)),
                                torch.sum(torch.square(w)), torch.sum(torch.square(g)))
        whole = float(np.sqrt(sum(v[1] for v in m_sq.values())))
        residue = sorted("/".join(map(str, p)) for p, v in m_sq.items()
                         if np.sqrt(v[1]) < SHARD_RESIDUE * whole)
        worst["m"] = {"rel": 0.0}
        for path, (d, w, g) in m_sq.items():
            key = "/".join(map(str, path))
            if key in residue:
                if np.sqrt(g) >= SHARD_RESIDUE * whole:
                    raise AssertionError(f"{label}: {key}'s first Adam moment is residue "
                                         f"in the unsharded step, {np.sqrt(g)} here")
                continue
            rel = float(np.sqrt(d / max(w, 1e-60)))
            if rel >= worst["m"]["rel"]:
                worst["m"] = {"leaf": key, "rel": rel}
        del want_m
    if "params" in ref:
        # (||p - p_ref||^2, ||p_ref - p_before||^2) a leaf
        want_p, p0 = cut(ref["params"]), cut(before)
        worst["step"] = {"rel": 0.0}
        for path, p in tree_leaves_with_path(p2):
            key = "/".join(map(str, path))
            if key in residue:
                continue
            w = want_p[path]
            d, s = summed(path, torch.sum(torch.square(p.float() - w.float())),
                          torch.sum(torch.square(w.float() - p0[path].float())))
            rel = float(np.sqrt(d / max(s, 1e-60)))
            if rel >= worst["step"]["rel"]:
                worst["step"] = {"leaf": key, "rel": rel}
    return worst, residue


def shard_layout(layout: tuple, cfg, batch_shape, ref_dir: Path, dev) -> list:
    import torch.distributed as dist
    from repro_torch.configs import TrainHParams
    from repro_torch.core.tree import tree_map
    from repro_torch.deploy import ExecutionPlan
    from repro_torch.distributed import training_specs
    from repro_torch.launch.mesh import make_train_groups
    from repro_torch.launch.train import build_train_step, shard_state
    from repro_torch.models import attention
    from repro_torch.optim import adam_init

    name, data, model, fsdp, seq, quantized, dtype = layout
    groups = make_train_groups(data, model)
    cfg = cfg.replace(attn_seq_shard=seq, dtype=dtype)
    before = torch.load(ref_dir / "before.pt", mmap=True, map_location="cpu")
    params = tree_map(lambda t: t.to(dev, copy=True), before)   # the step updates in place
    specs = training_specs(params, cfg, data=data, fsdp=fsdp)
    local = shard_state({"params": params, "opt": adam_init(params)}, specs, groups)
    del params
    torch.cuda.empty_cache()
    calls = {"seq_shard_attention": 0}
    real = attention.seq_shard_attention

    def counted(*a, **kw):
        calls["seq_shard_attention"] += 1
        return real(*a, **kw)
    attention.seq_shard_attention = counted
    step = build_train_step(ExecutionPlan.build(cfg, shard_policy(cfg, quantized), tp=model),
                            TrainHParams(**SHARD_HP), groups=groups, specs=specs)
    p2, o2, parts, run = timed_step(step, local["params"], local["opt"],
                                    shard_batch(cfg, batch_shape))
    attention.seq_shard_attention = real
    ref = torch.load(ref_dir / f"{quantized}_{dtype}.pt", mmap=True, map_location="cpu")
    worst, residue = held_distances(p2, o2, ref, before, specs, groups, dev, name)
    mine = {"rank": groups.rank, "ref": [quantized, dtype], "loss": parts, **run,
            "worst_leaf": worst, "residue_leaves": residue,
            "seq_shard_attention_calls": calls["seq_shard_attention"],
            "local_rows": int(p2["layers"]["attn"]["wq"]["w"].shape[0]),
            "wq_cols": int(p2["layers"]["attn"]["wq"]["w"].shape[-1])}
    del local, p2, o2, step, ref, before
    gc.collect()
    torch.cuda.empty_cache()
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    return everyone


def step_distance(m, p, m_ref, p_ref, before, start) -> dict:
    """The largest leaf distances of one step's first Adam moment ``m`` and
    params after ``p`` from the reference step's (each step: its params
    after less its own start, ``before`` for the reference), leaving out
    residue leaves."""
    from repro_torch.core.tree import tree_leaves_with_path
    flat = lambda tree: dict(tree_leaves_with_path(tree))
    mr, pr, mm, pp, b_ref, b_run = map(flat, (m_ref, p_ref, m, p, before, start))
    norm = lambda t: float(torch.linalg.vector_norm(t.float()))
    whole = float(np.sqrt(sum(norm(t) ** 2 for t in mr.values())))
    out = {"m": 0.0, "step": 0.0}
    for path, w in mr.items():
        if norm(w) < SHARD_RESIDUE * whole:
            continue
        out["m"] = max(out["m"], norm(mm[path] - w) / norm(w))
        ref_step = pr[path].float() - b_ref[path].float()
        run_step = pp[path].float() - b_run[path].float()
        out["step"] = max(out["step"], norm(run_step - ref_step) / max(norm(ref_step), 1e-30))
    return out


def twin_noise(step, before, batch, parts: dict, held, ks, eps: float,
               scale_ks=()) -> dict:
    """An unsharded step's own noise: the largest distance from it of the
    same step run from ``before`` with its embedding table (each k of
    ``ks``) or its activation scales (each k of ``scale_ks``) times 1 + k
    ``eps``. The loss's relative distance; with ``held`` = (first Adam
    moment, params after) of the step, also ``step_distance``'s, from a
    whole twin step, else from the twin's forward alone."""
    from repro_torch.core.tree import tree_map, tree_map_with_path
    from repro_torch.optim import adam_init
    noise = {"loss": 0.0, "m": 0.0, "step": 0.0}
    for kind, k in [("embed", k) for k in ks] + [("s_a", k) for k in scale_ks]:
        f = 1 + k * eps
        if kind == "embed":         # the twin's embedding table alone differs
            start = {**before, "embed": before["embed"] * f}
        else:                       # its activation scales alone
            start = tree_map_with_path(lambda path, t: t * f if path[-1] == "s_a" else t,
                                       before)
        if held is None:
            with torch.no_grad():
                parts_t = {n: float(v) for n, v in step.loss_fn(start, batch)[1].items()}
        else:
            twin = tree_map(torch.clone, start)
            p_t, o_t, parts_t, _ = timed_step(step, twin, adam_init(twin), batch)
            far = step_distance(o_t.m, p_t, *held, before, start)
            noise = {n: max(v, far.get(n, 0.0)) for n, v in noise.items()}
            del twin, p_t, o_t
        noise["loss"] = max(noise["loss"], max(abs(parts_t[n] - v) / abs(v)
                                               for n, v in parts.items()))
        del start
        gc.collect()
        torch.cuda.empty_cache()
    return noise


def unsharded_reference(dev, batch_shape, ref_dir: Path, keys,
                        layers: int = SHARD_LAYERS) -> tuple:
    """Phase 26's config, its calibrated starting params saved to
    ``ref_dir / before.pt``, and per reference (quantized, dtype) of
    ``keys`` the unsharded step on ``dev`` (its loss parts, eager ms and
    peak) with its first Adam moment and params after (where they are
    held) saved to ``ref_dir / <quantized>_<dtype>.pt`` for the
    ranks; then the step's own noise (its twins from the embedding table
    scaled by 1 + k ``SHARD_TWIN_EPS``) and the gates it sets."""
    from repro_torch.configs import TrainHParams
    from repro_torch.core.tree import tree_map
    from repro_torch.deploy import ExecutionPlan
    from repro_torch.launch.train import build_train_step
    from repro_torch.optim import adam_init
    cfg = shard_config(layers=layers)
    batch = shard_batch(cfg, batch_shape)
    before = shard_params(cfg, batch, dev)
    ref_dir.mkdir(parents=True, exist_ok=True)
    cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)
    torch.save(cpu(before), ref_dir / "before.pt")
    out = {}
    for quantized, dtype in keys:
        loss_tol, m_tol, step_tol = SHARD_REFS[quantized, dtype]
        c = cfg.replace(dtype=dtype)
        step = build_train_step(ExecutionPlan.build(c, shard_policy(c, quantized)),
                                TrainHParams(**SHARD_HP))
        params = tree_map(torch.clone, before)       # the step updates in place
        p_ref, o_ref, parts, run = timed_step(step, params, adam_init(params), batch)
        saved = {}
        if m_tol is not None:
            saved["m"] = cpu(o_ref.m)
        if step_tol is not None:
            saved["params"] = cpu(p_ref)
        torch.save(saved, ref_dir / f"{quantized}_{dtype}.pt")
        del saved
        held = (o_ref.m, p_ref) if m_tol is not None else None
        noise = twin_noise(step, before, batch, parts, held, SHARD_TWINS[quantized, dtype],
                           SHARD_TWIN_EPS[dtype])
        gate = lambda tol, n: None if tol is None else max(tol, SHARD_NOISE_MARGIN * n)
        gates = {"loss": gate(loss_tol, noise["loss"]), "m": gate(m_tol, noise["m"]),
                 "step": gate(step_tol, noise["step"])}
        if max(gates["m"] or 0.0, gates["step"] or 0.0) > SHARD_GATE_CAP:
            raise AssertionError(f"phase 26 {quantized} {dtype}: the unsharded step's own "
                                 f"noise {noise} sets gates {gates} past {SHARD_GATE_CAP}")
        out[f"{quantized}_{dtype}"] = {"loss": parts, **run, "noise": noise, "gates": gates}
        del params, p_ref, o_ref, step, held
        gc.collect()
        torch.cuda.empty_cache()
    del before
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, out


def check_ranks(name: str, ranks: list, ref: dict, phase: str = "26",
                failures=None) -> None:
    """Every rank's loss, first Adam moment and Adam step against the
    unsharded step's, at the gates of its reference ``ref``; each miss
    raises, or joins ``failures`` when it is a list."""
    gates = ref["gates"]
    print(f"phase {phase} {name}: rank 0 {ranks[0]['rank_seconds']:.1f} s, eager ms "
          f"{[round(r['eager_ms'], 1) for r in ranks]}, peak GB "
          f"{[round(r['peak_gb'], 2) for r in ranks]}, loss {ranks[0]['loss']}, worst "
          f"leaves {ranks[0]['worst_leaf']}, residue {ranks[0]['residue_leaves']}, "
          f"gates {gates}, noise {ref['noise']}", flush=True)

    def fail(msg):
        if failures is None:
            raise AssertionError(msg)
        failures.append(msg)
    for r in ranks:
        for k, v in r["loss"].items():
            want = ref["loss"][k]
            if not abs(v - want) <= gates["loss"] * abs(want):
                fail(f"{name} rank {r['rank']}: {k} {v} vs unsharded {want} (rel "
                     f"{abs(v - want) / abs(want)}, gate {gates['loss']})")
        for what in ("m", "step"):
            if gates[what] is not None and r["worst_leaf"][what]["rel"] > gates[what]:
                fail(f"{name}: {what} off: {r['worst_leaf'][what]} (gate {gates[what]})")


def sharded_train(dev) -> dict:
    """Phase 26 (a): the unsharded step on the card for each reference,
    then 2 ranks sharing it (one spawn) running each layout in turn, held
    to its reference."""
    import shutil
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.perf_counter()
    ref_dir = ROOT / "build" / "phase26_ref"
    cfg, refs = unsharded_reference(dev, SHARD_BATCH, ref_dir, list(SHARD_REFS))
    out = {"unsharded": refs}
    print(f"phase 26 unsharded: {time.perf_counter() - t0:.1f} s, {refs}", flush=True)
    t1 = time.perf_counter()
    runs = spawn_ranks(shard_rank, 1, 2, SHARD_LAYOUTS, cfg, SHARD_BATCH, str(ref_dir),
                       dev.type, device=dev.type, backend="gloo")
    out["spawn_seconds"] = time.perf_counter() - t1
    shutil.rmtree(ref_dir)
    for name, _, _, _, seq, quantized, dtype in SHARD_LAYOUTS:
        check_ranks(name, runs[name], refs[f"{quantized}_{dtype}"])
        if seq and not all(r["seq_shard_attention_calls"] for r in runs[name]):
            raise AssertionError(f"{name}: the chunk branch did not run context-parallel")
        out[name] = {"ranks": runs[name]}
    out["seconds"] = time.perf_counter() - t0
    return out


def examples_phase() -> dict:
    """Phase 26 (b): the four ``examples/torch_*.py`` with ``--quick`` on
    the card (their default device), each passing its own asserts; the
    kernels they launch."""
    import importlib.util
    from repro_torch.kernels import build
    out = {}
    build.reset_counts()
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        mod.main(["--quick"])
        out[name] = {"seconds": time.perf_counter() - t0}
        print(f"phase 26 {name}: {out[name]['seconds']:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = dict(build.LAUNCHES)
    out["plain_on_cuda"] = {k: v for k, v in build.PLAIN_ON_CUDA.items() if v}
    if out["plain_on_cuda"]:
        raise AssertionError(f"examples: plain versions ran on CUDA tensors: "
                             f"{out['plain_on_cuda']}")
    return out


def sharded_dryrun(pool) -> "callable":
    """Phase 26 (c): the dry run's stablelm-3b x train_4k x multi cell
    (data 2 x model 2) plain, with --fsdp and with --attn-seq-shard, on the
    card's host, each in a process of ``pool`` (each analysis is one Python
    thread; they run while the card trains). Returns the function that
    waits for them: every cell ``ok``, FSDP's argument bytes at most 0.55x
    the plain cell's."""
    from repro_torch.launch import dryrun
    out_dir = str(ROOT / "chiprun_out" / "dryrun_torch")
    tags = ["_".join(extra) or "plain" for extra in SHARD_DRYRUN]
    futures = [pool.submit(dryrun.run_cell, "stablelm-3b", "train_4k", "multi", out_dir,
                           tag="" if not extra else tag, extra=extra)
               for extra, tag in zip(SHARD_DRYRUN, tags)]

    def results() -> dict:
        cells = {}
        for tag, f in zip(tags, futures):
            r = f.result()
            if r["status"] != "ok":
                raise AssertionError(f"dry run {tag}: {r['status']} {r.get('reason')}")
            cells[tag] = {"argument_bytes": r["memory"]["argument_bytes"],
                          "total_bytes": r["memory"]["total_bytes"],
                          "collective_bytes": r["op_analysis"]["collective_bytes"],
                          "roofline_terms_s": r["roofline_terms_s"],
                          "seconds": r["lower_s"] + r["compile_s"]}
            print(f"phase 26 dry run {tag}: {cells[tag]['seconds']:.1f} s", flush=True)
        ratio = cells["fsdp"]["argument_bytes"] / cells["plain"]["argument_bytes"]
        if ratio > 0.55:
            raise AssertionError(f"dry run: FSDP argument bytes {ratio:.3f}x the plain cell's")
        return {"cells": cells, "fsdp_argument_ratio": ratio}
    return results


#: ``--sharded-cards 4``: phase 26 (a)'s step over NCCL, a card a rank, on
#: 4 layers (FSDP cuts them over data 4)
NCCL_BATCH = (4, 4096)
NCCL_LAYERS = 4
NCCL_LAYOUTS = (("data2_model2_fsdp_seq_shard", 2, 2, True, True, "wa", "float32"),
                ("data2_model2_fsdp_seq_shard_wonly", 2, 2, True, True, "w", "float32"),
                ("model4_wonly", 1, 4, False, False, "w", "float32"),
                ("data4_fsdp_wonly", 4, 1, True, False, "w", "float32"))


def sharded_cards(cards: int) -> dict:
    """``python3 chip_smoke.py --sharded-cards 4``: phase 26 (a)'s step on
    four cards over NCCL (a card a rank; 4 x 4096 tokens) at data 2 x model
    2 with FSDP and ``attn_seq_shard`` (weights and activations quantized,
    and weights only), at model 4 and at data 4 with FSDP (weights only),
    each held to the unsharded step on card 0 at phase 26's gates. Needs
    ``cards`` cards."""
    import shutil
    from repro_torch.launch.mesh import spawn_ranks
    if cards != 4 or torch.cuda.device_count() < cards:
        raise RuntimeError(f"--sharded-cards runs 4 ranks a card each; host has "
                           f"{torch.cuda.device_count()} cards")
    ref_dir = ROOT / "build" / "phase26_nccl_ref"
    cfg, refs = unsharded_reference(torch.device("cuda", 0), NCCL_BATCH, ref_dir,
                                    [("wa", "float32"), ("w", "float32")],
                                    layers=NCCL_LAYERS)
    t0 = time.perf_counter()
    runs = spawn_ranks(shard_rank, 2, 2, NCCL_LAYOUTS, cfg, NCCL_BATCH, str(ref_dir),
                       "cuda", device="cuda")
    out = {"unsharded": refs, "spawn_seconds": time.perf_counter() - t0}
    shutil.rmtree(ref_dir)
    for name, *_, quantized, dtype in NCCL_LAYOUTS:
        check_ranks(name, runs[name], refs[f"{quantized}_{dtype}"])
        out[name] = runs[name]
    return out


def sharded_phase(dev) -> dict:
    import concurrent.futures
    import multiprocessing
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            len(SHARD_DRYRUN), mp_context=multiprocessing.get_context("spawn")) as pool:
        dryrun_results = sharded_dryrun(pool)
        out = {"train": sharded_train(dev)}
        gc.collect()
        torch.cuda.empty_cache()
        out["examples"] = examples_phase()
        out["dryrun"] = dryrun_results()
    out["seconds"] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------- phase 27
#: phase 27: the token-mode families at full width, each depth cut so its
#: stack divides over data 2: arch -> (config edits, target tokens a row,
#: source frames a row). xlstm-1.3b takes 256 tokens (its mLSTM chunk), not
#: 2048: its sLSTM steps token by token on the host, some 460,000 launches
#: a 2048-token step (10.7-21.4 s unsharded, 20-62 s a rank, on an H100
#: 80GB HBM3 at 700 W)
FAMILY_SHARDS = {"xlstm-1.3b": ({"num_layers": 16}, 256, 0),
                 "zamba2-2.7b": ({"num_layers": 12}, 2048, 0),
                 "seamless-m4t-medium": ({"num_layers": 4, "enc_layers": 2,
                                          "dec_layers": 2}, 1024, 1024)}
FAMILY_ROWS = 2
#: (name, data, model, fsdp, the references it is held to): 2 ranks
#: sharing the one card over gloo. The quantized step runs at model 2 alone,
#: where the row-parallel inputs' activation scales take their LSQ share:
#: a rank's step took 20-28 s for xlstm-1.3b on the card
FAMILY_LAYOUTS = (("model2", 1, 2, False, ("wa", "w")),
                  ("data2_fsdp", 2, 1, True, ("w",)))
#: phase 26's references and gates in f32 ("wa": weights and activations
#: quantized, held by its loss, its twins' losses from a forward alone;
#: "w": weights only, held leaf by leaf, two twin steps: with one, xlstm's
#: model-2 first moment read 2.8e-3 at 512 tokens against a gate of 1.05e-3,
#: H100 80GB HBM3 at 700 W)
FAMILY_REFS = {"wa": SHARD_REFS["wa", "float32"], "w": SHARD_REFS["w", "float32"]}
FAMILY_TWINS = {"wa": SHARD_TWINS["wa", "float32"], "w": (1, -1)}
#: the quantized step's further twins: every activation scale times 1 + k e
#: moves each layer's inputs by about one unit roundoff against their
#: scales, as a sharded step's other summation order moves them at every
#: layer (the embedding twins move the first layer's alone): at model 2
#: zamba2-2.7b's and seamless-m4t-medium's losses read 2.4e-5 and 2.2e-5
#: off, their embedding twins 4.8e-6 and 3.3e-6, their weight-only steps
#: within 2.7e-5 a leaf (H100 80GB HBM3, 700 W)
FAMILY_SCALE_TWINS = (1, -1)
#: the trained zamba2-2.7b tree served: requests of prompt + new tokens
FAMILY_SERVE = (4, 16, 16)


def family_config(arch: str):
    """Phase 27's model: ``arch`` at full width, its depth cut
    (``FAMILY_SHARDS``), f32 activations."""
    from repro_torch.configs import get_config
    return get_config(arch).replace(dtype="float32", **FAMILY_SHARDS[arch][0])


def family_policy(cfg, quantized: str = "wa"):
    """The first half of the units (groups, or decoder layers) W8A8, the
    rest W4A4 ("wa"), or those weights with fp activations ("w")."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.deploy.plan import _segment_units
    n = _segment_units(cfg)
    return QuantPolicy(num_layers=n, mode="fake", last_k_int4=n // 2,
                       act_bits_override=0 if quantized == "w" else None)


def family_batch(cfg, arch: str) -> dict:
    """``FAMILY_ROWS`` rows of tokens (and the encoder-decoder's
    ``src_embeds``) from a seeded generator."""
    _, S, S_src = FAMILY_SHARDS[arch]
    rng = np.random.default_rng(27)
    toks = rng.integers(0, cfg.vocab_size, (FAMILY_ROWS, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if S_src:
        batch["src_embeds"] = rng.standard_normal(
            (FAMILY_ROWS, S_src, cfg.d_model)).astype(np.float32)
    return batch


def family_inputs(batch: dict, dev, rows=None, tokens=None) -> dict:
    """The forward's inputs of ``batch`` on ``dev``, cut to ``rows`` rows
    and ``tokens`` positions."""
    return {k: torch.as_tensor(v[:rows, :tokens], device=dev)
            for k, v in batch.items() if k != "labels"}


def family_params(cfg, batch: dict, dev):
    """fp params from a seeded generator on ``dev``, calibrated as training
    is (weight scales abs-max / l_max, the token-mode families' one
    activation scale on row 0's first ``SHARD_CALIB_TOKENS``)."""
    from repro_torch.core import qat
    from repro_torch.deploy import ExecutionPlan
    from repro_torch.models import api
    policy = family_policy(cfg)
    params = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    params = qat.calibrate_weight_scales(params, qat.default_bits_fn(cfg, policy))
    fp_plan = ExecutionPlan.build(cfg, None)
    fwd = lambda p, b: api.forward(p, fp_plan, **family_inputs(b, dev))[0]
    with torch.no_grad():
        return qat.calibrate_act_scales(params, cfg, policy, fwd, [
            {k: v[:1, :SHARD_CALIB_TOKENS] for k, v in batch.items()}])


def family_reference(arch: str, dev, ref_dir: Path) -> tuple:
    """Phase 26's ``unsharded_reference`` for ``arch``: its calibrated
    starting params saved to ``ref_dir / before.pt``, then per reference of
    ``FAMILY_REFS`` the unsharded step on ``dev`` (loss parts, eager ms,
    peak), its first Adam moment and params after saved where held, its
    twins' noise and the gates it sets."""
    from repro_torch.configs import TrainHParams
    from repro_torch.core.tree import tree_map
    from repro_torch.deploy import ExecutionPlan
    from repro_torch.launch.train import build_train_step
    from repro_torch.optim import adam_init
    cfg = family_config(arch)
    batch = family_batch(cfg, arch)
    before = family_params(cfg, batch, dev)
    n_params = sum(int(t.numel()) for t in _leaves(before))
    ref_dir.mkdir(parents=True, exist_ok=True)
    cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)
    torch.save(cpu(before), ref_dir / "before.pt")
    out = {"params": n_params}
    for quantized, (loss_tol, m_tol, step_tol) in FAMILY_REFS.items():
        step = build_train_step(ExecutionPlan.build(cfg, family_policy(cfg, quantized)),
                                TrainHParams(**SHARD_HP))
        params = tree_map(torch.clone, before)       # the step updates in place
        p_ref, o_ref, parts, run = timed_step(step, params, adam_init(params), batch)
        if not all(np.isfinite(v) for v in parts.values()):
            raise AssertionError(f"phase 27 {arch} {quantized}: loss {parts}")
        # only what the twins are held to stays on the card (1.3 B params:
        # each tree is 5.3 GB)
        held = (o_ref.m, p_ref) if m_tol is not None else None
        if held is not None:
            torch.save({"m": cpu(held[0]), "params": cpu(held[1])},
                       ref_dir / f"{quantized}.pt")
        else:
            torch.save({}, ref_dir / f"{quantized}.pt")
        del params, p_ref, o_ref
        gc.collect()
        torch.cuda.empty_cache()
        noise = twin_noise(step, before, batch, parts, held, FAMILY_TWINS[quantized],
                           SHARD_TWIN_EPS["float32"],
                           FAMILY_SCALE_TWINS if held is None else ())
        gate = lambda tol, n: None if tol is None else max(tol, SHARD_NOISE_MARGIN * n)
        gates = {"loss": gate(loss_tol, noise["loss"]), "m": gate(m_tol, noise["m"]),
                 "step": gate(step_tol, noise["step"])}
        if max(gates["m"] or 0.0, gates["step"] or 0.0) > SHARD_GATE_CAP:
            raise AssertionError(f"phase 27 {arch} {quantized}: the unsharded step's own "
                                 f"noise {noise} sets gates {gates} past {SHARD_GATE_CAP}")
        out[quantized] = {"loss": parts, **run, "noise": noise, "gates": gates}
        del held, step
        gc.collect()
        torch.cuda.empty_cache()
    del before
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, batch, out


def family_warm_up(dev) -> None:
    """One unsharded step of each family's reduced config on ``dev``: the
    kernels a first training step loads (some 18 s a process beside an
    H100 80GB HBM3), loaded while the other rank computes the first
    reference."""
    from repro_torch.configs import TrainHParams, reduced
    from repro_torch.deploy import ExecutionPlan
    from repro_torch.launch.train import build_train_step
    from repro_torch.models import api
    from repro_torch.optim import adam_init
    for arch in FAMILY_SHARDS:
        cfg = reduced(family_config(arch))
        params = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        step = build_train_step(ExecutionPlan.build(cfg, family_policy(cfg)),
                                TrainHParams(**SHARD_HP))
        rows = {k: v[:, :16] for k, v in family_batch(cfg, arch).items()}
        timed_step(step, params, adam_init(params), rows)
    torch.cuda.empty_cache()


def family_layouts(arch: str, cfg, batch: dict, ref_dir: Path, dev, layouts: dict,
                   serve_path: str) -> dict:
    """This rank's part of ``arch``'s layouts (``layouts``: name ->
    ``TrainGroups``), in turn: at the first the gathered starting tree
    equal to the full one (the round trip), then per reference a sharded
    step from the unsharded step's starting params, held as phase 26 holds
    its (``held_distances``). Under ``serve_path`` rank 0 saves the
    gathered params after zamba2's model-2 "wa" step. Every rank's
    readings, gathered to rank 0."""
    import torch.distributed as dist
    from repro_torch.configs import TrainHParams
    from repro_torch.core.tree import tree_leaves_with_path, tree_map
    from repro_torch.deploy import ExecutionPlan
    from repro_torch.distributed import gather_training, shard_training, training_specs
    from repro_torch.launch.train import build_train_step, gather_state, shard_state
    from repro_torch.optim import adam_init
    out = {}
    before = torch.load(ref_dir / "before.pt", mmap=True, map_location="cpu")
    for li, (name, data, model, fsdp, quantizations) in enumerate(FAMILY_LAYOUTS):
        t_layout = time.perf_counter()
        groups = layouts[name]
        specs = training_specs(before, cfg, data=data, fsdp=fsdp)
        axes = dict(tree_leaves_with_path(specs))
        t0 = time.perf_counter()
        local = shard_training(tree_map(lambda t: t.to(dev), before), specs, groups)
        round_trip = None
        if li == 0:
            back = gather_training(local, specs, groups)
            round_trip = all(torch.equal(a, b.to(dev)) for (_, a), (_, b) in zip(
                tree_leaves_with_path(back), tree_leaves_with_path(before)))
            del back
        round_trip_s = time.perf_counter() - t0
        cut_rows = sorted({int(t.shape[0]) for path, t in tree_leaves_with_path(local)
                           if "data" in axes[path].axes})
        del local
        torch.cuda.empty_cache()
        readings = []
        for quantized in quantizations:
            params = tree_map(lambda t: t.to(dev, copy=True), before)
            state = shard_state({"params": params, "opt": adam_init(params)}, specs, groups)
            del params
            torch.cuda.empty_cache()
            step = build_train_step(
                ExecutionPlan.build(cfg, family_policy(cfg, quantized), tp=model),
                TrainHParams(**SHARD_HP), groups=groups, specs=specs)
            p2, o2, parts, run = timed_step(step, state["params"], state["opt"], batch)
            ref = torch.load(ref_dir / f"{quantized}.pt", mmap=True, map_location="cpu")
            worst, residue = held_distances(p2, o2, ref, before, specs, groups, dev,
                                            f"{arch} {name}")
            if serve_path and name == "model2" and quantized == "wa":
                full = gather_state({"params": p2, "opt": o2}, specs, groups)["params"]
                if groups.rank == 0:
                    torch.save(tree_map(lambda t: t.cpu(), full), serve_path)
                del full
            readings.append({"ref": quantized, "rank": groups.rank, "loss": parts, **run,
                             "worst_leaf": worst, "residue_leaves": residue})
            del state, p2, o2, step, ref
            gc.collect()
            torch.cuda.empty_cache()
        mine = {"rank": groups.rank, "round_trip_bit_equal": round_trip,
                "round_trip_s": round_trip_s, "data_cut_rows": cut_rows,
                "readings": readings, "rank_seconds": time.perf_counter() - t_layout}
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, mine)
        out[name] = everyone
    del before
    gc.collect()
    torch.cuda.empty_cache()
    return out


def families_rank(archs: tuple, ref_root: str, device: str, serve_path: str) -> dict:
    """One of phase 27's 2 ranks sharing the card over gloo (one spawn for
    every family): per family rank 0 computes the unsharded references
    (``family_reference``; rank 1 warms up meanwhile, before the first),
    then both run its layouts (``family_layouts``). Rank 0's results."""
    import shutil

    import torch.distributed as dist
    from repro_torch.distributed.collectives import probe_gloo_cuda
    from repro_torch.launch.mesh import make_train_groups
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        probe_gloo_cuda(dev)
    rank = dist.get_rank()
    # the latency of one small all-reduce over gloo on this device
    tiny = torch.ones(256, device=dev)
    dist.all_reduce(tiny)
    t0 = time.perf_counter()
    for _ in range(20):
        dist.all_reduce(tiny)
    out = {"gloo_all_reduce_ms": (time.perf_counter() - t0) * 1e3 / 20}
    layouts = {name: make_train_groups(data, model)
               for name, data, model, *_ in FAMILY_LAYOUTS}
    for i, arch in enumerate(archs):
        ref_dir = Path(ref_root) / arch
        t0 = time.perf_counter()
        refs = None
        if rank == 0:
            _, _, refs = family_reference(arch, dev, ref_dir)
            print(f"phase 27 {arch} unsharded: {time.perf_counter() - t0:.1f} s, {refs}",
                  flush=True)
        elif i == 0:
            family_warm_up(dev)
        dist.barrier()
        ref_s = time.perf_counter() - t0
        cfg = family_config(arch)
        t1 = time.perf_counter()
        res = family_layouts(arch, cfg, family_batch(cfg, arch), ref_dir, dev, layouts,
                             serve_path if arch == "zamba2-2.7b" else "")
        dist.barrier()
        if rank == 0:
            shutil.rmtree(ref_dir)
        out[arch] = {"unsharded": refs, "reference_seconds": ref_s,
                     "layouts_seconds": time.perf_counter() - t1, **res}
    return out


def serve_trained(dev, path: Path) -> dict:
    """The zamba2-2.7b tree phase 27's model-2 step trained, deployed on its
    learned scales (W8A8 group 0, W4A4 group 1, bf16 activations, the
    kernel backend) and served in token mode: ``FAMILY_SERVE`` requests,
    every token step launching the integer kernels ``hybrid_linears``
    derives, the streams equal to the reference backend's."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.deploy import ExecutionPlan, deploy
    from repro_torch.serving import GenerationRequest
    t0 = time.perf_counter()
    cfg = get_config("zamba2-2.7b").replace(num_layers=FAMILY_SHARDS["zamba2-2.7b"][0]
                                             ["num_layers"])
    G = cfg.num_layers // cfg.attn_every
    plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=G, mode="int",
                                                last_k_int4=G // 2), backend="cuda")
    trained = torch.load(path, map_location="cpu")
    model = deploy(trained, plan, None, recalibrate=False, device=dev)
    del trained
    n, prompt, new = FAMILY_SERVE
    rng = np.random.default_rng(27)
    reqs = [GenerationRequest(prompt=rng.integers(1, cfg.vocab_size, prompt).astype(np.int32),
                              max_new_tokens=new) for _ in range(n)]
    per_step = {**dict.fromkeys(SOURCES, 0),
                **gemm_launches(hybrid_linears(cfg, plan.segments), TOKEN_SLOTS)}
    serve = serve_token_mode(model, reqs, per_step)
    ref = serve_token_mode(reference_twin(model), reqs)
    parted = first_divergence(serve["streams"], ref["streams"])
    if any(p is not None for p in parted):
        raise AssertionError(f"phase 27: the trained zamba2's kernel streams part from "
                             f"the reference backend's at steps {parted}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {**{k: v for k, v in serve.items() if k != "streams"},
            "streams_equal_reference": len(parted), "seconds": time.perf_counter() - t0}


def families_phase(dev) -> dict:
    """Phase 27: every token-mode family's sharded step on 2 ranks sharing
    the card (one spawn), each rank's steps held to the references' gates,
    the round trip bit-equal, FSDP's stacks cut to one group a data rank;
    then the trained zamba2 tree served. It fails after all of them with
    every miss."""
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.perf_counter()
    serve_path = ROOT / "build" / "phase27_zamba2_trained.pt"
    runs = spawn_ranks(families_rank, 1, 2, tuple(FAMILY_SHARDS),
                       str(ROOT / "build" / "phase27_ref"), dev.type, str(serve_path),
                       device=dev.type, backend="gloo")
    out = {"gloo_all_reduce_ms": runs["gloo_all_reduce_ms"],
           "spawn_seconds": time.perf_counter() - t0}
    failures = []
    for arch in FAMILY_SHARDS:
        res = runs[arch]
        refs = res["unsharded"]
        for name, data, model, fsdp, quantizations in FAMILY_LAYOUTS:
            ranks = res[name]
            if any(r["round_trip_bit_equal"] is False for r in ranks):
                failures.append(f"{arch} {name}: the gathered tree is not the full one")
            if fsdp and any(r["data_cut_rows"] != [1] for r in ranks):
                failures.append(f"{arch} {name}: FSDP cut rows "
                                f"{[r['data_cut_rows'] for r in ranks]}, not one a rank")
            for quantized in quantizations:
                per = [{**next(x for x in r["readings"] if x["ref"] == quantized),
                        "rank_seconds": r["rank_seconds"]} for r in ranks]
                check_ranks(f"{arch} {name} {quantized}", per, refs[quantized],
                            phase="27", failures=failures)
        if not any(r["round_trip_bit_equal"] for r in res[FAMILY_LAYOUTS[0][0]]):
            failures.append(f"{arch}: no round trip ran")
        out[arch] = {**res, "seconds": res["reference_seconds"] + res["layouts_seconds"]}
    out["serve"] = serve_trained(dev, serve_path)
    serve_path.unlink()
    out["seconds"] = time.perf_counter() - t0
    if failures:
        raise AssertionError("phase 27: " + "; ".join(failures))
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
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zamba = zamba_phase(dev)
    seconds["zamba2"] = time.perf_counter() - t0
    emit({"phase": "zamba2", **zamba})
    t0 = time.perf_counter()
    seamless = seamless_phase(dev)
    seconds["seamless"] = time.perf_counter() - t0
    emit({"phase": "seamless", **seamless})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    xl = xlstm_phase(dev)
    seconds["xlstm"] = time.perf_counter() - t0
    emit({"phase": "xlstm", **{k: v for k, v in xl.items() if k != "train"}})
    emit({"phase": "xlstm_train", **xl["train"]})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p25 = fused_remat_analysis_phase(dev, dense_streams[8], dec_times["decode_step_kv8"])
    seconds["fused_remat_analysis"] = time.perf_counter() - t0
    fused = p25["fused"]
    emit({"phase": "fused_serving", **{k: v for k, v in fused.items()
                                       if k != "gemm_calls_bit_equal"},
          "gemm_shapes_bit_equal": len(fused["gemm_calls_bit_equal"])})
    emit({"phase": "remat_train", **p25["remat"]})
    for tag, row in p25["analysis"].items():
        if tag != "dryrun_cells":
            emit({"phase": "analysis_vs_card", "step": tag, **row})
    for cell, r in p25["analysis"]["dryrun_cells"].items():
        emit({"phase": "dryrun_cell", "cell": cell, **r})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p26 = sharded_phase(dev)
    seconds["sharded_train_examples_dryrun"] = time.perf_counter() - t0
    emit({"phase": "sharded_train", "layout": "unsharded", **p26["train"]["unsharded"],
          "spawn_seconds": p26["train"]["spawn_seconds"]})
    for name, *_ in SHARD_LAYOUTS:
        for r in p26["train"][name]["ranks"]:
            emit({"phase": "sharded_train", "layout": name, **r})
    emit({"phase": "examples", **{k: v for k, v in p26["examples"].items()}})
    for cell, r in p26["dryrun"]["cells"].items():
        emit({"phase": "sharded_dryrun_cell", "cell": cell, **r})
    emit({"phase": "sharded_seconds", "train": p26["train"]["seconds"],
          "fsdp_argument_ratio": p26["dryrun"]["fsdp_argument_ratio"],
          "seconds": seconds["sharded_train_examples_dryrun"]})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p27 = families_phase(dev)
    seconds["sharded_families"] = time.perf_counter() - t0
    emit_families(p27, card)
    dec_rows.append(seamless["noncausal_flash_row"])
    errors["flash_attention"] = max(
        errors["flash_attention"], *(r["max_abs_err"] for r in flash_rows),
        *(run["layers_max_abs_err_vs_plain"] for run in prefill.values()),
        *(run["layer0_max_abs_err_vs_plain"] for run in long_times.values()),
        moe["granite_long_forward"]["layer0_max_abs_err_vs_plain"],
        zamba["long_forward"]["layer0_max_abs_err_vs_plain"],
        seamless["encoder"]["flash_max_abs_err_vs_plain"],
        seamless["noncausal_flash_row"]["max_abs_err"])

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
                        "moe_qwen_kv8_dense": moe["qwen_serve_kv8_dense"]["launches"],
                        "zamba2_token": zamba["serve"]["launches"],
                        f"zamba2_prefill_{ZAMBA_LONG}": zamba["long_forward"]["launches"],
                        "seamless_encoder": seamless["encoder"]["launches"],
                        "seamless_decode": seamless["decode"]["launches"],
                        "xlstm_token": xl["serve"]["launches"],
                        "fused_kv8": fused["launches"],
                        "examples": p26["examples"]["launches"],
                        "zamba2_trained_token": p27["serve"]["launches"],
                        f"xlstm_prefill_{XLSTM_LONG}": xl["long_forward"]["launches"]}
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
               "fleet_replicas_paged": fleet["replicas"]["paged"]["act_quant_planned"],
               "fused_kv8": fused["act_quant_planned"]}
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
                       ("moe_qwen_kv8_dense", MOE_KERNELS),
                       ("zamba2_token", HYBRID_KERNELS),
                       (f"zamba2_prefill_{ZAMBA_LONG}", PREFILL_KERNELS),
                       ("seamless_encoder", SEAMLESS_ENC_KERNELS),
                       ("seamless_decode", SEAMLESS_DEC_KERNELS),
                       ("xlstm_token", HYBRID_KERNELS),
                       ("zamba2_trained_token", HYBRID_KERNELS),
                       ("fused_kv8", DECODER_KERNELS),
                       ("examples", ("int8_matmul", "int4_matmul", "decode_attention")),
                       (f"xlstm_prefill_{XLSTM_LONG}", GEMM_KERNELS)):
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
        if entry["name"] in GEMM_KERNELS:
            entry["xlstm"] = {
                "per_token_step": xl["serve"]["launches_per_step"][entry["name"]],
                f"per_forward_{XLSTM_LONG}": xl["long_forward"]["launches"][entry["name"]]}
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
                                  "fleet": fleet, "moe": moe, "zamba2": zamba,
                                  "seamless": seamless, "xlstm": xl,
                                  "fused_remat_analysis": p25,
                                  "sharded_examples_dryrun": p26,
                                  "sharded_families": p27,
                                  "seconds": seconds},
                                 indent=2, default=str))
    emit({"kernels": entries})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def emit_families(p27: dict, card: str) -> None:
    """Phase 27's lines: per family the unsharded references and each
    layout's ranks (seconds, eager ms and peak memory beside the card),
    then the trained zamba2's serving."""
    for arch in FAMILY_SHARDS:
        res = p27[arch]
        emit({"phase": "sharded_family", "arch": arch, "layout": "unsharded", "card": card,
              **res["unsharded"], "reference_seconds": res["reference_seconds"],
              "layouts_seconds": res["layouts_seconds"], "seconds": res["seconds"]})
        for name, *_ in FAMILY_LAYOUTS:
            for r in res[name]:
                emit({"phase": "sharded_family", "arch": arch, "layout": name,
                      "card": card, **r})
    emit({"phase": "sharded_family_serve", "card": card, **p27["serve"]})
    emit({"phase": "sharded_family_seconds", "card": card, "seconds": p27["seconds"],
          "spawn_seconds": p27["spawn_seconds"],
          "gloo_all_reduce_ms": p27["gloo_all_reduce_ms"],
          **{arch: p27[arch]["seconds"] for arch in FAMILY_SHARDS}})


def main_families() -> int:
    """``python3 chip_smoke.py --families``: phase 27 alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.kernels import build
    card = card_line()
    print(card, flush=True)
    build.library()
    p27 = families_phase(torch.device("cuda"))
    emit_families(p27, card)
    report = ROOT / "chiprun_out" / "chip_smoke_families.json"
    report.parent.mkdir(exist_ok=True)
    report.write_text(json.dumps(p27, indent=2, default=str))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main_sharded_cards(cards: int) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    print(card_line(), flush=True)
    out = sharded_cards(cards)
    emit({"phase": "sharded_cards", "layout": "unsharded", **out["unsharded"],
          "spawn_seconds": out["spawn_seconds"]})
    for name, *_ in NCCL_LAYOUTS:
        for r in out[name]:
            emit({"phase": "sharded_cards", "layout": name, **r})
    report = ROOT / "chiprun_out" / "chip_smoke_sharded_cards.json"
    report.parent.mkdir(exist_ok=True)
    report.write_text(json.dumps(out, indent=2, default=str))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-cards"]:
        sys.exit(main_sharded_cards(int(sys.argv[2])))
    if sys.argv[1:2] == ["--families"]:
        sys.exit(main_families())
    sys.exit(main())
