"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card with nvcc (the kernels are built at
first use) and skips, inside its fixture, on a host without CUDA: a CUDA
kernel has no CPU mode. The file imports no JAX, so it runs on a machine
with PyTorch alone:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Codes and unfused outputs must be bit-equal to the plain versions (f32
and bf16 activations), on each of the integer GEMMs' paths (split-K,
wgmma, tiles) and over two calls and a CUDA-graph replay, also where
split-K quantizes f32 or bf16 activations itself and where wgmma reads
codes at a padded row pitch; the fused epilogue on every path bit-equal to
the plain version (the first tests hold tanh-GELU within rtol = atol =
1e-6 of it; the path tests, bit-equal). Decode attention within atol 1e-5 (rtol 0) for f32 and one bf16 ulp
plus 1e-5 for bf16 (the online and the one-pass softmax sum in different
orders, and that f32 difference survives the rounding of outputs near
zero), and
bit-unchanged when the cache rows past each slot's length are poisoned.
Paged decode attention within the same bounds of its plain version, and
bit-equal to the dense kernel on the layout its tables describe. Flash
attention within rtol = atol = 1e-5 (f32) and the decode bf16 bound of its
plain version (the tiles sum in another order), and exact where a causal
row attends one key.
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core.packing import pack_int4
from repro_torch.kernels import build, kv_pack, ops
from repro_torch.kernels.decode_attention import (SPLIT_ROWS,
                                                  decode_attention_cuda,
                                                  decode_attention_paged_cuda,
                                                  decode_attention_paged_plain,
                                                  decode_attention_plain,
                                                  gather_kv_blocks)
from repro_torch.kernels.act_quant import act_quant_cuda, act_quant_plain
from repro_torch.kernels.gemm_plan import (PATH_SPLITK, PATH_TILED, PATH_WGMMA,
                                           code_pitch, gemm_plan, quantizes_in_gemm)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.int4_matmul import (int4_matmul_cuda,
                                             int4_matmul_fused_cuda,
                                             int4_matmul_fused_plain,
                                             int4_matmul_plain)
from repro_torch.kernels.int8_matmul import int8_matmul_cuda, int8_matmul_plain

pytestmark = pytest.mark.cuda

# ragged M, and every (K, N) of the tinybert4 serving path
SHAPES = [(37, 312, 312), (300, 312, 1200), (129, 1200, 312)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _operands(dev, M, K, N, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev) * 2
    s = (x.abs().amax() * 0.6 / 8).reshape(())
    x4 = act_quant_plain(x, s, 4)
    wp = torch.randint(0, 256, (K // 2, N), generator=g, device=dev,
                       dtype=torch.uint8)
    w8 = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                       dtype=torch.int8)
    s_w = torch.rand((1, N), generator=g, device=dev) * 0.01 + 1e-3
    bias = torch.randn((1, N), generator=g, device=dev)
    return x, s, x4, wp, w8, s_w, bias


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_act_quant_kernel_matches_plain(dev, M, K, N, bits):
    x, s, *_ = _operands(dev, M, K, N)
    assert torch.equal(act_quant_cuda(x, s, bits), act_quant_plain(x, s, bits))


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_int8_matmul_kernel_matches_plain(dev, M, K, N):
    _, s, x4, _, w8, s_w, _ = _operands(dev, M, K, N)
    assert torch.equal(int8_matmul_cuda(x4, w8, s, s_w),
                       int8_matmul_plain(x4, w8, s, s_w))


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_int4_matmul_kernel_matches_plain(dev, M, K, N):
    _, s, x4, wp, _, s_w, _ = _operands(dev, M, K, N)
    assert torch.equal(int4_matmul_cuda(x4, wp, s, s_w),
                       int4_matmul_plain(x4, wp, s, s_w))


@pytest.mark.parametrize("act", ["none", "gelu", "relu"])
def test_int4_matmul_fused_kernel_matches_plain(dev, act):
    _, s, x4, wp, _, s_w, bias = _operands(dev, 300, 312, 1200)
    got = int4_matmul_fused_cuda(x4, wp, s, s_w, bias, act)
    want = int4_matmul_fused_plain(x4, wp, s, s_w, bias, act)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if act != "gelu":
        assert torch.equal(got, want)


def test_odd_k_through_ops_matches_the_cpu(dev):
    """Odd K: packing pads a zero row, ``ops`` pads the activation codes."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((37, 313), generator=g)
    wp = pack_int4(F.pad(torch.randint(-7, 9, (313, 200), generator=g,
                                       dtype=torch.int8), (0, 0, 0, 1)))
    s_a, s_w = torch.tensor(0.3), torch.rand((1, 200), generator=g) * 0.01
    want = ops.int4_matmul(x, wp, s_a, s_w, a_bits=4)
    got = ops.int4_matmul(x.to(dev), wp.to(dev), s_a.to(dev), s_w.to(dev),
                          a_bits=4)
    assert torch.equal(got.cpu(), want)


def test_ops_launch_kernels_and_count_them(dev):
    """One launch of each GEMM, and act_quant only for the GEMMs whose plan
    does not quantize inside (M = 64 at (312, 1200) is split-K: none)."""
    _, s, _, wp, w8, s_w, bias = _operands(dev, 64, 312, 1200)
    x = torch.randn((64, 312), device=dev)
    build.reset_counts()
    ops.int8_matmul(x, w8, s, s_w)
    ops.int4_matmul(x, wp, s, s_w, a_bits=4)
    ops.int4_matmul(x, wp, s, s_w, a_bits=4, bias=bias, act="gelu")
    torch.cuda.synchronize()
    quant = sum(not quantizes_in_gemm(64, 1200, 312, bits) for bits in (8, 4, 4))
    assert build.LAUNCHES == {"act_quant": quant, "int8_matmul": 1,
                              "int4_matmul": 1, "int4_matmul_fused": 1,
                              "decode_attention": 0,
                              "decode_attention_paged": 0,
                              "flash_attention": 0}
    assert not any(build.PLAIN_ON_CUDA.values())


# ------------------------------------------------------ bf16 activations
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_kernels_take_bf16_activations(dev, M, K, N):
    x, s, x4, wp, w8, s_w, bias = _operands(dev, M, K, N)
    xb = x.to(torch.bfloat16)
    for bits in (4, 8):
        assert torch.equal(act_quant_cuda(xb, s, bits), act_quant_plain(xb, s, bits))
    bf = dict(out_dtype=torch.bfloat16)
    got = int8_matmul_cuda(x4, w8, s, s_w, **bf)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, int8_matmul_plain(x4, w8, s, s_w, **bf))
    assert torch.equal(int4_matmul_cuda(x4, wp, s, s_w, **bf),
                       int4_matmul_plain(x4, wp, s, s_w, **bf))
    for act in ("none", "relu"):
        assert torch.equal(int4_matmul_fused_cuda(x4, wp, s, s_w, bias, act, **bf),
                           int4_matmul_fused_plain(x4, wp, s, s_w, bias, act, **bf))


# ------------------------------------------------- integer GEMM paths
def _gemm_operands(dev, M, K, N, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x8 = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    wp = pack_int4(torch.randint(-7, 9, (K, N), generator=g, device=dev,
                                 dtype=torch.int8))
    s_w = torch.rand((1, N), generator=g, device=dev) * 0.01 + 1e-3
    return x8, w8, wp, torch.tensor(0.02, device=dev), s_w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,path", [
    # split-K: M of 1, a decode step, one past it and the last; K at and
    # one word around the 64-row stage edges, ragged N
    (1, 256, 128, PATH_SPLITK), (8, 2560, 2560, PATH_SPLITK),
    (9, 316, 144, PATH_SPLITK), (64, 188, 272, PATH_SPLITK),
    (8, 6912, 2560, PATH_SPLITK), (33, 132, 48, PATH_SPLITK),
    # wgmma: a single tile, ragged M, N and a K that ends half a stage in
    (128, 256, 256, PATH_WGMMA), (1000, 2560, 2560, PATH_WGMMA),
    (300, 192, 400, PATH_WGMMA), (257, 4096, 1040, PATH_WGMMA)])
def test_gemm_paths_match_plain(dev, M, K, N, path, dtype):
    """Each path bit-equal to the plain version, two calls bit-equal."""
    x8, w8, wp, s_a, s_w = _gemm_operands(dev, M, K, N, seed=M + K + N)
    bf = dict(out_dtype=dtype)
    for bits, kernel, plain, w in ((8, int8_matmul_cuda, int8_matmul_plain, w8),
                                   (4, int4_matmul_cuda, int4_matmul_plain, wp)):
        assert gemm_plan(M, N, K, bits).path == path
        got = kernel(x8, w, s_a, s_w, **bf)
        assert torch.equal(got, plain(x8, w, s_a, s_w, **bf)), (bits, M, K, N)
        assert torch.equal(kernel(x8, w, s_a, s_w, **bf), got)


@pytest.mark.parametrize("M,K,N", [(8, 2560, 2560), (256, 512, 512)])
def test_gemm_replays_from_a_graph(dev, M, K, N):
    """A captured call (split-K: its workspace from the graph's pool) gives
    the eager call's bits on every replay."""
    x8, w8, wp, s_a, s_w = _gemm_operands(dev, M, K, N, seed=5)
    bf = dict(out_dtype=torch.bfloat16)
    calls = (lambda: int8_matmul_cuda(x8, w8, s_a, s_w, **bf),
             lambda: int4_matmul_cuda(x8, wp, s_a, s_w, **bf))
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
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)


def _grid_inputs(dev, M, K, a_bits, dtype, seed):
    """Activations on the grid of s = 1/16 (x / s exact): random values, a
    quarter at half-way points x / s = k + 0.5 (rint takes the even k), one
    in twenty past +-qmax."""
    from repro_torch.core.quantizer import qrange
    qmin, qmax = qrange(a_bits)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev) * (0.6 * qmax / 16)
    k = torch.randint(qmin - 4, qmax + 4, (M, K), generator=g, device=dev)
    pick = torch.rand((M, K), generator=g, device=dev)
    x = torch.where(pick < 0.25, (k.float() + 0.5) / 16, x)
    x = torch.where(pick > 0.95, torch.sign(x) * (qmax + 30) / 16, x)
    return x.to(dtype), torch.tensor(1 / 16, device=dev)


@pytest.mark.parametrize("a_bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(1, 256, 128), (8, 2560, 2560), (9, 316, 144),
                                   (64, 188, 272), (8, 6912, 2560), (33, 132, 48)])
def test_split_k_quantizes_float_activations(dev, M, K, N, dtype, a_bits):
    """f32 / bf16 activations handed to the split-K GEMMs: bit-equal to
    act_quant's plain version followed by the plain GEMM, two calls equal,
    one GEMM launch and no act_quant launch each."""
    x, s_a = _grid_inputs(dev, M, K, a_bits, dtype, seed=M + K + a_bits)
    _, w8, wp, _, s_w = _gemm_operands(dev, M, K, N, seed=K)
    x8 = act_quant_plain(x, s_a, a_bits)
    for bits, kernel, plain, w in ((8, int8_matmul_cuda, int8_matmul_plain, w8),
                                   (4, int4_matmul_cuda, int4_matmul_plain, wp)):
        assert quantizes_in_gemm(M, N, K, bits)
        build.reset_counts()
        got = kernel(x, w, s_a, s_w, out_dtype=dtype, a_bits=a_bits)
        torch.cuda.synchronize()
        assert build.LAUNCHES[f"int{bits}_matmul"] == 1 and not build.LAUNCHES["act_quant"]
        assert torch.equal(got, plain(x8, w, s_a, s_w, out_dtype=dtype)), (bits, M, K, N)
        assert torch.equal(kernel(x, w, s_a, s_w, out_dtype=dtype, a_bits=a_bits), got)


def test_quantizing_split_k_replays_from_a_graph(dev):
    """A captured call on bf16 activations gives the eager call's bits."""
    x, s_a = _grid_inputs(dev, 8, 2560, 8, torch.bfloat16, seed=11)
    _, w8, wp, _, s_w = _gemm_operands(dev, 8, 2560, 2560, seed=12)
    calls = (lambda: int8_matmul_cuda(x, w8, s_a, s_w, out_dtype=torch.bfloat16),
             lambda: int4_matmul_cuda(x, wp, s_a, s_w, out_dtype=torch.bfloat16))
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
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)


def test_float_activations_off_split_k_are_refused(dev):
    x = torch.randn((128, 256), device=dev)
    _, w8, _, s_a, s_w = _gemm_operands(dev, 128, 256, 256, seed=1)
    with pytest.raises(ValueError, match="split-K"):
        int8_matmul_cuda(x, w8, s_a, s_w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "gelu", "relu"])
@pytest.mark.parametrize("M,K,N,path", [
    (37, 312, 312, PATH_TILED), (100, 312, 1200, PATH_TILED),
    (8, 312, 1200, PATH_SPLITK), (64, 768, 3072, PATH_SPLITK),
    (128, 312, 1200, PATH_WGMMA), (300, 312, 1200, PATH_WGMMA),
    (1000, 768, 3072, PATH_WGMMA)])
def test_fused_paths_match_plain(dev, M, K, N, path, act, dtype):
    """int4_matmul_fused on each path (K = 312: wgmma's codes at a pitch of
    320), on codes and, on split-K, on f32 activations it quantizes:
    bit-equal to the plain version, GELU too; two calls equal; for M > 64 the first 100 rows bit-equal to
    the tiled kernel's (100 rows take the tiles), GELU included."""
    assert gemm_plan(M, N, K, 4).path == path
    x, s_a = _grid_inputs(dev, M, K, 4, torch.float32, seed=M + K + N)
    x4 = act_quant_plain(x, s_a, 4)
    g = torch.Generator(device=dev).manual_seed(K)
    wp = pack_int4(torch.randint(-7, 9, (K, N), generator=g, device=dev, dtype=torch.int8))
    s_w = torch.rand((1, N), generator=g, device=dev) * 0.01 + 1e-3
    bias = torch.randn((1, N), generator=g, device=dev)
    want = int4_matmul_fused_plain(x4, wp, s_a, s_w, bias, act, out_dtype=dtype)
    inputs = [x4] + ([x] if path == PATH_SPLITK else [])
    for xin in inputs:
        got = int4_matmul_fused_cuda(xin, wp, s_a, s_w, bias, act, out_dtype=dtype,
                                     a_bits=4)
        assert torch.equal(int4_matmul_fused_cuda(xin, wp, s_a, s_w, bias, act,
                                                  out_dtype=dtype, a_bits=4), got)
        assert torch.equal(got, want)
        if M > 64:
            assert gemm_plan(100, N, K, 4).path == PATH_TILED
            tiled = int4_matmul_fused_cuda(x4[:100], wp, s_a, s_w, bias, act,
                                           out_dtype=dtype)
            assert torch.equal(got[:100], tiled)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_quant_padded_pitch(dev, dtype):
    """act_quant at wgmma's pitch for K = 312 (320): the real columns
    bit-equal to the plain version; the wgmma GEMMs take that buffer as it
    is, and poisoning its pad bytes leaves their outputs bit-unchanged."""
    M, K, N = 300, 312, 1200
    plan = gemm_plan(M, N, K, 8)
    pitch = code_pitch(plan, K)
    assert plan.path == PATH_WGMMA and pitch == 320
    x, s_a = _grid_inputs(dev, M, K, 8, dtype, seed=4)
    codes = act_quant_cuda(x, s_a, 8, pitch=pitch)
    assert codes.shape == (M, K) and codes.stride() == (pitch, 1)
    assert torch.equal(codes, act_quant_plain(x, s_a, 8))
    _, w8, wp, _, s_w = _gemm_operands(dev, M, K, N, seed=6)
    bias = torch.randn((1, N), device=dev)
    calls = (lambda: int8_matmul_cuda(codes, w8, s_a, s_w, out_dtype=dtype),
             lambda: int4_matmul_cuda(codes, wp, s_a, s_w, out_dtype=dtype),
             lambda: int4_matmul_fused_cuda(codes, wp, s_a, s_w, bias, "relu",
                                            out_dtype=dtype))
    before = [fn() for fn in calls]
    plain = act_quant_plain(x, s_a, 8)
    assert torch.equal(before[0], int8_matmul_plain(plain, w8, s_a, s_w, out_dtype=dtype))
    assert torch.equal(before[1], int4_matmul_plain(plain, wp, s_a, s_w, out_dtype=dtype))
    codes.as_strided((M, pitch), (pitch, 1))[:, K:] = 0x5A
    for fn, b in zip(calls, before):
        assert torch.equal(fn(), b)


# ------------------------------------------------------ decode attention
def _decode_inputs(dev, B, S, H, Hkv, dh, bits, dtype, lengths, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    kf = torch.randn((B, S, Hkv, dh), generator=g, device=dev)
    vf = torch.randn((B, S, Hkv, dh), generator=g, device=dev)
    k_q, k_s = kv_pack.quantize_kv(kf, bits)
    v_q, v_s = kv_pack.quantize_kv(vf, bits)
    q = torch.randn((B, H, dh), generator=g, device=dev).to(dtype)
    kn = torch.randn((B, Hkv, dh), generator=g, device=dev).to(dtype)
    vn = torch.randn((B, Hkv, dh), generator=g, device=dev).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return [q, k_q, v_q, k_s, v_s, kn, vn, lens]


def _assert_decode_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        # one bf16 ulp of the output, on top of the f32 bound 1e-5: outputs
        # near zero have an ulp far below the f32 difference of the sums
        g, w = got.float(), want.float()
        ulp = 2.0 ** (torch.frexp(torch.maximum(g.abs(), w.abs())).exponent - 8)
        assert bool(((g - w).abs() <= ulp + 1e-5).all()), float((g - w).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("H,Hkv,dh", [(32, 32, 80), (48, 8, 128), (4, 2, 16),
                                      # the kernel's narrower copies: 4-byte
                                      # units and byte loads (dh 20, 6), 8- and
                                      # 4-byte units at G = 1 (dh 24)
                                      (4, 2, 20), (2, 2, 6), (6, 6, 24),
                                      # GQA groups 3, 5 and 8: granite-moe,
                                      # qwen2.5-32b and qwen1.5-110b
                                      (24, 8, 64), (40, 8, 128), (64, 8, 128)])
def test_decode_attention_kernel_matches_plain(dev, H, Hkv, dh, bits, dtype):
    """Lengths across the kernel's tiles (32 rows) and splits (C rows): the
    plain version's bound, two calls bit-equal, rows past the length inert."""
    C = SPLIT_ROWS
    S = 2 * C + 8
    lengths = [0, 1, 5, 31, 32, 33, C - 1, C, C + 1, 2 * C + 1, S, S + 37]
    _check_decode(decode_attention_cuda, _decode_inputs(
        dev, len(lengths), S, H, Hkv, dh, bits, dtype, lengths), lengths, bits)


def _check_decode(kernel, args, lengths, bits):
    got = kernel(*args)
    _assert_decode_close(got, decode_attention_plain(*args))
    assert torch.equal(kernel(*args), got)      # deterministic: no atomics
    # poison every row past each slot's length: the output must not move
    for i, n in enumerate(lengths):
        for t in (1, 2):            # codes
            args[t][i, n:] = 0x5A if bits == 8 else 0xF3
        for t in (3, 4):            # scales, finite garbage
            args[t][i, n:] = 3.0e4
    assert torch.equal(kernel(*args), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("H,Hkv,dh", [(32, 32, 80), (48, 8, 128)])
def test_decode_attention_long_cache_matches_plain(dev, H, Hkv, dh, bits, dtype):
    lengths = [4000, 4096]
    _check_decode(decode_attention_cuda, _decode_inputs(
        dev, 2, 4096, H, Hkv, dh, bits, dtype, lengths, seed=2), lengths, bits)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("H,Hkv,dh", [(32, 32, 80), (48, 8, 128), (4, 2, 16),
                                      (4, 2, 20), (2, 2, 6), (6, 6, 24),
                                      (24, 8, 64), (40, 8, 128), (64, 8, 128)])
def test_decode_attention_paged_kernel_matches_plain_and_dense(dev, H, Hkv, dh,
                                                               bits, dtype):
    """A pool of 40 blocks; tables (8 slots x 9 entries, S = 72) that
    permute the blocks, share some between slots and pad with the sentinel
    (40) and entries past it; lengths 0, 1, partial, S and past S."""
    NB, nb, blk = 40, 9, 8
    lengths = [0, 1, 5, 31, 33, 64, nb * blk, nb * blk + 37]
    g = torch.Generator().manual_seed(bits + H)
    tables = torch.cat([torch.randperm(NB, generator=g),
                        torch.randperm(NB, generator=g)])[:8 * nb].reshape(8, nb)
    tables[3, 2:4] = tables[2, 2:4]          # blocks shared between slots
    tables[1, 1:] = NB                       # the sentinel past the length
    tables[0, 3] = NB + 7
    tables = tables.to(torch.int32).to(dev)
    args = _decode_inputs(dev, NB, blk, H, Hkv, dh, bits, dtype, [0] * NB, seed=1)
    q, kn, vn = (t[:8] for t in (args[0], args[5], args[6]))
    pool = args[1:5]                          # (NB, blk, Hkv, dhp) codes, scales
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = decode_attention_paged_cuda(q, *pool, tables, kn, vn, lens)
    assert torch.equal(decode_attention_paged_cuda(q, *pool, tables, kn, vn, lens), got)
    _assert_decode_close(got, decode_attention_paged_plain(q, *pool, tables, kn, vn, lens))
    dense = [gather_kv_blocks(b, tables).contiguous() for b in pool]
    assert torch.equal(got, decode_attention_cuda(q, *dense, kn, vn, lens))
    # poison every pool row no table reaches below its slot's length
    live = torch.zeros((NB, blk), dtype=torch.bool, device=dev)
    for b, n in enumerate(lengths):
        for pos in range(min(n, nb * blk)):
            live[int(tables[b, pos // blk].clamp(0, NB - 1)), pos % blk] = True
    for t in (pool[0], pool[1]):
        t[~live] = 0x5A if bits == 8 else 0xF3
    for t in (pool[2], pool[3]):
        t[~live] = 3.0e4
    assert torch.equal(decode_attention_paged_cuda(q, *pool, tables, kn, vn, lens), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("H,Hkv,dh", [(32, 32, 80), (48, 8, 128)])
def test_decode_attention_paged_wider_tables_equal_dense(dev, H, Hkv, dh, bits, dtype):
    """Tables reaching 2C + 64 rows against the dense kernel over the first
    2C of them (lengths up to 2C): bit-equal, since the splits are counted
    from row 0 whatever the extent; and two calls bit-equal."""
    blk, C = 8, SPLIT_ROWS
    nb_dense, nb = 2 * C // blk, 2 * C // blk + 8
    lengths = [0, 1, 31, C - 1, C, C + 1, 2 * C - 1, 2 * C]
    NB = len(lengths) * nb + 3
    g = torch.Generator().manual_seed(bits + dh)
    tables = torch.randperm(NB, generator=g)[:len(lengths) * nb].reshape(len(lengths), nb)
    tables = tables.to(torch.int32).to(dev)
    args = _decode_inputs(dev, NB, blk, H, Hkv, dh, bits, dtype, [0] * NB, seed=3)
    q, kn, vn = (t[:len(lengths)] for t in (args[0], args[5], args[6]))
    pool = args[1:5]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = decode_attention_paged_cuda(q, *pool, tables, kn, vn, lens)
    assert torch.equal(decode_attention_paged_cuda(q, *pool, tables, kn, vn, lens), got)
    _assert_decode_close(got, decode_attention_paged_plain(q, *pool, tables, kn, vn, lens))
    dense = [gather_kv_blocks(b, tables[:, :nb_dense]).contiguous() for b in pool]
    assert torch.equal(got, decode_attention_cuda(q, *dense, kn, vn, lens))


def test_decode_step_launches_through_ops(dev):
    """One decode step of a small deployed decoder on the card: every
    linear through an integer GEMM, behind an act_quant launch only where
    its plan at the step's 4 rows does not quantize inside the GEMM (none:
    every linear is split-K), one decode_attention per layer, no plain
    version on a CUDA tensor."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.deploy import ExecutionPlan, deploy
    from repro_torch.models import api
    from repro_torch.serving import GenerationRequest, ServingEngine

    cfg = reduced(get_config("stablelm-3b")).replace(dtype="bfloat16")
    for kv_bits in (8, 4):
        plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=4, mode="int",
                                                    last_k_int4=2),
                                   backend="cuda", kv_bits=kv_bits)
        fp = api.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        calib = [{"tokens": np.arange(1, 33).reshape(2, 16)}]
        eng = ServingEngine(deploy(fp, plan, calib, device=dev), slots=4,
                            max_len=64)
        eng.submit(GenerationRequest(prompt=np.arange(1, 9), max_new_tokens=4))
        eng.engine_step()            # admit + prefill + the first decode step
        build.reset_counts()
        eng.engine_step()            # one decode step
        torch.cuda.synchronize()
        d, q, kv = cfg.d_model, cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
        shapes = [(d, q), (d, kv), (d, kv), (q, d), (d, cfg.d_ff), (d, cfg.d_ff),
                  (cfg.d_ff, d)]
        quant = sum(2 * (not quantizes_in_gemm(4, N, K, bits))
                    for bits in (8, 4) for K, N in shapes)
        assert build.LAUNCHES["act_quant"] == quant
        assert build.LAUNCHES["int8_matmul"] == 2 * 7
        assert build.LAUNCHES["int4_matmul"] == 2 * 7
        assert build.LAUNCHES["decode_attention"] == 4
        assert not any(build.PLAIN_ON_CUDA.values())


# ------------------------------------------------------- flash attention
def _flash_inputs(dev, B, S, H, Hkv, dh, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((B, S, H, dh), (B, S, Hkv, dh), (B, S, Hkv, dh))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hkv,dh", [(2, 256, 4, 2, 16), (1, 512, 8, 8, 64),
                                         (1, 256, 8, 2, 80), (1, 256, 8, 2, 128),
                                         # the bf16 kernel's tiles (128 query
                                         # rows, 64 or 128 keys): S = 1, ragged
                                         # S, dh 80 and 128 at GQA groups 1, 2, 4
                                         (1, 1, 4, 2, 80), (1, 1, 4, 1, 128),
                                         (1, 200, 8, 8, 80), (1, 200, 8, 2, 128),
                                         (1, 384, 8, 4, 80), (1, 384, 8, 8, 128),
                                         (1, 4097, 4, 1, 80), (1, 4097, 4, 2, 128),
                                         # GQA groups 3, 5 and 8 (granite-moe,
                                         # qwen2.5-32b, qwen1.5-110b)
                                         (1, 384, 24, 8, 64), (1, 256, 40, 8, 128),
                                         (1, 256, 64, 8, 128)])
def test_flash_attention_kernel_matches_plain(dev, B, S, H, Hkv, dh, causal, dtype):
    """Within atol 1e-5 and rtol 1e-5 (f32), one bf16 ulp plus 1e-5 (bf16)
    of the plain version at its (64, 64) and (128, 64) blocks (at (S, S)
    where they do not tile S); a causal row 0 equals row 0 of v in its KV
    head exactly (it attends key 0 alone)."""
    q, k, v = _flash_inputs(dev, B, S, H, Hkv, dh, dtype, seed=S + dh)
    got = flash_attention_cuda(q, k, v, causal=causal)
    for bq, bk in [b for b in ((64, 64), (128, 64)) if S % b[0] == 0] or [(S, S)]:
        want = flash_attention_plain(q, k, v, causal=causal, bq=bq, bk=bk)
        assert got.dtype == want.dtype and got.shape == want.shape
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        else:
            _assert_decode_close(got, want)
    if causal:
        heads = torch.arange(H, device=dev) // (H // Hkv)
        assert torch.equal(got[:, 0], v[:, 0, heads])


def test_flash_attention_ragged_length_and_ops_count(dev):
    """A length no tile divides (S = 200) against the plain version in one
    block, and ``ops.flash_attention`` launches the kernel once per call and
    runs no plain version on the card."""
    q, k, v = _flash_inputs(dev, 2, 200, 8, 2, 80, torch.float32, seed=3)
    build.reset_counts()
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == 1
    assert not any(build.PLAIN_ON_CUDA.values())
    torch.testing.assert_close(got, flash_attention_plain(q, k, v, causal=True,
                                                          bq=200, bk=200),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="dh"):
        flash_attention_cuda(*_flash_inputs(dev, 1, 64, 2, 2, 24, torch.float32))


@pytest.mark.parametrize("a_bits", [8, 4])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("E,C,K,N", [(40, 2, 1536, 512), (40, 2, 512, 1536),
                                     (60, 1, 2048, 1408), (4, 256, 1536, 512)])
def test_expert_matmul_route_matches_plain(dev, E, C, K, N, bits, a_bits):
    """``ops.expert_matmul`` (one GEMM launch an expert, each with its own
    scales; split-K at the decode's C, wgmma at C = 256) bit-equal to the
    exact batched product of the reference backend and to each expert's
    plain GEMM, on bf16 activations; E launches, no plain version."""
    from repro_torch.kernels.int8_matmul import expert_matmul_exact
    from repro_torch.models.layers import QuantSpec
    g = torch.Generator(device=dev).manual_seed(E + C + K)
    x = torch.randn((E, C, K), generator=g, device=dev).to(torch.bfloat16)
    codes = torch.randint(-7, 9, (E, K, N), generator=g, device=dev, dtype=torch.int32)
    wq = (codes.to(torch.int8) if bits == 8 else
          pack_int4(codes.to(torch.int8), axis=1))
    p = {"wq": wq, "s_a": torch.rand((E, 1, 1), generator=g, device=dev) * 0.5 + 0.01,
         "s_w": torch.rand((E, 1, N), generator=g, device=dev) * 0.01 + 1e-4}
    build.reset_counts()
    got = ops.expert_matmul(x, p, QuantSpec(mode="int", w_bits=bits, a_bits=a_bits,
                                            use_kernels=True))
    torch.cuda.synchronize()
    assert build.LAUNCHES[f"int{bits}_matmul"] == E
    assert not any(build.PLAIN_ON_CUDA.values())
    want = expert_matmul_exact(x, wq, p["s_a"], p["s_w"], bits, a_bits)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    plain = int8_matmul_plain if bits == 8 else int4_matmul_plain
    for e in (0, E - 1):
        s_a = p["s_a"][e].reshape(())
        x8 = act_quant_plain(x[e], s_a, a_bits)
        assert torch.equal(got[e], plain(x8, wq[e], s_a, p["s_w"][e],
                                         out_dtype=torch.bfloat16))
