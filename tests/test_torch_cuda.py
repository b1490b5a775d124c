"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card with nvcc (the kernels are built at
first use) and skips, inside its fixture, on a host without CUDA: a CUDA
kernel has no CPU mode. The file imports no JAX, so it runs on a machine
with PyTorch alone:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Codes and unfused outputs must be bit-equal to the plain versions (f32
and bf16 activations); the fused tanh-GELU epilogue within rtol = atol =
1e-6. Decode attention within atol 1e-5 (rtol 0) for f32 and one bf16 ulp
plus 1e-5 for bf16 (the online and the one-pass softmax sum in different
orders, and that f32 difference survives the rounding of outputs near
zero), and
bit-unchanged when the cache rows past each slot's length are poisoned.
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core.packing import pack_int4
from repro_torch.kernels import build, kv_pack, ops
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.act_quant import act_quant_cuda, act_quant_plain
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
    _, s, _, wp, w8, s_w, bias = _operands(dev, 64, 312, 1200)
    x = torch.randn((64, 312), device=dev)
    build.reset_counts()
    ops.int8_matmul(x, w8, s, s_w)
    ops.int4_matmul(x, wp, s, s_w, a_bits=4)
    ops.int4_matmul(x, wp, s, s_w, a_bits=4, bias=bias, act="gelu")
    torch.cuda.synchronize()
    assert build.LAUNCHES == {"act_quant": 3, "int8_matmul": 1,
                              "int4_matmul": 1, "int4_matmul_fused": 1,
                              "decode_attention": 0}
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
@pytest.mark.parametrize("H,Hkv,dh", [(32, 32, 80), (48, 8, 128), (4, 2, 16)])
def test_decode_attention_kernel_matches_plain(dev, H, Hkv, dh, bits, dtype):
    S = 72
    lengths = [0, 1, 5, 31, 32, 33, S, S + 37]
    args = _decode_inputs(dev, len(lengths), S, H, Hkv, dh, bits, dtype, lengths)
    got = decode_attention_cuda(*args)
    _assert_decode_close(got, decode_attention_plain(*args))
    # poison every row past each slot's length: the output must not move
    for i, n in enumerate(lengths):
        for t in (1, 2):            # codes
            args[t][i, n:] = 0x5A if bits == 8 else 0xF3
        for t in (3, 4):            # scales, finite garbage
            args[t][i, n:] = 3.0e4
    assert torch.equal(decode_attention_cuda(*args), got)


def test_decode_step_launches_through_ops(dev):
    """One decode step of a small deployed decoder on the card: every
    linear through act_quant + an integer GEMM, one decode_attention per
    layer, no plain version on a CUDA tensor."""
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
        assert build.LAUNCHES["act_quant"] == 4 * 7
        assert build.LAUNCHES["int8_matmul"] == 2 * 7
        assert build.LAUNCHES["int4_matmul"] == 2 * 7
        assert build.LAUNCHES["decode_attention"] == 4
        assert not any(build.PLAIN_ON_CUDA.values())
