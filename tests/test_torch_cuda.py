"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card with nvcc (the kernels are built at
first use) and skips, inside its fixture, on a host without CUDA: a CUDA
kernel has no CPU mode. The file imports no JAX, so it runs on a machine
with PyTorch alone:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Codes and unfused outputs must be bit-equal to the plain versions; the
fused tanh-GELU epilogue within rtol = atol = 1e-6.
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core.packing import pack_int4
from repro_torch.kernels import build, ops
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
                              "int4_matmul": 1, "int4_matmul_fused": 1}
    assert not any(build.PLAIN_ON_CUDA.values())
