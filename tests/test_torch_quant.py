"""Port parity: integer helpers and the four kernels' plain versions.

The same numpy inputs go through the JAX package (its Pallas kernels in
interpret mode on the CPU, and its jnp references) and through the port's
plain PyTorch versions, which CPU tensors take. Integer codes, packed
nibbles and the f32 epilogues are held bit-equal; the tanh-GELU epilogue
within rtol = atol = 1e-6 (XLA and PyTorch evaluate tanh differently).
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro.core import quantizer as jquant
from repro.kernels import kv_pack as jkv
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import packing, quantizer
from repro_torch.kernels import build, kv_pack, ops
from repro_torch.kernels.act_quant import act_quant_cuda
from repro_torch.kernels.int4_matmul import (int4_matmul_cuda,
                                             int4_matmul_fused_plain,
                                             int4_matmul_plain)
from repro_torch.kernels.int8_matmul import int8_matmul_cuda
from repro_torch.models.layers import act_fn


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _operands(seed, M, K, N, a_bits):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.5, (M, K)).astype(np.float32)
    s_a = np.float32(np.abs(x).max() * 0.7 / quantizer.qrange(a_bits)[1])
    s_w = (rng.random((1, N)) * 0.01 + 1e-3).astype(np.float32)
    bias = rng.normal(0, 1, (N,)).astype(np.float32)
    return x, np.asarray(s_a), s_w, bias


# ------------------------------------------------------------ quantizer
@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
def test_qrange_matches_reference(bits):
    assert quantizer.qrange(bits) == jquant.qrange(bits)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_to_int_bit_equal_with_half_way_values(bits):
    rng = np.random.default_rng(bits)
    s = np.float32(0.25)                 # a power of two: x / s is exact
    qmin, qmax = quantizer.qrange(bits)
    halves = (np.arange(qmin - 2, qmax + 2) + 0.5).astype(np.float32) * s
    x = np.concatenate([halves, rng.normal(0, 12, 500).astype(np.float32)])
    want = np.asarray(jquant.quantize_to_int(jnp.asarray(x), jnp.float32(s), bits))
    got = quantizer.quantize_to_int(_t(x), torch.tensor(s), bits).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    # half to even, not away from zero: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
    probe = np.array([0.5, 1.5, -2.5], np.float32) * s
    np.testing.assert_array_equal(
        quantizer.quantize_to_int(_t(probe), torch.tensor(s), bits).numpy(),
        [0, 2, -2])
    np.testing.assert_array_equal(
        quantizer.dequantize(_t(want), torch.tensor(s)).numpy(),
        np.asarray(jquant.dequantize(jnp.asarray(want), jnp.float32(s))))


@pytest.mark.parametrize("K", [7, 8, 33])
def test_packing_and_weight_quantization_bit_equal(K):
    rng = np.random.default_rng(K)
    N = 6
    codes = rng.integers(-7, 9, (2 * K, N)).astype(np.int8)
    packed = np.asarray(jpacking.pack_int4(jnp.asarray(codes), axis=0))
    got = packing.pack_int4(_t(codes), axis=0)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), packed)
    np.testing.assert_array_equal(packing.unpack_int4(got, axis=0).numpy(), codes)
    # stacked (L, K, N) weights with odd K pad one zero row before packing
    w = rng.normal(0, 0.05, (3, K, N)).astype(np.float32)
    s = (np.abs(w).max(axis=1, keepdims=True) / 8).astype(np.float32)
    for bits in (4, 8):
        want, _ = jpacking.quantize_weight(jnp.asarray(w), jnp.asarray(s), bits)
        have, _ = packing.quantize_weight(_t(w), _t(s), bits)
        assert have.dtype == (torch.uint8 if bits == 4 else torch.int8)
        np.testing.assert_array_equal(have.numpy(), np.asarray(want))


def test_unpack_nibbles_rows_bit_equal():
    wp = np.random.default_rng(0).integers(0, 256, (9, 5)).astype(np.uint8)
    want = np.asarray(jkv.unpack_nibbles_rows(jnp.asarray(wp)))
    np.testing.assert_array_equal(kv_pack.unpack_nibbles_rows(_t(wp)).numpy(), want)
    assert kv_pack.INT4_BIAS == jkv.INT4_BIAS == packing.INT4_BIAS


# ------------------------------------------------------- kernels, plain
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [37, 8])
def test_act_quant_plain_bit_equal(M, bits):
    x, s, _, _ = _operands(M, M, 24, 1, bits)
    want_kernel = np.asarray(jops.act_quant(jnp.asarray(x), jnp.asarray(s), bits))
    want_ref = np.asarray(jref.act_quant_ref(jnp.asarray(x), jnp.asarray(s), bits))
    got = ops.act_quant(_t(x), _t(s), bits).numpy()
    np.testing.assert_array_equal(got, want_kernel)
    np.testing.assert_array_equal(got, want_ref)


@pytest.mark.parametrize("a_bits", [4, 8])
def test_int8_matmul_plain_bit_equal(a_bits):
    M, K, N = 24, 40, 48
    x, s_a, s_w, _ = _operands(a_bits, M, K, N, a_bits)
    w8 = np.random.default_rng(1).integers(-127, 128, (K, N)).astype(np.int8)
    want = np.asarray(jops.int8_matmul(jnp.asarray(x), jnp.asarray(w8),
                                       jnp.asarray(s_a), jnp.asarray(s_w), a_bits))
    got = ops.int8_matmul(_t(x), _t(w8), _t(s_a), _t(s_w), a_bits).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("K", [40, 39])
def test_int4_matmul_plain_bit_equal(K):
    """Odd K goes through ``ops``: packing padded K, so the activation codes
    get a zero column."""
    M, N = 16, 24
    x, s_a, s_w, _ = _operands(K, M, K, N, 4)
    w = np.random.default_rng(2).normal(0, 0.05, (K, N)).astype(np.float32)
    ws = (np.abs(w).max(axis=0, keepdims=True) / 8).astype(np.float32)
    wp, _ = jpacking.quantize_weight(jnp.asarray(w), jnp.asarray(ws), 4)
    wp = np.asarray(wp)
    assert wp.shape[0] == (K + 1) // 2
    want = np.asarray(jops.int4_matmul(jnp.asarray(x), jnp.asarray(wp),
                                       jnp.asarray(s_a), jnp.asarray(s_w), 4))
    got = ops.int4_matmul(_t(x), _t(wp), _t(s_a), _t(s_w), 4).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("act", ["none", "gelu", "relu"])
def test_int4_matmul_fused_plain_matches_reference(act):
    """Against the JAX epilogue evaluated op by op (``r = acc*scale;
    r = r + b; act``): bit-equal for none/relu, rtol = atol = 1e-6 for GELU
    (tanh differs between XLA and PyTorch). The Pallas kernel in interpret
    mode differs from both in the last bit for none/relu: XLA's CPU
    compiler contracts ``acc*scale + b`` in the jitted kernel body into one
    fused multiply-add, which the test shows by matching it exactly, while
    the port rounds the product and the sum separately (as its own unfused
    composition does, which keeps fused == unfused bit-equal inside the
    port)."""
    M, K, N = 16, 32, 40
    x, s_a, s_w, bias = _operands(5, M, K, N, 4)
    wp = np.random.default_rng(3).integers(0, 256, (K // 2, N)).astype(np.uint8)
    jx8 = jops.act_quant(jnp.asarray(x), jnp.asarray(s_a), 4)
    r = jref.int4_matmul_ref(jx8, jnp.asarray(wp), jnp.asarray(s_a),
                             jnp.asarray(s_w)) + jnp.asarray(bias)
    eager = np.asarray({"none": lambda v: v, "relu": lambda v: jnp.maximum(v, 0.0),
                        "gelu": lambda v: jax.nn.gelu(v, approximate=True)}[act](r))
    kernel = np.asarray(jops.int4_matmul(jnp.asarray(x), jnp.asarray(wp),
                                         jnp.asarray(s_a), jnp.asarray(s_w), 4,
                                         bias=jnp.asarray(bias), act=act))
    got = ops.int4_matmul(_t(x), _t(wp), _t(s_a), _t(s_w), 4, bias=_t(bias),
                          act=act).numpy()
    if act == "gelu":
        np.testing.assert_allclose(got, eager, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, kernel, rtol=1e-6, atol=1e-6)
        return
    np.testing.assert_array_equal(got, eager)
    # the interpret-mode kernel is exactly the single-rounding fma(acc, scale,
    # b): the product of an int32 accumulator and an f32 scale is exact in
    # float64, and so is the sum at these magnitudes
    acc = np.asarray(jref.int4_matmul_ref(jx8, jnp.asarray(wp), jnp.float32(1.0),
                                          jnp.ones((1, N), jnp.float32)), np.float64)
    scale = (s_a * s_w).astype(np.float64)
    fma = (acc * scale + bias.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(kernel, fma if act == "none" else np.maximum(fma, 0))


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_fused_equals_unfused_inside_the_port(act):
    """The fused epilogue == the port's own composition (matmul, + bias,
    activation), bit for bit at f32."""
    M, K, N = 20, 32, 24
    x, s_a, s_w, bias = _operands(6, M, K, N, 4)
    wp = np.random.default_rng(4).integers(0, 256, (K // 2, N)).astype(np.uint8)
    x8 = ops.act_quant(_t(x), _t(s_a), 4)
    fused = int4_matmul_fused_plain(x8, _t(wp), _t(s_a), _t(s_w),
                                    _t(bias).reshape(1, N), act)
    unfused = act_fn(act)(int4_matmul_plain(x8, _t(wp), _t(s_a), _t(s_w)) + _t(bias))
    assert torch.equal(fused, unfused)


def test_cpu_tensors_take_the_plain_versions():
    build.reset_counts()
    x, s_a, s_w, bias = _operands(7, 8, 16, 8, 8)
    wp = np.zeros((8, 8), np.uint8)
    ops.int8_matmul(_t(x), torch.ones((16, 8), dtype=torch.int8), _t(s_a), _t(s_w))
    ops.int4_matmul(_t(x), _t(wp), _t(s_a), _t(s_w), bias=_t(bias), act="gelu")
    assert not any(build.LAUNCHES.values())
    assert not any(build.PLAIN_ON_CUDA.values())


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never runs a CPU tensor: it raises before any build."""
    x = torch.zeros((4, 8))
    s = torch.tensor(1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        act_quant_cuda(x, s, 8)
    x8 = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        int8_matmul_cuda(x8, x8.T.contiguous(), s, torch.ones((1, 4)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        int4_matmul_cuda(x8, torch.zeros((4, 4), dtype=torch.uint8), s,
                         torch.ones((1, 4)))
