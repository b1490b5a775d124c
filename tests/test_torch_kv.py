"""Port parity: the quantized KV cache helpers, decode attention, RoPE,
RMSNorm, SiLU, and bf16 activations through the kernel path.

The same numpy inputs go through the JAX package (its Pallas decode-
attention kernel in interpret mode, as its own tests run it on the CPU) and
through the port's plain PyTorch versions, which CPU tensors take.
Tolerances:

* KV codes, scales, packed nibbles and dequantized rows: bit-equal;
* decode attention: atol 1e-5, rtol 0 (JAX's own kernel-vs-reference bar;
  the Pallas kernel sums an online softmax, the plain version one pass);
  rows past each slot's length poisoned: bit-unchanged;
* RoPE, RMSNorm, SiLU, the fp-cache attention: rtol 1e-6, atol 1e-6
  (XLA and PyTorch evaluate pow/cos/sin/exp differently);
* ``qlinear`` with bf16 activations on the kernel path: the JAX dtype and
  bit-equal values (integer accumulators, one f32 epilogue, one rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import quantize_weight as jquantize_weight
from repro.kernels import kv_pack as jkv
from repro.kernels import ops as jops
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro_torch.kernels import build, kv_pack, ops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.models import attention, layers


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) and x.dtype == torch.bfloat16
                      else x)


# ------------------------------------------------------------- kv_pack
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(3, 5, 4, 16), (2, 7, 3, 20)])
def test_quantize_kv_bit_equal(bits, shape):
    rng = np.random.default_rng(bits + shape[-1])
    x = rng.normal(0, 1.3, shape).astype(np.float32)
    x[0, 1] = 0.0                        # all-zero rows: cache padding
    x[1, 2, 0] = 0.5 * np.arange(shape[-1]) / shape[-1]  # exact halves
    jc, js = jkv.quantize_kv(jnp.asarray(x), bits)
    tc, ts = kv_pack.quantize_kv(_t(x), bits)
    assert str(tc.dtype).endswith(str(np.asarray(jc).dtype))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jkv.dequantize_kv(jc, js, jdt).astype(jnp.float32))
        got = kv_pack.dequantize_kv(tc, ts, dt)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_nibble_packing_bit_equal_and_inverse():
    rng = np.random.default_rng(1)
    codes = rng.integers(-7, 9, (4, 6, 20)).astype(np.int8)
    packed = kv_pack.pack_nibbles_last(_t(codes))
    assert packed.dtype == torch.uint8 and packed.shape == (4, 6, 10)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jkv.pack_nibbles_last(jnp.asarray(codes))))
    np.testing.assert_array_equal(kv_pack.unpack_nibbles_last(packed).numpy(), codes)
    with pytest.raises(ValueError, match="even"):
        kv_pack.pack_nibbles_last(_t(codes[..., :5]))


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_kv_layout_helpers_match(bits):
    assert kv_pack.kv_buffer_keys(bits) == jkv.kv_buffer_keys(bits)
    for n_kv, hd in ((32, 80), (8, 128), (2, 16)):
        assert (kv_pack.kv_row_bytes(n_kv, hd, bits)
                == jkv.kv_row_bytes(n_kv, hd, bits))
        if bits != 16:
            assert kv_pack.kv_code_shape(hd, bits) == jkv.kv_code_shape(hd, bits)
            assert str(kv_pack.kv_code_dtype(bits)).endswith(
                jnp.dtype(jkv.kv_code_dtype(bits)).name)
            assert kv_pack.kv_qmax(bits) == jkv.kv_qmax(bits)


# ---------------------------------------------------- decode attention
def _decode_case(seed, B, S, H, Hkv, dh, bits, lengths):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f(B, H, dh), f(B, S, Hkv, dh), f(B, S, Hkv, dh)
    kn, vn = f(B, Hkv, dh), f(B, Hkv, dh)
    kq, ks = jkv.quantize_kv(jnp.asarray(k), bits)
    vq, vs = jkv.quantize_kv(jnp.asarray(v), bits)
    return [q, np.array(kq), np.array(vq), np.array(ks), np.array(vs),
            kn, vn, np.asarray(lengths, np.int32)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("B,S,H,Hkv,dh", [(4, 64, 8, 4, 16), (4, 40, 4, 2, 20)])
def test_decode_attention_plain_matches_pallas(bits, B, S, H, Hkv, dh):
    lengths = [0, 5, S, S + 3]
    arrays = _decode_case(bits + dh, B, S, H, Hkv, dh, bits, lengths)
    want = np.asarray(jops.decode_attention(*map(jnp.asarray, arrays)))
    got = decode_attention_plain(*map(_t, arrays))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_decode_attention_plain_ignores_rows_past_length(bits):
    S = 32
    lengths = [0, 4, 9, S]
    arrays = _decode_case(7, 4, S, 4, 2, 8, bits, lengths)
    base = decode_attention_plain(*map(_t, arrays))
    for i, n in enumerate(lengths):
        arrays[1][i, n:] = 0x5A if bits == 8 else 0xFF
        arrays[2][i, n:] = 0x5A if bits == 8 else 0xFF
        arrays[3][i, n:] = 1e4
        arrays[4][i, n:] = 1e4
    assert torch.equal(decode_attention_plain(*map(_t, arrays)), base)


def test_ops_decode_attention_takes_the_plain_version_on_cpu():
    arrays = _decode_case(3, 2, 16, 4, 4, 8, 8, [3, 3])
    tensors = list(map(_t, arrays))
    build.reset_counts()
    got = ops.decode_attention(*tensors[:7], torch.tensor(3, dtype=torch.int32))
    assert build.LAUNCHES["decode_attention"] == 0
    assert build.PLAIN_ON_CUDA["decode_attention"] == 0
    assert torch.equal(got, decode_attention_plain(*tensors))


def test_cached_decode_attention_matches_reference():
    """The fp-cache path (prefill and kv_bits 16): a 3-token chunk at
    per-slot cursors, causal among the new tokens."""
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, kc, vc, kn, vn = f(2, 3, 4, 16), f(2, 12, 4, 16), f(2, 12, 4, 16), \
        f(2, 3, 4, 16), f(2, 3, 4, 16)
    lens = np.array([0, 7], np.int32)
    want = jattention.cached_decode_attention(*map(jnp.asarray, (q, kc, vc, kn, vn, lens)))
    got = attention.cached_decode_attention(*map(_t, (q, kc, vc, kn, vn, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- rope / norms
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 5, 3, 20)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [37, 38, 39, 40, 41]], np.int32)
    jc, js = jlayers.rope_tables(jnp.asarray(pos), 20, theta)
    tc, ts = layers.rope_tables(_t(pos), 20, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    want = jlayers.apply_rope(jnp.asarray(x), jc, js)
    got = layers.apply_rope(_t(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_rmsnorm_and_silu_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (3, 7, 64)).astype(np.float32)
    scale = rng.normal(1, 0.1, (64,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm(_t(x), _t(scale)).numpy(),
        np.asarray(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        layers.act_fn("silu")(_t(x)).numpy(),
        np.asarray(jlayers.act_fn("silu")(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


# ------------------------------------------- bf16 through the kernel path
@pytest.mark.parametrize("w_bits", [8, 4])
def test_bf16_qlinear_kernel_path_matches_jax(w_bits):
    """bf16 activations through ``qlinear(use_kernels=True)``: the port
    returns JAX's dtype (bf16, not f32) with bit-equal values."""
    rng = np.random.default_rng(w_bits)
    x = rng.normal(0, 1, (2, 5, 64)).astype(np.float32)
    w = rng.normal(0, 0.05, (64, 48)).astype(np.float32)
    qmax = 127 if w_bits == 8 else 8
    s_w = (np.abs(w).max(0, keepdims=True) / qmax).astype(np.float32)
    wq, _ = jquantize_weight(jnp.asarray(w), jnp.asarray(s_w), w_bits)
    p = {"wq": np.asarray(wq), "s_w": s_w,
         "s_a": np.asarray(np.float32(np.abs(x).max() / qmax)),
         "b": rng.normal(0, 1, (48,)).astype(np.float32)}
    jspec = jlayers.QuantSpec(mode="int", w_bits=w_bits, a_bits=w_bits,
                              use_pallas=True)
    want = jlayers.qlinear(jnp.asarray(x).astype(jnp.bfloat16),
                           jax.tree.map(jnp.asarray, p), jspec)
    spec = layers.QuantSpec(mode="int", w_bits=w_bits, a_bits=w_bits,
                            use_kernels=True)
    got = layers.qlinear(_t(x).to(torch.bfloat16),
                         {k: _t(v) for k, v in p.items()}, spec)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
