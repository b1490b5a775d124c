"""Port parity: the LSQ quantizer, ``qlinear``'s fake mode and calibration.

* ``lsq_quantize``'s forward bit-equal to JAX's at bits 4 and 8, per-tensor
  and per-channel (1, N) scales, on points exactly half-way between two
  codes (round half to even on both sides), at +-qmax and past the clip
  range. Its ``dx`` bit-equal to ``jax.vjp``'s; its ``ds`` within rtol
  1e-6 of ``jax.vjp``'s and of the closed forms (computed in float64) in
  both modes, also for a scale shared by two calls (the two ``ds`` add). The
  ``mse`` gradient ignores the incoming gradient, as JAX's does.
* ``qlinear`` mode ``fake`` (W4A4 and W8A8, mse and ste) against JAX's:
  output within rtol 1e-5 / atol 1e-6 (float sums in another order), and
  the gradients of x, w, s_w and s_a within rtol 1e-4 / atol 1e-6.
* ``weight_scale``, ``ActCalibrator``, ``record_input`` and
  ``calibrate_act_scales_global`` equal to JAX's on the same inputs.

Inputs are made from fixed numpy seeds and explicit example lists, so every
run draws the same cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro.core import qat as jqat
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.core.quantizer import lsq_quantize as jlsq
from repro.models.layers import QuantSpec as JQuantSpec
from repro.models.layers import qlinear as jqlinear
from repro_torch.core import calibration, qat
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantizer import (lsq_quantize, qrange,
                                        reduce_axes_for_scale, scale_shape)
from repro_torch.models.layers import QuantSpec, qlinear

T = lambda a: torch.from_numpy(np.array(a, copy=True))


def _tie_input(bits: int, per_channel: bool):
    """(x, s) with every code's half-way points, +-qmax, the clip edges and
    values past them, plus random values; scales are powers of two so
    ``x / s`` is exact."""
    qmin, qmax = qrange(bits)
    ks = np.arange(qmin - 2, qmax + 2, dtype=np.float32)
    base = np.concatenate([ks + 0.5, ks, [qmin, qmax, qmin - 0.5, qmax + 0.5,
                                          qmax + 3.0, qmin - 3.0]]).astype(np.float32)
    rng = np.random.default_rng(bits)
    extra = rng.uniform(qmin - 2, qmax + 2, 64).astype(np.float32)
    z = np.concatenate([base, extra])
    N = 6
    z = np.resize(z, (len(z) // N + 1) * N).reshape(-1, N)
    if per_channel:
        s = (2.0 ** np.arange(-3, -3 + N)).astype(np.float32).reshape(1, N)
    else:
        s = np.float32(0.25)
    return (z * s).astype(np.float32), np.asarray(s, np.float32)


CASES = [(bits, pc) for bits in (4, 8) for pc in (False, True)]


@pytest.mark.parametrize("bits,per_channel", CASES)
def test_forward_is_bit_equal_on_ties_and_at_the_clip(bits, per_channel):
    x, s = _tie_input(bits, per_channel)
    for mode in ("mse", "ste"):
        got = lsq_quantize(T(x), T(s), bits, mode).numpy()
        want = np.asarray(jlsq(jnp.asarray(x), jnp.asarray(s), bits, mode))
        np.testing.assert_array_equal(got, want)
    # half-way points round to even on both sides
    qmin, qmax = qrange(bits)
    z = np.round(np.clip(x / s, qmin, qmax))
    np.testing.assert_array_equal(got, (s * z).astype(np.float32))


def _closed_form(x, s, g, bits, mode):
    """ds in float64 from the paper's formulas (JAX's ``_lsq_bwd``)."""
    qmin, qmax = qrange(bits)
    x, s, g = (np.asarray(a, np.float64) for a in (x, s, g))
    z = x / s
    zq = np.round(np.clip(z, qmin, qmax))
    inr = (z >= qmin) & (z <= qmax)
    axes = reduce_axes_for_scale(x.ndim, np.shape(s))
    n = x.size / max(np.size(s), 1)
    if mode == "ste":
        elem = np.where(inr, zq - z, np.clip(z, qmin, qmax))
        return np.sum(g * elem, axis=axes).reshape(np.shape(s)) / np.sqrt(n * qmax)
    return 2.0 * np.sum((s * zq - x) * zq, axis=axes).reshape(np.shape(s)) / n


def _port_vjp(x, s, g, bits, mode, uses=1):
    xt, st = T(x).requires_grad_(), T(s).requires_grad_()
    out = sum(lsq_quantize(xt, st, bits, mode) for _ in range(uses))
    out.backward(T(g))
    return xt.grad.numpy(), st.grad.numpy()


def _jax_vjp(x, s, g, bits, mode, uses=1):
    f = lambda a, b: sum(jlsq(a, b, bits, mode) for _ in range(uses))
    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(s))
    dx, ds = vjp(jnp.asarray(g))
    return np.asarray(dx), np.asarray(ds)


@pytest.mark.parametrize("bits,per_channel", CASES)
@pytest.mark.parametrize("mode", ["mse", "ste"])
def test_gradients_match_jax_vjp_and_the_closed_form(bits, per_channel, mode):
    x, s = _tie_input(bits, per_channel)
    g = np.random.default_rng(7).normal(0, 1, x.shape).astype(np.float32)
    dx, ds = _port_vjp(x, s, g, bits, mode)
    jdx, jds = _jax_vjp(x, s, g, bits, mode)
    np.testing.assert_array_equal(dx, jdx)
    assert ds.shape == np.shape(s) and ds.dtype == np.float32
    np.testing.assert_allclose(ds, jds, rtol=1e-6)
    np.testing.assert_allclose(ds, _closed_form(x, s, g, bits, mode), rtol=1e-6)
    qmin, qmax = qrange(bits)
    z = x / s
    np.testing.assert_array_equal(dx, np.where((z >= qmin) & (z <= qmax), g, 0))


@pytest.mark.parametrize("mode", ["mse", "ste"])
def test_a_shared_scale_sums_one_gradient_per_use(mode):
    x, s = _tie_input(4, True)
    g = np.random.default_rng(8).normal(0, 1, x.shape).astype(np.float32)
    dx, ds = _port_vjp(x, s, g, 4, mode, uses=2)
    jdx, jds = _jax_vjp(x, s, g, 4, mode, uses=2)
    np.testing.assert_array_equal(dx, jdx)
    np.testing.assert_allclose(ds, jds, rtol=1e-6)
    np.testing.assert_allclose(ds, 2 * _closed_form(x, s, g, 4, mode), rtol=1e-6)


def test_mse_scale_gradient_ignores_the_incoming_gradient():
    x, s = _tie_input(4, False)
    rng = np.random.default_rng(9)
    ones, other = np.ones_like(x), rng.normal(0, 3, x.shape).astype(np.float32)
    _, ds1 = _port_vjp(x, s, ones, 4, "mse")
    _, ds2 = _port_vjp(x, s, other, 4, "mse")
    np.testing.assert_array_equal(ds1, ds2)
    _, st1 = _port_vjp(x, s, ones, 4, "ste")
    _, st2 = _port_vjp(x, s, other, 4, "ste")
    assert not np.array_equal(st1, st2)


def test_lsq_saves_only_x_and_s():
    x, s = T(np.ones((3, 4), np.float32)).requires_grad_(), torch.tensor(0.5, requires_grad=True)
    out = lsq_quantize(x, s, 4, "mse")
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 2 and saved[0] is x and saved[1] is s


def test_scale_shape_and_reduce_axes_match_jax():
    from repro.core.quantizer import reduce_axes_for_scale as jred
    from repro.core.quantizer import scale_shape as jshape
    for shape, axis in (((4, 6), None), ((4, 6), -1), ((2, 4, 6), 1), ((2, 4, 6), 0)):
        assert scale_shape(shape, axis) == jshape(shape, axis)
        ss = scale_shape(shape, axis)
        assert reduce_axes_for_scale(len(shape), ss) == jred(len(shape), ss)
    assert reduce_axes_for_scale(3, (1, 6)) == jred(3, (1, 6)) == (0, 1)


def test_bf16_input_is_quantized_in_f32_as_jax_promotes():
    x = np.random.default_rng(3).normal(0, 1, (8, 16)).astype(np.float32)
    s = np.float32(0.125)
    got = lsq_quantize(T(x).to(torch.bfloat16), T(s), 4, "mse")
    want = jlsq(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s), 4, "mse")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


# ------------------------------------------------------------ fake qlinear
def _linear_inputs(K=24, N=16, M=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, M, K)).astype(np.float32)
    w = (rng.normal(0, 0.05, (K, N))).astype(np.float32)
    b = rng.normal(0, 0.1, (N,)).astype(np.float32)
    s_w = (np.abs(w).max(0, keepdims=True) / 8).astype(np.float32)
    s_a = np.float32(np.abs(x).max() / 8 * 0.7)   # some activations clip
    return x, {"w": w, "b": b, "s_w": s_w, "s_a": s_a}


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("mode", ["mse", "ste"])
def test_fake_qlinear_matches_jax_in_forward_and_grads(bits, mode):
    x, p = _linear_inputs(seed=bits)
    r = np.random.default_rng(11).normal(0, 1, (2, 10, 16)).astype(np.float32)
    jspec = JQuantSpec(mode="fake", w_bits=bits, a_bits=bits, grad_mode=mode)
    spec = QuantSpec(mode="fake", w_bits=bits, a_bits=bits, grad_mode=mode)

    def jloss(xx, w, s_w, s_a):
        out = jqlinear(xx, {"w": w, "b": jnp.asarray(p["b"]), "s_w": s_w, "s_a": s_a}, jspec)
        return jnp.sum(out * r), out
    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x), jnp.asarray(p["w"]), jnp.asarray(p["s_w"]), jnp.asarray(p["s_a"]))

    leaves = [T(a).requires_grad_() for a in (x, p["w"], p["s_w"], p["s_a"])]
    out = qlinear(leaves[0], {"w": leaves[1], "b": T(p["b"]), "s_w": leaves[2],
                              "s_a": leaves[3]}, spec)
    (out * T(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    for name, t, want in zip(("x", "w", "s_w", "s_a"), leaves, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_fake_mode_off_is_the_fp_matmul():
    x, p = _linear_inputs()
    tp = {k: T(v) for k, v in p.items()}
    off = qlinear(T(x), tp, QuantSpec(mode="fake", w_bits=0))
    fp = qlinear(T(x), tp, QuantSpec())
    np.testing.assert_array_equal(off.numpy(), fp.numpy())


# ------------------------------------------------------------- calibration
def test_weight_scale_matches_jax():
    from repro.core.calibration import weight_scale as jws
    w = np.random.default_rng(4).normal(0, 0.3, (3, 12, 8)).astype(np.float32)
    for bits in (4, 8):
        for axis in (None, -1, 1):
            np.testing.assert_array_equal(
                calibration.weight_scale(T(w), bits, axis).numpy(),
                np.asarray(jws(jnp.asarray(w), bits, axis)))


def test_act_calibrator_matches_jax():
    rng = np.random.default_rng(5)
    batches = [rng.standard_t(3, (n, 97)).astype(np.float32) for n in (10, 80, 3)]
    for bits in (4, 8):
        ours, ref = calibration.ActCalibrator(seed=3), jcal.ActCalibrator(seed=3)
        for b in batches:
            ours.update(T(b))
            ref.update(jnp.asarray(b))
        np.testing.assert_array_equal(ours.scale(bits).numpy(), np.asarray(ref.scale(bits)))
    assert float(calibration.ActCalibrator().scale(4)) == float(jcal.ActCalibrator().scale(4)) == 1.0


def test_record_input_per_axis0_matches_jax():
    x = np.random.default_rng(6).normal(0, 1, (3, 5, 7)).astype(np.float32)
    with calibration.calibration_mode() as cm:
        calibration.record_input(T(x), per_axis0=True)
        calibration.record_input(T(x))
    with jcal.calibration_mode() as jcm:
        jcal.record_input(jnp.asarray(x), per_axis0=True)
        jcal.record_input(jnp.asarray(x))
    assert len(cm.records) == len(jcm.records) == 2
    for a, b in zip(cm.records, jcm.records):
        np.testing.assert_array_equal(a, b)


def test_calibrate_act_scales_global_matches_jax():
    from repro.configs import get_config as jget, reduced as jred
    from repro.models.bert import bert_encode as jencode
    from repro.models.bert import init_bert_classifier as jinit
    from repro_torch.configs import get_config, reduced
    from repro_torch.deploy import ExecutionPlan, params_from_numpy
    from repro_torch.models.bert import bert_encode

    jcfg = jred(jget("tinybert4")).replace(num_layers=2)
    cfg = reduced(get_config("tinybert4")).replace(num_layers=2)
    jp = jinit(jcfg, 2, jax.random.PRNGKey(0))
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(2)
    batches = [{"tokens": rng.integers(1, 256, (2, 12)).astype(np.int32)} for _ in range(2)]
    jpol = JQuantPolicy(num_layers=2, mode="fake", last_k_int4=1)
    pol = QuantPolicy(num_layers=2, mode="fake", last_k_int4=1)
    jsegs = [(0, 2, JQuantSpec())]
    want = jqat.calibrate_act_scales_global(
        jp, jcfg, jpol, lambda pp, b: jencode(pp, jcfg, jsegs, jnp.asarray(b["tokens"])),
        batches)
    plan = ExecutionPlan.build(cfg, None, mode="encoder")
    got = qat.calibrate_act_scales_global(
        p, cfg, pol, lambda pp, b: bert_encode(pp, plan, b["tokens"]), batches)
    for site in ("wq", "wk", "wv", "wo"):
        np.testing.assert_allclose(got["layers"]["attn"][site]["s_a"].numpy(),
                                   np.asarray(want["layers"]["attn"][site]["s_a"]),
                                   rtol=1e-6)
    np.testing.assert_allclose(got["pooler"]["b"].numpy(), np.asarray(want["pooler"]["b"]))
