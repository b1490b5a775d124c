"""Port parity: the Mamba2 (SSD) block of ``models/mamba2.py`` against the
JAX package's, on the same seeded numpy inputs and JAX's own arrays.

* ``ssd_chunked`` (f32): output and final state within atol 2e-5 / rtol
  1e-5 of JAX's, at two chunk sizes; the port's chunked output equals its
  own one-token recurrence (``ssd_decode_step`` over the same S) within the
  same tolerance, and the recurrence equals JAX's step by step.
* ``_causal_conv``: bit-equal to JAX's without a cache; with one, fed one
  token at a time, equal to the cacheless conv (the window carries).
* ``mamba2_block`` on a reduced zamba2-2.7b layer (d 64, 8 heads of 16,
  state 8): fp within atol 1e-5 / rtol 1e-5 of JAX's, cacheless and one
  decode step; deployed int (W8A8 and W4A4) with every activation code and
  every int32 accumulator of its five quantized linears bit-equal to JAX's
  and the output within atol 1e-5 / rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.core import qat as jqat
from repro.models import layers as jlayers
from repro.models import mamba2 as jm
from repro.models.layers import QuantSpec as JSpec
from repro_torch.configs import get_config, reduced
from repro_torch.core import qat
from repro_torch.deploy import params_from_numpy
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tm
from repro_torch.models.layers import QuantSpec

ARCH = "zamba2-2.7b"


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _ssd_inputs(seed, B=2, S=16, H=4, P=8, N=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    a_log = rng.normal(scale=0.5, size=(H,)).astype(np.float32)
    b = rng.normal(size=(B, S, N)).astype(np.float32)
    c = rng.normal(size=(B, S, N)).astype(np.float32)
    return x, dt, a_log, b, c


@pytest.mark.parametrize("chunk", [4, 8])
def test_ssd_chunked_matches_jax(chunk):
    ins = _ssd_inputs(chunk)
    y_j, st_j = jm.ssd_chunked(*map(jnp.asarray, ins), chunk)
    y, st = tm.ssd_chunked(*map(_t, ins), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), atol=2e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        tm.ssd_chunked(*map(_t, _ssd_inputs(0, S=10)), chunk)


def test_ssd_decode_steps_equal_the_chunked_scan():
    x, dt, a_log, b, c = map(_t, _ssd_inputs(3))
    B, S, H, P = x.shape
    y_chunk, final = tm.ssd_chunked(x, dt, a_log, b, c, 4)
    state = torch.zeros((B, H, P, b.shape[-1]))
    jstate = jnp.zeros((B, H, P, b.shape[-1]))
    ys = []
    for t in range(S):
        sl = lambda a: a[:, t:t + 1]
        y, state = tm.ssd_decode_step(state, sl(x), sl(dt), a_log, sl(b), sl(c))
        jy, jstate = jm.ssd_decode_step(jstate, *(jnp.asarray(sl(a).numpy())
                                                  for a in (x, dt)),
                                        jnp.asarray(a_log.numpy()),
                                        *(jnp.asarray(sl(a).numpy()) for a in (b, c)))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_chunk.numpy(),
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(state.numpy(), final.numpy(), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), atol=1e-5, rtol=1e-5)


def test_causal_conv_with_and_without_its_cache():
    rng = np.random.default_rng(4)
    u = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(tm.CONV_K, 12)).astype(np.float32)
    want, none = jm._causal_conv(jnp.asarray(u), jnp.asarray(w))
    got, cache = tm._causal_conv(_t(u), _t(w))
    assert none is None and cache is None
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cache = torch.zeros((2, tm.CONV_K - 1, 12))
    jcache = jnp.zeros((2, tm.CONV_K - 1, 12))
    steps = []
    for t in range(u.shape[1]):
        out, cache = tm._causal_conv(_t(u[:, t:t + 1]), _t(w), cache)
        jout, jcache = jm._causal_conv(jnp.asarray(u[:, t:t + 1]), jnp.asarray(w), jcache)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(cache.numpy(), np.asarray(jcache))
        steps.append(out)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), got.numpy(), atol=1e-6,
                               rtol=1e-6)


# ------------------------------------------------------------------ block
@pytest.fixture(scope="module")
def block():
    """JAX's reduced layer (a_log / dt_bias / d_skip redrawn away from
    their constant init, so the gates matter), numpy."""
    jcfg = jreduced(jget(ARCH))
    p = jax.tree.map(np.asarray, jm.init_mamba2_block(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(5)
    H = p["a_log"].shape[0]
    p["a_log"] = rng.normal(scale=0.5, size=H).astype(np.float32)
    p["dt_bias"] = rng.normal(scale=0.5, size=H).astype(np.float32)
    p["d_skip"] = rng.normal(size=H).astype(np.float32)
    p["norm"]["scale"] = rng.uniform(0.5, 1.5, p["norm"]["scale"].shape).astype(np.float32)
    x = rng.normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    return jcfg, reduced(get_config(ARCH)), p, x


def test_init_tree_matches_jax(block):
    jcfg, cfg, p, _ = block
    mine = tm.init_mamba2_block(torch.Generator().manual_seed(0), cfg, None, "cpu")
    flat = lambda t, pre="": ({k2: v2 for k, v in t.items()
                               for k2, v2 in flat(v, f"{pre}{k}/").items()}
                              if isinstance(t, dict) else {pre[:-1]: tuple(t.shape)})
    assert flat(mine) == flat(p)
    st, jst = tm.mamba2_state_init(cfg, 3, "cpu"), jm.mamba2_state_init(jcfg, 3)
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {k: tuple(v.shape) for k, v in jst.items()}
    assert all(v.dtype == torch.float32 for v in st.values())


@pytest.mark.parametrize("step", ["cacheless", "decode"])
def test_fp_block_matches_jax(block, step):
    jcfg, cfg, p, x = block
    spec, jspec = QuantSpec(), JSpec()
    tp = params_from_numpy(p, "cpu")
    if step == "cacheless":
        want, _ = jm.mamba2_block(jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg, jspec)
        with torch.no_grad():
            got, st = tm.mamba2_block(_t(x), tp, cfg, spec)
        assert st is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        return
    rng = np.random.default_rng(6)
    state = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in jm.mamba2_state_init(jcfg, 2).items()}
    want, jst = jm.mamba2_block(jnp.asarray(x[:, :1]), jax.tree.map(jnp.asarray, p), jcfg,
                                jspec, state=jax.tree.map(jnp.asarray, state))
    with torch.no_grad():
        got, st = tm.mamba2_block(_t(x[:, :1]), tp, cfg, spec,
                                  state={k: _t(v) for k, v in state.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def _spies(module, names, seen, monkeypatch):
    for name in names:
        orig = getattr(module, name)

        def spy(*a, _orig=orig, _name=name, **k):
            out = _orig(*a, **k)
            seen.append((_name, np.asarray(out)))
            return out
        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("bits", [8, 4])
def test_deployed_int_block_codes_and_accumulators_match_jax(block, bits, monkeypatch):
    """W{bits}A{bits}: weights scaled by abs-max and packed by both
    packages' ``_quantize_stack`` (the codes equal), activation scales set
    from the fp block's inputs; each of the five linears' codes and int32
    accumulators bit-equal, the output close."""
    jcfg, cfg, p, x = block
    rng = np.random.default_rng(7)
    p = jax.tree.map(lambda a: a, p)
    for name in ("in_z", "in_x", "in_bc", "in_dt", "out_proj"):
        w = p[name]["w"]
        qmax = 127.0 if bits == 8 else 8.0
        p[name]["s_w"] = np.maximum(np.abs(w).max(0, keepdims=True) / qmax,
                                    1e-8).astype(np.float32)
        p[name]["s_a"] = np.float32(rng.uniform(0.5, 2.0) * 3.0 / (127.0 if bits == 8 else 7.0))
    jdep = jqat._quantize_stack(jax.tree.map(jnp.asarray, p), bits)
    dep = qat._quantize_stack(params_from_numpy(p, "cpu"), bits)
    for name in ("in_z", "in_x", "in_bc", "in_dt", "out_proj"):
        np.testing.assert_array_equal(dep[name]["wq"].numpy(),
                                      np.asarray(jdep[name]["wq"]))
    spec = QuantSpec(mode="int", w_bits=bits, a_bits=bits)
    jspec = JSpec(mode="int", w_bits=bits, a_bits=bits)
    jseen, seen = [], []
    _spies(jlayers, ("quantize_to_int", "_int_matmul_jnp"), jseen, monkeypatch)
    _spies(tlayers, ("quantize_to_int", "int_matmul_exact"), seen, monkeypatch)
    want, _ = jm.mamba2_block(jnp.asarray(x), jdep, jcfg, jspec)
    with torch.no_grad():
        got, _ = tm.mamba2_block(_t(x), dep, cfg, spec)
    assert len(seen) == len(jseen) == 10          # five linears: codes, accumulator
    for (n, a), (jn, b) in zip(seen, jseen):
        assert a.dtype == b.dtype and a.shape == b.shape, (n, jn)
        np.testing.assert_array_equal(a, b, err_msg=n)
    assert any(np.abs(a).max() > 1 for n, a in seen if n == "quantize_to_int")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
