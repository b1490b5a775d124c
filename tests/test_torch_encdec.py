"""Port parity: the encoder-decoder (``models/encdec.py``, the
seamless-m4t-medium shape) against the JAX package, on a reduced
seamless-m4t-medium (2 encoder + 2 decoder layers, d 64, 4 heads of 16,
GELU FFN, LayerNorm) and JAX's own arrays.

* ``attention_block`` with ``kv_input`` (cross-attention: keys and values
  from the source, no RoPE, no causal mask, never the chunk branch), fp and
  deployed-int, within atol 1e-5 / rtol 1e-5 of JAX's; its taps carry the
  source length.
* ``encdec_forward``: a prefill of 6 tokens over 128 source frames (past
  the reduced threshold of 64, so every encoder layer takes the chunk
  branch non-causally) into an fp decode cache, then 4 decode steps
  through ``decode_extra_inputs`` with the encoder output, fp and deployed
  W8A8 + W4A4 on the kernel plan: logits within atol 2e-5 / rtol 1e-5 of
  JAX's at every step, the cache rows too.
* A deployed prefill on the reference backend: every activation code and
  int32 accumulator bit-equal to JAX's.
* Deploy -> save -> load: the deployed arrays equal JAX's bit for bit (the
  encoder at the first segment's bits), the artifact loads in JAX.
* The engine refuses an encdec plan (the JAX engine's step cannot serve it
  either); the plan refuses a policy that does not cover the decoder
  layers, as JAX's does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.core.policy import QuantPolicy as JPolicy
from repro.deploy import DeployedModel as JDeployed
from repro.deploy import ExecutionPlan as JPlan
from repro.deploy import deploy as jdeploy
from repro.deploy.plan import plan_to_meta as jplan_to_meta
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models.layers import QuantSpec as JSpec
from repro.models.transformer import _norm as jnorm
from repro_torch.checkpoint import manager
from repro_torch.configs import get_config, reduced
from repro_torch.core import qat
from repro_torch.core.policy import QuantPolicy
from repro_torch.deploy import (DeployedModel, ExecutionPlan, deploy,
                                params_from_numpy)
from repro_torch.deploy.plan import plan_from_meta, plan_to_meta
from repro_torch.models import api, encdec
from repro_torch.models.attention import attention_block
from repro_torch.models.layers import QuantSpec
from repro_torch.serving import ServingEngine


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small, and
    at one thread a test worker does not contend with the suite's others
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ARCH = "seamless-m4t-medium"
N = lambda tree: jax.tree.map(np.asarray, tree)
POLICY = dict(num_layers=2, mode="int", last_k_int4=1)
S_SRC, PROMPT, STEPS = 128, 6, 4


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jreduced(jget(ARCH)), reduced(get_config(ARCH))
    jp = japi.init_model(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    src = rng.normal(size=(2, S_SRC, cfg.d_model)).astype(np.float32)
    toks = rng.integers(1, 256, (2, PROMPT + STEPS)).astype(np.int32)
    calib = [{"tokens": toks[:, :PROMPT], "src_embeds": src}]
    return jcfg, cfg, jp, src, toks, calib


def test_config_init_and_state_match_jax(model):
    import dataclasses
    jcfg, cfg, jp, *_ = model
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jget(ARCH))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    mine = manager._flatten(api.init_model(cfg, torch.Generator().manual_seed(0), "cpu"))
    theirs = manager._flatten(N(jp))
    assert sorted(mine) == sorted(theirs)
    for k, v in theirs.items():
        assert mine[k].shape == v.shape and mine[k].dtype == v.dtype, k
    st = manager._flatten(api.decode_state(cfg, 3, 20, torch.float32, device="cpu"))
    jst = manager._flatten(N(japi.decode_state(jcfg, 3, 20, dtype=jnp.float32)))
    assert {k: (v.shape, v.dtype) for k, v in st.items()} == \
        {k: (v.shape, v.dtype) for k, v in jst.items()}
    extra = api.decode_extra_inputs(cfg, 3, 7, torch.float32, device="cpu")
    jextra = japi.decode_extra_inputs(jcfg, 3, 7, dtype=jnp.float32)
    assert extra["enc_out"].shape == jextra["enc_out"].shape
    assert api.decode_extra_inputs(reduced(get_config("stablelm-3b")), 3, 7) == {}


@pytest.mark.parametrize("mode", ["fp", "int8", "int4"])
def test_cross_attention_matches_jax(model, mode):
    jcfg, cfg, jp, src, *_ = model
    p = jax.tree.map(lambda a: np.asarray(a[0]), jp["dec"]["cross"])
    bits = {"fp": 0, "int8": 8, "int4": 4}[mode]
    spec, jspec = QuantSpec(), JSpec()
    if bits:
        for lin in p.values():
            lin["s_w"] = np.maximum(np.abs(lin["w"]).max(0, keepdims=True)
                                    / (127.0 if bits == 8 else 8.0), 1e-8).astype(np.float32)
            lin["s_a"] = np.float32(4.0 / (127.0 if bits == 8 else 7.0))
        from repro.core import qat as jqat
        jpp = jqat._quantize_stack(jax.tree.map(jnp.asarray, p), bits)
        pp = qat._quantize_stack(params_from_numpy(p, "cpu"), bits)
        spec = QuantSpec(mode="int", w_bits=bits, a_bits=bits)
        jspec = JSpec(mode="int", w_bits=bits, a_bits=bits)
    else:
        jpp, pp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")
    x = np.random.default_rng(1).normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    kw = dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, hd=cfg.hd)
    want, _, jtaps = jattn.attention_block(jnp.asarray(x), jpp, spec=jspec, causal=False,
                                           rope=False, kv_input=jnp.asarray(src),
                                           want_taps=True, chunk=32, **kw)
    with torch.no_grad():
        # rope and causal asked for: the kv_input branch applies neither
        got, new_kv, taps = attention_block(_t(x), pp, spec=spec, causal=True, rope=True,
                                            kv_input=_t(src), want_taps=True, chunk=32,
                                            **kw)
    assert new_kv is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    for k in ("q", "k", "v"):
        assert taps[k].shape == jtaps[k].shape
        np.testing.assert_allclose(taps[k].numpy(), np.asarray(jtaps[k]), atol=1e-5,
                                   rtol=1e-5)
    assert taps["k"].shape[1] == S_SRC


def _jax_encode(jparams, jcfg, jplan, src):
    """JAX's encoder output as ``encdec_forward`` computes it inline."""
    h = jnp.asarray(src)
    enc, spec = jparams["enc"], jplan.segments[0][2]
    for i in range(jcfg.enc_layers):
        h = jencdec._enc_block(h, jax.tree.map(lambda a: a[i], enc), jcfg, spec)
    return jnorm(h, jparams["enc_norm"], jcfg.norm)


@pytest.fixture(scope="module")
def jdep(model):
    jcfg, _, jp, _, _, calib = model
    # JAX's deploy calibrates through a tokens-only forward, which an
    # encoder-decoder cannot run: pack uncalibrated, then give every
    # activation scale one value on the activations' range, so the codes
    # are not all 0 and +-1
    dm = jdeploy(jp, JPlan.build(jcfg, JPolicy(**POLICY)))

    def scale(node):
        if isinstance(node, dict):
            return {k: (jnp.full_like(v, 0.03) if k == "s_a" else scale(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [scale(v) for v in node]
        return node
    return dm.__class__(plan=dm.plan, params=scale(dm.params))


# the reference backend's integer path is held to JAX's code for code below
@pytest.mark.parametrize("which", ["fp", "int-cuda"])
def test_prefill_and_decode_steps_match_jax(model, jdep, which):
    jcfg, cfg, jp, src, toks, _ = model
    if which == "fp":
        plan, jplan, jparams = ExecutionPlan.build(cfg, None), JPlan.build(jcfg, None), jp
    else:
        backend = which.split("-")[1]
        plan = ExecutionPlan.build(cfg, QuantPolicy(**POLICY), backend=backend)
        jplan, jparams = jdep.plan, jdep.params
    params = params_from_numpy(N(jparams), "cpu")
    st = plan.decode_state(2, 16, device="cpu")
    jst = jplan.decode_state(2, 16)
    pre = toks[:, :PROMPT]
    jlg, jst, _, _ = japi.forward(jparams, jplan, state=jst, tokens=jnp.asarray(pre),
                                  src_embeds=jnp.asarray(src))
    with torch.no_grad():
        lg, st = api.forward(params, plan, state=st, tokens=pre, src_embeds=src)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=2e-5, rtol=1e-5)
    jenc = _jax_encode(jparams, jcfg, jplan, src)
    extra = api.decode_extra_inputs(cfg, 2, S_SRC, torch.float32, device="cpu")
    with torch.no_grad():
        extra["enc_out"].copy_(encdec.encode(params, cfg, plan.segments, src))
    np.testing.assert_allclose(extra["enc_out"].numpy(), np.asarray(jenc), atol=1e-5,
                               rtol=1e-5)
    step = jax.jit(lambda p, s, t, e: japi.forward(p, jplan, state=s, tokens=t,
                                                   enc_out=e)[:2])
    for t in range(PROMPT, PROMPT + STEPS):
        jlg, jst = step(jparams, jst, jnp.asarray(toks[:, t:t + 1]), jenc)
        with torch.no_grad():
            lg, st = api.forward(params, plan, state=st, tokens=toks[:, t:t + 1], **extra)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=2e-5, rtol=1e-5)
    assert int(st["len"]) == int(jst["len"]) == PROMPT + STEPS
    for k in ("k", "v"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), atol=2e-5, rtol=1e-5)


def test_deploy_save_load_round_trip_equals_jax(model, jdep, tmp_path):
    jcfg, cfg, jp, src, toks, calib = model
    plan = ExecutionPlan.build(cfg, QuantPolicy(**POLICY), backend="cuda")
    dm = deploy(N(jp), plan, device="cpu")
    mine = manager._flatten(dm.params)
    theirs = manager._flatten(N(jdeploy(jp, JPlan.build(jcfg, JPolicy(**POLICY))).params))
    assert sorted(mine) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    # the encoder at the first segment's bits, the decoder per segment
    assert mine["enc/attn/wq/wq"].dtype == np.int8
    assert mine["dec/1/ffn/w1/wq"].dtype == np.uint8
    dm.save(str(tmp_path / "art"))
    loaded = DeployedModel.load(str(tmp_path / "art"), device="cpu")
    assert loaded.plan == plan and plan.fuse_epilogue
    assert plan_from_meta(plan_to_meta(plan)) == plan
    assert plan_from_meta(jplan_to_meta(JPlan.build(jcfg, JPolicy(**POLICY),
                                                    backend="pallas"))) == plan
    back = JDeployed.load(str(tmp_path / "art"))
    assert sorted(manager._flatten(N(back.params))) == sorted(theirs)
    pre = toks[:, :PROMPT]
    with torch.no_grad():
        a = api.forward(dm.params, plan, tokens=pre, src_embeds=src)[0]
        b = api.forward(loaded.params, loaded.plan, tokens=pre, src_embeds=src)[0]
    assert torch.equal(a, b)
    # calibration batches carry the encoder's input; the global scale lands
    # on every linear, the encoder's included
    cal = deploy(N(jp), plan, calib, device="cpu")
    scales = {k: v for k, v in manager._flatten(cal.params).items() if k.endswith("/s_a")}
    values = np.unique(np.concatenate([v.reshape(-1) for v in scales.values()]))
    assert len(values) == 1 and values[0] != 1.0
    assert "enc/attn/wq/s_a" in scales and "dec/1/cross/wk/s_a" in scales


def test_engine_refuses_the_encdec_plan_naming_the_reference_limit(model):
    _, cfg, jp, *_ = model
    plan = ExecutionPlan.build(cfg, QuantPolicy(**POLICY), backend="cuda")
    assert plan.prefill_mode == "token"
    dm = deploy(N(jp), plan, device="cpu")
    with pytest.raises(ValueError, match="cannot serve an encoder-decoder plan.*"
                                         "JAX package's engine has the same limit"):
        ServingEngine(dm, slots=2, max_len=32)
    with pytest.raises(ValueError, match="needs src_embeds"):
        api.forward(dm.params, plan, tokens=np.ones((1, 2), np.int32))


def test_plan_refuses_a_policy_off_the_decoder_layers_as_jax_does(model):
    jcfg, cfg, *_ = model
    for n in (7, cfg.num_layers + cfg.enc_layers):
        with pytest.raises(ValueError, match="decoder layers"):
            ExecutionPlan.build(cfg, QuantPolicy(num_layers=n, mode="int"))
        with pytest.raises(ValueError, match="decoder layers"):
            JPlan.build(jcfg, JPolicy(num_layers=n, mode="int"))
    with pytest.raises(ValueError, match="no KV slot cache"):
        ExecutionPlan.build(cfg, None, prefill_mode="chunked")
    with pytest.raises(ValueError, match="no sharding rules"):
        ExecutionPlan.build(cfg, QuantPolicy(**POLICY), tp=2)


def test_deployed_decoder_codes_and_accumulators_match_jax(model, jdep, monkeypatch):
    """A deployed prefill over the encoder output: every activation code and
    int32 accumulator of every quantized linear (encoder and decoder, self
    and cross attention, FFN) bit-equal to JAX's, in call order."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    jcfg, cfg, jp, src, toks, _ = model
    plan = ExecutionPlan.build(cfg, QuantPolicy(**POLICY), backend="reference")
    params = params_from_numpy(N(jdep.params), "cpu")
    jseen, seen = [], []
    for mod, names, out in ((jlayers, ("quantize_to_int", "_int_matmul_jnp"), jseen),
                            (tlayers, ("quantize_to_int", "int_matmul_exact"), seen)):
        for name in names:
            orig = getattr(mod, name)

            def spy(*a, _orig=orig, _out=out, **k):
                r = _orig(*a, **k)
                _out.append(np.asarray(r))
                return r
            monkeypatch.setattr(mod, name, spy)
    pre = toks[:, :PROMPT]
    jax.config.update("jax_disable_jit", True)
    try:
        want = japi.forward(jdep.params, jdep.plan, tokens=jnp.asarray(pre),
                            src_embeds=jnp.asarray(src[:, :32]))[0]
    finally:
        jax.config.update("jax_disable_jit", False)
    with torch.no_grad():
        got = api.forward(params, plan, tokens=pre, src_embeds=src[:, :32])[0]
    # 2 encoder layers x 6 linears + 2 decoder layers x 10, codes + accumulators
    assert len(seen) == len(jseen) == 2 * (2 * 6 + 2 * 10)
    for i, (a, b) in enumerate(zip(seen, jseen)):
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))
    assert max(np.abs(a).max() for a in seen[::2]) > 8
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
