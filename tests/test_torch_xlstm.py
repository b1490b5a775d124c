"""Port parity: xLSTM (``models/xlstm.py``: mLSTM and sLSTM blocks) against
the JAX package, on a reduced xlstm-1.3b (4 layers in 2 groups of one mLSTM
and one sLSTM, d 64, 2 heads; the mLSTM's head width 64, chunk 8) and JAX's
own arrays.

* Init tree and decode state: keys, shapes and dtypes equal JAX's.
* ``mlstm_chunked`` (f32, S = 32 in 4 chunks) within atol 2e-5 / rtol 1e-5
  of JAX's, output and final (C, n, m), with and without an initial state;
  ``mlstm_decode_step`` run over the S tokens equal to the chunked form
  and to JAX's steps within the same tolerance; ``_causal_conv`` bit-equal
  with and without its cache.
* ``slstm_block`` and ``mlstm_block`` fp within atol 1e-5 / rtol 1e-5 of
  JAX's, cacheless and one decode step; deployed int (W8A8, W4A4) with
  every activation code and int32 accumulator of their quantized linears
  bit-equal to JAX's.
* The reduced forward: logits and the ``{'hidden'}`` tap within atol 2e-5
  / rtol 1e-5 of JAX's (fp, and deployed int on both backends); token
  steps over ``xlstm_states`` against JAX's steps and the cacheless
  forward.
* Plan segments equal JAX's for the policies of the JAX package's
  ``test_plan_reproduces_legacy_segments``.
* Deploy -> save -> load -> serve in token mode: the deployed codes and
  weight scales equal JAX's ``deploy`` bit for bit, the activation scales
  (one global percentile of the fp calibration forward) within rtol 2e-7,
  the artifact loads in JAX, and greedy
  streams (six requests over two slots, so freed slots are refilled, one
  of them 80 new tokens at max_len 64, which JAX's engine admits and
  finishes for this family) equal JAX's ``ServingEngine``.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.core import qat as jqat
from repro.core.policy import QuantPolicy as JPolicy
from repro.deploy import DeployedModel as JDeployed
from repro.deploy import ExecutionPlan as JPlan
from repro.deploy import deploy as jdeploy
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import xlstm as jx
from repro.models.layers import QuantSpec as JSpec
from repro.serving import GenerationRequest as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.checkpoint import manager
from repro_torch.configs import get_config, reduced
from repro_torch.core import qat
from repro_torch.core.policy import QuantPolicy
from repro_torch.deploy import (DeployedModel, ExecutionPlan, deploy,
                                params_from_numpy)
from repro_torch.models import api
from repro_torch.models import layers as tlayers
from repro_torch.models import xlstm as tx
from repro_torch.core.tree import tree_map
from repro_torch.models.layers import QuantSpec
from repro_torch.serving import GenerationRequest, ServingEngine


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small, and
    at one thread a test worker does not contend with the suite's others
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ARCH = "xlstm-1.3b"
N = lambda tree: jax.tree.map(np.asarray, tree)
POLICY = dict(num_layers=4, mode="int", last_k_int4=2)
CALIB = [{"tokens": np.random.default_rng(0).integers(1, 256, (2, 16)).astype(np.int32)}]
PROMPTS = [np.random.default_rng(1).integers(1, 256, n).astype(np.int32)
           for n in (3, 7, 5, 2, 9, 4)]
NEW = [4, 3, 80, 5, 2, 6]       # 5 + 80 tokens run past max_len 64
MAX_LEN = 64


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jreduced(jget(ARCH)), reduced(get_config(ARCH))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg, japi.init_model(jcfg, jax.random.PRNGKey(0))


def test_init_tree_and_states_match_jax(model):
    jcfg, cfg, jp = model
    mine = manager._flatten(api.init_model(cfg, torch.Generator().manual_seed(0), "cpu"))
    theirs = manager._flatten(N(jp))
    assert sorted(mine) == sorted(theirs)
    for k, v in theirs.items():
        assert mine[k].shape == v.shape and mine[k].dtype == v.dtype, k
    st = manager._flatten(api.decode_state(cfg, 3, 20, torch.bfloat16, device="cpu"))
    jst = manager._flatten(N(japi.decode_state(jcfg, 3, 20)))
    assert {k: (v.shape, v.dtype) for k, v in st.items()} == \
        {k: (v.shape, v.dtype) for k, v in jst.items()}
    for k, v in jst.items():
        np.testing.assert_array_equal(st[k], v, err_msg=k)    # m at -1e30
    for bad in (dict(per_slot_len=True), dict(kv_bits=8)):
        with pytest.raises(ValueError, match="transformer-family caches only"):
            api.decode_state(cfg, 2, 8, device="cpu", **bad)


# ------------------------------------------------------------------ mLSTM core
def _mlstm_inputs(seed, B=2, S=32, H=2, dh=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, H, dh)).astype(np.float32) for _ in range(3))
    i_pre = rng.normal(size=(B, S, H)).astype(np.float32)
    f_pre = (rng.normal(size=(B, S, H)) + 2.0).astype(np.float32)
    return q, k, v, i_pre, f_pre


def _state(seed, B=2, H=2, dh=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, dh, dh)).astype(np.float32),
            rng.normal(size=(B, H, dh)).astype(np.float32),
            rng.normal(size=(B, H)).astype(np.float32))


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked_matches_jax(with_state):
    ins = _mlstm_inputs(1)
    st = _state(2) if with_state else None
    y_j, st_j = jx.mlstm_chunked(*map(jnp.asarray, ins), 8,
                                 None if st is None else tuple(map(jnp.asarray, st)))
    y, st_t = tx.mlstm_chunked(*map(_t, ins), 8, None if st is None else tuple(map(_t, st)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=2e-5, rtol=1e-5)
    for a, b, name in zip(st_t, st_j, "Cnm"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=1e-5,
                                   err_msg=name)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        tx.mlstm_chunked(*map(_t, _mlstm_inputs(0, S=12)), 8)


def test_mlstm_decode_steps_equal_the_chunked_form():
    q, k, v, i_pre, f_pre = map(_t, _mlstm_inputs(3))
    B, S, H, dh = q.shape
    y_chunk, final = tx.mlstm_chunked(q, k, v, i_pre, f_pre, 8)
    state = (torch.zeros(B, H, dh, dh), torch.zeros(B, H, dh), torch.full((B, H), -1e30))
    jstate = tuple(jnp.asarray(s.numpy()) for s in state)
    ys = []
    for t in range(S):
        sl = lambda a: a[:, t:t + 1]
        y, state = tx.mlstm_decode_step(state, *map(sl, (q, k, v, i_pre, f_pre)))
        jy, jstate = jx.mlstm_decode_step(jstate, *(jnp.asarray(sl(a).numpy())
                                                    for a in (q, k, v, i_pre, f_pre)))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_chunk.numpy(), atol=2e-5,
                               rtol=1e-5)
    for a, b, j, name in zip(state, final, jstate, "Cnm"):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), atol=2e-5, rtol=1e-5,
                                   err_msg=name)


def test_causal_conv_with_and_without_its_cache():
    rng = np.random.default_rng(4)
    u = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(tx.CONV_K, 12)).astype(np.float32)
    want, none = jx._causal_conv(jnp.asarray(u), jnp.asarray(w))
    got, cache = tx._causal_conv(_t(u), _t(w))
    assert none is None and cache is None
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cache = torch.zeros((2, tx.CONV_K - 1, 12))
    jcache = jnp.zeros((2, tx.CONV_K - 1, 12))
    for t in range(u.shape[1]):
        out, cache = tx._causal_conv(_t(u[:, t:t + 1]), _t(w), cache)
        jout, jcache = jx._causal_conv(jnp.asarray(u[:, t:t + 1]), jnp.asarray(w), jcache)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(cache.numpy(), np.asarray(jcache))


# ------------------------------------------------------------------ blocks
@pytest.fixture(scope="module")
def blocks(model):
    """JAX's reduced mLSTM and sLSTM layers (norms, gate biases and the
    recurrence redrawn away from their constant init), numpy, and an
    input."""
    jcfg, cfg, _ = model
    rng = np.random.default_rng(5)
    mp = N(jx.init_mlstm_block(jax.random.PRNGKey(0), jcfg))
    sp = N(jx.init_slstm_block(jax.random.PRNGKey(1), jcfg))
    mp["norm"]["scale"] = rng.uniform(0.5, 1.5, mp["norm"]["scale"].shape).astype(np.float32)
    mp["headnorm"] = rng.uniform(0.5, 1.5, mp["headnorm"].shape).astype(np.float32)
    mp["w_gates"]["b"] = rng.normal(size=mp["w_gates"]["b"].shape).astype(np.float32)
    sp["norm"]["scale"] = rng.uniform(0.5, 1.5, sp["norm"]["scale"].shape).astype(np.float32)
    sp["b"] = rng.normal(size=sp["b"].shape).astype(np.float32)
    sp["r"] = (sp["r"] * 10).astype(np.float32)
    x = rng.normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    return jcfg, cfg, {"mlstm": mp, "slstm": sp}, x


def _block_state(kind, jcfg, seed):
    """A random decode state of one block, as numpy."""
    rng = np.random.default_rng(seed)
    full = N(jx.xlstm_states(jcfg, 2))[kind]
    one = {k: v[0, 0] if kind == "mlstm" else v[0] for k, v in full.items()}
    out = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in one.items()}
    if kind == "slstm":
        out["n"] = np.abs(out["n"]) + 0.5
    return out


@pytest.mark.parametrize("kind,step", list(itertools.product(
    ["mlstm", "slstm"], ["cacheless", "decode"])))
def test_fp_block_matches_jax(blocks, kind, step):
    jcfg, cfg, ps, x = blocks
    jfn, fn = {"mlstm": (jx.mlstm_block, tx.mlstm_block),
               "slstm": (jx.slstm_block, tx.slstm_block)}[kind]
    p = ps[kind]
    if step == "cacheless":
        want, _ = jfn(jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg, JSpec())
        with torch.no_grad():
            got, st = fn(_t(x), params_from_numpy(p, "cpu"), cfg, QuantSpec())
        assert st is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        return
    state = _block_state(kind, jcfg, 6)
    xs = x[:, :1]
    want, jst = jfn(jnp.asarray(xs), jax.tree.map(jnp.asarray, p), jcfg, JSpec(),
                    state=jax.tree.map(jnp.asarray, state))
    with torch.no_grad():
        got, st = fn(_t(xs), params_from_numpy(p, "cpu"), cfg, QuantSpec(),
                     state={k: _t(v) for k, v in state.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert sorted(st) == sorted(jst)
    for k in jst:
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


LINEARS = {"mlstm": ("up", "wq", "wk", "wv", "down"), "slstm": ("w_in", "down")}


@pytest.mark.parametrize("kind,bits", list(itertools.product(["mlstm", "slstm"], [8, 4])))
def test_deployed_int_block_codes_and_accumulators_match_jax(blocks, kind, bits,
                                                             monkeypatch):
    """W{bits}A{bits}: weights scaled by abs-max and packed by both
    packages' ``_quantize_stack`` (the codes equal), activation scales
    drawn; each quantized linear's codes and int32 accumulator bit-equal,
    the output close."""
    jcfg, cfg, ps, x = blocks
    rng = np.random.default_rng(7)
    p = jax.tree.map(lambda a: a, ps[kind])
    qmax = 127.0 if bits == 8 else 8.0
    for name in LINEARS[kind]:
        w = p[name]["w"]
        p[name]["s_w"] = np.maximum(np.abs(w).max(0, keepdims=True) / qmax,
                                    1e-8).astype(np.float32)
        p[name]["s_a"] = np.float32(rng.uniform(0.5, 2.0) * 3.0 / (127.0 if bits == 8 else 7.0))
    jdep = jqat._quantize_stack(jax.tree.map(jnp.asarray, p), bits)
    dep = qat._quantize_stack(params_from_numpy(p, "cpu"), bits)
    for name in LINEARS[kind]:
        np.testing.assert_array_equal(dep[name]["wq"].numpy(), np.asarray(jdep[name]["wq"]))
    jfn, fn = {"mlstm": (jx.mlstm_block, tx.mlstm_block),
               "slstm": (jx.slstm_block, tx.slstm_block)}[kind]
    jseen, seen = [], []
    _spies(jlayers, ("quantize_to_int", "_int_matmul_jnp"), jseen, monkeypatch)
    _spies(tlayers, ("quantize_to_int", "int_matmul_exact"), seen, monkeypatch)
    want, _ = jfn(jnp.asarray(x), jdep, jcfg, JSpec(mode="int", w_bits=bits, a_bits=bits))
    with torch.no_grad():
        got, _ = fn(_t(x), dep, cfg, QuantSpec(mode="int", w_bits=bits, a_bits=bits))
    assert len(seen) == len(jseen) == 2 * len(LINEARS[kind])
    for (n, a), (jn, b) in zip(seen, jseen):
        assert a.dtype == b.dtype and a.shape == b.shape, (n, jn)
        np.testing.assert_array_equal(a, b, err_msg=n)
    assert any(np.abs(a).max() > 1 for n, a in seen if n == "quantize_to_int")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------ the model
def _segs(segments, kernel_key):
    return [(s, e, sp.mode, sp.w_bits, sp.a_bits, sp.grad_mode, getattr(sp, kernel_key))
            for s, e, sp in segments]


def _policies(n, cls):
    return [None, cls(num_layers=n, mode="int", last_k_int4=0),
            cls(num_layers=n, mode="int", last_k_int4=n // 2),
            cls(num_layers=n, mode="fake", last_k_int4=n)]


def test_plan_segments_equal_jax(model):
    jcfg, cfg, _ = model
    n = cfg.num_layers
    for (pol, jpol), kern, fuse in itertools.product(
            zip(_policies(n, QuantPolicy), _policies(n, JPolicy)), (False, True),
            (False, True)):
        plan = ExecutionPlan.build(cfg, pol, backend="cuda" if kern else "reference",
                                   fuse_epilogue=fuse)
        jplan = JPlan.build(jcfg, jpol, backend="pallas" if kern else "reference",
                            fuse_epilogue=fuse)
        assert _segs(plan.segments, "use_kernels") == _segs(jplan.segments, "use_pallas")
        assert plan.prefill_mode == jplan.prefill_mode == "token"
    # the serve CLI's policy at full depth: W8A8 groups 0-2, W4A4 groups 3-5
    plan = ExecutionPlan.build(get_config(ARCH), QuantPolicy(
        num_layers=48, mode="int", last_k_int4=24), backend="cuda")
    assert [(s, e, sp.w_bits) for s, e, sp in plan.segments] == [(0, 3, 8), (3, 6, 4)]


@pytest.fixture(scope="module")
def jdep(model):
    """JAX's calibrated W8A8 + W4A4 deployment of the reduced model."""
    jcfg, _, jp = model
    return jdeploy(jp, JPlan.build(jcfg, JPolicy(**POLICY)), CALIB)


@pytest.mark.parametrize("which", ["fp", "int-reference", "int-cuda"])
def test_forward_logits_and_hidden_tap_match_jax(model, jdep, which):
    jcfg, cfg, jp = model
    if which == "fp":
        plan, jplan, jparams = ExecutionPlan.build(cfg, None), JPlan.build(jcfg, None), jp
    else:
        plan = ExecutionPlan.build(cfg, QuantPolicy(**POLICY),
                                   backend=which.split("-")[1])
        jplan, jparams = jdep.plan, jdep.params
    params = params_from_numpy(N(jparams), "cpu")
    toks = np.random.default_rng(8).integers(1, 256, (2, 32)).astype(np.int32)
    want, _, jtaps, _ = japi.forward(jparams, jplan, tokens=jnp.asarray(toks),
                                     want_taps=True)
    with torch.no_grad():
        got, st, taps = api.forward(params, plan, tokens=toks, want_taps=True)
    assert st is None and sorted(taps) == sorted(jtaps) == ["hidden"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(taps["hidden"].numpy(), np.asarray(jtaps["hidden"]),
                               atol=2e-5, rtol=1e-5)


def test_token_steps_match_jax_and_the_cacheless_forward(model):
    jcfg, cfg, jp = model
    plan, jplan = ExecutionPlan.build(cfg, None), JPlan.build(jcfg, None)
    params = params_from_numpy(N(jp), "cpu")
    toks = np.random.default_rng(3).integers(1, 256, (2, 8)).astype(np.int32)
    st = plan.decode_state(2, 16, device="cpu")
    jst = jplan.decode_state(2, 16)
    jstep = jax.jit(lambda s, t: japi.forward(jp, jplan, state=s, tokens=t)[:2])
    steps = []
    with torch.no_grad():
        full = api.forward(params, plan, tokens=toks)[0]
        for t in range(toks.shape[1]):
            lg, st2 = api.forward(params, plan, state=st, tokens=toks[:, t:t + 1])
            assert st2 is st              # updated in place
            jlg, jst = jstep(jst, jnp.asarray(toks[:, t:t + 1]))
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=2e-5, rtol=1e-5)
            steps.append(lg)
    mine, theirs = manager._flatten(st), manager._flatten(N(jst))
    for k, v in theirs.items():
        np.testing.assert_allclose(mine[k], v, atol=2e-5, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), atol=5e-5,
                               rtol=1e-4)


def _requests(cls):
    return [cls(prompt=p.copy(), max_new_tokens=m) for p, m in zip(PROMPTS, NEW)]


def _streams(streams):
    return [[int(t) for t in s.result().tokens] for s in streams]


def _jax_streams(model_or_params, plan=None):
    eng = JEngine(model_or_params, plan, slots=2, max_len=MAX_LEN)
    out = [eng.submit(r) for r in _requests(JRequest)]
    eng.run_until_drained()
    return _streams(out)


def _port_streams(dm):
    eng = ServingEngine(dm, slots=2, max_len=MAX_LEN)
    assert eng.token_mode and eng.kv is None
    out = [eng.submit(r) for r in _requests(GenerationRequest)]
    eng.run_until_drained()
    assert eng._cursor > MAX_LEN          # the recurrent state never runs out
    return _streams(out)


def test_deploy_save_load_serve_token_mode_equals_jax(model, jdep, tmp_path):
    jcfg, cfg, jp = model
    want = _jax_streams(jdep)
    assert [len(s) for s in want] == NEW
    for backend in ("reference", "cuda"):
        plan = ExecutionPlan.build(cfg, QuantPolicy(**POLICY), backend=backend)
        dm = deploy(N(jp), plan, CALIB, device="cpu")
        mine = manager._flatten(dm.params)
        theirs = manager._flatten(N(jdep.params))
        assert sorted(mine) == sorted(theirs)
        for k, v in theirs.items():
            if k.endswith("s_a"):
                # one global percentile of the fp calibration forward, whose
                # f32 sums differ from JAX's in the last bit
                np.testing.assert_allclose(mine[k], v, rtol=2e-7, atol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(mine[k], v, err_msg=k)
        assert mine["mlstm/1/up/wq"].dtype == np.uint8     # group 1: W4A4
        assert mine["slstm/0/w_in/wq"].dtype == np.int8    # group 0: W8A8
        path = str(tmp_path / backend)
        dm.save(path)
        loaded = DeployedModel.load(path, device="cpu")
        assert loaded.plan == plan
        assert _port_streams(loaded) == want, backend
    # the port's artifact serves in JAX too
    assert _jax_streams(JDeployed.load(str(tmp_path / "reference"))) == want


def test_act_bits_retarget_rescales_both_stacks_as_jax(jdep):
    """``retarget_act_bits`` moves the mLSTM and the sLSTM stacks' scales
    onto the new grid, as JAX's does."""
    from repro.deploy import retarget_act_bits as jretarget
    from repro_torch.deploy import retarget_act_bits
    dm = DeployedModel(plan=ExecutionPlan.build(reduced(get_config(ARCH)),
                                                QuantPolicy(**POLICY)),
                       params=params_from_numpy(N(jdep.params), "cpu"))
    for bits in (4, 8):
        mine = manager._flatten(retarget_act_bits(dm, bits).params)
        theirs = manager._flatten(N(jretarget(jdep, bits).params))
        for k, v in theirs.items():
            np.testing.assert_array_equal(mine[k], v, err_msg=k)
        assert any(not np.array_equal(mine[k], v) for k, v in
                   manager._flatten(N(jdep.params)).items() if k.endswith("s_a"))


def _slstm_saved_bytes(cfg, p, S: int) -> int:
    """The bytes of the distinct storages one cacheless sLSTM block keeps
    for its backward over S tokens."""
    seen = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t
    x = torch.randn(2, S, cfg.d_model, generator=torch.Generator().manual_seed(0))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tx.slstm_block(x, p, cfg, QuantSpec())
    return sum(seen.values())


def test_slstm_training_keeps_one_layout_of_the_recurrent_matrices():
    """A training forward keeps per token step only the step's (B, d)
    tensors: the recurrent matrices' batched layout is made once (an einsum
    a step kept its own permuted copy of ``r``, 16.8 MB a token at
    xlstm-1.3b's width: 34 GB for a 2048-token sLSTM layer)."""
    cfg = reduced(get_config("xlstm-1.3b"))
    p = tree_map(lambda t: t.requires_grad_(True), tx.init_slstm_block(
        torch.Generator().manual_seed(0), cfg, None, "cpu"))
    per_token = (_slstm_saved_bytes(cfg, p, 64) - _slstm_saved_bytes(cfg, p, 32)) / 32
    assert per_token < p["r"].numel() * p["r"].element_size() / 2, per_token
