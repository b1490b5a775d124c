"""Port parity: the MoE family (``qwen2-moe-a2.7b`` with its shared expert
and QKV bias, ``granite-moe-3b-a800m`` with GQA), reduced (4 layers, d 64,
8 experts of d_ff 32, top-k 4; qwen's shared expert d_ff 64).

Every test runs on JAX's own ``init_moe`` / ``init_lm`` arrays, carried
across as numpy (``params_from_numpy``). Tolerances:

* routing (each token's top-k experts) exact, with the smallest gap between
  the K-th and the (K+1)-th gate reported in the assertion message; expert
  inputs (each dispatch position and the keep mask, seen as the (E, C, d)
  slot tensor the experts read) bit-equal; integer activation codes and
  int32 accumulators bit-equal where the inputs are (the w1 / w3 sites);
* ``moe_apply`` / ``moe_apply_sorted`` outputs within rtol 1e-5 and atol
  2e-5 times the output's largest magnitude (JAX's own test uses atol 2e-5
  on outputs of order 1e-3: a flat atol would say nothing here), the aux
  loss within 1e-6 relative;
* calibration folding and deploy packing bit-equal given the same records
  and scales; a full ``deploy`` of the LM: codes and weight scales
  bit-equal, activation scales within rtol 1e-5 (percentiles of fp
  activations whose float rounding differs between XLA and PyTorch);
* ``lm_forward`` logits within rtol = atol = 1e-4 (the whole-model bar);
* engine greedy streams equal to JAX's engine token for token.

Capacity couples the rows of a batch (C slots an expert, tokens past them
dropped), so inside the port dense == sorted holds only where no expert
overflows (``capacity_factor=8.0``, one group), and a paged engine's
streams equal the dense engine's only where no slot idles through a decode
step (an idle slot feeds token 0, and its row takes capacity, computed
over its own stale cache); the tests hold those identities there only.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.manager as jmanager
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import calibration as jcal
from repro.core import qat as jqat
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.core.quantizer import quantize_to_int as jquantize_to_int
from repro.deploy import DeployedModel as JDeployedModel
from repro.deploy import ExecutionPlan as JExecutionPlan
from repro.models import api as japi
from repro.models import transformer as jt
from repro.models.layers import QuantSpec as JQuantSpec
from repro.serving import GenerationRequest as JGenerationRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.checkpoint import manager
from repro_torch.configs import get_config, reduced
from repro_torch.core import calibration, qat
from repro_torch.core.packing import unpack_int4
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantizer import qrange
from repro_torch.deploy import (DeployedModel, ExecutionPlan, deploy,
                                params_from_numpy)
from repro_torch.core.quantizer import quantize_to_int
from repro_torch.kernels import build, ops
from repro_torch.kernels.int8_matmul import int_matmul_exact
from repro_torch.models import api
from repro_torch.models import transformer as tt
from repro_torch.models.layers import QuantSpec
from repro_torch.serving import GenerationRequest, ServingEngine

ARCHS = ("qwen2-moe-a2.7b", "granite-moe-3b-a800m")
#: (mode, w_bits, a_bits) of the layer-level cases
MODES = (("none", 0, 0), ("fake", 8, 8), ("fake", 4, 4), ("int", 8, 8),
         ("int", 4, 4), ("int", 8, 4), ("int", 8, 0), ("int", 4, 0))
#: the default capacity (tokens overflow) and JAX's no-overflow setting
CAPACITY = {"default": {}, "roomy": dict(capacity_factor=8.0, moe_group_size=9999)}


def _cfgs(arch, **kw):
    return (reduced(get_config(arch)).replace(**kw),
            jreduced(jget_config(arch)).replace(**kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


def _x(d, shape=(2, 16), seed=1):
    """Inputs with a common offset, so tokens favour the same experts and the
    default capacity overflows in both dispatches."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(*shape, d)) + 1.5 * rng.normal(size=d)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _layer(arch, w_bits, a_bits):
    """JAX's ``init_moe`` arrays (one unstacked layer) with calibrated
    scales: s_w abs-max per expert and channel at ``w_bits``, s_a from a
    calibration forward of JAX's ``moe_apply`` (per-expert percentiles at
    the expert sites) at ``a_bits``; and their deployed form (codes packed
    by JAX's ``_quantize_stack``). numpy trees: (fp, int)."""
    _, jcfg = _cfgs(arch)
    p = jt.init_moe(jax.random.PRNGKey(0), jcfg, stacked=None)
    if not w_bits:
        return _np(p), None
    p = jqat.calibrate_weight_scales(p, lambda prefix: np.float32(w_bits))
    with jcal.calibration_mode() as cm:
        jt.moe_apply(jnp.asarray(_x(jcfg.d_model, seed=5)), p, jcfg, JQuantSpec())
    qmax = float(qrange(a_bits or 8)[1])     # a_bits 0: scales on the int8 grid
    sites = [("w1",), ("w3",), ("w2",)] + ([("shared", "w1"), ("shared", "w3"),
                                            ("shared", "w2")] if "shared" in p else [])
    for path, rec in zip(sites, cm.records):
        node = p
        for k in path:
            node = node[k]
        node["s_a"] = jnp.asarray(np.maximum(rec / qmax, 1e-8).reshape(node["s_a"].shape))
    return _np(p), _np(jqat._quantize_stack(p, w_bits))


def _specs(mode, w_bits, a_bits):
    jspec = JQuantSpec(mode=mode, w_bits=w_bits, a_bits=a_bits)
    spec = QuantSpec(mode=mode, w_bits=w_bits, a_bits=a_bits,
                     use_kernels=mode == "int" and a_bits > 0)
    return jspec, spec


class ExpertSpy:
    """Record each ``_expert_matmul`` call's input (as numpy) in order."""

    def __init__(self, module, monkeypatch):
        self.inputs = []
        orig = module._expert_matmul

        def spy(x, p, spec):
            self.inputs.append(np.array(x))
            return orig(x, p, spec)
        monkeypatch.setattr(module, "_expert_matmul", spy)


def _routing(x, router, K):
    """(JAX's top-k experts, the port's, the smallest K-th vs (K+1)-th gate
    gap) on the rows of x."""
    gates = jax.nn.softmax(jnp.asarray(x, jnp.float32) @ jnp.asarray(router), axis=-1)
    jvals, jidx = jax.lax.top_k(gates, K)
    _, _, idx = tt.route(_t(x), _t(router), K)
    g = np.sort(np.asarray(gates), axis=-1)[..., ::-1]
    margin = float((g[..., K - 1] - g[..., K]).min()) if g.shape[-1] > K else np.inf
    return np.asarray(jidx), idx.numpy(), margin


def _close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5 * scale, err_msg=what)


# ------------------------------------------------------- moe_apply vs JAX
@pytest.mark.parametrize("cap", sorted(CAPACITY))
@pytest.mark.parametrize("mode,w_bits,a_bits", MODES)
@pytest.mark.parametrize("impl", ["dense", "sorted"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, impl, mode, w_bits, a_bits, cap, monkeypatch):
    cfg, jcfg = _cfgs(arch, moe_impl=impl, **CAPACITY[cap])
    fp, deployed = _layer(arch, w_bits, a_bits)
    p = deployed if mode == "int" else fp
    jspec, spec = _specs(mode, w_bits, a_bits)
    x = _x(cfg.d_model)
    jidx, idx, margin = _routing(x.reshape(-1, cfg.d_model), p["router"], cfg.top_k)
    assert np.array_equal(idx, jidx), f"routing differs (smallest gap {margin})"

    jspy, spy = ExpertSpy(jt, monkeypatch), ExpertSpy(tt, monkeypatch)
    jy, jaux = jt.moe_apply(jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg, jspec)
    y, aux = tt.moe_apply(_t(x), params_from_numpy(p, "cpu"), cfg, spec)
    assert len(spy.inputs) == len(jspy.inputs) == 3
    # every dispatch position and the keep mask: the slots the experts read
    assert np.array_equal(spy.inputs[0], jspy.inputs[0]), "expert slots differ"
    if cap == "default":
        # the default capacity does overflow here: some choice was dropped
        kept = np.count_nonzero(np.abs(spy.inputs[0]).sum(-1))
        assert kept < x.shape[0] * x.shape[1] * cfg.top_k
    if mode == "int" and a_bits:
        for site in ("w1", "w3"):
            s_a, wq = p[site]["s_a"], p[site]["wq"]
            jx8 = np.asarray(jquantize_to_int(jnp.asarray(jspy.inputs[0]),
                                              jnp.asarray(s_a), a_bits))
            x8 = quantize_to_int(_t(spy.inputs[0]), _t(s_a), a_bits)
            assert np.array_equal(x8.numpy(), jx8), f"{site} codes differ"
            w8 = _t(wq) if w_bits == 8 else unpack_int4(_t(wq), axis=-2)
            jacc = np.asarray(jnp.einsum("eck,ekn->ecn", jnp.asarray(jx8),
                                         jnp.asarray(w8.numpy()),
                                         preferred_element_type=jnp.int32))
            assert np.array_equal(int_matmul_exact(x8, w8).numpy(), jacc), \
                f"{site} accumulators differ"
    _close(y.numpy(), np.asarray(jy), f"{arch} {impl} {mode} w{w_bits}a{a_bits} {cap}")
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)


def test_gates_fed_dispatch_is_bit_equal(monkeypatch):
    """The port fed JAX's own gates: the dense dispatch and combine tensors
    JAX builds (captured from its einsums) and, for both dispatches, the
    expert slots, bit for bit, at the default capacity (overflow) and in two
    groups: dispatch, combine and capacity held apart from the router's
    matmul."""
    arch = "qwen2-moe-a2.7b"
    fp, _ = _layer(arch, 0, 0)
    seen = {}
    orig_einsum = jnp.einsum

    def einsum(eq, *ops, **kw):
        seen.setdefault(eq, [np.asarray(o) for o in ops])
        return orig_einsum(eq, *ops, **kw)
    monkeypatch.setattr(jnp, "einsum", einsum)
    x = _x(64)
    for impl in ("dense", "sorted"):
        cfg, jcfg = _cfgs(arch, moe_impl=impl)
        seen.clear()
        # routing is row by row: on the two groups of 16 (dense), on all 32 rows
        xr = x.reshape(2, 16, 64) if impl == "dense" else x.reshape(32, 64)
        gates = jax.nn.softmax(jnp.asarray(xr) @ jnp.asarray(fp["router"]), axis=-1)
        vals, idx = jax.lax.top_k(gates, cfg.top_k)
        vals = vals / jnp.maximum(vals.sum(-1, keepdims=True), 1e-9)
        fed = (_t(gates), _t(vals), _t(idx).to(torch.int64))
        monkeypatch.setattr(tt, "route", lambda *a: fed)
        jspy, spy = ExpertSpy(jt, monkeypatch), ExpertSpy(tt, monkeypatch)
        jt.moe_apply(jnp.asarray(x), jax.tree.map(jnp.asarray, fp), jcfg, JQuantSpec())
        tt.moe_apply(_t(x), params_from_numpy(fp, "cpu"), cfg, QuantSpec())
        assert np.array_equal(spy.inputs[0], jspy.inputs[0]), impl
        if impl == "dense":
            E, C = cfg.num_experts, tt.capacity(16, cfg)
            dispatch, combine = tt.dense_dispatch(fed[1], fed[2], E, C, torch.float32)
            jdispatch = seen["gsec,gsd->gecd"][0]
            jcombine = seen["gsec,gecd->gsd"][0]
            assert dispatch.shape == (2, 16, E, C)
            assert np.array_equal(dispatch.numpy(), jdispatch)
            assert np.array_equal(combine.numpy(), jcombine)
            assert dispatch.sum() < 32 * cfg.top_k      # some choices dropped


def test_top_k_puts_the_lower_expert_first_on_ties():
    """Exactly tied gates (two equal router columns, and a row of equal
    gates): the port's experts and their order equal ``jax.lax.top_k``'s."""
    rng = np.random.default_rng(0)
    router = rng.normal(0, 0.3, (16, 8)).astype(np.float32)
    router[:, 5] = router[:, 2]
    router[:, 7] = router[:, 2]
    x = rng.normal(size=(12, 16)).astype(np.float32)
    x[0] = 0.0                                  # every gate 1/8
    for K in (2, 4):
        jidx, idx, _ = _routing(x, router, K)
        assert np.array_equal(idx, jidx)
    assert list(idx[0]) == [0, 1, 2, 3]
    g = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]])
    assert tt.top_k(g, 3)[1].tolist() == [[1, 2, 4]]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,w_bits,a_bits", [("none", 0, 0), ("int", 4, 4)])
def test_dense_equals_sorted_without_overflow(arch, mode, w_bits, a_bits):
    """Inside the port, with room for every choice: the two dispatches give
    the same output (within rtol 1e-6 of the largest magnitude: the combine
    sums in other orders) and the same aux loss."""
    fp, deployed = _layer(arch, w_bits, a_bits)
    p = params_from_numpy(deployed if mode == "int" else fp, "cpu")
    spec = _specs(mode, w_bits, a_bits)[1]
    x = _t(_x(64))
    outs = [tt.moe_apply(x, p, _cfgs(arch, moe_impl=impl, **CAPACITY["roomy"])[0], spec)
            for impl in ("dense", "sorted")]
    want = outs[0][0].numpy()
    np.testing.assert_allclose(outs[1][0].numpy(), want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))
    assert float(outs[1][1]) == float(outs[0][1])


def test_sorted_combine_is_deterministic():
    """Two calls of the sorted dispatch are bit-equal (the combine sums each
    token's rows in a fixed order, no scatter-add)."""
    fp, _ = _layer("granite-moe-3b-a800m", 0, 0)
    cfg = _cfgs("granite-moe-3b-a800m", moe_impl="sorted")[0]
    p, x = params_from_numpy(fp, "cpu"), _t(_x(64))
    a, b = tt.moe_apply(x, p, cfg, QuantSpec())[0], tt.moe_apply(x, p, cfg, QuantSpec())[0]
    assert torch.equal(a, b)


def test_groups_must_divide_the_tokens():
    fp, _ = _layer("granite-moe-3b-a800m", 0, 0)
    cfg = _cfgs("granite-moe-3b-a800m")[0]
    with pytest.raises(ValueError, match="do not split"):
        tt.moe_apply(_t(_x(64, shape=(1, 33))), params_from_numpy(fp, "cpu"), cfg,
                     QuantSpec())


# ---------------------------------------------------- calibration, deploy
@functools.lru_cache(maxsize=None)
def _lm(arch):
    """(port cfg, JAX cfg, JAX's init_lm arrays as numpy)."""
    cfg, jcfg = _cfgs(arch)
    return cfg, jcfg, _np(jt.init_lm(jcfg, jax.random.PRNGKey(0)))


def _policy(cls):
    return cls(num_layers=4, mode="int", last_k_int4=2)


CALIB = [{"tokens": np.random.default_rng(0).integers(1, 256, (2, 16)).astype(np.int32)}
         for _ in range(2)]


@pytest.mark.parametrize("arch", ARCHS)
def test_site_order_and_bits_match_jax(arch):
    cfg, jcfg, fp = _lm(arch)
    assert qat.site_order(cfg) == jqat.site_order(jcfg)
    fn, jfn = (qat.default_bits_fn(cfg, _policy(QuantPolicy)),
               jqat.default_bits_fn(jcfg, _policy(JQuantPolicy)))
    for prefix in [(), (4,), (4, 8), (8,)]:
        assert np.array_equal(fn(prefix), jfn(prefix)), prefix


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_folds_expert_records_like_jax(arch):
    """The same record stream (one (E,) record per expert site, one scalar
    per other site, per layer and batch) folds into bit-equal ``s_a``
    leaves: (L, E, 1, 1) for the experts."""
    cfg, jcfg, fp = _lm(arch)
    sites = qat.site_order(cfg)
    rng = np.random.default_rng(3)
    recs = [[rng.uniform(0.1, 3.0, (cfg.num_experts,) if s.startswith("moe/w") else ())
             .astype(np.float32) for s in sites] for _ in range(2 * cfg.num_layers)]

    def replay(record):
        def fwd(params, batch):
            for layer in recs[batch["i"]::2]:
                for r in layer:
                    record(r, per_axis0=np.ndim(r) == 1)
        return fwd

    def jrecord(r, per_axis0):
        jcal._COLLECTOR.records.append(np.asarray(r, np.float32))

    def record(r, per_axis0):
        calibration._COLLECTOR.records.append(np.asarray(r, np.float32))
    batches = [{"i": 0}, {"i": 1}]
    want = jqat.calibrate_act_scales(jax.tree.map(jnp.asarray, fp), jcfg,
                                     _policy(JQuantPolicy), replay(jrecord), batches)
    got = qat.calibrate_act_scales(params_from_numpy(fp, "cpu"), cfg,
                                   _policy(QuantPolicy), replay(record), batches)
    w, g = jmanager._flatten(want), manager._flatten(got)
    keys = [k for k in w if k.endswith("/s_a")]
    assert any("moe/w1" in k for k in keys)
    for k in keys:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert w["layers/moe/w2/s_a"].shape == (cfg.num_layers, cfg.num_experts, 1, 1)


@functools.lru_cache(maxsize=None)
def _jax_calibrated(arch):
    """JAX's ``deploy`` up to the packing, on the same batches: weight
    scales, then activation scales through an fp forward."""
    cfg, jcfg, fp = _lm(arch)
    pol = _policy(JQuantPolicy)
    fp_plan = JExecutionPlan.build(jcfg, None)
    return jqat.calibrate_act_scales(
        jqat.calibrate_weight_scales(jax.tree.map(jnp.asarray, fp),
                                     jqat.default_bits_fn(jcfg, pol)),
        jcfg, pol, lambda p, b: japi.forward(p, fp_plan, tokens=b["tokens"]), CALIB)


@functools.lru_cache(maxsize=None)
def _jax_deployed(arch):
    """JAX's deployed tree: ``deploy_params`` of the calibrated one."""
    jcfg = _lm(arch)[1]
    jplan = JExecutionPlan.build(jcfg, _policy(JQuantPolicy))
    return jqat.deploy_params(_jax_calibrated(arch), jcfg, jplan.segments)


@pytest.mark.parametrize("arch", ARCHS)
def test_deploy_matches_jax(arch):
    """The port's ``deploy`` with calibration of JAX's init_lm arrays against
    JAX's ``calibrate_act_scales`` / ``deploy_params`` on the same batches:
    the same keys, shapes and dtypes; codes (per expert, int4 packed along
    each expert's K), weight scales, routers and the shared gate bit-equal;
    ``s_a`` within rtol 1e-5. Then the port's ``deploy_params`` on JAX's
    calibrated tree: every leaf bit-equal."""
    cfg, jcfg, fp = _lm(arch)
    plan = ExecutionPlan.build(cfg, _policy(QuantPolicy), backend="cuda")
    want = jmanager._flatten(_jax_deployed(arch))
    got = manager._flatten(deploy(params_from_numpy(fp, "cpu"), plan, CALIB,
                                  device="cpu").params)
    assert sorted(got) == sorted(want)
    assert want["layers/1/moe/w2/wq"].dtype == np.uint8
    assert want["layers/1/moe/w2/wq"].shape == (2, 8, 16, 64)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        if key.endswith("/s_a"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    got = manager._flatten(qat.deploy_params(
        params_from_numpy(_np(_jax_calibrated(arch)), "cpu"), cfg, plan.segments))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ------------------------------------------------------------- lm_forward
def _load_pair(arch, kv_bits, tmp_path, kv_paging="dense"):
    """JAX's model under a Pallas-backend plan, and the port's loaded from
    the artifact JAX saves."""
    _, jcfg, _ = _lm(arch)
    jplan = JExecutionPlan.build(jcfg, _policy(JQuantPolicy), backend="pallas",
                                 kv_bits=kv_bits, kv_paging=kv_paging)
    jmodel = JDeployedModel(plan=jplan, params=_jax_deployed(arch))
    path = str(tmp_path / f"art_{arch}_{kv_bits}_{kv_paging}")
    jmodel.save(path)
    return jmodel, DeployedModel.load(path, device="cpu")


@pytest.mark.parametrize("arch,kv_bits", [("granite-moe-3b-a800m", 16),
                                          ("granite-moe-3b-a800m", 8),
                                          ("granite-moe-3b-a800m", 4),
                                          ("qwen2-moe-a2.7b", 8)])
def test_lm_forward_matches_jax(arch, kv_bits, tmp_path):
    """A prefill of (2, 8) and 3 teacher-forced decode steps through a
    JAX-saved artifact: JAX's jnp reference path against the port's kernel
    backend (the plain versions on the CPU); the aux loss too."""
    jmodel, model = _load_pair(arch, kv_bits, tmp_path)
    assert model.plan.cfg == _lm(arch)[0] and model.plan.backend == "cuda"
    jplan = JExecutionPlan.build(jmodel.plan.cfg, jmodel.plan.policy,
                                 backend="reference", kv_bits=kv_bits)
    jfwd = jax.jit(lambda p, st, t: japi.forward(p, jplan, state=st, tokens=t))
    toks = np.random.default_rng(kv_bits).integers(1, 256, (2, 8)).astype(np.int32)
    jstate = jplan.decode_state(2, 16)
    state = model.plan.decode_state(2, 16, device="cpu")
    for step in range(4):
        jl, jstate, _, jaux = jfwd(jmodel.params, jstate, jnp.asarray(toks))
        tl, state, aux = api.forward(model.params, model.plan, state=state,
                                     tokens=_t(toks), want_aux=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
        toks = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)[:, None]
    assert int(state["len"]) == 11


@pytest.mark.parametrize("arch", ARCHS)
def test_fp_forward_and_aux_match_jax(arch):
    """The fp plan (mode none, no cache, two groups of the reduced
    moe_group_size 16): logits within 1e-4, the aux loss within 1e-6
    relative; ``want_aux`` leaves the default return as it was."""
    cfg, jcfg, fp = _lm(arch)
    toks = np.random.default_rng(4).integers(1, 256, (2, 16)).astype(np.int32)
    jl, _, _, jaux = japi.forward(jax.tree.map(jnp.asarray, fp),
                                  JExecutionPlan.build(jcfg, None), tokens=jnp.asarray(toks))
    plan = ExecutionPlan.build(cfg, None)
    params = params_from_numpy(fp, "cpu")
    tl, _, aux = api.forward(params, plan, tokens=_t(toks), want_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6) and float(aux) > 0
    assert len(api.forward(params, plan, tokens=_t(toks))) == 2


# --------------------------------------------------------------- engines
PROMPTS = [np.array([5, 9, 2], np.int32), np.array([8, 8, 1, 4, 12, 77], np.int32),
           np.arange(30, 41, dtype=np.int32)]


def _serve(eng, prompts, max_new=(6, 6, 6)):
    streams = [eng.submit(GenerationRequest(prompt=p.copy(), max_new_tokens=m))
               for p, m in zip(prompts, max_new)]
    eng.run_until_drained()
    return [list(map(int, s.result().tokens)) for s in streams]


def _jserve(jeng, prompts, max_new=(6, 6, 6)):
    streams = [jeng.submit(JGenerationRequest(prompt=p.copy(), max_new_tokens=m))
               for p, m in zip(prompts, max_new)]
    jeng.run_until_drained()
    return [list(map(int, s.result().tokens)) for s in streams]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_jax(arch, tmp_path):
    """Greedy streams at kv8 on 2 slots, JAX's dense engine against the
    port's (its kernel backend: the plain versions on the CPU), on a
    JAX-saved artifact:
    three prompts (a slot idles through the last steps), equal token for
    token. The port's paged engine equals JAX's dense engine on two prompts
    that decode side by side to the end (no idle row: an idle row feeds
    token 0 over its own stale cache, which the two layouts hold apart, and
    takes capacity)."""
    jmodel, model = _load_pair(arch, 8, tmp_path)
    # JAX's reference backend, jitted (the Pallas attention kernels are held
    # against the port elsewhere; the experts have none); one engine, reused
    jplan = JExecutionPlan.build(jmodel.plan.cfg, jmodel.plan.policy,
                                 backend="reference", kv_bits=8)
    jeng = JServingEngine(JDeployedModel(plan=jplan, params=jmodel.params),
                          slots=2, max_len=32)
    assert _serve(ServingEngine(model, slots=2, max_len=32), PROMPTS) == \
        _jserve(jeng, PROMPTS)
    _, paged = _load_pair(arch, 8, tmp_path, kv_paging="paged")
    assert paged.plan.kv_paging == "paged"
    two, max_new = PROMPTS[1:], (6, 6)
    assert _serve(ServingEngine(paged, slots=2, max_len=32), two, max_new) == \
        _jserve(jeng, two, max_new)


# ------------------------------------------------------------------ ops
def test_expert_matmul_hands_each_expert_its_own_scales(monkeypatch):
    """On a CUDA tensor ``ops.expert_matmul`` makes one integer GEMM launch
    per expert, at the full capacity C, each with that expert's rows,
    weight codes, scalar ``s_a[e]`` and (1, N) ``s_w[e]`` (pointers into
    the stacks: no copy), so split-K quantizes each expert with its own
    scale. The C entry is patched (no card here): tensors claim the card and
    ``build.launch`` records what it is handed."""
    E, C, K, N = 3, 2, 64, 32
    calls = []
    monkeypatch.setattr(build, "launch", lambda name, dev, *a: calls.append((name, a)))
    monkeypatch.setattr(build, "check", lambda *a, **k: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    x = torch.randn(E, C, K, dtype=torch.bfloat16)
    for bits, wq in ((8, torch.zeros(E, K, N, dtype=torch.int8)),
                     (4, torch.zeros(E, K // 2, N, dtype=torch.uint8))):
        calls.clear()
        p = {"wq": wq, "s_a": torch.rand(E, 1, 1), "s_w": torch.rand(E, 1, N)}
        out = ops.expert_matmul(x, p, QuantSpec(mode="int", w_bits=bits, a_bits=4,
                                                use_kernels=True))
        assert out.shape == (E, C, N) and out.dtype == torch.bfloat16
        assert [c[0] for c in calls] == [f"int{bits}_matmul"] * E
        for e, (_, a) in enumerate(calls):
            assert a[0] == x[e].data_ptr()                       # expert e's rows
            assert a[1] == wq[e].data_ptr()
            assert a[2] == p["s_a"].data_ptr() + 4 * e           # scalar s_a[e]
            assert a[3] == p["s_w"].data_ptr() + 4 * N * e       # (1, N) s_w[e]
            assert a[6:9] == (C, N, K)                           # M = C: empty slots too
            assert a[14] == 2 and a[15:17] == (-7, 8)            # bf16, quantized inside
    with pytest.raises(ValueError, match="a_bits=0"):
        ops.expert_matmul(x, p, QuantSpec(mode="int", w_bits=4, a_bits=0))


def test_expert_matmul_on_the_cpu_is_the_exact_product():
    """On the CPU ``ops.expert_matmul`` is the exact batched product, equal
    to each expert's ``ops.int8_matmul`` / ``int4_matmul`` (the kernels'
    plain versions) to the bit."""
    _, deployed = _layer("granite-moe-3b-a800m", 4, 4)
    x = _t(_x(64, shape=(8, 5)))
    for site in ("w1", "w2"):
        p = params_from_numpy(deployed[site], "cpu")
        xs = x if site == "w1" else x[..., :32]
        got = ops.expert_matmul(xs, p, QuantSpec(mode="int", w_bits=4, a_bits=4,
                                                 use_kernels=True))
        for e in range(8):
            want = ops.int4_matmul(xs[e], p["wq"][e], p["s_a"][e].reshape(()),
                                   p["s_w"][e], a_bits=4)
            assert torch.equal(got[e], want)


# ------------------------------------------------------------------ plan
def test_moe_tp_is_refused():
    cfg = _cfgs("qwen2-moe-a2.7b")[0]
    with pytest.raises(ValueError, match="MoE under tensor parallelism.*later slice"):
        ExecutionPlan.build(cfg, _policy(QuantPolicy), backend="reference", tp=2)
    assert ExecutionPlan.build(cfg, _policy(QuantPolicy), backend="reference").tp == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_tree_matches_jax(arch):
    """The port's ``init_lm`` gives JAX's keys, shapes and dtypes."""
    cfg, _, fp = _lm(arch)
    mine = manager._flatten(api.init_model(cfg, torch.Generator().manual_seed(0), "cpu"))
    theirs = jmanager._flatten(fp)
    assert sorted(mine) == sorted(theirs)
    for k, v in theirs.items():
        assert mine[k].shape == v.shape and mine[k].dtype == v.dtype, k
