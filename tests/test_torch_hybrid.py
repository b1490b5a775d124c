"""Port parity: the Zamba2 hybrid (``models/hybrid.py``: a Mamba2 backbone
and one shared attention block) against the JAX package, on a reduced
zamba2-2.7b (4 Mamba2 layers in 2 groups of 2, d 64, the shared block's 4
heads of 16) and JAX's own arrays.

* Segments: ``group_segments`` and the plan's segments equal JAX's for the
  four policies of the JAX package's ``test_plan_reproduces_legacy_
  segments``, on both backends, fused or not; the plan's meta rebuilds in
  both packages.
* Forward: fp and deployed-int (both backends) logits within atol 2e-5 /
  rtol 1e-5 of JAX's at S = 16, and on the kernel plan at S = 128, past
  the reduced threshold of 64, where the shared block takes the chunk
  branch (the flash kernel's plain version here, JAX's
  ``chunked_attention``);
  token-by-token decode over ``hybrid_states`` against JAX's steps and
  against the cacheless forward.
* Deploy -> save -> load -> serve in token mode: the deployed arrays equal
  JAX's ``deploy`` bit for bit (the shared block at the last segment's
  bits), the artifact loads in JAX, and greedy streams (five requests over
  two slots, so freed slots are refilled) equal JAX's ``ServingEngine`` on
  the same requests, for the port's reference and kernel backends.
"""
import itertools

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
from repro.models import hybrid as jhybrid
from repro.serving import GenerationRequest as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.checkpoint import manager
from repro_torch.configs import get_config, reduced
from repro_torch.core.policy import QuantPolicy
from repro_torch.deploy import (DeployedModel, ExecutionPlan, deploy,
                                params_from_numpy)
from repro_torch.deploy.plan import plan_from_meta, plan_to_meta
from repro_torch.models import api, hybrid
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

ARCH = "zamba2-2.7b"
N = lambda tree: jax.tree.map(np.asarray, tree)
CALIB = [{"tokens": np.random.default_rng(0).integers(1, 256, (2, 16)).astype(np.int32)}]
PROMPTS = [np.random.default_rng(1).integers(1, 256, n).astype(np.int32)
           for n in (3, 7, 5, 2, 9)]
NEW = [4, 3, 6, 5, 2]


def _segs(segments, kernel_key):
    return [(s, e, sp.mode, sp.w_bits, sp.a_bits, sp.grad_mode, getattr(sp, kernel_key))
            for s, e, sp in segments]


def _policies(n, cls):
    return [None, cls(num_layers=n, mode="int", last_k_int4=0),
            cls(num_layers=n, mode="int", last_k_int4=n // 2),
            cls(num_layers=n, mode="fake", last_k_int4=n)]


def test_group_segments_and_plan_segments_equal_jax():
    cfg, jcfg = reduced(get_config(ARCH)), jreduced(jget(ARCH))
    assert dataclass_dict(cfg) == dataclass_dict(jcfg)
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
        if pol is not None:
            direct = hybrid.group_segments(pol, 2, kern, act_bits=None)
            jdirect = jhybrid.group_segments(jpol, 2, kern, act_bits=None)
            assert _segs(direct, "use_kernels") == _segs(jdirect, "use_pallas")
        assert plan_from_meta(plan_to_meta(plan)) == plan
        assert plan_from_meta(jplan_to_meta(jplan)) == plan
    # the serve CLI's default at full depth: W8A8 groups 0-4, W4A4 groups 5-8
    full = get_config(ARCH)
    plan = ExecutionPlan.build(full, QuantPolicy(num_layers=54, mode="int",
                                                 last_k_int4=27), backend="cuda")
    assert [(s, e, sp.w_bits) for s, e, sp in plan.segments] == [(0, 5, 8), (5, 9, 4)]


def dataclass_dict(cfg):
    import dataclasses
    return dataclasses.asdict(cfg)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jreduced(jget(ARCH)), reduced(get_config(ARCH))
    jp = japi.init_model(jcfg, jax.random.PRNGKey(0))
    # gates and skips away from their constant init, so they matter
    rng = np.random.default_rng(2)
    m = dict(jp["mamba"])
    for k, scale in (("a_log", 0.5), ("dt_bias", 0.5), ("d_skip", 1.0)):
        m[k] = jnp.asarray(rng.normal(scale=scale, size=m[k].shape).astype(np.float32))
    jp = {**jp, "mamba": m}
    return jcfg, cfg, jp


@pytest.fixture(scope="module")
def jdep(model):
    """JAX's calibrated W8A8 + W4A4 deployment of the reduced model."""
    jcfg, _, jp = model
    return jdeploy(jp, JPlan.build(jcfg, JPolicy(num_layers=4, mode="int",
                                                 last_k_int4=2)), CALIB)


def test_init_tree_and_states_match_jax(model):
    jcfg, cfg, jp = model
    mine = manager._flatten(api.init_model(cfg, torch.Generator().manual_seed(0), "cpu"))
    theirs = manager._flatten(N(jp))
    assert sorted(mine) == sorted(theirs)
    for k, v in theirs.items():
        assert mine[k].shape == v.shape and mine[k].dtype == v.dtype, k
    st = manager._flatten(api.decode_state(cfg, 3, 20, torch.float32, device="cpu"))
    jst = manager._flatten(N(japi.decode_state(jcfg, 3, 20, dtype=jnp.float32)))
    assert {k: (v.shape, v.dtype) for k, v in st.items()} == \
        {k: (v.shape, v.dtype) for k, v in jst.items()}
    for bad in (dict(per_slot_len=True), dict(kv_bits=8)):
        with pytest.raises(ValueError, match="transformer-family caches only"):
            api.decode_state(cfg, 2, 8, device="cpu", **bad)


def _plans(cfg, jcfg, which):
    if which == "fp":
        return ExecutionPlan.build(cfg, None), JPlan.build(jcfg, None)
    backend = "cuda" if which == "int-cuda" else "reference"
    pol = dict(num_layers=4, mode="int", last_k_int4=2)
    return (ExecutionPlan.build(cfg, QuantPolicy(**pol), backend=backend),
            JPlan.build(jcfg, JPolicy(**pol), backend="reference"))


# S = 128 (the chunk branch) on the kernel plan only: the others share it
@pytest.mark.parametrize("which,S", [("fp", 16), ("int-reference", 16), ("int-cuda", 16),
                                     ("int-cuda", 128)])
def test_forward_matches_jax(model, jdep, which, S):
    jcfg, cfg, jp = model
    plan, jplan = _plans(cfg, jcfg, which)
    params, jparams = params_from_numpy(N(jp), "cpu"), jp
    if which != "fp":
        jparams = jdep.params
        params = params_from_numpy(N(jdep.params), "cpu")
    toks = np.random.default_rng(S).integers(1, 256, (2, S)).astype(np.int32)
    want = np.asarray(japi.forward(jparams, jplan, tokens=jnp.asarray(toks))[0])
    with torch.no_grad():
        got = api.forward(params, plan, tokens=toks)[0].numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.99


def test_token_steps_match_jax_and_the_cacheless_forward(model):
    jcfg, cfg, jp = model
    plan, jplan = _plans(cfg, jcfg, "fp")
    params = params_from_numpy(N(jp), "cpu")
    toks = np.random.default_rng(3).integers(1, 256, (2, 8)).astype(np.int32)
    st = plan.decode_state(2, 16, device="cpu")
    jst = jplan.decode_state(2, 16)
    jstep = jax.jit(lambda s, t: japi.forward(jp, jplan, state=s, tokens=t)[:2])
    steps = []
    with torch.no_grad():
        full = api.forward(params, plan, tokens=toks)[0]
        for t in range(toks.shape[1]):
            lg, st = api.forward(params, plan, state=st, tokens=toks[:, t:t + 1])
            jlg, jst = jstep(jst, jnp.asarray(toks[:, t:t + 1]))
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=2e-5, rtol=1e-5)
            steps.append(lg)
    assert int(st["attn"]["len"]) == toks.shape[1] == int(jst["attn"]["len"])
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(st["mamba"][k].numpy(), np.asarray(jst["mamba"][k]),
                                   atol=2e-5, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), atol=5e-5,
                               rtol=1e-4)


def _streams(streams):
    return [[int(t) for t in s.result().tokens] for s in streams]


def _jax_streams(model_or_params, plan=None):
    eng = JEngine(model_or_params, plan, slots=2, max_len=64)
    out = [eng.submit(JRequest(prompt=p.copy(), max_new_tokens=m))
           for p, m in zip(PROMPTS, NEW)]
    eng.run_until_drained()
    return _streams(out)


def _port_streams(dm):
    eng = ServingEngine(dm, slots=2, max_len=64)
    assert eng.token_mode and eng.kv is None
    out = [eng.submit(GenerationRequest(prompt=p.copy(), max_new_tokens=m))
           for p, m in zip(PROMPTS, NEW)]
    eng.run_until_drained()
    return _streams(out)


def test_deploy_save_load_serve_token_mode_equals_jax(model, jdep, tmp_path):
    jcfg, cfg, jp = model
    pol = dict(num_layers=4, mode="int", last_k_int4=2)
    jm = jdep
    want = _jax_streams(jm)
    assert all(len(s) == m for s, m in zip(want, NEW))
    for backend in ("reference", "cuda"):
        plan = ExecutionPlan.build(cfg, QuantPolicy(**pol), backend=backend)
        dm = deploy(N(jp), plan, CALIB, device="cpu")
        mine = manager._flatten(dm.params)
        theirs = manager._flatten(N(jm.params))
        assert sorted(mine) == sorted(theirs)
        for k, v in theirs.items():     # the shared block: the last segment's int4
            np.testing.assert_array_equal(mine[k], v, err_msg=k)
        assert mine["shared/attn/wq/wq"].dtype == np.uint8
        path = str(tmp_path / backend)
        dm.save(path)
        loaded = DeployedModel.load(path, device="cpu")
        assert loaded.plan == plan
        assert _port_streams(loaded) == want, backend
    # the port's artifact serves in JAX too
    assert _jax_streams(JDeployed.load(str(tmp_path / "reference"))) == want
