"""Port parity: decoder serving over an fp / int8 / int4 KV cache.

A reduced stablelm-3b (4 layers, d 64, 4 heads of 16, d_ff 128, vocab 256,
SwiGLU, pre-LN, RoPE) under the JAX serve CLI's policy shape (layers 0-1
W8A8, layers 2-3 W4A4) is deployed by the JAX package from numpy weights;
the artifact JAX saves is loaded by the port (the ``"pallas"`` backend in
the meta loads as ``"cuda"``, whose kernels' plain versions CPU tensors
take). The same numpy inputs go through both. Tolerances:

* ``lm_forward`` over a prefill and 4 teacher-forced decode steps at
  kv_bits 16/8/4, MHA and GQA (``num_kv_heads=2``), JAX's jnp reference
  path against the port's kernel backend: logits within rtol =
  atol = 1e-4 (the whole-model bar of slice 1: XLA and PyTorch order their
  float sums differently); written KV codes at least 99.9 % equal (a float
  difference can move a value across a rounding boundary); cursors equal;
* greedy engine streams (JAX ``ServingEngine`` on its Pallas backend vs the
  port's on the CPU): equal token for token;
* the port's own serving properties (batched == solo, recycled slot ==
  fresh, cancel, stop tokens, ``n > 1``, sampled streams independent of
  batch composition): exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.deploy import DeployedModel as JDeployedModel
from repro.deploy import ExecutionPlan as JExecutionPlan
from repro.deploy import deploy as jdeploy
from repro.models import api as japi
from repro.serving import GenerationRequest as JGenerationRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config, reduced
from repro_torch.core.policy import QuantPolicy
from repro_torch.deploy import DeployedModel, ExecutionPlan, deploy
from repro_torch.deploy.plan import plan_from_meta, plan_to_meta
from repro_torch.models import api
from repro_torch.serving import (GenerationRequest, SamplingParams,
                                 ServingEngine, VirtualClock, sample_seed)

VARIANTS = {"mha": {}, "gqa": {"num_kv_heads": 2}}


def _cfgs(variant):
    kw = VARIANTS[variant]
    return (reduced(get_config("stablelm-3b")).replace(**kw),
            jreduced(jget_config("stablelm-3b")).replace(**kw))


def _policy(cls):
    return cls(num_layers=4, mode="int", last_k_int4=2)


def fp_params(cfg, seed=0):
    """fp params as numpy arrays: the port's init tree (the JAX package's
    keys and shapes), every random leaf redrawn from numpy."""
    rng = np.random.default_rng(seed)
    tree = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    const = lambda a: bool(torch.all(a == 0) or torch.all(a == 1))
    return jax.tree.map(
        lambda a: a.numpy() if const(a)
        else rng.normal(0, 0.02, tuple(a.shape)).astype(np.float32), tree)


CALIB = [{"tokens": np.random.default_rng(0).integers(1, 256, (4, 16)).astype(np.int32)}
         for _ in range(2)]


@pytest.fixture(scope="module")
def jax_deployed():
    """variant -> (port cfg, JAX cfg, fp numpy params, JAX deployed params)."""
    out = {}
    for variant in VARIANTS:
        cfg, jcfg = _cfgs(variant)
        fp = fp_params(cfg)
        jplan = JExecutionPlan.build(jcfg, _policy(JQuantPolicy))
        jparams = jdeploy(jax.tree.map(jnp.asarray, fp), jplan, CALIB).params
        out[variant] = (cfg, jcfg, fp, jparams)
    return out


def _load_pair(jax_deployed, variant, kv_bits, tmp_path):
    """The JAX model under a Pallas-backend plan at ``kv_bits``, and the
    port's model loaded from the artifact JAX saves."""
    _, jcfg, _, jparams = jax_deployed[variant]
    jplan = JExecutionPlan.build(jcfg, _policy(JQuantPolicy), backend="pallas",
                                 kv_bits=kv_bits)
    jmodel = JDeployedModel(plan=jplan, params=jparams)
    path = str(tmp_path / f"art_{variant}_{kv_bits}")
    jmodel.save(path)
    return jmodel, DeployedModel.load(path, device="cpu")


def _logits_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------- lm_forward
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_lm_forward_prefill_and_decode_match_jax(jax_deployed, variant, kv_bits,
                                                 tmp_path):
    """The JAX side runs its jnp reference path, jitted, on the same arrays
    (Pallas interpret mode costs seconds per forward; the Pallas kernels are
    held against the port in test_torch_kv.py and by the engine test
    below); the port runs its kernel backend, i.e. the kernels' plain
    versions on the CPU."""
    jmodel, model = _load_pair(jax_deployed, variant, kv_bits, tmp_path)
    assert model.plan.backend == "cuda" and model.plan.kv_bits == kv_bits
    assert model.plan.cfg == jax_deployed[variant][0]
    jmodel = JDeployedModel(plan=JExecutionPlan.build(
        jmodel.plan.cfg, jmodel.plan.policy, backend="reference",
        kv_bits=kv_bits), params=jmodel.params)
    jfwd = jax.jit(lambda p, st, t: japi.forward(p, jmodel.plan, state=st,
                                                 tokens=t)[:2])
    toks = np.random.default_rng(kv_bits).integers(1, 256, (2, 8)).astype(np.int32)
    jstate = jmodel.plan.decode_state(2, 16)
    state = model.plan.decode_state(2, 16, device="cpu")
    jl, jstate = jfwd(jmodel.params, jstate, jnp.asarray(toks))
    tl, state = api.forward(model.params, model.plan, state=state,
                            tokens=torch.as_tensor(toks))
    _logits_close(tl, jl)
    for _ in range(4):                       # teacher-forced decode steps
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)[:, None]
        jl, jstate = jfwd(jmodel.params, jstate, jnp.asarray(nxt))
        tl, state = api.forward(model.params, model.plan, state=state,
                                tokens=torch.as_tensor(nxt))
        _logits_close(tl, jl)
    assert int(state["len"]) == int(jstate["len"]) == 12
    for key, val in state.items():
        if key == "len":
            continue
        want = np.asarray(jstate[key])
        if key in ("k_q", "v_q"):
            assert (val.numpy() == want).mean() >= 0.999, key
        else:
            np.testing.assert_allclose(val.numpy(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- engines
def _serve(eng, prompts, max_new=6, sampling=None, submit=GenerationRequest):
    streams = [eng.submit(submit(prompt=p.copy(), max_new_tokens=max_new,
                                 sampling=sampling)) for p in prompts]
    eng.run_until_drained()
    return [list(s.result().tokens) for s in streams]


PROMPTS = [np.array([5, 9, 2], np.int32),
           np.array([8, 8, 1, 4, 12, 77], np.int32),
           np.arange(30, 41, dtype=np.int32)]


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_engine_greedy_streams_match_jax(jax_deployed, kv_bits, tmp_path):
    """Equal greedy streams, JAX on its Pallas kernels (interpret mode) and
    the port on the plain versions. No near-tie (top-two logit gap below
    1e-4) occurs on these prompts, so the streams are compared as they are."""
    jmodel, model = _load_pair(jax_deployed, "mha", kv_bits, tmp_path)
    jeng = JServingEngine(jmodel, slots=2, max_len=32)
    jstreams = [jeng.submit(JGenerationRequest(prompt=p.copy(), max_new_tokens=6))
                for p in PROMPTS]
    jeng.run_until_drained()
    want = [list(map(int, s.result().tokens)) for s in jstreams]
    got = _serve(ServingEngine(model, slots=2, max_len=32), PROMPTS)
    assert got == want


@pytest.fixture(scope="module")
def port_models(jax_deployed, tmp_path_factory):
    """kv_bits -> the port's model (kernel backend, CPU), loaded from the
    JAX artifact."""
    tmp = tmp_path_factory.mktemp("decode_art")
    return {kv: _load_pair(jax_deployed, "mha", kv, tmp)[1] for kv in (8, 4)}


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_batched_streams_equal_solo_streams(port_models, kv_bits):
    model = port_models[kv_bits]
    batched = _serve(ServingEngine(model, slots=3, max_len=32), PROMPTS)
    for p, stream in zip(PROMPTS, batched):
        assert _serve(ServingEngine(model, slots=3, max_len=32), [p])[0] == stream


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_recycled_slot_equals_fresh_slot(port_models, kv_bits):
    model = port_models[kv_bits]
    recycled = _serve(ServingEngine(model, slots=1, max_len=32), PROMPTS[2:] + PROMPTS[:1])
    fresh = _serve(ServingEngine(model, slots=1, max_len=32), PROMPTS[:1])
    assert recycled[1] == fresh[0]


def test_cancel_mid_flight_frees_the_slot(port_models):
    model = port_models[8]
    eng = ServingEngine(model, slots=1, max_len=32)
    a = eng.submit(GenerationRequest(prompt=PROMPTS[1].copy(), max_new_tokens=10))
    b = eng.submit(GenerationRequest(prompt=PROMPTS[0].copy(), max_new_tokens=6))
    eng.engine_step()
    eng.engine_step()
    assert eng.cancel(a.rid) and not eng.cancel(a.rid)
    assert a.finish_reason == "cancelled" and len(a.result().tokens) == 3
    assert int(eng.kv.lengths()[0]) == 0
    eng.run_until_drained()
    solo = _serve(ServingEngine(model, slots=1, max_len=32), PROMPTS[:1])
    assert list(b.result().tokens) == solo[0]
    q = eng.submit(GenerationRequest(prompt=PROMPTS[0].copy()))
    assert eng.cancel(q.rid) and q.result().finish_reason == "cancelled"
    assert len(q.result().tokens) == 0


def test_stop_tokens_end_the_stream(port_models):
    model = port_models[4]
    full = _serve(ServingEngine(model, slots=2, max_len=32), PROMPTS[1:2], max_new=8)[0]
    stop = full[3]
    first = full.index(stop)
    eng = ServingEngine(model, slots=2, max_len=32)
    s = eng.submit(GenerationRequest(prompt=PROMPTS[1].copy(), max_new_tokens=8,
                                     stop_tokens={stop}))
    res = s.result()
    assert res.finish_reason == "stop" and list(res.tokens) == full[:first + 1]


def test_submit_validates_prompt_and_length(port_models):
    eng = ServingEngine(port_models[8], slots=2, max_len=16)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(GenerationRequest(prompt=np.array([], np.int32)))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(GenerationRequest(prompt=np.arange(1, 12), max_new_tokens=6))
    eng.submit(GenerationRequest(prompt=np.arange(1, 11), max_new_tokens=6))
    assert eng.run_until_drained() > 0


def test_n_samples_fan_out(port_models):
    model = port_models[8]
    eng = ServingEngine(model, slots=4, max_len=32)
    greedy = eng.submit(GenerationRequest(prompt=PROMPTS[1].copy(), max_new_tokens=6,
                                          sampling=SamplingParams(n=3)))
    sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=11, n=2)
    sampled = eng.submit(GenerationRequest(prompt=PROMPTS[1].copy(), max_new_tokens=6,
                                           sampling=sp))
    eng.run_until_drained()
    assert len(greedy) == 3 and len(sampled) == 2
    g = [list(s.result().tokens) for s in greedy]
    assert g[0] == g[1] == g[2] == _serve(ServingEngine(model, slots=1, max_len=32),
                                          PROMPTS[1:2])[0]
    for i, stream in enumerate(sampled):     # sample i: seed sample_seed(seed, i)
        solo_sp = dataclasses.replace(sp, n=1, seed=sample_seed(sp.seed, i))
        solo = _serve(ServingEngine(model, slots=1, max_len=32), PROMPTS[1:2],
                      sampling=solo_sp)[0]
        assert list(stream.result().tokens) == solo


def test_sampled_streams_do_not_depend_on_the_batch(port_models):
    model = port_models[4]
    sp = SamplingParams(temperature=1.0, top_k=20, top_p=0.95, seed=5)
    alone = _serve(ServingEngine(model, slots=3, max_len=32), PROMPTS[:1], sampling=sp)
    eng = ServingEngine(model, slots=3, max_len=32, clock=VirtualClock())
    other = eng.submit(GenerationRequest(prompt=PROMPTS[2].copy(), max_new_tokens=6))
    eng.engine_step()
    mine = eng.submit(GenerationRequest(prompt=PROMPTS[0].copy(), max_new_tokens=6,
                                        sampling=sp))
    eng.run_until_drained()
    assert list(mine.result().tokens) == alone[0]
    assert other.result().finish_reason == "length"


# ---------------------------------------------------- artifacts and plans
def test_port_artifact_serves_in_jax(jax_deployed, tmp_path):
    """deploy() in the port from the same fp weights, saved, loaded by the
    JAX package: codes bit-equal to JAX's own deploy, the plan rebuilt
    identically, and the JAX forward of it matches the port's."""
    cfg, _, fp, jparams = jax_deployed["mha"]
    plan = ExecutionPlan.build(cfg, _policy(QuantPolicy), backend="cuda", kv_bits=4,
                               prefill_batch=2,
                               sampling=SamplingParams(temperature=0.7, seed=3))
    model = deploy(fp, plan, CALIB, device="cpu")
    model.save(str(tmp_path / "port_art"))
    jmodel = JDeployedModel.load(str(tmp_path / "port_art"))
    assert jmodel.plan.backend == "pallas" and jmodel.plan.kv_bits == 4
    assert jmodel.plan.default_sampling.temperature == 0.7
    assert plan_from_meta(plan_to_meta(plan)) == plan
    for seg in range(2):
        for name in ("wq", "wo"):
            got = jmodel.params["layers"][seg]["attn"][name]
            want = jparams["layers"][seg]["attn"][name]
            np.testing.assert_array_equal(np.asarray(got["wq"]), np.asarray(want["wq"]))
            np.testing.assert_allclose(np.asarray(got["s_a"]), np.asarray(want["s_a"]),
                                       rtol=1e-5)
    toks = np.random.default_rng(2).integers(1, 256, (2, 8)).astype(np.int32)
    jl = japi.forward(jmodel.params, jmodel.plan, tokens=jnp.asarray(toks))[0]
    tl = api.forward(model.params, model.plan, tokens=torch.as_tensor(toks))[0]
    _logits_close(tl, jl)
