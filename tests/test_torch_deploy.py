"""Port parity: deploy(), the artifact format and the execution plan.

The same fp parameters (numpy) and calibration batches go through the JAX
``deploy`` and the port's. Packed weight codes and weight scales must be
bit-equal; calibrated activation scales within rtol 1e-5 (they are
percentiles of fp activations, whose float rounding differs between XLA
and PyTorch). An artifact saved by either package loads in the other: the
plan round-trips, and logits agree within the whole-model tolerance
(rtol = atol = 1e-4, the same argmax).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.manager as jmanager
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.deploy import DeployedModel as JDeployedModel
from repro.deploy import ExecutionPlan as JExecutionPlan
from repro.deploy import deploy as jdeploy
from repro.deploy.plan import plan_to_meta as jplan_to_meta
from repro.models.bert import bert_classify_logits as jbert_classify_logits
from repro.models.bert import tinybert_config as jtinybert_config
from repro_torch.checkpoint import manager
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.deploy import (DeployedModel, ExecutionPlan, deploy,
                                params_from_numpy)
from repro_torch.deploy.plan import plan_from_meta, plan_to_meta
from repro_torch.models.bert import (bert_classify_logits,
                                     init_bert_classifier, tinybert_config)

SMALL = dict(layers=2, d=64, heads=4, d_ff=128, vocab=256, name="tinybert-test")
POLICIES = {"mixed": dict(last_k_int4=1), "mixed_a8": dict(last_k_int4=1)}
ACT_BITS = {"mixed": None, "mixed_a8": 8}


def fp_params(cfg, seed=0):
    """fp classifier params as numpy arrays: the port's init tree (the JAX
    package's keys and shapes), every random leaf redrawn from numpy."""
    rng = np.random.default_rng(seed)
    tree = init_bert_classifier(cfg, 2, torch.Generator().manual_seed(0), "cpu")
    const = lambda a: bool(torch.all(a == 0) or torch.all(a == 1))
    return jax.tree.map(
        lambda a: a.numpy() if const(a)
        else rng.normal(0, 0.02, tuple(a.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = tinybert_config(**SMALL), jtinybert_config(**SMALL)
    fp = fp_params(cfg)
    rng = np.random.default_rng(0)
    calib = [{"tokens": rng.integers(1, 256, (4, 16)).astype(np.int32)}
             for _ in range(2)]
    return cfg, jcfg, fp, calib


def _plans(cfg, jcfg, name, jax_backend="reference"):
    kw = dict(mode="encoder", prefill_batch=4, act_bits=ACT_BITS[name])
    jplan = JExecutionPlan.build(
        jcfg, JQuantPolicy(num_layers=2, mode="int", **POLICIES[name]),
        backend=jax_backend, **kw)
    plan = ExecutionPlan.build(
        cfg, QuantPolicy(num_layers=2, mode="int", **POLICIES[name]),
        backend="cuda", **kw)
    return jplan, plan


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_deploy_matches_reference(setup, name):
    cfg, jcfg, fp, calib = setup
    jplan, plan = _plans(cfg, jcfg, name)
    want = jmanager._flatten(jdeploy(jax.tree.map(jnp.asarray, fp), jplan,
                                     calib).params)
    got = manager._flatten(deploy(params_from_numpy(fp, "cpu"), plan, calib,
                                  device="cpu").params)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        if key.endswith("/s_a"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=key)
        else:                    # wq, s_w, biases, norms, embeddings, heads
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _tokens():
    rng = np.random.default_rng(3)
    return rng.integers(1, 256, (3, 12)).astype(np.int32)


def test_jax_artifact_serves_in_port(setup, tmp_path):
    cfg, jcfg, fp, calib = setup
    jplan, _ = _plans(cfg, jcfg, "mixed", jax_backend="pallas")
    jmodel = jdeploy(jax.tree.map(jnp.asarray, fp), jplan, calib)
    jmodel.save(str(tmp_path / "art"))
    model = DeployedModel.load(str(tmp_path / "art"), device="cpu")
    assert model.plan.backend == "cuda" and model.plan.fuse_epilogue
    assert model.plan.mode == "encoder" and model.plan.prefill_batch == 4
    assert [(s, e, sp.w_bits, sp.a_bits) for s, e, sp in model.plan.segments] \
        == [(s, e, sp.w_bits, sp.a_bits) for s, e, sp in jplan.segments]
    assert model.params["layers"][1]["attn"]["wq"]["wq"].dtype == torch.uint8
    toks = _tokens()
    want, _ = jbert_classify_logits(jmodel.params, jplan, jnp.asarray(toks))
    got = bert_classify_logits(model.params, model.plan, toks).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), np.asarray(want).argmax(-1))


def test_port_artifact_serves_in_jax(setup, tmp_path):
    cfg, jcfg, fp, calib = setup
    jplan, plan = _plans(cfg, jcfg, "mixed", jax_backend="pallas")
    model = deploy(params_from_numpy(fp, "cpu"), plan, calib, device="cpu")
    model.save(str(tmp_path / "art"))
    jmodel = JDeployedModel.load(str(tmp_path / "art"))
    assert jmodel.plan == jplan                  # the plan round-trips
    again = DeployedModel.load(str(tmp_path / "art"), device="cpu")
    assert again.plan == plan
    toks = _tokens()
    want, _ = jbert_classify_logits(jmodel.params, jmodel.plan, jnp.asarray(toks))
    got = bert_classify_logits(model.params, plan, toks).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), np.asarray(want).argmax(-1))


@pytest.mark.parametrize("backend,act_bits", [("cuda", None), ("reference", 0),
                                              ("reference", 4)])
def test_plan_meta_round_trip(backend, act_bits):
    cfg = tinybert_config(**SMALL)
    plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=2, mode="int",
                                                last_k_int4=1),
                               backend=backend, mode="encoder",
                               act_bits=act_bits, prefill_batch=2)
    meta = plan_to_meta(plan)
    assert meta["build"]["backend"] == {"cuda": "pallas"}.get(backend, backend)
    assert plan_from_meta(meta) == plan


@pytest.mark.parametrize("kw,match", [
    (dict(mode="decode", prefill_mode="token"), "token-mode prefill"),
    (dict(mode="decode", prefill_mode="token", prefix_cache=1024),
     "prefix_cache needs the chunked"),
    (dict(kv_paging="paged"), "pages the decode KV cache"),
    (dict(tp=2, backend="cuda"), "single-device"),
    (dict(backend="pallas"), "backend"),
    (dict(act_bits=0, backend="cuda"), "reference-backend"),
    (dict(act_bits=3), "act_bits"),
    (dict(prefix_cache=1024), "prefix_cache"),
])
def test_plan_rejects_what_this_slice_does_not_serve(kw, match):
    kw = {"mode": "encoder", **kw}
    # decode plans serve the dense decoder and vlm families, encoder plans bert
    cfg = (reduced(get_config("stablelm-3b")).replace(num_layers=2)
           if kw["mode"] == "decode" else tinybert_config(**SMALL))
    pol = QuantPolicy(num_layers=2, mode="int", last_k_int4=1)
    with pytest.raises(ValueError, match=match):
        ExecutionPlan.build(cfg, pol, **kw)


def test_decode_plan_builds_for_the_vlm_as_in_jax():
    """A decode plan for the reduced llava builds, as JAX's does, and its
    meta rebuilds the same plan in both packages."""
    cfg = reduced(get_config("llava-next-mistral-7b"))
    plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=4, mode="int",
                                                last_k_int4=2),
                               backend="cuda", kv_bits=8, prefill_batch=2)
    jplan = JExecutionPlan.build(jreduced(jget_config("llava-next-mistral-7b")),
                                 JQuantPolicy(num_layers=4, mode="int",
                                              last_k_int4=2),
                                 backend="pallas", kv_bits=8, prefill_batch=2)
    assert plan.mode == "decode" and plan.prefill_mode == jplan.prefill_mode
    assert [(s, e, sp.w_bits, sp.a_bits) for s, e, sp in plan.segments] == \
        [(s, e, sp.w_bits, sp.a_bits) for s, e, sp in jplan.segments]
    assert plan_from_meta(plan_to_meta(plan)) == plan
    assert plan_from_meta(jplan_to_meta(jplan)) == plan


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-3b-a800m"])
def test_moe_decode_plan_matches_jax(arch):
    """A MoE decode plan builds (the family the port refused before) and
    equals JAX's: segments, prefill_mode, kv and the meta both ways."""
    cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
    assert cfg == ModelConfig.from_dict(dataclasses.asdict(jcfg))
    kw = dict(kv_bits=8, prefill_batch=2, kv_paging="paged")
    plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=4, mode="int", last_k_int4=2),
                               backend="cuda", **kw)
    jplan = JExecutionPlan.build(jcfg, JQuantPolicy(num_layers=4, mode="int",
                                                    last_k_int4=2),
                                 backend="pallas", **kw)
    assert plan.mode == "decode" and plan.prefill_mode == jplan.prefill_mode == "chunked"
    assert [(s, e, sp.w_bits, sp.a_bits) for s, e, sp in plan.segments] == \
        [(s, e, sp.w_bits, sp.a_bits) for s, e, sp in jplan.segments]
    assert plan_from_meta(plan_to_meta(plan)) == plan
    assert plan_from_meta(jplan_to_meta(jplan)) == plan
    assert plan_to_meta(plan) == jplan_to_meta(jplan)


@pytest.mark.parametrize("family,extra", [
    ("xlstm", dict(slstm_every=2)),
    ("hybrid", dict(attn_every=2, ssm_state=8)),
    ("encdec", dict(enc_layers=1, dec_layers=1)),
])
def test_decode_plan_refuses_the_families_still_to_port(family, extra):
    from repro_torch.configs.base import ModelConfig
    cfg = ModelConfig(name=f"tiny-{family}", family=family, num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
                      vocab_size=256, **extra)
    pol = QuantPolicy(num_layers=2, mode="int", last_k_int4=1)
    with pytest.raises(ValueError, match="later slice"):
        ExecutionPlan.build(cfg, pol, backend="cuda", mode="decode")


def test_params_from_numpy_keeps_dtypes():
    tree = {"a": [np.zeros((2, 3), np.uint8), np.ones(4, np.int8)],
            "b": {"c": np.float32(1.5) * np.ones((2,), np.float32)}}
    out = params_from_numpy(tree, "cpu")
    assert out["a"][0].dtype == torch.uint8 and out["a"][1].dtype == torch.int8
    assert out["b"]["c"].dtype == torch.float32
    flat = manager._flatten(out)
    assert sorted(flat) == ["a/0", "a/1", "b/c"]
    back = manager._nest(flat)
    assert isinstance(back["a"], list) and back["b"]["c"].tolist() == [1.5, 1.5]


def test_deploy_needs_an_int_policy(setup):
    cfg = tinybert_config(**SMALL)
    fp_plan = ExecutionPlan.build(cfg, None, mode="encoder")
    with pytest.raises(ValueError, match="mode='int'"):
        deploy({}, fp_plan, device="cpu")
