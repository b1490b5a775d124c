"""Encoder serving in the port: the engine against the direct forward.

A deployed small TinyBERT (layer 0 W8A8, layer 1 W4A4, kernel backend, CPU
tensors) answers classify / embed / score requests. One mixed-length group
through the engine must equal the port's direct batched forward on the
same padded batch bit for bit, and agree with the JAX engine serving the
same artifact within the whole-model tolerance (rtol = atol = 1e-4).
Lifecycle semantics (deadline shed, cancel, priority) run on a
``VirtualClock``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.deploy import ExecutionPlan as JExecutionPlan
from repro.deploy import deploy as jdeploy
from repro.models.bert import tinybert_config as jtinybert_config
from repro.serving import EncodeRequest as JEncodeRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving import VirtualClock as JVirtualClock
from repro_torch.core.policy import QuantPolicy
from repro_torch.deploy import DeployedModel, ExecutionPlan, params_from_numpy
from repro_torch.models.bert import (bert_encode, bert_pool,
                                     init_bert_classifier, tinybert_config)
from repro_torch.serving import (EncodeRequest, QueueFullError, ServingEngine,
                                 VirtualClock)

SMALL = dict(layers=2, d=64, heads=4, d_ff=128, vocab=256, name="tinybert-test")
TASKS = ("classify", "embed", "score")


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
def models():
    """(JAX deployed model, the port's model on its arrays), kernel
    backends on both sides."""
    jcfg, cfg = jtinybert_config(**SMALL), tinybert_config(**SMALL)
    jplan = JExecutionPlan.build(
        jcfg, JQuantPolicy(num_layers=2, mode="int", last_k_int4=1),
        backend="pallas", mode="encoder", prefill_batch=4)
    rng = np.random.default_rng(0)
    calib = [{"tokens": rng.integers(1, 256, (4, 16)).astype(np.int32)}]
    jmodel = jdeploy(jax.tree.map(jnp.asarray, fp_params(cfg)), jplan, calib)
    plan = ExecutionPlan.build(
        cfg, QuantPolicy(num_layers=2, mode="int", last_k_int4=1),
        backend="cuda", mode="encoder", prefill_batch=4)
    model = DeployedModel(plan=plan, params=params_from_numpy(
        jax.tree.map(np.asarray, jmodel.params), "cpu"))
    return jmodel, model


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, n).astype(np.int32) for n in lens]


def _direct(model, prompts, bucket):
    """The port's direct batched forward on the padded batch the engine's
    group runs (model functions only, no engine code)."""
    toks = np.zeros((len(prompts), bucket), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = torch.as_tensor([len(p) for p in prompts])
    with torch.no_grad():
        h = bert_encode(model.params, model.plan, toks, lengths=lens)
        embed = bert_pool(model.params, h)
        logits = embed @ model.params["classifier"]["w"] + model.params["classifier"]["b"]
        logp = torch.log_softmax(logits, -1)
    return {"classify": logits.numpy(), "embed": embed.numpy(),
            "score": logp[:, 1].numpy()}


@pytest.mark.parametrize("task", TASKS)
def test_engine_matches_direct_forward_and_reference(models, task):
    jmodel, model = models
    prompts = _prompts((5, 6, 7, 8), seed=TASKS.index(task))   # one bucket-8 group
    eng = ServingEngine(model, slots=4, max_len=64, clock=VirtualClock())
    handles = [eng.submit_encode(EncodeRequest(tokens=p, task=task)) for p in prompts]
    eng.run_until_drained()
    assert eng.metrics.summary()["encode_steps"] == 1
    want = _direct(model, prompts, 8)[task]
    jeng = JServingEngine(jmodel, slots=4, max_len=64, clock=JVirtualClock())
    jhandles = [jeng.submit_encode(JEncodeRequest(tokens=p, task=task))
                for p in prompts]
    jeng.run_until_drained()
    for i, (h, jh) in enumerate(zip(handles, jhandles)):
        res = h.result()
        assert res.finish_reason == "done"
        np.testing.assert_array_equal(np.asarray(res.value), want[i])
        np.testing.assert_allclose(res.value, jh.result().value, rtol=1e-4, atol=1e-4)
        if task == "classify":
            assert np.argmax(res.value) == np.argmax(jh.result().value)


def test_mixed_buckets_resolve_in_groups(models):
    _, model = models
    lens = (3, 9, 17, 33, 5, 12)
    prompts = _prompts(lens, seed=5)
    eng = ServingEngine(model, slots=8, max_len=64, clock=VirtualClock())
    hs = [eng.submit_encode(EncodeRequest(tokens=p, task=TASKS[i % 3]))
          for i, p in enumerate(prompts)]
    eng.run_until_drained()
    # buckets 8 (3, 5), 16 (9, 12), 32 (17), 64 (33): four forwards
    assert eng.metrics.summary()["encode_steps"] == 4
    for p, h in zip(prompts, hs):
        res = h.result()
        bucket = {3: 8, 5: 8, 9: 16, 12: 16, 17: 32, 33: 64}[len(p)]
        group = [q for q in prompts if {3: 8, 5: 8, 9: 16, 12: 16, 17: 32,
                                        33: 64}[len(q)] == bucket]
        n = 1 << max(len(group) - 1, 0).bit_length()
        padded = group + [np.ones(1, np.int32)] * (n - len(group))
        want = _direct(model, padded, bucket)[res.task][
            [i for i, q in enumerate(group) if q is p][0]]
        np.testing.assert_array_equal(np.asarray(res.value), want)
    assert len(eng.pop_done()) == len(prompts) and not eng.done


def test_deadline_shed_on_virtual_clock(models):
    _, model = models
    clock = VirtualClock()
    eng = ServingEngine(model, slots=2, max_len=64, clock=clock)
    h = eng.submit_encode(EncodeRequest(tokens=np.arange(1, 6), deadline_s=0.05))
    clock.advance(0.1)                 # past the admission deadline
    eng.engine_step()
    assert h.finished and h.finish_reason == "shed"
    assert h.result().value is None
    assert not eng.scheduler.has_work


def test_cancel_while_queued(models):
    _, model = models
    eng = ServingEngine(model, slots=2, max_len=64, clock=VirtualClock())
    seen = []
    h = eng.submit_encode(EncodeRequest(tokens=np.arange(1, 6)),
                          on_result=lambda rid, v: seen.append((rid, v)))
    assert h.cancel()
    assert h.finished and h.finish_reason == "cancelled"
    assert seen == [(h.rid, None)]
    assert not eng.scheduler.has_work
    assert not h.cancel()              # already terminal


def test_priority_orders_admission(models):
    _, model = models
    eng = ServingEngine(model, slots=1, max_len=64, clock=VirtualClock())
    order = []
    hs = [eng.submit_encode(EncodeRequest(tokens=np.arange(1, 5), priority=pr),
                            on_result=lambda rid, v: order.append(rid))
          for pr in (0, 5, 1)]
    eng.run_until_drained()
    assert order == [hs[1].rid, hs[2].rid, hs[0].rid]


def test_bad_requests_rejected(models):
    _, model = models
    with pytest.raises(ValueError, match="task"):
        EncodeRequest(tokens=np.arange(3), task="generate")
    eng = ServingEngine(model, slots=2, max_len=8, clock=VirtualClock(),
                        max_queue=1)
    with pytest.raises(ValueError, match="empty"):
        eng.submit_encode(EncodeRequest(tokens=np.array([], np.int32)))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit_encode(EncodeRequest(tokens=np.arange(1, 12)))
    eng.submit_encode(EncodeRequest(tokens=np.arange(1, 4)))
    with pytest.raises(QueueFullError):
        eng.submit_encode(EncodeRequest(tokens=np.arange(1, 4)))


def test_engine_needs_an_encoder_plan(models):
    """Each mode refuses the other's requests: a decode engine has no
    encode path (the decoder score task is a later slice) and an encoder
    engine no decode loop."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import api
    from repro_torch.serving import GenerationRequest
    _, model = models
    enc = ServingEngine(model, slots=2, max_len=8)
    with pytest.raises(ValueError, match="submit_encode"):
        enc.submit(GenerationRequest(prompt=np.arange(1, 4)))
    cfg = reduced(get_config("stablelm-3b")).replace(num_layers=1)
    plan = ExecutionPlan.build(cfg, None, mode="decode")
    dec = ServingEngine(api.init_model(cfg, torch.Generator().manual_seed(0),
                                       "cpu"), plan, slots=2, max_len=8)
    with pytest.raises(ValueError, match="later slice"):
        dec.submit_encode(EncodeRequest(tokens=np.arange(1, 4), task="score"))
