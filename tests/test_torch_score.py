"""Port parity: the decoder ``score`` task (prompt log-likelihood) on a
decode engine.

A reduced stablelm-3b (4 layers, d 64, vocab 256) under the serve CLI's
policy shape (layers 0-1 W8A8, 2-3 W4A4) is deployed by the JAX package
from numpy weights; the artifact JAX saves is loaded by the port (its
kernel backend, whose plain versions CPU tensors take), and JAX's engine
serves the same params on its jnp reference backend. A score is
``sum_{i>=1} log p(t_i | t_<i)`` from one batched, bucketed causal forward
over a kv-16 scratch state. Tolerances:

* port vs JAX: each score within rtol 1e-5 + atol 1e-4 (the whole-model
  logits agree to 1e-4, ``test_torch_decode.py``; a score sums up to 30
  log-probabilities);
* inside the port: batched == solo and scores interleaved with decode
  traffic == scores alone, bit for bit; decode streams are unchanged by
  the score traffic (dense and paged);
* every refusal raises where JAX's engine raises, with the same message.
"""
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
from repro.serving import EncodeRequest as JEncodeRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config, reduced
from repro_torch.deploy import DeployedModel
from repro_torch.models import api
from repro_torch.serving import (EncodeRequest, GenerationRequest,
                                 ServingEngine, VirtualClock)

PROMPTS = [np.array([5, 9, 2], np.int32),
           np.array([8, 8, 1, 4, 12, 77], np.int32),
           np.arange(30, 41, dtype=np.int32),
           (np.arange(20, dtype=np.int32) * 7) % 255 + 1,
           (np.arange(30, dtype=np.int32) * 13) % 251 + 1]
RTOL, ATOL = 1e-5, 1e-4


def _policy(cls):
    return cls(num_layers=4, mode="int", last_k_int4=2)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX reference-backend model, port model loaded from JAX's artifact
    at kv_bits 8, port model at kv_bits 8 with paged KV)."""
    cfg = reduced(get_config("stablelm-3b"))
    jcfg = jreduced(jget_config("stablelm-3b"))
    rng = np.random.default_rng(0)
    tree = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    const = lambda a: bool(torch.all(a == 0) or torch.all(a == 1))
    fp = jax.tree.map(lambda a: a.numpy() if const(a)
                      else rng.normal(0, 0.02, tuple(a.shape)).astype(np.float32), tree)
    calib = [{"tokens": np.random.default_rng(0).integers(1, 256, (4, 16)).astype(np.int32)}
             for _ in range(2)]
    jparams = jdeploy(jax.tree.map(jnp.asarray, fp),
                      JExecutionPlan.build(jcfg, _policy(JQuantPolicy)), calib).params
    jref = JDeployedModel(plan=JExecutionPlan.build(
        jcfg, _policy(JQuantPolicy), backend="reference", kv_bits=8,
        prefill_batch=4), params=jparams)
    tmp = tmp_path_factory.mktemp("score_art")
    out = {"jax": jref}
    for paging in ("dense", "paged"):
        path = str(tmp / paging)
        JDeployedModel(plan=JExecutionPlan.build(
            jcfg, _policy(JQuantPolicy), backend="pallas", kv_bits=8,
            prefill_batch=4, kv_paging=paging), params=jparams).save(path)
        out[paging] = DeployedModel.load(path, device="cpu")
    return out


def _scores(eng, prompts, submit=EncodeRequest):
    handles = [eng.submit_encode(submit(tokens=p.copy(), task="score")) for p in prompts]
    eng.run_until_drained()
    return [float(h.result().value) for h in handles]


def test_decoder_scores_match_jax(models):
    port = models["dense"]
    assert port.plan.backend == "cuda" and port.plan.prefill_batch == 4
    want = _scores(JServingEngine(models["jax"], slots=4, max_len=64), PROMPTS,
                   submit=JEncodeRequest)
    got = _scores(ServingEngine(port, slots=4, max_len=64), PROMPTS)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert all(s < 0 for s in got)
    # one token has no continuation to score
    one = _scores(ServingEngine(port, slots=1, max_len=64), [np.array([7], np.int32)])
    assert one == [0.0]


def test_scores_batched_equal_solo(models):
    """Four same-bucket prompts in ONE forward (prefill_batch 4) against
    each alone: bit-equal."""
    port = models["dense"]
    same_bucket = [PROMPTS[3], PROMPTS[4], PROMPTS[4][:25], PROMPTS[3][:17]]
    eng = ServingEngine(port, slots=4, max_len=64)
    batched = _scores(eng, same_bucket)
    assert eng.metrics.summary()["encode_steps"] == 1
    for p, s in zip(same_bucket, batched):
        assert _scores(ServingEngine(port, slots=4, max_len=64), [p]) == [s]


@pytest.mark.parametrize("paging", ["dense", "paged"])
def test_scores_interleave_with_decode_traffic(models, paging):
    """Score requests submitted between decode steps resolve in the step
    that admits them, and leave every decode stream as it is without them;
    the scores equal the scores alone."""
    port = models[paging]
    gen_alone = ServingEngine(port, slots=4, max_len=64)
    streams = [gen_alone.submit(GenerationRequest(prompt=p.copy(), max_new_tokens=8))
               for p in PROMPTS[:3]]
    gen_alone.run_until_drained()
    want_streams = [list(s.result().tokens) for s in streams]
    want_scores = _scores(ServingEngine(port, slots=4, max_len=64), PROMPTS[2:])

    eng = ServingEngine(port, slots=4, max_len=64, clock=VirtualClock())
    streams = [eng.submit(GenerationRequest(prompt=p.copy(), max_new_tokens=8))
               for p in PROMPTS[:3]]
    handles = []
    for p in PROMPTS[2:]:
        eng.engine_step()
        handles.append(eng.submit_encode(EncodeRequest(tokens=p.copy(), task="score")))
        eng.engine_step()
        assert handles[-1].finished and eng.last_step_encode_tokens == len(p)
    eng.run_until_drained()
    assert [list(s.result().tokens) for s in streams] == want_streams
    assert [float(h.result().value) for h in handles] == want_scores
    s = eng.metrics.summary()
    assert s["encode_steps"] == 3 and s["encode_latency_n"] == 3


REFUSALS = [("empty input", np.array([], np.int32), "score"),
            ("exceeds engine max_len", np.arange(1, 70, dtype=np.int32), "score"),
            ("only task='score'", np.arange(1, 5, dtype=np.int32), "classify"),
            ("only task='score'", np.arange(1, 5, dtype=np.int32), "embed")]


@pytest.mark.parametrize("match,tokens,task", REFUSALS,
                         ids=["empty", "too_long", "classify", "embed"])
def test_score_refusals_match_jax(models, match, tokens, task):
    jeng = JServingEngine(models["jax"], slots=2, max_len=64)
    with pytest.raises(ValueError, match=match):
        jeng.submit_encode(JEncodeRequest(tokens=tokens, task=task))
    eng = ServingEngine(models["dense"], slots=2, max_len=64)
    with pytest.raises(ValueError, match=match):
        eng.submit_encode(EncodeRequest(tokens=tokens, task=task))
    assert not eng.scheduler.has_work


def test_engine_takes_a_metrics_recorder(models):
    """The ``metrics=`` knob: the engine writes to the recorder it is
    given, as JAX's engine does."""
    from repro_torch.serving import ServeMetrics
    rec = ServeMetrics()
    eng = ServingEngine(models["dense"], slots=2, max_len=64, metrics=rec)
    assert eng.metrics is rec
    _scores(eng, PROMPTS[:2])
    assert rec.summary()["encode_tokens"] == len(PROMPTS[0]) + len(PROMPTS[1])
