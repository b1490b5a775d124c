"""The port's ``ReplicaSet`` on the CPU: JAX's ``tests/test_replicas.py``
cases on the port, and the same requests through JAX's ``ReplicaSet`` and
the port's on one artifact JAX exported.

The model is JAX's: a reduced stablelm-3b with a GELU FFN, W4A4 in every
layer, kv_bits 8, reference backend, deployed by the JAX package from
numpy weights and saved; the port loads that artifact. Streams are held to
the decode-parity rule of ``tests/test_torch_decode.py``: equal token for
token (no near-tie occurs on these prompts). Dispatch (which member serves
each rid) and the rids themselves must be equal exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.deploy import ExecutionPlan as JExecutionPlan
from repro.deploy import deploy as jdeploy
from repro.serving import GenerationRequest as JGenerationRequest
from repro.serving import ReplicaSet as JReplicaSet
from repro_torch.configs import get_config, reduced
from repro_torch.deploy import DeployedModel
from repro_torch.models import api
from repro_torch.serving import (GenerationRequest, ReplicaSet, SamplingParams,
                                 ServingEngine)

CALIB = [{"tokens": np.random.default_rng(0).integers(1, 256, (4, 16)).astype(np.int32)}
         for _ in range(2)]


def fp_params(cfg, seed=0):
    """fp params as numpy arrays: the port's init tree (JAX's keys and
    shapes), every random leaf redrawn from numpy."""
    rng = np.random.default_rng(seed)
    tree = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    const = lambda a: bool(torch.all(a == 0) or torch.all(a == 1))
    return jax.tree.map(lambda a: a.numpy() if const(a)
                        else rng.normal(0, 0.02, tuple(a.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX DeployedModel, the port's DeployedModel loaded from JAX's
    artifact)."""
    cfg = reduced(get_config("stablelm-3b")).replace(act="gelu")
    jcfg = jreduced(jget_config("stablelm-3b")).replace(act="gelu")
    jpol = JQuantPolicy(num_layers=4, mode="int", last_k_int4=4)
    jplan = JExecutionPlan.build(jcfg, jpol, backend="reference", kv_bits=8)
    jmodel = jdeploy(jax.tree.map(jnp.asarray, fp_params(cfg)), jplan, CALIB)
    path = str(tmp_path_factory.mktemp("replicas") / "art")
    jmodel.save(path)
    return jmodel, DeployedModel.load(path, device="cpu")


@pytest.fixture(scope="module")
def model(models):
    return models[1]


def _prompts(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(rng.integers(3, 7))).astype(np.int32)
            for _ in range(n)]


def _owners(rs, rids):
    return [next(i for i, e in enumerate(rs.engines) if rid in e._streams
                 or any(r.rid == rid for r in e.done)) for rid in rids]


# --------------------------------------------------------- against JAX
def test_replica_set_matches_jax_on_one_artifact(models):
    """The same burst through JAX's ReplicaSet and the port's: equal rids,
    equal dispatch (member per rid, recorded at submit), equal streams,
    rid-sorted pop_done in both."""
    jmodel, model = models
    prompts = _prompts(model.plan.cfg.vocab_size, 8, seed=3)

    def run(rs, req):
        streams, owners = [], []
        for p in prompts:
            s = rs.submit(req(prompt=p.copy(), max_new_tokens=4))
            streams.append(s)
            owners.append(next(i for i, e in enumerate(rs.engines)
                               if s.rid in e._streams))
        steps = rs.run_until_drained()
        done = rs.pop_done()
        return ([s.rid for s in streams], owners, steps,
                [list(map(int, s.result().tokens)) for s in streams],
                [r.rid for r in done])

    want = run(JReplicaSet(jmodel, replicas=2, slots=2, max_len=32), JGenerationRequest)
    got = run(ReplicaSet(model, replicas=2, slots=2, max_len=32), GenerationRequest)
    assert got[0] == want[0] == list(range(8))
    assert got[1] == want[1]                     # dispatch, member by member
    assert got[2] == want[2]                     # engine steps to drain
    assert got[3] == want[3]                     # streams
    assert got[4] == want[4] == sorted(got[4])
    assert all(len(s) == 4 for s in got[3])


# ------------------------------------------------ JAX's cases, on the port
def test_shared_rid_space(model):
    rs = ReplicaSet(model, replicas=3, slots=2, max_len=32)
    streams = [rs.submit(GenerationRequest(prompt=p, max_new_tokens=2))
               for p in _prompts(model.plan.cfg.vocab_size, 6)]
    # one counter set-wide: sequential rids even though members alternate
    assert [s.rid for s in streams] == list(range(6))
    assert all(e.scheduler._ids is rs.engines[0].scheduler._ids for e in rs.engines)


def test_least_loaded_dispatch(model):
    rs = ReplicaSet(model, replicas=2, slots=2, max_len=32)
    p1, p2 = _prompts(model.plan.cfg.vocab_size, 2)
    s1 = rs.submit(GenerationRequest(prompt=p1, max_new_tokens=2))
    s2 = rs.submit(GenerationRequest(prompt=p2, max_new_tokens=2))
    owner = [next(e for e in rs.engines if s.rid in e._streams) for s in (s1, s2)]
    assert owner[0] is rs.engines[0]       # tie -> lowest index
    assert owner[1] is rs.engines[1]       # then the now-emptier member


def test_streams_match_single_engine(model):
    prompts = _prompts(model.plan.cfg.vocab_size, 8, seed=3)

    def run(make):
        eng = make()
        streams = [eng.submit(GenerationRequest(prompt=p, max_new_tokens=4))
                   for p in prompts]
        eng.run_until_drained()
        return [tuple(s.result().tokens) for s in streams]

    single = run(lambda: ServingEngine(model, slots=2, max_len=32))
    multi = run(lambda: ReplicaSet(model, replicas=2, slots=2, max_len=32))
    # tokens are a function of (prompt, seed) only, never of the member,
    # slot or batch that served the request: byte-identical
    assert single == multi


def test_replicas_share_the_model_tensors(model):
    rs = ReplicaSet(model, replicas=3, slots=2, max_len=32)
    assert all(e.params is model.params for e in rs.engines)
    assert len({id(e.kv.state["k_q"]) for e in rs.engines}) == 3
    assert all(e.metrics is rs.metrics and e.clock is rs.clock for e in rs.engines)


def test_replicas_drain_in_fewer_steps(model):
    prompts = _prompts(model.plan.cfg.vocab_size, 8, seed=5)

    def steps(make):
        eng = make()
        for p in prompts:
            eng.submit(GenerationRequest(prompt=p, max_new_tokens=4))
        return eng.run_until_drained()

    one = steps(lambda: ServingEngine(model, slots=2, max_len=32))
    two = steps(lambda: ReplicaSet(model, replicas=2, slots=2, max_len=32))
    # 2x the slots pumped per step: the backlog halves (within a step or
    # two of slack for ragged tail batches)
    assert two <= one // 2 + 2


def test_pop_done_rid_sorted(model):
    rs = ReplicaSet(model, replicas=2, slots=2, max_len=32)
    for p in _prompts(model.plan.cfg.vocab_size, 6, seed=7):
        rs.submit(GenerationRequest(prompt=p, max_new_tokens=3))
    rs.run_until_drained()
    done = rs.pop_done()
    assert [r.rid for r in done] == sorted(r.rid for r in done)
    assert len(done) == 6
    assert rs.pop_done() == []
    assert rs.done == []


def test_cancel_reaches_any_member(model):
    rs = ReplicaSet(model, replicas=2, slots=1, max_len=32)
    streams = [rs.submit(GenerationRequest(prompt=p, max_new_tokens=8))
               for p in _prompts(model.plan.cfg.vocab_size, 4, seed=9)]
    # rid 3 landed on member 1 (alternating under equal load); the
    # set-level cancel finds it without a replica argument
    assert _owners(rs, [streams[3].rid]) == [1]
    assert rs.cancel(streams[3].rid)
    assert streams[3].cancel() is False    # already cancelled
    rs.run_until_drained()
    by_rid = {r.rid: r for r in rs.pop_done()}
    assert by_rid[streams[3].rid].finish_reason == "cancelled"
    assert all(by_rid[s.rid].finish_reason == "length"
               for s in streams if s is not streams[3])


def test_fanout_children_get_unique_rids(model):
    rs = ReplicaSet(model, replicas=2, slots=2, max_len=32)
    p = _prompts(model.plan.cfg.vocab_size, 1, seed=11)[0]
    kids = rs.submit(GenerationRequest(
        prompt=p, max_new_tokens=2,
        sampling=SamplingParams(temperature=0.8, seed=0, n=3)))
    solo = rs.submit(GenerationRequest(prompt=p, max_new_tokens=2))
    rids = [s.rid for s in kids] + [solo.rid]
    # children draw from their member's scheduler, which is the SHARED
    # counter, so no rid collides across members
    assert len(set(rids)) == len(rids)
    rs.run_until_drained()
    assert len(rs.pop_done()) == 4


def test_replicas_must_be_positive(model):
    with pytest.raises(ValueError, match="replicas must be >= 1"):
        ReplicaSet(model, replicas=0)
    rs = ReplicaSet(model, replicas=1, slots=2, max_len=32)
    assert rs.replicas == 1 and rs.engine_step() == [] and rs.last_step_tokens == 0
