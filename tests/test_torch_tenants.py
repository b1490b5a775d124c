"""The port's ``MultiTenantEngine`` on the CPU: JAX's
``tests/test_tenants.py`` cases on the port, and the same submits on a
``VirtualClock`` through JAX's engine and the port's.

Two tenants, as in JAX's file: ``cls``, an int4 W4A4 BERT classifier
(2 layers, d 64, 4 heads, d_ff 128) under a ``mode='encoder'`` plan, and
``gen``, a reduced stablelm-3b with a GELU FFN, W4A4 in every layer, both
on the reference backend. JAX deploys them from its own initialisation and
saves them; the port loads those artifacts, so both engines serve the same
codes. Held exactly: the tenant each ``engine_step`` serves, the deficits
after it, the tokens it paid, rejections and quota releases, rids, and the
metrics' per-tenant rollups (``by_label``). Generation streams are held to
the decode-parity rule of ``tests/test_torch_decode.py`` (equal token for
token); encoder results within 1e-5.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.deploy import ExecutionPlan as JExecutionPlan
from repro.deploy import deploy as jdeploy
from repro.models import api as japi
from repro.models.bert import init_bert_classifier as jinit_bert
from repro.models.bert import tinybert_config as jtinybert
from repro.serving import EncodeRequest as JEncodeRequest
from repro.serving import GenerationRequest as JGenerationRequest
from repro.serving import MultiTenantEngine as JMultiTenantEngine
from repro.serving import QuotaExceededError as JQuotaExceededError
from repro.serving import VirtualClock as JVirtualClock
from repro_torch.deploy import DeployedModel
from repro_torch.serving import (EncodeRequest, GenerationRequest,
                                 MultiTenantEngine, QueueFullError,
                                 QuotaExceededError, TenantState, VirtualClock)

KEY = jax.random.PRNGKey(0)
CALIB = [{"tokens": np.random.default_rng(0).integers(1, 256, (4, 16)).astype(np.int32)}
         for _ in range(2)]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{'jax': (enc, dec), 'port': (enc, dec)}: JAX's deployed models and
    the port's, loaded from the artifacts JAX saved."""
    tmp = tmp_path_factory.mktemp("tenants")
    bcfg = jtinybert(num_classes=2, layers=2, d=64, heads=4, d_ff=128, vocab=256,
                     name="tinybert-test")
    bplan = JExecutionPlan.build(bcfg, JQuantPolicy(num_layers=2, mode="int",
                                                    last_k_int4=2),
                                 backend="reference", act_bits=4, mode="encoder",
                                 prefill_batch=4)
    enc = jdeploy(jinit_bert(bcfg, 2, KEY), bplan)
    cfg = jreduced(jget_config("stablelm-3b")).replace(act="gelu")
    plan = JExecutionPlan.build(cfg, JQuantPolicy(num_layers=4, mode="int",
                                                  last_k_int4=4),
                                backend="reference", act_bits=4)
    dec = jdeploy(japi.init_model(cfg, KEY), plan, CALIB)
    port = []
    for name, m in (("enc", enc), ("dec", dec)):
        m.save(str(tmp / name))
        port.append(DeployedModel.load(str(tmp / name), device="cpu"))
    return {"jax": (enc, dec), "port": tuple(port)}


def _enc_tokens(plen, seed=0):
    return np.random.default_rng(seed).integers(1, 256, plen)


def _gen_prompt(plen, seed=0):
    return np.random.default_rng(seed).integers(1, 256, plen).astype(np.int32)


def _mt(models, side="port", quantum=32):
    cls, vc = ((MultiTenantEngine, VirtualClock) if side == "port"
               else (JMultiTenantEngine, JVirtualClock))
    enc, dec = models[side]
    mt = cls(clock=vc(), quantum_tokens=quantum)
    mt.add_tenant("cls", enc, slots=2, max_len=64)
    mt.add_tenant("gen", dec, slots=2, max_len=64)
    return mt


def _reqs(side):
    return ((EncodeRequest, GenerationRequest, QuotaExceededError) if side == "port"
            else (JEncodeRequest, JGenerationRequest, JQuotaExceededError))


def _flood(mt, side):
    """JAX's adversarial flood: 10 generation requests first, then 4
    classify requests; every engine_step traced as (tenant served, its
    tokens, every tenant's deficit after)."""
    Enc, Gen, _ = _reqs(side)
    flood = [mt.submit(Gen(prompt=_gen_prompt(8, seed=i), max_new_tokens=6), tenant="gen")
             for i in range(10)]
    done_at = {}
    trace = []
    cls = [mt.submit_encode(Enc(tokens=_enc_tokens(8, seed=i)), tenant="cls",
                            on_result=lambda rid, v: done_at.setdefault(rid, len(trace)))
           for i in range(4)]
    served = []
    for name, t in mt.tenants.items():
        real = t.engine.engine_step
        t.engine.engine_step = (lambda n=name, f=real: (served.append(n), f())[1])
    steps = 0
    while mt.scheduler.has_work:
        n0 = len(served)
        mt.engine_step()
        trace.append((served[n0] if len(served) > n0 else None, mt.last_step_tokens,
                      tuple(t.deficit for t in mt.tenants.values())))
        steps += 1
    return {"trace": trace, "done_at": done_at, "flood": flood, "cls": cls,
            "streams": [list(map(int, s.result().tokens)) for s in flood],
            "results": [np.asarray(h.result().value) for h in cls],
            "rids": [s.rid for s in flood] + [h.rid for h in cls],
            "by_label": mt.metrics.summary()["by_label"]}


def _quota_script(mt, side):
    """Quota traffic on both tenants: each op's outcome (rid or
    'rejected') and every tenant's outstanding tokens after it."""
    Enc, Gen, Quota = _reqs(side)
    mt.tenants["cls"].token_budget = 20
    mt.tenants["gen"].token_budget = 10
    ops = [("cls", 8, 1), ("cls", 8, 2), ("cls", 8, 3), ("gen", (4, 3), 0),
           ("gen", (2, 2), 1), ("gen", (1, 2), 2)]
    log = []

    def outstanding():
        return tuple(t.outstanding_tokens for t in mt.tenants.values())
    for tenant, size, seed in ops:
        try:
            if tenant == "cls":
                h = mt.submit_encode(Enc(tokens=_enc_tokens(size, seed=seed)), tenant=tenant)
            else:
                h = mt.submit(Gen(prompt=_gen_prompt(size[0], seed=seed),
                                  max_new_tokens=size[1]), tenant=tenant)
            log.append((h.rid, outstanding()))
        except Quota:
            log.append(("rejected", outstanding()))
    log.append(("cancel", mt.cancel(log[0][0]), outstanding()))
    while mt.scheduler.has_work:
        mt.engine_step()
        log.append(("step", mt.last_step_tokens, outstanding()))
    log.append(("pop", [r.rid for r in mt.pop_done()], outstanding()))
    return log


# --------------------------------------------------------- against JAX
def test_drr_schedule_matches_jax(models):
    """The flood through both engines: the same tenant per engine_step,
    the same tokens paid, the same deficits; the same rids and the
    classify requests resolved at the same step; streams equal, results
    within 1e-5; per-tenant rollups equal."""
    want = _flood(_mt(models, "jax"), "jax")
    got = _flood(_mt(models, "port"), "port")
    assert got["trace"] == want["trace"]
    assert got["rids"] == want["rids"] == list(range(14))
    assert got["done_at"] == want["done_at"]
    assert got["streams"] == want["streams"]
    for a, b in zip(got["results"], want["results"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert got["by_label"] == want["by_label"]
    assert set(got["by_label"]) >= {"cls/encode", "gen/prefill", "gen/decode",
                                    "cls/queue_wait", "gen/ttft"}


def test_quotas_match_jax(models):
    """Quota rejections, releases on finish and on cancel, step by step."""
    got = _quota_script(_mt(models, "port"), "port")
    want = _quota_script(_mt(models, "jax"), "jax")
    assert got == want
    assert [op[0] for op in got[:6]] == [0, 1, "rejected", 2, "rejected", 3]
    assert got[-1][-1] == (0, 0)


# ------------------------------------------------ JAX's cases, on the port
def test_no_starvation_under_adversarial_flood(models):
    """A flooded decoder tenant must not starve a modest encoder tenant:
    while both have work, no tenant runs more than its DRR deficit bound
    of consecutive steps, and the modest tenant finishes while the flood
    is still draining."""
    quantum = 32
    run = _flood(_mt(models, quantum=quantum), "port")
    trace = [name for name, *_ in run["trace"]]
    for h in run["cls"]:
        assert h.finish_reason == "done"
    for s in run["flood"]:
        assert s.request.finish_reason in ("length", "stop")
    last_cls = max(run["done_at"][h.rid] for h in run["cls"])
    assert "gen" in trace[last_cls:]          # the flood kept draining after
    assert last_cls < len(trace) / 2          # ... and cls never waited on it
    run_len, prev = 0, None
    for name in trace:
        run_len = run_len + 1 if name == prev else 1
        prev = name
        assert run_len <= quantum + 1


def test_idle_tenants_cost_nothing(models):
    mt = _mt(models)
    h = mt.submit_encode(EncodeRequest(tokens=_enc_tokens(6)), tenant="cls")
    mt.engine_step()
    assert h.finish_reason == "done"
    assert mt.tenants["gen"].deficit == 0.0
    assert mt.engine_step() == []             # fully drained: no-op


def test_handle_pumps_the_drr_loop(models):
    mt = _mt(models)
    h = mt.submit_encode(EncodeRequest(tokens=_enc_tokens(6)), tenant="cls")
    res = h.result()
    assert res.finish_reason == "done" and res.value.shape == (2,)


def test_token_budget_quota_rejects_and_releases(models):
    mt = _mt(models)
    mt.tenants["cls"].token_budget = 20
    h1 = mt.submit_encode(EncodeRequest(tokens=_enc_tokens(8, seed=1)), tenant="cls")
    h2 = mt.submit_encode(EncodeRequest(tokens=_enc_tokens(8, seed=2)), tenant="cls")
    assert mt.tenants["cls"].outstanding_tokens == 16
    with pytest.raises(QuotaExceededError):
        mt.submit_encode(EncodeRequest(tokens=_enc_tokens(8, seed=3)), tenant="cls")
    assert issubclass(QuotaExceededError, QueueFullError)
    # the rejection consumed nothing, and the other tenant is untouched
    assert mt.tenants["cls"].outstanding_tokens == 16
    mt.submit(GenerationRequest(prompt=_gen_prompt(4), max_new_tokens=2), tenant="gen")
    mt.run_until_drained()
    assert h1.finish_reason == h2.finish_reason == "done"
    assert mt.tenants["cls"].outstanding_tokens == 0      # budget released
    mt.submit_encode(EncodeRequest(tokens=_enc_tokens(8, seed=3)), tenant="cls")


def test_generation_quota_counts_prompt_plus_output(models):
    mt = _mt(models)
    mt.tenants["gen"].token_budget = 10
    mt.submit(GenerationRequest(prompt=_gen_prompt(4), max_new_tokens=3), tenant="gen")
    with pytest.raises(QuotaExceededError):                # 7 + 4 > 10
        mt.submit(GenerationRequest(prompt=_gen_prompt(2), max_new_tokens=2), tenant="gen")
    mt.submit(GenerationRequest(prompt=_gen_prompt(1), max_new_tokens=2), tenant="gen")


def test_cancel_releases_quota(models):
    mt = _mt(models)
    mt.tenants["cls"].token_budget = 10
    h = mt.submit_encode(EncodeRequest(tokens=_enc_tokens(8)), tenant="cls")
    assert mt.cancel(h.rid)
    assert h.finish_reason == "cancelled"
    assert mt.tenants["cls"].outstanding_tokens == 0
    assert not mt.cancel(12345)               # unknown rid anywhere


def test_shared_rid_space_and_pop_done_order(models):
    mt = _mt(models)
    handles = [mt.submit_encode(EncodeRequest(tokens=_enc_tokens(6, seed=1)), tenant="cls"),
               mt.submit(GenerationRequest(prompt=_gen_prompt(4), max_new_tokens=2),
                         tenant="gen"),
               mt.submit_encode(EncodeRequest(tokens=_enc_tokens(7, seed=2)), tenant="cls")]
    rids = [h.rid for h in handles]
    assert rids == sorted(set(rids))          # globally unique, increasing
    mt.run_until_drained()
    done = mt.pop_done()
    assert [r.rid for r in done] == sorted(r.rid for r in done)
    assert len(done) == 3
    assert mt.pop_done() == []                # drained


def test_registry_validation(models):
    enc = models["port"][0]
    mt = MultiTenantEngine(clock=VirtualClock())
    t = mt.add_tenant("a", enc)
    assert isinstance(t, TenantState) and t.engine.tenant == "a"
    with pytest.raises(ValueError, match="already registered"):
        mt.add_tenant("a", enc)
    with pytest.raises(ValueError, match="weight"):
        mt.add_tenant("b", enc, weight=0)
    with pytest.raises(KeyError, match="unknown tenant"):
        mt.submit_encode(EncodeRequest(tokens=_enc_tokens(4)), tenant="nope")
    with pytest.raises(ValueError, match="quantum"):
        MultiTenantEngine(clock=VirtualClock(), quantum_tokens=0)


def test_weights_scale_the_share(models):
    """A weight-3 tenant spends three quanta a turn: with both tenants
    backlogged it takes more steps in a row than a weight-1 one."""
    mt = MultiTenantEngine(clock=VirtualClock(), quantum_tokens=8)
    enc, dec = models["port"]
    mt.add_tenant("cls", enc, slots=2, max_len=64, weight=3)
    mt.add_tenant("gen", dec, slots=2, max_len=64)
    for i in range(12):
        mt.submit_encode(EncodeRequest(tokens=_enc_tokens(8, seed=i)), tenant="cls")
    for i in range(4):
        mt.submit(GenerationRequest(prompt=_gen_prompt(4, seed=i), max_new_tokens=4),
                  tenant="gen")
    served = []
    for name, t in mt.tenants.items():
        real = t.engine.engine_step
        t.engine.engine_step = (lambda n=name, f=real: (served.append(n), f())[1])
    mt.run_until_drained()
    runs, prev = {"cls": 0, "gen": 0}, None
    cur = 0
    for name in served:
        cur = cur + 1 if name == prev else 1
        prev = name
        runs[name] = max(runs[name], cur)
    assert runs["cls"] >= 2 and served[0] == "cls"
