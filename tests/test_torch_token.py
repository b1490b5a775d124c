"""Port parity: token-mode prefill (the JAX package's seed semantics:
prompts fed one token per batched step through ONE shared cursor over an
fp decode state) on a reduced stablelm-3b, and the plan's token-mode rules.

* The plan resolves ``prefill_mode`` and refuses the token-mode
  combinations as JAX's ``test_plan_auto_resolution`` and
  ``test_plan_validation_fails_at_build`` have JAX's do, case for case,
  on the dense decoder, the hybrid, the encoder-decoder and xLSTM.
* ``submit`` refuses empty and oversized requests, token-mode engines
  refuse prefill-only requests.
* Greedy streams of a deployed W8A8 + W4A4 model on both backends equal
  JAX's token-mode ``ServingEngine`` on the same requests: six requests
  over two slots (freed slots refilled with their state carried over, as
  JAX does), and a tight ``max_len`` whose cursor runs out, so the idle
  engine resets its state to cursor 0 (counted) and goes on.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.core.policy import QuantPolicy as JPolicy
from repro.deploy import ExecutionPlan as JPlan
from repro.deploy import deploy as jdeploy
from repro.serving import GenerationRequest as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config, reduced
from repro_torch.core.policy import QuantPolicy
from repro_torch.deploy import ExecutionPlan, deploy
from repro_torch.serving import EncodeRequest, GenerationRequest, ServingEngine

N = lambda tree: jax.tree.map(np.asarray, tree)
POLICY = dict(num_layers=4, mode="int", last_k_int4=2)
CALIB = [{"tokens": np.random.default_rng(0).integers(1, 256, (2, 16)).astype(np.int32)}
         for _ in range(2)]
PROMPTS = [np.random.default_rng(1).integers(1, 256, n).astype(np.int32)
           for n in (3, 7, 5, 2, 9, 4)]
NEW = [4, 3, 6, 5, 2, 7]


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return e


PLAN_CASES = [
    ("dense-auto", "stablelm-3b", dict()),
    ("dense-token", "stablelm-3b", dict(prefill_mode="token")),
    ("dense-token-kv4", "stablelm-3b", dict(prefill_mode="token", kv_bits=4)),
    ("dense-token-kv8", "stablelm-3b", dict(prefill_mode="token", kv_bits=8)),
    ("dense-token-paged", "stablelm-3b", dict(prefill_mode="token", kv_paging="paged")),
    ("dense-token-prefix", "stablelm-3b", dict(prefill_mode="token", prefix_cache=1024)),
    ("dense-bad-mode", "stablelm-3b", dict(prefill_mode="eager")),
    ("hybrid-auto", "zamba2-2.7b", dict()),
    ("hybrid-chunked", "zamba2-2.7b", dict(prefill_mode="chunked")),
    ("hybrid-kv8", "zamba2-2.7b", dict(kv_bits=8)),
    ("xlstm-auto", "xlstm-1.3b", dict()),
    ("xlstm-chunked", "xlstm-1.3b", dict(prefill_mode="chunked")),
    ("xlstm-kv8", "xlstm-1.3b", dict(kv_bits=8)),
    ("xlstm-token-paged", "xlstm-1.3b", dict(prefill_mode="token", kv_paging="paged")),
    ("encdec-auto", "seamless-m4t-medium", dict()),
    ("encdec-token-kv4", "seamless-m4t-medium", dict(prefill_mode="token", kv_bits=4)),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_plan_resolves_and_refuses_token_mode_as_jax_does(case):
    _, arch, kw = case
    got = _outcome(lambda: ExecutionPlan.build(reduced(get_config(arch)), None, **kw))
    want = _outcome(lambda: JPlan.build(jreduced(jget(arch)), None, **kw))
    assert isinstance(got, ValueError) == isinstance(want, ValueError), (got, want)
    if isinstance(want, ValueError):
        # the same rule: the message's first clause, in both packages
        assert str(got).split(";")[0] == str(want).split(";")[0], (got, want)
    else:
        assert (got.prefill_mode, got.kv_bits, got.kv_paging) == \
            (want.prefill_mode, want.kv_bits, want.kv_paging)


@pytest.fixture(scope="module")
def models():
    """JAX's calibrated deployment and the port's, of the same fp arrays."""
    from repro.models import api as japi
    jcfg, cfg = jreduced(jget("stablelm-3b")), reduced(get_config("stablelm-3b"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp = japi.init_model(jcfg, jax.random.PRNGKey(0))
    jm = jdeploy(jp, JPlan.build(jcfg, JPolicy(**POLICY), prefill_mode="token"), CALIB)
    ports = {b: deploy(N(jp), ExecutionPlan.build(cfg, QuantPolicy(**POLICY), backend=b,
                                                   prefill_mode="token"),
                       CALIB, device="cpu") for b in ("reference", "cuda")}
    return jm, ports


def test_submit_refuses_what_token_mode_cannot_serve(models):
    _, ports = models
    eng = ServingEngine(ports["cuda"], slots=2, max_len=16)
    assert eng.token_mode and eng.kv is None and int(eng.state["len"]) == 0
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(GenerationRequest(prompt=np.zeros(0, np.int32), max_new_tokens=2))
    with pytest.raises(ValueError, match="exceeds engine max_len"):
        eng.submit(GenerationRequest(prompt=np.ones(10, np.int32), max_new_tokens=7))
    with pytest.raises(ValueError, match="token-mode engines.*prefill-only"):
        eng.submit_encode(EncodeRequest(tokens=np.ones(4, np.int32), task="score"))
    assert not eng.scheduler.has_work


def _run(engine_cls, request_cls, model, max_len):
    eng = engine_cls(model, slots=2, max_len=max_len)
    resets = []                # the cursor each state reset started over from
    streams = [eng.submit(request_cls(prompt=p.copy(), max_new_tokens=m))
               for p, m in zip(PROMPTS, NEW)]
    while eng.scheduler.has_work:
        before, state = eng._cursor, eng.state
        eng.engine_step()
        if eng._cursor <= before:
            assert eng._cursor == 1 and eng.state is not state
            resets.append(before)
    return [[int(t) for t in s.result().tokens] for s in streams], resets


@pytest.mark.parametrize("max_len", [64, 16], ids=["refill", "cursor-reset"])
def test_token_mode_streams_equal_jax(models, max_len):
    jm, ports = models
    want, _ = _run(JEngine, JRequest, jm, max_len)
    assert [len(s) for s in want] == NEW
    for backend, model in ports.items():
        got, resets = _run(ServingEngine, GenerationRequest, model, max_len)
        assert got == want, backend
        # max_len 16 exhausts the shared cursor: the idle engine restarts
        # from a fresh state, as JAX's does; 64 fits every request
        assert (len(resets) > 0) == (max_len == 16), resets
    _, jresets = _run(JEngine, JRequest, jm, max_len)
    assert jresets == resets
