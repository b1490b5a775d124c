"""Port parity: the shared-prefix KV cache (``serving/prefix_cache.py``, the
dense engine's prefix path and ``SlotKVCache.insert_rows``) against the JAX
package, and its invariants held inside the port.

* ``PrefixCache``: the port's copy and JAX's module run the same scripted
  calls; results, entry order, refcounts, bytes and ``stats()`` equal
  after every call, hash-collision guard included;
* ``insert_rows``: the slot rows bit-equal to JAX's;
* the dense prefix engine: prefix hit == cold and eviction under a small
  budget == cold, byte for byte, at kv_bits 16 (f32 and bf16 rows) / 8 / 4;
  every pin released once the requests finish or are cancelled.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import prefix_cache as jpc
from repro.serving.kv_cache import SlotKVCache as JSlotKVCache
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro_torch.configs import get_config, reduced
from repro_torch.core.policy import QuantPolicy
from repro_torch.deploy import DeployedModel, ExecutionPlan, deploy
from repro_torch.models import api
from repro_torch.serving import (GenerationRequest, SamplingParams, ServingEngine,
                                 SlotKVCache)
from repro_torch.serving import prefix_cache as pc

B = pc.PREFIX_BLOCK


def _state(cache):
    return [(k, e.tokens.tolist(), e.refs, e.nbytes) for k, e in cache._entries.items()]


def test_prefix_constants_and_hash_match_jax():
    assert (pc.PREFIX_BLOCK, pc.HASH_SEED) == (jpc.PREFIX_BLOCK, jpc.HASH_SEED)
    h = jh = pc.HASH_SEED
    for blk in np.arange(1, 33, dtype=np.int32).reshape(4, 8):
        h, jh = pc.rolling_hash(h, blk), jpc.rolling_hash(jh, blk)
        assert h == jh


def test_prefix_cache_matches_jax_call_for_call():
    rng = np.random.default_rng(2)
    rows = lambda lo, hi: {"k_q": np.full((2, hi - lo, 3, 4), lo, np.int8),
                           "k_scale": np.full((2, hi - lo, 3), lo, np.float32)}
    entry = sum(a.nbytes for a in rows(0, B).values()) + 4 * B
    caches = (jpc.PrefixCache(5 * entry), pc.PrefixCache(5 * entry))
    a = rng.integers(1, 256, 3 * B + 2).tolist()
    b = a[:2 * B] + rng.integers(1, 256, B + 1).tolist()
    c = rng.integers(1, 256, 4 * B + 1).tolist()

    def both(fn):
        outs = [fn(x) for x in caches]
        assert outs[0] == outs[1]
        assert _state(caches[0]) == _state(caches[1])
        assert caches[0].stats() == caches[1].stats()
        return outs[0]

    assert both(lambda x: x.match(a)) == (0, ())
    both(lambda x: x.insert(a, 3 * B, rows))
    m, keys_b = both(lambda x: x.match(b))
    assert m == 2 * B
    for key in ("k_q", "k_scale"):
        np.testing.assert_array_equal(caches[1].gather(keys_b)[key],
                                      caches[0].gather(keys_b)[key])
    both(lambda x: x.insert(b, 3 * B, rows))
    both(lambda x: x.insert(c, 4 * B, rows))     # over budget: b's pins hold
    both(lambda x: x.release(keys_b))            # deferred eviction runs
    assert caches[1].evictions >= 1
    # the hash-collision guard: a stored block whose tokens differ from the
    # prompt's is a miss, and an unpinned colliding entry is replaced
    both(lambda x: x.insert(c, B, rows))         # c's first block is resident
    d = pc.rolling_hash(pc.HASH_SEED, np.asarray(c[:B], np.int32))
    for x in caches:
        x._entries[d].tokens = x._entries[d].tokens + 1
    assert both(lambda x: x.match(c)) == (0, ())
    both(lambda x: x.insert(c, 2 * B, rows))
    both(lambda x: len(x))


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_insert_rows_matches_jax(bits):
    cfg, jcfg = reduced(get_config("stablelm-3b")), jreduced(jget_config("stablelm-3b"))
    slot = SlotKVCache(cfg, 2, 32, kv_bits=bits, device="cpu")
    jslot = JSlotKVCache(jcfg, 2, 32, kv_bits=bits)
    rng = np.random.default_rng(bits)
    src = {}
    for key, val in slot.state.items():
        if key == "len":
            continue
        shape = (val.shape[0], 2, 40, *val.shape[3:])     # a block-grid scratch
        src[key] = (rng.integers(0, 120, shape) if val.dtype != torch.float32
                    else rng.normal(size=shape)).astype(
                        str(val.dtype).replace("torch.", ""))
    slot.insert_rows(1, {k: torch.from_numpy(v) for k, v in src.items()}, 21, 32, row=1)
    jslot.insert_rows(1, {k: jnp.asarray(v) for k, v in src.items()}, 21, 32, row=1)
    for key, val in slot.state.items():
        np.testing.assert_array_equal(val.numpy(), np.asarray(jslot.state[key]))


# ---------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def params():
    cfg = reduced(get_config("stablelm-3b"))
    fp = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    calib = [{"tokens": np.random.default_rng(0).integers(1, 256, (4, 16))}]
    plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=4, mode="int", last_k_int4=2))
    return deploy(fp, plan, calib, device="cpu").params


def _engine(params, kv_bits, prefix, decode_dtype="float32", slots=2):
    cfg = reduced(get_config("stablelm-3b"))
    plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=4, mode="int", last_k_int4=2),
                               backend="cuda", kv_bits=kv_bits, prefix_cache=prefix,
                               prefill_batch=2, decode_dtype=decode_dtype)
    return ServingEngine(DeployedModel(plan=plan, params=params), slots=slots, max_len=64)


def _run(eng, prompts, max_new=4):
    sp = SamplingParams(temperature=1.5, seed=9)
    streams = [eng.submit(GenerationRequest(prompt=p.copy(), max_new_tokens=max_new,
                                            sampling=sp)) for p in prompts]
    eng.run_until_drained()
    return [list(s.result().tokens) for s in streams]


def _prompts():
    rng = np.random.default_rng(4)
    base = rng.integers(1, 256, 2 * B)
    return [np.concatenate([base, rng.integers(1, 256, n)]) for n in (3, 9)] + \
        [rng.integers(1, 256, 13)]


@pytest.mark.parametrize("kv_bits,dtype", [(16, "float32"), (16, "bfloat16"),
                                           (8, "float32"), (4, "float32")])
def test_prefix_hit_equals_cold(params, kv_bits, dtype):
    cold = [_run(_engine(params, kv_bits, 1 << 20, dtype), [p])[0] for p in _prompts()]
    eng = _engine(params, kv_bits, 1 << 20, dtype)
    assert _run(eng, _prompts()) == cold
    assert _run(eng, _prompts()) == cold        # every prompt hits now
    st = eng.prefix_cache.stats()
    assert st["hits"] >= 3 and st["tokens_reused"] >= 5 * B
    assert not eng._prefix_refs
    assert all(e.refs == 0 for e in eng.prefix_cache._entries.values())


def test_prefix_eviction_keeps_streams_identical(params):
    cold = _run(_engine(params, 4, 1 << 20), _prompts())
    tiny = _engine(params, 4, 1)                 # a budget below one block
    assert _run(tiny, _prompts()) == cold == _run(tiny, _prompts())
    assert tiny.prefix_cache.stats()["evictions"] >= 1
    assert len(tiny.prefix_cache) == 0


def test_cancel_releases_prefix_pins(params):
    eng = _engine(params, 8, 1 << 20, slots=1)
    _run(eng, _prompts()[:1])
    a = eng.submit(GenerationRequest(prompt=_prompts()[1], max_new_tokens=8))
    q = eng.submit(GenerationRequest(prompt=_prompts()[0], max_new_tokens=8))
    eng.engine_step()
    assert eng._prefix_refs and any(e.refs for e in eng.prefix_cache._entries.values())
    assert eng.cancel(a.rid) and eng.cancel(q.rid)
    assert not eng._prefix_refs
    assert all(e.refs == 0 for e in eng.prefix_cache._entries.values())
