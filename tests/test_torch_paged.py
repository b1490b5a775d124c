"""Port parity: paged KV serving (the block pool, the paged decode attention
and the engine's paged path) against the JAX package, and the JAX
package's paged invariants held inside the port.

A reduced stablelm-3b (4 layers, d 64, 4 heads of 16, vocab 256) under the
JAX serve CLI's policy shape (layers 0-1 W8A8, 2-3 W4A4) is deployed by the
JAX package from numpy weights; the artifact JAX saves, with its paged /
prefix plan, is loaded by the port. Tolerances:

* ``decode_attention_paged_plain`` vs JAX ``decode_attention_paged`` in
  interpret mode: atol 1e-5, rtol 0 (the dense kernel's bar: the Pallas
  kernel sums an online softmax, the plain version one pass); vs the
  port's dense plain version on the gathered layout: bit-equal; pool rows
  no table reaches below its slot's length, poisoned: bit-unchanged;
* ``BlockPool`` / ``PagedKVCache`` bookkeeping: equal to JAX's after every
  call (tables, refcounts, free-list order, registry order, ``stats()``),
  and the blocks they write: codes bit-equal, scales within one f32 ulp
  (JAX quantizes inside a jit, where XLA multiplies by 1 / qmax);
* greedy engine streams (the port's paged and dense-prefix engines on its
  ``"cuda"`` plan, whose kernels take their plain versions on the CPU,
  against JAX's engine on its Pallas backend in interpret mode; on its
  ``"reference"`` plan against JAX's reference backend): equal token for
  token; the paged engine's pool bookkeeping: equal to JAX's paged
  engine's;
* inside the port: paged == dense, prefix hit == cold, fork layouts, the
  budget and eviction: byte-identical streams.
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
from repro.kernels import kv_pack as jkv
from repro.kernels.decode_attention import decode_attention_paged as jpaged
from repro.kernels.decode_attention import gather_kv_blocks as jgather
from repro.serving import GenerationRequest as JGenerationRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving.block_pool import BlockPool as JBlockPool
from repro.serving.block_pool import PagedKVCache as JPagedKVCache
from repro_torch.configs import get_config, reduced
from repro_torch.core.policy import QuantPolicy
from repro_torch.deploy import DeployedModel, ExecutionPlan
from repro_torch.deploy.plan import plan_from_meta, plan_to_meta
from repro_torch.kernels import build, ops
from repro_torch.kernels.decode_attention import (decode_attention_paged_plain,
                                                  decode_attention_plain,
                                                  gather_kv_blocks)
from repro_torch.models import api, transformer
from repro_torch.serving.prefix_cache import HASH_SEED, rolling_hash
from repro_torch.serving import (PREFIX_BLOCK, BlockPool, GenerationRequest,
                                 PagedKVCache, SamplingParams, ServingEngine,
                                 blocks_needed)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small, and
    at one thread a test worker does not contend with the suite's others
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

POLICY = dict(num_layers=4, mode="int", last_k_int4=2)
CALIB = [{"tokens": np.random.default_rng(0).integers(1, 256, (4, 16)).astype(np.int32)}
         for _ in range(2)]


def fp_params(cfg, seed=0):
    """fp params as numpy arrays: the port's init tree (the JAX package's
    keys and shapes), every random leaf redrawn from numpy."""
    rng = np.random.default_rng(seed)
    tree = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    const = lambda a: bool(torch.all(a == 0) or torch.all(a == 1))
    return jax.tree.map(
        lambda a: a.numpy() if const(a)
        else rng.normal(0, 0.02, tuple(a.shape)).astype(np.float32), tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------------ the kernel
def _paged_inputs(bits, H, Hkv, dh, seed=0):
    """A pool of NB = 10 blocks of 8 rows (codes by JAX's quantize_kv),
    tables (B = 4, nb = 4) with a permutation, a block shared by two
    slots, the sentinel NB and entries past it (and below 0); lengths 0,
    1, partial and full."""
    rng = np.random.default_rng(seed + bits + H)
    NB, blk, B, nb = 10, 8, 4, 4
    kq, ks = jkv.quantize_kv(jnp.asarray(rng.normal(size=(NB, blk, Hkv, dh)),
                                         jnp.float32), bits)
    vq, vs = jkv.quantize_kv(jnp.asarray(rng.normal(size=(NB, blk, Hkv, dh)),
                                         jnp.float32), bits)
    tables = np.array([[7, 2, 9, NB],
                       [3, 3, NB + 5, NB],
                       [0, 5, 1, 8],
                       [4, 6, -3, NB]], np.int32)
    lengths = np.array([27, 1, 32, 0], np.int32)
    q = rng.normal(size=(B, H, dh)).astype(np.float32)
    kn = rng.normal(size=(B, Hkv, dh)).astype(np.float32)
    vn = rng.normal(size=(B, Hkv, dh)).astype(np.float32)
    return [np.asarray(a) for a in (q, kq, vq, ks, vs)] + [tables, kn, vn, lengths]


HEADS = [(4, 4, 16), (8, 2, 16)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("H,Hkv,dh", HEADS)
def test_paged_plain_matches_jax_paged_kernel(bits, H, Hkv, dh):
    args = _paged_inputs(bits, H, Hkv, dh)
    want = jpaged(*map(jnp.asarray, args), bs=8, interpret=True)
    got = decode_attention_paged_plain(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("H,Hkv,dh", HEADS)
def test_paged_plain_is_dense_plain_on_the_gathered_layout(bits, H, Hkv, dh):
    q, kq, vq, ks, vs, tables, kn, vn, lens = map(_t, _paged_inputs(bits, H, Hkv, dh))
    for buf in (kq, ks):                  # the gather is JAX's, clamp included
        np.testing.assert_array_equal(
            gather_kv_blocks(buf, tables).numpy(),
            np.asarray(jgather(jnp.asarray(buf.numpy()), jnp.asarray(tables.numpy()))))
    dense = decode_attention_plain(q, *(gather_kv_blocks(b, tables)
                                        for b in (kq, vq, ks, vs)), kn, vn, lens)
    assert torch.equal(decode_attention_paged_plain(q, kq, vq, ks, vs, tables,
                                                    kn, vn, lens), dense)


@pytest.mark.parametrize("bits", [8, 4])
def test_paged_rows_no_table_reaches_are_inert(bits):
    q, kq, vq, ks, vs, tables, kn, vn, lens = map(_t, _paged_inputs(bits, 8, 2, 16))
    want = decode_attention_paged_plain(q, kq, vq, ks, vs, tables, kn, vn, lens)
    NB, blk = kq.shape[:2]
    live = torch.zeros((NB, blk), dtype=torch.bool)
    for b in range(tables.shape[0]):
        for pos in range(int(lens[b])):
            live[int(tables[b, pos // blk].clamp(0, NB - 1)), pos % blk] = True
    for codes in (kq, vq):
        codes[~live] = 0x5A if bits == 8 else 0xF3
    for scales in (ks, vs):
        scales[~live] = 3.0e4
    got = decode_attention_paged_plain(q, kq, vq, ks, vs, tables, kn, vn, lens)
    assert torch.equal(got, want)


def test_ops_send_cpu_tensors_to_the_plain_version():
    q, kq, vq, ks, vs, tables, kn, vn, lens = map(_t, _paged_inputs(8, 4, 4, 16))
    build.reset_counts()
    out = ops.decode_attention_paged(q, kq, vq, ks, vs, tables.long(), kn, vn,
                                     lens.long())
    assert torch.equal(out, decode_attention_paged_plain(q, kq, vq, ks, vs, tables,
                                                         kn, vn, lens))
    assert not any(build.LAUNCHES.values()) and not any(build.PLAIN_ON_CUDA.values())


# -------------------------------------------------------- the block pool
def _pool_state(pool):
    return {"free": list(pool._free), "refs": [int(r) for r in pool.refs],
            "tables": {r: list(t) for r, t in pool._tables.items()},
            "shared": sorted(pool.shared),
            "registry": [(d, int(b)) for d, b in pool._registry.items()],
            "stats": pool.stats()}


def test_block_pool_bookkeeping_matches_jax_call_for_call():
    cfg, jcfg = reduced(get_config("stablelm-3b")), jreduced(jget_config("stablelm-3b"))
    probe = JBlockPool(jcfg, 1 << 20, kv_bits=4)
    budget = 6 * probe.block_nbytes + 100
    pools = (JBlockPool(jcfg, budget, kv_bits=4),
             BlockPool(cfg, budget, kv_bits=4, device="cpu"))
    assert pools[1].num_blocks == pools[0].num_blocks == 6
    for key, buf in pools[1].bufs.items():   # one trash block past the budget
        assert tuple(buf.shape) == (4, 7, *pools[0].bufs[key].shape[2:])
    rng = np.random.default_rng(3)
    a = rng.integers(1, 256, 3 * PREFIX_BLOCK + 2).tolist()
    b = a[:2 * PREFIX_BLOCK] + rng.integers(1, 256, 5).tolist()
    c = rng.integers(1, 256, 2 * PREFIX_BLOCK + 1).tolist()

    def both(fn):
        outs = [fn(p) for p in pools]
        assert outs[0] == outs[1]
        assert _pool_state(pools[0]) == _pool_state(pools[1])
        return outs[0]

    both(lambda p: p.alloc(1, 4))
    both(lambda p: p.publish(1, a, 3 * PREFIX_BLOCK))
    m, ids = both(lambda p: p.match(b))
    assert m == 2 * PREFIX_BLOCK
    both(lambda p: p.attach(2, ids))
    both(lambda p: p.alloc(2, 1))
    both(lambda p: p.available())
    both(lambda p: p.release(1))
    both(lambda p: p.release(2))
    both(lambda p: p.match(a))              # a full hit, capped at len - 1
    both(lambda p: p.alloc(3, 5))           # evicts LRU residents
    assert pools[1].evictions >= 1
    both(lambda p: p.publish(3, c, 2 * PREFIX_BLOCK))
    both(lambda p: p.release(3))
    # the hash-collision guard: a registered digest whose stored tokens
    # differ from the prompt's block stops both the match and the publish
    d = rolling_hash(HASH_SEED, np.asarray(c[:PREFIX_BLOCK], np.int32))
    for p in pools:
        assert d in p._registry
        p._tokens[d] = p._tokens[d] + 1
    assert both(lambda p: p.match(c)) == (0, [])
    both(lambda p: p.alloc(4, 2))
    both(lambda p: p.publish(4, c, 2 * PREFIX_BLOCK))
    both(lambda p: p.release(4))
    both(lambda p: p.release(4))            # idempotent


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_paged_kv_cache_writes_match_jax(bits):
    cfg, jcfg = reduced(get_config("stablelm-3b")), jreduced(jget_config("stablelm-3b"))
    budget = 8 * JBlockPool(jcfg, 1 << 20, kv_bits=bits).block_nbytes
    jkvc = JPagedKVCache(JBlockPool(jcfg, budget, kv_bits=bits), 2, 32)
    kvc = PagedKVCache(BlockPool(cfg, budget, kv_bits=bits, device="cpu"), 2, 32)
    rng = np.random.default_rng(bits)
    fp = {k: rng.normal(size=(4, 2, 16, 4, 16)).astype(np.float32) for k in "kv"}
    if bits == 16:
        scratch = fp
    else:
        scratch = {}
        for k in "kv":
            scratch[f"{k}_q"], scratch[f"{k}_scale"] = map(
                np.asarray, jkv.quantize_kv(jnp.asarray(fp[k]), bits))
    for c in (jkvc, kvc):
        torch_side = c is kvc
        conv = _t if torch_side else jnp.asarray
        c.open_slot(0, rid=5)
        ids = c.pool.alloc(5, 3)
        c.extend_table(0, ids)
        c.write_fp_blocks(ids[:2], {k: conv(v) for k, v in fp.items()}, 1, 0, 2)
        c.write_state_blocks(ids[2:], {k: conv(v) for k, v in scratch.items()},
                             0, 8, 1)
        c.set_length(0, 21)
    np.testing.assert_array_equal(kvc._tables, jkvc._tables)
    np.testing.assert_array_equal(kvc.lengths(), jkvc.lengths())
    assert kvc.block_ids(0) == jkvc.block_ids(0)
    nb = kvc.pool.num_blocks
    for key in kvc.pool.keys:
        got = (kvc.pool.bufs[key][:, :nb].numpy(),
               kvc.pool.gather_rows([2, 0])[key].numpy())
        want = (np.asarray(jkvc.pool.bufs[key]),
                np.asarray(jkvc.pool.gather_rows([2, 0])[key]))
        for g, w in zip(got, want):
            if key.endswith("scale"):
                # JAX quantizes inside a jit, where XLA turns amax / qmax
                # into a multiply by the reciprocal: one f32 ulp apart
                np.testing.assert_allclose(g, w, rtol=1.2e-7, atol=0)
            else:
                np.testing.assert_array_equal(g, w)
    for c in (jkvc, kvc):
        c.release_slot(0)
    np.testing.assert_array_equal(kvc._tables, jkvc._tables)
    assert kvc.pool.stats() == jkvc.pool.stats()


def _collision_cache(bits):
    """Slot 0 active, its cursor inside its tail block, which is the pool's
    LAST block (NB - 1); slot 1 idle on the sentinel, which clamps to that
    same block in the JAX package's gather."""
    cfg = reduced(get_config("stablelm-3b"))
    probe = BlockPool(cfg, 1 << 20, kv_bits=bits, device="cpu")
    kvc = PagedKVCache(BlockPool(cfg, 3 * probe.block_nbytes, kv_bits=bits,
                                 device="cpu"), slots=2, max_len=24)
    g = torch.Generator().manual_seed(bits)
    for buf in kvc.pool.bufs.values():
        buf.copy_((torch.rand(buf.shape, generator=g) * 100).to(buf.dtype))
    kvc.open_slot(0, rid=1)
    kvc.extend_table(0, kvc.pool.alloc(1, 3))
    assert kvc.block_ids(0)[-1] == kvc.pool.num_blocks - 1
    kvc.set_length(0, 19)
    return cfg, kvc


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_decode_write_lands_only_at_the_slots_own_target(bits):
    cfg, kvc = _collision_cache(bits)
    before = {k: v.clone() for k, v in kvc.pool.bufs.items()}
    state = kvc.decode_state(active=[0])
    assert state["write_block"].tolist() == [kvc.pool.num_blocks - 1,
                                             kvc.pool.trash_block]
    assert state["write_off"].tolist() == [3, 0]
    new = torch.randn((2, 1, cfg.num_kv_heads, cfg.hd), generator=torch.Generator().manual_seed(9))
    for layer in range(cfg.num_layers):
        transformer.write_new_kv(state, layer, (new, -new))
    kvc.advance([0])
    assert kvc.lengths().tolist() == [20, 0]
    nb = kvc.pool.num_blocks
    for key, buf in kvc.pool.bufs.items():
        changed = (buf != before[key]).reshape(*buf.shape[:3], -1).any(-1)
        live = changed[:, :nb]
        # the active slot's row (block NB-1, offset 3) and nothing else live
        assert live[:, nb - 1, 3].all() and int(live.sum()) == cfg.num_layers, key
    if bits != 16:
        from repro_torch.kernels.kv_pack import quantize_kv
        codes, _ = quantize_kv(new[:1], bits)
        assert torch.equal(kvc.pool.bufs["k_q"][:, nb - 1, 3], codes[0, 0].expand(
            cfg.num_layers, *codes.shape[2:]))


# ------------------------------------------------------------ the engine
def _cfgs():
    return reduced(get_config("stablelm-3b")), jreduced(jget_config("stablelm-3b"))


@pytest.fixture(scope="module")
def jparams():
    cfg, jcfg = _cfgs()
    jplan = JExecutionPlan.build(jcfg, JQuantPolicy(**POLICY))
    return jdeploy(jax.tree.map(jnp.asarray, fp_params(cfg)), jplan, CALIB).params


@pytest.fixture(scope="module")
def port_params(jparams, tmp_path_factory):
    """The port's params, loaded from an artifact the JAX package saved
    with a paged, prefix-caching plan; the plan must load unchanged."""
    _, jcfg = _cfgs()
    jplan = JExecutionPlan.build(jcfg, JQuantPolicy(**POLICY), backend="pallas",
                                 kv_bits=4, kv_paging="paged", prefix_cache=1 << 20,
                                 prefill_batch=2)
    path = str(tmp_path_factory.mktemp("paged_art") / "art")
    JDeployedModel(plan=jplan, params=jparams).save(path)
    model = DeployedModel.load(path, device="cpu")
    assert model.plan == ExecutionPlan.build(
        _cfgs()[0], QuantPolicy(**POLICY), backend="cuda", kv_bits=4,
        kv_paging="paged", prefix_cache=1 << 20, prefill_batch=2)
    assert plan_to_meta(model.plan)["build"] == jplan.build_kwargs()
    return model.params


def _engine(params, *, kv_bits, paging, prefix=0, backend="cuda", slots=2,
            max_len=64, prefill_batch=2, **kw):
    plan = ExecutionPlan.build(_cfgs()[0], QuantPolicy(**POLICY), backend=backend,
                               kv_bits=kv_bits, kv_paging=paging,
                               prefix_cache=prefix, prefill_batch=prefill_batch)
    return ServingEngine(DeployedModel(plan=plan, params=params), slots=slots,
                         max_len=max_len, **kw)


def _prompts(seed=7):
    """Three prompts and one that shares the first's leading block. No
    near-tie (top-two logit gap below 1e-4) occurs on them, so the two
    packages' streams are compared as they are."""
    rng = np.random.default_rng(seed)
    ps = [rng.integers(1, 256, n).astype(np.int32) for n in (11, 5, 23)]
    return ps + [np.concatenate([ps[0][:PREFIX_BLOCK],
                                 rng.integers(1, 256, 4).astype(np.int32)])]


def _serve(eng, prompts, max_new=5, sampling=None, rounds=1, cls=GenerationRequest):
    out = []
    for _ in range(rounds):
        streams = [eng.submit(cls(prompt=p.copy(), max_new_tokens=max_new,
                                  sampling=sampling)) for p in prompts]
        eng.run_until_drained()
        out += [[int(t) for t in s.result().tokens] for s in streams]
    return out


_JAX_STREAMS: dict = {}


def _jax_streams(jparams, kv_bits, prefix, backend):
    """Greedy streams of the JAX package's DENSE engine (on its Pallas
    backend, interpret mode, for the port's ``"cuda"`` plan; on its
    reference backend for the port's ``"reference"`` plan); with the prefix
    cache, two rounds, so the second round hits (and the shared-prefix
    prompt may hit in the first). JAX's paged engine is designed to give
    these same streams (its paged == dense invariant), but on the CPU its
    decode step reads host arrays that ``jnp.asarray`` may alias and the
    donated step may overwrite, so its streams depend on what ran before
    in the process; its dense engine's do not."""
    key = (kv_bits, prefix, backend)
    if key not in _JAX_STREAMS:
        _, jcfg = _cfgs()
        jplan = JExecutionPlan.build(jcfg, JQuantPolicy(**POLICY),
                                     backend={"cuda": "pallas"}.get(backend, backend),
                                     kv_bits=kv_bits, prefix_cache=prefix,
                                     prefill_batch=2)
        jeng = JServingEngine(jparams, jplan, slots=2, max_len=64)
        _JAX_STREAMS[key] = (_serve(jeng, _prompts(), rounds=2 if prefix else 1,
                                    cls=JGenerationRequest), jeng)
    return _JAX_STREAMS[key]


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("backend,prefix", [("cuda", 0), ("cuda", 1 << 20),
                                            ("reference", 1 << 20)])
def test_paged_engine_greedy_streams_match_jax(jparams, port_params, kv_bits, prefix,
                                               backend):
    want, jeng = _jax_streams(jparams, kv_bits, prefix, backend)
    eng = _engine(port_params, kv_bits=kv_bits, paging="paged", prefix=prefix,
                  backend=backend)
    assert _serve(eng, _prompts(), rounds=2 if prefix else 1) == want
    if prefix:
        st, jst = eng.pool.stats(), jeng.prefix_cache.stats()
        assert (st["hits"], st["misses"], st["tokens_reused"]) == (
            jst["hits"], jst["misses"], jst["tokens_reused"]) and st["hits"] >= 4


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_dense_prefix_engine_greedy_streams_match_jax(jparams, port_params, kv_bits):
    want, jeng = _jax_streams(jparams, kv_bits, 1 << 20, "cuda")
    eng = _engine(port_params, kv_bits=kv_bits, paging="dense", prefix=1 << 20)
    assert _serve(eng, _prompts(), rounds=2) == want
    assert eng.prefix_cache.stats() == jeng.prefix_cache.stats()


def test_paged_engine_bookkeeping_matches_jax_paged_engine(jparams, port_params):
    """The pool's gauges after the same traffic (admission, allocation,
    publication and hits are host bookkeeping, independent of the tokens)."""
    _, jcfg = _cfgs()
    jplan = JExecutionPlan.build(jcfg, JQuantPolicy(**POLICY), kv_bits=8,
                                 kv_paging="paged", prefix_cache=1 << 20,
                                 prefill_batch=2)
    jeng = JServingEngine(jparams, jplan, slots=2, max_len=64)
    _serve(jeng, _prompts(), rounds=2, cls=JGenerationRequest)
    eng = _engine(port_params, kv_bits=8, paging="paged", prefix=1 << 20)
    _serve(eng, _prompts(), rounds=2)
    assert eng.pool.stats() == jeng.pool.stats()
    assert eng.pool.refs.tolist() == jeng.pool.refs.tolist()
    assert eng.pool._free == jeng.pool._free
    assert list(eng.pool._registry.items()) == list(jeng.pool._registry.items())


SAMPLED = SamplingParams(temperature=0.8, seed=3)


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
@pytest.mark.parametrize("prefix", [0, 1 << 20])
def test_paged_streams_equal_dense_streams(port_params, kv_bits, prefix):
    dense = _serve(_engine(port_params, kv_bits=kv_bits, paging="dense",
                           prefix=prefix), _prompts(), sampling=SAMPLED, rounds=2)
    eng = _engine(port_params, kv_bits=kv_bits, paging="paged", prefix=prefix)
    assert _serve(eng, _prompts(), sampling=SAMPLED, rounds=2) == dense
    st = eng.pool.stats()
    assert st["blocks_in_use"] == st["prefix_blocks"]   # only residents left
    assert (eng.pool.refs == 0).all()                   # refcounts drained
    if prefix:
        assert dense[:4] == dense[4:]                   # prefix hit == cold
        assert st["hits"] >= 4 and st["prefix_attached"] >= 1


def test_fork_n_samples_deterministic_and_layout_invariant(port_params):
    prompt = np.random.default_rng(5).integers(1, 256, 19).astype(np.int32)
    sp = SamplingParams(temperature=2.0, seed=5, n=2)

    def run(paging):
        eng = _engine(port_params, kv_bits=4, paging=paging, prefill_batch=4, slots=4)
        fan = eng.submit(GenerationRequest(prompt=prompt, max_new_tokens=6, sampling=sp))
        solo = eng.submit(GenerationRequest(prompt=prompt, max_new_tokens=6,
                                            sampling=dataclasses.replace(sp, n=1)))
        eng.engine_step()             # admit + prefill + the first decode step
        shared = None
        if paging == "paged":
            shared = sorted(eng.pool.shared)
            snap = {k: v[:, shared].clone() for k, v in eng.pool.bufs.items()}
        eng.run_until_drained()
        if paging == "paged":         # copy-on-write: shared blocks never written
            for k, v in eng.pool.bufs.items():
                assert torch.equal(v[:, shared], snap[k]), k
        return ([list(s.result().tokens) for s in fan], list(solo.result().tokens),
                eng.pool.stats() if eng.pool else None, shared)

    p_fan, p_solo, st, shared = run("paged")
    d_fan, d_solo, _, _ = run("dense")
    assert p_fan == d_fan and p_fan[0] == p_solo == d_solo
    assert p_fan[0] != p_fan[1]
    assert st["cow_forks"] >= 1 and len(shared) == 19 // PREFIX_BLOCK
    assert st["blocks_free"] == st["blocks_total"]


def test_one_budget_gates_admission_and_rejects_oversize(port_params):
    probe = _engine(port_params, kv_bits=4, paging="paged", slots=4)
    eng = _engine(port_params, kv_bits=4, paging="paged", slots=4,
                  kv_budget_bytes=3 * probe.pool.block_nbytes)
    assert eng.pool.num_blocks == 3
    with pytest.raises(ValueError, match="blocks"):
        eng.submit(GenerationRequest(prompt=np.arange(1, 30), max_new_tokens=10))
    rng = np.random.default_rng(1)
    streams = [eng.submit(GenerationRequest(prompt=rng.integers(1, 256, 6),
                                            max_new_tokens=4)) for _ in range(5)]
    peak = 0
    while eng.scheduler.has_work:
        eng.engine_step()
        peak = max(peak, sum(r is not None for r in eng.active))
    assert blocks_needed(6, 4) == 2 and peak == 1      # byte-gated, not slot-gated
    assert all(len(s.result().tokens) == 4 for s in streams)
    assert eng.metrics.summary()["kv"]["blocks_total"] == 3
    assert "kv:" in eng.metrics.report()


def test_eviction_under_reuse_keeps_streams_identical(port_params):
    rng = np.random.default_rng(9)
    pa, pb = (rng.integers(1, 256, 2 * PREFIX_BLOCK + 1).astype(np.int32)
              for _ in range(2))

    def run(paging, **kw):
        eng = _engine(port_params, kv_bits=4, paging=paging, prefix=1 << 20, **kw)
        out = []
        for p in (pa, pb, pa):       # pb's blocks push pa's out of the pool
            out += _serve(eng, [p], max_new=3)
        return out, eng

    probe = _engine(port_params, kv_bits=4, paging="paged")
    paged, eng = run("paged", kv_budget_bytes=4 * probe.pool.block_nbytes)
    dense, _ = run("dense")
    assert paged == dense
    assert eng.pool.stats()["evictions"] >= 1
    assert (eng.pool.refs == 0).all()


def test_cancel_releases_the_slots_blocks(port_params):
    eng = _engine(port_params, kv_bits=8, paging="paged")
    a = eng.submit(GenerationRequest(prompt=_prompts()[2], max_new_tokens=10))
    eng.engine_step()
    assert eng.pool.stats()["blocks_in_use"] == blocks_needed(23, 10)
    assert eng.cancel(a.rid)
    assert eng.pool.stats()["blocks_in_use"] == 0 and (eng.pool.refs == 0).all()
    assert eng.kv.lengths().tolist() == [0, 0]


# ---------------------------------------------------------------- the plan
def test_plan_kv_paging_and_prefix_round_trip_and_validation():
    cfg = _cfgs()[0]
    pol = QuantPolicy(**POLICY)
    plan = ExecutionPlan.build(cfg, pol, kv_bits=4, kv_paging="paged",
                               prefix_cache=1 << 20)
    meta = plan_to_meta(plan)
    assert meta["build"]["kv_paging"] == "paged"
    assert plan_from_meta(meta) == plan
    del meta["build"]["kv_paging"]           # artifacts older than paging
    assert plan_from_meta(meta).kv_paging == "dense"
    assert "kv_paging=paged" in plan.describe()
    assert "kv_paging" not in ExecutionPlan.build(cfg, pol).describe()
    with pytest.raises(ValueError, match="kv_paging"):
        ExecutionPlan.build(cfg, pol, kv_paging="virtual")
    with pytest.raises(ValueError, match="chunked"):
        ExecutionPlan.build(cfg, pol, prefill_mode="token", kv_paging="paged")
    with pytest.raises(ValueError, match="learned-pos"):
        ExecutionPlan.build(cfg.replace(learned_pos=True), pol, prefix_cache=1024)


def test_paged_engine_rejects_bad_geometry_and_budget(port_params):
    with pytest.raises(ValueError, match="max_len"):
        _engine(port_params, kv_bits=16, paging="paged", max_len=60)
    with pytest.raises(ValueError, match="kv_budget_bytes"):
        _engine(port_params, kv_bits=16, paging="dense", kv_budget_bytes=1 << 20)
    with pytest.raises(ValueError, match="block"):
        _engine(port_params, kv_bits=16, paging="paged", kv_budget_bytes=16)


def test_paged_decode_state_is_what_the_step_reads(port_params):
    """The paged cache dict of one step: pool buffers by reference, tables
    and cursors from the host, dtypes the kernel takes."""
    eng = _engine(port_params, kv_bits=8, paging="paged")
    eng.submit(GenerationRequest(prompt=_prompts()[0], max_new_tokens=4))
    eng.engine_step()
    st = eng.kv.decode_state(eng.scheduler.active_slots())
    assert st["k_q"] is eng.pool.bufs["k_q"]
    assert st["tables"].dtype == torch.int32 and st["len"].dtype == torch.int32
    assert st["len"].tolist() == [12, 0]
    assert st["tables"][1].tolist() == [eng.pool.trash_block] * 8
