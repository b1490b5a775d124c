"""Port parity: ``distributed/compression.compressed_grad_mean`` (``none``,
``bf16``, ``int8_ef``) against the JAX package's.

* World size 1 (a gloo group of one in this process): every method, with
  the error state carried over three steps, bit-equal to JAX's
  ``compressed_grad_mean`` under a one-device ``shard_map`` (as the JAX
  package's own tests run it), f32 and bf16 leaves; an unknown method
  raises as JAX's does.
* gloo ranks 2 and 4 (``launch.mesh.spawn_tp``): every rank's mean and
  every rank's error state after three ``int8_ef`` steps bit-equal to a
  numpy statement of JAX's formula (one scale shared through the ranks'
  max, int8 codes, an int32 sum). A floating-point sum over more than two
  ranks depends on the order the all-reduce adds them in, which neither
  package fixes, so at 4 ranks ``none`` and ``bf16`` are held on the
  leaves whose partial sums are exact in any order (small multiples of
  1/16, and a leaf nonzero on rank 0 alone, which tests the bf16 cast's
  rounding); at 2 ranks, where a + b is the only sum, on every leaf.
* Error feedback: over 50 ``int8_ef`` steps the accumulated compressed
  mean tracks the accumulated exact one within 2 %.

The module imports no JAX at the top: the gloo ranks import it by name.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.distributed import compressed_grad_mean
from repro_torch.distributed.compression import METHODS
from repro_torch.launch.mesh import spawn_tp


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small, and
    at one thread a test worker does not contend with the suite's others
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

STEPS = 3
#: leaves whose cross-rank partial sums are exact in any order
ORDER_FREE = ("list/1", "only0")


def _grads(rank: int, step: int) -> dict:
    """Rank ``rank``'s gradients at ``step``: an f32 normal leaf, a bf16
    leaf, an exact-sum leaf (multiples of 1/16 in [-31/16, 31/16]) and a
    leaf that is nonzero on rank 0 only."""
    rng = np.random.default_rng(100 * rank + step)
    only0 = rng.standard_normal(7).astype(np.float32) * (rank == 0)
    return {"w": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)),
            "list": [torch.from_numpy(rng.standard_normal(5).astype(np.float32))
                     .to(torch.bfloat16),
                     torch.from_numpy((rng.integers(-31, 32, 6) / 16).astype(np.float32))],
            "only0": torch.from_numpy(only0)}


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree.detach().to(torch.float32).numpy()}


def _run(rank: int) -> dict:
    """Every method over ``STEPS`` steps on this rank's gradients: the
    means and error states, flattened to f32 numpy."""
    out = {}
    for method in METHODS:
        err, steps = None, []
        for step in range(STEPS):
            g = _grads(rank, step)
            before = _flat(g)
            mean, err = compressed_grad_mean(g, None, method, err)
            assert all(np.array_equal(v, _flat(g)[k]) for k, v in before.items())
            steps.append((_flat(mean), None if err is None else _flat(err)))
        out[method] = steps
    return out


def _rank_main() -> list:
    """Each rank's ``_run``, gathered on every rank (rank 0's is returned)."""
    mine = _run(dist.get_rank())
    allr = [None] * dist.get_world_size()
    dist.all_gather_object(allr, mine)
    return allr


# ------------------------------------------------ numpy statement of JAX's
def _bf16(a):
    import ml_dtypes
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _formula(n: int, method: str) -> list:
    """Per rank, per step: (mean, error) as JAX's formula gives them."""
    f32 = np.float32
    errs = [None] * n
    out = [[] for _ in range(n)]
    for step in range(STEPS):
        gs = [_flat(_grads(r, step)) for r in range(n)]
        means, new_errs = {}, [dict() for _ in range(n)]
        for k in gs[0]:
            dtype_bf16 = k == "list/0"
            if method == "none":
                acc = gs[0][k].astype(f32)
                for r in range(1, n):
                    acc = acc + gs[r][k]
                m = acc / f32(n)
                means[k] = _bf16(m).astype(f32) if dtype_bf16 else m
            elif method == "bf16":
                acc = _bf16(gs[0][k])
                for r in range(1, n):
                    acc = _bf16(acc.astype(f32) + _bf16(gs[r][k]).astype(f32))
                m = _bf16(acc.astype(f32) / f32(n)).astype(f32)
                means[k] = _bf16(m).astype(f32) if dtype_bf16 else m
            else:
                ts = [gs[r][k] + (0 if errs[r] is None else errs[r][k]) for r in range(n)]
                s = max(f32(np.abs(t).max()) for t in ts) / f32(127.0)
                s = np.maximum(s, f32(1e-12)).astype(f32)
                total = np.zeros(ts[0].shape, np.int32)
                for r, t in enumerate(ts):
                    q = np.clip(np.round(t / s), -127, 127).astype(np.int8)
                    new_errs[r][k] = (t - q.astype(f32) * s).astype(f32)
                    total = total + q.astype(np.int32)
                m = (total.astype(f32) * s / f32(n)).astype(f32)
                means[k] = _bf16(m).astype(f32) if dtype_bf16 else m
        for r in range(n):
            out[r].append((means, None if method != "int8_ef" else new_errs[r]))
        if method == "int8_ef":
            errs = new_errs
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["ranks2", "ranks4"])
def ranks(request):
    return request.param, spawn_tp(_rank_main, request.param, device="cpu")


@pytest.mark.parametrize("method", METHODS)
def test_gloo_ranks_equal_jax_formula(ranks, method):
    n, runs = ranks
    want = _formula(n, method)
    for r in range(n):
        for step, ((mean, err), (wmean, werr)) in enumerate(zip(runs[r][method], want[r])):
            assert sorted(mean) == sorted(wmean)
            keys = wmean if n == 2 or method == "int8_ef" else ORDER_FREE
            for k in keys:
                np.testing.assert_array_equal(mean[k], wmean[k],
                                              err_msg=f"rank {r} step {step} {k}")
            if method != "int8_ef":
                assert err is None
                continue
            for k in werr:
                np.testing.assert_array_equal(err[k], werr[k],
                                              err_msg=f"rank {r} step {step} err {k}")
    # the exact-sum leaf really mixes the ranks
    assert not np.array_equal(runs[0][method][0][0]["list/1"],
                              _flat(_grads(0, 0))["list/1"])


# ------------------------------------------------ world size 1 against JAX
@pytest.fixture
def group1(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _jax_mean(method, grads, err):
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.distributed.compression import compressed_grad_mean as jmean
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1), ("data",))
    lead = lambda t: jax.tree.map(lambda a: a[None], t)

    def f(gr, er):
        return jmean(gr, ("data",), method, er)
    if err is None:
        out = shard_map(lambda gr: jmean(gr, ("data",), method)[0], mesh=mesh,
                        in_specs=(P("data"),), out_specs=P("data"))(lead(grads))
        return jax.tree.map(lambda a: a[0], out), None
    m, e = shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                     out_specs=(P("data"), P("data")))(lead(grads), lead(err))
    return jax.tree.map(lambda a: a[0], m), jax.tree.map(lambda a: a[0], e)


@pytest.mark.parametrize("method", METHODS)
def test_world_size_one_equals_jax(group1, method):
    import jax
    import jax.numpy as jnp
    err = jerr = None
    for step in range(STEPS):
        g = _grads(0, step)
        jg = jax.tree.map(lambda t: jnp.asarray(t.to(torch.float32).numpy())
                          .astype(jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32),
                          g)
        if method == "int8_ef" and jerr is None:
            jerr = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), jg)
        mean, err = compressed_grad_mean(g, None, method, err)
        jm, jerr_new = _jax_mean(method, jg, jerr if method == "int8_ef" else None)
        mine, theirs = _flat(mean), {k: np.asarray(v, np.float32) for k, v in
                                     _flat_np(jm).items()}
        for k in theirs:
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=f"{step} {k}")
        assert mean["list"][0].dtype == torch.bfloat16 and mean["w"].dtype == torch.float32
        if method == "int8_ef":
            jerr = jerr_new
            for k, v in _flat_np(jerr).items():
                np.testing.assert_array_equal(_flat(err)[k], np.asarray(v), err_msg=k)
        else:
            assert err is None


def _flat_np(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat_np(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat_np(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def test_unknown_method_raises_as_jax(group1):
    from repro.distributed.compression import compressed_grad_mean as jmean
    with pytest.raises(ValueError, match="unknown compression 'int4'"):
        compressed_grad_mean({"w": torch.ones(2)}, None, "int4")
    with pytest.raises(ValueError, match="unknown compression 'int4'"):
        jmean({"w": np.ones(2, np.float32)}, (), "int4")


def test_error_feedback_tracks_the_exact_sum(group1):
    """JAX's property (``test_substrate``): with the residual carried, the
    accumulated compressed mean tracks the accumulated gradient."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal((4, 8))
                               .astype(np.float32))}
    err, comp = None, torch.zeros(4, 8)
    for _ in range(50):
        mean, err = compressed_grad_mean(g, None, "int8_ef", err)
        comp = comp + mean["w"]
    exact = 50 * g["w"]
    rel = float((comp - exact).abs().max() / exact.abs().max())
    assert rel < 0.02, rel
    # without the residual the bias accumulates
    plain = sum(compressed_grad_mean(g, None, "int8_ef")[0]["w"] for _ in range(50))
    assert float((plain - exact).abs().max()) > float((comp - exact).abs().max())
