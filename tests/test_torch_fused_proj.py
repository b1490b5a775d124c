"""Port parity: the fused QKV and gate-up projections (``fused_proj``).

Reduced stablelm-3b, qwen2.5-32b (QKV bias), granite-moe-3b-a800m,
qwen2-moe-a2.7b (its shared expert's ``w13``) and zamba2-2.7b (its shared
block's ``w13``; its attention stays unfused, as the JAX package builds
it). The fp weights are drawn with numpy in the unfused layout and fused
by concatenation (``transformer.fuse_projections``), so fused and unfused
models hold the same functions.

* The fused init tree has JAX's keys and shapes (``jax.eval_shape``).
* Inside the port, fused == unfused to the bit: fp, fake-quant and
  deployed integer logits (reference and kernel backends), the deployed
  codes (``wqkv`` = wq | wk | wv, ``w13`` = w1 | w3, one activation scale
  each, equal to the unfused parts').
* Against JAX's ``fused_proj`` model on the same arrays: fake-quant logits
  and deployed integer logits within rtol = atol = 1e-4 (XLA and PyTorch
  order their float sums differently); the deployed tree (codes, scales,
  biases) bit-equal; greedy engine streams equal, on JAX's artifact loaded
  by the port. JAX's calibration has no fused site (its ``site_order``), so
  the activation scales JAX deploys with are the port's calibrated ones.
* Tensor parallelism: a rank's fused leaf is the concatenation of its
  slices of the parts (``FusedAxis``), and tp=2 on gloo ranks serves
  streams and decode logits bit-equal to tp=1.

This module imports no JAX at the top: the ranks import it by name.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.tree import tree_leaves_with_path, tree_map
from repro_torch.deploy import DeployedModel, ExecutionPlan, deploy
from repro_torch.distributed import FusedAxis, serving_param_specs, shard_serving
from repro_torch.launch.mesh import spawn_tp
from repro_torch.models import api
from repro_torch.models.transformer import fuse_projections
from repro_torch.serving import GenerationRequest, ServingEngine


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small, and
    at one thread a test worker does not contend with the suite's others
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ARCHS = ("stablelm-3b", "qwen2.5-32b", "granite-moe-3b-a800m",
         "qwen2-moe-a2.7b", "zamba2-2.7b")
SERVED = ("stablelm-3b", "qwen2.5-32b", "qwen2-moe-a2.7b")
CALIB = [{"tokens": np.random.default_rng(0).integers(1, 256, (4, 16)).astype(np.int32)}
         for _ in range(2)]
TOKENS = np.random.default_rng(1).integers(1, 256, (2, 16)).astype(np.int32)
PROMPTS = [np.array(p, np.int32) for p in
           ([5, 9, 2], [8, 8, 1, 4, 12, 77], list(range(30, 41)), [3, 250])]


def _cfg(arch, fused=False):
    return reduced(get_config(arch)).replace(fused_proj=fused)


def _kw(cfg) -> dict:
    return {"prefill_mode": "token"} if cfg.family == "hybrid" else {}


def _policy(cfg, mode="int"):
    n = cfg.num_layers // (cfg.attn_every or 1)
    return QuantPolicy(num_layers=n, mode=mode, last_k_int4=n // 2)


def _fp(arch, seed=0):
    """Unfused fp params of the reduced arch, every random leaf drawn from
    numpy (so logits are far from uniform), as tensors."""
    rng = np.random.default_rng(seed)
    tree = api.init_model(_cfg(arch), torch.Generator().manual_seed(0), "cpu")
    return tree_map(lambda a: a if bool(torch.all(a == 0) or torch.all(a == 1))
                    else torch.from_numpy(rng.normal(0, 0.02, tuple(a.shape))
                                          .astype(np.float32)), tree)


def _flat(tree) -> dict:
    return {"/".join(map(str, k)): v for k, v in tree_leaves_with_path(tree)}


def _deployed(arch, fused: bool, backend="cuda", kv_bits=16):
    cfg = _cfg(arch, fused)
    fp = _fp(arch)
    plan = ExecutionPlan.build(cfg, _policy(cfg), backend=backend, kv_bits=kv_bits,
                               **_kw(cfg))
    return deploy(fuse_projections(fp) if fused else fp, plan, CALIB, device="cpu")


@pytest.fixture(scope="module")
def models():
    """arch -> (unfused, fused) deployed models on the kernel backend."""
    return {a: (_deployed(a, False), _deployed(a, True)) for a in ARCHS}


# --------------------------------------------------------------- init
@pytest.mark.parametrize("arch", ARCHS)
def test_fused_init_tree_matches_jax(arch):
    import jax
    from repro.configs import get_config as jget
    from repro.configs import reduced as jred
    from repro.models import api as japi
    jtree = jax.eval_shape(lambda k: japi.init_model(
        jred(jget(arch)).replace(fused_proj=True), k), jax.random.PRNGKey(0))
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in k): tuple(v.shape)
            for k, v in jax.tree_util.tree_leaves_with_path(jtree)}
    got = {k: tuple(v.shape) for k, v in _flat(api.init_model(
        _cfg(arch, True), torch.Generator().manual_seed(0), "meta")).items()}
    assert got == want
    fused = {k for k in got if "/wqkv/" in k or "/w13/" in k}
    assert any("/w13/" in k for k in fused) == (arch != "granite-moe-3b-a800m")
    assert any("/wqkv/" in k for k in fused) == (arch != "zamba2-2.7b")
    # fuse_projections gives the same tree as the fused init
    assert {k: tuple(v.shape) for k, v in _flat(fuse_projections(_fp(arch))).items()} == got


# ---------------------------------------------------- fused == unfused
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["none", "fake"])
def test_fused_fp_and_fake_logits_equal_unfused(arch, mode):
    cfg, fcfg = _cfg(arch), _cfg(arch, True)
    pol = None if mode == "none" else _policy(cfg, "fake")
    fp = _fp(arch)
    a = api.forward(fp, ExecutionPlan.build(cfg, pol, **_kw(cfg)), tokens=TOKENS)[0]
    b = api.forward(fuse_projections(fp), ExecutionPlan.build(fcfg, pol, **_kw(cfg)),
                    tokens=TOKENS)[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_deploy_and_int_logits_equal_unfused(models, arch):
    unfused, fused = models[arch]
    u, f = _flat(unfused.params), _flat(fused.params)
    n_fused = 0
    for key, val in f.items():
        if "/wqkv/" not in key and "/w13/" not in key:
            assert torch.equal(val, u[key]), key
            continue
        n_fused += 1
        site, leaf = key.rsplit("/", 1)
        prefix, name = site.rsplit("/", 1)
        parts = ("wq", "wk", "wv") if name == "wqkv" else ("w1", "w3")
        srcs = [u[f"{prefix}/{p}/{leaf}"] for p in parts]
        if leaf == "s_a":   # one activation scale, the parts' (equal) one
            for s in srcs:
                assert torch.equal(val, s), key
        else:
            assert torch.equal(val, torch.cat(srcs, dim=-1)), key
    assert n_fused
    for backend in ("cuda", "reference"):
        plans = [ExecutionPlan.build(m.plan.cfg, m.plan.policy, backend=backend,
                                     **_kw(m.plan.cfg)) for m in (unfused, fused)]
        a = api.forward(unfused.params, plans[0], tokens=TOKENS)[0]
        b = api.forward(fused.params, plans[1], tokens=TOKENS)[0]
        assert torch.equal(a, b), backend


# ----------------------------------------------------------- against JAX
def _jax_side(arch, fused_fp):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced as jred
    from repro.core.policy import QuantPolicy as JPol
    from repro.deploy import ExecutionPlan as JPlan
    jcfg = jred(jget(arch)).replace(fused_proj=True)
    n = jcfg.num_layers // (jcfg.attn_every or 1)
    kw = {"prefill_mode": "token"} if jcfg.family == "hybrid" else {}
    jp = jax.tree.map(lambda a: jnp.asarray(a.numpy()), fused_fp,
                      is_leaf=lambda a: isinstance(a, torch.Tensor))
    return jcfg, jp, lambda mode, **k: JPlan.build(
        jcfg, JPol(num_layers=n, mode=mode, last_k_int4=n // 2), **kw, **k)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_fake_logits_match_jax(arch):
    import jax
    from repro.models import api as japi
    fp = fuse_projections(_fp(arch))
    jcfg, jp, jplan = _jax_side(arch, fp)
    plan = jplan("fake")
    want = jax.jit(lambda p, t: japi.forward(p, jcfg, plan.segments, tokens=t)[0])(jp, TOKENS)
    cfg = _cfg(arch, True)
    got = api.forward(fp, ExecutionPlan.build(cfg, _policy(cfg, "fake"), **_kw(cfg)),
                      tokens=TOKENS)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def _with_act_scales(fp, deployed, cfg):
    """``fp`` with every linear's ``s_a`` taken from the port's calibrated
    deployed tree (its per-segment stacks joined along the layer axis)."""
    out = _flat(fp)
    dep = _flat(deployed)
    for key in out:
        if not key.endswith("/s_a"):
            continue
        head, rest = key.split("/", 1)
        segs = [v for k, v in dep.items() if k.split("/", 2)[0] == head
                and k.split("/", 2)[-1] == rest and k.split("/", 2)[1].isdigit()]
        out[key] = torch.cat(segs) if segs else dep[key]
    from repro_torch.core.tree import tree_map_with_path
    return tree_map_with_path(lambda path, _: out["/".join(map(str, path))], fp)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_deployed_tree_and_int_logits_match_jax(models, arch, tmp_path):
    import jax
    from repro.deploy import deploy as jdeploy
    from repro.models import api as japi
    cfg = _cfg(arch, True)
    fused = models[arch][1]
    fp = _with_act_scales(fuse_projections(_fp(arch)), fused.params, cfg)
    jcfg, jp, jplan = _jax_side(arch, fp)
    jmodel = jdeploy(jp, jplan("int"))          # no calibration batches: fp's s_a
    want = {k: np.asarray(v) for k, v in _flat(jax.tree.map(np.asarray, jmodel.params,
            is_leaf=lambda a: hasattr(a, "shape"))).items()}
    got = {k: v.numpy() for k, v in _flat(fused.params).items()}
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jlogits = jax.jit(lambda p, t: japi.forward(p, jcfg, jmodel.plan.segments,
                                                tokens=t)[0])(jmodel.params, TOKENS)
    np.testing.assert_allclose(api.forward(fused.params, fused.plan, tokens=TOKENS)[0].numpy(),
                               np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    if arch not in SERVED:
        return
    # greedy engine streams: JAX's engine on its artifact, the port's engine
    # (kernel backend, the plain versions on the CPU) on the same artifact
    from repro.serving import GenerationRequest as JReq
    from repro.serving import ServingEngine as JEngine
    jmodel.save(str(tmp_path / "art"))
    jeng = JEngine(jmodel, slots=2, max_len=32)
    js = [jeng.submit(JReq(prompt=p.copy(), max_new_tokens=6)) for p in PROMPTS]
    jeng.run_until_drained()
    loaded = DeployedModel.load(str(tmp_path / "art"), device="cpu")
    assert loaded.plan.cfg.fused_proj
    model = DeployedModel(plan=ExecutionPlan.build(loaded.plan.cfg, loaded.plan.policy,
                                                   backend="cuda"), params=loaded.params)
    assert _serve(model) == [[int(t) for t in s.result().tokens] for s in js]


# ------------------------------------------------------------- tp
def _serve(model, with_logits=False):
    import repro_torch.serving.engine as engine_mod
    logits = []
    orig = engine_mod.sample_batch

    def spy(lg, *a):
        logits.append(lg.clone())
        return orig(lg, *a)
    engine_mod.sample_batch = spy
    try:
        eng = ServingEngine(model, slots=2, max_len=32)
        streams = [eng.submit(GenerationRequest(prompt=p.copy(), max_new_tokens=6))
                   for p in PROMPTS]
        eng.run_until_drained()
    finally:
        engine_mod.sample_batch = orig
    out = [[int(t) for t in s.result().tokens] for s in streams]
    return (out, torch.stack(logits)) if with_logits else out


def _tp_rank(paths: dict) -> dict:
    import torch.distributed as dist
    torch.set_num_threads(1)
    tp = dist.get_world_size()
    return {arch: _serve(DeployedModel.load(path, tp=tp, device="cpu"), with_logits=True)
            for arch, path in paths.items()}


@pytest.mark.parametrize("arch", SERVED)
def test_rank_slices_of_a_fused_leaf_are_its_parts_slices(models, arch):
    unfused, fused = models[arch]
    cfg = fused.plan.cfg
    specs = _flat(serving_param_specs(fused.params, cfg))
    assert specs["layers/0/attn/wqkv/wq"] == FusedAxis(     # (L, K, N): N
        2, (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    assert any(isinstance(s, FusedAxis) and s.parts == (1, 1) for s in specs.values())
    for rank in range(2):
        u = _flat(shard_serving(unfused.params, serving_param_specs(unfused.params), rank, 2))
        f = _flat(shard_serving(fused.params, serving_param_specs(fused.params, cfg), rank, 2))
        assert torch.equal(
            f["layers/0/attn/wqkv/wq"],
            torch.cat([u[f"layers/0/attn/{p}/wq"] for p in ("wq", "wk", "wv")], -1))
        key = next(k for k in f if "/w13/wq" in k)
        assert torch.equal(f[key], torch.cat([u[key.replace("w13", p)] for p in ("w1", "w3")], -1))
        if cfg.qkv_bias:
            assert torch.equal(f["layers/0/attn/wqkv/b"], torch.cat(
                [u[f"layers/0/attn/{p}/b"] for p in ("wq", "wk", "wv")], -1))


def test_fused_tp2_serves_bit_equal_to_tp1(tmp_path):
    paths = {}
    for arch in SERVED:
        model = _deployed(arch, True, backend="reference", kv_bits=8)
        paths[arch] = str(tmp_path / arch)
        model.save(paths[arch])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # the ranks' thread count: bits may depend on it
    try:
        want = {arch: _serve(DeployedModel.load(p, device="cpu"), with_logits=True)
                for arch, p in paths.items()}
    finally:
        torch.set_num_threads(threads)
    got = spawn_tp(_tp_rank, 2, paths, device="cpu")
    for arch in SERVED:
        assert got[arch][0] == want[arch][0], arch
        assert torch.equal(got[arch][1], want[arch][1]), arch
