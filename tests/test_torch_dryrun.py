"""The dry run's inputs, the step analysis, the dry run and the roofline of
the port, against the JAX package's.

* ``SHAPES``, ``SUBQUADRATIC_FAMILIES``, ``ASSIGNED``, ``shape_applicable``
  (reason strings too) and ``input_specs`` (keys, shapes, dtypes; meta
  tensors where JAX gives ``ShapeDtypeStruct``s) equal JAX's for every
  arch in ``ASSIGNED`` and every shape.
* The training shard rules: ``param_specs`` (without and with FSDP axes,
  on the TPU meshes and on the port's layouts), ``batch_spec``,
  ``safe_batch_spec`` and ``state_specs`` equal JAX's ``PartitionSpec``s
  entry for entry, for every arch (JAX's trees from ``jax.eval_shape``,
  the port's on the meta device).
* The roofline's ``param_count``, ``model_flops`` and
  ``analytic_decode_bytes`` equal JAX's ``benchmarks/roofline.py`` for
  every arch x shape x layout.
* ``op_analysis``' dot FLOPs and their int / float split on reduced
  prefill and decode cells of five families and a reduced stablelm-3b
  train step against ``repro.launch.hlo_analysis.analyze`` of the JAX
  step, compiled on one device: within rtol 1e-6 (they are equal; a
  probe of the hybrid's and xLSTM's train steps found XLA counting their
  chunked scans' backward dots 0.2 % and 0.8 % apart, so a train step is
  held to 1e-2); its predicted kernel launches equal the counts derived
  from ``gemm_plan`` linear by linear.
* ``run_cell``'s JSON schema and skips; ``benchmarks.run --quick --only
  roofline`` on its output.

``repro.launch.dryrun`` is never imported here: its first line sets
``XLA_FLAGS`` to 512 host devices. The JAX steps are built directly.
"""
import dataclasses
import functools
import importlib.util
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import TrainHParams as JHP
from repro.configs import get_config as jget
from repro.configs import input_specs as jinput_specs
from repro.configs import reduced as jred
from repro.configs import shape_applicable as jshape_applicable
from repro.configs.archs import ASSIGNED as JASSIGNED
from repro.configs.base import SUBQUADRATIC_FAMILIES as JSUBQ
from repro.core.policy import QuantPolicy as JPol
from repro.core.qat import deploy_params as jdeploy_params
from repro.deploy import ExecutionPlan as JPlan
from repro.distributed import sharding as jsh
from repro.launch.hlo_analysis import analyze as hlo_analyze
from repro.launch.train import build_train_step as jbuild_train_step
from repro.models import api as japi
from repro.optim import adam_init as jadam_init
from repro_torch.configs import (ASSIGNED, SHAPES, SUBQUADRATIC_FAMILIES,
                                 ShapeSpec, get_config, input_specs, reduced,
                                 shape_applicable)
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.gemm_plan import quantizes_in_gemm
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import analyze
from repro_torch.models import api


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small, and
    at one thread a test worker does not contend with the suite's others
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"tpu_single": (("data", "model"), {"data": 16, "model": 16}),
          "tpu_multi": (("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16}),
          "h100_multi_train": (("data", "model"), {"data": 2, "model": 2}),
          "h100_multi_serve": (("data", "model"), {"data": 1, "model": 4})}


def _mesh(name):
    axes, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, shape=shape)


def _jpath(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _jflat(tree) -> dict:
    return {_jpath(k): v for k, v in jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}


def _flat(tree) -> dict:
    return {"/".join(map(str, k)): v for k, v in tree_leaves_with_path(tree)}


def _spec_flat(tree, prefix="") -> dict:
    """A spec tree's leaves (tuples, one entry a dim) by '/'-joined path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_spec_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _jax_roofline():
    spec = importlib.util.spec_from_file_location("jax_roofline",
                                                  ROOT / "benchmarks" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ the inputs
def test_shapes_assigned_and_families_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert list(SHAPES) == list(JSHAPES)
    assert ASSIGNED == JASSIGNED and SUBQUADRATIC_FAMILIES == JSUBQ


@pytest.mark.parametrize("arch", JASSIGNED)
def test_shape_applicable_and_input_specs_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    for name in SHAPES:
        assert shape_applicable(cfg, SHAPES[name]) == jshape_applicable(jcfg, JSHAPES[name])
        got, want = input_specs(cfg, SHAPES[name]), jinput_specs(jcfg, JSHAPES[name])
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            if w is None:
                assert got[k] is None
                continue
            assert got[k].is_meta and tuple(got[k].shape) == tuple(w.shape), k
            assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k


# ----------------------------------------------------------- shard rules
@pytest.fixture(scope="module", params=JASSIGNED)
def trees(request):
    arch = request.param
    cfg = get_config(arch)
    jparams = jax.eval_shape(lambda k: japi.init_model(jget(arch), k), jax.random.PRNGKey(0))
    params = api.init_model(cfg, torch.Generator(), "meta")
    jstate = japi.decode_state(jget(arch), 8, 64, as_specs=True)
    state = api.decode_state(cfg, 8, 64, device="meta")
    return arch, jparams, params, jstate, state


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_batch_and_state_specs_equal_jax(trees, mesh):
    arch, jparams, params, jstate, state = trees
    m = _mesh(mesh)
    jsh.set_mesh_axis_sizes(m)
    sh.set_mesh_axis_sizes(m)
    dp = tuple(a for a in ("pod", "data") if a in m.axis_names)
    for fsdp in ((), dp):
        want = {k: tuple(v) for k, v in _jflat(jsh.param_specs(jparams, fsdp_axes=fsdp)).items()}
        got = _spec_flat(sh.param_specs(params, fsdp_axes=fsdp))
        assert got == want, (arch, fsdp)
    assert _spec_flat(sh.state_specs(state, m)) == \
        {k: tuple(v) for k, v in _jflat(jsh.state_specs(jstate, m)).items()}
    for shape in ((256, 4096), (1, 1), (8, 1, 64)):
        assert sh.safe_batch_spec(m, shape) == tuple(jsh.safe_batch_spec(m, shape))
        assert sh.batch_spec(m, len(shape)) == tuple(jsh.batch_spec(m, len(shape)))


# ------------------------------------------------------------- roofline
def test_roofline_arithmetic_equals_jax():
    from repro_torch.benchmarks import roofline
    jr = _jax_roofline()
    for arch in ASSIGNED:
        cfg, jcfg = get_config(arch), jget(arch)
        for active in (False, True):
            assert roofline.param_count(cfg, active) == jr.param_count(jcfg, active)
        for name in SHAPES:
            for chips in (1, 4, 256, 512):
                assert roofline.model_flops(cfg, SHAPES[name], chips) == \
                    jr.model_flops(jcfg, JSHAPES[name], chips)
                assert roofline.analytic_decode_bytes(cfg, SHAPES[name], chips) == \
                    jr.analytic_decode_bytes(jcfg, JSHAPES[name], chips)


# -------------------------------------------------------- step analysis
ANALYSED = ("stablelm-3b", "granite-moe-3b-a800m", "seamless-m4t-medium",
            "zamba2-2.7b", "xlstm-1.3b")
TRAINED = "stablelm-3b"
B, S = 2, 64


def _units(cfg) -> int:
    return cfg.dec_layers if cfg.family == "encdec" else cfg.num_layers


@functools.lru_cache(maxsize=None)
def _jax_flops(arch) -> dict:
    """hlo_analysis of JAX's prefill and decode steps and, for stablelm-3b,
    its train step (reduced arch, compiled on the one CPU device; the
    other families' train steps take 15-25 s each to compile)."""
    jcfg = jred(jget(arch))
    n = _units(jcfg)
    jp = japi.init_model(jcfg, jax.random.PRNGKey(0))
    batch = {"tokens": jnp.zeros((B, S), jnp.int32), "labels": jnp.zeros((B, S), jnp.int32)}
    if jcfg.family == "encdec":
        batch["src_embeds"] = jnp.zeros((B, S, jcfg.d_model), jnp.float32)
    out = {}
    if arch == TRAINED:
        plan = JPlan.build(jcfg, JPol(num_layers=n, mode="fake", last_k_int4=n // 2))
        out["train"] = jax.jit(jbuild_train_step(plan, JHP())).lower(
            jp, jadam_init(jp), batch).compile().as_text()
    kw = {"prefill_mode": "token"} if jcfg.family in ("hybrid", "xlstm", "encdec") else {}
    plan = JPlan.build(jcfg, JPol(num_layers=n, mode="int", last_k_int4=n // 2), **kw)
    jpi = jdeploy_params(jp, jcfg, plan.segments)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    out["prefill"] = jax.jit(lambda p, b: japi.forward(p, jcfg, plan.segments, **b)[0]).lower(
        jpi, inputs).compile().as_text()
    st = japi.decode_state(jcfg, B, S, dtype=jnp.bfloat16)
    ex = japi.decode_extra_inputs(jcfg, B, S, dtype=jcfg.compute_dtype)
    out["decode"] = jax.jit(lambda p, s, t, e: japi.forward(
        p, jcfg, plan.segments, state=s, tokens=t, **e)[:2]).lower(
        jpi, st, jnp.zeros((B, 1), jnp.int32), ex).compile().as_text()
    return {k: hlo_analyze(v) for k, v in out.items()}


def _port_cell(arch, kind):
    cfg = reduced(get_config(arch))
    n = _units(cfg)
    pol = QuantPolicy(num_layers=n, mode="fake" if kind == "train" else "int",
                      last_k_int4=n // 2)
    shape = ShapeSpec(kind, S, B, kind)
    if kind == "train":
        return cfg, dryrun._train_cell(cfg, shape, make_production_mesh(), policy=pol,
                                       distill=False, extra={})
    return cfg, dryrun._serve_cell(cfg, shape, make_production_mesh(serving=True),
                                   policy=pol, extra={})


def _expected_launches(cfg, M: int) -> dict:
    """Each quantized linear's GEMM launch and, where its plan does not
    quantize inside the GEMM, its act_quant launch, from the deployed
    tree's shapes (``gemm_plan``)."""
    from repro_torch.deploy import ExecutionPlan
    from repro_torch.core.qat import deploy_params
    plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=_units(cfg), mode="int",
                                                last_k_int4=_units(cfg) // 2),
                               backend="cuda", **({"prefill_mode": "token"} if cfg.family in
                                                 ("hybrid", "xlstm", "encdec") else {}))
    params = deploy_params(api.init_model(cfg, torch.Generator(), "meta"), cfg, plan.segments)
    out = dict.fromkeys(("act_quant", "int8_matmul", "int4_matmul"), 0)
    for si, (_, _, spec) in enumerate(plan.segments):
        for path, leaf in tree_leaves_with_path(params["layers"][si]):
            if path[-1] != "wq":
                continue
            L, Kw, N = leaf.shape
            K = Kw * (2 if spec.w_bits == 4 else 1)
            out[f"int{spec.w_bits}_matmul"] += L
            if not quantizes_in_gemm(M, N, K, spec.w_bits):
                out["act_quant"] += L
    return out


CASES = [(a, k) for a in ANALYSED for k in ("prefill", "decode")] + [(TRAINED, "train")]


@pytest.mark.parametrize("arch,kind", CASES)
def test_op_analysis_dot_flops_match_hlo_analysis(arch, kind):
    jflops = _jax_flops(arch)
    cfg, (step, args, _) = _port_cell(arch, kind)
    got, want = analyze(step, *args), jflops[kind]
    rtol = 1e-2 if kind == "train" else 1e-6
    for key in ("flops", "int_flops", "float_flops"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, err_msg=key)
    assert got["flops"] > 0 and got["hbm_bytes"] > 0
    if kind == "train":
        assert got["int_flops"] == 0 and not any(got["launches"].values())
    elif cfg.family == "dense":
        want_l = _expected_launches(cfg, B * S if kind == "prefill" else B)
        assert want_l["int8_matmul"] == want_l["int4_matmul"] == 14
        assert want_l["act_quant"] == (28 if kind == "prefill" else 0)
        assert got["launches"] == {**dict.fromkeys(got["launches"], 0), **want_l}


def test_analyze_counts_collectives_of_a_fake_group():
    """A tp=4 int8 linear's row-parallel all-reduce (int32 partials) counts
    twice its bytes, as hlo_analysis counts an all-reduce."""
    import torch.distributed as dist
    from repro_torch.models.layers import QuantSpec, qlinear
    p = {"wq": torch.empty(16, 8, dtype=torch.int8, device="meta"),
         "s_w": torch.empty(1, 8, device="meta"), "s_a": torch.empty((), device="meta")}
    x = torch.empty(3, 16, device="meta")
    with dryrun.fake_group(4):
        got = analyze(lambda: qlinear(x, p, QuantSpec(mode="int", w_bits=8, a_bits=8, tp=4),
                                      row_parallel=True))
    assert not dist.is_initialized()
    assert got["collective_bytes"] == {"all-reduce": 2 * 3 * 8 * 4}
    assert got["top_collectives"][0]["count"] == 1


# ------------------------------------------------------------ run_cell
def test_run_cell_schema_skips_and_the_runner(tmp_path, capsys, monkeypatch):
    out = str(tmp_path / "dry")
    ok = dryrun.run_cell("xlstm-1.3b", "long_500k", "single", out)
    assert ok["status"] == "ok" and ok["chips"] == 1
    assert set(ok) == {"arch", "shape", "mesh", "chips", "policy", "grad_mode", "tag",
                       "status", "lower_s", "compile_s", "memory", "xla_cost_analysis",
                       "op_analysis", "top_collectives", "top_dots", "top_hbm",
                       "roofline_terms_s", "dominant"}
    assert set(ok["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                 "total_bytes", "fits_80g"}
    assert set(ok["op_analysis"]) == {"flops", "int_flops", "float_flops", "hbm_bytes",
                                      "collective_bytes", "collective_bytes_total",
                                      "launches", "torch_ops"}
    assert ok["op_analysis"]["launches"]["int8_matmul"] == 111      # 3 groups W8A8
    assert ok["op_analysis"]["launches"]["int4_matmul"] == 111
    assert ok["dominant"] in ok["roofline_terms_s"]
    skips = [("stablelm-3b", "long_500k", "single", {}, "full-attention arch"),
             ("xlstm-1.3b", "decode_32k", "multi", {}, "tp=4: no sharding rules")]
    for arch, shape, mesh, extra, why in skips:
        r = dryrun.run_cell(arch, shape, mesh, out, extra=extra)
        assert r["status"] == "skipped" and why in r["reason"], r
    # the token-mode families' train cells over data 2 x model 2 build (cut to
    # two groups at d 64 and 8 x 64 tokens here: the sLSTM steps token by
    # token, and the full cells' analysis takes many minutes)
    import repro_torch.configs as configs
    with monkeypatch.context() as mp:
        mp.setattr(configs, "get_config", lambda a, real=configs.get_config: reduced(real(a)))
        mp.setitem(SHAPES, "train_4k", ShapeSpec("train_4k", 64, 8, "train"))
        for arch, extra in (("xlstm-1.3b", {}), ("zamba2-2.7b", {"fsdp": True})):
            r = dryrun.run_cell(arch, "train_4k", "multi", out, extra=extra)
            assert r["status"] == "ok" and r["chips"] == 4, r
    files = sorted(p.name for p in (tmp_path / "dry").iterdir())
    assert "xlstm-1.3b__long_500k__single.json" in files and len(files) == 5
    assert json.loads((tmp_path / "dry" / files[-1]).read_text())["status"]
    from repro_torch.benchmarks import run
    capsys.readouterr()
    assert run.main(["--quick", "--only", "roofline", "--dryrun-dir", out]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("roofline,")]
    assert len(lines) == 1 + 5
    assert any(ln.startswith("roofline,xlstm-1.3b,long_500k,single,ok,") for ln in lines)


# ------------------------------------------------- the sharded train cells
def _small_stablelm(arch):
    """stablelm-3b reduced to 2 layers at d 64, its chunk (1024) and
    threshold (2048) kept so train_4k takes the chunk branch in 4 blocks."""
    return reduced(get_config("stablelm-3b")).replace(num_layers=2, attn_chunk=1024,
                                                     attn_chunk_threshold=2048)


@pytest.mark.parametrize("extra", [{}, {"fsdp": True}, {"attn_seq_shard": True}],
                         ids=["plain", "fsdp", "attn_seq_shard"])
def test_multi_train_cells_build_with_fsdp_and_seq_shard(extra, tmp_path, monkeypatch):
    """The train_4k x multi cell (data 2 x model 2) is ``ok`` plain, with
    --fsdp and with --attn-seq-shard (on a 2-layer, d 64 stablelm-3b);
    FSDP broadcasts the layers (collective-permute), the context-parallel
    chunk branch adds all-gathers of the heads."""
    import repro_torch.configs as configs
    monkeypatch.setattr(configs, "get_config", _small_stablelm)
    r = dryrun.run_cell("stablelm-3b", "train_4k", "multi", str(tmp_path), extra=extra)
    assert r["status"] == "ok" and r["chips"] == 4, r
    coll = r["op_analysis"]["collective_bytes"]
    assert coll["all-reduce"] > 0 and coll["all-gather"] > 0
    assert ("collective-permute" in coll) == bool(extra.get("fsdp"))
    shapes = [c["operands"] for c in r["top_collectives"] if c["op"] == "all-gather"]
    assert any(len(op.split(",")) == 6 for op in shapes) == bool(extra.get("attn_seq_shard"))


def test_fsdp_cell_keeps_at_most_055_of_the_argument_bytes():
    """stablelm-3b x train_4k x multi at full size: FSDP cuts the layer
    stacks and both Adam moments over the 2 data ranks; the vocabulary
    tables (2-D) stay cut over "model" only: 0.5465x."""
    mesh = make_production_mesh(multi=True)
    got = {}
    for fsdp in (False, True):
        with dryrun.fake_group(mesh.chips):
            built, why = dryrun._build_cell("stablelm-3b", "train_4k", mesh,
                                            policy_kind="mkq50", distill=False,
                                            grad_mode="mse", extra={"fsdp": fsdp})
        assert built is not None, why
        got[fsdp] = built[2]
    assert got[True] <= 0.55 * got[False], got[True] / got[False]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_proj"])
def test_tp_step_collective_bytes_follow_the_formula(fused):
    """Rank 0 of data 2 x model 2, a reduced stablelm-3b (2 layers, d 64,
    f32, ``remat`` off), b = B / 2 rows of S tokens, e = 4 bytes; the
    analyzer counts an all-reduce twice its bytes, an all-gather its input:

    all-reduce = 2 e (b S d (2 + L (2 + c)) + 2 L (d + 1) + P + 2)
      the embedding's rows summed over the vocabulary shards and the lm_head
      input's dx (2); per layer the row-parallel outputs of wo and w2 (2)
      and the dx of the c column-parallel inputs (wq wk wv w1 w3: 5; fused
      wqkv w13: 2); the row-parallel scales' shares (s_w (1, d), s_a ()) of
      wo and w2; the P local params' gradients averaged over the data
      ranks; the loss over them and the clip's norm over "model" (2);
    all-gather = b S (V / 2) e: the logits.
    """
    cfg = reduced(get_config("stablelm-3b")).replace(num_layers=2, fused_proj=fused)
    B, S = 4, 32
    pol = QuantPolicy(num_layers=2, mode="fake", last_k_int4=1)
    with dryrun.fake_group(4):
        step, args, _ = dryrun._train_cell(cfg, ShapeSpec("t", S, B, "train"),
                                           make_production_mesh(multi=True), policy=pol,
                                           distill=False, extra={})
        got = analyze(step, *args)["collective_bytes"]
    b, d, L, e, V = B // 2, cfg.d_model, cfg.num_layers, 4, cfg.padded_vocab
    c = 2 if fused else 5
    P = sum(t.numel() for _, t in tree_leaves_with_path(args[0]))
    assert got == {"all-reduce": 2 * e * (b * S * d * (2 + L * (2 + c)) + 2 * L * (d + 1)
                                          + P + 2),
                   "all-gather": b * S * (V // 2) * e}
