"""Tensor-parallel serving of the port on gloo ranks on the CPU.

* **Validation parity**: ``ExecutionPlan.build(tp=...)`` accepts and
  rejects the plans JAX's does, and ``_validate_tp`` fails on the same
  condition, with the same key phrase, as JAX's (token-only families
  called directly: the port's build refuses them earlier).
* **Spec parity**: the axis each leaf of a deployed tree (and of a dense
  decode state and a block pool) shards on equals the axis JAX's
  ``serving_param_specs`` / ``serving_state_specs`` put "model" on.
* **The head-count test**: plain attention over all heads is bit-equal to
  the concatenation of its tp slices as a rank computes them
  (``rank_attention``), at the two shapes where a probe of a batched
  contraction over H / tp heads was not, f32 and bf16, prefill and decode.
* **The tp grid**: a reduced stablelm-3b (4 heads of 16, d_ff 128) at int8
  / int4 x kv 16 / 8 / 4 x dense / paged, saved at tp=1 and served at tp=2
  and tp=4: streams and every decode step's logits equal to tp=1's; and a
  small W8A8/W4A4 bert encoder plan, its results bit-equal.
* **The tp=2 artifact**: deployed and saved at tp=2, it holds tp=1's
  arrays and serves at tp=1 and tp=4 with tp=2's streams.
* **The MoE grid**: reduced granite-moe-3b-a800m (dense and sorted
  dispatch) and qwen2-moe-a2.7b (its shared expert and sigmoid gate), W8A8
  + W4A4 at kv 8, saved at tp=1 and served at tp=2 and tp=4: the experts'
  w1 / w3 hold a column slice, their w2 a row slice whose int32 partials
  are all-reduced, the router is replicated; streams and every decode
  step's logits equal to tp=1's.

Each tp degree is one ``spawn_tp`` (tp=1 too, so every process runs one
intra-op thread) that serves the whole grid; the three take about 20 s.
This module imports no JAX at the top: the ranks import it by name.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.deploy import DeployedModel, ExecutionPlan, deploy
from repro_torch.distributed import serving_param_specs, serving_state_specs
from repro_torch.launch.mesh import make_tp_group, spawn_tp
from repro_torch.models import api
from repro_torch.models.attention import (cached_decode_attention,
                                          chunked_attention, full_attention,
                                          rank_attention)
from repro_torch.serving import BlockPool, GenerationRequest, ServingEngine

GRID = [(w, kv, paging) for w in ("int8", "int4") for kv in (16, 8, 4)
        for paging in ("dense", "paged")]
PROMPTS = [np.array(p, np.int32) for p in
           ([5, 9, 2], [8, 8, 1, 4, 12, 77], list(range(30, 41)), [3, 250])]
#: activation-scale calibration: without it every s_a stays 1 and the
#: small activations all quantize to code 0
CALIB = [{"tokens": np.random.default_rng(0).integers(1, 256, (4, 16)).astype(np.int32)}
         for _ in range(2)]


def _cfg():
    return reduced(get_config("stablelm-3b"))


def _policy(w: str):
    return QuantPolicy(num_layers=4, mode="int",
                       last_k_int4=0 if w == "int8" else 4)


def _fp_params(cfg, seed=0):
    """The port's init tree with every random leaf redrawn from numpy (so
    logits are far from uniform), as tensors."""
    rng = np.random.default_rng(seed)
    tree = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")

    def redraw(a):
        if bool(torch.all(a == 0) or torch.all(a == 1)):
            return a
        return torch.from_numpy(rng.normal(0, 0.02, tuple(a.shape)).astype(np.float32))
    from repro_torch.core.tree import tree_map
    return tree_map(redraw, tree)


# ------------------------------------------------------------ the ranks
def _serve(model) -> dict:
    """Greedy streams of PROMPTS (5 new tokens, 4 slots: few steps, as
    each costs the ranks a gloo all-reduce per row-parallel linear) and
    every decode step's logits, on this rank."""
    import repro_torch.serving.engine as engine_mod
    logits = []
    orig = engine_mod.sample_batch

    def spy(lg, *a):
        logits.append(lg.clone())
        return orig(lg, *a)
    engine_mod.sample_batch = spy
    try:
        eng = ServingEngine(model, slots=4, max_len=32)
        streams = [eng.submit(GenerationRequest(prompt=p.copy(), max_new_tokens=5))
                   for p in PROMPTS]
        eng.run_until_drained()
    finally:
        engine_mod.sample_batch = orig
    return {"streams": [[int(t) for t in s.result().tokens] for s in streams],
            "logits": torch.stack(logits)}


def _encode(model) -> list:
    """Classify / embed / score results of four requests, on this rank."""
    from repro_torch.serving import EncodeRequest
    eng = ServingEngine(model, slots=4, max_len=32)
    hs = [eng.submit_encode(EncodeRequest(tokens=p.copy(), task=task))
          for p, task in zip(PROMPTS, ("classify", "embed", "score", "classify"))]
    eng.run_until_drained()
    return [torch.as_tensor(np.asarray(h.result().value)) for h in hs]


def _grid_rank(paths: dict, fp_path: str, tp2_path: str) -> dict:
    """One rank of a tp degree (the group's size): serve every grid
    artifact resharded to it; at tp=2 also deploy the fp params under a
    tp=2 plan, serve that model and save it; at tp 1 and 4 serve the
    tp=2-saved artifact resharded."""
    import torch.distributed as dist
    torch.set_num_threads(1)      # every process of every degree alike
    tp = dist.get_world_size()
    out = {case: (_encode if case == "encoder" else _serve)(
               DeployedModel.load(path, tp=tp, device="cpu"))
           for case, path in paths.items()}
    out["tp_seen"] = {case: DeployedModel.load(path, tp=tp, device="cpu").plan.tp
                      for case, path in list(paths.items())[:1]}
    if tp == 2:
        plan = ExecutionPlan.build(_cfg(), _policy("int4"), backend="reference",
                                   kv_bits=8, tp=2)
        model = deploy(torch.load(fp_path), plan, CALIB, device="cpu")
        wq = model.params["layers"][0]["attn"]["wq"]["wq"]
        out["tp2_wq_cols"] = int(wq.shape[-1])
        out["tp2_built"] = _serve(model)
        model.save(tp2_path)
        out["tp2_as_saved"] = _serve(DeployedModel.load(tp2_path, device="cpu"))
    else:
        out["tp2_resharded"] = _serve(DeployedModel.load(tp2_path, tp=tp, device="cpu"))
    return out


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """tp -> rank 0's results; plus the tp=1-saved artifact paths."""
    tmp = tmp_path_factory.mktemp("tp_grid")
    cfg = _cfg()
    fp = _fp_params(cfg)
    fp_path = str(tmp / "fp.pt")
    torch.save(fp, fp_path)
    paths = {}
    deployed = {w: deploy(fp, ExecutionPlan.build(cfg, _policy(w), backend="reference"),
                          CALIB, device="cpu").params for w in ("int8", "int4")}
    for w, kv, paging in GRID:
        plan = ExecutionPlan.build(cfg, _policy(w), backend="reference",
                                   kv_bits=kv, kv_paging=paging)
        path = str(tmp / f"{w}_kv{kv}_{paging}")
        DeployedModel(plan=plan, params=deployed[w]).save(path)
        paths[(w, kv, paging)] = path
    from repro_torch.models.bert import init_bert_classifier, tinybert_config
    bcfg = tinybert_config(num_classes=2, layers=2, d=64, heads=4, d_ff=128, vocab=256)
    bplan = ExecutionPlan.build(bcfg, QuantPolicy(num_layers=2, mode="int", last_k_int4=1),
                                backend="reference", mode="encoder", prefill_batch=4)
    paths["encoder"] = str(tmp / "encoder")
    deploy(init_bert_classifier(bcfg, 2, torch.Generator().manual_seed(1), "cpu"), bplan,
           CALIB, device="cpu").save(paths["encoder"])
    tp2_path = str(tmp / "saved_at_tp2")
    out = {"paths": paths, "tp2_path": tp2_path}
    for tp in (2, 1, 4):          # tp=2 writes the artifact the others read
        out[tp] = spawn_tp(_grid_rank, tp, paths, fp_path, tp2_path, device="cpu")
    return out


@pytest.mark.parametrize("case", GRID, ids=["-".join(map(str, c)) for c in GRID])
def test_tp_streams_are_byte_identical_to_tp1(grid, case):
    ref = grid[1][case]
    assert all(len(s) == 5 for s in ref["streams"])
    for tp in (2, 4):
        got = grid[tp][case]
        assert got["streams"] == ref["streams"], f"tp={tp} {case}"
        assert torch.equal(got["logits"], ref["logits"]), f"tp={tp} {case}"


def test_tp_encoder_results_are_bit_equal_to_tp1(grid):
    """The encoder plan (a bidirectional bert stack, its pooler and
    classifier replicated) at tp 2 and 4."""
    ref = grid[1]["encoder"]
    for tp in (2, 4):
        assert all(torch.equal(a, b) for a, b in zip(grid[tp]["encoder"], ref)), tp


def test_the_grid_ran_sharded_and_its_logits_see_every_precision(grid):
    """The ranks held tp's shards, and the logits compared bit for bit
    move with the weight and the KV precision (random weights this small
    leave the greedy tokens themselves unmoved)."""
    assert {grid[tp]["tp_seen"][GRID[0]] for tp in (1, 2, 4)} == {1, 2, 4}
    assert grid[2]["tp2_wq_cols"] == _cfg().num_heads * _cfg().hd // 2
    ref = grid[1]
    for a, b in ((("int8", 16, "dense"), ("int4", 16, "dense")),
                 (("int4", 16, "dense"), ("int4", 8, "dense")),
                 (("int4", 8, "dense"), ("int4", 4, "dense"))):
        assert not torch.equal(ref[a]["logits"], ref[b]["logits"]), (a, b)


def test_tp2_artifact_reshards_both_ways_with_tp1_arrays(grid):
    built = grid[2]["tp2_built"]
    assert grid[2]["tp2_as_saved"]["streams"] == built["streams"]
    for tp in (1, 4):
        got = grid[tp]["tp2_resharded"]
        assert got["streams"] == built["streams"]
        assert torch.equal(got["logits"], built["logits"])
    # the tp=2 deploy saved the same logical arrays as the tp=1 deploy
    assert built["streams"] == grid[1][("int4", 8, "dense")]["streams"]
    import json

    from repro_torch.checkpoint import manager as ckpt
    a, meta = ckpt.load_artifact(grid["tp2_path"])
    b, meta1 = ckpt.load_artifact(grid["paths"][("int4", 8, "dense")])
    assert meta["build"]["tp"] == 2 and meta1["build"]["tp"] == 1
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k
    assert json.dumps(meta["cfg"], sort_keys=True) == json.dumps(meta1["cfg"], sort_keys=True)


def test_a_tp_layout_outside_its_group_raises(grid):
    with pytest.raises(RuntimeError, match="tp=2 needs a process group of 2 "
                                           "ranks, this process has 1"):
        DeployedModel.load(grid["tp2_path"], device="cpu")
    plan = ExecutionPlan.build(_cfg(), _policy("int4"), backend="reference", tp=4)
    with pytest.raises(RuntimeError, match="tp=4 needs a process group of 4 ranks"):
        plan.make_group("cpu")
    with pytest.raises(RuntimeError, match="tp=4 needs a process group of 4 ranks"):
        deploy(_fp_params(_cfg()), plan, device="cpu")
    model = DeployedModel.load(grid["tp2_path"], tp=1, device="cpu")
    assert model.plan.tp == 1 and "tp=" not in model.plan.describe()
    assert "tp=4, " in plan.describe()


def test_make_tp_group_refuses_missing_cards():
    if torch.cuda.device_count() >= 64:
        pytest.skip("a host with 64 cards")
    with pytest.raises(RuntimeError, match=f"tp=64 needs 64 devices, host has "
                                           f"{torch.cuda.device_count()}"):
        make_tp_group(64, "cuda")
    with pytest.raises(RuntimeError, match="needs 64 devices"):
        spawn_tp(_serve, 64, None, device="cuda")


# ------------------------------------------------------------ the MoE grid
MOE_CASES = ("granite-moe-3b-a800m", "granite-moe-3b-a800m-sorted", "qwen2-moe-a2.7b")


def _moe_cfg(case: str):
    cfg = reduced(get_config(case.replace("-sorted", "")))
    return cfg.replace(moe_impl="sorted") if case.endswith("-sorted") else cfg


def _moe_rank(paths: dict) -> dict:
    """One rank of a tp degree: every MoE artifact resharded to it and
    served, with this rank's expert shard shapes."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = {}
    for case, path in paths.items():
        model = DeployedModel.load(path, tp=dist.get_world_size(), device="cpu")
        moe = model.params["layers"][0]["moe"]
        out[case] = {**_serve(model),
                     "shapes": {k: tuple(moe[k]["wq"].shape) for k in ("w1", "w3", "w2")},
                     "router": tuple(moe["router"].shape)}
    return out


@pytest.fixture(scope="module")
def moe_grid(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_moe")
    paths = {}
    for case in MOE_CASES:
        cfg = _moe_cfg(case)
        plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=4, mode="int",
                                                    last_k_int4=2),
                                   backend="reference", kv_bits=8)
        paths[case] = str(tmp / case)
        deploy(_fp_params(cfg), plan, CALIB, device="cpu").save(paths[case])
    return {tp: spawn_tp(_moe_rank, tp, paths, device="cpu") for tp in (1, 2, 4)}


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_tp_streams_and_logits_are_bit_equal_to_tp1(moe_grid, case):
    """Sharded experts at tp 2 and 4 serve tp=1's streams, and every
    decode step's logits to the bit."""
    ref = moe_grid[1][case]
    assert all(len(s) == 5 for s in ref["streams"])
    for tp in (2, 4):
        got = moe_grid[tp][case]
        assert got["streams"] == ref["streams"], f"tp={tp} {case}"
        assert torch.equal(got["logits"], ref["logits"]), f"tp={tp} {case}"


def test_moe_tp_ranks_hold_expert_slices(moe_grid):
    """A rank holds 1/tp of every expert's w1 / w3 columns and of its w2's
    rows (W8A8 layers 0-1, int8 codes), and the whole router."""
    for case in MOE_CASES:
        cfg = _moe_cfg(case)
        E, d, f = cfg.num_experts, cfg.d_model, cfg.expert_d_ff
        for tp in (1, 2, 4):
            got = moe_grid[tp][case]
            assert got["shapes"] == {"w1": (2, E, d, f // tp), "w3": (2, E, d, f // tp),
                                     "w2": (2, E, f // tp, d)}, (case, tp)
            assert got["router"] == (2, d, E)


def test_moe_tp_plans_build_as_jax_builds_them():
    """JAX's ``_validate_tp`` admits MoE at the reference backend; so does
    the port's, at tp 2 and 4, and both refuse the kernel backend."""
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.core.policy import QuantPolicy as JQuantPolicy
    from repro.deploy import ExecutionPlan as JExecutionPlan
    for arch in ("granite-moe-3b-a800m", "qwen2-moe-a2.7b"):
        cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
        for backend, tp in (("reference", 2), ("reference", 4), ("cuda", 2)):
            pol = QuantPolicy(num_layers=4, mode="int", last_k_int4=2)
            jpol = JQuantPolicy(num_layers=4, mode="int", last_k_int4=2)
            got = _outcome(lambda: ExecutionPlan.build(cfg, pol, backend=backend, tp=tp))
            want = _outcome(lambda: JExecutionPlan.build(
                jcfg, jpol, backend={"cuda": "pallas"}.get(backend, backend), tp=tp))
            assert (got is None) == (want is None), (arch, backend, tp, got, want)
            if want is not None:
                assert "single-device" in got and "single-device" in want


# ------------------------------------------------------ the head count
HEAD_SHAPES = [((4, 4, 100, 16), 2), ((8, 32, 448, 80), 2), ((8, 32, 448, 80), 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,tp", HEAD_SHAPES,
                         ids=[f"{s[0]}x{s[1]}x{s[2]}x{s[3]}-tp{tp}" for s, tp in HEAD_SHAPES])
@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_plain_attention_bits_do_not_depend_on_the_head_count(step, shape, tp, dtype):
    """Each rank's heads through ``rank_attention`` (what a tp rank runs)
    concatenate to the all-heads result, bit for bit, at the shapes where
    a probe saw a batched contraction over H / tp heads differ
    (decode: one query over a cache of T; prefill: T queries, causal)."""
    B, H, T, hd = shape
    g = torch.Generator().manual_seed(H + T)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dtype)
    k, v = rnd(B, T, H, hd), rnd(B, T, H, hd)
    w = H // tp
    cut = lambda x, r: x[:, :, r * w:(r + 1) * w]
    if step == "prefill":
        q = rnd(B, T, H, hd)
        full = full_attention(q, k, v, causal=True)
        parts = [rank_attention(full_attention, r, tp, cut(q, r), cut(k, r), cut(v, r),
                                causal=True) for r in range(tp)]
        if H == 4:          # the encoder's masked form, on the small shape
            kv_len = torch.randint(1, T + 1, (B,), generator=g).reshape(-1, 1, 1, 1)
            masked = full_attention(q, k, v, causal=False, kv_len=kv_len)
            mparts = [rank_attention(full_attention, r, tp, cut(q, r), cut(k, r),
                                     cut(v, r), causal=False, kv_len=kv_len)
                      for r in range(tp)]
            assert torch.equal(torch.cat(mparts, dim=2), masked)
    else:
        q, kn, vn = rnd(B, 1, H, hd), rnd(B, 1, H, hd), rnd(B, 1, H, hd)
        length = torch.randint(0, T + 1, (B,), generator=g).to(torch.int32)
        full = cached_decode_attention(q, k, v, kn, vn, length)
        parts = [rank_attention(cached_decode_attention, r, tp, cut(q, r), cut(k, r),
                                cut(v, r), cut(kn, r), cut(vn, r), length)
                 for r in range(tp)]
    assert torch.equal(torch.cat(parts, dim=2), full)


@pytest.mark.parametrize("tp", [2, 4])
def test_chunked_plain_attention_bits_do_not_depend_on_the_head_count(tp):
    """The reference path of long forwards (GQA: 8 query heads on 4 KV
    heads, so each rank keeps whole groups)."""
    g = torch.Generator().manual_seed(tp)
    q = torch.randn(2, 128, 8, 16, generator=g)
    k, v = torch.randn(2, 128, 4, 16, generator=g), torch.randn(2, 128, 4, 16, generator=g)
    full = chunked_attention(q, k, v, causal=True, chunk=32, use_kernel=False)
    w, wk = 8 // tp, 4 // tp
    parts = [rank_attention(chunked_attention, r, tp, q[:, :, r * w:(r + 1) * w],
                            k[:, :, r * wk:(r + 1) * wk], v[:, :, r * wk:(r + 1) * wk],
                            causal=True, chunk=32, use_kernel=False) for r in range(tp)]
    assert torch.equal(torch.cat(parts, dim=2), full)


def test_rank_attention_is_the_attention_itself_at_tp1():
    q = torch.randn(1, 3, 2, 4)
    assert torch.equal(rank_attention(full_attention, 0, 1, q, q, q, causal=True),
                       full_attention(q, q, q, causal=True))


# ------------------------------------------------------ validation parity
def _validation_cases():
    """(name, cfg edits, backend, policy mode or None, act_bits, w4) rows;
    each runs at tp 1, 2, 3 and 4."""
    rows = []
    for backend in ("reference", "cuda"):
        for mode in (None, "fake", "int"):
            for act_bits in (None, 0, 4):
                if act_bits is not None and mode is None:
                    continue
                rows.append((f"{backend}-{mode}-a{act_bits}", {}, backend, mode,
                             act_bits, True))
    for name, edits, w4 in (("heads6", dict(num_heads=6, num_kv_heads=6), False),
                            ("kv2", dict(num_kv_heads=2), True),
                            ("dff96", dict(d_ff=96), False),
                            ("dff100", dict(d_ff=100), False),
                            ("hd3_int4", dict(num_heads=2, num_kv_heads=2, head_dim=3,
                                              d_ff=6), True),
                            ("hd3_int8", dict(num_heads=2, num_kv_heads=2, head_dim=3,
                                              d_ff=6), False)):
        rows.append((name, edits, "reference", "int", None, w4))
    return rows


VALIDATION = _validation_cases()


def _outcome(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


KEY_PHRASES = ("single-device", "no sharding rules", "DEPLOYED integer",
               "integer accumulation", "does not divide", "2*tp")


@pytest.mark.parametrize("row", VALIDATION, ids=[r[0] for r in VALIDATION])
def test_plan_build_accepts_the_tp_plans_jax_accepts(row):
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.core.policy import QuantPolicy as JQuantPolicy
    from repro.deploy import ExecutionPlan as JExecutionPlan
    _, edits, backend, mode, act_bits, w4 = row
    cfg = _cfg().replace(**edits)
    jcfg = jreduced(jget_config("stablelm-3b")).replace(**edits)
    k4 = 2 if w4 else 0
    pol = None if mode is None else QuantPolicy(num_layers=4, mode=mode, last_k_int4=k4)
    jpol = None if mode is None else JQuantPolicy(num_layers=4, mode=mode, last_k_int4=k4)
    jbackend = {"cuda": "pallas"}.get(backend, backend)
    for tp in (1, 2, 3, 4):
        got = _outcome(lambda: ExecutionPlan.build(cfg, pol, backend=backend,
                                                   act_bits=act_bits, tp=tp))
        want = _outcome(lambda: JExecutionPlan.build(jcfg, jpol, backend=jbackend,
                                                     act_bits=act_bits, tp=tp))
        if mode == "fake" and backend == "reference" and tp > 1:
            # the port's fake-quant plan takes tp as the model ranks of its
            # sharded training step; JAX trains under GSPMD with no tp plan
            # and refuses one. The port refuses only a tp its dims (4 heads,
            # d_ff 128) do not divide
            assert "DEPLOYED integer" in want, (tp, want)
            assert (got is None) == (4 % tp == 0), (tp, got)
            assert got is None or "does not divide" in got, (tp, got)
            continue
        assert (got is None) == (want is None), (tp, got, want)
        if want is not None:
            phrase = [p for p in KEY_PHRASES if p in want]
            # a rule outside _validate_tp (act_bits=0 on the kernels) names
            # the same knob in both packages
            assert all(p in got for p in phrase), (tp, got, want)
            if not phrase:
                assert "act_bits=0" in got and "act_bits=0" in want


@pytest.mark.parametrize("family", ["xlstm", "hybrid", "encdec"])
def test_validate_tp_refuses_token_only_families_as_jax_does(family):
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.deploy import plan as jplan
    from repro_torch.deploy import plan as tplan
    cfg = _cfg().replace(family=family)
    jcfg = jreduced(jget_config("stablelm-3b")).replace(family=family)
    pol = QuantPolicy(num_layers=4, mode="int", last_k_int4=2)
    got = _outcome(lambda: tplan._validate_tp(cfg, pol, "reference", None, (), 2))
    want = _outcome(lambda: jplan._validate_tp(jcfg, pol, "reference", None, (), 2))
    assert got is not None and want is not None
    assert "no sharding rules" in got and "no sharding rules" in want
    assert tplan.TOKEN_ONLY_FAMILIES == jplan.TOKEN_ONLY_FAMILIES


# ----------------------------------------------------------- spec parity
def _jax_axis(spec):
    return spec.index("model") if "model" in spec else None


def _deployed(w: str, encoder: bool = False):
    if encoder:
        from repro_torch.models.bert import init_bert_classifier, tinybert_config
        cfg = tinybert_config(num_classes=2, layers=2, d=64, heads=4, d_ff=128, vocab=256)
        plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=2, mode="int",
                                                    last_k_int4=2 if w == "int4" else 0),
                                   backend="reference", mode="encoder")
        return deploy(init_bert_classifier(cfg, 2, torch.Generator().manual_seed(0), "cpu"),
                      plan, device="cpu").params
    if w == "moe":
        cfg = reduced(get_config("qwen2-moe-a2.7b"))
        plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=4, mode="int",
                                                    last_k_int4=2), backend="reference")
        return deploy(api.init_model(cfg, torch.Generator().manual_seed(0), "cpu"), plan,
                      device="cpu").params
    cfg = reduced(get_config("llava-next-mistral-7b")).replace(tie_embeddings=False)
    plan = ExecutionPlan.build(cfg, _policy(w) if w != "mixed" else
                               QuantPolicy(num_layers=4, mode="int", last_k_int4=2),
                               backend="reference")
    return deploy(api.init_model(cfg, torch.Generator().manual_seed(0), "cpu"), plan,
                  device="cpu").params


@pytest.mark.parametrize("which", ["int8", "int4", "mixed", "encoder_int4", "moe"])
def test_param_shard_axes_equal_jax_serving_specs(which):
    import jax
    from repro.distributed.sharding import serving_param_specs as jspecs
    params = _deployed(which.split("_")[-1], encoder=which.startswith("encoder"))
    np_tree = jax.tree.map(lambda a: a.numpy(), params,
                           is_leaf=lambda a: isinstance(a, torch.Tensor))
    want = dict(tree_leaves_with_path(jax.tree.map(_jax_axis, jspecs(np_tree),
                                   is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))))
    got = dict(tree_leaves_with_path(serving_param_specs(params)))
    assert got == want
    sharded = {"/".join(map(str, k)) for k, a in got.items() if a is not None}
    assert any(s.endswith("attn/wq/wq") for s in sharded)
    assert any(s.endswith("attn/wo/wq") for s in sharded)
    assert not any(s.startswith(("embed", "lm_head")) for s in sharded)
    if which == "moe":      # the experts and the shared expert shard; the router does not
        for site in ("moe/w1/wq", "moe/w2/wq", "moe/w3/s_w", "moe/shared/w2/wq"):
            assert any(s.endswith(site) for s in sharded), site
        assert not any("router" in s or "shared_gate" in s for s in sharded)


@pytest.mark.parametrize("tp", [2, 4, 3])
@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_state_shard_axes_equal_jax_serving_specs(kv_bits, tp):
    import jax
    from repro.distributed.sharding import serving_state_specs as jspecs
    cfg = _cfg()
    plan = ExecutionPlan.build(cfg, _policy("int4"), backend="reference", kv_bits=kv_bits)
    mesh = types.SimpleNamespace(shape={"model": tp})
    states = {"dense": plan.decode_state(2, 16, per_slot_len=True, device="cpu"),
              "pool": BlockPool(cfg, 1 << 16, kv_bits=kv_bits, device="cpu").bufs}
    for name, state in states.items():
        np_state = {k: v.numpy() for k, v in state.items()}
        want = {k: _jax_axis(s) for k, s in jspecs(np_state, mesh).items()}
        got = serving_state_specs(state, tp)
        assert got == want, name
        assert (got.get("k_q", got.get("k")) is None) == (tp == 3), name


def test_fused_projection_leaves_raise_naming_the_leaf():
    tree = {"layers": [{"attn": {"wqkv": {"wq": torch.zeros(2, 8, 24)}}}]}
    with pytest.raises(ValueError, match="layers/0/attn/wqkv/wq: fused projections"):
        serving_param_specs(tree)
