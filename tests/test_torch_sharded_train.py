"""The sharded QAT training step (``launch/train.build_train_step`` with
``TrainGroups``) on gloo ranks on the CPU, held against the port's
unsharded step and the JAX package's single-device ``build_train_step`` on
the same numpy arrays.

Layouts (the two of 2 ranks share ONE ``spawn_ranks``, the 4-rank one has
its own), each running every check of its layout:

* ``1x2``: tensor parallel over 2 model ranks: reduced stablelm-3b, the
  same with ``fused_proj`` (``wqkv`` / ``w13`` cut part by part),
  granite-moe-3b-a800m (vocab 250: the padded logits dropped from the
  gathered ones) and tinybert4; stablelm-3b's plain step also under the
  ste scale gradient; the collectives' forward and backward at world 2;
* ``2x1-fsdp``: 2 data ranks with FSDP (the layer stacks and their Adam
  moments cut over the data ranks): stablelm-3b and granite (its aux loss
  over the whole batch); ``run_training`` one step with a checkpoint,
  which is written gathered and restores in the unsharded port;
* ``2x2-fsdp-seq``: data 2 x model 2 with FSDP and ``attn_seq_shard``
  (the chunk branch context-parallel): stablelm-3b.

Every config is the reduced arch cut to 2 layers (d 64), one W8A8 and one
W4A4 layer, 4 rows: stablelm-3b's of S = 128 past the reduced chunk
threshold of 64 (chunk 32), the others' of 32. Each case runs one step,
plain and MINI-distilled (a 2-layer fp teacher, whole on every rank), and
is held to the port's unsharded step, and to JAX's jitted step for
``JAX_CASES`` (both of stablelm-3b's, granite's plain and tinybert4's
distilled: each compile costs seconds):

* the loss and its parts within rtol 1e-5 of the unsharded port's and of
  JAX's: the sharded forward sums the same products in another order
  (row-parallel partial sums, the data ranks' means), so float32 rounding
  moves the loss by about 1e-7 relative; a part near 0 (MINI's KL of two
  nearly equal relation distributions, about 3e-4) is a difference of
  nearly equal logs, whose rounding is absolute, so the parts also pass
  within atol 1e-8 (about 4e-9 seen);
* every gradient leaf (gathered, averaged over the data ranks) within
  ||delta|| / ||g|| <= 1e-4 of the unsharded port's, and the first Adam
  moment (the clipped gradient times 1 - b1) within the same of JAX's:
  norm-based, because a fake-quant code that flips when a float sum
  changes order moves one activation's gradient, not the whole leaf (the
  runs here show at most 6.4e-6 against the port, 1.0e-5 against JAX).
  A key bias's gradient is 0 in exact arithmetic (a softmax row does not
  change when one constant joins all its scores), so tinybert4's
  ``wk/b`` holds only rounding residue (1.2e-12 of the whole gradient's
  norm, 5e-10 distilled), which two runs round differently: a leaf below
  1e-8 of the whole norm is residue, may only be ``wk/b``, and must be
  residue in both runs (the smallest true leaf seen, ``wk/s_a`` under
  ste, is 2.5e-8);
* the Adam step, gathered into JAX's tree layout (same keys and shapes):
  per leaf ||dp - dp_ref|| / ||dp_ref|| <= 1e-2, with dp the params after
  the step less the params before it, for every leaf but a residue one
  (whose step follows its residue). The first step is about
  lr g / (|g| + eps), +-lr where |g| >> eps, so a skipped or misapplied
  update reads about 1: skipping the norm scales' update in the sharded
  step read 1.0, summing an FSDP layer's gradient onto the wrong data
  rank 1.48 (each planted in a copy of the code). The sound runs read at
  most 1.4e-3: where |g| nears eps (1e-8) the step follows the
  gradient's rounding at a gain of up to lr / eps (one element of
  ``wq/s_w`` with |g| 2.3e-8 here, 2.5e-8 in JAX, stepped 6.98e-4 against
  7.12e-4), and the params round to float32 after the step;
* one bf16 step (stablelm-3b at model 2) against the unsharded bf16 step:
  the loss within rtol 1e-3 (7.6e-5 seen), every gradient leaf within
  ||delta|| / ||g|| <= 0.5 (0.17 seen, on ``ffn/w2/w``; the planted faults
  above read 1.0 to 1.58). A row-parallel product's partials round to
  bf16 before their sum, where the unsharded product rounds once; that
  flips activation codes downstream, so the gap is bf16's own noise: the
  unsharded bf16 step differs from the f32 one by up to 0.63 a leaf. The
  bf16 Adam step is not held: its sign flips read 0.43, too near a
  fault's 1.0 to tell them apart.

The student is calibrated (weight and activation scales) before the step,
as training does: at the scales' init of 1 no block weight gets a
gradient, and these checks would hold only the norms, embeddings and
scales.

Refusals: a dim the rules cut that does not divide (per token-mode family
by name, each of whose reduced configs builds at model 2); a sharded step
without its specs. The token-mode families' sharded steps are held in
``test_torch_sharded_families.py``.

The ranks import this module by name, so it imports no JAX at the top.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import TrainHParams, get_config, reduced
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qat import (calibrate_act_scales, calibrate_weight_scales,
                                  default_bits_fn)
from repro_torch.core.tree import tree_leaves_with_path, tree_map
from repro_torch.deploy import ExecutionPlan
from repro_torch.distributed import gather_training, shard_training, training_specs
from repro_torch.launch.mesh import make_train_groups, spawn_ranks
from repro_torch.launch.train import (_mean_over_data, _norm_reduce, _plan_mode,
                                      _rows_of, build_train_step, gather_state,
                                      shard_state)
from repro_torch.models import api
from repro_torch.optim import adam_init, value_and_grad

#: name -> (arch, config edits, tokens a row): stablelm-3b past the reduced
#: chunk threshold of 64 (the chunk branch), the others below it
ARCHS = {"stablelm": ("stablelm-3b", {}, 128),
         "fused": ("stablelm-3b", {"fused_proj": True}, 32),
         "granite": ("granite-moe-3b-a800m", {"vocab_size": 250}, 32),
         "tinybert": ("tinybert4", {}, 32)}
#: name -> (data, model, fsdp, attn_seq_shard, archs)
LAYOUTS = {"1x2": (1, 2, False, False, ("stablelm", "fused", "granite", "tinybert")),
           "2x1-fsdp": (2, 1, True, False, ("stablelm", "granite")),
           "2x2-fsdp-seq": (2, 2, True, True, ("stablelm",))}
CASES = [(lay, name, d) for lay, (*_, names) in LAYOUTS.items() for name in names
         for d in ("plain", "distilled")]
#: the ranks each spawn runs: the two layouts of 2 ranks share one group
SPAWNS = {2: ("1x2", "2x1-fsdp"), 4: ("2x2-fsdp-seq",)}
#: the cases JAX's step is compiled for (each compile costs seconds): both
#: of stablelm-3b's, which every layout runs, and one of each other arch's
JAX_CASES = (("stablelm", "plain"), ("stablelm", "distilled"),
             ("granite", "plain"), ("tinybert", "distilled"))
HP = dict(total_steps=10, lr_weights=1e-3)
LOSS_RTOL = 1e-5
PART_ATOL = 1e-8
GRAD_TOL = 1e-4
#: a leaf whose gradient norm is below this of the whole tree's is rounding
#: residue; only a key bias's is (its exact gradient is 0)
RESIDUE = 1e-8
RESIDUE_LEAVES = {"layers/attn/wk/b"}
UPDATE_TOL = 1e-2
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_TOL = 0.5


def _cfg(name, seq_shard=False):
    arch, over, _ = ARCHS[name]
    return reduced(get_config(arch)).replace(num_layers=2, attn_seq_shard=seq_shard,
                                             **over)


def _policy(grad_mode="mse"):
    return QuantPolicy(num_layers=2, mode="fake", last_k_int4=1, grad_mode=grad_mode)


def _arrays(name):
    """numpy params (student seed 0, teacher seed 1) and a batch of 4 rows.
    The student is calibrated on the batch (weight and activation scales,
    as ``launch.train`` does): at the scales' init of 1 every N(0, 0.02)
    weight quantizes to 0, and no block weight would get a gradient."""
    cfg, S = _cfg(name), ARCHS[name][2]
    init = lambda seed: api.init_model(cfg, torch.Generator().manual_seed(seed), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    student = calibrate_weight_scales(init(0), default_bits_fn(cfg, _policy()))
    fp_plan = ExecutionPlan.build(cfg, None, mode=_plan_mode(cfg))
    fwd = lambda p, b: api.forward(p, fp_plan, tokens=torch.as_tensor(b["tokens"]))[0]
    student = calibrate_act_scales(student, cfg, _policy(), fwd, [batch])
    return _numpy(student), _numpy(init(1)), batch


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _numpy(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def _step(cfg, arrays, distill, groups=None, specs=None, grad_mode="mse"):
    """One step: (parts, grads, m, params after), the sharded ones gathered."""
    params, teacher, batch = arrays
    plan = ExecutionPlan.build(cfg, _policy(grad_mode), mode=_plan_mode(cfg),
                               tp=1 if groups is None else groups.model)
    kw = {}
    if distill:
        kw = dict(teacher=_torch(teacher),
                  teacher_plan=ExecutionPlan.build(cfg, None, mode=_plan_mode(cfg)))
    step = build_train_step(plan, TrainHParams(**HP), groups=groups, specs=specs, **kw)
    params = _torch(params)
    state = {"params": params, "opt": adam_init(params)}
    rows = batch
    if groups is not None:
        state = shard_state(state, specs, groups)
        rows = _rows_of(batch, groups)
    _, parts, grads = value_and_grad(step.loss_fn, state["params"], rows)
    if groups is not None:
        grads, parts = _mean_over_data(grads, parts, specs, groups)
        grads = gather_training(grads, specs, groups)
    p2, o2, metrics = step(state["params"], state["opt"], batch)
    state = {"params": p2, "opt": o2}
    if groups is not None:
        state = gather_state(state, specs, groups)
    return ({k: float(v) for k, v in metrics.items()}, _numpy(grads),
            _numpy(state["opt"].m), _numpy(state["params"]))


def _collectives(groups):
    """Each collective's forward and its input's gradient at world 2, on
    rank-dependent inputs (rank r holds r + 1 ...)."""
    from repro_torch.distributed import collectives as c
    r = groups.mp_rank
    x = torch.arange(4.0).reshape(2, 2) + 10 * r
    out = {}
    for name, fn in (("copy", lambda t: c.copy_to_model(t, groups)),
                     ("reduce", lambda t: c.reduce_from_model(t, groups)),
                     ("gather", lambda t: c.gather_from_model(t, 1, groups)),
                     ("gather_sum", lambda t: c.gather_from_model(t, 1, groups, sum_grad=True)),
                     ("scatter", lambda t: c.scatter_to_model(t, 1, groups)),
                     ("all_to_all", lambda t: c.all_to_all_model(t, 0, 1, groups))):
        xi = x.clone().requires_grad_(True)
        y = fn(xi)
        # a rank-dependent upstream gradient: rank r weights by r + 1
        (y * (r + 1) * torch.arange(1.0, y.numel() + 1).reshape(y.shape)).sum().backward()
        out[name] = (y.detach().numpy(), xi.grad.numpy())
    return out


def _spawn_rank(layouts, arrays, ckpt_dir):
    """One rank of every layout in ``layouts`` (one world size), in turn."""
    torch.set_num_threads(1)
    return {lay: _layout(lay, arrays, ckpt_dir) for lay in layouts}


def _layout(layout, arrays, ckpt_dir):
    from repro_torch.models import attention
    data, model, fsdp, seq, names = LAYOUTS[layout]
    groups = make_train_groups(data, model)
    calls = {"seq_shard": 0}
    real = attention.seq_shard_attention

    def counted(*a, **kw):
        calls["seq_shard"] += 1
        return real(*a, **kw)
    attention.seq_shard_attention = counted
    res = {"steps": {}, "norms": {}, "round_trip": {}}
    for name in names:
        cfg = _cfg(name, seq)
        specs = training_specs(_torch(arrays[name][0]), cfg, data=data, fsdp=fsdp)
        for d in ("plain", "distilled"):
            res["steps"][name, d] = _step(cfg, arrays[name], d == "distilled", groups, specs)
        # the clip's norm from the local slices, each leaf once
        params = _torch(arrays[name][0])
        full = {"g": tree_map(lambda t: t * 0.5 + 1.0, params)}["g"]
        local = shard_training(full, specs, groups)
        squares = [torch.sum(torch.square(t)) for _, t in tree_leaves_with_path(local)]
        res["norms"][name] = (float(torch.sqrt(_norm_reduce(specs, groups)(squares))),
                              float(torch.sqrt(sum(torch.sum(torch.square(t)) for _, t
                                                   in tree_leaves_with_path(full)))))
        back = gather_training(local, specs, groups)
        res["round_trip"][name] = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_leaves_with_path(back), tree_leaves_with_path(full)))
    res["seq_shard_calls"] = calls["seq_shard"]
    attention.seq_shard_attention = real
    if layout == "1x2":
        res["bf16"] = _step(_cfg("stablelm").replace(dtype="bfloat16"), arrays["stablelm"],
                            False, groups,
                            training_specs(_torch(arrays["stablelm"][0]), _cfg("stablelm")))
        res["ste"] = _step(_cfg("stablelm"), arrays["stablelm"], False, groups,
                           training_specs(_torch(arrays["stablelm"][0]), _cfg("stablelm")),
                           grad_mode="ste")
        res["collectives"] = _collectives(groups)
        # a vocabulary table whose rows do not divide: 5 rows over 2 ranks
        table = {"embed": torch.arange(10.0).reshape(5, 2)}
        tspecs = training_specs(table)
        cut = shard_training(table, tspecs, groups)
        res["padded"] = (cut["embed"].numpy(),
                         torch.equal(gather_training(cut, tspecs, groups)["embed"],
                                     table["embed"]))
    if layout == "2x1-fsdp":
        from repro_torch.data import SyntheticLM
        from repro_torch.launch.train import run_training
        cfg = _cfg("stablelm")
        data_set = SyntheticLM(cfg.vocab_size, 16, 4)
        params = _torch(arrays["stablelm"][0])
        state, _ = run_training(
            cfg, QuantPolicy(num_layers=2, mode="fake", last_k_int4=1),
            TrainHParams(**HP), lambda s0: map(data_set.batch, range(s0, 1)),
            ckpt_dir=ckpt_dir, ckpt_every=1, max_steps=1, device="cpu",
            params=params, groups=groups, fsdp=True, log_every=0)
        res["run_training_local_rows"] = int(state["params"]["layers"]["attn"]["wq"]["w"].shape[0])
    return res


# ------------------------------------------------------------------ fixtures
@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread runs them without contending
    with the suite's other workers for the cores (the ranks run at one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arrays():
    return {name: _arrays(name) for name in ARCHS}


@pytest.fixture(scope="module")
def unsharded(arrays):
    """The port's unsharded step on every case's arrays (and stablelm-3b's
    plain step under the ste scale gradient)."""
    out = {(name, d): _step(_cfg(name), arrays[name], d == "distilled")
           for name in ARCHS for d in ("plain", "distilled")}
    out["ste"] = _step(_cfg("stablelm"), arrays["stablelm"], False, grad_mode="ste")
    out["bf16"] = _step(_cfg("stablelm").replace(dtype="bfloat16"), arrays["stablelm"], False)
    return out


@pytest.fixture(scope="module")
def jax_steps(arrays):
    """JAX's single-device ``build_train_step`` (jitted) on the same arrays:
    (params after, first Adam moment, loss parts) per case."""
    import jax
    import jax.numpy as jnp
    from repro.configs import TrainHParams as JHP
    from repro.configs import get_config as jget
    from repro.configs import reduced as jred
    from repro.core.policy import QuantPolicy as JPol
    from repro.deploy import ExecutionPlan as JPlan
    from repro.launch.train import build_train_step as jbuild
    from repro.optim import adam_init as jadam_init
    out = {}
    for name, d in JAX_CASES:
        arch, over, _ = ARCHS[name]
        jcfg = jred(jget(arch)).replace(num_layers=2, **over)
        mode = "encoder" if jcfg.family == "bert" else "decode"
        params, teacher, batch = arrays[name]
        jp = jax.tree.map(jnp.asarray, params)
        jb = jax.tree.map(jnp.asarray, batch)
        kw = {}
        if d == "distilled":
            kw = dict(teacher=jax.tree.map(jnp.asarray, teacher),
                      teacher_plan=JPlan.build(jcfg, None, mode=mode))
        step = jax.jit(jbuild(JPlan.build(jcfg, JPol(num_layers=2, mode="fake",
                                                     last_k_int4=1), mode=mode),
                              JHP(**HP), **kw))
        p2, o2, parts = step(jp, jadam_init(jp), jb)
        out[name, d] = (jax.tree.map(np.asarray, p2), jax.tree.map(np.asarray, o2.m),
                        {k: float(v) for k, v in parts.items()})
    return out


@pytest.fixture(scope="module")
def runs(arrays, tmp_path_factory):
    """``runs(layout)``: that layout's ranks' results, spawned once."""
    cache = {}

    def get(lay):
        if lay not in cache:
            world = next(w for w, lays in SPAWNS.items() if lay in lays)
            ckpt = tmp_path_factory.mktemp(f"ckpt-{world}")
            res = spawn_ranks(_spawn_rank, 1, world, SPAWNS[world], arrays, str(ckpt),
                              device="cpu")
            for name, r in res.items():
                cache[name] = {**r, "ckpt": str(ckpt)}
        return cache[lay]
    return get


def _flat(tree) -> dict:
    return {"/".join(map(str, k)): np.asarray(v) for k, v in tree_leaves_with_path(tree)}


def _rel(a, b) -> float:
    return float(np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-30))


def _norm(a) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64).ravel()))


def _residue(tree) -> set:
    """The leaves whose norm is below RESIDUE of the whole tree's."""
    flat = _flat(tree)
    whole = float(np.sqrt(sum(_norm(v) ** 2 for v in flat.values())))
    return {k for k, v in flat.items() if _norm(v) < RESIDUE * whole}, whole


def _assert_trees(got, want, tol, what, allowed=RESIDUE_LEAVES):
    """Per leaf ||got - want|| / ||want|| <= tol; a residue leaf of
    ``want`` must be one of ``allowed`` and residue in ``got`` too."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    residue, whole = _residue(want)
    assert residue <= allowed, (what, residue)
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        if k in residue:
            assert _norm(got[k]) < RESIDUE * whole, (what, k, _norm(got[k]), whole)
        else:
            assert _rel(got[k], want[k]) <= tol, (what, k, _rel(got[k], want[k]))


def _assert_updates(got, want, before, what, grads=None):
    """Per leaf ||(got - before) - (want - before)|| / ||want - before||
    <= UPDATE_TOL, but for the leaves whose gradient in ``grads`` is
    residue (their step follows the residue)."""
    got, want, before = _flat(got), _flat(want), _flat(before)
    assert sorted(got) == sorted(want) == sorted(before), what
    residue = _residue(grads)[0] if grads is not None else set()
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        if k not in residue:
            step = want[k] - before[k]
            assert _rel(got[k] - before[k], step) <= UPDATE_TOL, (
                what, k, _rel(got[k] - before[k], step))


# ------------------------------------------------------------------- the step
@pytest.mark.parametrize("lay,name,d", CASES, ids=[f"{a}-{b}-{c}" for a, b, c in CASES])
def test_sharded_step_matches_unsharded_and_jax(runs, lay, name, d, unsharded, jax_steps,
                                                arrays):
    parts, grads, m, params = runs(lay)["steps"][name, d]
    u_parts, u_grads, u_m, u_params = unsharded[name, d]
    total = "loss/total" if d == "distilled" else "loss/train"
    refs = [("the unsharded port", u_parts, u_m, u_params)]
    if (name, d) in jax_steps:
        j_params, j_m, j_parts = jax_steps[name, d]
        refs.append(("JAX", j_parts, j_m, j_params))
    for who, r_parts, r_m, r_params in refs:
        assert sorted(parts) == sorted(r_parts), who
        np.testing.assert_allclose(parts[total], r_parts[total], rtol=LOSS_RTOL, err_msg=who)
        for k in parts:
            np.testing.assert_allclose(parts[k], r_parts[k], rtol=LOSS_RTOL,
                                       atol=PART_ATOL, err_msg=f"{who} {k}")
        _assert_trees(m, r_m, GRAD_TOL, f"first Adam moment vs {who}")
        _assert_updates(params, r_params, arrays[name][0], f"Adam step vs {who}", u_grads)
    _assert_trees(grads, u_grads, GRAD_TOL, "grads vs the unsharded port")


def test_ste_scale_gradient_sums_the_row_parallel_shares(runs, unsharded, arrays):
    """The ste ``ds`` is linear in the upstream gradient: each rank's share
    over the whole K's count, summed, is the unsharded one."""
    parts, grads, _, params = runs("1x2")["ste"]
    u_parts, u_grads, _, u_params = unsharded["ste"]
    np.testing.assert_allclose(parts["loss/train"], u_parts["loss/train"], rtol=LOSS_RTOL)
    _assert_trees(grads, u_grads, GRAD_TOL, "ste grads")
    _assert_updates(params, u_params, arrays["stablelm"][0], "ste Adam step", u_grads)


def test_bf16_step_at_model_2_stays_within_bf16s_noise(runs, unsharded):
    """stablelm-3b in bf16 activations at model 2 against the unsharded
    bf16 step, to the bf16 gates the module's docstring sets out."""
    parts, grads, _, _ = runs("1x2")["bf16"]
    u_parts, u_grads, _, _ = unsharded["bf16"]
    np.testing.assert_allclose(parts["loss/train"], u_parts["loss/train"],
                               rtol=BF16_LOSS_RTOL)
    _assert_trees(grads, u_grads, BF16_GRAD_TOL, "bf16 grads")


@pytest.mark.parametrize("lay", list(LAYOUTS))
def test_clip_norm_counts_each_leaf_once_and_cuts_round_trip(runs, lay):
    res = runs(lay)
    for name, (sharded, whole) in res["norms"].items():
        np.testing.assert_allclose(sharded, whole, rtol=1e-6, err_msg=name)
        assert res["round_trip"][name], name


@pytest.mark.parametrize("lay", list(LAYOUTS))
def test_context_parallel_attention_runs_only_under_attn_seq_shard(runs, lay):
    data, model, fsdp, seq, names = LAYOUTS[lay]
    # each case: two forwards (the gradients, then the step) of 2 layers
    want = len(names) * 2 * 2 * 2 if seq else 0
    assert runs(lay)["seq_shard_calls"] == want


def test_collectives_forward_and_backward_at_world_2(runs):
    """Rank 0's view: x_r = arange(4).reshape(2, 2) + 10 r, upstream
    gradient (r + 1) * arange(1, n + 1)."""
    got = runs("1x2")["collectives"]
    a = lambda *rows: np.array(rows, dtype=np.float32)
    want = {"copy": (a([0, 1], [2, 3]), 3 * a([1, 2], [3, 4])),
            "reduce": (a([10, 12], [14, 16]), a([1, 2], [3, 4])),
            "gather": (a([0, 1, 10, 11], [2, 3, 12, 13]), a([1, 2], [5, 6])),
            "gather_sum": (a([0, 1, 10, 11], [2, 3, 12, 13]), 3 * a([1, 2], [5, 6])),
            "scatter": (a([0], [2]), a([1, 2], [2, 4])),
            "all_to_all": (a([0, 1, 10, 11]), a([1, 2], [2, 4]))}
    assert sorted(got) == sorted(want)
    for name, (y, g) in want.items():
        np.testing.assert_array_equal(got[name][0], y, err_msg=name)
        np.testing.assert_array_equal(got[name][1], g, err_msg=name)


def test_a_table_whose_rows_do_not_divide_is_padded_and_gathered_back(runs):
    local, round_trip = runs("1x2")["padded"]
    np.testing.assert_array_equal(local, np.arange(6.0, dtype=np.float32).reshape(3, 2))
    assert round_trip


def test_run_training_checkpoints_the_gathered_tree(runs, arrays, tmp_path):
    """``run_training`` over data 2 with FSDP: one step, its checkpoint the
    full tree (the unsharded port restores it), equal to the unsharded
    loop's."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import run_training
    res = runs("2x1-fsdp")
    assert res["run_training_local_rows"] == 1          # 2 layers over 2 data ranks
    cfg = _cfg("stablelm")
    data_set = SyntheticLM(cfg.vocab_size, 16, 4)
    params = _torch(arrays["stablelm"][0])
    state, _ = run_training(cfg, QuantPolicy(num_layers=2, mode="fake", last_k_int4=1),
                            TrainHParams(**HP), lambda s0: map(data_set.batch, range(s0, 1)),
                            ckpt_dir=str(tmp_path), ckpt_every=0, max_steps=1,
                            device="cpu", params=params, log_every=0)
    like = {"params": _torch(arrays["stablelm"][0]), "opt": adam_init(params)}
    restored, step = CheckpointManager(res["ckpt"]).restore(like)
    assert step == 1 and int(restored["opt"].step) == 1
    _assert_updates(_numpy(restored["params"]), _numpy(state["params"]),
                    arrays["stablelm"][0], "checkpointed params")


#: per token-mode family: config edits that leave a dim the training rules
#: cut indivisible over ``tp`` model ranks, and the dim the refusal names
FAMILY_REFUSALS = {
    "xlstm-1.3b": [({"num_heads": 3}, 2, "num_heads=3")],
    "zamba2-2.7b": [({"ssm_head_dim": 64}, 4, r"ssm_expand\*d_model/ssm_head_dim=2"),
                    ({"num_heads": 2, "num_kv_heads": 2}, 4, "num_heads=2"),
                    ({"d_ff": 130}, 4, "d_ff=130")],
    "seamless-m4t-medium": [({"num_kv_heads": 2}, 4, "num_kv_heads=2"),
                            ({"d_ff": 130}, 4, "d_ff=130")]}


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-2.7b", "seamless-m4t-medium"])
def test_token_mode_families_are_refused_over_model_ranks(arch):
    """The token-mode families train over model ranks (each reduced config
    builds at tp=2, and serving them at tp=2 stays refused, as JAX refuses
    it); a training plan is refused where a dim the rules cut does not
    divide over the model ranks, naming the dim and the arch."""
    from repro_torch.deploy.plan import _segment_units
    cfg = reduced(get_config(arch))
    pol = QuantPolicy(num_layers=_segment_units(cfg), mode="fake")
    assert ExecutionPlan.build(cfg, pol, tp=2).tp == 2
    with pytest.raises(ValueError, match=f"no sharding rules for family '{cfg.family}'"):
        ExecutionPlan.build(cfg, QuantPolicy(num_layers=_segment_units(cfg), mode="int"),
                            tp=2)
    for edit, tp, dim in FAMILY_REFUSALS[arch]:
        with pytest.raises(ValueError, match=rf"tp={tp} does not divide {dim}: .*{arch}"):
            ExecutionPlan.build(cfg.replace(**edit), pol, tp=tp)


def test_dims_that_do_not_divide_and_a_step_without_specs_are_refused():
    cfg = _cfg("stablelm")
    pol = QuantPolicy(num_layers=2, mode="fake")
    with pytest.raises(ValueError, match="tp=3 does not divide num_heads=4"):
        ExecutionPlan.build(cfg, pol, tp=3)
    groups = type("G", (), {"model": 2})()
    with pytest.raises(ValueError, match="training specs"):
        build_train_step(ExecutionPlan.build(cfg, pol, tp=2), TrainHParams(), groups=groups)
