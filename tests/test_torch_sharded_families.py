"""The sharded QAT step of the token-mode families (xlstm-1.3b's mLSTM /
sLSTM, zamba2-2.7b's Mamba2 + shared block, seamless-m4t-medium's
encoder-decoder) on gloo ranks on the CPU, held against the port's
unsharded step and the JAX package's single-device ``build_train_step`` on
the same numpy arrays.

Layouts (the two of 2 ranks share ONE ``spawn_ranks``, the 4-rank one has
its own), each running every family, plain and MINI-distilled (the
xLSTM's hidden-state loss):

* ``1x2``: tensor parallel over 2 model ranks;
* ``2x1-fsdp``: 2 data ranks with FSDP (the group stacks, the encoder and
  decoder stacks and their Adam moments cut over the data ranks);
* ``2x2-fsdp``: data 2 x model 2 with FSDP.

Every config is the reduced arch (d 64): two groups (xlstm: 2 x (mLSTM,
sLSTM), 2 heads; zamba2: 2 x (2 Mamba2 layers, the shared block), 8 SSM
heads), or 2 + 2 encoder and decoder layers; one W8A8 and one W4A4 unit;
4 rows of 16 tokens (the encoder-decoder's ``src_embeds`` 4 x 24). The
student is calibrated first (at the scales' init of 1 no block weight gets
a gradient). Each step is held to the port's unsharded step, and to JAX's
jitted step for ``JAX_CASES`` (one a family), by
``test_torch_sharded_train``'s checks and tolerances: the loss within
rtol 1e-5 and its parts within atol 1e-8; every gathered gradient leaf and
the first Adam moment within ||delta|| / ||g|| <= 1e-4; the Adam step per
leaf within 1e-2. Against JAX the first moment is held leaf by leaf
within 1e-4 beyond the unsharded port's own distance from JAX: on these
calibrated models the port's unsharded step differs from JAX's on a few
per-tensor activation-scale leaves by more than 1e-4 (``slstm/down/s_a``
3.0e-4, the encoder's ``attn/*/s_a`` 1.1e-4 on the CPU, every other leaf
within 2e-5): such a leaf's LSQ gradient sums the signed rounding residuals of
every input element, so ulp differences of XLA's and torch's
transcendentals can show in it, where the port's own 1-ulp perturbations
of the embedding move no leaf past 1.5e-5.
A replicated leaf a rank uses only in part (``conv_w``,
``a_log``, ``dt_bias``, ``d_skip``, ``ssm_norm``, ``headnorm``,
``w_gates``, ``r``, the sLSTM ``b``, ``in_bc`` / ``in_dt``) whose gradient
were summed twice, or not at all, would read about 1.0 there. The
encoder-decoder's key biases' gradients are rounding residue (a softmax
row does not change when one constant joins all its scores), as
tinybert4's are (``RESIDUE_LEAVES``).

The gathered trees round-trip ``shard_training`` / ``gather_training``
bit for bit, and the clip's norm from the slices counts each leaf once.
In a spawn of its own, ``run_training`` takes one FSDP step of reduced
xlstm-1.3b and zamba2-2.7b over 2 data ranks (FSDP over their group
stacks raised an IndexError before the family forwards took each group
from the rank that owns it).

The ranks import this module by name, so it imports no JAX at the top.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import TrainHParams, get_config, reduced
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qat import calibrate_weight_scales, default_bits_fn
from repro_torch.core.tree import tree_leaves_with_path, tree_map
from repro_torch.deploy import ExecutionPlan
from repro_torch.deploy.plan import _segment_units
from repro_torch.distributed import gather_training, shard_training, training_specs
from repro_torch.launch.mesh import make_train_groups, spawn_ranks
from repro_torch.launch.train import (_mean_over_data, _norm_reduce, _rows_of,
                                      build_train_step, gather_state, shard_state)
from repro_torch.models import api
from repro_torch.optim import adam_init, value_and_grad
from test_torch_sharded_train import (GRAD_TOL, HP, LOSS_RTOL, PART_ATOL,
                                      _assert_trees, _assert_updates, _flat, _numpy,
                                      _rel, _residue, _torch)

#: name -> arch (reduced)
ARCHS = {"xlstm": "xlstm-1.3b", "zamba2": "zamba2-2.7b",
         "seamless": "seamless-m4t-medium"}
#: name -> (data, model, fsdp)
LAYOUTS = {"1x2": (1, 2, False), "2x1-fsdp": (2, 1, True), "2x2-fsdp": (2, 2, True)}
CASES = [(lay, name, d) for lay in LAYOUTS for name in ARCHS
         for d in ("plain", "distilled")]
#: the ranks each spawn runs: the two layouts of 2 ranks share one group
SPAWNS = {2: ("1x2", "2x1-fsdp"), 4: ("2x2-fsdp",)}
#: the cases JAX's step is compiled for: one a family (each compile costs
#: seconds), the distilled ones where the family's taps differ
JAX_CASES = (("xlstm", "distilled"), ("zamba2", "plain"), ("seamless", "distilled"))
#: gradient leaves that are rounding residue (exactly 0 in exact
#: arithmetic): the encoder-decoder's key biases
RESIDUE_LEAVES = {"enc/attn/wk/b", "dec/self/wk/b", "dec/cross/wk/b"}
ROWS, TOKENS, SRC = 4, 16, 24


def _cfg(name):
    return reduced(get_config(ARCHS[name]))


def _policy(cfg):
    n = _segment_units(cfg)
    return QuantPolicy(num_layers=n, mode="fake", last_k_int4=n // 2)


def _inputs(b):
    return {k: torch.as_tensor(v) for k, v in b.items() if k != "labels"}


def _sites(cfg, policy):
    """The quantized linears of one cacheless forward, in call order: (the
    path of the ``s_a`` leaf, the index of the unit's entry in it, the
    activation bits)."""
    bits = lambda u: policy.act_bits(u) or 32
    out = []
    if cfg.family in ("xlstm", "hybrid"):
        G = _segment_units(cfg)
        per = cfg.num_layers // G
        for g in range(G):
            if cfg.family == "xlstm":
                for li in range(per - 1):
                    out += [(("mlstm", k), (g, li), bits(g))
                            for k in ("up", "wq", "wk", "wv", "down")]
                out += [(("slstm", k), (g,), bits(g)) for k in ("w_in", "down")]
                continue
            for li in range(per):
                out += [(("mamba", k), (g, li), bits(g))
                        for k in ("in_z", "in_x", "in_bc", "in_dt", "out_proj")]
            last = bits(G - 1)      # the shared block runs at the last unit's
            out += [(("shared", "attn", k), (), last) for k in ("wq", "wk", "wv", "wo")]
            out += [(("shared", "ffn", k), (), last) for k in ("w1", "w3", "w2")]
        return out
    attn = ("wq", "wk", "wv", "wo")
    for i in range(cfg.enc_layers):
        out += [(("enc", "attn", k), (i,), bits(0)) for k in attn]
        out += [(("enc", "ffn", k), (i,), bits(0)) for k in ("w1", "w2")]
    for i in range(cfg.dec_layers):
        out += [(("dec", blk, k), (i,), bits(i)) for blk in ("self", "cross") for k in attn]
        out += [(("dec", "ffn", k), (i,), bits(i)) for k in ("w1", "w2")]
    return out


def _calibrate_sites(params, cfg, policy, batch):
    """Each linear's activation scale from its own input (the 99.99th
    percentile of |x| over its calls, over its bits' l_max), recorded in
    the fp forward and then again in the fake-quant one: the port's
    token-mode calibration sets one global scale, at which these small
    models' mLSTM inputs quantize to 0, and the fp forward's inputs leave
    the shared block's ``w2`` codes all 0 in the fake-quant one; either
    way a linear would get no gradient."""
    for plan_policy in (None, policy):
        params = _record_sites(params, cfg, policy, batch,
                               ExecutionPlan.build(cfg, plan_policy))
    return params


def _record_sites(params, cfg, policy, batch, plan):
    from repro_torch.core import calibration
    from repro_torch.core.quantizer import qrange
    with calibration.calibration_mode() as cm, torch.no_grad():
        api.forward(params, plan, **_inputs(batch))
    sites = _sites(cfg, policy)
    assert len(cm.records) == len(sites)
    scales = {}
    for (path, idx, b), stat in zip(sites, cm.records):
        s = float(stat) / float(qrange(b)[1])
        scales[path, idx] = max(s, scales.get((path, idx), 0.0))
    for (path, idx), s in scales.items():
        node = params
        for k in path:
            node = node[k]
        node["s_a"][idx] = s
    return params


def _arrays(name):
    """numpy params (student seed 0, calibrated on the batch; teacher seed
    1) and a batch of ``ROWS`` rows."""
    cfg = _cfg(name)
    init = lambda seed: api.init_model(cfg, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (ROWS, TOKENS + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal((ROWS, SRC, cfg.d_model)).astype(np.float32)
    student = calibrate_weight_scales(init(0), default_bits_fn(cfg, _policy(cfg)))
    student = _calibrate_sites(student, cfg, _policy(cfg), batch)
    return _numpy(student), _numpy(init(1)), batch


def _step(cfg, arrays, distill, groups=None, specs=None):
    """One step: (parts, grads, m, params after), the sharded ones gathered."""
    params, teacher, batch = arrays
    plan = ExecutionPlan.build(cfg, _policy(cfg), tp=1 if groups is None else groups.model)
    kw = {}
    if distill:
        kw = dict(teacher=_torch(teacher), teacher_plan=ExecutionPlan.build(cfg, None))
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


def _run_training(name, groups, ckpt_dir):
    """``run_training`` over data 2 with FSDP: one step from seeded params
    on the train CLI's synthetic batches; its loss and the rows of the
    first group stack this rank holds, or the error it raised."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import run_training
    cfg = _cfg(name)
    data_set = SyntheticLM(cfg.vocab_size, TOKENS, ROWS)
    try:
        state, metrics = run_training(
            cfg, _policy(cfg), TrainHParams(**HP),
            lambda s0: map(data_set.batch, range(s0, 1)), ckpt_dir=f"{ckpt_dir}/{name}",
            ckpt_every=1, max_steps=1, device="cpu", groups=groups, fsdp=True,
            log_every=0)
    except Exception as e:      # reported by the test, not by the spawn
        return repr(e)
    stack = state["params"]["mlstm" if cfg.family == "xlstm" else "mamba"]
    return {"loss": metrics["loss/train"], "step": int(state["opt"].step),
            "local_groups": int(stack["norm"]["scale"].shape[0])}


def _spawn_rank(layouts, arrays, ckpt_dir):
    """One rank of every layout in ``layouts`` (one world size), in turn."""
    torch.set_num_threads(1)
    return {lay: _layout(lay, arrays, ckpt_dir) for lay in layouts}


def _layout(layout, arrays, ckpt_dir):
    data, model, fsdp = LAYOUTS[layout]
    groups = make_train_groups(data, model)
    res = {"steps": {}, "norms": {}, "round_trip": {}}
    for name in ARCHS:
        cfg = _cfg(name)
        specs = training_specs(_torch(arrays[name][0]), cfg, data=data, fsdp=fsdp)
        for d in ("plain", "distilled"):
            res["steps"][name, d] = _step(cfg, arrays[name], d == "distilled", groups, specs)
        full = tree_map(lambda t: t * 0.5 + 1.0, _torch(arrays[name][0]))
        local = shard_training(full, specs, groups)
        squares = [torch.sum(torch.square(t)) for _, t in tree_leaves_with_path(local)]
        res["norms"][name] = (float(torch.sqrt(_norm_reduce(specs, groups)(squares))),
                              float(torch.sqrt(sum(torch.sum(torch.square(t)) for _, t
                                                   in tree_leaves_with_path(full)))))
        back = gather_training(local, specs, groups)
        res["round_trip"][name] = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_leaves_with_path(back), tree_leaves_with_path(full)))
    return res


def _fsdp_rank(ckpt_dir):
    """One rank of data 2 with FSDP: ``run_training`` of reduced xlstm-1.3b
    and zamba2-2.7b (its own spawn, so that it runs on a tree whose
    sharded steps fail)."""
    torch.set_num_threads(1)
    groups = make_train_groups(2, 1)
    return {name: _run_training(name, groups, ckpt_dir) for name in ("xlstm", "zamba2")}


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
    return {(name, d): _step(_cfg(name), arrays[name], d == "distilled")
            for name in ARCHS for d in ("plain", "distilled")}


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
        jcfg = jred(jget(ARCHS[name]))
        n = _segment_units(_cfg(name))
        params, teacher, batch = arrays[name]
        jp = jax.tree.map(jnp.asarray, params)
        kw = {}
        if d == "distilled":
            kw = dict(teacher=jax.tree.map(jnp.asarray, teacher),
                      teacher_plan=JPlan.build(jcfg, None))
        step = jax.jit(jbuild(JPlan.build(jcfg, JPol(num_layers=n, mode="fake",
                                                     last_k_int4=n // 2)),
                              JHP(**HP), **kw))
        p2, o2, parts = step(jp, jadam_init(jp), jax.tree.map(jnp.asarray, batch))
        out[name, d] = (jax.tree.map(np.asarray, p2), jax.tree.map(np.asarray, o2.m),
                        {k: float(v) for k, v in parts.items()})
    return out


@pytest.fixture(scope="module")
def fsdp_runs(tmp_path_factory):
    return spawn_ranks(_fsdp_rank, 2, 1, str(tmp_path_factory.mktemp("fsdp")),
                       device="cpu")


@pytest.fixture(scope="module")
def runs(arrays, tmp_path_factory):
    """``runs(layout)``: that layout's ranks' results, spawned once."""
    cache = {}

    def get(lay):
        if lay not in cache:
            world = next(w for w, lays in SPAWNS.items() if lay in lays)
            ckpt = tmp_path_factory.mktemp(f"ckpt-{world}")
            cache.update(spawn_ranks(_spawn_rank, 1, world, SPAWNS[world], arrays,
                                     str(ckpt), device="cpu"))
        return cache[lay]
    return get


# ------------------------------------------------------------------- the step
@pytest.mark.parametrize("lay,name,d", CASES, ids=[f"{a}-{b}-{c}" for a, b, c in CASES])
def test_sharded_family_step_matches_unsharded_and_jax(runs, lay, name, d, unsharded,
                                                       jax_steps, arrays):
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
        _assert_updates(params, r_params, arrays[name][0], f"Adam step vs {who}", u_grads)
    _assert_trees(m, u_m, GRAD_TOL, "first Adam moment vs the unsharded port",
                  RESIDUE_LEAVES)
    _assert_trees(grads, u_grads, GRAD_TOL, "grads vs the unsharded port", RESIDUE_LEAVES)
    if (name, d) in jax_steps:
        _assert_near_jax(m, u_m, jax_steps[name, d][1])


def _assert_near_jax(m, u_m, j_m):
    """The sharded first Adam moment within ``GRAD_TOL`` of JAX's, leaf by
    leaf, beyond the unsharded port's own distance from JAX (a few
    activation-scale leaves, see the module docstring)."""
    got, port, want = _flat(m), _flat(u_m), _flat(j_m)
    assert sorted(got) == sorted(want)
    residue, whole = _residue(want)
    for k in want:
        if k in residue:
            assert k in RESIDUE_LEAVES, k
            continue
        assert _rel(got[k], want[k]) <= GRAD_TOL + _rel(port[k], want[k]), (
            k, _rel(got[k], want[k]), _rel(port[k], want[k]))


@pytest.mark.parametrize("lay", list(LAYOUTS))
def test_family_clip_norm_counts_each_leaf_once_and_cuts_round_trip(runs, lay):
    res = runs(lay)
    for name, (sharded, whole) in res["norms"].items():
        np.testing.assert_allclose(sharded, whole, rtol=1e-6, err_msg=name)
        assert res["round_trip"][name], name


@pytest.mark.parametrize("name", ["xlstm", "zamba2"])
def test_run_training_with_fsdp_over_data_ranks_takes_each_group_from_its_owner(
        fsdp_runs, name):
    """The group stacks (G = 2) cut over 2 data ranks: one row a rank, each
    group taken from the rank that owns it (before, the family forwards
    indexed the local stack by the global group and raised IndexError)."""
    got = fsdp_runs[name]
    assert isinstance(got, dict), got
    assert got["step"] == 1 and got["local_groups"] == 1 and np.isfinite(got["loss"])


def test_parted_projections_are_cut_part_by_part():
    """The mLSTM's ``up`` ([xi | z]) and the sLSTM's ``w_in`` ([i | f | z |
    o]) hold, on model rank r of 2, its half of every part."""
    cfg = _cfg("xlstm")
    params = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = training_specs(params, cfg)
    groups = type("G", (), {"model": 2, "data": 1, "mp_rank": 1, "dp_rank": 0})()
    local = shard_training(params, specs, groups)
    for path, parts in ((("mlstm", "up", "w"), 2), (("slstm", "w_in", "w"), 4),
                        (("slstm", "w_in", "s_w"), 4)):
        full, cut = params, local
        for k in path:
            full, cut = full[k], cut[k]
        want = torch.cat([p.chunk(2, dim=-1)[1] for p in full.chunk(parts, dim=-1)], -1)
        assert torch.equal(cut, want), path
