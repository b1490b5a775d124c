"""Port parity: the optimizer, the synthetic data, the QAT train step, the
checkpoint manager and the train CLI.

* ``adam_update``: one step from JAX's params, grads and ``AdamState``
  (carried across by ``params_from_numpy``), under the warm-up/decay
  schedule and global-norm clipping, within rtol 1e-6 / atol 1e-9 of JAX's
  params and moments, the step count equal; scales clamp at 1e-8 in both.
* ``SyntheticLM`` / ``SyntheticClassification`` batches bit-equal to JAX's
  (two hosts, several steps).
* One QAT + MINI step of ``launch.train.build_train_step`` (a reduced
  stablelm-3b student, W8A8 + W4A4 fake-quant, mse scale gradients, a
  deeper fp teacher) from JAX's params: the loss and its parts within rtol
  1e-5 of JAX's, every gradient within rtol 1e-4 / atol 1e-6 (relative to
  the leaf's largest gradient); ``run_training`` for three steps from the
  same params within rtol 1e-4 / atol 1e-6 of JAX's ``run_training``. The
  same for ``benchmarks/common``'s classifier loss and ``train_classifier``
  (a reduced TinyBERT4 with MINI and output KD).
* ``CheckpointManager``: round trip, keep-k, a JAX checkpoint (params and
  ``AdamState``) restores in the port and the port's in JAX; ``main`` with
  ``--reduced --device cpu``: 4 steps uninterrupted equal, bit for bit, 2
  steps stopped by SIGTERM (the preemption path) then a resume for 2 more.

Fixed seeds throughout.
"""
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCkpt
from repro.configs import TrainHParams as JHP
from repro.configs import get_config as jget
from repro.configs import reduced as jred
from repro.core.policy import QuantPolicy as JPol
from repro.data.synthetic import SyntheticClassification as JSC
from repro.data.synthetic import SyntheticLM as JSLM
from repro.optim import adam_init as jadam_init
from repro.optim import adam_update as jadam_update
from repro.optim import linear_warmup_decay as jsched
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainHParams, get_config, reduced
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.data import SyntheticClassification, SyntheticLM
from repro_torch.deploy import params_from_numpy
from repro_torch.optim import (AdamState, adam_init, adam_update,
                               group_for_path, linear_warmup_decay,
                               value_and_grad)

N = lambda tree: jax.tree.map(np.asarray, tree)


def _flat(tree) -> dict:
    return {"/".join(map(str, k)): v for k, v in tree_leaves_with_path(tree)}


def _assert_tree_close(port, jax_tree, rtol, atol, scaled=False):
    got, want = _flat(port), _flat(params_from_numpy(N(jax_tree), "cpu"))
    assert sorted(got) == sorted(want)
    for k in got:
        g, w = got[k].numpy(), want[k].numpy()
        a = atol * max(float(np.abs(w).max()), 1e-30) if scaled else atol
        np.testing.assert_allclose(g, w, rtol=rtol, atol=a, err_msg=k)


# ----------------------------------------------------------------- optim
def test_schedule_matches_jax():
    for total, frac in ((10, 0.1), (3, 0.1), (100, 0.25), (1, 0.1)):
        ours, ref = linear_warmup_decay(total, frac), jsched(total, frac)
        for step in range(0, total + 2):
            assert float(ours(torch.tensor(step, dtype=torch.int32))) == \
                float(ref(jnp.int32(step)))


def test_groups_follow_the_leaf_names():
    assert group_for_path(("layers", "attn", "wq", "s_a")) == "act_scale"
    assert group_for_path(("layers", "ffn", "w1", "s_w")) == "weight_scale"
    assert group_for_path(("layers", "ffn", "w1", "w")) == "weights"
    assert group_for_path(("s_a_stats", 0)) == "act_scale"


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_one_adam_step_from_jax_state_matches(clip):
    rng = np.random.default_rng(0)
    params = {"lin": {"w": rng.normal(0, 1, (6, 5)).astype(np.float32),
                      "s_w": np.full((1, 5), 2e-8, np.float32),
                      "s_a": np.float32(0.3)},
              "embed": rng.normal(0, 1, (7, 5)).astype(np.float32)}
    grads = jax.tree.map(lambda a: rng.normal(0, 1, np.shape(a)).astype(np.float32), params)
    jp, jg = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads)
    # a state some steps in: nonzero moments, step 3 of a 20-step schedule
    jst = jadam_init(jp)._replace(
        step=jnp.int32(3),
        m=jax.tree.map(lambda a: jnp.asarray(rng.normal(0, 0.1, a.shape), jnp.float32), jp),
        v=jax.tree.map(lambda a: jnp.asarray(rng.uniform(0, 0.1, a.shape), jnp.float32), jp))
    kw = dict(lr_by_group={"weights": 1e-2, "act_scale": 0.05, "weight_scale": 1e-3},
              grad_clip=clip)
    jp2, jst2 = jadam_update(jp, jg, jst, schedule_fn=jsched(20), **kw)
    carried = params_from_numpy(N({"p": jp, "g": jg, "opt": jst}), "cpu")
    assert isinstance(carried["opt"], AdamState)
    p2, st2 = adam_update(carried["p"], carried["g"], carried["opt"],
                          schedule_fn=linear_warmup_decay(20), **kw)
    assert int(st2.step) == int(jst2.step) == 4
    _assert_tree_close(p2, jp2, rtol=1e-6, atol=1e-9)
    _assert_tree_close(st2.m, jst2.m, rtol=1e-6, atol=1e-9)
    _assert_tree_close(st2.v, jst2.v, rtol=1e-6, atol=1e-9)
    assert float(p2["lin"]["s_w"].min()) >= np.float32(1e-8)


def test_adam_init_matches_jax_layout():
    p = {"a": {"w": torch.ones(2, 3), "s_a": torch.ones(())}, "b": torch.ones(4)}
    st = adam_init(p)
    jst = jadam_init(jax.tree.map(lambda t: jnp.asarray(t.numpy()), p))
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert sorted(_flat(st.m)) == sorted(_flat(params_from_numpy(N(jst.m), "cpu")))


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("host", [0, 1])
def test_synthetic_batches_are_bit_equal(host):
    lm, jlm = (cls(300, 12, 8, seed=5, host_index=host, num_hosts=2)
               for cls in (SyntheticLM, JSLM))
    sc, jsc = (cls(300, 12, 8, num_classes=3, seed=5, host_index=host,
                   num_hosts=2) for cls in (SyntheticClassification, JSC))
    for step in (0, 1, 17, 10_000):
        for a, b in ((lm.batch(step), jlm.batch(step)), (sc.batch(step), jsc.batch(step))):
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_prefetcher_yields_the_stream_in_order_and_closes():
    from repro_torch.data import Prefetcher, lm_batches
    it = lm_batches(64, 4, 2, seed=1)
    ref = SyntheticLM(64, 4, 2, seed=1)
    for step in range(3):
        np.testing.assert_array_equal(next(it)["tokens"], ref.batch(step)["tokens"])
    it.close()
    pf = Prefetcher(iter(range(100)), depth=1)
    assert [next(pf), next(pf)] == [0, 1]
    pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()


# ------------------------------------------------------------ train step
def _lm_setup():
    from repro.deploy import ExecutionPlan as JPlan
    from repro.models import api as japi
    from repro_torch.deploy import ExecutionPlan

    jcfg = jred(jget("stablelm-3b")).replace(num_layers=2)
    jtcfg = jcfg.replace(num_layers=3)
    cfg = reduced(get_config("stablelm-3b")).replace(num_layers=2)
    tcfg = cfg.replace(num_layers=3)
    jpol = JPol(num_layers=2, mode="fake", last_k_int4=1, grad_mode="mse")
    pol = QuantPolicy(num_layers=2, mode="fake", last_k_int4=1, grad_mode="mse")
    jp = japi.init_model(jcfg, jax.random.PRNGKey(0))
    jteacher = japi.init_model(jtcfg, jax.random.PRNGKey(1))
    hp_kw = dict(total_steps=10, lr_weights=1e-3)
    return dict(
        jcfg=jcfg, jtcfg=jtcfg, cfg=cfg, tcfg=tcfg, jpol=jpol, pol=pol,
        jp=jp, jteacher=jteacher, jhp=JHP(**hp_kw), hp=TrainHParams(**hp_kw),
        jplan=JPlan.build(jcfg, jpol), jtplan=JPlan.build(jtcfg, None),
        plan=ExecutionPlan.build(cfg, pol), tplan=ExecutionPlan.build(tcfg, None),
        data=JSLM(jcfg.vocab_size, 16, 4, seed=3))


def _jax_lm_loss(s, params, batch):
    """JAX's ``launch/train.build_train_step`` loss, from its own parts."""
    from repro.core.distill import combine_losses, minilm_losses, output_loss
    from repro.models import api as japi
    from repro.models.transformer import lm_loss
    logits, _, taps_s, aux = japi.forward(params, s["jplan"], want_taps=True,
                                          tokens=batch["tokens"])
    l_train = lm_loss(logits, batch["labels"]) + aux
    t_logits, _, taps_t, _ = japi.forward(s["jteacher"], s["jtplan"], want_taps=True,
                                          tokens=batch["tokens"])
    l_out = output_loss(logits, jax.lax.stop_gradient(t_logits))
    l_attn, l_val = minilm_losses(taps_s, jax.lax.stop_gradient(taps_t),
                                  min(s["jcfg"].num_heads, s["jtcfg"].num_heads))
    return combine_losses(l_train, l_out, l_attn, l_val, s["jhp"].alpha, s["jhp"].beta)


@pytest.fixture(scope="module")
def lm():
    return _lm_setup()


def test_qat_mini_step_loss_and_grads_match_jax(lm):
    from repro_torch.launch.train import build_train_step
    batch = lm["data"].batch(0)
    jb = jax.tree.map(jnp.asarray, batch)
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_lm_loss(lm, p, jb), has_aux=True))(lm["jp"])
    teacher = params_from_numpy(N(lm["jteacher"]), "cpu")
    step = build_train_step(lm["plan"], lm["hp"], teacher=teacher,
                            teacher_plan=lm["tplan"])
    params = params_from_numpy(N(lm["jp"]), "cpu")
    loss, parts, grads = value_and_grad(step.loss_fn, params, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _assert_tree_close(grads, jgrads, rtol=1e-4, atol=1e-6, scaled=True)
    assert parts["loss/attention"].item() > 0 and parts["loss/value"].item() > 0


def test_run_training_three_steps_match_jax(lm, tmp_path):
    from repro.launch.train import run_training as jrun
    from repro_torch.launch.train import run_training

    jstate, jm = jrun(lm["jcfg"], lm["jpol"], lm["jhp"],
                      (jax.tree.map(jnp.asarray, lm["data"].batch(i)) for i in range(3)),
                      ckpt_dir=str(tmp_path / "jax"), ckpt_every=0,
                      distill_teacher=lm["jteacher"], teacher_cfg=lm["jtcfg"],
                      max_steps=3)
    state, m = run_training(lm["cfg"], lm["pol"], lm["hp"],
                            lambda step0: map(lm["data"].batch, range(step0, 3)),
                            ckpt_dir=str(tmp_path / "port"), ckpt_every=0,
                            distill_teacher=params_from_numpy(N(lm["jteacher"]), "cpu"),
                            teacher_cfg=lm["tcfg"], max_steps=3, device="cpu",
                            **params_from_numpy(N({"params": lm["jp"],
                                                   "opt": jadam_init(lm["jp"])}), "cpu"))
    assert int(state["opt"].step) == 3
    for k in jm:
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, err_msg=k)
    _assert_tree_close(state["params"], jstate["params"], rtol=1e-4, atol=1e-6)
    _assert_tree_close(state["opt"].m, jstate["opt"].m, rtol=1e-3, atol=1e-6, scaled=True)


# ------------------------------------------------- benchmarks.common
def _cls_setup():
    from repro.models import api as japi
    from repro.models.bert import init_bert_classifier as jinit
    from repro_torch.benchmarks import common

    jcfg = jred(jget("tinybert4")).replace(num_layers=2, d_model=64, num_heads=4,
                                           num_kv_heads=4, d_ff=96, vocab_size=256)
    jtcfg = jcfg.replace(num_layers=3)
    cfg = common.student_config(num_layers=2).replace(d_model=64, d_ff=96, vocab_size=256)
    tcfg = cfg.replace(num_layers=3)
    jpol = JPol(num_layers=2, mode="fake", last_k_int4=1, grad_mode="mse")
    pol = QuantPolicy(num_layers=2, mode="fake", last_k_int4=1, grad_mode="mse")
    return dict(jcfg=jcfg, jtcfg=jtcfg, jsegs=japi.segments_for(jcfg, jpol),
                jtsegs=japi.segments_for(jtcfg, None), plan=common.plan_for(cfg, pol),
                tplan=common.plan_for(tcfg), jp=jinit(jcfg, 2, jax.random.PRNGKey(0)),
                jteacher=jinit(jtcfg, 2, jax.random.PRNGKey(1)),
                data=JSC(256, 12, 8, num_classes=2, seed=4))


def test_classifier_loss_and_train_classifier_match_jax():
    import benchmarks.common as jcommon
    from repro.core.distill import combine_losses, minilm_losses, output_loss
    from repro.models.bert import bert_classify_logits, classification_loss
    from repro_torch.benchmarks import common

    s = _cls_setup()
    b = s["data"].batch(0)
    toks, labels = jnp.asarray(b["tokens"]), jnp.asarray(b["labels"])

    def jloss(p):  # JAX's train_classifier loss, from its own parts
        logits, taps_s = bert_classify_logits(p, s["jcfg"], s["jsegs"], toks, want_taps=True)
        t_logits, taps_t = bert_classify_logits(s["jteacher"], s["jtcfg"], s["jtsegs"],
                                                toks, want_taps=True)
        l_attn, l_val = minilm_losses(taps_s, taps_t, num_relation_heads=4)
        return combine_losses(classification_loss(logits, labels),
                              output_loss(logits, t_logits), l_attn, l_val)[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(s["jp"])
    teacher = params_from_numpy(N(s["jteacher"]), "cpu")
    params = params_from_numpy(N(s["jp"]), "cpu")
    loss, _, grads = value_and_grad(
        lambda p: (common.classifier_loss(p, s["plan"], torch.as_tensor(b["tokens"]),
                                          torch.as_tensor(b["labels"]), teacher=teacher,
                                          teacher_plan=s["tplan"]), None), params)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _assert_tree_close(grads, jg, rtol=1e-4, atol=1e-6, scaled=True)

    jtrained = jcommon.train_classifier(s["jp"], s["jcfg"], s["jsegs"], s["data"],
                                        steps=3, lr=1e-3, teacher=s["jteacher"],
                                        teacher_cfg=s["jtcfg"], teacher_segments=s["jtsegs"])
    trained = common.train_classifier(params, s["plan"], s["data"], steps=3, lr=1e-3,
                                      teacher=teacher, teacher_plan=s["tplan"])
    _assert_tree_close(trained, jtrained, rtol=1e-4, atol=1e-6)
    # the input params are left as they were
    _assert_tree_close(params, s["jp"], rtol=0, atol=0)


# ------------------------------------------------------------ checkpoints
def _state(seed=0):
    rng = np.random.default_rng(seed)
    p = {"layers": {"w": torch.from_numpy(rng.normal(0, 1, (2, 3, 4)).astype(np.float32)),
                    "s_a": torch.ones(2)}, "embed": torch.zeros(5, 4)}
    return {"params": p, "opt": adam_init(p)}


def test_checkpoint_round_trip_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.restore(_state()) == (None, None)
    for step in (10, 20, 30):
        st = _state(step)
        st["opt"] = st["opt"]._replace(step=torch.tensor(step, dtype=torch.int32))
        mgr.save(step, st, {"loss": 1.0})
    assert mgr.all_steps() == [20, 30] and mgr.latest_step() == 30
    restored, step = mgr.restore(_state())
    assert step == 30 and isinstance(restored["opt"], AdamState)
    assert int(restored["opt"].step) == 30 and restored["opt"].step.dtype == torch.int32
    want = _state(30)
    np.testing.assert_array_equal(restored["params"]["layers"]["w"].numpy(),
                                  want["params"]["layers"]["w"].numpy())
    os.makedirs(tmp_path / ".tmp_crashed")           # a crash mid-save
    assert mgr.latest_step() == 30
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({"params": {"other": torch.zeros(1)}})


def test_checkpoints_cross_between_the_packages(tmp_path):
    jp = {"layers": {"w": jnp.arange(24.0).reshape(2, 3, 4), "s_a": jnp.ones(2)},
          "embed": jnp.zeros((5, 4))}
    jst = {"params": jp, "opt": jadam_init(jp)._replace(step=jnp.int32(7))}
    JCkpt(str(tmp_path / "j")).save(7, jst)
    restored, step = CheckpointManager(str(tmp_path / "j")).restore(_state())
    assert step == 7 and int(restored["opt"].step) == 7
    _assert_tree_close(restored["params"], jp, rtol=0, atol=0)
    _assert_tree_close(restored["opt"].v, jst["opt"].v, rtol=0, atol=0)

    st = _state(3)
    CheckpointManager(str(tmp_path / "t")).save(5, st)
    jres, jstep = JCkpt(str(tmp_path / "t")).restore(jst)
    assert jstep == 5 and int(jres["opt"].step) == 0
    np.testing.assert_array_equal(np.asarray(jres["params"]["layers"]["w"]),
                                  st["params"]["layers"]["w"].numpy())


def test_cli_resume_equals_an_uninterrupted_run(tmp_path, monkeypatch):
    from repro_torch.launch import train
    base = ["--reduced", "--device", "cpu", "--steps", "4", "--ckpt-every", "2",
            "--batch", "2", "--seq", "8"]
    full, _ = train.main(base + ["--ckpt-dir", str(tmp_path / "a")])
    # a preemption: SIGTERM after the second step checkpoints and stops
    assert threading.current_thread() is threading.main_thread()
    real = train.build_train_step

    def preempted(*a, **kw):
        step, done = real(*a, **kw), []

        def run(*args):
            out = step(*args)
            done.append(1)
            if len(done) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return run
    monkeypatch.setattr(train, "build_train_step", preempted)
    part, _ = train.main(base + ["--ckpt-dir", str(tmp_path / "b")])
    monkeypatch.undo()
    assert int(part["opt"].step) == 2
    resumed, _ = train.main(base + ["--ckpt-dir", str(tmp_path / "b")])
    assert int(resumed["opt"].step) == int(full["opt"].step) == 4
    a, b = _flat(full["params"]), _flat(resumed["params"])
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [2, 4]
