"""Port parity: training the token-mode families (xLSTM, the Zamba2 hybrid
and the encoder-decoder) on the JAX package's losses.

The setup is the one whose JAX figures the ``EXPECTED`` table records: the
reduced arch, the student from ``PRNGKey(0)`` and the fp teacher from
``PRNGKey(1)`` (JAX's arrays, carried across by ``params_from_numpy``),
tokens of shape (2, 16) from ``np.random.default_rng(0)`` over the whole
vocabulary, used as their own labels, and for the encoder-decoder a (2, 24,
d) ``src_embeds`` in the batch; ``QuantPolicy(mode="fake", last_k_int4=n //
2)`` over the policy's units and ``TrainHParams(total_steps=3)``.

* One step of ``build_train_step``, plain and distilled, against JAX's
  (jitted) on the same arrays: every loss part within rtol 1e-5 / atol
  1e-8 of JAX's and within 2e-6 of the recorded figure; the first Adam moment (the
  clipped gradient times 1 - b1) within rtol 1e-4 / atol 1e-6 relative to
  each leaf's largest; the parameters after the step within rtol 1e-5 /
  atol 1e-6. The distilled xLSTM step takes the hidden-state loss (its
  taps are ``{'hidden'}``, the value part 0); the hybrid's and the
  encoder-decoder's MINI on their attention taps.
* ``run_training`` trains the encoder-decoder on batches that carry
  ``src_embeds``; the train CLI trains reduced xlstm-1.3b and zamba2-2.7b
  on the CPU; ``TrainHParams`` equals JAX's field for field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainHParams as JHP
from repro.configs import get_config as jget
from repro.configs import reduced as jred
from repro.core.policy import QuantPolicy as JPol
from repro.deploy import ExecutionPlan as JPlan
from repro.launch.train import build_train_step as jbuild_train_step
from repro.models import api as japi
from repro.optim import adam_init as jadam_init
from repro_torch.configs import TrainHParams, get_config, reduced
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.deploy import ExecutionPlan, params_from_numpy
from repro_torch.launch import train
from repro_torch.optim import adam_init


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small, and
    at one thread a test worker does not contend with the suite's others
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

N = lambda tree: jax.tree.map(np.asarray, tree)
ARCHS = ("xlstm-1.3b", "zamba2-2.7b", "seamless-m4t-medium")

#: JAX's loss parts on this setup (its ``build_train_step``, CPU, f32),
#: rounded to 6 decimals
EXPECTED = {
    ("xlstm-1.3b", False): {"loss/train": 5.535598},
    ("xlstm-1.3b", True): {"loss/total": 6.049494, "loss/output": 0.051301,
                           "loss/attention": 0.000885, "loss/value": 0.0},
    ("zamba2-2.7b", False): {"loss/train": 5.608033},
    ("zamba2-2.7b", True): {"loss/total": 6.118783, "loss/output": 0.050972,
                            "loss/attention": 0.000282, "loss/value": 0.000749},
    ("seamless-m4t-medium", False): {"loss/train": 5.570569},
    ("seamless-m4t-medium", True): {"loss/total": 6.059129, "loss/attention": 0.000271,
                                    "loss/value": 0.000665},
}


def _units(cfg) -> int:
    return cfg.dec_layers if cfg.family == "encdec" else cfg.num_layers


def _batch(cfg) -> dict:
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    return batch


def _flat(tree) -> dict:
    return {"/".join(map(str, k)): v for k, v in tree_leaves_with_path(tree)}


def _assert_tree_close(port, jax_tree, rtol, atol, scaled=False):
    got, want = _flat(port), _flat(params_from_numpy(N(jax_tree), "cpu"))
    assert sorted(got) == sorted(want)
    for k in got:
        g, w = got[k].numpy(), want[k].numpy()
        a = atol * max(float(np.abs(w).max()), 1e-30) if scaled else atol
        np.testing.assert_allclose(g, w, rtol=rtol, atol=a, err_msg=k)


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """One family's arrays and JAX's step, plain and distilled (each
    compiled once)."""
    arch = request.param
    jcfg, cfg = jred(jget(arch)), reduced(get_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    n = _units(cfg)
    jp = japi.init_model(jcfg, jax.random.PRNGKey(0))
    jt = japi.init_model(jcfg, jax.random.PRNGKey(1))
    batch = _batch(cfg)
    jplan = JPlan.build(jcfg, JPol(num_layers=n, mode="fake", last_k_int4=n // 2))
    jtplan = JPlan.build(jcfg, None)
    jout = {}
    for distill in (False, True):
        kw = dict(teacher=jt, teacher_plan=jtplan) if distill else {}
        step = jax.jit(jbuild_train_step(jplan, JHP(total_steps=3), **kw))
        jp2, jopt2, jparts = step(jp, jadam_init(jp), jax.tree.map(jnp.asarray, batch))
        jout[distill] = (jp2, jopt2, {k: float(v) for k, v in jparts.items()})
    return dict(arch=arch, cfg=cfg, n=n, jp=jp, jt=jt, batch=batch, jout=jout)


@pytest.mark.parametrize("distill", [False, True], ids=["plain", "distilled"])
def test_one_train_step_matches_jax(family, distill):
    cfg, n = family["cfg"], family["n"]
    plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=n, mode="fake",
                                                last_k_int4=n // 2))
    kw = {}
    if distill:
        kw = dict(teacher=params_from_numpy(N(family["jt"]), "cpu"),
                  teacher_plan=ExecutionPlan.build(cfg, None))
    step = train.build_train_step(plan, TrainHParams(total_steps=3), **kw)
    params = params_from_numpy(N(family["jp"]), "cpu")
    params, opt, parts = step(params, adam_init(params), family["batch"])
    jp2, jopt2, jparts = family["jout"][distill]
    assert sorted(parts) == sorted(jparts)
    for k, v in jparts.items():
        np.testing.assert_allclose(parts[k].item(), v, rtol=1e-5, atol=1e-8, err_msg=k)
    for k, v in EXPECTED[(family["arch"], distill)].items():
        assert abs(parts[k].item() - v) <= 2e-6, (k, parts[k].item(), v)
    if distill and cfg.family == "xlstm":      # the hidden-state loss
        assert parts["loss/value"].item() == 0.0 and parts["loss/attention"].item() > 0
    assert int(opt.step) == int(jopt2.step) == 1
    _assert_tree_close(opt.m, jopt2.m, rtol=1e-4, atol=1e-6, scaled=True)
    _assert_tree_close(params, jp2, rtol=1e-5, atol=1e-6)


def test_run_training_takes_encdec_batches_with_src_embeds(tmp_path):
    """``run_training`` feeds every key of a batch to the forward, so an
    encoder-decoder trains on batches that carry ``src_embeds``; the CLI's
    token-only batches are what it refuses."""
    cfg = reduced(get_config("seamless-m4t-medium"))
    n = _units(cfg)
    batch = _batch(cfg)
    seen = []

    def data_fn(step0):
        while True:
            yield batch

    state, metrics = train.run_training(
        cfg, QuantPolicy(num_layers=n, mode="fake", last_k_int4=n // 2),
        TrainHParams(total_steps=2), data_fn, ckpt_dir=str(tmp_path / "ckpt"),
        ckpt_every=0, log_every=0, device="cpu",
        on_step=lambda s, st, m: seen.append(float(m["loss/train"])))
    assert len(seen) == 2 and all(np.isfinite(seen))
    assert metrics["loss/train"] == seen[-1]
    enc = _flat(state["params"]["enc"])
    assert all(torch.isfinite(v).all() for v in enc.values())


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-2.7b"])
def test_train_cli_trains_the_token_mode_families(arch, tmp_path):
    state, metrics = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                                 "--steps", "2", "--batch", "2", "--seq", "32",
                                 "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    assert int(state["opt"].step) == 2
    assert np.isfinite(metrics["loss/train"])
    assert (tmp_path / "LATEST").exists()


def test_train_hparams_equal_jax():
    assert dataclasses.asdict(TrainHParams()) == dataclasses.asdict(JHP())
    assert [f.name for f in dataclasses.fields(TrainHParams)] == \
        [f.name for f in dataclasses.fields(JHP)]
