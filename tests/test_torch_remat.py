"""Per-layer activation checkpointing (``cfg.remat``) in training.

The JAX package wraps each layer's body in ``jax.checkpoint`` when
``cfg.remat`` is set (the decoder stacks, the encoder and decoder of the
encoder-decoder, the hybrid's and xLSTM's groups). The port wraps the same
bodies in ``torch.utils.checkpoint`` (``models.layers.remat``) whenever
autograd records.

On reduced stablelm-3b (dense), granite-moe-3b-a800m (MoE),
seamless-m4t-medium (encoder-decoder), zamba2-2.7b (hybrid) and
xlstm-1.3b, from JAX's own init (``PRNGKey(0)``, carried across):

* the gradients of one fake-quant loss are bit-equal with ``remat`` on and
  off, and so are the losses (the recomputed forward is the same forward);
* with ``remat`` on, the tensors autograd keeps for the backward outside
  the checkpointed bodies are under half of those kept without it (the
  layer bodies' activations are recomputed instead): the knob is honoured;
* the loss equals JAX's ``remat=True`` loss (jitted) within rtol 1e-5
  (``test_torch_train*.py`` hold the steps' gradients to JAX's);
* a forward under ``no_grad`` (serving) keeps nothing and runs as before;
  the distilled loss (the last layer tapped, outside the checkpoint, as in
  JAX) gives the same gradients with and without ``remat``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jred
from repro.core.policy import QuantPolicy as JPol
from repro.deploy import ExecutionPlan as JPlan
from repro.models import api as japi
from repro.models.transformer import lm_loss as jlm_loss
from repro_torch.configs import TrainHParams, get_config, reduced
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.deploy import ExecutionPlan, params_from_numpy
from repro_torch.launch.train import build_train_step
from repro_torch.optim import value_and_grad


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small, and
    at one thread a test worker does not contend with the suite's others
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ARCHS = ("stablelm-3b", "granite-moe-3b-a800m", "seamless-m4t-medium",
         "zamba2-2.7b", "xlstm-1.3b")


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


def _loss_fn(cfg, teacher=None):
    n = _units(cfg)
    plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=n, mode="fake",
                                                last_k_int4=n // 2))
    kw = {} if teacher is None else dict(teacher=teacher,
                                          teacher_plan=ExecutionPlan.build(cfg, None))
    return build_train_step(plan, TrainHParams(total_steps=3), **kw).loss_fn


def _grads(cfg, params, batch, teacher=None):
    """(loss, grads, bytes autograd saved outside checkpointed bodies)."""
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _, grads = value_and_grad(_loss_fn(cfg, teacher), params, batch)
    return loss, grads, saved[0]


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    arch = request.param
    jcfg = jred(jget(arch)).replace(remat=True)
    cfg = reduced(get_config(arch))
    assert not cfg.remat            # reduced() turns it off, as JAX's does
    jp = japi.init_model(jcfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    n = _units(cfg)
    jplan = JPlan.build(jcfg, JPol(num_layers=n, mode="fake", last_k_int4=n // 2))
    inputs = {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"}

    def jloss(p):
        logits, _, _, aux = japi.forward(p, jcfg, jplan.segments, **inputs)
        return jlm_loss(logits, jnp.asarray(batch["labels"])) + aux
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return dict(arch=arch, cfg=cfg, params=params, batch=batch,
                jloss=float(jax.jit(jloss)(jp)))


def test_remat_grads_are_bit_equal_and_keep_less(family):
    cfg, params, batch = family["cfg"], family["params"], family["batch"]
    l0, g0, kept0 = _grads(cfg, params, batch)
    l1, g1, kept1 = _grads(cfg.replace(remat=True), params, batch)
    assert torch.equal(l0, l1)
    f0, f1 = _flat(g0), _flat(g1)
    assert sorted(f0) == sorted(f1)
    for k in f0:
        assert torch.equal(f0[k], f1[k]), k
    assert 0 < kept1 < kept0 / 2, (kept1, kept0)


def test_remat_loss_matches_jax(family):
    loss, _, _ = _grads(family["cfg"].replace(remat=True), family["params"],
                        family["batch"])
    np.testing.assert_allclose(loss.item(), family["jloss"], rtol=1e-5)


def test_serving_forward_under_no_grad_keeps_nothing(family):
    from repro_torch.models import api
    cfg = family["cfg"].replace(remat=True)
    n = _units(cfg)
    plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=n, mode="fake",
                                                last_k_int4=n // 2))
    inputs = {k: v for k, v in family["batch"].items() if k != "labels"}
    want = api.forward(family["params"], ExecutionPlan.build(
        family["cfg"], plan.policy), **inputs)[0]
    with torch.no_grad():
        got = api.forward(family["params"], plan, **inputs)[0]
    assert got.grad_fn is None and torch.equal(got, want.detach())


@pytest.mark.parametrize("arch", ["stablelm-3b", "xlstm-1.3b"])
def test_remat_distilled_grads_are_bit_equal(arch):
    cfg = reduced(get_config(arch))
    jcfg = jred(jget(arch))
    params = params_from_numpy(jax.tree.map(
        np.asarray, japi.init_model(jcfg, jax.random.PRNGKey(0))), "cpu")
    teacher = params_from_numpy(jax.tree.map(
        np.asarray, japi.init_model(jcfg, jax.random.PRNGKey(1))), "cpu")
    batch = _batch(cfg)
    l0, g0, _ = _grads(cfg, params, batch, teacher)
    l1, g1, _ = _grads(cfg.replace(remat=True), params, batch, teacher)
    assert torch.equal(l0, l1)
    f0, f1 = _flat(g0), _flat(g1)
    for k in f0:
        assert torch.equal(f0[k], f1[k]), k
