"""Port parity: MINI distillation (``core/distill``), the taps it reads and
the training losses.

* Each distillation loss (``kl_from_logits``, ``relation_distribution``,
  ``minilm_losses``, ``output_loss`` mse and kl, ``hidden_state_loss``,
  ``combine_losses``), with and without a mask, equals JAX's within rtol
  1e-5 / atol 1e-7 in value and in the gradients of every input.
* The taps: ``bert_classify_logits(..., want_taps=True)`` and ``api.forward
  (..., want_taps=True)`` on JAX's params give the last layer's q, k and v
  (before RoPE) within rtol 1e-5 / atol 1e-6 of JAX's, fp and fake-quant;
  without ``want_taps`` the callers get the shapes they always got.
* ``classification_loss`` and ``lm_loss`` (with ignored labels) equal
  JAX's within rtol 1e-6.

Inputs come from fixed numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distill as jd
from repro_torch.core import distill as d

T = lambda a: torch.from_numpy(np.array(a, copy=True))
TOL = dict(rtol=1e-5, atol=1e-7)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def _check(jfn, fn, arrays, mask=None):
    """Value and the gradient of every array input, port vs JAX."""
    jargs = [jnp.asarray(a) for a in arrays]
    jm = None if mask is None else jnp.asarray(mask)
    jval, jgrads = jax.jit(jax.value_and_grad(lambda *a: jfn(*a, jm),
                                              argnums=tuple(range(len(arrays)))))(*jargs)
    targs = [T(a).requires_grad_() for a in arrays]
    val = fn(*targs, None if mask is None else T(mask))
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), **TOL)
    for t, jg in zip(targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-7)


MASKS = [None, np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)]


@pytest.mark.parametrize("mask", MASKS, ids=["nomask", "mask"])
def test_kl_from_logits(mask):
    a, b = _arrays(0, (2, 5, 7), (2, 5, 7))
    _check(jd.kl_from_logits, d.kl_from_logits, [a, b], mask)


@pytest.mark.parametrize("mask", MASKS, ids=["nomask", "mask"])
def test_relation_distribution(mask):
    a, b = _arrays(1, (2, 5, 12), (2, 5, 12))
    _check(lambda x, y, m: jnp.sum(jnp.sin(jd.relation_distribution(x, y, 3, m))),
           lambda x, y, m: torch.sum(torch.sin(d.relation_distribution(x, y, 3, m))),
           [a, b], mask)
    with pytest.raises(ValueError, match="not divisible"):
        d.relation_distribution(T(a), T(b), 5)


@pytest.mark.parametrize("mask", MASKS, ids=["nomask", "mask"])
def test_minilm_losses_with_different_widths(mask):
    # student width 12, teacher width 16, 4 relation heads on both
    qs, ks, vs, qt, kt, vt = _arrays(2, *[(2, 5, 12)] * 3, *[(2, 5, 16)] * 3)

    def jf(qs, ks, vs, m):
        la, lv = jd.minilm_losses({"q": qs, "k": ks, "v": vs},
                                  {"q": jnp.asarray(qt), "k": jnp.asarray(kt),
                                   "v": jnp.asarray(vt)}, 4, m)
        return la + 2 * lv

    def f(qs, ks, vs, m):
        la, lv = d.minilm_losses({"q": qs, "k": ks, "v": vs},
                                 {"q": T(qt), "k": T(kt), "v": T(vt)}, 4, m)
        return la + 2 * lv
    _check(jf, f, [qs, ks, vs], mask)


@pytest.mark.parametrize("kind", ["mse", "kl"])
@pytest.mark.parametrize("mask", MASKS, ids=["nomask", "mask"])
def test_output_loss(kind, mask):
    a, b = _arrays(3, (2, 5, 6), (2, 5, 6))
    _check(lambda x, y, m: jd.output_loss(x, y, kind, m),
           lambda x, y, m: d.output_loss(x, y, kind, m), [a, b], mask)


@pytest.mark.parametrize("mask", MASKS, ids=["nomask", "mask"])
def test_hidden_state_loss(mask):
    a, b = _arrays(4, (2, 5, 6), (2, 5, 6))
    _check(jd.hidden_state_loss, d.hidden_state_loss, [a, b], mask)


def test_combine_losses():
    vals = [np.float32(v) for v in (0.7, 0.3, 0.11, 0.05)]
    jt, jparts = jd.combine_losses(*map(jnp.asarray, vals), alpha=3.0, beta=0.5)
    t, parts = d.combine_losses(*map(T, vals), alpha=3.0, beta=0.5)
    assert sorted(parts) == sorted(jparts)
    for k in parts:
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]), rtol=1e-7)
    with pytest.raises(ValueError):
        d.output_loss(T(vals[0]), T(vals[1]), "huber")


# ------------------------------------------------------------------ taps
def _bert_pair(mode="none"):
    from repro.configs import get_config as jget, reduced as jred
    from repro.core.policy import QuantPolicy as JPol
    from repro.models import api as japi
    from repro.models.bert import init_bert_classifier as jinit
    from repro_torch.benchmarks import common
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.deploy import params_from_numpy

    cfg = common.student_config(num_layers=2)
    jcfg = jred(jget("tinybert4")).replace(num_layers=2, d_model=96, num_heads=4,
                                           num_kv_heads=4, d_ff=192, vocab_size=512)
    jp = jinit(jcfg, 2, jax.random.PRNGKey(3))
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jpol = None if mode == "none" else JPol(num_layers=2, mode="fake", last_k_int4=1)
    pol = None if mode == "none" else QuantPolicy(num_layers=2, mode="fake", last_k_int4=1)
    return jp, p, jcfg, japi.segments_for(jcfg, jpol), common.plan_for(cfg, pol)


@pytest.mark.parametrize("mode", ["none", "fake"])
def test_bert_taps_are_the_last_layers_qkv(mode):
    from repro.models.bert import bert_classify_logits as jlogits
    from repro_torch.models.bert import bert_classify_logits

    jp, p, jcfg, jsegs, plan = _bert_pair(mode)
    toks = np.random.default_rng(0).integers(1, 512, (3, 10)).astype(np.int32)
    jl, jtaps = jax.jit(lambda pp, t: jlogits(pp, jcfg, jsegs, t, want_taps=True))(
        jp, jnp.asarray(toks))
    logits, taps = bert_classify_logits(p, plan, T(toks), want_taps=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    assert sorted(taps) == ["k", "q", "v"]
    for k in taps:
        assert taps[k].shape == (3, 10, 64)
        np.testing.assert_allclose(taps[k].numpy(), np.asarray(jtaps[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    plain = bert_classify_logits(p, plan, T(toks))
    assert torch.is_tensor(plain)
    np.testing.assert_array_equal(plain.numpy(), logits.numpy())


def test_lm_forward_taps_are_before_rope():
    from repro.configs import get_config as jget, reduced as jred
    from repro.models import api as japi
    from repro_torch.configs import get_config, reduced
    from repro_torch.deploy import ExecutionPlan, params_from_numpy
    from repro_torch.models import api

    jcfg = jred(jget("stablelm-3b")).replace(num_layers=2)
    cfg = reduced(get_config("stablelm-3b")).replace(num_layers=2)
    jp = japi.init_model(jcfg, jax.random.PRNGKey(1))
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(np.int32)
    jsegs = japi.segments_for(jcfg, None)
    jl, _, jtaps, aux = jax.jit(lambda pp, t: japi.forward(
        pp, jcfg, jsegs, tokens=t, want_taps=True))(jp, jnp.asarray(toks))
    plan = ExecutionPlan.build(cfg, None)
    logits, state, taps = api.forward(p, plan, tokens=toks, want_taps=True)
    assert state is None and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    for k in ("q", "k", "v"):
        np.testing.assert_allclose(taps[k].numpy(), np.asarray(jtaps[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert len(api.forward(p, plan, tokens=toks)) == 2


# ---------------------------------------------------------------- losses
def test_classification_loss_matches_jax():
    from repro.models.bert import classification_loss as jcl
    from repro_torch.models.bert import classification_loss
    logits, = _arrays(5, (6, 3))
    labels = np.array([0, 2, 1, 1, 0, 2], np.int32)
    np.testing.assert_allclose(classification_loss(T(logits), labels).item(),
                               float(jcl(jnp.asarray(logits), jnp.asarray(labels))),
                               rtol=1e-6)


def test_lm_loss_matches_jax_with_ignored_labels():
    from repro.models.transformer import lm_loss as jlm
    from repro_torch.models.transformer import lm_loss
    logits, = _arrays(6, (2, 5, 11))
    labels = np.array([[1, 4, -1, 10, 0], [3, -1, -1, 2, 7]], np.int32)
    np.testing.assert_allclose(lm_loss(T(logits), T(labels)).item(),
                               float(jlm(jnp.asarray(logits), jnp.asarray(labels))),
                               rtol=1e-6)
