"""Port parity: the deployed BERT encoder forward.

A small TinyBERT (2 layers, d 64, 4 heads, d_ff 128, vocab 256) under the
mixed policy (layer 0 W8A8, layer 1 W4A4) is deployed by the JAX package;
its arrays are carried into the port with ``params_from_numpy``, and the
same numpy inputs go through both. Tolerances:

* ``qlinear`` in int mode: bit-equal (exact int32 accumulators, the same
  f32 epilogue order); with fp activations (a_bits 0) rtol 1e-5, atol 1e-6
  (an fp matmul, whose reduction order differs between XLA and PyTorch);
* layernorm, GELU, attention, a whole block: rtol 1e-5, atol 1e-6;
* the whole classifier: logits rtol = atol = 1e-4, the same argmax, the
  first quantized linear's activation codes all equal and every later
  linear's codes at least 99.9 % equal;
* padded vs unpadded rows inside the port: rtol 1e-5, atol 1e-6, the same
  argmax and the first linear's codes bit-equal. PyTorch picks its
  reduction order by shape, so padding is not bit-free in torch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as jcalibration
from repro.core.packing import quantize_weight as jquantize_weight
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.deploy import ExecutionPlan as JExecutionPlan
from repro.deploy import deploy as jdeploy
from repro.kernels import ops as jops
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.bert import bert_classify_logits as jbert_classify_logits
from repro.models.bert import tinybert_config as jtinybert_config
from repro_torch.core.policy import QuantPolicy
from repro_torch.deploy import ExecutionPlan, params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import attention, layers, transformer
from repro_torch.models.bert import (bert_classify_logits,
                                     init_bert_classifier, tinybert_config)

SMALL = dict(layers=2, d=64, heads=4, d_ff=128, vocab=256, name="tinybert-test")


def fp_params(cfg, seed=0):
    """fp classifier params as numpy arrays: the port's init tree (the JAX
    package's keys and shapes), every random leaf redrawn from numpy."""
    rng = np.random.default_rng(seed)
    tree = init_bert_classifier(cfg, 2, torch.Generator().manual_seed(0), "cpu")
    const = lambda a: bool(torch.all(a == 0) or torch.all(a == 1))
    return jax.tree.map(
        lambda a: a.numpy() if const(a)
        else rng.normal(0, 0.02, tuple(a.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def models():
    """(JAX reference plan, JAX pallas plan, JAX deployed params, port
    plan with the kernel backend, port params) for the small mixed model."""
    jcfg = jtinybert_config(**SMALL)
    jpol = JQuantPolicy(num_layers=2, mode="int", last_k_int4=1)
    jref_plan = JExecutionPlan.build(jcfg, jpol, backend="reference", mode="encoder")
    jpal_plan = JExecutionPlan.build(jcfg, jpol, backend="pallas", mode="encoder")
    cfg = tinybert_config(**SMALL)
    fp = jax.tree.map(jnp.asarray, fp_params(cfg))
    rng = np.random.default_rng(0)
    calib = [{"tokens": rng.integers(1, 256, (4, 16)).astype(np.int32)}
             for _ in range(2)]
    jparams = jdeploy(fp, jref_plan, calib).params
    plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=2, mode="int",
                                                last_k_int4=1),
                               backend="cuda", mode="encoder")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jref_plan, jpal_plan, jparams, plan, params


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------------- qlinear
QLINEAR_CASES = [(w, a, be) for w in (4, 8) for a in (4, 8)
                 for be in ("reference", "cuda")] + [(4, 0, "reference"),
                                                     (8, 0, "reference")]


@pytest.mark.parametrize("w_bits,a_bits,backend", QLINEAR_CASES)
def test_qlinear_int_matches_reference(w_bits, a_bits, backend):
    rng = np.random.default_rng(w_bits * 10 + a_bits)
    K, N = 33, 20                      # odd K: int4 packing pads a row
    x = rng.normal(0, 1, (2, 5, K)).astype(np.float32)
    w = rng.normal(0, 0.05, (K, N)).astype(np.float32)
    qmax = 8 if w_bits == 4 else 127
    s_w = (np.abs(w).max(axis=0, keepdims=True) / qmax).astype(np.float32)
    wq, _ = jquantize_weight(jnp.asarray(w), jnp.asarray(s_w), w_bits)
    p = {"wq": np.asarray(wq), "s_w": s_w,
         "s_a": np.asarray(np.float32(np.abs(x).max() / 7)),
         "b": rng.normal(0, 0.1, (N,)).astype(np.float32)}
    use_kernels = backend == "cuda"
    jspec = jlayers.QuantSpec(mode="int", w_bits=w_bits, a_bits=a_bits,
                              use_pallas=use_kernels)
    want = np.asarray(jlayers.qlinear(jnp.asarray(x),
                                      jax.tree.map(jnp.asarray, p), jspec))
    spec = layers.QuantSpec(mode="int", w_bits=w_bits, a_bits=a_bits,
                            use_kernels=use_kernels)
    got = layers.qlinear(_t(x), {k: _t(v) for k, v in p.items()}, spec).numpy()
    if a_bits == 0:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ norms and blocks
def test_layernorm_and_gelu_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 3, (3, 7, 64)).astype(np.float32)
    scale = rng.normal(1, 0.1, 64).astype(np.float32)
    bias = rng.normal(0, 0.1, 64).astype(np.float32)
    np.testing.assert_allclose(
        layers.layernorm(_t(x), _t(scale), _t(bias)).numpy(),
        np.asarray(jlayers.layernorm(jnp.asarray(x), jnp.asarray(scale),
                                     jnp.asarray(bias))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(layers.gelu_f32(_t(x)).numpy(),
                               np.asarray(jlayers.gelu_f32(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def _layer(tree, seg, i):
    return jax.tree.map(lambda a: a[i], tree["layers"][seg])


@pytest.mark.parametrize("seg", [0, 1])
def test_attention_block_with_kv_len_matches_reference(models, seg):
    jref_plan, _, jparams, plan, params = models
    x = np.random.default_rng(seg).normal(0, 1, (3, 10, 64)).astype(np.float32)
    lens = np.array([10, 4, 7], np.int32)
    jspec, spec = jref_plan.segments[seg][2], plan.segments[seg][2]
    want, _, _ = jattention.attention_block(
        jnp.asarray(x), _layer(jparams, seg, 0)["attn"], n_heads=4, n_kv=4,
        hd=16, spec=jspec, causal=False, rope=False,
        kv_len=jnp.asarray(lens))
    lp = {k: v[0] for k, v in params["layers"][seg]["attn"]["wq"].items()}
    assert torch.equal(lp["wq"], _t(_layer(jparams, seg, 0)["attn"]["wq"]["wq"]))
    tlp = {name: {k: v[0] for k, v in lin.items()}
           for name, lin in params["layers"][seg]["attn"].items()}
    got, _ = attention.attention_block(_t(x), tlp, n_heads=4, n_kv=4, hd=16,
                                       spec=spec, causal=False,
                                       kv_len=torch.as_tensor(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seg", [0, 1])
def test_block_apply_matches_reference(models, seg):
    jref_plan, _, jparams, plan, params = models
    x = np.random.default_rng(10 + seg).normal(0, 1, (2, 9, 64)).astype(np.float32)
    lens = np.array([9, 6], np.int32)
    want, _, _, _ = jtransformer.block_apply(
        jnp.asarray(x), _layer(jparams, seg, 0), jref_plan.cfg,
        jref_plan.segments[seg][2], kv_len=jnp.asarray(lens).reshape(-1, 1, 1, 1))
    tlp = _tree_index(params["layers"][seg], 0)
    got, _ = transformer.block_apply(_t(x), tlp, plan.cfg, plan.segments[seg][2],
                                     kv_len=torch.as_tensor(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _tree_index(tree, i):
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------ whole classifier
def _codes_jax(params, plan, toks, lens, backend):
    """JAX logits + every quantized linear's activation codes, in call order
    (calibration mode makes the layer loop eager so the codes are concrete)."""
    seen = []
    if backend == "pallas":
        orig, mod, name = jops.act_quant, jops, "act_quant"
    else:
        orig, mod, name = jlayers.quantize_to_int, jlayers, "quantize_to_int"

    def spy(*a, **k):
        out = orig(*a, **k)
        seen.append(np.asarray(out).reshape(-1, np.asarray(out).shape[-1]))
        return out

    setattr(mod, name, spy)
    try:
        with jcalibration.calibration_mode():
            logits, _ = jbert_classify_logits(params, plan, jnp.asarray(toks),
                                              lengths=jnp.asarray(lens))
    finally:
        setattr(mod, name, orig)
    return np.asarray(logits), seen


def _codes_port(params, plan, toks, lens):
    seen = []
    orig = ops.act_quant

    def spy(*a, **k):
        out = orig(*a, **k)
        seen.append(out.reshape(-1, out.shape[-1]).numpy())
        return out

    ops.act_quant = spy
    try:
        logits = bert_classify_logits(params, plan, toks,
                                      lengths=None if lens is None
                                      else torch.as_tensor(lens))
    finally:
        ops.act_quant = orig
    return logits.numpy(), seen


@pytest.mark.parametrize("jax_backend", ["reference", "pallas"])
def test_classifier_matches_reference(models, jax_backend):
    jref_plan, jpal_plan, jparams, plan, params = models
    rng = np.random.default_rng(2)
    toks = rng.integers(1, 256, (4, 16)).astype(np.int32)
    lens = np.array([16, 9, 5, 12], np.int32)
    jplan = jref_plan if jax_backend == "reference" else jpal_plan
    want, jcodes = _codes_jax(jparams, jplan, toks, lens, jax_backend)
    got, codes = _codes_port(params, plan, toks, lens)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert len(codes) == len(jcodes) == 12          # 2 layers x 6 linears
    np.testing.assert_array_equal(codes[0], jcodes[0])
    shares = [float((a == b).mean()) for a, b in zip(codes, jcodes)]
    assert min(shares) >= 0.999, f"activation-code agreement per linear: {shares}"


@pytest.mark.parametrize("plen,bucket", [(5, 8), (13, 16), (50, 64)])
def test_padded_rows_match_unpadded_inside_the_port(models, plen, bucket):
    _, _, _, plan, params = models
    p = np.random.default_rng(plen).integers(1, 256, plen)
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :plen] = p
    got, gcodes = _codes_port(params, plan, padded, np.array([plen]))
    want, wcodes = _codes_port(params, plan, p[None], None)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_array_equal(gcodes[0][:plen], wcodes[0])
