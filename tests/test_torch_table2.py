"""Port parity: the Table 2 layer (``benchmarks/table2_speedup.py``) and
``transformer.init_block``.

* ``block_apply`` of one reduced bert-base layer (d 64, 4 heads of 16,
  d_ff 128, post-LN, GELU, bidirectional) on JAX's ``init_block`` arrays,
  calibrated and packed as the JAX Table 2 spec does (``calibrate_weight_
  scales`` then ``_quantize_stack``; activation scales stay 1): the port's
  packed codes bit-equal to JAX's, its weight scales within rtol 1e-6, and
  the layer's output within rtol = atol = 1e-4 of JAX's jnp path (the
  whole-model bar: XLA and PyTorch order their float sums differently) at
  modes none, int8 and int4. The port's int4 layer with the fused bias +
  GELU epilogue equals its unfused layer bit for bit, and the first
  quantized linear's activation codes equal JAX's.
* The runner's ``--quick`` rows on the CPU: every grid point has its four
  rows (no TF32 row off the card), no device time, host ms, the GEMM paths
  the shape plan names, and bounds recomputed here from the shapes.
* ``init_block``: keys, shapes and dtypes equal to JAX's (bert-base and a
  stacked SwiGLU decoder block), the same constant leaves, weights drawn at
  std 0.02.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.qat import _quantize_stack as j_quantize_stack
from repro.core.qat import calibrate_weight_scales as jcalibrate
from repro.kernels.ref import act_quant_ref
from repro.models.layers import QuantSpec as JQuantSpec
from repro.models.transformer import block_apply as jblock_apply
from repro.models.transformer import init_block as jinit_block
from repro_torch.benchmarks import table2_speedup as t2
from repro_torch.benchmarks.timing import (FP32_OPS_PER_S, HBM_BYTES_PER_S,
                                           INT8_OPS_PER_S)
from repro_torch.configs import get_config, reduced
from repro_torch.core.qat import _quantize_stack, calibrate_weight_scales
from repro_torch.deploy import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.gemm_plan import gemm_plan
from repro_torch.models.transformer import block_apply, init_block

TOL = 1e-4


def _jcfg():
    return jreduced(jget_config("bert-base")).replace(dtype="float32", remat=False)


@pytest.fixture(scope="module")
def layers():
    """bits -> (JAX params, the port's params from JAX's fp arrays)."""
    jcfg = _jcfg()
    jfp = jinit_block(jax.random.PRNGKey(0), jcfg, None)
    out = {0: (jfp, params_from_numpy(jax.tree.map(np.asarray, jfp), "cpu"))}
    for bits in (8, 4):
        jp = jcalibrate({"layers": jfp}, lambda prefix: np.float32(bits))["layers"]
        jp = j_quantize_stack(jp, bits)
        p = calibrate_weight_scales({"layers": out[0][1]}, lambda prefix: float(bits))
        out[bits] = (jp, _quantize_stack(p["layers"], bits))
    return out


def _x(shape=(2, 12, 64)):
    return np.random.default_rng(1).normal(0, 1, shape).astype(np.float32)


def test_packed_codes_equal_jax(layers):
    for bits in (8, 4):
        jp, p = layers[bits]
        for site in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(p["attn"][site]["wq"].numpy(),
                                          np.asarray(jp["attn"][site]["wq"]))
            np.testing.assert_allclose(p["attn"][site]["s_w"].numpy(),
                                       np.asarray(jp["attn"][site]["s_w"]), rtol=1e-6)
        for site in ("w1", "w2"):
            np.testing.assert_array_equal(p["ffn"][site]["wq"].numpy(),
                                          np.asarray(jp["ffn"][site]["wq"]))


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_block_apply_matches_jax(layers, bits):
    cfg = t2.layer_config(quick=True)
    jp, p = layers[bits]
    x = _x()
    mode = "int" if bits else "none"
    jspec = JQuantSpec(mode=mode, w_bits=bits, a_bits=bits)
    want = np.asarray(jax.jit(lambda p, x: jblock_apply(x, p, _jcfg(), jspec)[0])(
        jp, jnp.asarray(x)))
    got = block_apply(torch.as_tensor(x), p, cfg, t2.layer_spec(mode, bits, False))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    if bits:
        # the first quantized linear's codes (the LN-free q projection input)
        np.testing.assert_array_equal(
            ops.act_quant(torch.as_tensor(x), p["attn"]["wq"]["s_a"], bits).numpy(),
            np.asarray(act_quant_ref(jnp.asarray(x), jp["attn"]["wq"]["s_a"], bits)))


def test_int4_fused_equals_unfused(layers):
    cfg = t2.layer_config(quick=True)
    _, p = layers[4]
    x = torch.as_tensor(_x())
    calls = []
    orig = ops.int4_matmul

    def spy(*a, **kw):
        calls.append(kw.get("act"))
        return orig(*a, **kw)

    ops.int4_matmul = spy
    try:
        fused = block_apply(x, p, cfg, t2.layer_spec("int", 4, True))[0]
        unfused = block_apply(x, p, cfg, t2.layer_spec("int", 4, False))[0]
    finally:
        ops.int4_matmul = orig
    assert calls.count("gelu") == 1 and calls.count(None) == 11
    assert torch.equal(fused, unfused)


def test_quick_rows_schema_and_bounds():
    res = t2.run(quick=True, device="cpu", iters=1)
    cfg = t2.layer_config(quick=True)
    assert res["device"] == "cpu" and res["paper"]["float32_over_int4"] == 15.0
    names = [r["row"] for r in res["rows"]]
    assert names == ["float32", "int8", "int4", "int4_fused"] * len(t2.QUICK_GRID)
    d, f, H, hd = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.hd
    lin = [(d, d)] * 4 + [(d, f), (f, d)]
    for r in res["rows"]:
        assert r["device_ms"] is None and r["eager_ms"] is None and r["cpu_ms"] > 0
        B, S = r["batch"], r["tokens"]
        M = B * S
        bits = {"float32": 0, "int8": 8}.get(r["row"], 4)
        w = sum(K * N for K, N in lin) * (bits / 8 if bits else 4)
        side = (4 * d + d + f) * 4 * (2 if bits else 1) + 4 * d * 4
        assert r["bytes"] == 2 * M * d * 4 + w + side
        gemm = 2 * M * (4 * d * d + 2 * d * f)
        attn = 4 * B * H * S * S * hd
        assert (r["gemm_ops"], r["attention_ops"]) == (gemm, attn)
        t_ops = gemm / (INT8_OPS_PER_S if bits else FP32_OPS_PER_S) + attn / FP32_OPS_PER_S
        t_bytes = r["bytes"] / HBM_BYTES_PER_S
        assert r["bound_ms"] == pytest.approx(max(t_ops, t_bytes) * 1e3, rel=1e-12)
        assert r["bound_by"] == ("bytes" if t_bytes >= t_ops else "operations")
        if bits:
            assert r["paths"] == {f"{K}x{N}": gemm_plan(M, N, K, bits).name for K, N in lin}
    assert {r["paths"]["64x64"] for r in res["rows"] if r["row"] == "int8"} == \
        {"wgmma", "splitk"}
    assert len(res["ratios"]) == len(t2.QUICK_GRID)
    for ratio in res["ratios"]:
        assert set(ratio) >= {"float32_over_int4_cpu_ms", "int8_over_int4_cpu_ms"}
    assert "table2,4,110,int4," in t2.table(res)


def _tree(p, f):
    if isinstance(p, dict):
        return {k: _tree(v, f) for k, v in p.items()}
    return f(p)


@pytest.mark.parametrize("arch,stacked", [("bert-base", None), ("stablelm-3b", 3)])
def test_init_block_matches_jax_shapes_and_scales(arch, stacked):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if arch != "bert-base":
        jcfg, cfg = jreduced(jcfg), reduced(cfg)
    jp = jinit_block(jax.random.PRNGKey(0), jcfg, stacked)
    p = init_block(torch.Generator().manual_seed(0), cfg, stacked, "cpu")
    spec = lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
    assert _tree(p, spec) == _tree(jp, spec)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(p),
                                 jax.tree_util.tree_leaves_with_path(jp)):
        b = np.asarray(b)
        if np.all(b == b.flat[0]):          # norms, biases, quant scales
            np.testing.assert_array_equal(a.numpy(), b)
        else:                                # weights: N(0, 0.02)
            assert abs(float(a.std()) - 0.02) < 0.002, path
    with pytest.raises(ValueError, match="later slice"):
        init_block(torch.Generator(), cfg.replace(fused_proj=True), None, "cpu")
