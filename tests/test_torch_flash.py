"""Port parity: long-context prefill through chunked (flash) attention, and
the vlm family.

The JAX side runs as its own tests run it: ``flash_attention_pallas`` in
interpret mode, the model on its jnp reference backend (jitted). Inputs are
made with numpy from a seed and fed to both packages. The reduced configs
keep ``attn_chunk_threshold=64`` and ``attn_chunk=32``, so a forward of S =
128 takes the chunk branch with 4 chunks. Tolerances:

* ``flash_attention_plain`` vs ``flash_attention_pallas``: f32 within atol
  2e-6, rtol 1e-5 (the same block algorithm, sums in another order); bf16
  within one bf16 ulp of the output plus that f32 atol (both round an f32
  result once, and near zero the f32 difference outlives the rounding);
* ``flash_attention_plain`` vs JAX's ``chunked_attention``: f32 within atol
  1e-6 (rtol 1e-5); bf16 within one bf16 ulp of the output's largest
  magnitude (0.0078 for |out| in [1, 2)), not of each element, because JAX's
  ``chunked_attention`` rounds the scores of a bf16 einsum to bf16 where the
  kernel and the plain version widen q, k and v to f32 first (a difference
  inside the reference: the Pallas kernel widens too);
* the whole model at f32 (W8A8 layers 0-1, W4A4 layers 2-3, deployed by the
  JAX package): logits within rtol = atol = 1e-4 with the same argmax at
  every position, the bar of ``tests/test_torch_model.py``;
* the vlm patch splice (``_embed``): bit-equal;
* greedy engine streams of the reduced vlm: equal token for token;
* the bf16 CUDA kernel's rounding, emulated in plain torch (bf16 products
  with f32 sums, p split into two bf16 parts): within one bf16 ulp of the
  output plus 1e-5 of ``flash_attention_plain`` (``chip_smoke.decode_close``,
  the bound the kernel is held to on the card); with p rounded once to
  bf16 about one element in ten falls outside it.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.deploy import DeployedModel as JDeployedModel
from repro.deploy import ExecutionPlan as JExecutionPlan
from repro.deploy import deploy as jdeploy
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import api as japi
from repro.models import attention as jattention
from repro.models import transformer as jtransformer
from repro.serving import GenerationRequest as JGenerationRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config, reduced
from repro_torch.deploy import DeployedModel, ExecutionPlan
from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import api, attention, transformer
from repro_torch.models.layers import QuantSpec
from repro_torch.serving import GenerationRequest, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("stablelm-3b", "llava-next-mistral-7b")
S_LONG = 128                 # > attn_chunk_threshold (64), 4 chunks of 32
NPATCH = 8                   # reduced vlm: num_patches


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    return 2.0 ** (np.frexp(np.abs(x))[1] - 8)


def _qkv(shape, dtype, seed):
    B, S, H, Hkv, dh = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in (q, k, v)],
            [_t(a).to(tdt) for a in (q, k, v)])


def _close(got: torch.Tensor, want, dtype, atol, rtol=1e-5):
    """f32: atol/rtol. bf16: one ulp of each output element plus atol."""
    g = got.to(torch.float32).numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)
    else:
        bound = _bf16_ulp(np.maximum(np.abs(g), np.abs(w))) + atol
        assert (np.abs(g - w) <= bound).all(), np.abs(g - w).max()


# ------------------------------------------------------------- kernel module
# (B, S, H, Hkv, dh, bq, bk, causal): the four of tests/test_kernels.py
# (GQA, causal and not, bq != bk), the stablelm-3b head width, and GQA
# groups 3 (granite-moe), 5 (qwen2.5-32b) and 8 (qwen1.5-110b)
PALLAS_CASES = [(2, 64, 4, 2, 16, 16, 16, True),
                (1, 128, 8, 8, 32, 32, 16, True),
                (2, 64, 4, 4, 16, 32, 16, False),
                (1, 256, 4, 1, 64, 64, 64, True),
                (1, 128, 4, 2, 80, 64, 32, True),
                (1, 64, 6, 2, 64, 32, 32, True),
                (1, 64, 10, 2, 32, 32, 16, False),
                (1, 64, 16, 2, 32, 32, 32, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PALLAS_CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_matches_flash_attention_pallas(case, dtype):
    B, S, H, Hkv, dh, bq, bk, causal = case
    (jq, jk, jv), (q, k, v) = _qkv((B, S, H, Hkv, dh), dtype, seed=S + dh)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, bq=bq, bk=bk,
                                  interpret=True)
    got = flash_attention_plain(q, k, v, causal=causal, bq=bq, bk=bk)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, dtype, atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_chunked_attention(causal, dtype):
    B, S, H, Hkv, dh, chunk = 2, 128, 4, 2, 16, 32
    (jq, jk, jv), (q, k, v) = _qkv((B, S, H, Hkv, dh), dtype, seed=3)
    g = H // Hkv
    want = jattention.chunked_attention(jq, jattention._repeat_kv(jk, g),
                                        jattention._repeat_kv(jv, g),
                                        causal=causal, chunk=chunk)
    got = flash_attention_plain(q, k, v, causal=causal, bq=chunk, bk=chunk)
    if dtype == "float32":
        _close(got, want, dtype, atol=1e-6)
    else:
        g = got.to(torch.float32).numpy()
        w = np.asarray(want.astype(jnp.float32))
        assert np.abs(g - w).max() <= _bf16_ulp(np.abs(w).max())


def test_ops_on_cpu_runs_the_plain_version_at_a_dividing_block():
    """CPU tensors take the plain version (at 64, or at gcd(S, 64)); the
    kernel is not launched and its count stays."""
    (_, _, _), (q, k, v) = _qkv((1, 96, 4, 2, 16), "float32", seed=5)
    before = build.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, flash_attention_plain(q, k, v, causal=True,
                                                          bq=96, bk=96),
                               atol=2e-6, rtol=1e-5)
    assert build.LAUNCHES["flash_attention"] == before
    with pytest.raises(ValueError, match="tile"):
        flash_attention_plain(q, k, v, causal=True, bq=64, bk=64)


# --------------------------------------- the tensor-core kernel's rounding
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tc_emulation(q, k, v, *, causal: bool, split: bool):
    """The bf16 kernel's arithmetic (``csrc/flash_attention.cu``, namespace
    ``tc``) in plain torch: QK^T of the bf16 operands with f32 sums, the
    scale applied to the f32 score after the product, an online softmax over
    the kernel's key tiles (128 keys for dh <= 80, 64 for dh = 128) with the
    finite -2e38 mask, ``l`` summed from the f32 p, and P.V with p split
    into bf16(p) + bf16(p - bf16(p)) summed in f32 (``split=False``: p
    rounded once to bf16)."""
    B, S, H, dh = q.shape
    bn = 128 if dh <= 80 else 64
    Hkv = k.shape[2]
    g = H // Hkv
    scale = torch.tensor(1.0 / float(dh) ** 0.5, dtype=torch.float32)
    qf = q.float().reshape(B, S, Hkv, g, dh).permute(0, 2, 3, 1, 4)
    kf, vf = (t.float().permute(0, 2, 1, 3)[:, :, None] for t in (k, v))
    acc = torch.zeros((B, Hkv, g, S, dh))
    m = torch.full((B, Hkv, g, S), -2.0e38)
    l = torch.zeros((B, Hkv, g, S))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, bn):
        kb, vb = kf[..., k0:k0 + bn, :], vf[..., k0:k0 + bn, :]
        s = (qf @ kb.transpose(-1, -2)) * scale
        if causal:
            s = torch.where(k0 + torch.arange(kb.shape[-2])[None, :] <= rows, s, -2.0e38)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        hi = p.bfloat16().float()
        pv = hi @ vb + (p - hi).bfloat16().float() @ vb if split else hi @ vb
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dh).to(q.dtype)


# (S, H, Hkv, dh): stablelm-3b's and llava's head widths at GQA groups 1 and
# 4, and a ragged S that no 64- or 128-row tile divides
TC_CASES = [(512, 2, 2, 80), (512, 4, 1, 80), (512, 2, 2, 128), (512, 4, 1, 128),
            (333, 4, 1, 128), (333, 2, 2, 80)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", TC_CASES, ids=lambda c: "x".join(map(str, c)))
def test_tensor_core_rounding_with_split_p_meets_the_plain_bound(case, causal):
    """With p split into two bf16 parts, the kernel's arithmetic stays within
    ``chip_smoke.decode_close``'s bf16 rule (one output ulp + 1e-5) of
    ``flash_attention_plain``; its causal row 0 is row 0 of v exactly."""
    S, H, Hkv, dh = case
    (_, _, _), (q, k, v) = _qkv((1, S, H, Hkv, dh), "bfloat16", seed=S + dh + H)
    got = _tc_emulation(q, k, v, causal=causal, split=True)
    want = flash_attention_plain(q, k, v, causal=causal, bq=S, bk=S)
    _chip_smoke().decode_close(got, want, f"emulation {case}", rtol=1e-5)
    if causal:
        assert torch.equal(got[:, 0], v[:, 0, torch.arange(H) // (H // Hkv)])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", TC_CASES, ids=lambda c: "x".join(map(str, c)))
def test_tensor_core_rounding_with_one_bf16_p_leaves_the_plain_bound(case, causal):
    """The same inputs with p rounded once to bf16 (no split) fall outside
    that rule: this is why the kernel splits p."""
    S, H, Hkv, dh = case
    (_, _, _), (q, k, v) = _qkv((1, S, H, Hkv, dh), "bfloat16", seed=S + dh + H)
    got = _tc_emulation(q, k, v, causal=causal, split=False)
    want = flash_attention_plain(q, k, v, causal=causal, bq=S, bk=S)
    with pytest.raises(AssertionError, match="kernel != plain"):
        _chip_smoke().decode_close(got, want, f"emulation {case}", rtol=1e-5)


# ------------------------------------------------------------------ models
def _policy(cls):
    return cls(num_layers=4, mode="int", last_k_int4=2)


def fp_params(cfg, seed=0):
    """fp params as numpy arrays: the port's init tree (the JAX package's
    keys and shapes), every random leaf redrawn from numpy."""
    rng = np.random.default_rng(seed)
    tree = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    const = lambda a: bool(torch.all(a == 0) or torch.all(a == 1))
    return jax.tree.map(
        lambda a: a.numpy() if const(a)
        else rng.normal(0, 0.02, tuple(a.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    """arch -> (port cfg, JAX model on its reference backend, port model
    loaded from the artifact the JAX package saved)."""
    tmp = tmp_path_factory.mktemp("flash_art")
    out = {}
    for arch in ARCHS:
        cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
        calib = [{"tokens": np.random.default_rng(i).integers(
            1, 256, (4, 16)).astype(np.int32)} for i in range(2)]
        jplan = JExecutionPlan.build(jcfg, _policy(JQuantPolicy), backend="pallas",
                                     kv_bits=8)
        jmodel = jdeploy(jax.tree.map(jnp.asarray, fp_params(cfg)), jplan, calib)
        jmodel.save(str(tmp / arch))
        model = DeployedModel.load(str(tmp / arch), device="cpu")
        jref = JDeployedModel(plan=JExecutionPlan.build(jcfg, _policy(JQuantPolicy),
                                                        backend="reference"),
                              params=jmodel.params)
        out[arch] = (cfg, jref, jmodel, model)
    return out


def _inputs(cfg, S, seed=0):
    """Tokens and, for the vlm, (1, 8, d) patch embeddings placed at
    positions 3..10 (a text prefix, the patch rows, then text)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (2, S)).astype(np.int32)
    if cfg.family != "vlm":
        return {"tokens": toks}
    pe = rng.standard_normal((2, NPATCH, cfg.d_model)).astype(np.float32) * 0.02
    mask = np.zeros((2, S), bool)
    mask[:, 3:3 + NPATCH] = True
    return {"tokens": toks, "patch_embeds": pe, "patch_mask": mask}


def _jax_forward(jmodel, inputs):
    fwd = jax.jit(lambda p, kw: japi.forward(p, jmodel.plan, **kw)[0])
    return np.asarray(fwd(jmodel.params, {k: jnp.asarray(v) for k, v in inputs.items()}))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_long_cacheless_forward_matches_jax(deployed, arch, backend):
    """The port's whole forward at S = 128 (the chunk branch) under the
    reference plan and the kernel plan (the kernel's plain version on the
    CPU) against JAX's, from the artifact JAX saved."""
    cfg, jref, _, model = deployed[arch]
    plan = ExecutionPlan.build(cfg, model.plan.policy, backend=backend)
    inputs = _inputs(cfg, S_LONG)
    want = _jax_forward(jref, inputs)
    got, _ = api.forward(model.params, plan, **{k: _t(v) for k, v in inputs.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_jax_vlm_artifact_serves_in_the_port(deployed, tmp_path):
    """The JAX-exported reduced-llava W8A8/W4A4 artifact loads with its plan
    (the meta's "pallas" backend as "cuda") and its cacheless forward with
    patches matches JAX's Pallas-plan forward; saved again by the port, it
    loads to the same plan and the same logits."""
    cfg, _, jmodel, model = deployed["llava-next-mistral-7b"]
    assert model.plan.cfg == cfg and model.plan.backend == "cuda"
    assert model.plan.cfg.family == "vlm" and model.plan.cfg.num_patches == NPATCH
    assert [(s, e, sp.w_bits, sp.a_bits) for s, e, sp in model.plan.segments] == \
        [(0, 2, 8, 8), (2, 4, 4, 4)]
    inputs = _inputs(cfg, S_LONG, seed=1)
    want = _jax_forward(jmodel, inputs)
    got, _ = api.forward(model.params, model.plan,
                         **{k: _t(v) for k, v in inputs.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    model.save(str(tmp_path / "port"))
    again = DeployedModel.load(str(tmp_path / "port"), device="cpu")
    assert again.plan == model.plan
    assert torch.equal(api.forward(again.params, again.plan,
                                   **{k: _t(v) for k, v in inputs.items()})[0], got)


# --------------------------------------------------------------- the branch
@pytest.mark.parametrize("S", [128, 96, 80, 64, 40])
def test_cacheless_forward_takes_the_chunk_branch_where_jax_does(S, monkeypatch):
    """S above the threshold (64) with S % chunk (32) == 0 takes the chunk
    branch and never builds the (S, S) scores; otherwise full attention
    runs, in both packages. Under a kernel spec the chunk branch goes
    through ``ops.flash_attention`` with K/V unrepeated (GQA, 4 query heads
    on 2 KV heads)."""
    cfg = reduced(get_config("llava-next-mistral-7b")).replace(num_kv_heads=2)
    jcfg = jreduced(jget_config("llava-next-mistral-7b")).replace(num_kv_heads=2)
    calls = {"full": 0, "chunked": 0, "ops": 0, "jfull": 0, "jchunked": 0}

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(attention, "full_attention",
                        count("full", attention.full_attention))
    monkeypatch.setattr(attention, "chunked_attention",
                        count("chunked", attention.chunked_attention))
    heads = []

    def spy_ops(q, k, v, *, causal):
        calls["ops"] += 1
        heads.append((q.shape[2], k.shape[2], v.shape[2]))
        return flash_attention_plain(q, k, v, causal=causal, bq=32, bk=32)
    monkeypatch.setattr(ops, "flash_attention", spy_ops)
    monkeypatch.setattr(jattention, "full_attention",
                        count("jfull", jattention.full_attention))
    monkeypatch.setattr(jattention, "chunked_attention",
                        count("jchunked", jattention.chunked_attention))

    toks = _inputs(cfg, S)["tokens"]
    np_params = fp_params(cfg)
    params = jax.tree.map(_t, np_params)
    L = cfg.num_layers
    want = japi.forward(jax.tree.map(jnp.asarray, np_params),
                        JExecutionPlan.build(jcfg, None), tokens=jnp.asarray(toks))[0]
    ref, _ = api.forward(params, ExecutionPlan.build(cfg, None), tokens=_t(toks))
    kern, _ = transformer.lm_forward(params, cfg, [(0, L, QuantSpec(use_kernels=True))],
                                     tokens=_t(toks))
    takes_chunk = S > cfg.attn_chunk_threshold and S % cfg.attn_chunk == 0
    assert (calls["jchunked"] > 0) == takes_chunk and (calls["jfull"] > 0) != takes_chunk
    assert calls["chunked"] == (2 * L if takes_chunk else 0)
    assert calls["full"] == (0 if takes_chunk else 2 * L)
    assert calls["ops"] == (L if takes_chunk else 0)
    assert heads == [(cfg.num_heads, 2, 2)] * calls["ops"]
    for got in (ref, kern):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# -------------------------------------------------------------- vlm inputs
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_masked", [0, 5, NPATCH, 13])
def test_patch_splice_is_bit_equal_to_jax(n_masked, dtype):
    """``_embed`` places patch row k at the k-th masked position, clipped to
    the last patch row when more positions than patches are masked."""
    cfg = reduced(get_config("llava-next-mistral-7b")).replace(dtype=dtype)
    jcfg = jreduced(jget_config("llava-next-mistral-7b")).replace(dtype=dtype)
    rng = np.random.default_rng(n_masked)
    embed = rng.standard_normal((cfg.padded_vocab, cfg.d_model)).astype(np.float32)
    toks = rng.integers(1, cfg.vocab_size, (2, 24)).astype(np.int32)
    pe = rng.standard_normal((2, NPATCH, cfg.d_model)).astype(np.float32)
    mask = np.zeros((2, 24), bool)
    for b in range(2):
        mask[b, rng.choice(24, n_masked, replace=False)] = True
    want = jtransformer._embed({"embed": jnp.asarray(embed)}, jcfg,
                               jnp.asarray(toks), None, jnp.asarray(pe),
                               jnp.asarray(mask))
    got = transformer._embed({"embed": _t(embed)}, cfg, _t(toks).long(), _t(pe),
                             _t(mask))
    w = np.asarray(want.astype(jnp.float32))
    assert got.dtype == cfg.torch_dtype
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), w)


def test_vlm_engine_streams_match_jax(deployed):
    """A decode plan for the vlm serves tokens, as the JAX engine serves it:
    equal greedy streams at kv 8 (JAX on its Pallas kernels in interpret
    mode, the port on the plain versions)."""
    _, _, jmodel, model = deployed["llava-next-mistral-7b"]
    assert model.plan.mode == "decode" and model.plan.kv_bits == 8
    prompts = [np.array([5, 9, 2], np.int32), np.arange(30, 41, dtype=np.int32),
               np.array([8, 8, 1, 4, 12, 77], np.int32)]
    jeng = JServingEngine(jmodel, slots=2, max_len=32)
    js = [jeng.submit(JGenerationRequest(prompt=p.copy(), max_new_tokens=5))
          for p in prompts]
    jeng.run_until_drained()
    eng = ServingEngine(model, slots=2, max_len=32)
    ts = [eng.submit(GenerationRequest(prompt=p.copy(), max_new_tokens=5))
          for p in prompts]
    eng.run_until_drained()
    assert ([list(s.result().tokens) for s in ts]
            == [list(map(int, s.result().tokens)) for s in js])
