"""act_quant folded into the split-K GEMMs, and int4_matmul_fused on every
path, on the CPU.

On the card a GEMM whose plan is split-K (``M <= 64``, the decode step)
takes the f32 or bf16 activations and quantizes them as it stages them
(``csrc/int_gemm_splitk.cuh``, with ``csrc/quant.cuh``'s arithmetic, which
``csrc/act_quant.cu`` shares), so no act_quant kernel runs for it; every
other GEMM gets act_quant's codes at the row pitch its path reads (wgmma:
``K`` rounded up to 16, where TMA reads only the ``K`` real columns).
``int4_matmul_fused`` takes the same three paths with its bias + activation
epilogue. The kernels run only on the card; here, with inputs made from a
seed with numpy and no operand above a few KB:

* when the GEMM quantizes, from the shapes alone;
* the arguments ``ops`` and each wrapper hand the C entries (a patched
  ``build.launch``): the float pointer, its kind, qmin / qmax of ``a_bits``
  and no act_quant launch on split-K; act_quant's padded pitch and the
  GEMM's ``lda`` on ragged-K wgmma;
* a plain-torch model of quantize-per-split-then-sum, bit-equal to
  ``act_quant_plain`` + the plain GEMMs and to JAX's ``act_quant_pallas`` ->
  ``int8_matmul_pallas`` / ``int4_matmul_pallas`` in interpret mode;
* models of the fused epilogue in the split-K reduce and of the padded-K
  wgmma's zero-filled k tiles, held to ``int4_matmul_fused_plain`` and to
  JAX's ``int4_matmul_fused_pallas`` in interpret mode under the tolerance
  ``test_torch_quant.py::test_int4_matmul_fused_plain_matches_reference``
  states.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.act_quant import act_quant_pallas
from repro.kernels.int4_matmul import int4_matmul_fused_pallas, int4_matmul_pallas
from repro.kernels.int8_matmul import int8_matmul_pallas
from repro_torch.core import packing, quantizer
from repro_torch.kernels import act_quant as aq
from repro_torch.kernels import build
from repro_torch.kernels import gemm_plan as gp
from repro_torch.kernels import int4_matmul as i4
from repro_torch.kernels import int8_matmul as i8
from repro_torch.kernels import ops
from repro_torch.kernels.kv_pack import unpack_nibbles_rows

#: (K, N) of the stablelm-3b decode step and of tinybert4 / bert-base's FFN-up
DECODE = ((2560, 2560), (2560, 6912), (6912, 2560))
FFN_UP = ((312, 1200), (768, 3072))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def grid_activations(M: int, K: int, a_bits: int, seed: int) -> tuple:
    """(M, K) f32 on the grid of s = 1/16, so that x / s is exact: random
    values, a quarter exactly half-way between two codes (x / s = k + 0.5,
    rounded to the even k), one in twenty past +-qmax (clamped)."""
    qmin, qmax = quantizer.qrange(a_bits)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.6 * qmax / 16, (M, K))
    pick = rng.random((M, K))
    half = (rng.integers(qmin - 4, qmax + 4, (M, K)) + 0.5) / 16
    x = np.where(pick < 0.25, half, x)
    x = np.where(pick > 0.95, np.sign(x) * (qmax + 30) / 16, x)
    return x.astype(np.float32), np.float32(1 / 16)


# ---------------------------------------------------------- the plan
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 8, 9, 64])
@pytest.mark.parametrize("K,N", DECODE + FFN_UP)
def test_small_m_quantizes_in_the_gemm(M, K, N, bits):
    assert gp.quantizes_in_gemm(M, N, K, bits)
    assert gp.gemm_plan(M, N, K, bits).path == gp.PATH_SPLITK


@pytest.mark.parametrize("M,N,K", [
    (65, 2560, 2560), (128, 2560, 2560), (8192, 2560, 6912),   # tiles, wgmma
    (8, 312, 312), (8, 312, 1200),                              # N % 16 != 0
    (8, 2560, 2562), (0, 2560, 2560)])                          # K % 4, no rows
def test_other_shapes_get_codes(M, N, K):
    for bits in (8, 4):
        assert not gp.quantizes_in_gemm(M, N, K, bits)


@pytest.mark.parametrize("M,N,K,pitch", [
    (4096, 1200, 312, 320), (128, 1200, 312, 320), (4096, 3072, 768, 768),
    (8192, 2560, 2560, 2560), (1024, 2560, 2562, 2576),        # wgmma
    (4096, 312, 312, 312), (100, 1200, 312, 312), (8, 1200, 312, 312)])
def test_code_pitch(M, N, K, pitch):
    assert gp.code_pitch(gp.gemm_plan(M, N, K, 8), K) == pitch


# ------------------------------------------ what reaches the C entries
@pytest.fixture
def launches(monkeypatch):
    """A patched ``build.launch`` that records (name, args), and no device
    checks, so that the card's route runs on CPU tensors."""
    calls = []
    monkeypatch.setattr(build, "check", lambda *a, **k: None)
    monkeypatch.setattr(build, "launch", lambda name, dev, *a: calls.append((name, a)))
    return calls


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N", [(8, 2560, 2560), (64, 312, 1200), (1, 6912, 2560)])
def test_ops_hand_split_k_the_activations(launches, M, K, N, bits):
    x = torch.zeros((M, K))
    assert ops.gemm_activations(x, N, K, bits, torch.tensor(0.5), 4) is x
    assert launches == []                              # no act_quant


@pytest.mark.parametrize("M,K,N,pitch", [(300, 312, 1200, 320), (4096, 768, 3072, 768),
                                         (100, 312, 1200, 312), (37, 312, 312, 312)])
def test_ops_quantize_at_the_paths_pitch(launches, M, K, N, pitch):
    """act_quant's C entry gets the pitch (argument 5) and the result is the
    (M, K) view of an (M, pitch) buffer."""
    x = torch.zeros((M, K), dtype=torch.bfloat16)
    codes = ops.gemm_activations(x, N, K, 4, torch.tensor(0.5), 4)
    (name, args), = launches
    assert name == "act_quant" and len(args) + 1 == len(build.SIGNATURES[name])
    assert args[3:] == (M, K, pitch, -7, 8, 1)
    assert codes.shape == (M, K) and codes.stride() == (pitch, 1)
    assert args[2] == codes.data_ptr()


@pytest.mark.parametrize("dtype,kind", [(torch.float32, 1), (torch.bfloat16, 2)])
@pytest.mark.parametrize("a_bits", [8, 4])
@pytest.mark.parametrize("entry", ["int8_matmul", "int4_matmul", "int4_matmul_fused"])
def test_wrappers_hand_float_activations(launches, entry, a_bits, dtype, kind):
    """On split-K, the wrappers hand the activations' own pointer, their
    kind and the a_bits grid, at a pitch of K; one launch, no act_quant."""
    M, K, N = 8, 256, 128
    x = torch.zeros((M, K), dtype=dtype)
    s_a, s_w = torch.tensor(0.5), torch.ones((1, N))
    if entry == "int8_matmul":
        out = i8.int8_matmul_cuda(x, torch.zeros((K, N), dtype=torch.int8), s_a, s_w,
                                  out_dtype=dtype, a_bits=a_bits)
    elif entry == "int4_matmul":
        out = i4.int4_matmul_cuda(x, torch.zeros((K // 2, N), dtype=torch.uint8), s_a,
                                  s_w, out_dtype=dtype, a_bits=a_bits)
    else:
        out = i4.int4_matmul_fused_cuda(x, torch.zeros((K // 2, N), dtype=torch.uint8),
                                        s_a, s_w, torch.zeros((1, N)), "gelu",
                                        out_dtype=dtype, a_bits=a_bits)
    assert out.shape == (M, N) and out.dtype == dtype
    (name, args), = launches
    assert name == entry and len(args) + 1 == len(build.SIGNATURES[name])
    plan = gp.gemm_plan(M, N, K, 8 if entry == "int8_matmul" else 4)
    assert args[0] == x.data_ptr()
    assert args[-4:] == (K, kind, *quantizer.qrange(a_bits))
    assert args[-7:-4] == (plan.path, plan.splits, plan.kc) and plan.path == gp.PATH_SPLITK


def test_float_activations_off_a_16_byte_boundary_are_copied(launches):
    base = torch.arange(8 * 257, dtype=torch.float32).reshape(8, 257)
    x = base.reshape(-1)[1:1 + 8 * 256].reshape(8, 256)    # contiguous, offset 4 bytes
    assert x.is_contiguous() and x.data_ptr() % 16
    i8.int8_matmul_cuda(x, torch.zeros((256, 128), dtype=torch.int8), torch.tensor(0.5),
                        torch.ones((1, 128)))
    (_, args), = launches
    assert args[0] % 16 == 0 and args[0] != x.data_ptr()


def test_float_activations_need_the_split_k_path(launches):
    s_a, s_w = torch.tensor(0.5), torch.ones((1, 256))
    with pytest.raises(ValueError, match="split-K"):
        i8.int8_matmul_cuda(torch.zeros((128, 256)), torch.zeros((256, 256), dtype=torch.int8),
                            s_a, s_w)
    with pytest.raises(ValueError, match="split-K"):   # N % 16 != 0: tiles
        i4.int4_matmul_cuda(torch.zeros((8, 256)), torch.zeros((128, 312), dtype=torch.uint8),
                            s_a, torch.ones((1, 312)))
    with pytest.raises(TypeError):
        i8.int8_matmul_cuda(torch.zeros((8, 256), dtype=torch.float16),
                            torch.zeros((256, 256), dtype=torch.int8), s_a, s_w)
    assert launches == []


def test_ragged_k_codes_reach_wgmma_at_the_padded_pitch(launches):
    """Contiguous codes of K = 312 are laid into a (M, 320) buffer; codes
    already at that pitch go through as they are."""
    M, K, N = 300, 312, 1200
    s_a, s_w = torch.tensor(0.5), torch.ones((1, N))
    wp = torch.zeros((K // 2, N), dtype=torch.uint8)
    x8 = torch.arange(M * K, dtype=torch.int64).reshape(M, K).remainder(7).to(torch.int8)
    i4.int4_matmul_fused_cuda(x8, wp, s_a, s_w, torch.zeros((1, N)), "relu")
    pitched = torch.zeros((M, 320), dtype=torch.int8)[:, :K]
    i4.int4_matmul_cuda(pitched, wp, s_a, s_w)
    (n1, a1), (n2, a2) = launches
    assert a1[-4:] == (320, 0, -127, 127) and a1[0] != x8.data_ptr()
    assert a2[-4:] == (320, 0, -127, 127) and a2[0] == pitched.data_ptr()
    assert gp.gemm_plan(M, N, K, 4).path == a1[-7] == gp.PATH_WGMMA


def test_gemm_input_relays_codes_exactly(launches):
    """The re-laid buffer holds the codes in its first K columns."""
    x8 = torch.arange(40 * 312).reshape(40, 312).remainder(255).sub(127).to(torch.int8)
    plan = gp.gemm_plan(200, 1200, 312, 8)
    got, lda, kind = i8.gemm_input(x8, plan, 312)
    assert (lda, kind) == (320, 0) and got.stride() == (320, 1)
    assert torch.equal(got, x8)


# ------------------------------------------------ split-K arithmetic
def quantizing_split_k_model(x: torch.Tensor, w8: torch.Tensor, s_a, s_w, a_bits: int,
                             plan: gp.GemmPlan, out_dtype, bias=None, act=None):
    """The split-K kernels on float activations: split ``s`` quantizes its
    own columns ``[s kc, (s + 1) kc)`` of ``x`` (quant1: IEEE x / s, rint
    half to even, clamp), sums them with rows ``[s kc, (s + 1) kc)`` of the
    weight into int32 partials; the reduce adds the partials in split order
    and runs the epilogue once: ``acc * (s_a * s_w)``, then ``+ bias`` and
    the activation for the fused entry, in f32, one cast at the end."""
    qmin, qmax = quantizer.qrange(a_bits)
    M, K = x.shape
    acc = torch.zeros((M, w8.shape[1]), dtype=torch.int32)
    for s in range(plan.splits):
        k0, k1 = s * plan.kc, min((s + 1) * plan.kc, K)
        codes = torch.clamp(torch.round(x[:, k0:k1].to(torch.float32) / s_a), qmin, qmax)
        acc += (codes.to(torch.int64) @ w8[k0:k1].to(torch.int64)).to(torch.int32)
    r = acc.to(torch.float32) * (s_a * s_w)
    if act is not None:
        r = i4.apply_epilogue(r + bias, act)
    return r.to(out_dtype)


@pytest.mark.parametrize("a_bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(1, 60, 16), (8, 188, 32), (9, 196, 16),
                                   (64, 132, 16), (8, 384, 16), (8, 388, 48)])
def test_quantizing_split_k_model_matches_plain(M, K, N, dtype, a_bits):
    x, s = grid_activations(M, K, a_bits, seed=M * K + N + a_bits)
    x = _t(x).to(dtype)
    s_a = torch.tensor(s)
    rng = np.random.default_rng(K)
    s_w = _t((rng.random((1, N)) * 0.01 + 1e-3).astype(np.float32))
    x8 = aq.act_quant_plain(x, s_a, a_bits)
    for bits in (8, 4):
        lo, hi = (-127, 127) if bits == 8 else (-7, 8)
        w8 = _t(rng.integers(lo, hi + 1, (K, N)).astype(np.int8))
        plan = gp.gemm_plan(M, N, K, bits)
        assert plan.path == gp.PATH_SPLITK and plan.splits > (K > 64)
        got = quantizing_split_k_model(x, w8, s_a, s_w, a_bits, plan, dtype)
        if bits == 8:
            want = i8.int8_matmul_plain(x8, w8, s_a, s_w, dtype)
        else:
            want = i4.int4_matmul_plain(x8, packing.pack_int4(w8, axis=0), s_a, s_w, dtype)
        assert torch.equal(got, want)


@pytest.mark.parametrize("a_bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantizing_split_k_model_matches_jax(bits, dtype, a_bits):
    """M = 8: JAX's act_quant_pallas then int8_matmul_pallas /
    int4_matmul_pallas, both in interpret mode, tolerance 0."""
    M, K, N = 8, 196, 32
    x, s = grid_activations(M, K, a_bits, seed=bits + a_bits)
    tdt = getattr(torch, dtype)
    xt = _t(x).to(tdt)
    rng = np.random.default_rng(bits)
    s_w = (rng.random((1, N)) * 0.01 + 1e-3).astype(np.float32)
    lo, hi = (-127, 127) if bits == 8 else (-7, 8)
    w8 = rng.integers(lo, hi + 1, (K, N)).astype(np.int8)
    plan = gp.gemm_plan(M, N, K, bits)
    got = quantizing_split_k_model(xt, _t(w8), torch.tensor(s), _t(s_w), a_bits, plan,
                                   tdt).float().numpy()
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jx8 = act_quant_pallas(jx, jnp.asarray(s), bits=a_bits, interpret=True)
    np.testing.assert_array_equal(np.asarray(jx8), aq.act_quant_plain(xt, torch.tensor(s),
                                                                      a_bits).numpy())
    if bits == 8:
        want = int8_matmul_pallas(jx8, jnp.asarray(w8), jnp.asarray(s), jnp.asarray(s_w),
                                  bm=M, bn=N, bk=K, out_dtype=getattr(jnp, dtype),
                                  interpret=True)
    else:
        wp = packing.pack_int4(_t(w8), axis=0).numpy()
        want = int4_matmul_pallas(jx8, jnp.asarray(wp), jnp.asarray(s), jnp.asarray(s_w),
                                  bm=M, bn=N, bk=K, out_dtype=getattr(jnp, dtype),
                                  interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want.astype(jnp.float32)))


# ------------------------------------------------- the fused epilogue
def padded_k_wgmma_model(codes_rows: torch.Tensor, K: int, wp: torch.Tensor, s_a, s_w,
                         bias, act: str) -> torch.Tensor:
    """The wgmma path on codes at a padded pitch: TMA reads the activation
    rows to their extent K (the pad bytes of ``codes_rows`` are never
    read) and the packed weight to K / 2 rows, filling each 128-deep k tile
    past them with zeros; a zero packed byte unpacks to two codes of -7,
    which meet only zero activations. The int32 sums over the k tiles, then
    the fused epilogue."""
    M = codes_rows.shape[0]
    kt = -(-K // 128) * 128
    a = torch.zeros((M, kt), dtype=torch.int64)
    a[:, :K] = codes_rows[:, :K].to(torch.int64)
    wfill = torch.zeros((kt // 2, wp.shape[1]), dtype=torch.uint8)
    wfill[:K // 2] = wp
    b = unpack_nibbles_rows(wfill).to(torch.int64)           # -7 past K
    assert bool((b[K:] == -7).all())
    acc = torch.zeros((M, wp.shape[1]), dtype=torch.int64)
    for t in range(kt // 128):
        acc += a[:, 128 * t:128 * (t + 1)] @ b[128 * t:128 * (t + 1)]
    r = acc.to(torch.int32).to(torch.float32) * (s_a * s_w)
    return i4.apply_epilogue(r + bias, act)


def _fused_operands(M, K, N, seed):
    x, s = grid_activations(M, K, 4, seed)
    rng = np.random.default_rng(seed)
    wp = rng.integers(0, 256, (K // 2, N)).astype(np.uint8)
    s_w = (rng.random((1, N)) * 0.01 + 1e-3).astype(np.float32)
    bias = rng.normal(0, 1, (1, N)).astype(np.float32)
    return x, np.asarray(s), wp, s_w, bias


def _jax_fused(x, s, wp, s_w, bias, act):
    M, K = x.shape
    jx8 = act_quant_pallas(jnp.asarray(x), jnp.asarray(s), bits=4, interpret=True)
    return np.asarray(int4_matmul_fused_pallas(
        jx8, jnp.asarray(wp), jnp.asarray(s), jnp.asarray(s_w), jnp.asarray(bias),
        act=act, bm=M, bn=wp.shape[1], bk=K, interpret=True))


def _hold_to_jax(got, x, s, wp, s_w, bias, act):
    """As test_int4_matmul_fused_plain_matches_reference: GELU within rtol =
    atol = 1e-6 of the interpret-mode kernel; none / ReLU: that kernel is
    the single-rounding fma(acc, scale, b), exact in float64 from the same
    int32 sums."""
    kernel = _jax_fused(x, s, wp, s_w, bias, act)
    if act == "gelu":
        np.testing.assert_allclose(got.numpy(), kernel, rtol=1e-6, atol=1e-6)
        return
    x8 = aq.act_quant_plain(_t(x), _t(s), 4)
    acc = i4.int_matmul_exact(x8, unpack_nibbles_rows(_t(wp))).numpy().astype(np.float64)
    fma = (acc * (s * s_w).astype(np.float64) + bias.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(kernel, fma if act == "none" else np.maximum(fma, 0))


@pytest.mark.parametrize("act", ["none", "gelu", "relu"])
@pytest.mark.parametrize("K,N", [(312, 32), (768, 16)])
def test_fused_split_k_reduce_model(K, N, act):
    """The fused epilogue in the split-K reduce, on activations the GEMM
    quantizes: bit-equal to act_quant_plain + int4_matmul_fused_plain, and
    held to JAX's int4_matmul_fused_pallas in interpret mode."""
    M = 8
    x, s, wp, s_w, bias = _fused_operands(M, K, N, seed=K + N)
    plan = gp.gemm_plan(M, N, K, 4)
    assert plan.path == gp.PATH_SPLITK and plan.splits > 1
    w8 = unpack_nibbles_rows(_t(wp))
    got = quantizing_split_k_model(_t(x), w8, _t(s), _t(s_w), 4, plan, torch.float32,
                                   bias=_t(bias), act=act)
    want = i4.int4_matmul_fused_plain(aq.act_quant_plain(_t(x), _t(s), 4), _t(wp), _t(s),
                                      _t(s_w), _t(bias), act)
    assert torch.equal(got, want)
    _hold_to_jax(got, x, s, wp, s_w, bias, act)


@pytest.mark.parametrize("act", ["none", "gelu", "relu"])
@pytest.mark.parametrize("K,N", [(312, 32), (768, 16)])
def test_fused_padded_k_wgmma_model(K, N, act):
    """The fused epilogue on the wgmma path's codes at a padded pitch (K =
    312 at 320; K = 768 needs none), pad bytes poisoned: bit-equal to
    int4_matmul_fused_plain and held to JAX's kernel in interpret mode."""
    M = 8
    x, s, wp, s_w, bias = _fused_operands(M, K, N, seed=K * N)
    pitch = gp.code_pitch(gp.gemm_plan(4096, N, K, 4), K)
    assert pitch == -(-K // 16) * 16
    x4 = aq.act_quant_plain(_t(x), _t(s), 4)
    rows = torch.full((M, pitch), 0x5A, dtype=torch.int8)
    rows[:, :K] = x4
    got = padded_k_wgmma_model(rows, K, _t(wp), _t(s), _t(s_w), _t(bias), act)
    assert torch.equal(got, i4.int4_matmul_fused_plain(x4, _t(wp), _t(s), _t(s_w),
                                                       _t(bias), act))
    _hold_to_jax(got, x, s, wp, s_w, bias, act)


def test_ops_pad_odd_k_before_the_gemm_decides():
    """Odd K: the packed weight covers K + 1; on the CPU the codes get a
    zero column, on the card the activations do (a zero quantizes to 0),
    so both hand the GEMM the same codes."""
    rng = np.random.default_rng(9)
    x = _t(rng.normal(0, 1, (5, 13)).astype(np.float32))
    s = torch.tensor(0.25)
    padded = aq.act_quant_plain(F.pad(x, (0, 1)), s, 4)
    assert torch.equal(padded, F.pad(aq.act_quant_plain(x, s, 4), (0, 1)))
