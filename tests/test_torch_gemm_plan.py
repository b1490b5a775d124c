"""The integer GEMMs' three CUDA paths, on the CPU.

``int8_matmul`` and ``int4_matmul`` launch one of three kernels that
``gemm_plan`` picks from shapes alone: split-K for the decode step's small
M (``csrc/int_gemm_splitk.cuh``), wgmma with a TMA ring for the long
forwards' large M (``csrc/int_gemm_wgmma.cuh``), and the first design's
tiles for the rest (``csrc/int_gemm.cuh``). The kernels run only on the
card; here, each at small sizes with inputs made from a seed with numpy:

* the plan for each main-path shape and its invariants, with the sizes
  the C entries check, and the tile and split constants read from the CUDA
  sources;
* the arguments each wrapper hands its C entry (a patched ``build.launch``);
* a plain-torch model of the split-K arithmetic (int32 partials over the
  splits, the epilogue once on their sum) held bit-equal to the plain
  versions and to JAX's ``kernels/ops`` at split edges and ragged K;
* a plain-torch model of the wgmma path's re-layout of a raw weight tile
  (word loads, the nibble unpack, the ``__byte_perm`` transposition, the
  swizzled 16-byte stores) held equal to the tile's transpose, of the
  split-K path's B fragments, and of the wgmma epilogue's bf16 quad trade.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import packing, quantizer
from repro_torch.kernels import build
from repro_torch.kernels import gemm_plan as gp
from repro_torch.kernels import int4_matmul as i4
from repro_torch.kernels import int8_matmul as i8
from repro_torch.kernels.act_quant import act_quant_plain
from repro_torch.kernels.kv_pack import unpack_nibbles_rows

CSRC = Path(gp.__file__).resolve().parent / "csrc"

#: (K, N) of the decoder paths: stablelm-3b's and llava-next-mistral-7b's
STABLELM = ((2560, 2560), (2560, 6912), (6912, 2560))
LLAVA = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
#: tinybert4's (K, N) at its serving and check sizes
ENCODER = ((312, 312), (312, 1200), (1200, 312))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 8, 64])
@pytest.mark.parametrize("K,N", STABLELM + LLAVA)
def test_decode_shapes_take_split_k(M, K, N, bits):
    plan = gp.gemm_plan(M, N, K, bits)
    assert plan.path == gp.PATH_SPLITK and plan.name == "splitk"
    assert plan.kc % gp.SPLITK_STAGE_K == 0 and plan.kc <= gp.SPLITK_MAX_KC
    assert plan.splits == -(-K // plan.kc)
    # at least twice the 132 SMs, and no smaller split than that needs
    blocks = -(-N // gp.SPLITK_BN) * plan.splits
    assert blocks >= gp.SPLITK_MIN_BLOCKS
    if plan.kc < gp.SPLITK_MAX_KC:
        assert -(-N // gp.SPLITK_BN) * -(-K // (plan.kc + gp.SPLITK_STAGE_K)) \
            < gp.SPLITK_MIN_BLOCKS
    assert plan.ws_bytes == 4 * plan.splits * M * N


def test_stablelm_decode_splits():
    """The decode step's three shapes at M = 8: 280, 270 and 280 blocks."""
    got = {(K, N): gp.gemm_plan(8, N, K, 8)[:3] for K, N in STABLELM}
    assert got == {(2560, 2560): (gp.PATH_SPLITK, 14, 192),
                   (2560, 6912): (gp.PATH_SPLITK, 5, 512),
                   (6912, 2560): (gp.PATH_SPLITK, 14, 512)}
    assert gp.gemm_plan(8, 2560, 2560, 4) == gp.gemm_plan(8, 2560, 2560, 8)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [128, 1000, 1024, 8192, 32768])
@pytest.mark.parametrize("K,N", STABLELM + LLAVA)
def test_long_forward_and_prefill_shapes_take_wgmma(M, K, N, bits):
    assert gp.gemm_plan(M, N, K, bits) == (gp.PATH_WGMMA, 1, K, 0)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [37, 100, 512, 4096])
@pytest.mark.parametrize("K,N", ENCODER)
def test_encoder_shapes(M, K, N, bits):
    """tinybert4: N = 312 is no multiple of 16, so no TMA row and the
    tiles; (312, 1200) at M <= 64 streams its weight split over K, and at M
    >= 128 takes wgmma with its codes at a pitch of 320 (K = 312 is no
    multiple of 16)."""
    plan = gp.gemm_plan(M, N, K, bits)
    if M <= gp.SPLITK_MAX_M and N % 16 == 0:
        assert plan.path == gp.PATH_SPLITK and (plan.splits, plan.kc) == (5, 64)
        assert gp.code_pitch(plan, K) == K
    elif M >= gp.WGMMA_MIN_M and N % 16 == 0:
        assert plan == (gp.PATH_WGMMA, 1, K, 0)
        assert gp.code_pitch(plan, K) == 320
    else:
        assert plan == (gp.PATH_TILED, 1, K, 0)


@pytest.mark.parametrize("M,N,K,path", [
    (65, 2560, 2560, gp.PATH_TILED),     # between the regimes
    (127, 2560, 2560, gp.PATH_TILED),
    (8, 2568, 2560, gp.PATH_TILED),      # N % 16 != 0: no TMA row
    (8, 2560, 2562, gp.PATH_TILED),      # K % 4 != 0: no word loads
    (1024, 2560, 2592, gp.PATH_WGMMA),   # K % 64 != 0: a zero-filled last k tile
    (1024, 2560, 2562, gp.PATH_WGMMA),   # K % 16 != 0: codes at a padded pitch
    (1024, 2568, 2560, gp.PATH_TILED),
    (0, 2560, 2560, gp.PATH_TILED),
    (8, 16, 4, gp.PATH_SPLITK),
    (128, 16, 64, gp.PATH_WGMMA),
])
def test_plan_limits(M, N, K, path):
    assert gp.gemm_plan(M, N, K, 8).path == path


def test_plan_takes_shapes_only():
    with pytest.raises(ValueError):
        gp.gemm_plan(8, 2560, 2560, 2)


def _constant(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_constants_match_the_cuda_sources():
    sk = (CSRC / "int_gemm_splitk.cuh").read_text()
    assert _constant(sk, "kBN") == gp.SPLITK_BN
    assert _constant(sk, "kStageK") == gp.SPLITK_STAGE_K
    assert _constant(sk, "kMaxKc") == gp.SPLITK_MAX_KC
    assert _constant(sk, "kMaxM") == gp.SPLITK_MAX_M
    wg = (CSRC / "int_gemm_wgmma.cuh").read_text()
    assert (_constant(wg, "kBM"), _constant(wg, "kBN"), _constant(wg, "kBK")) == \
        (gp.WGMMA_BM, gp.WGMMA_BN, gp.WGMMA_BK)
    assert gp.WGMMA_MIN_M == gp.WGMMA_BM
    for src in ("int8_matmul.cu", "int4_matmul.cu"):
        text = (CSRC / src).read_text()
        for path, kernel in ((gp.PATH_TILED, "launch_int_gemm"),
                             (gp.PATH_SPLITK, "splitk::launch"),
                             (gp.PATH_WGMMA, "wg::launch")):
            assert re.search(rf"case {path}:\s*return {re.escape(kernel)}", text), (src, path)
    assert set(build.HEADERS) >= {"int_gemm.cuh", "int_gemm_splitk.cuh",
                                  "int_gemm_wgmma.cuh"}


# -------------------------------------------------------------- wrappers
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N", [(8, 2560, 2560), (37, 312, 1200), (1024, 256, 512),
                                   (37, 312, 312), (300, 1200, 312)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_wrappers_hand_the_plan_to_the_c_entry(monkeypatch, M, K, N, bits, out_dtype):
    """As many arguments as ``SIGNATURES`` names (the stream last), the
    sizes, the dtype flag and the plan, and a workspace of the plan's size
    that lives through the launch."""
    calls = []
    monkeypatch.setattr(build, "check", lambda *a, **k: None)

    def launch(name, dev, *args):
        calls.append((name, args, [t.numel() for t in made]))
    monkeypatch.setattr(build, "launch", launch)
    made = []
    orig = i8.workspace

    def workspace(plan, device):
        made.append(orig(plan, device))
        return made[-1]
    monkeypatch.setattr(i8, "workspace", workspace)
    monkeypatch.setattr(i4, "workspace", workspace)
    x8 = torch.zeros((M, K), dtype=torch.int8)
    s_a, s_w = torch.tensor(0.5), torch.ones((1, N))
    if bits == 8:
        out = i8.int8_matmul_cuda(x8, torch.zeros((K, N), dtype=torch.int8), s_a, s_w,
                                  out_dtype=out_dtype)
    else:
        out = i4.int4_matmul_cuda(x8, torch.zeros((K // 2, N), dtype=torch.uint8), s_a,
                                  s_w, out_dtype=out_dtype)
    assert out.shape == (M, N) and out.dtype == out_dtype
    name = f"int{bits}_matmul"
    plan = gp.gemm_plan(M, N, K, bits)
    (got_name, args, ws_sizes), = calls
    assert got_name == name
    assert len(args) + 1 == len(build.SIGNATURES[name])
    flag = i8.OUT_DTYPES[out_dtype]
    assert args[6:13] == (M, N, K, flag, plan.path, plan.splits, plan.kc)
    # the codes' row pitch, their kind (int8 codes) and the 8-bit grid
    assert args[13:] == (gp.code_pitch(plan, K), 0, -127, 127)
    assert args[4] == out.data_ptr() and args[5] == made[0].data_ptr()
    assert ws_sizes == [max(plan.ws_bytes // 4, 4)]


def test_wrappers_keep_their_checks():
    x8 = torch.zeros((8, 64), dtype=torch.int8)
    s_a, s_w = torch.tensor(0.5), torch.ones((1, 32))
    with pytest.raises(TypeError):
        i8.int8_matmul_cuda(x8, torch.zeros((64, 32), dtype=torch.int8), s_a, s_w,
                            out_dtype=torch.float16)
    with pytest.raises(ValueError):   # CPU tensors go to the plain versions
        i8.int8_matmul_cuda(x8, torch.zeros((64, 32), dtype=torch.int8), s_a, s_w)
    with pytest.raises(ValueError):   # packed rows cover another K
        i4.int4_matmul_cuda(x8, torch.zeros((31, 32), dtype=torch.uint8), s_a, s_w)


# ------------------------------------------------- split-K arithmetic
def split_k_model(x8: torch.Tensor, w8: torch.Tensor, s_a: torch.Tensor,
                  s_w: torch.Tensor, out_dtype: torch.dtype,
                  plan: gp.GemmPlan) -> torch.Tensor:
    """The split-K kernels' arithmetic: split ``s`` sums rows ``[s kc,
    (s + 1) kc)`` of K into int32 partials (a workspace of ``(splits, M,
    N)``); the reduce adds them in split order in int32 and applies the
    epilogue once, to the full sum."""
    M, K = x8.shape
    ws = torch.empty((plan.splits, M, w8.shape[1]), dtype=torch.int32)
    for s in range(plan.splits):
        k0, k1 = s * plan.kc, min((s + 1) * plan.kc, K)
        ws[s] = (x8[:, k0:k1].to(torch.int64) @ w8[k0:k1].to(torch.int64)).to(torch.int32)
    acc = ws[0].clone()
    for s in range(1, plan.splits):
        acc += ws[s]
    return (acc.to(torch.float32) * (s_a * s_w)).to(out_dtype)


def _split_operands(M, K, N, bits, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.5, (M, K)).astype(np.float32)
    s_a = np.float32(np.abs(x).max() * 0.7 / quantizer.qrange(bits)[1])
    s_w = (rng.random((1, N)) * 0.01 + 1e-3).astype(np.float32)
    codes = rng.integers(-7, 9, (K, N)) if bits == 4 else rng.integers(-127, 128, (K, N))
    return x, np.asarray(s_a), s_w, codes.astype(np.int8)


#: split edges (multiples of the 64-row stage, one word either side) and
#: ragged K; M of one, of a decode step, one past it, and the path's last
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(1, 60, 16), (8, 64, 144), (9, 68, 16),
                                   (64, 124, 48), (8, 128, 144), (9, 132, 16),
                                   (8, 316, 144), (1, 196, 272)])
def test_split_k_model_matches_plain(M, K, N, bits, out_dtype):
    x, s_a, s_w, codes = _split_operands(M, K, N, bits, seed=M * K + N + bits)
    plan = gp.gemm_plan(M, N, K, bits)
    assert plan.path == gp.PATH_SPLITK and plan.splits == -(-K // 64)
    x8 = act_quant_plain(_t(x), _t(s_a), bits)
    got = split_k_model(x8, _t(codes), _t(s_a), _t(s_w), out_dtype, plan)
    if bits == 8:
        want = i8.int8_matmul_plain(x8, _t(codes), _t(s_a), _t(s_w), out_dtype)
    else:
        wp = packing.pack_int4(_t(codes), axis=0)
        want = i4.int4_matmul_plain(x8, wp, _t(s_a), _t(s_w), out_dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N", [(8, 132, 48), (9, 196, 16)])
def test_split_k_model_matches_jax(M, K, N, bits):
    """The same inputs through JAX's ``kernels/ops`` (its Pallas kernels in
    interpret mode): the f32 outputs bit-equal."""
    x, s_a, s_w, codes = _split_operands(M, K, N, bits, seed=K + bits)
    x8 = act_quant_plain(_t(x), _t(s_a), bits)
    plan = gp.gemm_plan(M, N, K, bits)
    got = split_k_model(x8, _t(codes), _t(s_a), _t(s_w), torch.float32, plan).numpy()
    if bits == 8:
        want = jops.int8_matmul(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(s_a),
                                jnp.asarray(s_w), bits)
    else:
        wp = packing.pack_int4(_t(codes), axis=0).numpy()
        want = jops.int4_matmul(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(s_a),
                                jnp.asarray(s_w), bits)
    np.testing.assert_array_equal(got, np.asarray(want))


# ----------------------------------------------- word-level device models
def byte_perm(x: torch.Tensor, y: torch.Tensor, sel) -> torch.Tensor:
    """``__byte_perm(x, y, sel)`` on int64 tensors of uint32 words: byte i
    of the result is byte ``(sel >> 4i) & 7`` of the 8-byte pool (x, y)."""
    pool = x | (y << 32)
    sel = torch.as_tensor(sel, dtype=torch.int64)
    out = torch.zeros_like(x)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        out |= ((pool >> (8 * b)) & 0xFF) << (8 * i)
    return out


def nibble_codes(nib: torch.Tensor) -> torch.Tensor:
    return ((nib | 0x80808080) - 0x07070707) ^ 0x80808080


def words(raw: torch.Tensor) -> torch.Tensor:
    """(rows, cols) uint8 -> (rows, cols / 4) int64 little-endian words."""
    b = raw.to(torch.int64).reshape(raw.shape[0], -1, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def unword(w: torch.Tensor) -> torch.Tensor:
    """int64 words -> their 4 bytes, last axis, as uint8."""
    return torch.stack([(w >> (8 * i)) & 0xFF for i in range(4)], -1).to(torch.uint8)


def transpose4(v):
    t0, t1 = byte_perm(v[0], v[1], 0x5140), byte_perm(v[0], v[1], 0x7362)
    t2, t3 = byte_perm(v[2], v[3], 0x5140), byte_perm(v[2], v[3], 0x7362)
    return [byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
            byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)]


def relayout_model(raw: torch.Tensor, int4: bool) -> tuple[torch.Tensor, list]:
    """``relayout_b`` of ``csrc/int_gemm_wgmma.cuh`` for all 256 consumer
    threads: the raw tile (128 k rows, or 64 packed rows, x 256 columns)
    to the K-major tile (256 rows x 128 bytes, chunk c of row n at c ^ (n &
    7)). Returns the tile and, per store (h, q) and warp, the 16-byte slots
    of each 8-lane phase."""
    W = words(raw)                                 # (rows, 64)
    bk = torch.zeros((256, 128), dtype=torch.uint8)
    slots = []
    u = torch.arange(256)
    lane, kc = u % 32, u // 32
    rot = (lane >> 1) & 3
    for h in range(2):
        wd = 32 * h + lane
        if not int4:
            r = [W[16 * kc + i, wd] for i in range(16)]
        else:
            r = []
            for p in range(8):
                w = W[8 * kc + p, wd]
                r += [nibble_codes(w & 0x0F0F0F0F), nibble_codes((w >> 4) & 0x0F0F0F0F)]
        for q in range(4):
            j = (q + rot) & 3
            sel = j | ((4 + j) << 4)
            o = [byte_perm(byte_perm(r[4 * g], r[4 * g + 1], sel),
                           byte_perm(r[4 * g + 2], r[4 * g + 3], sel), 0x5410)
                 for g in range(4)]
            n = 4 * wd + j
            chunk = kc ^ (n & 7)
            data = torch.cat([unword(x) for x in o], -1)    # (256, 16)
            for i in range(256):
                bk[n[i], 16 * chunk[i]:16 * chunk[i] + 16] = data[i]
            # the 16-byte slot (bank group) each lane writes: row n is 128
            # bytes, so only the chunk decides it
            slots.append(chunk.reshape(8, 4, 8))
    return bk, slots


def unswizzle(bk: torch.Tensor) -> torch.Tensor:
    """K-major swizzled tile -> (256 n, 128 k) plain."""
    out = torch.empty_like(bk)
    for n in range(256):
        for c in range(8):
            p = c ^ (n & 7)
            out[n, 16 * c:16 * c + 16] = bk[n, 16 * p:16 * p + 16]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_int4_relayout_model_equals_unpacked_transpose(seed):
    g = torch.Generator().manual_seed(seed)
    wp = torch.randint(0, 256, (64, 256), generator=g, dtype=torch.uint8)
    bk, slots = relayout_model(wp, int4=True)
    want = unpack_nibbles_rows(wp).T.contiguous()            # (256 n, 128 k)
    assert torch.equal(unswizzle(bk).view(torch.int8), want)
    # every 8-lane phase of a 16-byte store covers 8 distinct slots: all 32
    # banks, no conflict
    for s in slots:
        assert all(len(set(ph.tolist())) == 8 for ph in s.reshape(-1, 8))


def test_int8_relayout_model_equals_transpose():
    g = torch.Generator().manual_seed(2)
    w8 = torch.randint(-127, 128, (128, 256), generator=g, dtype=torch.int8)
    bk, _ = relayout_model(w8.view(torch.uint8), int4=False)
    assert torch.equal(unswizzle(bk).view(torch.int8), w8.T.contiguous())


@pytest.mark.parametrize("int4", [False, True])
def test_split_k_fragments_equal_the_columns(int4):
    """``splitk_partial_kernel``'s B fragments: thread (g, t) of warp w reads
    the word of columns 32 w + 4 g .. + 3 from k rows 4t .. 4t + 3 (+16), or
    2 packed rows, through the 128-byte swizzle; after ``transpose4``, its
    j-th word holds k rows 4t .. 4t + 3 of column 32 w + 4 g + j."""
    g = torch.Generator().manual_seed(3)
    rows = 32 if int4 else 64
    tile = torch.randint(0, 256, (rows, 128), generator=g, dtype=torch.uint8)
    # the stage as TMA writes it with the 128-byte swizzle
    st = torch.empty_like(tile)
    for r in range(rows):
        for c in range(8):
            p = c ^ (r & 7)
            st[r, 16 * p:16 * p + 16] = tile[r, 16 * c:16 * c + 16]
    codes = unpack_nibbles_rows(tile) if int4 else tile.view(torch.int8)   # (64, 128)
    W = words(st)
    for warp in range(4):
        for gg in range(8):
            col = 32 * warp + 4 * gg
            for t in range(4):
                for h in range(2):
                    for kh in range(2):
                        def word(row):
                            off = ((col >> 4) ^ (row & 7)) * 16 + (col & 15)
                            return W[row, off // 4]
                        if not int4:
                            v = [word(32 * h + 16 * kh + 4 * t + i) for i in range(4)]
                        else:
                            p = 16 * h + 8 * kh + 2 * t
                            u0, u1 = word(p), word(p + 1)
                            v = [nibble_codes(u0 & 0x0F0F0F0F), nibble_codes((u0 >> 4) & 0x0F0F0F0F),
                                 nibble_codes(u1 & 0x0F0F0F0F), nibble_codes((u1 >> 4) & 0x0F0F0F0F)]
                        o = transpose4([torch.as_tensor(x) for x in v])
                        k0 = 32 * h + 16 * kh + 4 * t
                        for j in range(4):
                            want = codes[k0:k0 + 4, col + j].view(torch.uint8)
                            assert torch.equal(unword(o[j]), want)


def test_wgmma_bf16_epilogue_quad_trade_writes_whole_groups():
    """The wgmma epilogue's bf16 stores: thread t of a quad holds columns 8j
    + 2t, + 1 of groups j = 4q .. 4q + 3; after three ``__shfl_xor_sync``
    rounds (lane t ^ k sends its pair of group 4q + t) and the ``pick4``
    reorder, thread t's 16 bytes are columns 8 (4q + t) .. + 7 in order."""
    cols = torch.arange(32 * 8).reshape(32, 8)          # (group j, column)
    for q in range(8):
        pr = [[int(cols[4 * q + jj, 2 * t]) for jj in range(4)] for t in range(4)]

        def pick4(v, i):
            return v[i]

        def shfl_xor(k, t):
            """What lane t receives: lane t ^ k's ``pick4(pr, lane ^ k)``."""
            src = t ^ k
            return pick4(pr[src], src ^ k)
        for t in range(4):
            got = [pick4(pr[t], t)] + [shfl_xor(k, t) for k in range(1, 4)]
            out = [pick4(got, t ^ i) for i in range(4)]
            # each pair stands for columns (c, c + 1)
            assert [c + e for c in out for e in (0, 1)] == \
                list(range(8 * (4 * q + t), 8 * (4 * q + t) + 8))
