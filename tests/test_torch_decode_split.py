"""The decode-attention kernels' split over the cache, on the CPU.

``csrc/decode_attention.cu`` splits each slot's cache into chunks of
``SPLIT_ROWS`` rows counted from position 0, leaves per chunk an
unnormalised ``(acc, m, l)`` in a workspace, and merges the chunks in order
with the current token last. The kernels run only on the card; here:

* the sizing the wrappers take from shapes alone (``split_plan``), and the
  arguments the wrappers hand the C entries;
* a plain-torch model of the split-and-combine arithmetic, held to
  ``decode_attention_plain`` within the card checks' f32 bound (atol 1e-5,
  rtol 0: the one-pass and the split softmax sum in different orders),
  and bit-equal to itself across cache extents and with neutral partials
  merged in place of the skipped splits.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels.kv_pack import dequantize_kv, quantize_kv

C = da.SPLIT_ROWS
CSRC = Path(da.__file__).resolve().parent / "csrc" / "decode_attention.cu"


def _inputs(B, S, H, Hkv, dh, bits, lengths, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    k_q, k_s = quantize_kv(t(B, S, Hkv, dh), bits)
    v_q, v_s = quantize_kv(t(B, S, Hkv, dh), bits)
    return [t(B, H, dh), k_q, v_q, k_s, v_s, t(B, Hkv, dh), t(B, Hkv, dh),
            torch.tensor(lengths, dtype=torch.int32)]


def split_model(q, k_q, v_q, k_scale, v_scale, k_new, v_new, lengths, *,
                neutral: bool = False):
    """The kernels' arithmetic in plain torch: per split ``(acc, m, l)`` of
    its rows below ``min(len, S)``, then ``M = max(m_0, ..., s_new)`` and
    ``l``, ``acc`` summed over splits 0, 1, ... with weights
    ``exp(m_s - M)``, the new token last. ``neutral`` merges every split of
    the extent, those past the length as ``(0, -2e38, 0)``, where the kernels
    skip them. Unwritten workspace entries are NaN."""
    B, H, dh = q.shape
    S, Hkv = k_q.shape[1], k_q.shape[2]
    G = H // Hkv
    n_split, ws_shape = da.split_plan(B, H, dh, S)
    qg = (q.float() * torch.full((), 1.0 / dh ** 0.5)).reshape(B, Hkv, G, dh)
    k, v = dequantize_kv(k_q, k_scale), dequantize_kv(v_q, v_scale)
    ws = torch.full(ws_shape, float("nan"))
    out = torch.empty((B, H, dh))
    for b in range(B):
        n_rows = min(max(int(lengths[b]), 0), S)
        ns = -(-n_rows // C)
        for s in range(ns):
            rows = slice(s * C, min((s + 1) * C, n_rows))
            sc = torch.einsum("hgd,jhd->hgj", qg[b], k[b, rows])
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            ws[b, :, s, :dh] = torch.einsum("hgj,jhd->hgd", p, v[b, rows]).reshape(H, dh)
            ws[b, :, s, dh] = m.reshape(H)
            ws[b, :, s, dh + 1] = p.sum(-1).reshape(H)
        if neutral:
            ws[b, :, ns:, :dh] = 0.0
            ws[b, :, ns:, dh] = da.NEG_INF
            ws[b, :, ns:, dh + 1] = 0.0
            ns = n_split
        s_new = (qg[b] * k_new[b].float()[:, None]).sum(-1).reshape(H)
        mm = torch.maximum(s_new, ws[b, :, :ns, dh].amax(-1)) if ns else s_new
        acc, l = torch.zeros((H, dh)), torch.zeros(H)
        for s in range(ns):
            w = torch.exp(ws[b, :, s, dh] - mm)
            l = l + ws[b, :, s, dh + 1] * w
            acc = acc + ws[b, :, s, :dh] * w[:, None]
        pn = torch.exp(s_new - mm)
        vn = v_new[b].float().repeat_interleave(G, dim=0)
        out[b] = (acc + pn[:, None] * vn) / torch.clamp_min(l + pn, 1e-30)[:, None]
    return out.to(q.dtype)


# ------------------------------------------------------------- sizing
@pytest.mark.parametrize("S,n_split", [(1, 1), (C - 1, 1), (C, 1), (C + 1, 2),
                                       (2 * C + 1, 3), (8 * C, 8), (8 * C + 8, 9)])
def test_split_plan_from_shapes(S, n_split):
    assert da.split_plan(8, 32, 80, S) == (n_split, (8, 32, n_split, 82))
    assert da.split_plan(2, 48, 128, S) == (n_split, (2, 48, n_split, 130))


def test_split_boundaries_do_not_depend_on_the_extent():
    """Dense extent 512 and a table extent of 640 (80 blocks of 8): the
    splits of the shorter extent are the first splits of the longer."""
    bounds = lambda S: [(i * C, min((i + 1) * C, S))
                        for i in range(da.split_plan(1, 1, 16, S)[0])]
    dense, paged = bounds(512), bounds(640)
    assert len(dense) == -(-512 // C) and len(paged) == -(-640 // C)
    assert paged[:len(dense) - 1] == dense[:-1]
    assert dense[-1][0] == paged[len(dense) - 1][0]
    assert da.split_plan(8, 32, 80, 0) == (0, (8, 32, 0, 82))


def test_split_rows_match_the_cuda_source():
    text = CSRC.read_text()
    assert int(re.search(r"constexpr int kSplit = (\d+);", text).group(1)) == C
    assert C % 32 == 0


@pytest.mark.parametrize("paged", [False, True])
def test_wrappers_size_the_workspace_from_shapes_alone(monkeypatch, paged):
    """The arguments each wrapper hands its C entry: as many as
    ``SIGNATURES`` names (the stream last), and the same sizes, with
    ``split_plan``'s ``n_split``, whatever the lengths."""
    calls = []
    monkeypatch.setattr(build, "check", lambda *a, **k: None)
    monkeypatch.setattr(build, "launch",
                        lambda name, dev, *args: calls.append((name, args)))
    B, S, H, Hkv, dh, blk = 3, 80, 4, 2, 16, 8
    for lengths in ([0, 5, 80], [80, 80, 200]):
        args = _inputs(B, S, H, Hkv, dh, 8, lengths)
        if paged:
            tables = torch.arange(B * S // blk, dtype=torch.int32).reshape(B, S // blk)
            pool = [a.reshape(B * S // blk, blk, *a.shape[2:]) for a in args[1:5]]
            da.decode_attention_paged_cuda(args[0], *pool, tables, *args[5:])
        else:
            da.decode_attention_cuda(*args)
    name = "decode_attention_paged" if paged else "decode_attention"
    n_split = da.split_plan(B, H, dh, S)[0]
    scale = 1.0 / dh ** 0.5
    sizes = ((B, S // blk, blk, B * S // blk, H, Hkv, dh, n_split, 8, 0, scale)
             if paged else (B, S, H, Hkv, dh, n_split, 8, 0, scale))
    for got_name, got in calls:
        assert got_name == name
        assert len(got) + 1 == len(build.SIGNATURES[name])
        assert got[len(got) - len(sizes):] == sizes


# ------------------------------------------------------------- arithmetic
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("H,Hkv,dh", [(4, 4, 16), (6, 2, 16)])
@pytest.mark.parametrize("S", [C // 2 + 8, 2 * C + 40])
def test_split_model_matches_plain(bits, H, Hkv, dh, S):
    lengths = [0, 1, 7, C - 1, C, C + 1, 2 * C + 1, S // 2, S - 1, S, S + 37]
    args = _inputs(len(lengths), S, H, Hkv, dh, bits, lengths, seed=bits + S)
    got = split_model(*args)
    torch.testing.assert_close(got, da.decode_attention_plain(*args), rtol=0, atol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_split_model_is_finite_at_lengths_0_and_1(bits):
    """NaN scales and garbage codes past the length: a slot of length 0
    returns v_new exactly, one of length 1 stays finite and within the
    bound of the plain version on the clean cache."""
    lengths = [0, 1, 0, 1]
    args = _inputs(4, 96, 4, 2, 16, bits, lengths, seed=3)
    want = da.decode_attention_plain(*args)
    for i, n in enumerate(lengths):
        for t in (1, 2):
            args[t][i, n:] = 0x5A if bits == 8 else 0xF3
        for t in (3, 4):
            args[t][i, n:] = float("nan")
    got = split_model(*args)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    vn = args[6].repeat_interleave(2, dim=1)
    assert torch.equal(got[0], vn[0]) and torch.equal(got[2], vn[2])


@pytest.mark.parametrize("bits", [8, 4])
def test_split_model_neutral_partials_and_wider_extents_are_bit_equal(bits):
    """Splits past the length carry no weight: merged as neutral partials
    they leave the bits unchanged, and a cache padded from 2C to 2.5C rows
    (a wider paged extent) gives the same bits as the dense extent."""
    S = 2 * C
    lengths = [0, 1, C - 1, C, C + 1, 3 * C // 2, S - 1, S]
    args = _inputs(len(lengths), S, 4, 2, 16, bits, lengths, seed=5)
    got = split_model(*args)
    assert torch.equal(split_model(*args, neutral=True), got)
    pad = lambda t: torch.cat([t, torch.zeros((t.shape[0], C // 2, *t.shape[2:]),
                                              dtype=t.dtype)], dim=1)
    wide = [args[0], *map(pad, args[1:5]), *args[5:]]
    assert torch.equal(split_model(*wide), got)
    assert torch.equal(split_model(*wide, neutral=True), got)
