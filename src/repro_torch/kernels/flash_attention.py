"""Forward flash attention with GQA, causal or not, over the JAX layout.

``flash_attention_cuda`` replaces
``src/repro/kernels/flash_attention.py::flash_attention_pallas`` (its
``pl.pallas_call`` at flash_attention.py:84), the Pallas form of the JAX
package's ``models/attention.chunked_attention``, which every cacheless
forward longer than ``cfg.attn_chunk_threshold`` takes. CUDA source:
``csrc/flash_attention.cu``. Bound on H100 by operations: ``2·B·H·S²·dh``
flops causal (``4·B·H·S²·dh`` not) against ``B·S·(2H + 2Hkv)·dh`` bytes. The
kernel keeps each (64, 64) score tile and the online-softmax state on chip,
so no (S, S) tensor exists in device memory, and maps query head ``h`` to KV
head ``h // (H // Hkv)`` itself, so K and V are never repeated. bf16 inputs
(every path) take the tensor-core kernel: wgmma on the bf16 operands with
f32 sums, p split into two bf16 parts for P·V, K/V tiles loaded by TMA;
f32 inputs take the f32 SIMT kernel. Both count as one launch.

``flash_attention_plain`` mirrors the Pallas body block by block (f32
operands, the scale applied to q before the product, the finite ``-2e38``
mask, the causal bound ``(qi + 1) * bq // bk``, ``acc / max(l, 1e-30)``),
with every head of a block in one batched product: it holds one (B, H, bq,
bk) score block at a time.
"""
from __future__ import annotations

import torch

from . import build

NEG_INF = -2.0e38
#: the kernels' key tile (the f32 kernel's query tile too; the bf16 one
#: takes 128 query rows)
TILE = 64
#: q / k / v / output dtypes, by the flag the C entry takes
IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is built for: stablelm-3b's 80 and llava's 128 on
#: the path, 16 and 64 in the small checks
HEAD_DIMS = (16, 64, 80, 128)


def _scale(dh: int) -> float:
    """1/sqrt(dh) as the reference forms it: in double, then f32."""
    return 1.0 / float(dh) ** 0.5


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, bq: int,
                          bk: int) -> torch.Tensor:
    """Plain version: q (B, S, H, dh), k/v (B, S, Hkv, dh) with H % Hkv ==
    0 -> (B, S, H, dh) in q's dtype. Blocks of ``bq`` query and ``bk`` key
    rows (each cut to S) with ``S % bq == S % bk == bq % bk == 0``, as the
    Pallas kernel requires."""
    build.note_plain(q, "flash_attention")
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    if H % Hkv or tuple(k.shape) != (B, S, Hkv, dh) or k.shape != v.shape:
        raise ValueError(f"flash attention takes q (B, S, H, dh) and k/v (B, S, "
                         f"Hkv, dh) with H % Hkv == 0, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    bq, bk = min(bq, S), min(bk, S)
    if S % bq or S % bk or bq % bk:
        raise ValueError(f"flash_attention_plain: blocks ({bq}, {bk}) do not "
                         f"tile S={S} (S % bq == S % bk == bq % bk == 0)")
    g = H // Hkv
    scale = torch.full((), _scale(dh), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    for qi in range(S // bq):
        # (B, Hkv, g, bq, dh): query head h = hk * g + i reads KV head hk
        qb = (q[:, qi * bq:(qi + 1) * bq].to(torch.float32) * scale).reshape(
            B, bq, Hkv, g, dh).permute(0, 2, 3, 1, 4)
        acc = torch.zeros((B, Hkv, g, bq, dh), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, Hkv, g, bq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, g, bq), dtype=torch.float32, device=q.device)
        # causal: key blocks strictly after this query block contribute nothing
        upper = (qi + 1) * bq // bk if causal else S // bk
        for j in range(upper):
            kb = k[:, j * bk:(j + 1) * bk].to(torch.float32).permute(0, 2, 1, 3)
            vb = v[:, j * bk:(j + 1) * bk].to(torch.float32).permute(0, 2, 1, 3)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb)
            if causal:
                qpos = qi * bq + torch.arange(bq, device=q.device)[:, None]
                kpos = j * bk + torch.arange(bk, device=q.device)[None, :]
                s = torch.where(kpos <= qpos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, qi * bq:(qi + 1) * bq] = o.permute(0, 3, 1, 2, 4).reshape(
            B, bq, H, dh).to(q.dtype)
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, dh) f32 or bf16; k/v: (B, S, Hkv, dh) in q's dtype with
    H % Hkv == 0; dh in ``HEAD_DIMS``; any S >= 1; B * H <= 65535. Returns
    (B, S, H, dh) in q's dtype."""
    dev = q.device
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, S, H, dh) and k/v (B, S, Hkv, dh), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    if q.dtype not in IN_DTYPES:
        raise TypeError(f"q: expected one of {list(IN_DTYPES)}, got {q.dtype}")
    if dh not in HEAD_DIMS or Hkv < 1 or H % Hkv or B * H > 65535:
        raise ValueError(f"flash_attention kernel takes dh in {HEAD_DIMS}, "
                         f"H % Hkv == 0 and B * H <= 65535; got B={B}, H={H}, "
                         f"Hkv={Hkv}, dh={dh}")
    build.check(q, "q", q.dtype, (B, S, H, dh), dev)
    build.check(k, "k", q.dtype, (B, S, Hkv, dh), dev)
    build.check(v, "v", q.dtype, (B, S, Hkv, dh), dev)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel():
        build.launch("flash_attention", dev, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), B, S, H, Hkv, dh,
                     int(causal), IN_DTYPES[q.dtype], _scale(dh))
    return out


def bound_flops(B: int, S: int, H: int, dh: int, causal: bool) -> float:
    """Flops of one call: QK^T and P.V over the whole (S, S) score matrix,
    half of it causal."""
    return (2.0 if causal else 4.0) * B * H * S * S * dh


def bound_bytes(B: int, S: int, H: int, Hkv: int, dh: int,
                itemsize: int) -> int:
    """Bytes one call must move: q, k and v read once, out written once."""
    return B * S * (2 * H + 2 * Hkv) * dh * itemsize


__all__ = ["NEG_INF", "TILE", "HEAD_DIMS", "flash_attention_plain",
           "flash_attention_cuda", "bound_flops", "bound_bytes"]
