"""Which of the integer GEMM's three CUDA paths serves a shape.

``int8_matmul``, ``int4_matmul`` and ``int4_matmul_fused`` share three
hand-written kernels for ``sm_90a``; :func:`gemm_plan` picks one from the
shapes alone (no host read of any tensor, so a call stays capturable in a
CUDA graph), and the wrappers hand its path, split count and split depth
to the C entry, which refuses a plan its kernels do not take:

* ``PATH_SPLITK`` (``csrc/int_gemm_splitk.cuh``) for ``M <= 64``, the
  decode step's ``M = 8`` and a short encoder batch: the weight is
  streamed by ``SPLITK_BN``-column blocks over ``splits`` ranges of ``kc``
  rows each, enough blocks to fill the card twice; int32 partials go to a
  workspace and a second kernel of the same launch sums them in split
  order and applies the epilogue once. Needs ``N % 16 == 0`` (TMA
  describes the weight's rows) and ``K % 4 == 0`` (word loads of the
  activations). It takes the float activations and quantizes them as it
  loads them (:func:`quantizes_in_gemm`): on this path no act_quant kernel
  runs.
* ``PATH_WGMMA`` (``csrc/int_gemm_wgmma.cuh``) for ``M >= 128`` with ``N %
  16 == 0`` and any ``K``: the long forwards' ``M = 8192`` and ``32768``,
  the prefill's ``M = 1024`` and the encoder's (312, 1200), on ``wgmma``
  s8 tensor cores with a TMA ring. TMA describes both operands' rows, so
  the activation codes come at a row pitch that is a multiple of 16 bytes
  (:func:`code_pitch`: ``K`` rounded up; the pad bytes are never read).
* ``PATH_TILED`` (``csrc/int_gemm.cuh``, the first design: 64 x 64
  ``mma.sync`` tiles) for the rest: the encoder's ``N = 312``, ``64 < M <
  128``, a small ``M`` with ``K % 4 != 0``.
"""
from __future__ import annotations

from typing import NamedTuple

PATH_TILED, PATH_SPLITK, PATH_WGMMA = 0, 1, 2
PATH_NAMES = {PATH_TILED: "tiled", PATH_SPLITK: "splitk", PATH_WGMMA: "wgmma"}

#: split-K: rows of M at most, columns a block, k rows a TMA stage, k rows a
#: split at most (all of a split's stages are in flight at once)
SPLITK_MAX_M = 64
SPLITK_BN = 128
SPLITK_STAGE_K = 64
SPLITK_MAX_KC = 512
#: blocks the split-K grid aims for: the H100's 132 SMs, twice
SPLITK_MIN_BLOCKS = 2 * 132
#: wgmma: rows of M at least, and the output tile and k depth of a stage
WGMMA_MIN_M = 128
WGMMA_BM, WGMMA_BN, WGMMA_BK = 128, 256, 128


class GemmPlan(NamedTuple):
    path: int           #: PATH_TILED, PATH_SPLITK or PATH_WGMMA
    splits: int         #: k ranges (split-K), else 1
    kc: int             #: k rows a split (split-K), else K
    ws_bytes: int       #: int32 workspace (splits, M, N) for split-K, else 0

    @property
    def name(self) -> str:
        return PATH_NAMES[self.path]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def splitk_depth(N: int, K: int) -> int:
    """The split depth ``kc``: the largest multiple of ``SPLITK_STAGE_K`` up
    to ``SPLITK_MAX_KC`` whose grid of ``ceil(N / SPLITK_BN) * ceil(K /
    kc)`` blocks reaches ``SPLITK_MIN_BLOCKS``, else one stage."""
    n_blocks = _cdiv(N, SPLITK_BN)
    for kc in range(SPLITK_MAX_KC, SPLITK_STAGE_K, -SPLITK_STAGE_K):
        if n_blocks * _cdiv(K, kc) >= SPLITK_MIN_BLOCKS:
            return kc
    return SPLITK_STAGE_K


def gemm_plan(M: int, N: int, K: int, bits: int) -> GemmPlan:
    """The path for an (M, K) x (K, N) integer GEMM with ``bits``-bit
    weights (8, or 4 packed two to a byte along K), from shapes alone."""
    if bits not in (4, 8):
        raise ValueError(f"bits: expected 4 or 8, got {bits}")
    if 1 <= M <= SPLITK_MAX_M and N % 16 == 0 and K % 4 == 0 and K > 0 and N > 0:
        kc = splitk_depth(N, K)
        splits = _cdiv(K, kc)
        return GemmPlan(PATH_SPLITK, splits, kc, 4 * splits * M * N)
    if M >= WGMMA_MIN_M and N % 16 == 0 and K > 0 and N > 0:
        return GemmPlan(PATH_WGMMA, 1, K, 0)
    return GemmPlan(PATH_TILED, 1, K, 0)


def quantizes_in_gemm(M: int, N: int, K: int, bits: int) -> bool:
    """Whether the GEMM on the card takes the float activations and
    quantizes them as it loads them (the split-K path) instead of
    ``act_quant``'s codes, from the shapes alone."""
    return gemm_plan(M, N, K, bits).path == PATH_SPLITK


def code_pitch(plan: GemmPlan, K: int) -> int:
    """The row pitch, in bytes, of the activation codes ``plan``'s path
    reads: ``K`` rounded up to 16 for wgmma (TMA's row stride), else
    ``K``."""
    return -(-K // 16) * 16 if plan.path == PATH_WGMMA else K
