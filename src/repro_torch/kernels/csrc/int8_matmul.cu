// int8 x int8 -> int32 matmul with the fused dequant epilogue
//   out[m, n] = float(acc[m, n]) * (s_a * s_w[n])     (f32, or bf16 when the
//                                                      activations are bf16)
//
// Replaces: src/repro/kernels/int8_matmul.py::int8_matmul_pallas
//           (pl.pallas_call at int8_matmul.py:59).
//
// Three paths, which kernels/gemm_plan.py chooses from the shapes and the
// wrapper hands over as `path` (with `splits` and `kc` for split-K):
//   1 split-K (int_gemm_splitk.cuh), M <= 64: bound by bytes. The decode
//     step's (K, N) in {(2560, 2560), (2560, 6912), (6912, 2560)} at M = 8
//     stream 6.6-17.7 MB of weights (2.0-5.3 us at 3.35 TB/s) for 0.1-0.3 G
//     operations; the weight is split over K across 264+ blocks. It takes
//     the f32 or bf16 activations themselves (in_kind 1 / 2) and quantizes
//     them with s_a onto [qmin, qmax] as it stages them, so the decode step
//     launches no act_quant.
//   2 wgmma (int_gemm_wgmma.cuh), M >= 128 with N % 16 == 0: bound by
//     operations. At M = 32768, (K, N) = (4096, 14336): 3.85 T int8
//     operations (1.95 ms at 1,979 TOPS) against 1.13 GB (0.34 ms). The
//     codes come at a row pitch lda, a multiple of 16 (TMA's rows).
//   0 tiled (int_gemm.cuh): the rest, e.g. the encoder's N = 312 (64x64
//     mma.sync tiles, no pipelining).
// Every path keeps the int32 accumulator exact and runs the same f32
// epilogue, so each is bit-identical to the plain version.
#include "int_gemm.cuh"
#include "int_gemm_splitk.cuh"
#include "int_gemm_wgmma.cuh"

// path: 0 tiled, 1 split-K, 2 wgmma; ws: int32 (splits, M, N) for split-K;
// x: int8 codes (in_kind 0) at a row pitch of lda (K but on wgmma), or f32 /
// bf16 activations (in_kind 1 / 2, split-K only) with their grid [qmin, qmax]
extern "C" int int8_matmul_launch(const void* x, const void* w8, const void* s_a,
                                  const void* s_w, void* out, void* ws, int M, int N,
                                  int K, int out_bf16, int path, int splits, int kc,
                                  int lda, int in_kind, int qmin, int qmax,
                                  void* stream) {
  using namespace repro_kernels;
  if ((path != 1 && in_kind != 0) || (path != 2 && lda != K))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (path) {
    case 0:
      return launch_int_gemm<false, kScaleOnly>(x, w8, s_a, s_w, nullptr, out, M, N,
                                                K, out_bf16, stream);
    case 1:
      return splitk::launch<false, kScaleOnly>(x, w8, s_a, s_w, nullptr, out, ws, M, N,
                                               K, out_bf16, splits, kc, in_kind, qmin,
                                               qmax, stream);
    case 2:
      return wg::launch<false, kScaleOnly>(x, w8, s_a, s_w, nullptr, out, M, N, K, lda,
                                           out_bf16, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
