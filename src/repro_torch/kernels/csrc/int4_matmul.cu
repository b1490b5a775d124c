// Packed-int4 weight matmul, plain and with the fused bias + activation
// epilogue (the paper's deployed W4A4 layer).
//
//   plain:  out[m, n] = float(acc[m, n]) * (s_a * s_w[n])
//   fused:  r = float(acc) * (s_a * s_w[n]); r = r + bias[n]; out = act(r)
//           act in {none, tanh-GELU, ReLU}
//   the epilogue runs in f32; a bf16 output is rounded once, at the store
//
// Replaces: src/repro/kernels/int4_matmul.py::int4_matmul_pallas
//           (pl.pallas_call at int4_matmul.py:105) and
//           src/repro/kernels/int4_matmul.py::int4_matmul_fused_pallas
//           (pl.pallas_call at int4_matmul.py:143).
//
// Weights arrive as (K/2, N) bytes, two codes per byte along K (row 2k in
// the low nibble, bias +7). Hopper's tensor cores have no int4 rate, so the
// nibbles are unpacked to int8 on the way to the tensor cores and the
// product runs on the int8 path, the same adaptation the TPU kernels made
// for the MXU.
//
// int4_matmul and int4_matmul_fused take one of three paths, which
// kernels/gemm_plan.py chooses from the shapes and the wrapper hands over
// as `path` (with `splits` and `kc` for split-K), each with the epilogue as
// a template parameter:
//   1 split-K (int_gemm_splitk.cuh), M <= 64: bound by bytes. The decode
//     step streams 3.3-8.8 MB of packed weights a call (1.0-2.6 us at 3.35
//     TB/s); the nibbles are unpacked in registers after the shared load.
//     It quantizes f32 or bf16 activations (in_kind 1 / 2) as it stages
//     them, so neither the decode step nor a short encoder batch launches
//     act_quant for it.
//   2 wgmma (int_gemm_wgmma.cuh), M >= 128 with N % 16 == 0: bound by
//     operations at the long shapes, as int8_matmul; the packed tile is
//     unpacked while it is re-laid K-major in shared memory. The codes come
//     at a row pitch lda, a multiple of 16: the encoder's K = 312 at 320.
//   0 tiled (int_gemm.cuh): the rest (the encoder's N = 312).
// int4_matmul_fused is the encoder's FFN-up layer (K = 312, N = 1200 for
// tinybert4; K = 768, N = 3072 for bert-base). Bound on H100: bytes. At M =
// 4096 (32 requests x 128 tokens), K = 312, N = 1200 it writes 19.7 MB of
// f32 output against 3.07 G int8 ops: 5.9 us of memory time against 1.6 us
// of tensor-core time. It applies bias and GELU in registers, so that
// output is written once instead of three times (matmul, +bias, GELU).
#include "int_gemm.cuh"
#include "int_gemm_splitk.cuh"
#include "int_gemm_wgmma.cuh"

namespace {

// path: 0 tiled, 1 split-K, 2 wgmma; ws: int32 (splits, M, N) for split-K;
// x: int8 codes (in_kind 0) at a row pitch of lda (K but on wgmma), or f32 /
// bf16 activations (in_kind 1 / 2, split-K only) with their grid [qmin, qmax]
template <int kEpi>
int int4_gemm(const void* x, const void* wp, const void* s_a, const void* s_w,
              const void* bias, void* out, void* ws, int M, int N, int K, int out_bf16,
              int path, int splits, int kc, int lda, int in_kind, int qmin, int qmax,
              void* stream) {
  using namespace repro_kernels;
  if ((path != 1 && in_kind != 0) || (path != 2 && lda != K))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (path) {
    case 0:
      return launch_int_gemm<true, kEpi>(x, wp, s_a, s_w, bias, out, M, N, K, out_bf16,
                                         stream);
    case 1:
      return splitk::launch<true, kEpi>(x, wp, s_a, s_w, bias, out, ws, M, N, K,
                                        out_bf16, splits, kc, in_kind, qmin, qmax,
                                        stream);
    case 2:
      return wg::launch<true, kEpi>(x, wp, s_a, s_w, bias, out, M, N, K, lda, out_bf16,
                                    stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int int4_matmul_launch(const void* x, const void* wp, const void* s_a,
                                  const void* s_w, void* out, void* ws, int M, int N,
                                  int K, int out_bf16, int path, int splits, int kc,
                                  int lda, int in_kind, int qmin, int qmax,
                                  void* stream) {
  return int4_gemm<repro_kernels::kScaleOnly>(x, wp, s_a, s_w, nullptr, out, ws, M, N,
                                              K, out_bf16, path, splits, kc, lda,
                                              in_kind, qmin, qmax, stream);
}

// act: 0 none, 1 tanh-GELU, 2 ReLU, after + bias
extern "C" int int4_matmul_fused_launch(const void* x, const void* wp, const void* s_a,
                                        const void* s_w, const void* bias, void* out,
                                        void* ws, int M, int N, int K, int act,
                                        int out_bf16, int path, int splits, int kc,
                                        int lda, int in_kind, int qmin, int qmax,
                                        void* stream) {
  using namespace repro_kernels;
  switch (act) {
    case 0:
      return int4_gemm<kBiasNone>(x, wp, s_a, s_w, bias, out, ws, M, N, K, out_bf16,
                                  path, splits, kc, lda, in_kind, qmin, qmax, stream);
    case 1:
      return int4_gemm<kBiasGelu>(x, wp, s_a, s_w, bias, out, ws, M, N, K, out_bf16,
                                  path, splits, kc, lda, in_kind, qmin, qmax, stream);
    case 2:
      return int4_gemm<kBiasRelu>(x, wp, s_a, s_w, bias, out, ws, M, N, K, out_bf16,
                                  path, splits, kc, lda, in_kind, qmin, qmax, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
