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
// nibbles are unpacked to int8 while the slab is staged in shared memory
// and the product runs on the int8 path, the same adaptation the TPU
// kernels made for the MXU.
//
// Bound on H100: bytes. The FFN-up layer at M = 4096 (32 requests x 128
// tokens), K = 312, N = 1200 writes 19.7 MB of f32 output against 3.07 G
// int8 ops: 5.9 us of memory time against 1.6 us of tensor-core time. The
// fused kernel applies bias and GELU in registers, so that output is
// written once instead of three times (matmul, +bias, GELU) as the unfused
// composition does; the packed weights halve the weight bytes against int8.
#include "int_gemm.cuh"

extern "C" int int4_matmul_launch(const void* x8, const void* wp,
                                  const void* s_a, const void* s_w, void* out,
                                  int M, int N, int K, int out_bf16,
                                  void* stream) {
  return repro_kernels::launch_int_gemm<true, repro_kernels::kScaleOnly>(
      x8, wp, s_a, s_w, nullptr, out, M, N, K, out_bf16, stream);
}

// act: 0 = none, 1 = tanh-GELU, 2 = ReLU
extern "C" int int4_matmul_fused_launch(const void* x8, const void* wp,
                                        const void* s_a, const void* s_w,
                                        const void* bias, void* out, int M,
                                        int N, int K, int act, int out_bf16,
                                        void* stream) {
  using namespace repro_kernels;
  switch (act) {
    case 0:
      return launch_int_gemm<true, kBiasNone>(x8, wp, s_a, s_w, bias, out, M, N, K,
                                              out_bf16, stream);
    case 1:
      return launch_int_gemm<true, kBiasGelu>(x8, wp, s_a, s_w, bias, out, M, N, K,
                                              out_bf16, stream);
    case 2:
      return launch_int_gemm<true, kBiasRelu>(x8, wp, s_a, s_w, bias, out, M, N, K,
                                              out_bf16, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
