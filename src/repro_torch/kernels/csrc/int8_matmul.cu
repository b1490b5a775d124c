// int8 x int8 -> int32 matmul with the fused dequant epilogue
//   out[m, n] = float(acc[m, n]) * (s_a * s_w[n])     (f32, or bf16 when the
//                                                      activations are bf16)
//
// Replaces: src/repro/kernels/int8_matmul.py::int8_matmul_pallas
//           (pl.pallas_call at int8_matmul.py:59).
//
// Bound on H100: at the serving shapes (M = rows x bucket, K and N in
// {312, 1200}) the work is 2*M*K*N int8 operations against M*K + K*N bytes
// in and 4*M*N bytes out; at M = 4096, K = 312, N = 1200 that is 3.07 G ops
// (1.6 us at 1979 TOPS) against 20.9 MB (6.2 us at 3.35 TB/s), so the kernel
// is bound by memory, and mostly by its f32 output.
//
// Design: int_gemm.cuh. The product uses the int8 tensor cores through
// mma.sync.m16n8k32; the int32 accumulator never leaves registers, and each
// output element is written once, already dequantized, which is the one
// pass over the output that the bound counts.
#include "int_gemm.cuh"

extern "C" int int8_matmul_launch(const void* x8, const void* w8,
                                  const void* s_a, const void* s_w, void* out,
                                  int M, int N, int K, int out_bf16,
                                  void* stream) {
  return repro_kernels::launch_int_gemm<false, repro_kernels::kScaleOnly>(
      x8, w8, s_a, s_w, nullptr, out, M, N, K, out_bf16, stream);
}
