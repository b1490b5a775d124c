// Integer GEMM shared by the int8 and packed-int4 matmul kernels.
//
// C[m, n] = epilogue(float(sum_k A[m, k] * B[k, n]) * (s_a * s_w[n]))
//
//   A   (M, K) int8 activation codes, row-major
//   B   int8:  (K, N) int8 weight codes, row-major
//       int4:  (K/2, N) uint8, two codes per byte along K (row 2k = low
//              nibble, row 2k+1 = high nibble, both biased by +7)
//   C   (M, N) float32 or bf16 (the activations' dtype), row-major; the
//       epilogue runs in f32 and a bf16 output is rounded to nearest even
//       once, at the store (__float2bfloat16_rn), as the reference's
//       .astype(out_dtype) does
//
// Design: one 64x64 output tile per block of 4 warps (2x2, 32x32 each).
// K advances in 64-deep slabs staged in shared memory: A as [m][k], B
// transposed to [n][k] (int4 nibbles unpacked to int8 on the way in), so
// both mma.sync.m16n8k32 s8 fragments are 4-byte shared loads. Ragged M, N
// and K edges are masked inside the kernel: out-of-range codes load as 0
// and out-of-range outputs are not written. The int32 accumulators stay in
// registers until the epilogue, which rounds every f32 operation on its
// own (__fmul_rn / __fadd_rn, no FMA contraction) in the reference's
// order, so the result is bit-identical to the plain PyTorch version.
//
// Not yet: wgmma, TMA, multi-stage pipelining, split-K.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_kernels {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;
// shared rows are 80 bytes (20 words): the 8 rows x 4 words of one
// fragment load then hit 32 distinct banks
constexpr int kLds = kBK + 16;

enum Epilogue { kScaleOnly = 0, kBiasNone = 1, kBiasGelu = 2, kBiasRelu = 3 };

// jax.nn.gelu(approximate=True) in its own operation order:
// x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner =
      __fmul_rn(0.7978845608028654f, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4 consecutive bytes of a row, zero past `limit`; one word load when the
// row is word-aligned throughout.
__device__ __forceinline__ uint32_t load4(const uint8_t* row, int col,
                                          int limit, bool vec) {
  if (vec) return col < limit ? *reinterpret_cast<const uint32_t*>(row + col) : 0u;
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col + j < limit) v |= uint32_t(row[col + j]) << (8 * j);
  return v;
}

__device__ __forceinline__ void store_out(float* p, float r) { *p = r; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float r) {
  *p = __float2bfloat16_rn(r);
}

__device__ __forceinline__ uint32_t unpack_nibble_byte(uint32_t b, int shift) {
  return uint32_t(uint8_t(int((b >> shift) & 0xF) - 7));
}

template <bool kInt4, int kEpi, typename OutT>
__global__ void __launch_bounds__(kThreads)
int_gemm_kernel(const int8_t* __restrict__ A, const uint8_t* __restrict__ B,
                const float* __restrict__ sa, const float* __restrict__ sw,
                const float* __restrict__ bias, OutT* __restrict__ C, int M,
                int N, int K) {
  __shared__ __align__(16) uint8_t As[kBM][kLds];
  __shared__ __align__(16) uint8_t Bs[kBN][kLds];  // transposed: [n][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const int group = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const uint8_t* Ab = reinterpret_cast<const uint8_t*>(A);
  const bool a_vec = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(A) % 4 == 0);
  const bool b_vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(B) % 4 == 0);

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A slab: 64 rows x 16 words
#pragma unroll
    for (int i = 0; i < (kBM * kBK / 4) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kBK / 4), c = (idx % (kBK / 4)) * 4;
      const int gm = m0 + r;
      const uint32_t v =
          gm < M ? load4(Ab + size_t(gm) * K, k0 + c, K, a_vec) : 0u;
      *reinterpret_cast<uint32_t*>(&As[r][c]) = v;
    }
    // B slab: 16 x 16 sub-blocks of 4 k x 4 n, transposed in registers
#pragma unroll
    for (int i = 0; i < (kBK / 4) * (kBN / 4) / kThreads; ++i) {
      const int sb = tid + i * kThreads;
      const int kg = sb / (kBN / 4), ng = sb % (kBN / 4);
      const int gn = n0 + ng * 4;
      uint32_t w[4] = {0u, 0u, 0u, 0u};  // w[j]: 4 k codes of column gn + j
      if (!kInt4) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int gk = k0 + kg * 4 + kk;
          const uint32_t v = gk < K ? load4(B + size_t(gk) * N, gn, N, b_vec) : 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j) w[j] |= ((v >> (8 * j)) & 0xFFu) << (8 * kk);
        }
      } else {
        const int Kp = K / 2;
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          const int gkp = k0 / 2 + kg * 2 + pp;
          if (gkp >= Kp) continue;  // codes past K stay 0, not -7
          const uint32_t v = load4(B + size_t(gkp) * N, gn, N, b_vec);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (gn + j >= N) continue;
            const uint32_t byte = (v >> (8 * j)) & 0xFFu;
            w[j] |= unpack_nibble_byte(byte, 0) << (16 * pp);
            w[j] |= unpack_nibble_byte(byte, 4) << (16 * pp + 8);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(&Bs[ng * 4 + j][kg * 4]) = w[j];
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = warp_m * 32 + mi * 16 + group;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][ks + tig * 4]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + tig * 4]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][ks + 16 + tig * 4]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + 16 + tig * 4]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = warp_n * 32 + ni * 8 + group;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][ks + tig * 4]);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[n][ks + 16 + tig * 4]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  const float s_a = *sa;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + warp_m * 32 + mi * 16 + group + (e >> 1) * 8;
        const int col = n0 + warp_n * 32 + ni * 8 + tig * 2 + (e & 1);
        if (row >= M || col >= N) continue;
        float r = __fmul_rn(__int2float_rn(acc[mi][ni][e]), __fmul_rn(s_a, sw[col]));
        if (kEpi != kScaleOnly) r = __fadd_rn(r, bias[col]);
        if (kEpi == kBiasGelu) r = gelu_tanh(r);
        if (kEpi == kBiasRelu) r = fmaxf(r, 0.0f);
        store_out(C + size_t(row) * N + col, r);
      }
}

template <bool kInt4, int kEpi, typename OutT>
int launch_int_gemm_t(const void* x8, const void* w, const void* sa,
                      const void* sw, const void* bias, void* out, int M,
                      int N, int K, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int_gemm_kernel<kInt4, kEpi, OutT><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x8), static_cast<const uint8_t*>(w),
      static_cast<const float*>(sa), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<OutT*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// out_bf16: 0 = f32 output, 1 = bf16 output
template <bool kInt4, int kEpi>
int launch_int_gemm(const void* x8, const void* w, const void* sa,
                    const void* sw, const void* bias, void* out, int M, int N,
                    int K, int out_bf16, void* stream) {
  if (out_bf16)
    return launch_int_gemm_t<kInt4, kEpi, __nv_bfloat16>(x8, w, sa, sw, bias,
                                                         out, M, N, K, stream);
  return launch_int_gemm_t<kInt4, kEpi, float>(x8, w, sa, sw, bias, out, M, N,
                                               K, stream);
}

}  // namespace repro_kernels
