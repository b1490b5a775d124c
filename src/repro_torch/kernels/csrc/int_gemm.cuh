// Integer GEMM shared by the int8 and packed-int4 matmul kernels.
//
// C[m, n] = epilogue(float(sum_k A[m, k] * B[k, n]) * (s_a * s_w[n]))
//
//   A   (M, K) int8 activation codes, row-major (split-K also takes the
//       f32 or bf16 activations and quantizes them as it loads them;
//       wgmma reads the codes at a row pitch of lda, a multiple of 16)
//   B   int8:  (K, N) int8 weight codes, row-major
//       int4:  (K/2, N) uint8, two codes per byte along K (row 2k = low
//              nibble, row 2k+1 = high nibble, both biased by +7)
//   C   (M, N) float32 or bf16 (the activations' dtype), row-major; the
//       epilogue runs in f32 and a bf16 output is rounded to nearest even
//       once, at the store (__float2bfloat16_rn), as the reference's
//       .astype(out_dtype) does
//
// Three paths, chosen from shapes alone by kernels/gemm_plan.py:
//   * split-K (int_gemm_splitk.cuh): M <= 64, the decode step's M = 8;
//   * wgmma (int_gemm_wgmma.cuh): M >= 128 with N % 16 == 0, the long
//     forwards, the prefill and the encoder's (312, 1200);
//   * tiled (this file): everything else (N = 312, 64 < M < 128).
// Each path takes the four epilogues (scale only for int8_matmul and
// int4_matmul; + bias, then none, tanh-GELU or ReLU for int4_matmul_fused).
// Every path keeps the int32 sums exact and runs the same epilogue, each
// f32 operation rounded on its own (__fmul_rn / __fadd_rn, no FMA
// contraction) in the reference's order, so all three are bit-identical to
// the plain PyTorch version.
//
// The tiled path: one 64x64 output tile per block of 4 warps (2x2, 32x32
// each). K advances in 64-deep slabs staged in shared memory: A as [m][k],
// B transposed to [n][k] (int4 nibbles unpacked to int8 on the way in), so
// both mma.sync.m16n8k32 s8 fragments are 4-byte shared loads. Ragged M, N
// and K edges are masked inside the kernel: out-of-range codes load as 0
// and out-of-range outputs are not written. No second stage: a slab's loads
// do not overlap the previous slab's products, which is why the shapes of
// the main paths go to the other two.
#pragma once

#include <cuda.h>
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

// the epilogue of one int32 sum, in the reference's order:
// r = acc * scale (scale = s_a * s_w[n], formed first), r = r + bias[n],
// then the activation; each f32 operation rounded on its own
template <int kEpi>
__device__ __forceinline__ float epilogue(int acc, float scale, float bias) {
  float r = __fmul_rn(__int2float_rn(acc), scale);
  if (kEpi != kScaleOnly) r = __fadd_rn(r, bias);
  if (kEpi == kBiasGelu) r = gelu_tanh(r);
  if (kEpi == kBiasRelu) r = fmaxf(r, 0.0f);
  return r;
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
        store_out(C + size_t(row) * N + col,
                  epilogue<kEpi>(acc[mi][ni][e], __fmul_rn(s_a, sw[col]),
                                 kEpi == kScaleOnly ? 0.0f : bias[col]));
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


// ------------------------------------------ TMA and mbarriers (split-K, wgmma)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the producer's arrival, announcing the bytes the stage's copies bring
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait for phase `parity` of the barrier; a wait past 4 s traps (an error
// the launch reports) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (t0 == 0) t0 = now;
    else if (now - t0 > 4000000000ull) __trap();
  }
}
// one box of a 2-d tensor map at (c0 inner, c1 outer) into shared memory,
// completing on bar; elements past the tensor's edges arrive as zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// byte transposition of a 4 x 4 block: v[i] holds bytes (c0..c3) of row i;
// o[j] gets bytes (row 0..3) of column j
__device__ __forceinline__ void transpose4(const uint32_t (&v)[4], uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);  // v0.b0 v1.b0 v0.b1 v1.b1
  const uint32_t t1 = __byte_perm(v[0], v[1], 0x7362);  // v0.b2 v1.b2 v0.b3 v1.b3
  const uint32_t t2 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}
// four nibbles (0..15, one a byte) to their int8 codes nibble - 7: bit 7
// set, 7 subtracted without a borrow between bytes, bit 7 flipped back
__device__ __forceinline__ uint32_t nibble_codes(uint32_t nib) {
  return ((nib | 0x80808080u) - 0x07070707u) ^ 0x80808080u;
}
__device__ __forceinline__ uint32_t low_codes(uint32_t packed) {
  return nibble_codes(packed & 0x0F0F0F0Fu);
}
__device__ __forceinline__ uint32_t high_codes(uint32_t packed) {
  return nibble_codes((packed >> 4) & 0x0F0F0F0Fu);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (the
// library does not link libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess)
#endif
      return EncodeTiled(nullptr);
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                : EncodeTiled(nullptr);
  }();
  return fn;
}

// a row-major (rows, cols) byte matrix, rows `pitch` bytes apart (a
// multiple of 16), as a 2-d tensor map with boxes of box_cols x box_rows;
// zeros past its edges (past `cols`, whatever the pitch)
inline bool byte_map(CUtensorMap* map, const void* base, int rows, int cols,
                     int box_cols, int box_rows, CUtensorMapSwizzle swizzle,
                     int pitch) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(pitch)};
  const cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace repro_kernels
