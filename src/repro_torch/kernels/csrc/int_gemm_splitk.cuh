// Split-K path of the integer GEMM, for small M (the decode step's M = 8).
//
// Same function and layouts as int_gemm.cuh. Taken for 1 <= M <= 64 with
// N % 16 == 0 and K % 4 == 0 (kernels/gemm_plan.py); at decode the work is
// streaming the weight (3.3-8.8 MB of int4, twice that at int8, 1-2.6 us at
// 3.35 TB/s), so the design is about bytes in flight across the card:
//
//   * Kernel 1: one block of 4 warps per (kBN = 128 columns, split of kc
//     rows of K). kc is a multiple of kStageK = 64, at most kMaxKc = 512,
//     chosen by the plan so that the grid holds at least 264 blocks (twice
//     the 132 SMs). Thread 0 issues every TMA copy of the split's weight
//     rows at once, one 64-row stage (8 KB int8, 4 KB int4) on each
//     mbarrier, with the 128-byte swizzle; the split's activations (M x kc)
//     go to shared memory meanwhile, zeros past M and K: int8 codes by word
//     loads, or f32 / bf16 activations by 16- / 8-byte loads of 4 elements,
//     each quantized by act_quant's own quant1 (quant.cuh) and the 4 codes
//     stored as one word; a thread has 16 (codes) or 8 (f32, bf16) loads
//     in flight at once, all of a split's at M = 8. So the decode step runs no act_quant kernel: its
//     quantization hides behind the weight's TMA stages, and the codes are
//     act_quant's bit for bit.
//     Each warp owns 32 columns: a thread reads one 4-byte word of 4
//     columns from 4 k rows (int8) or 2 packed rows (int4, unpacked by
//     nibble_codes), transposes the 4 x 4 bytes with __byte_perm
//     (ldmatrix.trans has no 8-bit form), and holds the results as the B
//     fragments of 4 n8 sub-tiles of mma.sync.m16n8k32: sub-tile j's column
//     g is physical column 4g + j, so no byte is read twice. The int32 sums
//     of the split go to an int32 workspace (splits, M, N).
//   * Kernel 2, launched from the same C entry as a programmatic dependent
//     of kernel 1 (one counted launch): each thread loads 4 columns of up
//     to 16 splits at once, sums them in split order in int32 (exact in
//     any order), and applies the epilogue once to the full sum, in the
//     tiled path's order: __fmul_rn(__int2float_rn(acc), __fmul_rn(s_a,
//     s_w[n])), then (int4_matmul_fused) __fadd_rn(r, bias[n]) and GELU or
//     ReLU, then one rounding to bf16. So the output is bit-identical to the
//     plain version; no split is dequantized on its own.
// The workspace comes from torch.empty in the wrapper and is written whole
// before it is read; there are no counters, so a CUDA-graph replay runs the
// same two kernels on the same buffers.
#pragma once

#include "int_gemm.cuh"
#include "quant.cuh"

namespace repro_kernels {
namespace splitk {

constexpr int kBN = 128;       // columns a block: 4 warps x 32
constexpr int kStageK = 64;    // k rows a stage (one TMA box)
constexpr int kMaxKc = 512;    // k rows a split at most: 8 stages, all in flight
constexpr int kMaxM = 64;      // rows of M at most: 4 m16 tiles
constexpr int kThreads = 128;
constexpr int kMaxStages = kMaxKc / kStageK;
constexpr int kAPad = 16;      // activations' shared rows: kc + 16 bytes
constexpr int kReduceThreads = 128;
constexpr int kReduceBatch = 16;  // splits a reduce thread loads at once

// what the activations are: int8 codes, or f32 / bf16 values to quantize
enum ActIn { kCodes = 0, kF32 = 1, kBf16 = 2 };

template <bool kInt4>
__host__ __device__ constexpr int stage_rows() { return kInt4 ? kStageK / 2 : kStageK; }
template <bool kInt4>
__host__ __device__ constexpr int stage_bytes() { return stage_rows<kInt4>() * kBN; }
template <bool kInt4, int MT>
__host__ __device__ constexpr int max_smem() {
  return kMaxStages * stage_bytes<kInt4>() + 16 * MT * (kMaxKc + kAPad) +
         8 * kMaxStages + 1024;
}

// word (4 columns) at byte column `col` of row `row` of a stage written by
// TMA with the 128-byte swizzle (16-byte chunk c of row r lands at c ^ (r & 7))
__device__ __forceinline__ uint32_t swz_word(const unsigned char* stage, int row,
                                             int col) {
  const int off = row * kBN + ((((col >> 4) ^ (row & 7)) << 4) | (col & 15));
  return *reinterpret_cast<const uint32_t*>(stage + off);
}

// four activations of kind kIn as loaded (V) and as their four codes
template <int kIn> struct ActIn4;
template <> struct ActIn4<kCodes> {
  using T = int8_t;
  using V = uint32_t;
  static constexpr int kBatch = 16;  // loads a thread has in flight at once
  __device__ static uint32_t codes(V v, float, float, float) { return v; }
};
template <> struct ActIn4<kF32> {
  using T = float;
  using V = float4;
  static constexpr int kBatch = 8;
  __device__ static uint32_t codes(const V& v, float s, float qmin, float qmax) {
    const float f[4] = {v.x, v.y, v.z, v.w};
    return quant4(f, s, qmin, qmax);
  }
};
template <> struct ActIn4<kBf16> {
  using T = __nv_bfloat16;
  using V = uint2;
  static constexpr int kBatch = 8;
  __device__ static uint32_t codes(const V& v, float s, float qmin, float qmax) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    const float f[4] = {__low2float(a), __high2float(a), __low2float(b), __high2float(b)};
    return quant4(f, s, qmin, qmax);
  }
};

// rows [0, rows) x columns [k0, k0 + kc) of the activations (row pitch K)
// into sA (row pitch lda) as int8 codes, zeros past `rows` up to 16 MT and
// past K (K % 4 == 0, so a group of 4 columns is all in or all out). A
// thread issues kBatch group loads at once, then turns them into code
// words: int8 codes as they are, f32 / bf16 through quant1 (quant.cuh).
template <int kIn, int MT>
__device__ __forceinline__ void stage_activations(const void* __restrict__ A,
                                                  unsigned char* sA, int lda, int rows,
                                                  int K, int k0, int kc, float s,
                                                  float qmin, float qmax) {
  using In = ActIn4<kIn>;
  const typename In::T* a = static_cast<const typename In::T*>(A);
  const int words = kc / 4, real = rows * words;
  for (int i = real + threadIdx.x; i < 16 * MT * words; i += kThreads)
    *reinterpret_cast<uint32_t*>(sA + (i / words) * lda + 4 * (i % words)) = 0u;
  for (int i0 = threadIdx.x; i0 < real; i0 += In::kBatch * kThreads) {
    typename In::V v[In::kBatch];
#pragma unroll
    for (int u = 0; u < In::kBatch; ++u) {
      const int i = i0 + u * kThreads, r = i / words, c = 4 * (i % words);
      if (i < real && k0 + c < K)
        v[u] = __ldg(reinterpret_cast<const typename In::V*>(a + size_t(r) * K + k0 + c));
    }
#pragma unroll
    for (int u = 0; u < In::kBatch; ++u) {
      const int i = i0 + u * kThreads, r = i / words, c = 4 * (i % words);
      if (i >= real) break;
      *reinterpret_cast<uint32_t*>(sA + r * lda + c) =
          k0 + c < K ? In::codes(v[u], s, qmin, qmax) : 0u;
    }
  }
}

template <bool kInt4, int MT, int kIn>
__global__ void __launch_bounds__(kThreads)
splitk_partial_kernel(const __grid_constant__ CUtensorMap map_b,
                      const void* __restrict__ A, const float* __restrict__ sa,
                      int* __restrict__ ws, int M, int N, int K, int kc, float qmin,
                      float qmax) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = align1024(smem_raw);
  constexpr int kBytes = stage_bytes<kInt4>();
  const int split = blockIdx.y, n0 = blockIdx.x * kBN;
  const int k0 = split * kc;
  const int kn = min(kc, K - k0);
  const int n_st = (kn + kStageK - 1) / kStageK;
  const int lda = kc + kAPad;
  unsigned char* const sB = smem;
  unsigned char* const sA = smem + (kc / kStageK) * kBytes;
  const uint32_t bars = smem_u32(sA + 16 * MT * lda);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < n_st; ++s) mbar_init(bars + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < n_st; ++s) {
      mbar_expect(bars + 8 * s, kBytes);
      tma_load_2d(smem_u32(sB + s * kBytes), &map_b, n0,
                  (k0 + s * kStageK) / (kInt4 ? 2 : 1), bars + 8 * s);
    }
  }
  // let the reduce kernel launch once every block has started
  pdl_launch_dependents();

  // the split's activations (as codes) while the weight's stages arrive
  stage_activations<kIn, MT>(A, sA, lda, M, K, k0, kc, kIn == kCodes ? 1.0f : *sa, qmin,
                             qmax);
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col = 32 * warp + 4 * g;  // this thread's 4 columns, in a stage row
  int acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

  for (int s = 0; s < n_st; ++s) {
    mbar_wait(bars + 8 * s, 0);
    const unsigned char* const st = sB + s * kBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // two k32 steps a stage
      uint32_t b[4][2];
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        uint32_t v[4], o[4];
        if (!kInt4) {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = swz_word(st, 32 * h + 16 * kh + 4 * t + i, col);
        } else {
          const int p = 16 * h + 8 * kh + 2 * t;  // packed rows p, p + 1: k = 2p .. 2p + 3
          const uint32_t u0 = swz_word(st, p, col), u1 = swz_word(st, p + 1, col);
          v[0] = low_codes(u0);
          v[1] = high_codes(u0);
          v[2] = low_codes(u1);
          v[3] = high_codes(u1);
        }
        transpose4(v, o);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j][kh] = o[j];
      }
      const int kk = s * kStageK + 32 * h;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const unsigned char* ar = sA + (16 * mt + g) * lda + kk + 4 * t;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(ar),
                               *reinterpret_cast<const uint32_t*>(ar + 8 * lda),
                               *reinterpret_cast<const uint32_t*>(ar + 16),
                               *reinterpret_cast<const uint32_t*>(ar + 8 * lda + 16)};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], a, b[j]);
      }
    }
  }

  // accumulator (mt, j, e): row 16 mt + g + 8 (e >> 1), column
  // 32 warp + 4 (2t + (e & 1)) + j, so a thread holds columns
  // 32 warp + 8t .. + 7 of each of its rows: two 16-byte stores
  const int n = n0 + 32 * warp + 8 * t;
  if (n >= N) return;  // N % 16 == 0: the 8 columns are all in or all out
  int* const wsp = ws + size_t(split) * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = 16 * mt + g + 8 * hr;
      if (row >= M) continue;
      int4* dst = reinterpret_cast<int4*>(wsp + size_t(row) * N + n);
      dst[0] = make_int4(acc[mt][0][2 * hr], acc[mt][1][2 * hr], acc[mt][2][2 * hr],
                         acc[mt][3][2 * hr]);
      dst[1] = make_int4(acc[mt][0][2 * hr + 1], acc[mt][1][2 * hr + 1],
                         acc[mt][2][2 * hr + 1], acc[mt][3][2 * hr + 1]);
    }
}

template <typename OutT, int kEpi>
__global__ void __launch_bounds__(kReduceThreads)
splitk_reduce_kernel(const int* __restrict__ ws, const float* __restrict__ sa,
                     const float* __restrict__ sw, const float* __restrict__ bias,
                     OutT* __restrict__ C, int M, int N, int splits) {
  pdl_wait();  // every split's partials are written
  const long long quads = static_cast<long long>(M) * N / 4;
  const long long i = static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (i >= quads) return;
  const int4* w4 = reinterpret_cast<const int4*>(ws);
  int4 acc = make_int4(0, 0, 0, 0);
  // kReduceBatch splits' loads in flight at once (one L2 round trip), then
  // their sums in split order
  for (int s0 = 0; s0 < splits; s0 += kReduceBatch) {
    int4 v[kReduceBatch];
#pragma unroll
    for (int j = 0; j < kReduceBatch; ++j)
      v[j] = s0 + j < splits ? __ldcg(w4 + (s0 + j) * quads + i) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < kReduceBatch; ++j) {
      acc.x += v[j].x;
      acc.y += v[j].y;
      acc.z += v[j].z;
      acc.w += v[j].w;
    }
  }
  const int n = static_cast<int>((4 * i) % N);
  const float s_a = *sa;
  const int a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    store_out(C + 4 * i + j, epilogue<kEpi>(a[j], __fmul_rn(s_a, sw[n + j]),
                                            kEpi == kScaleOnly ? 0.0f : bias[n + j]));
}

template <bool kInt4, int MT, int kIn>
cudaError_t launch_partials(const CUtensorMap& map, const void* x, const void* sa,
                            void* ws, int M, int N, int K, int splits, int kc,
                            float qmin, float qmax, cudaStream_t st) {
  auto kernel = splitk_partial_kernel<kInt4, MT, kIn>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem<kInt4, MT>());
  if (attr != cudaSuccess) return attr;
  const int smem = (kc / kStageK) * stage_bytes<kInt4>() + 16 * MT * (kc + kAPad) +
                   8 * kMaxStages + 1024;
  const dim3 grid((N + kBN - 1) / kBN, splits);
  kernel<<<grid, kThreads, smem, st>>>(map, x, static_cast<const float*>(sa),
                                       static_cast<int*>(ws), M, N, K, kc, qmin, qmax);
  return cudaGetLastError();
}

template <bool kInt4, int kIn>
cudaError_t launch_partials_m(const CUtensorMap& map, const void* x, const void* sa,
                              void* ws, int M, int N, int K, int splits, int kc,
                              float qmin, float qmax, cudaStream_t st) {
  return M <= 16 ? launch_partials<kInt4, 1, kIn>(map, x, sa, ws, M, N, K, splits, kc,
                                                  qmin, qmax, st)
         : M <= 32 ? launch_partials<kInt4, 2, kIn>(map, x, sa, ws, M, N, K, splits,
                                                    kc, qmin, qmax, st)
                   : launch_partials<kInt4, 4, kIn>(map, x, sa, ws, M, N, K, splits,
                                                    kc, qmin, qmax, st);
}

// plan: splits ranges of kc rows (kernels/gemm_plan.py); ws: int32 (splits,
// M, N); x: int8 codes, or (in_kind kF32 / kBf16) the activations, which
// are quantized with s_a onto [qmin, qmax] as they are staged
template <bool kInt4, int kEpi>
int launch(const void* x, const void* w, const void* sa, const void* sw,
           const void* bias, void* out, void* ws, int M, int N, int K, int out_bf16,
           int splits, int kc, int in_kind, int qmin, int qmax, void* stream) {
  // a group of 4 activations is one 4-byte (codes), 16-byte (f32) or
  // 8-byte (bf16) load
  const int x_align = in_kind == kCodes ? 4 : in_kind == kF32 ? 16 : 8;
  if (M < 1 || M > kMaxM || N < 16 || N % 16 != 0 || K < 4 || K % 4 != 0 ||
      kc < kStageK || kc > kMaxKc || kc % kStageK != 0 ||
      splits != (K + kc - 1) / kc || splits > 65535 || in_kind < kCodes ||
      in_kind > kBf16 || qmin > qmax || !aligned(x, x_align) || !aligned(w, 16) ||
      !aligned(ws, 16) || (kEpi != kScaleOnly && bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap map;
  if (!byte_map(&map, w, kInt4 ? K / 2 : K, N, kBN, stage_rows<kInt4>(),
                CU_TENSOR_MAP_SWIZZLE_128B, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const float lo = static_cast<float>(qmin), hi = static_cast<float>(qmax);
  cudaError_t err =
      in_kind == kCodes ? launch_partials_m<kInt4, kCodes>(map, x, sa, ws, M, N, K, splits,
                                                            kc, lo, hi, st)
      : in_kind == kF32 ? launch_partials_m<kInt4, kF32>(map, x, sa, ws, M, N, K, splits,
                                                          kc, lo, hi, st)
                        : launch_partials_m<kInt4, kBf16>(map, x, sa, ws, M, N, K, splits,
                                                           kc, lo, hi, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the reduce, as a programmatic dependent launch of the partials
  cudaLaunchConfig_t cfg = {};
  const long long quads = static_cast<long long>(M) * N / 4;
  cfg.gridDim = dim3(static_cast<unsigned>((quads + kReduceThreads - 1) / kReduceThreads));
  cfg.blockDim = dim3(kReduceThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int* wsi = static_cast<const int*>(ws);
  const float* saf = static_cast<const float*>(sa);
  const float* swf = static_cast<const float*>(sw);
  const float* bf = static_cast<const float*>(bias);
  err = out_bf16
            ? cudaLaunchKernelEx(&cfg, splitk_reduce_kernel<__nv_bfloat16, kEpi>, wsi, saf,
                                 swf, bf, static_cast<__nv_bfloat16*>(out), M, N, splits)
            : cudaLaunchKernelEx(&cfg, splitk_reduce_kernel<float, kEpi>, wsi, saf, swf, bf,
                                 static_cast<float*>(out), M, N, splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace splitk
}  // namespace repro_kernels
