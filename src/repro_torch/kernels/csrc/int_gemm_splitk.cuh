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
//     go to shared memory by word loads meanwhile, zeros past M and K.
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
//     any order), and applies the
//     epilogue once to the full sum, in the tiled path's order:
//     __fmul_rn(__int2float_rn(acc), __fmul_rn(s_a, s_w[n])), then one
//     rounding to bf16. So the output is bit-identical to the plain version;
//     no split is dequantized on its own.
// The workspace comes from torch.empty in the wrapper and is written whole
// before it is read; there are no counters, so a CUDA-graph replay runs the
// same two kernels on the same buffers.
#pragma once

#include "int_gemm.cuh"

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

template <bool kInt4, int MT>
__global__ void __launch_bounds__(kThreads)
splitk_partial_kernel(const __grid_constant__ CUtensorMap map_b,
                      const int8_t* __restrict__ A, int* __restrict__ ws, int M,
                      int N, int K, int kc) {
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

  // the split's activations: (16 MT) x kc, zeros past M and past K
  const int words = kc / 4;
  for (int i = tid; i < 16 * MT * words; i += kThreads) {
    const int r = i / words, c = 4 * (i % words);
    uint32_t v = 0u;
    if (r < M && k0 + c < K)
      v = __ldg(reinterpret_cast<const uint32_t*>(A + size_t(r) * K + k0 + c));
    *reinterpret_cast<uint32_t*>(sA + r * lda + c) = v;
  }
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

template <typename OutT>
__global__ void __launch_bounds__(kReduceThreads)
splitk_reduce_kernel(const int* __restrict__ ws, const float* __restrict__ sa,
                     const float* __restrict__ sw, OutT* __restrict__ C, int M,
                     int N, int splits) {
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
    store_out(C + 4 * i + j, __fmul_rn(__int2float_rn(a[j]), __fmul_rn(s_a, sw[n + j])));
}

template <bool kInt4, int MT>
cudaError_t launch_partials(const CUtensorMap& map, const void* x8, void* ws, int M,
                            int N, int K, int splits, int kc, cudaStream_t st) {
  auto kernel = splitk_partial_kernel<kInt4, MT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem<kInt4, MT>());
  if (attr != cudaSuccess) return attr;
  const int smem = (kc / kStageK) * stage_bytes<kInt4>() + 16 * MT * (kc + kAPad) +
                   8 * kMaxStages + 1024;
  const dim3 grid((N + kBN - 1) / kBN, splits);
  kernel<<<grid, kThreads, smem, st>>>(map, static_cast<const int8_t*>(x8),
                                       static_cast<int*>(ws), M, N, K, kc);
  return cudaGetLastError();
}

// plan: splits ranges of kc rows (kernels/gemm_plan.py); ws: int32 (splits, M, N)
template <bool kInt4>
int launch(const void* x8, const void* w, const void* sa, const void* sw, void* out,
           void* ws, int M, int N, int K, int out_bf16, int splits, int kc,
           void* stream) {
  if (M < 1 || M > kMaxM || N < 16 || N % 16 != 0 || K < 4 || K % 4 != 0 ||
      kc < kStageK || kc > kMaxKc || kc % kStageK != 0 ||
      splits != (K + kc - 1) / kc || splits > 65535 || !aligned(x8, 4) ||
      !aligned(w, 16) || !aligned(ws, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap map;
  if (!byte_map(&map, w, kInt4 ? K / 2 : K, N, kBN, stage_rows<kInt4>(),
                CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      M <= 16 ? launch_partials<kInt4, 1>(map, x8, ws, M, N, K, splits, kc, st)
      : M <= 32 ? launch_partials<kInt4, 2>(map, x8, ws, M, N, K, splits, kc, st)
                : launch_partials<kInt4, 4>(map, x8, ws, M, N, K, splits, kc, st);
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
  err = out_bf16
            ? cudaLaunchKernelEx(&cfg, splitk_reduce_kernel<__nv_bfloat16>, wsi, saf, swf,
                                 static_cast<__nv_bfloat16*>(out), M, N, splits)
            : cudaLaunchKernelEx(&cfg, splitk_reduce_kernel<float>, wsi, saf, swf,
                                 static_cast<float*>(out), M, N, splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace splitk
}  // namespace repro_kernels
