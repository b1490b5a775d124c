// wgmma path of the integer GEMM, for large M (the long forwards' M = 8192
// and 32768, the prefill's M = 1024).
//
// Same function and layouts as int_gemm.cuh. Taken for M >= 128 with N %
// 16 == 0 and any K (kernels/gemm_plan.py: TMA describes both operands'
// rows; the activation codes come at a row pitch lda that is a multiple of
// 16 bytes, padded past K where K is not, e.g. the encoder's K = 312 at a
// pitch of 320, and TMA reads only their K real columns). Bound on H100 by
// operations at the long shapes: 2 M K N int8 operations at 1,979 TOPS (a
// (32768, 14336) x (14336, 4096) product: 1.95 ms) against M K + K N (or
// K N / 2) + 2 M N bytes (0.80 GB there: 0.24 ms at 3.35 TB/s); by bytes
// at the encoder's shallow K (int4_matmul_fused at M = 4096, K = 312, N =
// 1200, f32 out: 21.1 MB, 6.3 us, against 3.1 G operations, 1.5 us).
//
//   * 128 x 256 output tiles, grouped by 8 row tiles so that blocks that
//     run together share their weight columns in L2; one persistent block
//     an SM walks its tiles, with its k tiles one stream across them, so
//     the next tile's loads and first re-layout overlap the last one's
//     epilogue. A block is two consumer warpgroups of 64 rows each and one
//     producer warpgroup (384 threads). One producer thread keeps a ring of
//     kStages stages in flight by TMA, each 128 k deep: the activation
//     tile (128 rows x 128 bytes, the 128-byte swizzle, the K-major A
//     operand as it is) and the raw weight tile (128 k rows x 256 bytes
//     int8, or 64 packed rows), both on the stage's `full` mbarrier; the
//     consumers free a stage on its `empty` mbarrier (256 arrivals).
//   * wgmma on 8-bit types takes both operands K-major from shared memory
//     (no transposed B as for f16/bf16), and the weights are (K, N)
//     row-major: the consumers re-lay each raw weight tile into a K-major
//     tile of 256 rows x 128 bytes with the 128-byte swizzle, unpacking int4
//     nibbles in the same pass. A thread reads 16 k rows (8 packed rows) of
//     4 columns as words, transposes them with __byte_perm and writes four
//     16-byte chunks; the columns a lane writes first rotate with the lane,
//     so neither the reads nor the writes of a warp meet in a bank. Each
//     weight byte costs one shared read and write, spread over 128 rows of
//     the activations.
//   * k tile kt: each warpgroup issues its four m64n256k32 s8 products on
//     A(kt) and the K-major tile kt (double buffered), then re-lays raw
//     tile kt + 1 while the tensor cores work, waits for its products,
//     frees stage kt and meets the other warpgroup at a named barrier.
//   * The int32 sums stay in registers (128 a thread); the epilogue is the
//     tiled path's (scale; for int4_matmul_fused + bias and GELU or ReLU),
//     in f32 then one rounding to bf16, with stores past M or N masked.
//     For bf16 the 4 threads of a quad trade their column pairs by
//     shuffles so that each writes 16 contiguous bytes: a quarter of the
//     store instructions of 4-byte pairs, which bound the epilogue, and
//     whole 32-byte sectors. TMA fills rows past M and columns past K with
//     zeros, which is exact for integer sums (a zero packed byte is two
//     codes of -7, but it meets only zero activations), so a ragged K runs
//     ceil(K / 128) k tiles on zero fill.
//   * Every wgmma lies on a path the whole warpgroup takes; the role split
//     reads the warpgroup index through a shuffle, as a uniform value.
//   * Registers: ptxas gives each of 384 threads 168, too few for 128
//     int32 sums beside the re-layout's words; setmaxnreg moves the
//     producer warpgroup to 40 and the consumers to 232.
#pragma once

#include "int_gemm.cuh"

namespace repro_kernels {
namespace wg {

constexpr int kBM = 128;    // rows a block: two consumer warpgroups of 64
constexpr int kBN = 256;    // columns a block: one m64n256k32 a warpgroup and k32 step
constexpr int kBK = 128;    // k a stage: four k32 steps, one 128-byte swizzle row
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
// registers a thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 = 384 x 168,
// the 168 a thread ptxas gives 384 threads at entry
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kGroupM = 8;  // row tiles a raster group

template <bool kInt4>
struct Smem {
  static constexpr int kStages = kInt4 ? 4 : 3;
  static constexpr int kA = kBM * kBK;                         // 16 KB
  static constexpr int kBraw = (kInt4 ? kBK / 2 : kBK) * kBN;  // 16 or 32 KB
  static constexpr int kStage = kA + kBraw;
  static constexpr int kBk = kBN * kBK;                        // 32 KB, K-major
  static constexpr int kBars = kStages * kStage + 2 * kBk;
  static constexpr int kBytes = kBars + 16 * kStages + 1024;   // + alignment
};

// wgmma matrix descriptor of a K-major operand with the 128-byte swizzle
// (layout type 1): 8-row groups 1024 bytes apart; a k32 step within the
// 128-byte row moves the start address by 32 bytes
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the two consumer warpgroups meet (barrier 1; barrier 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}
// keeps the compiler from moving reads or writes of r across a wgmma that
// is still in flight
// v[i] for an index known only at run time, by selects (no local memory)
__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}
template <int N>
__device__ __forceinline__ void pin(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 256, s32) += A (64 x 32, s8, shared) * B (32 x 256, s8, shared,
// K-major); scale-d = 0 on the first product of a tile
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// raw weight tile -> K-major tile (256 rows n x 128 bytes k, 128-byte
// swizzle: chunk c of row n at c ^ (n & 7)). Consumer thread u: warp u / 32
// takes k rows 16 (u / 32) .. + 15 (one 16-byte chunk of every row n), its
// lanes word columns 32 h + lane (columns 4 w .. 4 w + 3) for h = 0, 1.
template <bool kInt4>
__device__ __forceinline__ void relayout_b(const unsigned char* raw, unsigned char* bk,
                                           int u) {
  const int lane = u & 31, kc = u >> 5;
  // the column a lane writes q-th: (q + rot) & 3, so that the 8 lanes of a
  // 16-byte store phase write 8 rows n with distinct n & 7
  const int rot = (lane >> 1) & 3;
  uint32_t sel[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t j = (q + rot) & 3;
    sel[q] = j | ((4 + j) << 4);  // bytes j of the two words, in the low half
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int wd = 32 * h + lane;
    uint32_t r[16];  // k rows 16 kc + i, columns 4 wd .. + 3
    if (!kInt4) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        r[i] = *reinterpret_cast<const uint32_t*>(raw + (16 * kc + i) * kBN + 4 * wd);
    } else {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(raw + (8 * kc + p) * kBN + 4 * wd);
        r[2 * p] = low_codes(w);
        r[2 * p + 1] = high_codes(w);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t o[4];  // column (q + rot) & 3, k rows 4 grp .. + 3
#pragma unroll
      for (int grp = 0; grp < 4; ++grp) {
        const uint32_t x = __byte_perm(r[4 * grp], r[4 * grp + 1], sel[q]);
        const uint32_t y = __byte_perm(r[4 * grp + 2], r[4 * grp + 3], sel[q]);
        o[grp] = __byte_perm(x, y, 0x5410);
      }
      const int n = 4 * wd + ((q + rot) & 3);
      *reinterpret_cast<uint4*>(bk + n * kBK + ((kc ^ (n & 7)) << 4)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// the output tile of linear index `tile`: kGroupM row tiles sweep the
// column tiles together, so blocks that run at once share weight columns in L2
__device__ __forceinline__ void tile_origin(int tile, int tiles_m, int tiles_n, int& m0,
                                            int& n0) {
  const int per_group = kGroupM * tiles_n;
  const int first_m = (tile / per_group) * kGroupM;
  const int gsize = min(tiles_m - first_m, kGroupM);
  m0 = (first_m + (tile % per_group) % gsize) * kBM;
  n0 = ((tile % per_group) / gsize) * kBN;
}

// One persistent block an SM walks the tiles blockIdx.x, + gridDim.x, ...;
// its k tiles form one stream across the tiles (stage and buffer from the
// running count), so the producer loads the next tile, and the consumers
// re-lay its first weight tile, while the epilogue of the last one runs.
template <bool kInt4, typename OutT, int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const float* __restrict__ sa, const float* __restrict__ sw,
                  const float* __restrict__ bias, OutT* __restrict__ C, int M, int N,
                  int K) {
  using L = Smem<kInt4>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::kBars, empty = full + 8 * S;
  unsigned char* const sBk = smem + S * L::kStage;

  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const int tiles = tiles_m * tiles_n;
  const int nk = (K + kBK - 1) / kBK;
  const int my_tiles = (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int total = my_tiles * nk;  // k tiles of this block, over all its tiles

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);  // 0, 1 consumers; 2 producer
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, tiles_m, tiles_n, m0, n0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int st = it % S;
          if (it >= S) mbar_wait(empty + 8 * st, (it / S - 1) & 1);
          mbar_expect(full + 8 * st, L::kStage);
          tma_load_2d(base + st * L::kStage, &map_a, kt * kBK, m0, full + 8 * st);
          tma_load_2d(base + st * L::kStage + L::kA, &map_b, n0,
                      kInt4 ? kt * (kBK / 2) : kt * kBK, full + 8 * st);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  if (total == 0) return;

  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float s_a = *sa;
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;

  mbar_wait(full, 0);
  relayout_b<kInt4>(smem + L::kA, sBk, tid);
  fence_proxy_async();
  consumers_sync();
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    tile_origin(tile, tiles_m, tiles_n, m0, n0);
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int st = it % S;
      const uint32_t a0 = base + st * L::kStage + role * 64 * kBK;  // this group's 64 rows
      const uint32_t b0 = smem_u32(sBk) + (it & 1) * L::kBk;
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_s8_n256(acc, desc128(a0 + 32 * kk), desc128(b0 + 32 * kk), kt > 0 || kk > 0);
      wgmma_commit();
      if (it + 1 < total) {  // re-lay the next raw tile while the products run
        const int st1 = (it + 1) % S;
        mbar_wait(full + 8 * st1, ((it + 1) / S) & 1);
        relayout_b<kInt4>(smem + st1 * L::kStage + L::kA, sBk + ((it + 1) & 1) * L::kBk,
                          tid);
        fence_proxy_async();
      }
      wgmma_wait_all();
      pin(acc);
      mbar_arrive(empty + 8 * st);  // A read; the raw tile re-laid a step ago
      consumers_sync();             // the next K-major tile written, this one read
    }

    // accumulator i: row 16 warp + g + 8 ((i >> 1) & 1), column 8 (i >> 2) +
    // 2t + (i & 1) of the group's 64 x 256 tile
    const int row0 = m0 + 64 * role + 16 * warp + g;
    if constexpr (sizeof(OutT) == 4) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= N) continue;  // N is even: col + 1 < N too
        const float s0 = __fmul_rn(s_a, sw[col]), s1 = __fmul_rn(s_a, sw[col + 1]);
        const float b0 = kEpi == kScaleOnly ? 0.f : bias[col];
        const float b1 = kEpi == kScaleOnly ? 0.f : bias[col + 1];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = row0 + 8 * hr;
          if (row >= M) continue;
          *reinterpret_cast<float2*>(C + size_t(row) * N + col) =
              make_float2(epilogue<kEpi>(acc[4 * j + 2 * hr], s0, b0),
                          epilogue<kEpi>(acc[4 * j + 2 * hr + 1], s1, b1));
        }
      }
    } else {
      // bf16: the 4 threads of a quad hold 2 columns each of 8-column group
      // j; they trade so that thread t stores all 8 of group 4q + t, one
      // 16-byte store for four 4-byte ones (every thread takes part in the
      // shuffles; only the stores are masked)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float sc[4][2], bs[4][2];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int col = n0 + 8 * (4 * q + jj) + 2 * t;
          const bool in = col < N;  // N is even: col + 1 < N too
          sc[jj][0] = __fmul_rn(s_a, in ? sw[col] : 0.f);
          sc[jj][1] = __fmul_rn(s_a, in ? sw[col + 1] : 0.f);
          bs[jj][0] = kEpi != kScaleOnly && in ? bias[col] : 0.f;
          bs[jj][1] = kEpi != kScaleOnly && in ? bias[col + 1] : 0.f;
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          uint32_t pr[4];  // columns 8 (4q + jj) + 2t, + 1 of row row0 + 8 hr
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int i = 4 * (4 * q + jj) + 2 * hr;
            const __nv_bfloat162 v = __halves2bfloat162(
                __float2bfloat16_rn(epilogue<kEpi>(acc[i], sc[jj][0], bs[jj][0])),
                __float2bfloat16_rn(epilogue<kEpi>(acc[i + 1], sc[jj][1], bs[jj][1])));
            pr[jj] = *reinterpret_cast<const uint32_t*>(&v);
          }
          // got[k]: thread t ^ k's columns of group 4q + t
          uint32_t got[4];
          got[0] = pick4(pr, t);
#pragma unroll
          for (int k = 1; k < 4; ++k)
            got[k] = __shfl_xor_sync(0xffffffffu, pick4(pr, t ^ k), k);
          const int row = row0 + 8 * hr, col = n0 + 8 * (4 * q + t);
          if (row < M && col < N)  // N % 16 == 0: the 8 columns are all in or out
            *reinterpret_cast<uint4*>(C + size_t(row) * N + col) =
                make_uint4(pick4(got, t), pick4(got, t ^ 1), pick4(got, t ^ 2),
                           pick4(got, t ^ 3));
        }
      }
    }
  }
}

template <bool kInt4, typename OutT, int kEpi>
int launch_t(const CUtensorMap& map_a, const CUtensorMap& map_b, const void* sa,
             const void* sw, const void* bias, void* out, int M, int N, int K,
             cudaStream_t st) {
  auto kernel = wgmma_gemm_kernel<kInt4, OutT, kEpi>;
  constexpr int kBytes = Smem<kInt4>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // setmaxnreg.inc waits until the block's pool holds the registers asked
  // for: refuse a build whose entry count would leave it waiting forever
  static const int regs = [&] {
    cudaFuncAttributes fa;
    return cudaFuncGetAttributes(&fa, kernel) == cudaSuccess ? fa.numRegs : 0;
  }();
  if (regs * kThreads < kConsumers * kConsumerRegs + (kThreads - kConsumers) * kProducerRegs)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles =
      static_cast<long long>((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // one persistent block an SM
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 132;
  }();
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, kBytes, st>>>(
      map_a, map_b, static_cast<const float*>(sa), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<OutT*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// x8: (M, K) codes at a row pitch of lda bytes (a multiple of 16)
template <bool kInt4, int kEpi>
int launch(const void* x8, const void* w, const void* sa, const void* sw,
           const void* bias, void* out, int M, int N, int K, int lda, int out_bf16,
           void* stream) {
  if (M < 1 || N < 16 || N % 16 != 0 || K < 1 || (kInt4 && K % 2 != 0) || lda < K ||
      lda % 16 != 0 || !aligned(x8, 16) || !aligned(w, 16) ||
      (kEpi != kScaleOnly && bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  if (!byte_map(&map_a, x8, M, K, kBK, kBM, CU_TENSOR_MAP_SWIZZLE_128B, lda) ||
      !byte_map(&map_b, w, kInt4 ? K / 2 : K, N, kBN, kInt4 ? kBK / 2 : kBK,
                CU_TENSOR_MAP_SWIZZLE_NONE, N))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_bf16
             ? launch_t<kInt4, __nv_bfloat16, kEpi>(map_a, map_b, sa, sw, bias, out, M, N,
                                                    K, st)
             : launch_t<kInt4, float, kEpi>(map_a, map_b, sa, sw, bias, out, M, N, K, st);
}

}  // namespace wg
}  // namespace repro_kernels
