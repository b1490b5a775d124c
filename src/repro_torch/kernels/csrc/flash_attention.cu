// Forward flash attention with GQA, causal or not
//
//   for each batch row b, query head h (KV head hk = h / (H / Hkv)) and
//   query position i < S:
//     s_j     = (q[b, i, h] . k[b, j, hk]) * scale      f32, scale = 1/sqrt(dh)
//               (s_j = -2e38 where j > i when causal)
//     out     = softmax(s) @ v[b, :, hk]                 in q's dtype
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (flash_attention.py:68, pl.pallas_call at :84), the Pallas form of the
// JAX package's chunked attention (models/attention.chunked_attention), which
// every cacheless forward longer than cfg.attn_chunk_threshold takes.
//
// Layouts (all row-major, contiguous, the JAX package's public layout):
//   q, out   (B, S, H, dh)     f32 or bf16
//   k, v     (B, S, Hkv, dh)   q's dtype, H % Hkv == 0
// dh is 16, 64, 80 or 128 (stablelm-3b 80 and llava-next-mistral-7b 128 on
// the path, 16 and 64 in the small checks); S is any positive length (a
// ragged last tile is masked). There is no kv_len mask, as in the TPU kernel.
//
// Numerics, as the Pallas body (_kernel, flash_attention.py:32-64): an
// online softmax walks the KV tiles from tile 0 upward, keeping (m, l, acc)
// in f32, with the finite mask -2e38 (never -inf) and expf (no fast math);
// the result is acc / max(l, 1e-30), rounded once to q's dtype
// (__float2bfloat16_rn for bf16). Tile 0 holds key 0, which every query row
// sees, so the running max is finite after the first tile and a masked score
// gives p = exp(-2e38 - m) = 0 exactly. Causal: KV tiles wholly after a query
// tile are never read; the diagonal tile is masked per element. The sums run
// in another order than the Pallas kernel's, so the result agrees with the
// plain version within f32 rounding (then one rounding to bf16), not bit
// for bit.
//
// Bound on H100: operations. Per call 4 * B * H * S^2 * dh flops
// (2 * B * H * S^2 * dh causal, half the score matrix); bytes
// B * S * (2H + 2Hkv) * dh * itemsize (q, k, v read once, out written once).
// At S = 32768, B = 1, causal: stablelm-3b (32 heads of 80) 5.50e12 flops,
// llava-next-mistral-7b (32 query / 8 KV heads of 128) 8.80e12 flops per
// layer: 5.6 ms and 8.9 ms at the 989 TFLOP/s bf16 tensor-core peak; q, k,
// v and out are 671 MB for either model, 0.20 ms at 3.35 TB/s.
//
// bf16 (the path: both models run bf16) takes tc::flash_attention_tc_kernel,
// on the tensor cores:
//   * QK^T by wgmma.mma_async m64nNk16 on the bf16 operands as they are
//     (q as register A fragments, loaded once; K from shared memory), f32
//     sums; the f32 score is multiplied by scale after the product (a
//     product of two bf16 values is exact in f32, so only the order of the
//     f32 sums differs from the plain version).
//   * P.V at f32 accuracy: p (f32) is split into p_hi = bf16(p) and p_lo =
//     bf16(p - p_hi), and both products go into the same f32 accumulator by
//     wgmma m64n{dh}k16 with P as the register A operand (relative error of
//     p about 2^-17; a single bf16 p, 2^-9, leaves the bf16 tolerance of the
//     plain version at about one output element in ten). l sums the f32 p.
//     This costs 1.5x the tensor-core work of plain bf16 attention.
//   * One block of two warpgroups per (128-row query tile, b, h), heavy
//     causal tiles first; each warpgroup owns 64 query rows and its
//     registers: the 64 x N score tile (N / 2 f32 a thread), p_hi and p_lo
//     (N / 4 + N / 4), q (dh / 4) and the 64 x dh output (dh / 2 f32). N,
//     the keys of a tile, is 128 for dh <= 80 and 64 for dh = 128, as far
//     as 255 registers a thread allow.
//   * K/V tiles of N keys in a 4-stage ring in dynamic shared memory,
//     loaded by TMA (thread 0 issues the copies, one mbarrier a stage
//     counts their bytes): tiles j + 1 and j + 2 are in flight while tile j
//     is multiplied. One __syncthreads a step frees the stage of tile j - 2.
//   * Each warpgroup issues S_j = Q K_j^T and P_{j-1} V_{j-1} back to back
//     and runs the softmax of S_j while the tensor cores finish P_{j-1}
//     V_{j-1}. Every wgmma lies on a path the whole block takes (a branch
//     around one makes ptxas serialize them all).
//   * Tiles are stored as boxes of 64 rows x 16 columns with the 32-byte
//     swizzle (descriptors of layout type 3): K is the K-major B operand
//     (one box a k16 step), V the MN-major (transposed) B operand (one box
//     a 16 columns of the output), so neither is transposed in memory, and
//     every dh that is a multiple of 16 takes the same layout.
// Where trouble is likely:
//   * dh = 80 (stablelm-3b): 160-byte rows are not a multiple of the
//     128-byte swizzle (a 64-column box would need a 16-column second one
//     with another swizzle and a split P.V product); 32-byte boxes tile 16,
//     64, 80 and 128 alike, QK^T takes k = 80 as 5 k16 steps and P.V an
//     N = 80 product;
//   * the causal row 0 must equal v[0] bit for bit: p = 1 gives p_hi = 1,
//     p_lo = 0, and masked keys give p = 0 only while the masked score stays
//     the finite -2e38 (it is set after the scale, never -inf or NaN);
//   * registers: dh / 2 + dh / 4 + N accumulator and fragment registers a
//     thread, one block (256 threads, up to 255 registers) an SM; ptxas -v
//     reports spills (chip_smoke.py prints it): 254 for dh = 80 at N = 128,
//     222 for dh = 128 at N = 64, none spilled;
//   * wgmma's f32 accumulation is not an IEEE sum of each product in turn;
//     the difference to the plain version is held to one output ulp + 1e-5;
//   * causal at N = 64: the first warpgroup computes the block's last key
//     tile too, wholly masked for its rows (p = 0, corr = 1: the result is
//     the same).
// Not yet: warp specialisation (a producer warp, consumer warpgroups that
// meet at mbarriers instead of a block barrier), two score tiles in flight,
// a persistent schedule.
//
// f32 (the small checks only; no path runs attention in f32 past
// attn_chunk_threshold) takes flash_attention_kernel, on the f32 units:
// one block of 256 threads per (64-row query tile, b, h); the query tile is
// scaled by scale before the product (as the Pallas body) and held
// transposed in shared memory as f32; each 64-row K tile is stored
// transposed and the V tile as rows. Thread (ty, tx) of a 16 x 16 grid owns
// a 4 x 4 patch of the score tile; row maxima and sums reduce with shuffles
// over the 16 lanes of a row group; the probability tile overwrites the K
// tile, and each thread accumulates its 4 rows x dh / 16 columns of P.V in
// registers. Loads are 16 bytes wide; offsets are 64-bit.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -2.0e38f;

// ---------------------------------------------------------------- f32 (SIMT)
constexpr int kTile = 64;              // query rows per block, keys per KV tile
constexpr int kThreads = 256;          // a 16 x 16 grid of 4 x 4 score patches
constexpr int kPStride = kTile + 4;    // padded row of the probability tile

// a 16-byte load
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

template <int DH>
struct Smem {
  static constexpr int kKt = DH * kTile;                         // K^T tile
  static constexpr int kP = kTile * kPStride;                    // P tile
  static constexpr int kKtP = kKt > kP ? kKt : kP;               // shared
  static constexpr int kFloats = DH * kTile + kKtP + kTile * DH;  // + Q^T, V
  static constexpr int kBytes = kFloats * 4;
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           int S, int H, int Hkv, int causal, float scale) {
  constexpr int kNV4 = DH / 64;          // float4 column groups per thread
  constexpr int kNSc = (DH % 64) / 16;   // single columns per thread
  constexpr int kNC = 4 * kNV4 + kNSc;   // output columns per thread (dh / 16)
  constexpr int kCh = 4;                 // floats of a 16-byte load
  constexpr int kChunks = DH / kCh;      // 16-byte chunks per row

  extern __shared__ float4 smem4[];
  float* const Qt = reinterpret_cast<float*>(smem4);  // [DH][kTile], scaled
  float* const Kt = Qt + DH * kTile;                  // [DH][kTile]
  float* const Ps = Kt;                               // [kTile][kPStride]
  float* const Vs = Kt + Smem<DH>::kKtP;              // [kTile][DH]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int b = static_cast<int>(blockIdx.y) / H;
  const int h = static_cast<int>(blockIdx.y) % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kTile;

  const int64_t q_pos = static_cast<int64_t>(H) * DH;    // q/out row stride
  const int64_t kv_pos = static_cast<int64_t>(Hkv) * DH;  // k/v row stride
  const float* qb = q + static_cast<int64_t>(b) * S * q_pos + static_cast<int64_t>(h) * DH;
  const float* kb = k + static_cast<int64_t>(b) * S * kv_pos + static_cast<int64_t>(hk) * DH;
  const float* vb = v + static_cast<int64_t>(b) * S * kv_pos + static_cast<int64_t>(hk) * DH;

  // the query tile, scaled and transposed (rows past S read as zeros)
  for (int idx = tid; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx % kTile, c0 = (idx / kTile) * kCh;
    float f[kCh];
    if (q0 + r < S) {
      load4(qb + (q0 + r) * q_pos + c0, f);
    } else {
#pragma unroll
      for (int e = 0; e < kCh; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kCh; ++e) Qt[(c0 + e) * kTile + r] = f[e] * scale;
  }

  float acc[4][kNC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c) acc[i][c] = 0.f;
  }

  // equal query and key tiles: tile qt is the diagonal one
  const int n_kv = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's P and V are read (and Q^T written)
    for (int idx = tid; idx < kTile * kChunks; idx += kThreads) {
      const int r = idx % kTile, c0 = (idx / kTile) * kCh;
      float f[kCh];
      if (k0 + r < S) {
        load4(kb + (k0 + r) * kv_pos + c0, f);
      } else {
#pragma unroll
        for (int e = 0; e < kCh; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kCh; ++e) Kt[(c0 + e) * kTile + r] = f[e];
    }
    for (int idx = tid; idx < kTile * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c0 = (idx % kChunks) * kCh;
      float f[kCh];
      if (k0 + r < S) {
        load4(vb + (k0 + r) * kv_pos + c0, f);
      } else {
#pragma unroll
        for (int e = 0; e < kCh; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kCh; e += 4)
        *reinterpret_cast<float4*>(Vs + r * DH + c0 + e) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
    __syncthreads();

    // scores of rows q0 + 4ty + i against keys k0 + 4tx + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kTile + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(Kt + d * kTile + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + 4 * tx + j;
        if (key >= S || (causal && key > row)) s[i][j] = kNegInf;
      }
    }

    // online softmax: the 16 lanes of a row group hold one row's 64 keys
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kNC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // every thread is done with K^T: P takes its place
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(Ps + (4 * ty + i) * kPStride + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    __syncthreads();

    // acc += P . V for rows 4ty + i; columns 64 jj + 4 tx + e, then the
    // single columns 64 kNV4 + tx + 16 sc
#pragma unroll 2
    for (int kk = 0; kk < kTile; kk += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * kPStride + kk);
        p[i][0] = t.x;
        p[i][1] = t.y;
        p[i][2] = t.z;
        p[i][3] = t.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = Vs + (kk + e) * DH;
#pragma unroll
        for (int jj = 0; jj < kNV4; ++jj) {
          const float4 w = *reinterpret_cast<const float4*>(vr + 64 * jj + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * jj + 0] = fmaf(p[i][e], w.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(p[i][e], w.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(p[i][e], w.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(p[i][e], w.w, acc[i][4 * jj + 3]);
          }
        }
#pragma unroll
        for (int sc = 0; sc < kNSc; ++sc) {
          const float w = vr[64 * kNV4 + tx + 16 * sc];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][4 * kNV4 + sc] = fmaf(p[i][e], w, acc[i][4 * kNV4 + sc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* o = out + (static_cast<int64_t>(b) * S + row) * q_pos + static_cast<int64_t>(h) * DH;
#pragma unroll
    for (int jj = 0; jj < kNV4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[64 * jj + 4 * tx + e] = acc[i][4 * jj + e] / den;
#pragma unroll
    for (int sc = 0; sc < kNSc; ++sc)
      o[64 * kNV4 + tx + 16 * sc] = acc[i][4 * kNV4 + sc] / den;
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int Hkv, int causal, float scale, cudaStream_t st) {
  auto kernel = flash_attention_kernel<DH>;
  constexpr int kBytes = Smem<DH>::kBytes;
  // once per instantiation: above 48 KB shared memory must be asked for
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, kBytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, Hkv, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ bf16 (tensor cores)
namespace tc {

constexpr int kBM = 128;      // query rows per block: two warpgroups of 64
// keys per K/V tile: 128 where the registers allow (dh <= 80), else 64
template <int DH>
constexpr int kBN = DH <= 80 ? 128 : 64;
constexpr int kStages = 4;    // K/V tiles in the TMA ring
constexpr int kAhead = kStages - 2;  // tiles loading while tile j is used
constexpr int kWG = 128;      // threads of a warpgroup
constexpr int kThreads = 2 * kWG;
constexpr int kBox = 16;      // columns of one TMA box: 32 bytes, the swizzle span
template <int DH>
constexpr int kBoxBytes = kBN<DH> * kBox * 2;

using bf16 = __nv_bfloat16;

// Shared memory: kStages (K, V) tile pairs, then one mbarrier a stage. A
// tile of kBN rows is DH / 16 boxes of kBN x 16 bf16 (2 or 4 KB), each box
// written by one TMA copy with the 32-byte swizzle (rows of 32 bytes, the
// two 16-byte halves of row r swapped when bit 2 of r is set): wgmma's
// canonical 32-byte-swizzled layout, K-major for K (a k16 step of QK^T is
// one box) and MN-major for V (16 columns of P.V a box).
template <int DH>
struct Smem {
  static constexpr int kTile = kBN<DH> * DH * 2;
  static constexpr int kBars = kStages * 2 * kTile;  // offset of the mbarriers
  static constexpr int kBytes = kBars + 8 * kStages + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
// the producer's arrival, announcing the bytes the stage's copies bring
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one box of a 4-d tensor map (dh, Hkv, S, B) at (c0, c1, c2, c3) into
// shared memory, completing on bar; rows past S are zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// wgmma matrix descriptor of a 32-byte-swizzled operand (layout type 3),
// lbo and sbo in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (3ull << 62);
}
// K, K-major: 8-row groups 256 bytes apart (sbo); a swizzled K-major
// operand takes no lbo. V, MN-major: its 16-column boxes kBoxBytes apart
// (lbo), 8-row (key) groups 256 bytes apart (sbo).

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of r across a wgmma that
// is still in flight
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 16, f32) += A (64 x 16, registers) * B (16 x 16, smem)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t* a,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TRANS_B));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TRANS_B));
}

// d (64 x 80, f32) += A (64 x 16, registers) * B (16 x 80, smem)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t* a,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TRANS_B));
}

// d (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, smem)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TRANS_B));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// One block of two warpgroups per (128-row query tile, b, h), heavy causal
// tiles first; warpgroup wg owns query rows q0 + 64 wg .. + 63.
// Accumulator layout of a 64 x N wgmma: warp w of the group, lane = 4 g +
// t, element 4 j + e holds row 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e
// & 1); a k16 A fragment in registers holds, in its 4 registers, rows (g, g
// + 8, g, g + 8) at columns (2t, 2t, 2t + 8, 2t + 8) and the next one.
//
// Each warpgroup pipelines its tiles: in step j it issues S_j = Q K_j^T and
// O += P_{j-1} V_{j-1} back to back, waits for S_j only, runs the softmax of
// S_j while the tensor cores finish P_{j-1} V_{j-1}, then waits for that,
// rescales O and turns S_j into P_j. So tiles j and j - 1 are read in step
// j, and step j refills the stage of tile j - 2 with tile j + kAhead.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tmap_k,
                              const __grid_constant__ CUtensorMap tmap_v,
                              const bf16* __restrict__ q, bf16* __restrict__ out,
                              int S, int H, int Hkv, int causal, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  // stage s: K at tile 2s, V at 2s + 1; the swizzle wants 1024-byte alignment
  const uint32_t sKV = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sBar = sKV + Smem<DH>::kBars;

  const int tid = threadIdx.x;
  const int wg = tid / kWG, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (S + kBM - 1) / kBM;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);
  const int b = static_cast<int>(blockIdx.y) / H;
  const int h = static_cast<int>(blockIdx.y) % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBM;
  const int wrow = q0 + 64 * wg;                 // this group's first row
  const int ra = wrow + 16 * warp + g;           // this thread's rows ra, ra + 8

  const int64_t q_ld = static_cast<int64_t>(H) * DH;
  const bf16* qb = q + static_cast<int64_t>(b) * S * q_ld + static_cast<int64_t>(h) * DH;

  constexpr int BN = kBN<DH>;  // keys per tile
  const int n_kt = (S + BN - 1) / BN;
  // causal: key tiles up to the one holding the block's last row (at BN =
  // 64 the first group computes the last one too, wholly masked for its
  // rows: a masked tile gives p = 0 and corr = 1, so the result is the
  // same, and every wgmma stays on a path that the whole block takes)
  const int n_kv = causal ? min(n_kt, (q0 + kBM - 1) / BN + 1) : n_kt;

  // thread 0 loads the tiles: K and V tile i into stage i % kStages, whose
  // mbarrier completes phase (i / kStages) & 1 when their bytes have landed
  auto load_kv = [&](int tile) {
    const int st = tile % kStages;
    const uint32_t dst = sKV + 2 * st * Smem<DH>::kTile, bar = sBar + 8 * st;
    mbar_expect(bar, 2 * Smem<DH>::kTile);
#pragma unroll
    for (int c = 0; c < DH / kBox; ++c) {
      tma_load(dst + c * kBoxBytes<DH>, &tmap_k, c * kBox, hk, tile * BN, b, bar);
      tma_load(dst + Smem<DH>::kTile + c * kBoxBytes<DH>, &tmap_v, c * kBox, hk,
               tile * BN, b, bar);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(sBar + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kAhead && i < n_kv; ++i) load_kv(i);
  }
  __syncthreads();

  // this thread's part of the query rows as k16 A fragments, once (rows
  // past S are zeros)
  uint32_t qf[DH / 4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    const bf16* qrow = qb + static_cast<int64_t>(row < S ? row : 0) * q_ld + 2 * t;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      qf[4 * kk + r] = row < S ? __ldg(reinterpret_cast<const uint32_t*>(qrow + 16 * kk)) : 0u;
      qf[4 * kk + 2 + r] =
          row < S ? __ldg(reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 8)) : 0u;
    }
  }

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t phi[BN / 4], plo[BN / 4];   // P_{j-1} = p_hi + p_lo
  float s[BN / 2];

  // o += p_hi v + p_lo v on the tensor cores, f32 sums (V is the MN-major
  // B operand)
  auto issue_pv = [&](int tile) {
    const uint32_t sV = sKV + (2 * (tile % kStages) + 1) * Smem<DH>::kTile;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t dv = desc(sV + kk * 16 * kBox * 2, kBoxBytes<DH>, 256);
      wgmma_rs<1>(o, phi + 4 * kk, dv, 1);
      wgmma_rs<1>(o, plo + 4 * kk, dv, 1);
    }
    wgmma_commit();
  };

  // step j: wait for tile j, refill the stage of tile j - 2, S_j = Q K_j^T
  // (and P_{j-1} V_{j-1} when PV), softmax of S_j, P_j
  auto step = [&](int j, auto with_pv) {
    constexpr bool PV = decltype(with_pv)::value;
    mbar_wait(sBar + 8 * (j % kStages), (j / kStages) & 1);  // tile j landed
    // every thread has finished step j - 1 (and with it P_{j-2} V_{j-2})
    // before the stage of tile j - 2 is refilled
    __syncthreads();
    if (tid == 0 && j + kAhead < n_kv) load_kv(j + kAhead);

    // s = q k^T on the tensor cores: bf16 products, f32 sums (K is the
    // K-major B operand); then P_{j-1} V_{j-1}
    pin(qf);
    pin(o);
    pin(phi);
    pin(plo);
    wgmma_fence();
    const uint32_t sK = sKV + 2 * (j % kStages) * Smem<DH>::kTile;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_rs<0>(s, qf + 4 * kk, desc(sK + kk * kBoxBytes<DH>, 16, 256), kk);
    wgmma_commit();
    if constexpr (PV) {
      issue_pv(j - 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    pin(s);
    pin(qf);

    // the scale after the product, then the mask (the diagonal and ragged
    // tiles only)
    const int k0 = j * BN;
    const bool edge = k0 + BN > S || (causal && k0 + BN - 1 > wrow);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      s[i] *= scale;
      if (edge) {
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int row = ra + 8 * ((i >> 1) & 1);
        if (key >= S || (causal && key > row)) s[i] = kNegInf;
      }
    }

    // online softmax over the 4 lanes (t) that share a row
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i >> 1) & 1;
      mx[r] = fmaxf(mx[r], s[i]);
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = expf(s[i] - mx[r]);
      rs[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
    }

    if constexpr (PV) wgmma_wait<0>();  // P_{j-1} V_{j-1} is in o
    pin(o);
    pin(phi);
    pin(plo);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    // p = p_hi + p_lo, two bf16 A fragments: the accumulator's pairs (s[2i],
    // s[2i + 1]) are, in order, the registers of the k16 slices of P
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
      const float2 hf = __bfloat1622float2(hi);
      phi[i] = bf16x2_bits(hi);
      plo[i] = bf16x2_bits(__floats2bfloat162_rn(s[2 * i] - hf.x,
                                                 s[2 * i + 1] - hf.y));
    }
  };

  step(0, std::false_type{});
  for (int j = 1; j < n_kv; ++j) step(j, std::true_type{});
  pin(o);
  pin(phi);
  pin(plo);
  wgmma_fence();
  issue_pv(n_kv - 1);
  wgmma_wait<0>();
  pin(o);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    bf16* orow = out + (static_cast<int64_t>(b) * S + row) * q_ld +
                 static_cast<int64_t>(h) * DH + 2 * t;
#pragma unroll
    for (int jd = 0; jd < DH / 8; ++jd)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jd) = __halves2bfloat162(
          __float2bfloat16_rn(o[4 * jd + 2 * r] / den),
          __float2bfloat16_rn(o[4 * jd + 2 * r + 1] / den));
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime (the
// library links no libcuda)
EncodeTiled encode_tiled() {
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

// k or v (B, S, Hkv, dh) bf16 as a 4-d tensor map (dh, Hkv, S, B), boxes of
// kBox columns x rows of one head, 32-byte swizzle, zeros out of bounds
bool kv_map(CUtensorMap* map, const void* base, int B, int S, int Hkv, int dh,
            int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {cuuint64_t(dh), cuuint64_t(Hkv), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(dh) * 2, cuuint64_t(Hkv) * dh * 2,
                                 cuuint64_t(S) * Hkv * dh * 2};
  const cuuint32_t box[4] = {kBox, 1, cuuint32_t(rows), 1}, elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int Hkv, int causal, float scale, cudaStream_t st) {
  auto kernel = flash_attention_tc_kernel<DH>;
  constexpr int kBytes = Smem<DH>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap map_k, map_v;
  if (!kv_map(&map_k, k, B, S, Hkv, DH, kBN<DH>) ||
      !kv_map(&map_v, v, B, S, Hkv, DH, kBN<DH>))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kBM - 1) / kBM, B * H);
  kernel<<<grid, kThreads, kBytes, st>>>(map_k, map_v, static_cast<const bf16*>(q),
                                         static_cast<bf16*>(out), S, H, Hkv,
                                         causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <typename Launch>
int dispatch_dh(int dh, Launch&& f) {
  switch (dh) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// in_bf16: 0 = q, k, v and out are f32 (the SIMT kernel), 1 = bf16 (the
// tensor-core kernel); causal: 0 or 1; scale = 1 / sqrt(dh) rounded to f32
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int Hkv, int dh, int causal,
                                      int in_bf16, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_dh(dh, [&](auto d) {
    constexpr int DH = decltype(d)::value;
    return in_bf16 ? tc::launch<DH>(q, k, v, out, B, S, H, Hkv, causal, scale, st)
                   : launch<DH>(q, k, v, out, B, S, H, Hkv, causal, scale, st);
  });
}
