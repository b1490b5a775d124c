// Forward flash attention with GQA, causal or not
//
//   for each batch row b, query head h (KV head hk = h / (H / Hkv)) and
//   query position i < S:
//     q'      = q[b, i, h] * scale                         f32, scale = 1/sqrt(dh)
//     s_j     = q' . k[b, j, hk]   (s_j = -2e38 where j > i when causal)
//     out     = softmax(s) @ v[b, :, hk]                   in q's dtype
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
// the path, 16 and 64 in the small checks); S is any positive length (a ragged last tile is masked). There is no
// kv_len mask, as in the TPU kernel.
//
// Numerics, as the Pallas body (_kernel, flash_attention.py:32-64): q, k and
// v widen to f32; q is multiplied by the f32 scale before the product; an
// online softmax walks the KV tiles from tile 0 upward, keeping (m, l, acc)
// in f32, with the finite mask -2e38 (never -inf) and expf (no fast math);
// the result is acc / max(l, 1e-30), rounded once to q's dtype
// (__float2bfloat16_rn for bf16). Tile 0 holds key 0, which every query row
// sees, so the running max is finite after the first tile and a masked score
// gives p = exp(-2e38 - m) = 0 exactly. Causal: KV tiles wholly after a query
// tile are never read; the diagonal tile is masked per element. The sums run
// in another order than the Pallas kernel's (f32 FMA chains of 16 lanes), so
// the result agrees with the plain version within f32 rounding, not bit for
// bit.
//
// Bound on H100: operations. Per call 4 * B * H * S^2 * dh flops
// (2 * B * H * S^2 * dh causal, half the score matrix); bytes
// B * S * (2H + 2Hkv) * dh * itemsize (q, k, v read once, out written once).
// At S = 32768, B = 1, causal: stablelm-3b (32 heads of 80) 5.50e12 flops,
// llava-next-mistral-7b (32 query / 8 KV heads of 128) 8.80e12 flops per
// layer: 5.6 ms and 8.9 ms at the 989 TFLOP/s bf16 tensor-core peak, 82 ms
// and 131 ms at the 67 TFLOP/s f32 rate outside the tensor cores, under
// which this design works; q, k, v and out are 671 MB for either model,
// 0.20 ms at 3.35 TB/s.
//
// Design (simple first): one block of 256 threads per (64-row query tile,
// b, h); heavy causal tiles are scheduled first. The scaled query tile is
// held transposed in shared memory as f32; each 64-row K tile is stored
// transposed and the V tile as rows, both f32. Thread (ty, tx) of a 16 x 16
// grid owns a 4 x 4 patch of the score tile (rows 4ty.., keys 4tx..): the
// QK^T loop reads one float4 of the query and one of the keys per dh step
// for 16 FMAs. Row maxima and sums reduce with shuffles over the 16 lanes of
// a row group. The probability tile is written to shared memory over the K
// tile (which is dead by then), and each thread accumulates its 4 rows x dh
// / 16 columns of P.V in registers. Loads are 16 bytes wide (4 f32 or 8
// bf16); offsets are 64-bit. Not yet: tensor cores (wgmma on bf16 operands
// would round p and the scaled q to bf16 and leave the plain version's
// bound), TMA or cp.async pipelining of the K/V tiles, warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;              // query rows per block, keys per KV tile
constexpr int kThreads = 256;          // a 16 x 16 grid of 4 x 4 score patches
constexpr int kPStride = kTile + 4;    // padded row of the probability tile
constexpr float kNegInf = -2.0e38f;

// a 16-byte load of T, widened to f32
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half (exact)
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DH>
struct Smem {
  static constexpr int kKt = DH * kTile;                         // K^T tile
  static constexpr int kP = kTile * kPStride;                    // P tile
  static constexpr int kKtP = kKt > kP ? kKt : kP;               // shared
  static constexpr int kFloats = DH * kTile + kKtP + kTile * DH;  // + Q^T, V
  static constexpr int kBytes = kFloats * 4;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int S, int H, int Hkv, int causal, float scale) {
  constexpr int kNV4 = DH / 64;          // float4 column groups per thread
  constexpr int kNSc = (DH % 64) / 16;   // single columns per thread
  constexpr int kNC = 4 * kNV4 + kNSc;   // output columns per thread (dh / 16)
  constexpr int kCh = Chunk<T>::N;
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
  const T* qb = q + static_cast<int64_t>(b) * S * q_pos + static_cast<int64_t>(h) * DH;
  const T* kb = k + static_cast<int64_t>(b) * S * kv_pos + static_cast<int64_t>(hk) * DH;
  const T* vb = v + static_cast<int64_t>(b) * S * kv_pos + static_cast<int64_t>(hk) * DH;

  // the query tile, scaled and transposed (rows past S read as zeros)
  for (int idx = tid; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx % kTile, c0 = (idx / kTile) * kCh;
    float f[kCh];
    if (q0 + r < S) {
      Chunk<T>::load(qb + (q0 + r) * q_pos + c0, f);
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
        Chunk<T>::load(kb + (k0 + r) * kv_pos + c0, f);
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
        Chunk<T>::load(vb + (k0 + r) * kv_pos + c0, f);
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
    T* o = out + (static_cast<int64_t>(b) * S + row) * q_pos + static_cast<int64_t>(h) * DH;
#pragma unroll
    for (int jj = 0; jj < kNV4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_out(o + 64 * jj + 4 * tx + e, acc[i][4 * jj + e] / den);
#pragma unroll
    for (int sc = 0; sc < kNSc; ++sc)
      store_out(o + 64 * kNV4 + tx + 16 * sc, acc[i][4 * kNV4 + sc] / den);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int Hkv, int causal, float scale, cudaStream_t st) {
  auto kernel = flash_attention_kernel<T, DH>;
  constexpr int kBytes = Smem<DH>::kBytes;
  // once per instantiation: above 48 KB shared memory must be asked for
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, kBytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, Hkv, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, void* out, int B,
                int S, int H, int Hkv, int dh, int causal, float scale,
                cudaStream_t st) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, H, Hkv, causal, scale, st);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, Hkv, causal, scale, st);
    case 80: return launch<T, 80>(q, k, v, out, B, S, H, Hkv, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, Hkv, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// in_bf16: 0 = q, k, v and out are f32, 1 = bf16; causal: 0 or 1;
// scale = 1 / sqrt(dh) rounded to f32
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int Hkv, int dh, int causal,
                                      int in_bf16, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return dispatch_dh<__nv_bfloat16>(q, k, v, out, B, S, H, Hkv, dh, causal,
                                      scale, st);
  return dispatch_dh<float>(q, k, v, out, B, S, H, Hkv, dh, causal, scale, st);
}
