// One-token decode attention over an int8 / packed-int4 KV cache, dense or
// paged
//
//   for each slot b and query head hq (KV head h = hq / (H / Hkv)):
//     q'      = q[b, hq] * (1 / sqrt(dh))                       f32
//     k_j     = codes_k[row(b, j), h] * k_scale[row(b, j), h]   f32, j < S
//     s_j     = q' . k_j            (s_j = -2e38 for j >= lengths[b])
//     s_new   = q' . k_new[b, h]
//     out     = softmax([s ; s_new]) @ [v ; v_new[b, h]]        in q's dtype
//
// Two entries:
//   decode_attention_launch        dense cache, row(b, j) = (b, j).
//     Replaces src/repro/kernels/decode_attention.py::decode_attention_pallas
//     (pl.pallas_call at decode_attention.py:102).
//   decode_attention_paged_launch  block pool, row(b, j) =
//     (clamp(tables[b, j / blk], 0, NB - 1), j % blk), S = nb * blk.
//     Replaces src/repro/kernels/decode_attention.py::decode_attention_paged
//     (decode_attention.py:143, which gathers the blocks and reaches the
//     pl.pallas_call at :102 through decode_attention_pallas at :166).
//
// Layouts (all row-major, contiguous):
//   q, out          (B, H, dh)          f32 or bf16
//   k_q, v_q        (B, S, Hkv, dhp)    int8 (dhp = dh) or uint8 nibbles
//                                       packed along head_dim (dhp = dh / 2,
//                                       element 2i in the low nibble, +7 bias)
//                   paged: (NB, blk, Hkv, dhp), one layer of the pool
//   k_scale,v_scale (B, S, Hkv)         f32, one scale per (token, head)
//                   paged: (NB, blk, Hkv)
//   tables          (B, nb)             int32 block ids (paged only); entries
//                                       out of [0, NB) are clamped, as
//                                       jnp.take(mode="clip") does
//   k_new, v_new    (B, Hkv, dh)        q's dtype, the current token
//   lengths         (B,)                int32 per-slot cursors
//
// Numerics, as the Pallas body: the masked score is the finite -2e38, never
// -inf (a slot of length 0 would otherwise give -inf - -inf = NaN); the
// online softmax keeps (m, l, acc) in f32 with expf; the current token is
// folded in after the loop at full precision; the result is
// acc / max(l, 1e-30), rounded once to the output dtype. Masked rows get
// p = exp(-2e38 - m) = 0 exactly, so finite garbage past a slot's length
// never changes the output, and blocks wholly past the length are skipped
// (the same result bit for bit). The loop runs over min(len, S) rows: an
// idle slot whose cursor walked past S attends the whole buffer and never
// reads beyond it. The paged kernel is the dense one with the table lookup
// in its row addressing: the same tiles from position 0, the same order of
// sums, so on a pool it is bit-equal to the dense kernel on the layout its
// tables describe (the gathered cache).
//
// Bound on H100: bytes. A decode step reads each slot's codes and scales
// once: at B = 8, S = 512, Hkv = 32, dh = 80 that is 22.0 MB for an int8
// cache (6.6 us at 3.35 TB/s) and 11.5 MB for int4 (3.4 us); the arithmetic
// is about 2 * B * H * len * dh * 2 flops, far below the f32 rate. The
// paged kernel moves the same bytes plus 4 * B * nb of table: it reads the
// pool in place, where gathering a dense copy first would read and write
// the whole cache once more.
//
// Design (simple first): one block of 128 threads per (KV head, slot), which
// owns the G = H / Hkv query heads of its group. The cache is walked in
// blocks of 32 rows: all threads dequantize the K and V rows into shared
// memory (K rows padded to an odd stride, so lane j reading row j is free of
// bank conflicts); warp w scores query heads w, w + 4, ... with one lane per
// row and updates (m, l) with warp shuffles; then every thread updates its
// share of the G x dh accumulator. The paged kernel resolves each tile's 32
// physical rows (table entry clamped, times blk, plus the offset) into
// shared memory once, while the tile before it accumulates P.V, so its code
// loads wait on no table load and divide by nothing. Not yet: wide or
// asynchronous (cp.async / TMA) loads, a split over S for few slots, tensor
// cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBS = 32;        // cache rows per block: one per lane
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 128;
constexpr int kMaxG = 8;
constexpr int kMaxPer = kMaxG * kMaxDh / kThreads;  // accumulators per thread
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dequantize cache rows [pos0, pos0 + n) of one (slot, KV head) into
// dst[j * ld + d]; rows n .. kBS-1 are zero-filled. `codes` points at the
// code row of physical row 0 of the KV head, `scales` at its scale; the
// dense cache's physical row is (slot, pos), the pool's prow[j] (row
// pos0 + j of the slot through its table). Every load of the block is
// issued before the first is used, so a tile waits on the memory latency
// once, not once per code byte.
template <bool kInt4, bool kPaged>
__device__ __forceinline__ void load_rows(const uint8_t* __restrict__ codes,
                                          const float* __restrict__ scales,
                                          long long row_stride, int Hkv,
                                          int pos0, int n, int dhp, float* dst,
                                          int ld, const int* prow) {
  constexpr int kPer = kBS * (kInt4 ? kMaxDh / 2 : kMaxDh) / kThreads;
  uint32_t byte[kPer];
  float s[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int j = idx / dhp;
    byte[i] = 0u;
    s[i] = 0.f;
    if (idx < kBS * dhp && j < n) {
      const long long row = kPaged ? prow[j] : pos0 + j;
      byte[i] = codes[row * row_stride + (idx - j * dhp)];
      s[i] = scales[row * Hkv];
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx >= kBS * dhp) break;
    const int j = idx / dhp, c = idx - j * dhp;
    const bool live = j < n;
    if (kInt4) {
      const float lo = __fmul_rn(static_cast<float>(static_cast<int>(byte[i] & 0xFu) - 7), s[i]);
      const float hi = __fmul_rn(static_cast<float>(static_cast<int>(byte[i] >> 4) - 7), s[i]);
      dst[j * ld + 2 * c] = live ? lo : 0.f;
      dst[j * ld + 2 * c + 1] = live ? hi : 0.f;
    } else {
      const float v = __fmul_rn(static_cast<float>(static_cast<int8_t>(byte[i])), s[i]);
      dst[j * ld + c] = live ? v : 0.f;
    }
  }
}

// Paged: rows [p0, p0 + kBS) of the slot -> their pool rows in prow: block
// tb[pos / blk] clamped to [0, NB - 1] (as jnp.take(mode="clip") does),
// offset pos % blk. One thread per row.
template <bool kPaged>
__device__ __forceinline__ void resolve_rows(int* prow, const int* tb, int p0,
                                             int n_rows, int NB, int blk) {
  const int pos = p0 + static_cast<int>(threadIdx.x);
  if (kPaged && threadIdx.x < kBS && pos < n_rows)
    prow[threadIdx.x] = min(max(tb[pos / blk], 0), NB - 1) * blk + pos % blk;
}

// S is the dense extent (paged: nb * blk); `tables` (B, nb), NB and blk are
// read only when kPaged
template <typename T, bool kInt4, bool kPaged>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const uint8_t* __restrict__ kq,
                        const uint8_t* __restrict__ vq,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs, const T* __restrict__ kn,
                        const T* __restrict__ vn,
                        const int* __restrict__ lengths,
                        const int* __restrict__ tables, T* __restrict__ out,
                        int S, int nb, int blk, int NB, int H, int Hkv, int dh,
                        float scale) {
  __shared__ float Ks[kBS][kMaxDh + 1];
  __shared__ float Vs[kBS][kMaxDh];
  __shared__ float qs[kMaxG][kMaxDh];
  __shared__ float ps[kMaxG][kBS];
  __shared__ float ms[kMaxG], ls[kMaxG], cs[kMaxG];
  __shared__ int prow[kPaged ? kBS : 1];  // the next tile's physical rows

  const int h = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  const int dhp = kInt4 ? dh / 2 : dh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long head0 = (long long)b * H + (long long)h * G;  // first q head

  for (int i = tid; i < G * dh; i += kThreads)
    qs[i / dh][i % dh] = __fmul_rn(widen(q[head0 * dh + i]), scale);
  if (tid < G) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  float acc[kMaxPer];
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) acc[i] = 0.f;

  const int len = lengths[b];
  const int n_rows = len <= 0 ? 0 : (len < S ? len : S);
  const long long row_stride = (long long)Hkv * dhp;
  // physical row 0 of KV head h: (b, 0, h) of the dense cache, (0, 0, h) of
  // the pool
  const long long row0 = (kPaged ? 0LL : (long long)b * S * Hkv) + h;
  const uint8_t* kb = kq + row0 * dhp;
  const uint8_t* vb = vq + row0 * dhp;
  const float* ksb = ks + row0;
  const float* vsb = vs + row0;
  const int* tb = kPaged ? tables + (long long)b * nb : nullptr;
  resolve_rows<kPaged>(prow, tb, 0, n_rows, NB, blk);
  __syncthreads();

  for (int pos0 = 0; pos0 < n_rows; pos0 += kBS) {
    const int n = min(kBS, n_rows - pos0);
    load_rows<kInt4, kPaged>(kb, ksb, row_stride, Hkv, pos0, n, dhp, &Ks[0][0],
                             kMaxDh + 1, prow);
    load_rows<kInt4, kPaged>(vb, vsb, row_stride, Hkv, pos0, n, dhp, &Vs[0][0],
                             kMaxDh, prow);
    __syncthreads();
    // prow is read only above: resolve the next tile's rows now, visible
    // to it after the barrier that closes this tile
    resolve_rows<kPaged>(prow, tb, pos0 + kBS, n_rows, NB, blk);
    for (int g = warp; g < G; g += kWarps) {
      float s = kNegInf;
      if (lane < n) {
        float dot = 0.f;
        for (int d = 0; d < dh; ++d) dot = fmaf(qs[g][d], Ks[lane][d], dot);
        s = dot;
      }
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = expf(s - m_new);
      const float corr = expf(m_old - m_new);
      const float psum = warp_sum(p);
      ps[g][lane] = p;
      __syncwarp();
      if (lane == 0) {
        ms[g] = m_new;
        ls[g] = ls[g] * corr + psum;
        cs[g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < G * dh) {
        const int g = idx / dh, d = idx - g * dh;
        float pv = 0.f;
        for (int j = 0; j < n; ++j) pv = fmaf(ps[g][j], Vs[j][d], pv);
        acc[i] = acc[i] * cs[g] + pv;
      }
    }
    __syncthreads();
  }

  // fold in the current token: it always attends itself, at full precision
  const long long new0 = ((long long)b * Hkv + h) * dh;
  for (int g = warp; g < G; g += kWarps) {
    float part = 0.f;
    for (int d = lane; d < dh; d += 32) part = fmaf(qs[g][d], widen(kn[new0 + d]), part);
    const float sn = warp_sum(part);
    const float m_old = ms[g];
    const float m_new = fmaxf(m_old, sn);
    const float pn = expf(sn - m_new);
    const float corr = expf(m_old - m_new);
    __syncwarp();
    if (lane == 0) {
      ls[g] = ls[g] * corr + pn;
      cs[g] = corr;
      ps[g][0] = pn;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < G * dh) {
      const int g = idx / dh, d = idx - g * dh;
      const float a = acc[i] * cs[g] + ps[g][0] * widen(vn[new0 + d]);
      store(out + head0 * dh + idx, a / fmaxf(ls[g], 1e-30f));
    }
  }
}

template <typename T, bool kInt4, bool kPaged>
int launch(const void* q, const void* kq, const void* vq, const void* ks,
           const void* vs, const void* kn, const void* vn, const void* lengths,
           const void* tables, void* out, int B, int S, int nb, int blk, int NB,
           int H, int Hkv, int dh, float scale, cudaStream_t st) {
  const dim3 grid(Hkv, B);
  decode_attention_kernel<T, kInt4, kPaged><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const uint8_t*>(kq),
      static_cast<const uint8_t*>(vq), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<const int*>(lengths),
      static_cast<const int*>(tables), static_cast<T*>(out), S, nb, blk, NB, H,
      Hkv, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPaged>
int dispatch(const void* q, const void* kq, const void* vq, const void* ks,
             const void* vs, const void* kn, const void* vn,
             const void* lengths, const void* tables, void* out, int B, int S,
             int nb, int blk, int NB, int H, int Hkv, int dh, int kv_bits,
             int in_bf16, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG || dh > kMaxDh ||
      dh <= 0 || (kv_bits == 4 && dh % 2 != 0) || (kv_bits != 4 && kv_bits != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_DA_ARGS q, kq, vq, ks, vs, kn, vn, lengths, tables, out, B, S, nb, blk, NB, H, Hkv, dh, scale, st
  if (in_bf16) {
    return kv_bits == 4 ? launch<__nv_bfloat16, true, kPaged>(REPRO_DA_ARGS)
                        : launch<__nv_bfloat16, false, kPaged>(REPRO_DA_ARGS);
  }
  return kv_bits == 4 ? launch<float, true, kPaged>(REPRO_DA_ARGS)
                      : launch<float, false, kPaged>(REPRO_DA_ARGS);
#undef REPRO_DA_ARGS
}

}  // namespace

// kv_bits: 8 (int8 codes) or 4 (packed nibbles); in_bf16: 0 = q, k_new,
// v_new and out are f32, 1 = bf16; scale = 1 / sqrt(dh) rounded to f32
extern "C" int decode_attention_launch(const void* q, const void* kq,
                                       const void* vq, const void* ks,
                                       const void* vs, const void* kn,
                                       const void* vn, const void* lengths,
                                       void* out, int B, int S, int H, int Hkv,
                                       int dh, int kv_bits, int in_bf16,
                                       float scale, void* stream) {
  return dispatch<false>(q, kq, vq, ks, vs, kn, vn, lengths, nullptr, out, B, S,
                         0, 1, 0, H, Hkv, dh, kv_bits, in_bf16, scale, stream);
}

// The paged entry: kq/vq/ks/vs are one layer of the pool, NB blocks of blk
// rows; tables (B, nb) int32; the dense extent is nb * blk.
extern "C" int decode_attention_paged_launch(
    const void* q, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* tables, const void* kn, const void* vn,
    const void* lengths, void* out, int B, int nb, int blk, int NB, int H,
    int Hkv, int dh, int kv_bits, int in_bf16, float scale, void* stream) {
  if (nb <= 0 || blk <= 0 || NB <= 0 || (long long)nb * blk > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(q, kq, vq, ks, vs, kn, vn, lengths, tables, out, B,
                        nb * blk, nb, blk, NB, H, Hkv, dh, kv_bits, in_bf16,
                        scale, stream);
}
