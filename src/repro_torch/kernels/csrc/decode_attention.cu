// One-token decode attention over an int8 / packed-int4 KV cache
//
//   for each slot b and query head hq (KV head h = hq / (H / Hkv)):
//     q'      = q[b, hq] * (1 / sqrt(dh))                       f32
//     k_j     = codes_k[b, j, h] * k_scale[b, j, h]             f32, j < S
//     s_j     = q' . k_j            (s_j = -2e38 for j >= lengths[b])
//     s_new   = q' . k_new[b, h]
//     out     = softmax([s ; s_new]) @ [v ; v_new[b, h]]        in q's dtype
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_pallas
//           (pl.pallas_call at decode_attention.py:102).
//
// Layouts (all row-major, contiguous):
//   q, out          (B, H, dh)          f32 or bf16
//   k_q, v_q        (B, S, Hkv, dhp)    int8 (dhp = dh) or uint8 nibbles
//                                       packed along head_dim (dhp = dh / 2,
//                                       element 2i in the low nibble, +7 bias)
//   k_scale,v_scale (B, S, Hkv)         f32, one scale per (token, head)
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
// reads beyond it.
//
// Bound on H100: bytes. A decode step reads each slot's codes and scales
// once: at B = 8, S = 512, Hkv = 32, dh = 80 that is 22.0 MB for an int8
// cache (6.6 us at 3.35 TB/s) and 11.5 MB for int4 (3.4 us); the arithmetic
// is about 2 * B * H * len * dh * 2 flops, far below the f32 rate.
//
// Design (simple first): one block of 128 threads per (KV head, slot), which
// owns the G = H / Hkv query heads of its group. The cache is walked in
// blocks of 32 rows: all threads dequantize the K and V rows into shared
// memory (K rows padded to an odd stride, so lane j reading row j is free of
// bank conflicts); warp w scores query heads w, w + 4, ... with one lane per
// row and updates (m, l) with warp shuffles; then every thread updates its
// share of the G x dh accumulator. Not yet: wide or asynchronous (cp.async /
// TMA) loads, a split over S for few slots, tensor cores.
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
// (slot, position 0, head) code row, `scales` at its scale. Every load of
// the block is issued before the first is used, so a tile waits on the
// memory latency once, not once per code byte.
template <bool kInt4>
__device__ __forceinline__ void load_rows(const uint8_t* __restrict__ codes,
                                          const float* __restrict__ scales,
                                          long long row_stride, int Hkv,
                                          int pos0, int n, int dhp, float* dst,
                                          int ld) {
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
      const long long pos = pos0 + j;
      byte[i] = codes[pos * row_stride + (idx - j * dhp)];
      s[i] = scales[pos * Hkv];
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

template <typename T, bool kInt4>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const uint8_t* __restrict__ kq,
                        const uint8_t* __restrict__ vq,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs, const T* __restrict__ kn,
                        const T* __restrict__ vn,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int S, int H, int Hkv, int dh, float scale) {
  __shared__ float Ks[kBS][kMaxDh + 1];
  __shared__ float Vs[kBS][kMaxDh];
  __shared__ float qs[kMaxG][kMaxDh];
  __shared__ float ps[kMaxG][kBS];
  __shared__ float ms[kMaxG], ls[kMaxG], cs[kMaxG];

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
  const long long slot_row0 = (long long)b * S * Hkv + h;  // (b, 0, h)
  const uint8_t* kb = kq + slot_row0 * dhp;
  const uint8_t* vb = vq + slot_row0 * dhp;
  const float* ksb = ks + slot_row0;
  const float* vsb = vs + slot_row0;
  __syncthreads();

  for (int pos0 = 0; pos0 < n_rows; pos0 += kBS) {
    const int n = min(kBS, n_rows - pos0);
    load_rows<kInt4>(kb, ksb, row_stride, Hkv, pos0, n, dhp, &Ks[0][0], kMaxDh + 1);
    load_rows<kInt4>(vb, vsb, row_stride, Hkv, pos0, n, dhp, &Vs[0][0], kMaxDh);
    __syncthreads();
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

template <typename T, bool kInt4>
int launch(const void* q, const void* kq, const void* vq, const void* ks,
           const void* vs, const void* kn, const void* vn, const void* lengths,
           void* out, int B, int S, int H, int Hkv, int dh, float scale,
           cudaStream_t st) {
  const dim3 grid(Hkv, B);
  decode_attention_kernel<T, kInt4><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const uint8_t*>(kq),
      static_cast<const uint8_t*>(vq), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<const int*>(lengths),
      static_cast<T*>(out), S, H, Hkv, dh, scale);
  return static_cast<int>(cudaGetLastError());
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
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG || dh > kMaxDh ||
      dh <= 0 || (kv_bits == 4 && dh % 2 != 0) || (kv_bits != 4 && kv_bits != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return kv_bits == 4
               ? launch<__nv_bfloat16, true>(q, kq, vq, ks, vs, kn, vn, lengths, out, B, S, H, Hkv, dh, scale, st)
               : launch<__nv_bfloat16, false>(q, kq, vq, ks, vs, kn, vn, lengths, out, B, S, H, Hkv, dh, scale, st);
  }
  return kv_bits == 4
             ? launch<float, true>(q, kq, vq, ks, vs, kn, vn, lengths, out, B, S, H, Hkv, dh, scale, st)
             : launch<float, false>(q, kq, vq, ks, vs, kn, vn, lengths, out, B, S, H, Hkv, dh, scale, st);
}
