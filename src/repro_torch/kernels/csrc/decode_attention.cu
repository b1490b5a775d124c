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
//   ws              (B, H, n_split, dh + 2)  f32 workspace, n_split =
//                                       ceil(S / kSplit): per split the
//                                       unnormalised sum acc[dh], then m, l
//
// Bound on H100: bytes. A decode step reads each slot's codes and scales
// once: at B = 8, len 448, Hkv = 32, dh = 80 that is 19.3 MB for an int8
// cache (5.8 us at 3.35 TB/s) and 10.1 MB for int4; the arithmetic is about
// 2 * B * H * len * dh * 2 flops, far below the f32 rate. The paged kernel
// moves the same bytes plus 4 * B * nb of table: it reads the pool in place,
// where gathering a dense copy first would read and write the whole cache
// once more.
//
// Design (flash-decoding). The cache of each (slot, KV head) is split into
// chunks of kSplit = 256 rows counted from position 0: grid (n_split, Hkv,
// B), so the decode shape (8 slots, len 448) runs 512 blocks, about four on
// each of the 132 SMs, and one slot with a long cache still fills the card.
// A block is one producer warp and four consumer warps, and walks its chunk
// in tiles of 32 rows, each in a shared-memory stage of its own. The
// producer copies the raw codes and scales of every tile with cp.async, in
// order, at the widest width the rows allow (16 B for int8 at dh 80 and 128,
// 8 B for int4 at dh 80, 4 B as the floor, byte loads for odd rows), and
// each tile's copies arrive on the tile's mbarrier when they land
// (cp.async.mbarrier.arrive). The consumers take the tiles in turn and score
// a tile as soon as it lands, while the later ones are still in flight: a
// warp that issued the copies itself would stall behind them, so no
// consumer issues any. Shared code rows are padded to an odd number of copy
// units, so the 32 rows a warp reads at once fall on distinct banks. Codes
// are dequantized at use, __fmul_rn(code, scale) in f32 (code to f32
// through the 2^23 trick, exact), so every dequantized value equals the
// plain version's dequantize_kv. A consumer scores one row a lane (each unit
// dequantized once for the G query heads), keeps its own online softmax in
// f32 with expf and the finite -2e38 mask, and its P.V sums over (head,
// 16-byte unit) lanes; the four consumers merge in warp order at the end
// and the block writes its (acc, m, l) to the workspace. A second kernel,
// launched from the same C entry as a programmatic dependent (it starts
// while the split kernel's last blocks run and waits for their workspace),
// merges the splits of each (slot, head) in order: M = max(m_0, m_1, ...,
// s_new), then l and acc summed over splits 0, 1, ... with weights
// exp(m_s - M), the new token last at full precision; the result is
// acc / max(l, 1e-30), rounded once to the output dtype. No atomics: a
// repeated call gives the same bits. Splits and tiles wholly past
// min(len, S) are not copied and not read, so neither the finite garbage
// nor the NaN past a slot's length reaches the output, and a slot of length
// 0 returns v_new. An idle slot whose cursor walked past S attends the whole
// buffer and never reads beyond it. Because the chunks are counted from
// position 0 whatever the extent, the paged kernel is the dense one with the
// table lookup in its row addressing (the producer resolves its rows through
// the table before it issues their copies): on a pool it is bit-equal to the
// dense kernel on the layout its tables describe, also where the two
// extents differ. Measured at the decode shape, the copies land at about
// 2.3 TB/s (80-byte rows at a 2560-byte stride and 4-byte scales, a sector
// each), which bounds the kernel more than its arithmetic. Not yet: tensor
// cores (they do not pay at G = 1), blocks over several heads (whole cache
// rows, fewer sectors).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSplit = 256;    // cache rows per split; SPLIT_ROWS in decode_attention.py
constexpr int kRows = 32;      // rows of a tile: one a lane
constexpr int kSplitTiles = kSplit / kRows;
constexpr int kConsumers = 4;  // consumer warps of a split block, plus one producer
constexpr int kSplitThreads = 32 * (kConsumers + 1);
static_assert(kSplit % (kRows * kConsumers) == 0, "a split is whole tiles, dealt evenly");
constexpr int kThreads = 128;  // the combine's block: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 128;
constexpr int kMaxG = 8;
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

// ------------------------------------------------------------ cp.async
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
                 "n"(kBytes));
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ------------------------------------------------------------ dequantize
// f32 of the int8 code in byte i of w (wx = w ^ 0x80808080): the biased
// byte as the mantissa of 2^23, minus 2^23 + 128. Exact.
__device__ __forceinline__ float code8(uint32_t wx, int i) {
  return __int_as_float(__byte_perm(wx, 0x4B000000u, 0x7440 | i)) - 8388736.0f;
}
// f32 of nibble k of w minus the +7 bias. Exact.
__device__ __forceinline__ float code4(uint32_t w, int k) {
  return __int_as_float(0x4B000000u | ((w >> (4 * k)) & 0xFu)) - 8388615.0f;
}

template <int kUnit>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t (&w)[kUnit / 4]) {
  if constexpr (kUnit == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (kUnit == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// One unit (kUnit code bytes in shared memory) dequantized: v = code * sc,
// rounded as dequantize_kv rounds it.
template <bool kInt4, int kUnit>
__device__ __forceinline__ void dequant(const uint8_t* p, float sc,
                                        float (&v)[kInt4 ? 2 * kUnit : kUnit]) {
  uint32_t w[kUnit / 4];
  load_words<kUnit>(p, w);
#pragma unroll
  for (int i = 0; i < kUnit / 4; ++i) {
    if constexpr (kInt4) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[8 * i + k] = __fmul_rn(code4(w[i], k), sc);
    } else {
      const uint32_t wx = w[i] ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 4; ++k) v[4 * i + k] = __fmul_rn(code8(wx, k), sc);
    }
  }
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// arrives on `bar` once every cp.async this thread issued so far has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// the consumer warps alone (the producer does not take part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 32) : "memory");
}

// ------------------------------------------------------------ shared layout
// Byte offsets into the split kernel's dynamic shared memory: one stage a
// tile of the split (its K and V codes, kRows rows of `stride` bytes, then
// its K and V scales), then q, each consumer warp's probabilities and
// rescaling, the warps' (m, l) and one mbarrier a tile. A code row takes
// `stride` bytes: dhp rounded up to the unit, plus one unit where the count
// of units is even, so the 32 rows a warp reads at once fall on distinct
// banks.
struct Layout {
  int stride, stage, off_q, off_p, off_c, off_ml, off_bar, total;
};

__host__ __device__ __forceinline__ Layout make_layout(int dhp, int unit, int G, int dh) {
  Layout L;
  L.stride = (dhp + unit - 1) / unit * unit;
  if (((L.stride / unit) & 1) == 0) L.stride += unit;
  L.stage = 2 * kRows * L.stride + 2 * kRows * 4;  // K, V codes; K, V scales
  L.off_q = kSplitTiles * L.stage;
  L.off_p = L.off_q + G * dh * 4;                   // per warp: p (G x kRows)
  L.off_c = L.off_p + kConsumers * G * kRows * 4;   // per warp: exp(m_old - m_new)
  L.off_ml = L.off_c + kConsumers * kMaxG * 4;      // per warp: m, l
  L.off_bar = (L.off_ml + 2 * kConsumers * kMaxG * 4 + 7) / 8 * 8;
  L.total = L.off_bar + kSplitTiles * 8;
  return L;
}

// ------------------------------------------------------------ split kernel
// Block (split, h, b): cache rows [split * kSplit, + n) of slot b, KV head
// h, for its G query heads, in tiles of kRows rows. Warp kConsumers is the
// producer: it copies every tile of the split into its own stage, in order,
// and each tile's copies arrive on the tile's mbarrier when they land. The
// consumer warps take the tiles in turn (tile t to warp t % kConsumers);
// each scores one row a lane, keeps its own online softmax and P.V sums,
// and meets the other consumers once, at the end, where their (m, l, acc)
// merge in warp order. Copying from a warp of its own keeps the consumers
// from stalling behind the copies they would otherwise issue. S is the
// dense extent (paged: nb * blk); `tables` (B, nb), NB and blk are read only
// when kPaged.
template <bool kInt4, bool kPaged, int kUnit, int kG>
__global__ void __launch_bounds__(kSplitThreads)
decode_attention_split(const void* __restrict__ q, bool q_bf16,
                       const uint8_t* __restrict__ kq, const uint8_t* __restrict__ vq,
                       const float* __restrict__ ks, const float* __restrict__ vs,
                       const int* __restrict__ lengths, const int* __restrict__ tables,
                       float* __restrict__ ws, int S, int nb, int blk, int NB, int H,
                       int Hkv, int dh, int n_split, float scale, bool bytes) {
  constexpr int kDpu = kInt4 ? 2 * kUnit : kUnit;  // head dims per unit
  constexpr int kPairs = 32 / kDpu;                 // P.V (head, unit) pairs a lane
  constexpr int kTiles = kSplitTiles / kConsumers;  // tiles a consumer takes
  constexpr int kQPer = (kG * kMaxDh + kConsumers * 32 - 1) / (kConsumers * 32);
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) uint8_t smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long head0 = (long long)b * H + (long long)h * G;  // first q head
  // q first: its loads are out before the barrier below lets the producer
  // issue the cache's copies
  float qv[kQPer];
  if (warp < kConsumers) {
#pragma unroll
    for (int k = 0; k < kQPer; ++k) {
      const int i = tid + k * kConsumers * 32;
      qv[k] = 0.f;
      if (i < G * dh)
        qv[k] = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[head0 * dh + i])
                       : static_cast<const float*>(q)[head0 * dh + i];
    }
  }
  // let the combine launch once every split block has started
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int len = lengths[b];
  const int n_rows = len <= 0 ? 0 : (len < S ? len : S);
  const int pos0 = split * kSplit;
  if (pos0 >= n_rows) return;  // wholly past the length: not run, not read
  const int n = min(kSplit, n_rows - pos0);
  const int nt = (n + kRows - 1) / kRows;

  const int dhp = kInt4 ? dh / 2 : dh;
  const Layout L = make_layout(dhp, kUnit, G, dh);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.off_bar);  // a tile
  if (tid < kSplitTiles) mbar_init(full + tid, 32);
  __syncthreads();

  if (warp == kConsumers) {
    // the producer: lane j copies row j of each tile's K and V codes (in
    // units, spread over the lanes) and its two scales
    const long long rs = (long long)Hkv * dhp;  // code bytes between cache rows
    const int per = bytes ? dhp : dhp / kUnit;  // copies a row
    const int j0 = lane / per, c0 = lane - j0 * per;
    const int dj = 32 / per, dc = 32 - dj * per;
    long long row[kSplitTiles];  // this lane's cache row in each tile
#pragma unroll
    for (int t = 0; t < kSplitTiles; ++t) {
      const int j = t * kRows + lane, pos = pos0 + j;
      row[t] = (long long)b * S + pos;
      if (kPaged)
        row[t] = j < n ? (long long)min(max(tables[(long long)b * nb + pos / blk], 0), NB - 1) *
                                 blk + pos % blk
                       : 0;
    }
#pragma unroll
    for (int t = 0; t < kSplitTiles; ++t) {
      if (t >= nt) break;
      const int nr = min(kRows, n - t * kRows);
      uint8_t* st = smem + t * L.stage;
      float* sc = reinterpret_cast<float*>(st + 2 * kRows * L.stride);
      const long long r = row[t];
      int j = j0, c = c0;
      for (int i0 = 0; i0 < nr * per; i0 += 32) {
        const long long rj = kPaged ? __shfl_sync(kAll, r, min(j, kRows - 1))
                                    : r - lane + j;
        if (i0 + lane < nr * per) {
          const long long off = rj * rs + (long long)h * dhp;
          if (bytes) {
            st[j * L.stride + c] = kq[off + c];
            st[(kRows + j) * L.stride + c] = vq[off + c];
          } else {
            cp_async<kUnit>(st + j * L.stride + c * kUnit, kq + off + c * kUnit);
            cp_async<kUnit>(st + (kRows + j) * L.stride + c * kUnit, vq + off + c * kUnit);
          }
        }
        j += dj;
        c += dc;
        if (c >= per) {
          c -= per;
          ++j;
        }
      }
      if (bytes) {
        if (lane < nr) {
          sc[lane] = ks[r * Hkv + h];
          sc[kRows + lane] = vs[r * Hkv + h];
        }
        mbar_arrive(full + t);  // releases the stores above
      } else {
        if (lane < nr) {
          cp_async<4>(sc + lane, ks + r * Hkv + h);
          cp_async<4>(sc + kRows + lane, vs + r * Hkv + h);
        }
        mbar_arrive_cp_async(full + t);
      }
    }
    cp_wait_all();
    return;
  }

  // the consumers
  float* qs = reinterpret_cast<float*>(smem + L.off_q);
  float* ps = reinterpret_cast<float*>(smem + L.off_p) + warp * G * kRows;
  float* cw = reinterpret_cast<float*>(smem + L.off_c) + warp * kMaxG;
  float* mlw = reinterpret_cast<float*>(smem + L.off_ml);  // [2][kConsumers][kMaxG]
  const int rec = dh + 2;                                   // ws record
#pragma unroll
  for (int k = 0; k < kQPer; ++k) {
    const int i = tid + k * kConsumers * 32;
    if (i < G * dh) qs[i] = __fmul_rn(qv[k], scale);
  }
  consumers_sync();  // q is shared by the consumers

  const int nuse = (dhp + kUnit - 1) / kUnit;  // units a row holds
  // P.V: lane -> (g, unit u) over rows rg, rg + R, ... of each tile; the R
  // row groups' sums meet at the end in a fixed order, in the stage of the
  // warp's first tile
  const int pv_pairs = G * nuse;
  const int cap = L.stage / 4 / (G * dh);
  const int R = max(1, min(32 / pv_pairs, cap));
  float m_r[kG], l_r[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m_r[g] = kNegInf;
    l_r[g] = 0.f;
  }
  float acc[kPairs][kDpu];
#pragma unroll
  for (int p = 0; p < kPairs; ++p)
#pragma unroll
    for (int e = 0; e < kDpu; ++e) acc[p][e] = 0.f;

#pragma unroll
  for (int k = 0; k < kTiles; ++k) {
    const int t = warp + k * kConsumers;
    if (t >= nt) break;
    mbar_wait(full + t, 0);  // tile t has landed
    const int nr = min(kRows, n - t * kRows);
    const uint8_t* kc = smem + t * L.stage;
    const uint8_t* vc = kc + kRows * L.stride;
    const float* ksc = reinterpret_cast<const float*>(kc + 2 * kRows * L.stride);
    const float* vsc = ksc + kRows;

    // scores: lane j = row j, each unit dequantized once for the G heads
    float s[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) s[g] = 0.f;
    if (lane < nr) {
      const float sc = ksc[lane];
      const uint8_t* rowp = kc + lane * L.stride;
      for (int u = 0; u < nuse; ++u) {
        float v[kDpu];
        dequant<kInt4, kUnit>(rowp + u * kUnit, sc, v);
        const int d0 = u * kDpu;
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          if (g < G) {
            const float* qg = qs + g * dh + d0;
            float s0 = s[g], s1 = 0.f;
            if constexpr (kUnit >= 8) {
#pragma unroll
              for (int e = 0; e < kDpu / 4; ++e) {
                const float4 qv4 = reinterpret_cast<const float4*>(qg)[e];
                s0 = fmaf(qv4.x, v[4 * e], s0);
                s1 = fmaf(qv4.y, v[4 * e + 1], s1);
                s0 = fmaf(qv4.z, v[4 * e + 2], s0);
                s1 = fmaf(qv4.w, v[4 * e + 3], s1);
              }
            } else {
#pragma unroll
              for (int e = 0; e < kDpu; ++e)
                if (d0 + e < dh) {
                  if (e & 1) s1 = fmaf(qg[e], v[e], s1);
                  else s0 = fmaf(qg[e], v[e], s0);
                }
            }
            s[g] = s0 + s1;
          }
        }
      }
    }
    // online softmax of the warp's rows, a head at a time
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g < G) {
        const float sv = lane < nr ? s[g] : kNegInf;
        const float m_new = fmaxf(m_r[g], warp_max(sv));
        const float c = expf(m_r[g] - m_new);
        const float p = lane < nr ? expf(sv - m_new) : 0.f;
        ps[g * kRows + lane] = p;
        l_r[g] = l_r[g] * c + warp_sum(p);
        m_r[g] = m_new;
        if (lane == 0) cw[g] = c;
      }
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int pr = R == 1 ? lane + p * 32 : lane % pv_pairs;
      const int rg = R == 1 ? 0 : lane / pv_pairs;
      if (pr < pv_pairs && rg < R && (p == 0 || R == 1)) {
        const int g = pr / nuse, u = pr - g * nuse;
        const float c = cw[g];
        const float* pg = ps + g * kRows;
        float a[kDpu];
#pragma unroll
        for (int e = 0; e < kDpu; ++e) a[e] = acc[p][e] * c;
        for (int j = rg; j < nr; j += R) {
          const float pj = pg[j];
          float v[kDpu];
          dequant<kInt4, kUnit>(vc + j * L.stride + u * kUnit, vsc[j], v);
#pragma unroll
          for (int e = 0; e < kDpu; ++e) a[e] = fmaf(pj, v[e], a[e]);
        }
#pragma unroll
        for (int e = 0; e < kDpu; ++e) acc[p][e] = a[e];
      }
    }
    __syncwarp();  // ps and cw are read before the next tile writes them
  }

  // the warp's sums over its row groups, into the stage of its first tile
  // (consumed by now, or never filled)
  float* wr = reinterpret_cast<float*>(smem + warp * L.stage);
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const int pr = R == 1 ? lane + p * 32 : lane % pv_pairs;
    const int rg = R == 1 ? 0 : lane / pv_pairs;
    if (pr < pv_pairs && rg < R && (p == 0 || R == 1)) {
      const int g = pr / nuse, u = pr - g * nuse;
      float* o = wr + (rg * G + g) * dh + u * kDpu;
#pragma unroll
      for (int e = 0; e < kDpu; ++e)
        if (kUnit != 4 || u * kDpu + e < dh) o[e] = acc[p][e];
    }
  }
  __syncwarp();
  if (R > 1)
    for (int i = lane; i < G * dh; i += 32) {
      float a = wr[i];
      for (int r = 1; r < R; ++r) a += wr[r * G * dh + i];
      wr[i] = a;
    }
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < kG; ++g)
      if (g < G) {
        mlw[warp * kMaxG + g] = m_r[g];
        mlw[(kConsumers + warp) * kMaxG + g] = l_r[g];
      }
  consumers_sync();

  // the block's (m, l, acc): the consumers merged in order
  for (int i = tid; i < G * dh; i += kConsumers * 32) {
    const int g = i / dh;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) M = fmaxf(M, mlw[w * kMaxG + g]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float c = expf(mlw[w * kMaxG + g] - M);
      a = fmaf(reinterpret_cast<const float*>(smem + w * L.stage)[i], c, a);
      l = fmaf(mlw[(kConsumers + w) * kMaxG + g], c, l);
    }
    float* o = ws + ((head0 + g) * n_split + split) * rec;
    o[i - g * dh] = a;
    if (i - g * dh == 0) {
      o[dh] = M;
      o[dh + 1] = l;
    }
  }
}

// ------------------------------------------------------------ combine
// Block (h, b): the G query heads of KV head h of slot b. Merges the live
// splits in order with the current token last. Launched as a programmatic
// dependent of the split kernel: it may start while the split kernel's
// last blocks run, and waits for their workspace before reading it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_combine(const T* __restrict__ q, const T* __restrict__ kn,
                         const T* __restrict__ vn, const int* __restrict__ lengths,
                         const float* __restrict__ ws, T* __restrict__ out, int S,
                         int H, int Hkv, int dh, int n_split, float scale) {
  __shared__ float mx[kMaxG], sn[kMaxG];
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long head0 = (long long)b * H + (long long)h * G;
  const long long new0 = ((long long)b * Hkv + h) * dh;
  const int rec = dh + 2;
  constexpr int kPerWarp = kMaxG / kWarps;  // query heads a warp scores
  float part[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int g = warp + i * kWarps;
    part[i] = 0.f;
    if (g < G)
      for (int d = lane; d < dh; d += 32)
        part[i] = fmaf(__fmul_rn(widen(q[(head0 + g) * dh + d]), scale),
                       widen(kn[new0 + d]), part[i]);
  }
  const int len = lengths[b];
  const int n_rows = len <= 0 ? 0 : (len < S ? len : S);
  const int ns = (n_rows + kSplit - 1) / kSplit;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the splits' workspace
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int g = warp + i * kWarps;
    if (g >= G) break;
    const float s_new = warp_sum(part[i]);
    float m = s_new;
    const float* w = ws + (head0 + g) * n_split * rec + dh;
    for (int s = lane; s < ns; s += 32) m = fmaxf(m, w[s * rec]);
    m = warp_max(m);
    if (lane == 0) {
      mx[g] = m;
      sn[g] = s_new;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * dh; idx += kThreads) {
    const int g = idx / dh, d = idx - g * dh;
    const float M = mx[g];
    const float* w = ws + (head0 + g) * n_split * rec;
    float a = 0.f, l = 0.f;
#pragma unroll 8
    for (int s = 0; s < ns; ++s) {
      const float c = expf(w[s * rec + dh] - M);
      l = fmaf(w[s * rec + dh + 1], c, l);
      a = fmaf(w[s * rec + d], c, a);
    }
    // the current token always attends itself, at full precision
    const float pn = expf(sn[g] - M);
    a = fmaf(pn, widen(vn[new0 + d]), a);
    store(out + head0 * dh + idx, a / fmaxf(l + pn, 1e-30f));
  }
}

// ------------------------------------------------------------ host side
int pick_unit(int dhp, const void* kq, const void* vq) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(kq) | reinterpret_cast<uintptr_t>(vq);
  for (int u = 16; u >= 4; u /= 2)
    if (dhp % u == 0 && a % u == 0) return u;
  return 0;  // byte loads
}

template <bool kInt4, bool kPaged, int kUnit, int kG>
cudaError_t launch_split(dim3 grid, int smem, cudaStream_t st, const void* q, bool q_bf16,
                         const void* kq, const void* vq, const void* ks, const void* vs,
                         const void* lengths, const void* tables, void* ws, int S,
                         int nb, int blk, int NB, int H, int Hkv, int dh, int n_split,
                         float scale, bool bytes) {
  static int opted = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(decode_attention_split<kInt4, kPaged, kUnit, kG>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  decode_attention_split<kInt4, kPaged, kUnit, kG><<<grid, kSplitThreads, smem, st>>>(
      q, q_bf16, static_cast<const uint8_t*>(kq), static_cast<const uint8_t*>(vq),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(lengths), static_cast<const int*>(tables),
      static_cast<float*>(ws), S, nb, blk, NB, H, Hkv, dh, n_split, scale, bytes);
  return cudaGetLastError();
}

template <bool kPaged>
int dispatch(const void* q, const void* kq, const void* vq, const void* ks,
             const void* vs, const void* kn, const void* vn, const void* lengths,
             const void* tables, void* out, void* ws, int B, int S, int nb, int blk,
             int NB, int H, int Hkv, int dh, int n_split, int kv_bits, int in_bf16,
             float scale, void* stream) {
  if (B <= 0 || S < 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG || dh > kMaxDh ||
      dh <= 0 || (kv_bits == 4 && dh % 2 != 0) || (kv_bits != 4 && kv_bits != 8) ||
      n_split != (S + kSplit - 1) / kSplit || n_split > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool int4 = kv_bits == 4;
  const int dhp = int4 ? dh / 2 : dh;
  int unit = pick_unit(dhp, kq, vq);
  const bool bytes = unit == 0;
  if (bytes) unit = 4;
  const int smem = make_layout(dhp, unit, H / Hkv, dh).total;
  const dim3 grid(n_split, Hkv, B);
#define REPRO_DA_ARGS grid, smem, st, q, in_bf16 != 0, kq, vq, ks, vs, lengths, tables, ws, \
                      S, nb, blk, NB, H, Hkv, dh, n_split, scale, bytes
  cudaError_t err = cudaSuccess;
  // one instantiation a (bits, unit) for G = 1, one for 2 <= G <= kMaxG
  auto split = [&](auto int4_tag, auto g_tag) {
    constexpr bool kI4 = decltype(int4_tag)::value;
    constexpr int kG = decltype(g_tag)::value;
    return unit == 16 ? launch_split<kI4, kPaged, 16, kG>(REPRO_DA_ARGS)
         : unit == 8  ? launch_split<kI4, kPaged, 8, kG>(REPRO_DA_ARGS)
                      : launch_split<kI4, kPaged, 4, kG>(REPRO_DA_ARGS);
  };
  using One = std::integral_constant<int, 1>;
  using Many = std::integral_constant<int, kMaxG>;
  if (n_split == 0) {
    // an empty dense cache: every slot attends only its current token
  } else if (int4) {
    err = H == Hkv ? split(std::true_type{}, One{}) : split(std::true_type{}, Many{});
  } else {
    err = H == Hkv ? split(std::false_type{}, One{}) : split(std::false_type{}, Many{});
  }
#undef REPRO_DA_ARGS
  if (err != cudaSuccess) return static_cast<int>(err);
  // the combine, as a programmatic dependent launch of the split kernel
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* wsf = static_cast<const float*>(ws);
  const int* lens = static_cast<const int*>(lengths);
  if (in_bf16) {
    using T = __nv_bfloat16;
    err = cudaLaunchKernelEx(&cfg, decode_attention_combine<T>, static_cast<const T*>(q),
                             static_cast<const T*>(kn), static_cast<const T*>(vn), lens,
                             wsf, static_cast<T*>(out), S, H, Hkv, dh, n_split, scale);
  } else {
    err = cudaLaunchKernelEx(&cfg, decode_attention_combine<float>,
                             static_cast<const float*>(q), static_cast<const float*>(kn),
                             static_cast<const float*>(vn), lens, wsf,
                             static_cast<float*>(out), S, H, Hkv, dh, n_split, scale);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kv_bits: 8 (int8 codes) or 4 (packed nibbles); in_bf16: 0 = q, k_new,
// v_new and out are f32, 1 = bf16; scale = 1 / sqrt(dh) rounded to f32;
// ws: f32 (B, H, n_split, dh + 2), n_split = ceil(S / 64)
extern "C" int decode_attention_launch(const void* q, const void* kq,
                                       const void* vq, const void* ks,
                                       const void* vs, const void* kn,
                                       const void* vn, const void* lengths,
                                       void* out, void* ws, int B, int S, int H,
                                       int Hkv, int dh, int n_split, int kv_bits,
                                       int in_bf16, float scale, void* stream) {
  return dispatch<false>(q, kq, vq, ks, vs, kn, vn, lengths, nullptr, out, ws, B, S,
                         0, 1, 0, H, Hkv, dh, n_split, kv_bits, in_bf16, scale, stream);
}

// The paged entry: kq/vq/ks/vs are one layer of the pool, NB blocks of blk
// rows; tables (B, nb) int32; the dense extent is nb * blk, and
// n_split = ceil(nb * blk / 64).
extern "C" int decode_attention_paged_launch(
    const void* q, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* tables, const void* kn, const void* vn,
    const void* lengths, void* out, void* ws, int B, int nb, int blk, int NB,
    int H, int Hkv, int dh, int n_split, int kv_bits, int in_bf16, float scale,
    void* stream) {
  if (nb <= 0 || blk <= 0 || NB <= 0 || (long long)nb * blk > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(q, kq, vq, ks, vs, kn, vn, lengths, tables, out, ws, B,
                        nb * blk, nb, blk, NB, H, Hkv, dh, n_split, kv_bits, in_bf16,
                        scale, stream);
}
