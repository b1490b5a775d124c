// Activation quantization: f32 or bf16 (M, K) -> int8 codes on the qrange grid
//   out = clamp(rint(float(x) / s), qmin, qmax)     s: per-tensor scale
//
// Replaces: src/repro/kernels/act_quant.py::act_quant_pallas
//           (pl.pallas_call at act_quant.py:42).
//
// Numerics: quant.cuh, shared with the split-K GEMM's activation load.
//
// Bound on H100: bytes. Each element is read once as f32 (bf16) and
// written once as int8, 5 (3) bytes for 4 cheap operations; at M = 4096,
// K = 1200 that is 24.6 MB, 7.3 us at 3.35 TB/s.
//
// Design: one pass over the M*K elements, eight elements a group: a
// 16-byte load of bf16 (two of f32) and an 8-byte store of codes, two
// groups a thread in flight at once (32 bytes of bf16, 64 of f32), in a
// grid-stride loop over a grid of the blocks the SMs hold at once; a
// scalar loop where K % 8 != 0 or alignment does not allow. The codes go
// out at a row pitch of ld >= K bytes: ld = K is one flat range (rows are
// contiguous, so the ragged M and K edges are just the end of it); a wider
// pitch (the wgmma GEMM's TMA rows, a multiple of 16 bytes) writes the K
// real columns of each row and leaves the pad bytes alone. The scale is
// read from device memory, so the caller never synchronises to fetch it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

using repro_kernels::quant1;
using repro_kernels::quant4;
using repro_kernels::widen;

// eight consecutive elements of T: 16 bytes of bf16, or two float4 of f32
template <typename T> struct Vec8;
template <> struct Vec8<float> {
  struct type { float4 a, b; };
  __device__ static void get(const type& v, float (&lo)[4], float (&hi)[4]) {
    lo[0] = v.a.x; lo[1] = v.a.y; lo[2] = v.a.z; lo[3] = v.a.w;
    hi[0] = v.b.x; hi[1] = v.b.y; hi[2] = v.b.z; hi[3] = v.b.w;
  }
};
template <> struct Vec8<__nv_bfloat16> {
  using type = uint4;
  __device__ static void get(const uint4& v, float (&lo)[4], float (&hi)[4]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    lo[0] = __low2float(h[0]); lo[1] = __high2float(h[0]);
    lo[2] = __low2float(h[1]); lo[3] = __high2float(h[1]);
    hi[0] = __low2float(h[2]); hi[1] = __high2float(h[2]);
    hi[2] = __low2float(h[3]); hi[3] = __high2float(h[3]);
  }
};

template <typename T>
__device__ __forceinline__ uint2 codes8(const typename Vec8<T>::type& v, float s,
                                        float qmin, float qmax) {
  float lo[4], hi[4];
  Vec8<T>::get(v, lo, hi);
  return make_uint2(quant4(lo, s, qmin, qmax), quant4(hi, s, qmin, qmax));
}

// kPitched: group i of 8 is row i / k8, group i % k8 of it, stored at
// row * ld8 + group; otherwise i is its own place (ld = K)
template <typename T, bool kPitched>
__global__ void act_quant_vec8(const typename Vec8<T>::type* __restrict__ x,
                               const float* __restrict__ s, uint2* __restrict__ out,
                               long long n8, int k8, int ld8, float qmin, float qmax) {
  const float sv = *s;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n8;
       i += 2 * stride) {
    const long long j = i + stride;
    const typename Vec8<T>::type v0 = x[i];
    typename Vec8<T>::type v1;
    if (j < n8) v1 = x[j];
    out[kPitched ? (i / k8) * ld8 + i % k8 : i] = codes8<T>(v0, sv, qmin, qmax);
    if (j < n8) out[kPitched ? (j / k8) * ld8 + j % k8 : j] = codes8<T>(v1, sv, qmin, qmax);
  }
}

template <typename T>
__global__ void act_quant_scalar(const T* __restrict__ x,
                                 const float* __restrict__ s,
                                 int8_t* __restrict__ out, long long n, int K,
                                 int ld, float qmin, float qmax) {
  const float sv = *s;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[(i / K) * ld + i % K] = quant1(widen(x[i]), sv, qmin, qmax);
}

template <typename T>
int launch(const void* x, const void* s, void* out, int M, int K, int ld, float qmin,
           float qmax, cudaStream_t st) {
  const long long n = (long long)M * K;
  const int threads = 256;
  const long long max_blocks = 132LL * 8;  // the 2048 threads an SM holds, 132 SMs
  const bool vec = K % 8 == 0 && ld % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 8 == 0;
  if (vec) {
    const long long n8 = n / 8;
    long long blocks = (n8 + 2 * threads - 1) / (2 * threads);
    if (blocks > max_blocks) blocks = max_blocks;
    auto kernel = ld == K ? act_quant_vec8<T, false> : act_quant_vec8<T, true>;
    kernel<<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const typename Vec8<T>::type*>(x), static_cast<const float*>(s),
        static_cast<uint2*>(out), n8, K / 8, ld / 8, qmin, qmax);
  } else {
    long long blocks = (n + threads - 1) / threads;
    if (blocks > max_blocks) blocks = max_blocks;
    act_quant_scalar<T><<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(s),
        static_cast<int8_t*>(out), n, K, ld, qmin, qmax);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in_bf16: 0 = x is f32, 1 = x is bf16; ld: the codes' row pitch (>= K)
extern "C" int act_quant_launch(const void* x, const void* s, void* out, int M,
                                int K, int ld, int qmin, int qmax, int in_bf16,
                                void* stream) {
  if (M < 0 || K < 1 || ld < K) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch<__nv_bfloat16>(x, s, out, M, K, ld, (float)qmin, (float)qmax, st);
  return launch<float>(x, s, out, M, K, ld, (float)qmin, (float)qmax, st);
}
