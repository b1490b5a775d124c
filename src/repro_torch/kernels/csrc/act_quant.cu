// Activation quantization: f32 (M, K) -> int8 codes on the qrange grid
//   out = clamp(rint(x / s), qmin, qmax)     s: per-tensor scale
//
// Replaces: src/repro/kernels/act_quant.py::act_quant_pallas
//           (pl.pallas_call at act_quant.py:42).
//
// Numerics: x / s is the IEEE division (the reference divides; a multiply by
// 1/s differs in the last bit), and rintf rounds half to even as jnp.round
// and torch.round do (roundf would round half away from zero).
//
// Bound on H100: bytes. Each element is read once as f32 and written once
// as int8, 5 bytes for 4 cheap operations; at M = 4096, K = 1200 that is
// 24.6 MB, 7.3 us at 3.35 TB/s.
//
// Design: one flat pass over the M*K elements (rows are contiguous, so
// the ragged M and K edges are just the end of the range), four elements a
// thread per step with 16-byte loads and 4-byte stores where alignment
// allows, a grid-stride loop over the rest. The scale is read from device
// memory, so the caller never synchronises to fetch it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int8_t quant1(float x, float s, float qmin, float qmax) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(x, s)), qmin), qmax));
}

__global__ void act_quant_vec4(const float4* __restrict__ x,
                               const float* __restrict__ s,
                               char4* __restrict__ out, long long n4, float qmin,
                               float qmax) {
  const float sv = *s;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    char4 o;
    o.x = quant1(v.x, sv, qmin, qmax);
    o.y = quant1(v.y, sv, qmin, qmax);
    o.z = quant1(v.z, sv, qmin, qmax);
    o.w = quant1(v.w, sv, qmin, qmax);
    out[i] = o;
  }
}

__global__ void act_quant_scalar(const float* __restrict__ x,
                                 const float* __restrict__ s,
                                 int8_t* __restrict__ out, long long n,
                                 float qmin, float qmax) {
  const float sv = *s;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = quant1(x[i], sv, qmin, qmax);
}

}  // namespace

extern "C" int act_quant_launch(const void* x, const void* s, void* out, int M,
                                int K, int qmin, int qmax, void* stream) {
  const long long n = (long long)M * K;
  const int threads = 256;
  const long long max_blocks = 132LL * 16;  // 16 resident blocks per SM
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  if (vec) {
    const long long n4 = n / 4;
    long long blocks = (n4 + threads - 1) / threads;
    if (blocks > max_blocks) blocks = max_blocks;
    act_quant_vec4<<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const float4*>(x), static_cast<const float*>(s),
        static_cast<char4*>(out), n4, (float)qmin, (float)qmax);
  } else {
    long long blocks = (n + threads - 1) / threads;
    if (blocks > max_blocks) blocks = max_blocks;
    act_quant_scalar<<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(s),
        static_cast<int8_t*>(out), n, (float)qmin, (float)qmax);
  }
  return static_cast<int>(cudaGetLastError());
}
