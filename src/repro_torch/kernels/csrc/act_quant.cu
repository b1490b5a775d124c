// Activation quantization: f32 or bf16 (M, K) -> int8 codes on the qrange grid
//   out = clamp(rint(float(x) / s), qmin, qmax)     s: per-tensor scale
//
// Replaces: src/repro/kernels/act_quant.py::act_quant_pallas
//           (pl.pallas_call at act_quant.py:42).
//
// Numerics: bf16 inputs widen to f32 exactly first (the reference's
// x.astype(f32)); x / s is the IEEE division (the reference divides; a multiply by
// 1/s differs in the last bit), and rintf rounds half to even as jnp.round
// and torch.round do (roundf would round half away from zero).
//
// Bound on H100: bytes. Each element is read once as f32 (bf16) and
// written once as int8, 5 (3) bytes for 4 cheap operations; at M = 4096,
// K = 1200 that is 24.6 MB, 7.3 us at 3.35 TB/s.
//
// Design: one flat pass over the M*K elements (rows are contiguous, so
// the ragged M and K edges are just the end of the range), four elements a
// thread per step with 16-byte (f32) or 8-byte (bf16) loads and 4-byte
// stores where alignment allows, a grid-stride loop over the rest. The scale is read from device
// memory, so the caller never synchronises to fetch it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int8_t quant1(float x, float s, float qmin, float qmax) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(x, s)), qmin), qmax));
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// four consecutive elements of T: a float4 (f32) or 8 bytes (bf16)
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  using type = float4;
  __device__ static void get(const float4& v, float (&f)[4]) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};
template <> struct Vec4<__nv_bfloat16> {
  using type = uint2;
  __device__ static void get(const uint2& v, float (&f)[4]) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    f[0] = __low2float(a); f[1] = __high2float(a);
    f[2] = __low2float(b); f[3] = __high2float(b);
  }
};

template <typename T>
__global__ void act_quant_vec4(const typename Vec4<T>::type* __restrict__ x,
                               const float* __restrict__ s,
                               char4* __restrict__ out, long long n4, float qmin,
                               float qmax) {
  const float sv = *s;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float f[4];
    Vec4<T>::get(x[i], f);
    char4 o;
    o.x = quant1(f[0], sv, qmin, qmax);
    o.y = quant1(f[1], sv, qmin, qmax);
    o.z = quant1(f[2], sv, qmin, qmax);
    o.w = quant1(f[3], sv, qmin, qmax);
    out[i] = o;
  }
}

template <typename T>
__global__ void act_quant_scalar(const T* __restrict__ x,
                                 const float* __restrict__ s,
                                 int8_t* __restrict__ out, long long n,
                                 float qmin, float qmax) {
  const float sv = *s;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = quant1(widen(x[i]), sv, qmin, qmax);
}

template <typename T>
int launch(const void* x, const void* s, void* out, long long n, float qmin,
           float qmax, cudaStream_t st) {
  const int threads = 256;
  const long long max_blocks = 132LL * 16;  // 16 resident blocks per SM
  const bool vec = n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  if (vec) {
    const long long n4 = n / 4;
    long long blocks = (n4 + threads - 1) / threads;
    if (blocks > max_blocks) blocks = max_blocks;
    act_quant_vec4<T><<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const typename Vec4<T>::type*>(x),
        static_cast<const float*>(s), static_cast<char4*>(out), n4, qmin, qmax);
  } else {
    long long blocks = (n + threads - 1) / threads;
    if (blocks > max_blocks) blocks = max_blocks;
    act_quant_scalar<T><<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(s),
        static_cast<int8_t*>(out), n, qmin, qmax);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in_bf16: 0 = x is f32, 1 = x is bf16
extern "C" int act_quant_launch(const void* x, const void* s, void* out, int M,
                                int K, int qmin, int qmax, int in_bf16,
                                void* stream) {
  const long long n = (long long)M * K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch<__nv_bfloat16>(x, s, out, n, (float)qmin, (float)qmax, st);
  return launch<float>(x, s, out, n, (float)qmin, (float)qmax, st);
}
