// Activation quantization's arithmetic, shared by the standalone kernel
// (act_quant.cu) and the split-K GEMM's activation load
// (int_gemm_splitk.cuh), so that both write the same codes:
//
//   code = clamp(rint(float(x) / s), qmin, qmax)     s: per-tensor scale
//
// bf16 inputs widen to f32 exactly first (the reference's x.astype(f32));
// x / s is the IEEE division (the reference divides; a multiply by 1/s
// differs in the last bit), and rintf rounds half to even as jnp.round and
// torch.round do (roundf would round half away from zero).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_kernels {

__device__ __forceinline__ int8_t quant1(float x, float s, float qmin, float qmax) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(x, s)), qmin), qmax));
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// four codes of consecutive elements as one little-endian word
__device__ __forceinline__ uint32_t quant4(const float (&f)[4], float s, float qmin,
                                           float qmax) {
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w |= uint32_t(uint8_t(quant1(f[j], s, qmin, qmax))) << (8 * j);
  return w;
}

}  // namespace repro_kernels
