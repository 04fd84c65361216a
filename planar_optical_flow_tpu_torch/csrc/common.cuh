// Device helpers shared by the port's CUDA sources: the block shape of the
// int8 stacks and gates, LeakyReLU 0.1, the int8 requant and warp
// reductions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// leaky(v) with the product rounded on its own (never contracted)
__device__ __forceinline__ float leaky(float v) {
  return v > 0.0f ? v : __fmul_rn(0.1f, v);
}

// clip(rint(v), -127, 127); rintf rounds half to even, as jnp.rint does
__device__ __forceinline__ int requant(float v) {
  return (int)fminf(fmaxf(rintf(v), -127.0f), 127.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// allow a launch of `kernel` with `bytes` of dynamic shared memory
inline int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
