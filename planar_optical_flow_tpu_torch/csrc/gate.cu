// K3: the serving spatial-attention gate for Hopper (sm_90a).
//
// Replaces planar_optical_flow_tpu/infer/fast_gate.py gate_fused_flat
// (kernel _gate_fused_kernel, shared math _attention_body). Per stream of
// ct rows (ct_valid of them real):
//   ex = leaky(zx), et = leaky(zt)
//   valid = 0 <= i + o < ct_valid and i < ct_valid,  o in [-hw, hw]
//   s[i, o] = ex[i] . et[i + o] where valid, else ex[i] . et[0] for
//             i + o < 0 and ex[i] . et[ct_valid - 1] otherwise
//   attn = validity-masked softmax over o, rounded to bf16 (the JAX MXU
//          operand)
//   new_t[i] = alpha * x[i] + (1 - alpha) * sum_o attn[i, o] * t[i + o]
//   new_z[i] = alpha * zx[i] + (1 - alpha) * sum_o attn[i, o] * zt[i + o]
//   sim[i, o] = s[i, o] (the edge rows reproduce the reference's
//               edge-clamped duplicates exactly)
// Rows >= ct_valid have no valid offset: attn = 0, new_t = alpha * x.
//
// Grid (stream, D-chunk). Each block computes the stream's banded attention
// from the (ct, 128) embeddings into shared memory (one warp per row,
// channel dot products reduced with shuffles), then applies the band to its
// D-chunk as 2*hw+1 FMAs per element. The TPU kernel's dense (ct, ct) MXU
// matmul is not carried over. new_t and new_z go to fresh buffers: a block
// writing row i while another reads row i +- hw of the old template would
// race in place.
//
// Bound: HBM bytes. Per cutout it reads x and the template (2 x 7 KB at
// D=3584) and writes new_t (7 KB) plus the small embeddings and sim; the
// template rows each block re-reads for the band come from L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float leaky(float v) {
  return v > 0.0f ? v : 0.1f * v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// bf16 vectors move as one 8- or 16-byte access; the lanes are read and
// written through __nv_bfloat162 views of the register copy
__device__ __forceinline__ void load4(const bf16* p, float* f) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float2 a = __bfloat1622float2(h[q]);
    f[2 * q] = a.x;
    f[2 * q + 1] = a.y;
  }
}

__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 a = __bfloat1622float2(h[q]);
    f[2 * q] = a.x;
    f[2 * q + 1] = a.y;
  }
}

__device__ __forceinline__ void store4(bf16* p, const float* f) {
  uint2 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 2; ++q) h[q] = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void store8(bf16* p, const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__global__ void __launch_bounds__(kThreads)
    gate_kernel(const bf16* __restrict__ zx, const bf16* __restrict__ zt,
                const bf16* __restrict__ x, const bf16* __restrict__ t,
                bf16* __restrict__ new_t, bf16* __restrict__ new_z,
                float* __restrict__ sim, int ct, int ct_valid, int window,
                int d, int d_chunk, float alpha) {
  extern __shared__ float attn_s[];  // (ct, window) bf16-rounded attention
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hw = window / 2;
  const size_t row0 = (size_t)blockIdx.x * ct;
  const bool first_chunk = blockIdx.y == 0;
  const float beta = 1.0f - alpha;

  // ---- banded attention (every chunk block), sim + new_z (chunk 0) ----
  for (int i = warp; i < ct; i += kWarps) {
    const size_t row = row0 + i;
    float ex[4];
    load4(zx + row * 128 + lane * 4, ex);
#pragma unroll
    for (int q = 0; q < 4; ++q) ex[q] = leaky(ex[q]);
    float my_s = 0.0f;
    bool my_valid = false;
    for (int k = 0; k < window; ++k) {
      const int j = i + k - hw;
      const bool valid = j >= 0 && j < ct_valid && i < ct_valid;
      // an invalid offset reads row 0 below the stream, else row ct_valid-1
      const int jc = valid ? j : (j < 0 ? 0 : ct_valid - 1);
      float et[4];
      load4(zt + (row0 + jc) * 128 + lane * 4, et);
      float part = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) part += ex[q] * leaky(et[q]);
      part = warp_sum(part);
      if (lane == k) {
        my_s = part;
        my_valid = valid;
      }
    }
    const float masked =
        lane < window ? (my_valid ? my_s : -1e10f) : -INFINITY;
    const float m = warp_max(masked);
    const float e = (lane < window && my_valid) ? expf(masked - m) : 0.0f;
    const float denom = fmaxf(warp_sum(e), 1e-20f);
    const float a = __bfloat162float(__float2bfloat16(e / denom));
    if (lane < window) attn_s[i * window + lane] = a;
    if (first_chunk) {
      if (lane < window) sim[row * window + lane] = my_s;
      float zm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k = 0; k < window; ++k) {
        const float ak = __shfl_sync(kFull, a, k);
        if (ak != 0.0f) {  // nonzero only at valid, in-range offsets
          float z4[4];
          load4(zt + (row0 + i + k - hw) * 128 + lane * 4, z4);
#pragma unroll
          for (int q = 0; q < 4; ++q) zm[q] += ak * z4[q];
        }
      }
      float zx4[4];
      load4(zx + row * 128 + lane * 4, zx4);
#pragma unroll
      for (int q = 0; q < 4; ++q) zx4[q] = alpha * zx4[q] + beta * zm[q];
      store4(new_z + row * 128 + lane * 4, zx4);
    }
  }
  __syncthreads();

  // ---- banded template mix on this block's D-chunk, 8 columns a thread ----
  const int nvec = d_chunk / 8;
  const size_t col0 = (size_t)blockIdx.y * d_chunk;
  for (int idx = threadIdx.x; idx < ct * nvec; idx += kThreads) {
    const int i = idx / nvec;
    const size_t col = col0 + (size_t)(idx - i * nvec) * 8;
    float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < window; ++k) {
      const float ak = attn_s[i * window + k];
      if (ak != 0.0f) {
        float tv[8];
        load8(t + (row0 + i + k - hw) * d + col, tv);
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[q] += ak * tv[q];
      }
    }
    float xv[8];
    load8(x + (row0 + i) * d + col, xv);
#pragma unroll
    for (int q = 0; q < 8; ++q) xv[q] = alpha * xv[q] + beta * acc[q];
    store8(new_t + (row0 + i) * d + col, xv);
  }
}

}  // namespace

// dynamic shared memory a launch asks for (bytes)
extern "C" long long gate_smem_bytes(int ct, int window) {
  return (long long)ct * window * sizeof(float);
}

extern "C" int gate_launch(const void* zx, const void* zt, const void* x,
                           const void* t, void* new_t, void* new_z, void* sim,
                           int n, int d, int ct, int ct_valid, int window,
                           int d_chunk, float alpha, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)gate_smem_bytes(ct, window);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n / ct, d / d_chunk);
  gate_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)zx, (const bf16*)zt, (const bf16*)x, (const bf16*)t,
      (bf16*)new_t, (bf16*)new_z, (float*)sim, ct, ct_valid, window, d,
      d_chunk, alpha);
  return (int)cudaGetLastError();
}
