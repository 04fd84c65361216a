// K3 (bf16 gate) and K6 (int8-carry gate): the serving spatial-attention
// gate for Hopper (sm_90a).
//
// K3 replaces planar_optical_flow_tpu/infer/fast_gate.py gate_fused_flat
// (kernel _gate_fused_kernel); K6 replaces gate_fused_int8_pm with
// per_stream=True (kernel _gate_int8_pm_stream_kernel, _quantize_attn,
// _mix_requant). Both share the front half, as the JAX kernels share
// _attention_body (band_attention and z_mix_and_sim below). Per stream of ct
// rows (ct_valid of them real):
//   ex = leaky(zx), et = leaky(zt)
//   valid = 0 <= i + o < ct_valid and i < ct_valid,  o in [-hw, hw]
//   s[i, o] = ex[i] . et[i + o] where valid, else ex[i] . et[0] for
//             i + o < 0 and ex[i] . et[ct_valid - 1] otherwise
//   attn = validity-masked softmax over o (f32)
//   new_z[i] = alpha * zx[i] + beta * sum_o bf16(attn[i, o]) * zt[i + o]
//   sim[i, o] = s[i, o] (the edge rows reproduce the reference's
//               edge-clamped duplicates exactly)
// K3 (bf16 x and template):
//   new_t[i] = alpha * x[i] + beta * sum_o bf16(attn[i, o]) * t[i + o]
// K6 (int8 x at s_x, template at s_t, output at s_out):
//   q[i, o] = clip(rint(127 * attn[i, o]))           (from the f32 attn)
//   m[i] = sum_o q[i, o] * t[i + o]                   (exact, int32)
//   new_t[i] = clip(rint((alpha * (s_x * x[i]) + beta * ((s_t / 127) * m[i]))
//                        / s_out))
//   every f32 step rounded once in the JAX order (__f*_rn, a true division).
// beta = 1 - alpha and s_t / 127 are computed in double on the host and
// rounded once to f32, as the JAX kernels' Python constants are. Rows >=
// ct_valid have no valid offset: attn = 0, the template mix is 0.
//
// Grid (stream, D-chunk). Each block computes the stream's banded attention
// from the (ct, 128) embeddings into shared memory (one warp per row,
// channel dot products reduced with shuffles), then applies the band to its
// D-chunk as 2*hw+1 multiply-adds per element. The TPU kernels' dense
// (ct, ct) MXU matmul is not carried over. new_t and new_z go to fresh
// buffers: the TPU kernels alias the carry, but here a block writing row i
// while another reads row i +- hw of the old template would race in place.
//
// Bound: device-memory bytes. Per cutout K3 reads x and the template (2 x 7
// KB bf16 at D=3584) and writes new_t (7 KB); K6 moves a third of that in
// int8 (3 x 3.5 KB); both add the small embeddings and sim. The template rows
// each block re-reads for the band come from L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// Row i's banded attention, one warp (the JAX _attention_body): lane
// k < window ends with offset k's raw similarity, its validity and its f32
// attention; the other lanes hold attention 0.
struct BandLane {
  float s;
  bool valid;
  float attn;
};

__device__ __forceinline__ BandLane band_attention(const bf16* __restrict__ zx,
                                                   const bf16* __restrict__ zt,
                                                   size_t row0, int i,
                                                   int ct_valid, int window,
                                                   int lane) {
  const int hw = window / 2;
  float ex[4];
  load4(zx + (row0 + i) * 128 + lane * 4, ex);
#pragma unroll
  for (int q = 0; q < 4; ++q) ex[q] = leaky(ex[q]);
  BandLane r = {0.0f, false, 0.0f};
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
      r.s = part;
      r.valid = valid;
    }
  }
  const float masked = lane < window ? (r.valid ? r.s : -1e10f) : -INFINITY;
  const float m = warp_max(masked);
  const float e = (lane < window && r.valid) ? expf(masked - m) : 0.0f;
  const float denom = fmaxf(warp_sum(e), 1e-20f);
  r.attn = e / denom;
  return r;
}

// Row i's sim and z-carry mix (the chunk-0 block's share): `a` is lane k's
// bf16-rounded attention, the JAX z-mix operand.
__device__ __forceinline__ void z_mix_and_sim(
    const bf16* __restrict__ zx, const bf16* __restrict__ zt,
    bf16* __restrict__ new_z, float* __restrict__ sim, size_t row0, int i,
    int window, const BandLane& r, float a, float alpha, float beta,
    int lane) {
  const int hw = window / 2;
  const size_t row = row0 + i;
  if (lane < window) sim[row * window + lane] = r.s;
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

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ int requant(float v) {
  return (int)fminf(fmaxf(rintf(v), -127.0f), 127.0f);
}

__device__ __forceinline__ int sbyte(unsigned w, int b) {
  return (int)(signed char)(w >> (8 * b));
}

__global__ void __launch_bounds__(kThreads)
    gate_kernel(const bf16* __restrict__ zx, const bf16* __restrict__ zt,
                const bf16* __restrict__ x, const bf16* __restrict__ t,
                bf16* __restrict__ new_t, bf16* __restrict__ new_z,
                float* __restrict__ sim, int ct, int ct_valid, int window,
                int d, int d_chunk, float alpha, float beta) {
  extern __shared__ float attn_s[];  // (ct, window) bf16-rounded attention
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hw = window / 2;
  const size_t row0 = (size_t)blockIdx.x * ct;

  // ---- banded attention (every chunk block), sim + new_z (chunk 0) ----
  for (int i = warp; i < ct; i += kWarps) {
    const BandLane r = band_attention(zx, zt, row0, i, ct_valid, window, lane);
    const float a = bf16_round(r.attn);
    if (lane < window) attn_s[i * window + lane] = a;
    if (blockIdx.y == 0)
      z_mix_and_sim(zx, zt, new_z, sim, row0, i, window, r, a, alpha, beta,
                    lane);
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

__global__ void __launch_bounds__(kThreads)
    gate_int8_kernel(const bf16* __restrict__ zx, const bf16* __restrict__ zt,
                     const int8_t* __restrict__ x, const int8_t* __restrict__ t,
                     int8_t* __restrict__ new_t, bf16* __restrict__ new_z,
                     float* __restrict__ sim, int ct, int ct_valid, int window,
                     int d, int d_chunk, float alpha, float beta, float s_x,
                     float s_t127, float s_out) {
  extern __shared__ int attn_q[];  // (ct, window) clip(rint(127 * attn))
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hw = window / 2;
  const size_t row0 = (size_t)blockIdx.x * ct;

  for (int i = warp; i < ct; i += kWarps) {
    const BandLane r = band_attention(zx, zt, row0, i, ct_valid, window, lane);
    if (lane < window) attn_q[i * window + lane] = requant(__fmul_rn(r.attn, 127.0f));
    if (blockIdx.y == 0)
      z_mix_and_sim(zx, zt, new_z, sim, row0, i, window, r,
                    bf16_round(r.attn), alpha, beta, lane);
  }
  __syncthreads();

  // ---- int8 template mix + requant on this block's D-chunk, 16 columns a
  // thread: the 2*hw+1 products summed exactly in int32 ----
  const int nvec = d_chunk / 16;
  const size_t col0 = (size_t)blockIdx.y * d_chunk;
  for (int idx = threadIdx.x; idx < ct * nvec; idx += kThreads) {
    const int i = idx / nvec;
    const size_t col = col0 + (size_t)(idx - i * nvec) * 16;
    int acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0;
    for (int k = 0; k < window; ++k) {
      const int q = attn_q[i * window + k];
      if (q != 0) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(t + (row0 + i + k - hw) * d + col);
        const unsigned w4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] += q * sbyte(w4[e >> 2], e & 3);
      }
    }
    const uint4 xraw = *reinterpret_cast<const uint4*>(x + (row0 + i) * d + col);
    const unsigned xw[4] = {xraw.x, xraw.y, xraw.z, xraw.w};
    unsigned ow[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float mixed = __fmul_rn(__int2float_rn(acc[e]), s_t127);
      const float xf = __fmul_rn((float)sbyte(xw[e >> 2], e & 3), s_x);
      const float v = __fadd_rn(__fmul_rn(alpha, xf), __fmul_rn(beta, mixed));
      ow[e >> 2] |= ((unsigned)requant(__fdiv_rn(v, s_out)) & 0xffu)
                    << (8 * (e & 3));
    }
    *reinterpret_cast<uint4*>(new_t + (row0 + i) * d + col) =
        make_uint4(ow[0], ow[1], ow[2], ow[3]);
  }
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// dynamic shared memory a launch asks for (bytes; the same for K3 and K6)
extern "C" long long gate_smem_bytes(int ct, int window) {
  return (long long)ct * window * sizeof(float);
}

extern "C" int gate_launch(const void* zx, const void* zt, const void* x,
                           const void* t, void* new_t, void* new_z, void* sim,
                           int n, int d, int ct, int ct_valid, int window,
                           int d_chunk, float alpha, float beta, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)gate_smem_bytes(ct, window);
  int err = set_smem((const void*)gate_kernel, smem);
  if (err) return err;
  const dim3 grid(n / ct, d / d_chunk);
  gate_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)zx, (const bf16*)zt, (const bf16*)x, (const bf16*)t,
      (bf16*)new_t, (bf16*)new_z, (float*)sim, ct, ct_valid, window, d,
      d_chunk, alpha, beta);
  return (int)cudaGetLastError();
}

extern "C" int gate_int8_launch(const void* zx, const void* zt, const void* x,
                                const void* t, void* new_t, void* new_z,
                                void* sim, int n, int d, int ct, int ct_valid,
                                int window, int d_chunk, float alpha,
                                float beta, float s_x, float s_t127,
                                float s_out, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)gate_smem_bytes(ct, window);
  int err = set_smem((const void*)gate_int8_kernel, smem);
  if (err) return err;
  const dim3 grid(n / ct, d / d_chunk);
  gate_int8_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)zx, (const bf16*)zt, (const int8_t*)x, (const int8_t*)t,
      (int8_t*)new_t, (bf16*)new_z, (float*)sim, ct, ct_valid, window, d,
      d_chunk, alpha, beta, s_x, s_t127, s_out);
  return (int)cudaGetLastError();
}
