// The band gate's device code, shared by gate.cu (K3, K6), gate_head_wg.cuh
// (K12, K13) and banded_mix.cu (K15): the banded attention of one row (the
// JAX _attention_body), the z-carry mix and similarity band, and the int8
// template mix's requant and operand staging. The attention and z mix take bf16 or f32
// embeddings (K3's two modes). Every row reads only its own current embedding and the CARRIED
// embedding and template rows i + o, |o| <= window / 2, of its stream, so a
// block may own any rows, provided it writes new rows to fresh buffers.
//
//   ex = leaky(zx), et = leaky(zt)
//   valid = 0 <= i + o < ct_valid and i < ct_valid,  o in [-hw, hw]
//   s[i, o] = ex[i] . et[i + o] where valid, else ex[i] . et[0] for
//             i + o < 0 and ex[i] . et[ct_valid - 1] otherwise
//   attn = validity-masked softmax over o (f32)
//   new_z[i] = alpha * zx[i] + beta * sum_o a[i, o] * zt[i + o], with
//              a = bf16(attn) (f32 attn in K3's f32 mode)
//   sim[i, o] = s[i, o] (the edge rows reproduce the reference's
//               edge-clamped duplicates exactly)
// The int8 mix (K6, K12, K13; int8 x at s_x, template at s_t, output at
// s_out):
//   q[i, o] = clip(rint(127 * attn[i, o]))           (from the f32 attn)
//   m[i] = sum_o q[i, o] * t[i + o]                   (exact, int32)
//   new_t[i] = clip(rint((alpha * (s_x * x[i]) + beta * ((s_t / 127) * m[i]))
//                        / s_out))
//   every f32 step rounded once in the JAX order (__f*_rn, a true division).
// beta = 1 - alpha and s_t / 127 are computed in double on the host and
// rounded once to f32, as the JAX kernels' Python constants are. Rows >=
// ct_valid have no valid offset: attn = 0, the template mix is 0.

#pragma once

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxWindow = 32;  // attention lanes a row (one warp): K12, K13

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

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  load4(p, f);
  load4(p + 4, f + 4);
}

__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  store4(p, f);
  store4(p + 4, f + 4);
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

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Row i's banded attention, one warp (the JAX _attention_body): lane
// k < window ends with offset k's raw similarity, its validity and its f32
// attention; the other lanes hold attention 0. zx_row: the row's (128,)
// embedding (device or shared memory); zt: the stream's carried (ct, 128)
// embeddings; both bf16 or both f32.
struct BandLane {
  float s;
  bool valid;
  float attn;
};

template <typename Z>
__device__ __forceinline__ BandLane band_attention(const Z* zx_row,
                                                   const Z* __restrict__ zt,
                                                   int i, int ct_valid,
                                                   int window, int lane) {
  const int hw = window / 2;
  float ex[4];
  load4(zx_row + lane * 4, ex);
#pragma unroll
  for (int q = 0; q < 4; ++q) ex[q] = leaky(ex[q]);
  BandLane r = {0.0f, false, 0.0f};
  for (int k = 0; k < window; ++k) {
    const int j = i + k - hw;
    const bool valid = j >= 0 && j < ct_valid && i < ct_valid;
    // an invalid offset reads row 0 below the stream, else row ct_valid-1
    const int jc = valid ? j : (j < 0 ? 0 : ct_valid - 1);
    float et[4];
    load4(zt + (size_t)jc * 128 + lane * 4, et);
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

// Row i's sim band and z-carry mix, one warp: `a` is lane k's attention as
// the JAX z mix takes it (bf16-rounded; f32 in K3's f32 mode). zt: the
// stream's carried embeddings; new_z_row / sim_row: the row's outputs.
template <typename Z>
__device__ __forceinline__ void z_mix_and_sim(
    const Z* zx_row, const Z* __restrict__ zt, Z* __restrict__ new_z_row,
    float* __restrict__ sim_row, int i, int window, const BandLane& r,
    float a, float alpha, float beta, int lane) {
  const int hw = window / 2;
  if (lane < window) sim_row[lane] = r.s;
  float zm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < window; ++k) {
    const float ak = __shfl_sync(kFull, a, k);
    if (ak != 0.0f) {  // nonzero only at valid, in-range offsets
      float z4[4];
      load4(zt + (long long)(i + k - hw) * 128 + lane * 4, z4);
#pragma unroll
      for (int q = 0; q < 4; ++q) zm[q] += ak * z4[q];
    }
  }
  float zx4[4];
  load4(zx_row + lane * 4, zx4);
#pragma unroll
  for (int q = 0; q < 4; ++q) zx4[q] = alpha * zx4[q] + beta * zm[q];
  store4(new_z_row + lane * 4, zx4);
}

// The int8 attention weight of one band lane: clip(rint(127 * attn))
__device__ __forceinline__ int quantize_attn(float attn) {
  return requant(__fmul_rn(attn, 127.0f));
}

// One new_t byte from its exact template mix m and its x byte:
// clip(rint((alpha * (s_x * x) + beta * (s_t127 * m)) / s_out)), each f32
// step rounded once in the JAX order
__device__ __forceinline__ int blend_requant(int m, int xb, float alpha,
                                             float beta, float s_x,
                                             float s_t127, float s_out) {
  const float mixed = __fmul_rn(__int2float_rn(m), s_t127);
  const float xf = __fmul_rn((float)xb, s_x);
  const float v = __fadd_rn(__fmul_rn(alpha, xf), __fmul_rn(beta, mixed));
  // A zero dividend sends __fdiv_rn down its slow path, a whole warp at a
  // time (zero bytes of x at a zero mix are common); 0 / s_out rounds to 0
  // either way, so a zero divides s_out instead and is put back.
  const float q = __fdiv_rn(v == 0.0f ? s_out : v, s_out);
  return requant(v == 0.0f ? 0.0f : q);
}

// word k of a 16-byte vector
__device__ __forceinline__ uint32_t word_of(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Four template rows' 16 bytes (tr[e]: row e of a quad, columns c .. c +
// 15) byte-transposed into the 16 words at dst: word c' holds the four
// rows' bytes of column c + c', the K order of the B operand of the int8
// mix's mma.m16n8k32 (K6, K12, K13)
__device__ __forceinline__ void transpose_quad(uint32_t* dst,
                                               const uint4 (&tr)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t r0 = word_of(tr[0], k), r1 = word_of(tr[1], k);
    const uint32_t r2 = word_of(tr[2], k), r3 = word_of(tr[3], k);
    const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
    const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
    const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
    const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
    *reinterpret_cast<uint4*>(dst + 4 * k) = make_uint4(
        __byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
        __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632));
  }
}

}  // namespace
