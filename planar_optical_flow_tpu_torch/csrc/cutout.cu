// K1: fused per-beam cutout for Hopper (sm_90a).
//
// Replaces planar_optical_flow_tpu/ops/pallas/cutout_kernel.py cutout_fused
// (math in cutout_block). (B, P) f32 scans -> (B*P, C) f32 cutouts.
//
// One block per scan: the P ranges and their half-window angles sit in
// shared memory, and the block's threads walk the P*C (beam, tap) pairs, so
// every lerp and band-mean gather is a shared-memory read. HBM sees the scan
// once and the cutouts once: the kernel is bound by the bytes it writes
// (4*C per beam).
//
// The index arithmetic is written with explicit round-to-nearest intrinsics
// (no FMA contraction) in the order of the JAX kernel and of the plain
// PyTorch version (ops/kernels/cutout_kernel.py), so the floor/rint
// decisions of the three agree.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// fractional beam index of tap k of beam i:
//   i + (k * delta - half_alpha) / angle_inc,  delta = 2 * half_alpha / (c-1)
__device__ __forceinline__ float tap_index(int i, int k, float half_alpha,
                                           int c, float angle_inc) {
  float delta = __fdiv_rn(__fmul_rn(2.0f, half_alpha), (float)(c - 1));
  float off = __fsub_rn(__fmul_rn((float)k, delta), half_alpha);
  return __fadd_rn((float)i, __fdiv_rn(off, angle_inc));
}

__global__ void cutout_kernel(const float* __restrict__ scans,
                              float* __restrict__ out, int p, int p_valid,
                              int c, float half_width, float window_depth,
                              float padding_val, float angle_inc,
                              int centered, int area_mode) {
  extern __shared__ float smem[];
  float* r_s = smem;       // ranges (p)
  float* ha_s = smem + p;  // half-window angles (p)
  const int b = blockIdx.x;
  const float* scan = scans + (size_t)b * p;
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    float r = scan[i];
    r_s[i] = r;
    ha_s[i] = atanf(__fdiv_rn(half_width, fmaxf(r, 1e-2f)));
  }
  __syncthreads();

  const float hi_idx = (float)(p_valid - 1);
  for (int idx = threadIdx.x; idx < p * c; idx += blockDim.x) {
    const int i = idx / c;
    const int k = idx - i * c;
    const float dist = r_s[i];
    const float ha = ha_s[i];
    const float ind = tap_index(i, k, ha, c, angle_inc);
    const bool outbound = ind < 0.0f || ind > hi_idx;
    const int low = (int)clampf(floorf(ind), 0.0f, hi_idx);
    const int high = min(low + 1, p_valid - 1);
    const float frac = clampf(__fsub_rn(ind, (float)low), 0.0f, 1.0f);
    const float lo_v = r_s[low];
    float ct = __fadd_rn(lo_v, __fmul_rn(frac, __fsub_rn(r_s[high], lo_v)));
    if (area_mode) {
      const float ind0 = tap_index(i, 0, ha, c, angle_inc);
      const float ind1 = tap_index(i, c - 1, ha, c, angle_inc);
      const float span = __fsub_rn(ind1, ind0);
      if (span > (float)c) {
        const float tap_w = __fdiv_rn(span, (float)(c - 1));
        const float half_tap = __fmul_rn(0.5f, tap_w);
        const int a_lo = (int)rintf(clampf(__fsub_rn(ind, half_tap), 0.0f,
                                           hi_idx));
        const int a_hi = max((int)rintf(clampf(__fadd_rn(ind, half_tap), 0.0f,
                                               hi_idx)), a_lo);
        float band = 0.0f;
        for (int j = a_lo; j <= a_hi; ++j) band += r_s[j];
        ct = __fdiv_rn(band, (float)(a_hi - a_lo + 1));
      }
    }
    if (outbound) ct = padding_val;
    ct = clampf(ct, __fsub_rn(dist, window_depth),
                __fadd_rn(dist, window_depth));
    if (centered) ct = __fdiv_rn(__fsub_rn(ct, dist), window_depth);
    out[((size_t)b * p + i) * c + k] = ct;
  }
}

}  // namespace

// dynamic shared memory a launch asks for (bytes)
extern "C" long long cutout_smem_bytes(int p) {
  return 2 * (long long)p * sizeof(float);
}

extern "C" int cutout_launch(const void* scans, void* out, int b, int p,
                             int p_valid, int c, float window_width,
                             float window_depth, float padding_val,
                             float angle_inc, int centered, int area_mode,
                             void* stream) {
  if (b == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)cutout_smem_bytes(p);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cutout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cutout_kernel<<<b, 256, smem, (cudaStream_t)stream>>>(
      (const float*)scans, (float*)out, p, p_valid, c, 0.5f * window_width,
      window_depth, padding_val, angle_inc, centered, area_mode);
  return (int)cudaGetLastError();
}
