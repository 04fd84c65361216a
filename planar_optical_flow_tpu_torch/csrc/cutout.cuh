// The per-beam cutout arithmetic of K1 (cutout.cu), shared with K8
// (conv_stack_int8.cu backbone_int8_cut_kernel), which computes the same
// cutouts inside the int8 backbone's block.
//
// The f32 arithmetic is spelled with explicit round-to-nearest intrinsics in
// the form the JAX kernel takes on XLA's CPU backend (the tests' reference)
// and the plain PyTorch version (ops/kernels/cutout_kernel.py) repeats:
// divisions by the constants c - 1, angle_inc and window_depth are
// multiplies by their f32 reciprocals, the index and lerp multiply-adds are
// fused (__fmaf_rn), and the area-mode band sum differences an f32 prefix
// sum computed in XLA's order (scan_xla).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

constexpr int kScanBase = 16;
constexpr int kScanLevels = 4;  // scans of up to 16^4 beams

// The scan geometry and options of one launch (host values; the
// reciprocals are the f32 constants XLA multiplies by).
struct CutoutCfg {
  int p_valid;  // real beams; beams >= p_valid are out of range
  int c;        // taps per cutout
  float half_width, window_depth, padding_val;
  float inv_c1, inv_angle, inv_depth;
  int centered, area_mode;
};

// shared-memory floats of the scan's row totals that scan_xla needs
__host__ __device__ inline int scan_scratch_floats(int p) {
  return (p + kScanBase - 2) / (kScanBase - 1) + 4;
}

// fractional beam index of tap k of beam i:
//   i + (k * delta - half_alpha) / angle_inc,  delta = 2 * half_alpha / (c-1)
__device__ __forceinline__ float tap_index(int i, int k, float half_alpha,
                                           float inv_c1, float inv_angle) {
  const float delta = __fmul_rn(__fmul_rn(2.0f, half_alpha), inv_c1);
  const float off = __fmaf_rn((float)k, delta, -half_alpha);
  return __fmaf_rn(off, inv_angle, (float)i);
}

// the half-window angle of a beam at range r
__device__ __forceinline__ float half_alpha_of(float r, float half_width) {
  return atanf(__fdiv_rn(half_width, fmaxf(r, 1e-2f)));
}

// In-place inclusive f32 prefix sum of v[0..n) in the order XLA's CPU
// backend computes jnp.cumsum: sequential within rows of 16, the row totals
// (into `scratch`) scanned the same way, then each row's exclusive offset
// added. Every thread of the block calls it.
__device__ void scan_xla(float* v, int n, float* scratch) {
  float* lv[kScanLevels + 1];
  int ln[kScanLevels + 1];
  lv[0] = v;
  ln[0] = n;
  int top = 0;
  while (ln[top] > kScanBase && top < kScanLevels) {
    const int rows = (ln[top] + kScanBase - 1) / kScanBase;
    lv[top + 1] = scratch;
    ln[top + 1] = rows;
    scratch += rows;
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const int end = min((r + 1) * kScanBase, ln[top]);
      float acc = 0.0f;
      for (int i = r * kScanBase; i < end; ++i) {
        acc = __fadd_rn(acc, lv[top][i]);
        lv[top][i] = acc;
      }
      lv[top + 1][r] = acc;
    }
    __syncthreads();
    ++top;
  }
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int i = 0; i < ln[top]; ++i) {
      acc = __fadd_rn(acc, lv[top][i]);
      lv[top][i] = acc;
    }
  }
  __syncthreads();
  for (int k = top - 1; k >= 0; --k) {
    for (int i = threadIdx.x + kScanBase; i < ln[k]; i += blockDim.x)
      lv[k][i] = __fadd_rn(lv[k][i], lv[k + 1][i / kScanBase - 1]);
    __syncthreads();
  }
}

// Tap k of beam i's cutout. r_s: the scan's ranges; cs_s: its prefix sums
// with cs_s[j] = sum of beams < j (read in area mode only); ha: beam i's
// half-window angle.
__device__ __forceinline__ float cutout_tap(const float* r_s,
                                            const float* cs_s, int i, int k,
                                            float ha, const CutoutCfg& cfg) {
  const int c = cfg.c;
  const float hi_idx = (float)(cfg.p_valid - 1);
  const float dist = r_s[i];
  const float ind = tap_index(i, k, ha, cfg.inv_c1, cfg.inv_angle);
  const bool outbound = ind < 0.0f || ind > hi_idx;
  const int low = (int)clampf(floorf(ind), 0.0f, hi_idx);
  const int high = min(low + 1, cfg.p_valid - 1);
  const float frac = clampf(__fsub_rn(ind, (float)low), 0.0f, 1.0f);
  const float lo_v = r_s[low];
  float ct = __fmaf_rn(frac, __fsub_rn(r_s[high], lo_v), lo_v);
  if (cfg.area_mode) {
    const float ind0 = tap_index(i, 0, ha, cfg.inv_c1, cfg.inv_angle);
    const float ind1 = tap_index(i, c - 1, ha, cfg.inv_c1, cfg.inv_angle);
    const float span = __fsub_rn(ind1, ind0);
    if (span > (float)c) {
      const float tap_w = __fmul_rn(span, cfg.inv_c1);
      const float half_tap = __fmul_rn(0.5f, tap_w);
      const int a_lo = (int)rintf(clampf(__fsub_rn(ind, half_tap), 0.0f,
                                         hi_idx));
      const int a_hi = max((int)rintf(clampf(__fadd_rn(ind, half_tap), 0.0f,
                                             hi_idx)), a_lo);
      const float band = __fsub_rn(cs_s[a_hi + 1], cs_s[a_lo]);
      ct = __fdiv_rn(band, (float)(a_hi - a_lo + 1));
    }
  }
  if (outbound) ct = cfg.padding_val;
  ct = clampf(ct, __fsub_rn(dist, cfg.window_depth),
              __fadd_rn(dist, cfg.window_depth));
  if (cfg.centered) ct = __fmul_rn(__fsub_rn(ct, dist), cfg.inv_depth);
  return ct;
}

}  // namespace
