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
//
// A cutout splits in two: the beam's geometry (beam_geometry: its index,
// half-window angle, tap spacing, clip bounds and, in area mode, whether its
// window spans more than c beams and its band's half width), which K1
// computes once a beam, and each tap's own work (beam_tap: its index, the
// lerp or the band mean, padding, clip and centering). K8 calls both for
// every tap (cutout_tap); the arithmetic is the same either way.

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

// One beam's geometry: everything of its cutout that is not a tap's own.
struct __align__(16) BeamGeom {
  float fi;        // the beam's index
  float ha;        // its half-window angle
  float delta;     // the tap spacing 2 * ha / (c - 1), rounded as XLA does
  float half_tap;  // half the width of an area-mode band
  float dist;      // the beam's range
  float lo, hi;    // the clip bounds dist -+ window_depth
  int area;        // area mode, and the window spans more than c beams
};

// fractional beam index of tap k (as a float) of beam g:
//   i + (k * delta - half_alpha) / angle_inc
__device__ __forceinline__ float tap_at(const BeamGeom& g, float k,
                                        float inv_angle) {
  const float off = __fmaf_rn(k, g.delta, -g.ha);
  return __fmaf_rn(off, inv_angle, g.fi);
}

// the geometry of beam i at range dist with half-window angle ha
__device__ __forceinline__ BeamGeom beam_geometry(int i, float dist,
                                                  float ha,
                                                  const CutoutCfg& cfg) {
  BeamGeom g;
  g.fi = (float)i;
  g.ha = ha;
  g.delta = __fmul_rn(__fmul_rn(2.0f, ha), cfg.inv_c1);
  g.dist = dist;
  g.lo = __fsub_rn(dist, cfg.window_depth);
  g.hi = __fadd_rn(dist, cfg.window_depth);
  g.area = 0;
  g.half_tap = 0.0f;
  if (cfg.area_mode) {
    const float ind0 = tap_at(g, 0.0f, cfg.inv_angle);
    const float ind1 = tap_at(g, (float)(cfg.c - 1), cfg.inv_angle);
    const float span = __fsub_rn(ind1, ind0);
    g.area = span > (float)cfg.c;
    g.half_tap = __fmul_rn(0.5f, __fmul_rn(span, cfg.inv_c1));
  }
  return g;
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

// Tap kf (the tap's index as a float) of beam g's cutout. r[j]: the range
// of beam j; cs(j): the sum of the ranges of beams < j (called in area mode
// only). Every beam read lies within the beam's reach, clamped to
// [0, p_valid - 1] (cs: [0, p_valid]), so the caller may stage a window of
// them. kDupLast: r[p_valid] holds a copy of r[p_valid - 1], so the lerp's
// upper beam min(low + 1, p_valid - 1) reads as r[low + 1].
template <bool kDupLast, class PrefixAt>
__device__ __forceinline__ float beam_tap(const BeamGeom& g, float kf,
                                          const float* r, PrefixAt cs,
                                          const CutoutCfg& cfg) {
  const float hi_idx = (float)(cfg.p_valid - 1);
  const float ind = tap_at(g, kf, cfg.inv_angle);
  const bool outbound = ind < 0.0f || ind > hi_idx;
  float ct;
  if (g.area) {
    // the mean over the beam band [rint(ind - tap_w/2), rint(ind + tap_w/2)]
    const int a_lo = (int)rintf(clampf(__fsub_rn(ind, g.half_tap), 0.0f,
                                       hi_idx));
    const int a_hi = max((int)rintf(clampf(__fadd_rn(ind, g.half_tap), 0.0f,
                                           hi_idx)), a_lo);
    const float band = __fsub_rn(cs(a_hi + 1), cs(a_lo));
    ct = __fdiv_rn(band, (float)(a_hi - a_lo + 1));
  } else {
    // (int)clamp(floor(ind), 0, hi_idx), and r[min(low + 1, p_valid - 1)]
    const int low = min(max(__float2int_rd(ind), 0), cfg.p_valid - 1);
    const float frac = clampf(__fsub_rn(ind, (float)low), 0.0f, 1.0f);
    const float lo_v = r[low];
    const float hi_v =
        kDupLast || low < cfg.p_valid - 1 ? r[low + 1] : lo_v;
    ct = __fmaf_rn(frac, __fsub_rn(hi_v, lo_v), lo_v);
  }
  if (outbound) ct = cfg.padding_val;
  ct = clampf(ct, g.lo, g.hi);
  if (cfg.centered) ct = __fmul_rn(__fsub_rn(ct, g.dist), cfg.inv_depth);
  return ct;
}

// Tap k of beam i's cutout, its geometry computed with it (K8). r_s: the
// scan's ranges; cs_s: its prefix sums with cs_s[j] = sum of beams < j
// (read in area mode only); ha: beam i's half-window angle.
__device__ __forceinline__ float cutout_tap(const float* r_s,
                                            const float* cs_s, int i, int k,
                                            float ha, const CutoutCfg& cfg) {
  return beam_tap<false>(beam_geometry(i, r_s[i], ha, cfg), (float)k, r_s,
                  [cs_s](int j) { return cs_s[j]; }, cfg);
}

}  // namespace
