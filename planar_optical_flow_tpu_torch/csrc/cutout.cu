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
// The f32 arithmetic is spelled with explicit round-to-nearest intrinsics in
// the form the JAX kernel takes on XLA's CPU backend (the tests' reference)
// and the plain PyTorch version (ops/kernels/cutout_kernel.py) repeats:
// divisions by the constants c - 1, angle_inc and window_depth are
// multiplies by their f32 reciprocals, the index and lerp multiply-adds are
// fused (__fmaf_rn), and the area-mode band sum differences an f32 prefix
// sum computed in XLA's order (scan_xla). So the floor/rint decisions and the
// cutouts of the three agree to the bit (but for atanf, which differs from
// the other two implementations in the last bit of a few 1e-5 of beams).

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

constexpr int kScanBase = 16;
constexpr int kScanLevels = 4;  // scans of up to 16^4 beams

// fractional beam index of tap k of beam i:
//   i + (k * delta - half_alpha) / angle_inc,  delta = 2 * half_alpha / (c-1)
__device__ __forceinline__ float tap_index(int i, int k, float half_alpha,
                                           float inv_c1, float inv_angle) {
  const float delta = __fmul_rn(__fmul_rn(2.0f, half_alpha), inv_c1);
  const float off = __fmaf_rn((float)k, delta, -half_alpha);
  return __fmaf_rn(off, inv_angle, (float)i);
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

__global__ void cutout_kernel(const float* __restrict__ scans,
                              float* __restrict__ out, int p, int p_valid,
                              int c, float half_width, float window_depth,
                              float padding_val, float inv_c1,
                              float inv_angle, float inv_depth, int centered,
                              int area_mode) {
  extern __shared__ float smem[];
  float* r_s = smem;            // ranges (p)
  float* ha_s = smem + p;       // half-window angles (p)
  float* cs_s = ha_s + p;       // prefix sums, cs_s[i] = sum of beams < i
  float* scratch = cs_s + p + 1;
  const int b = blockIdx.x;
  const float* scan = scans + (size_t)b * p;
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    float r = scan[i];
    r_s[i] = r;
    ha_s[i] = atanf(__fdiv_rn(half_width, fmaxf(r, 1e-2f)));
    cs_s[i + 1] = r;
  }
  if (threadIdx.x == 0) cs_s[0] = 0.0f;
  __syncthreads();
  if (area_mode) scan_xla(cs_s + 1, p, scratch);

  const float hi_idx = (float)(p_valid - 1);
  for (int idx = threadIdx.x; idx < p * c; idx += blockDim.x) {
    const int i = idx / c;
    const int k = idx - i * c;
    const float dist = r_s[i];
    const float ha = ha_s[i];
    const float ind = tap_index(i, k, ha, inv_c1, inv_angle);
    const bool outbound = ind < 0.0f || ind > hi_idx;
    const int low = (int)clampf(floorf(ind), 0.0f, hi_idx);
    const int high = min(low + 1, p_valid - 1);
    const float frac = clampf(__fsub_rn(ind, (float)low), 0.0f, 1.0f);
    const float lo_v = r_s[low];
    float ct = __fmaf_rn(frac, __fsub_rn(r_s[high], lo_v), lo_v);
    if (area_mode) {
      const float ind0 = tap_index(i, 0, ha, inv_c1, inv_angle);
      const float ind1 = tap_index(i, c - 1, ha, inv_c1, inv_angle);
      const float span = __fsub_rn(ind1, ind0);
      if (span > (float)c) {
        const float tap_w = __fmul_rn(span, inv_c1);
        const float half_tap = __fmul_rn(0.5f, tap_w);
        const int a_lo = (int)rintf(clampf(__fsub_rn(ind, half_tap), 0.0f,
                                           hi_idx));
        const int a_hi = max((int)rintf(clampf(__fadd_rn(ind, half_tap), 0.0f,
                                               hi_idx)), a_lo);
        const float band = __fsub_rn(cs_s[a_hi + 1], cs_s[a_lo]);
        ct = __fdiv_rn(band, (float)(a_hi - a_lo + 1));
      }
    }
    if (outbound) ct = padding_val;
    ct = clampf(ct, __fsub_rn(dist, window_depth),
                __fadd_rn(dist, window_depth));
    if (centered) ct = __fmul_rn(__fsub_rn(ct, dist), inv_depth);
    out[((size_t)b * p + i) * c + k] = ct;
  }
}

}  // namespace

// dynamic shared memory a launch asks for (bytes)
extern "C" long long cutout_smem_bytes(int p) {
  // ranges, angles, p + 1 prefix sums, and the scan's row totals
  return (3 * (long long)p + 1 + (p + kScanBase - 2) / (kScanBase - 1) + 4) *
         sizeof(float);
}

extern "C" int cutout_launch(const void* scans, void* out, int b, int p,
                             int p_valid, int c, float window_width,
                             float window_depth, float padding_val,
                             float inv_c1, float inv_angle, float inv_depth,
                             int centered, int area_mode, void* stream) {
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
      window_depth, padding_val, inv_c1, inv_angle, inv_depth, centered,
      area_mode);
  return (int)cudaGetLastError();
}
