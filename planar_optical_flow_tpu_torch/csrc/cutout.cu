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
// The per-tap arithmetic (cutout.cuh cutout_tap, shared with K8) follows
// XLA's CPU forms, so the floor/rint decisions and the cutouts of this
// kernel, the plain PyTorch version and the JAX reference agree to the bit
// (but for atanf, which differs from the other two implementations in the
// last bit of a few 1e-5 of beams).

#include "cutout.cuh"

namespace {

__global__ void cutout_kernel(const float* __restrict__ scans,
                              float* __restrict__ out, int p,
                              const CutoutCfg cfg) {
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
    ha_s[i] = half_alpha_of(r, cfg.half_width);
    cs_s[i + 1] = r;
  }
  if (threadIdx.x == 0) cs_s[0] = 0.0f;
  __syncthreads();
  if (cfg.area_mode) scan_xla(cs_s + 1, p, scratch);

  const int c = cfg.c;
  for (int idx = threadIdx.x; idx < p * c; idx += blockDim.x) {
    const int i = idx / c;
    const int k = idx - i * c;
    out[((size_t)b * p + i) * c + k] = cutout_tap(r_s, cs_s, i, k, ha_s[i],
                                                  cfg);
  }
}

}  // namespace

// dynamic shared memory a launch asks for (bytes)
extern "C" long long cutout_smem_bytes(int p) {
  // ranges, angles, p + 1 prefix sums, and the scan's row totals
  return (3 * (long long)p + 1 + scan_scratch_floats(p)) * sizeof(float);
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
  const CutoutCfg cfg = {p_valid, c, 0.5f * window_width, window_depth,
                         padding_val, inv_c1, inv_angle, inv_depth,
                         centered, area_mode};
  cutout_kernel<<<b, 256, smem, (cudaStream_t)stream>>>(
      (const float*)scans, (float*)out, p, cfg);
  return (int)cudaGetLastError();
}
