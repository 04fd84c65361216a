// K1: fused per-beam cutout for Hopper (sm_90a).
//
// Replaces planar_optical_flow_tpu/ops/pallas/cutout_kernel.py cutout_fused
// (math in cutout_block). (B, P) f32 scans -> (B*P, C) f32 cutouts.
//
// Bound on the H100: the bytes it writes, 4*C a beam (39.2 MB at B=384, 456
// beams a stream, C=56: 11.7 us at 3.35 TB/s); the scan is read once.
//
// Design. A block takes kCutoutTile beams of one stream (grid: stream x
// tile; the last tile of a stream may be partial), so the card holds tens of
// blocks an SM and a block's prologue hides under the other blocks' taps.
// 1. The window. A tap of beam i reads ranges and prefix sums within
//    `reach` beams of i (cutout_reach: the widest half-window over the beam
//    step, an area band's half width on top, a margin for rounding), clamped
//    to [0, p_valid - 1]. The block stages the ranges of the window [ws, we)
//    its beams read, ws a multiple of 16, so its shared memory does not grow
//    with P but for the prefix sum's row totals (P / 15 floats; scans of up
//    to 16^4 beams fit).
// 2. The prefix sum (area mode), in scan_xla's order and so to its bits,
//    by the block's first warp: one lane a row of 16 sums the row in order
//    from device memory (L2 after the stream's first tile; the window's
//    rows leave their running sums staged), then the row totals' levels
//    in registers by shuffles (up to 32 rows, 512 beams; above that the
//    block's threads and cutout.cuh's scan_xla). A tap adds a staged
//    running sum and its row's offset as scan_xla's last level adds them
//    (window_prefix).
// 3. Beside it, the other warps stage the window's ranges and compute each
//    beam's geometry once (cutout.cuh beam_geometry: the half-window
//    angle's atanf, the tap spacing, the area flag and band width, the clip
//    bounds), one thread a beam. One barrier, then the taps.
// 4. The taps (cutout.cuh beam_tap): a warp a beam, lane k on taps k and
//    k + 32 together, so the beam's area branch is uniform in the warp and
//    no tap divides by C; every gather is a shared-memory read.
// 5. The store. The tile's outputs are one contiguous span of nv * C floats
//    of device memory; they are staged in shared memory at the span's
//    alignment, the 16-byte-aligned middle leaves by one cp.async.bulk
//    shared -> global copy and the head and tail (where C % 4 != 0) by
//    scalar stores.
//
// The arithmetic (cutout.cuh) follows XLA's CPU forms, so the floor/rint
// decisions and the cutouts of this kernel, the plain PyTorch version and
// the JAX reference agree to the bit (but for atanf, which differs from the
// CPU's in the last bit of a few 1e-5 of beams).

#include "cutout.cuh"

#include <stdint.h>

namespace {

constexpr int kCutoutTile = 128;  // beams a block
constexpr int kCutoutThreads = 256;
constexpr int kCutoutWarps = kCutoutThreads / 32;
constexpr int kScanMaxBeams = 65536;  // 16^4 (kScanLevels)
constexpr int kGeoFloats = (int)(sizeof(BeamGeom) / sizeof(float));

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// floats of the staged outputs: the tile's span, shifted by its alignment
// (up to 3 floats)
__host__ __device__ inline int tile_out_floats(int c) {
  return round4(kCutoutTile * c + 3);
}

// floats of the staged ranges of the window (the prefix sums take 4 more)
__host__ __device__ inline int window_floats(int p, int reach) {
  const int w = kCutoutTile + 2 * reach + 16;
  return round4(p < w ? p : w);
}

// floats of the level-1 row totals and the levels above them
__host__ __device__ inline int totals_floats(int p) {
  const int n1 = (p + kScanBase - 1) / kScanBase;
  return n1 + scan_scratch_floats(n1);
}

__host__ __device__ inline long long cutout_smem(int p, int c, int reach) {
  return (long long)(tile_out_floats(c) + kCutoutTile * kGeoFloats +
                     2 * window_floats(p, reach) + 4 + totals_floats(p)) *
         (long long)sizeof(float);
}

// Beams beyond i that a tap of beam i may read, either side, capped at p:
// the widest half-window (atan(half_width / 0.01) over the beam step), an
// area band's half width on top (span / (c - 1) / 2), and a margin for the
// f32 rounding of the tap index and the rint of the band's ends.
int cutout_reach(int p, int c, float half_width, float inv_angle) {
  const double reach = atan(fabs((double)half_width) / (double)1e-2f) *
                       fabs((double)inv_angle);
  const double r = ceil(reach * (1.0 + 1.0 / (c - 1)) * (1.0 + 1e-5)) + 4.0;
  return r < (double)p ? (int)r : p;
}

// Row `row` of 16 of the scan's first `we` beams summed in order (rows
// before the window are whole), read from device memory (L2 after the
// stream's first tile); a row of the window [ws, we) leaves its running
// sums in cs_w[j - ws]. Returns the row's total.
__device__ __forceinline__ float sum_row(const float* __restrict__ scan,
                                         float* cs_w, int ws, int we,
                                         int row, bool vec) {
  const int j0 = row * kScanBase;
  const int len = min(kScanBase, we - j0);
  float v[kScanBase];
  if (vec && len == kScanBase) {
#pragma unroll
    for (int q = 0; q < kScanBase / 4; ++q) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(scan + j0) + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kScanBase; ++u)
      v[u] = u < len ? __ldg(scan + j0 + u) : 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (int u = 0; u < kScanBase; ++u) {
    if (u < len) acc = __fadd_rn(acc, v[u]);
    v[u] = acc;
  }
  if (j0 >= ws) {
    float* o = cs_w + (j0 - ws);
    if (len == kScanBase) {
#pragma unroll
      for (int q = 0; q < kScanBase / 4; ++q)
        reinterpret_cast<float4*>(o)[q] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    } else {
#pragma unroll
      for (int u = 0; u < kScanBase; ++u)
        if (u < len) o[u] = v[u];
    }
  }
  return acc;
}

// scan_xla of n <= 32 values, lane l holding t[l], by shuffles: lane l's
// result. Up to 16 values: the top level, summed in order; above 16, two
// rows of 16 summed in order, the top level of their two totals, and the
// second row's offset.
__device__ __forceinline__ float scan_xla_lanes(float t, int n) {
  const int lane = threadIdx.x & 31;
  const int r0 = n > kScanBase ? lane & ~(kScanBase - 1) : 0;
  float acc = 0.0f;
#pragma unroll
  for (int u = 0; u < kScanBase; ++u) {
    const float x = __shfl_sync(0xffffffffu, t, r0 + u);
    if (r0 + u <= lane && r0 + u < n) acc = __fadd_rn(acc, x);
  }
  if (n > kScanBase) {
    const float top0 = __fadd_rn(
        0.0f, __shfl_sync(0xffffffffu, acc, kScanBase - 1));
    if (r0 > 0) acc = __fadd_rn(acc, top0);
  }
  return acc;
}

// The sum of the ranges of beams < j (j - 1 in [ws - 1, we)): the running
// sum of beam j - 1 in its row plus the offset of the rows before it, as
// scan_xla adds them (row 0 has none; cs_w[-1] is 0).
__device__ __forceinline__ float window_prefix(const float* cs_w,
                                               const float* tot, int ws,
                                               int j) {
  const int q = j - 1;
  float v = cs_w[q - ws];
  if (q >= kScanBase) v = __fadd_rn(v, tot[q / kScanBase - 1]);
  return v;
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from shared to
// global memory by the copy engine, in a bulk group
__device__ __forceinline__ void bulk_copy_s2g(void* dst, const void* src,
                                              uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"((uint32_t)__cvta_generic_to_shared(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until the bulk groups have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kCutoutThreads)
    cutout_kernel(const float* __restrict__ scans, float* __restrict__ out,
                  int p, int reach, const CutoutCfg cfg) {
  extern __shared__ __align__(16) float smem[];
  const int c = cfg.c;
  const int i0 = blockIdx.y * kCutoutTile;
  const int nv = min(kCutoutTile, p - i0);
  const float* scan = scans + (size_t)blockIdx.x * p;
  // the tile's outputs out[s .. s + nv * c), staged at out_s[h ..]
  const size_t s = ((size_t)blockIdx.x * p + i0) * c;
  const int h = (int)(s & 3);
  float* out_s = smem;
  BeamGeom* geo_s = reinterpret_cast<BeamGeom*>(smem + tile_out_floats(c));
  float* r_w = reinterpret_cast<float*>(geo_s + kCutoutTile);
  float* cs_w = r_w + window_floats(p, reach) + 4;  // cs_w[-1] = 0
  float* tot = cs_w + window_floats(p, reach);
  // the beams the tile's taps read: [ws, we), ws a multiple of 16 below the
  // lowest (cs_w[-1] is read only where ws == 0)
  const int pv1 = cfg.p_valid - 1;
  const int lo = max(0, min(i0 - reach, pv1));
  const int we = min(i0 + nv - 1 + reach, pv1) + 1;
  const int ws = max(lo - 1, 0) & ~(kScanBase - 1);
  const int nw = we - ws;

  // the prefix sums of beams [0, we) in scan_xla's order (area mode): each
  // row of 16 summed in order by one thread (sum_row), then the row
  // totals' levels into tot; a tap reads them through window_prefix
  const int n1 = (we + kScanBase - 1) / kScanBase;
  const bool vec = (reinterpret_cast<uintptr_t>(scan) & 15) == 0;
  if (cfg.area_mode && n1 > 32) {  // over 512 beams: the block's threads
    for (int row = threadIdx.x; row < n1; row += kCutoutThreads)
      tot[row] = sum_row(scan, cs_w, ws, we, row, vec);
    __syncthreads();
    scan_xla(tot, n1, tot + n1);
  }
  if (threadIdx.x < 32) {
    // up to 512 beams: warp 0, one lane a row, the levels by shuffles
    if (threadIdx.x == 0) cs_w[-1] = 0.0f;  // the sum of no beam
    if (cfg.area_mode && n1 <= 32) {
      const int lane = threadIdx.x;
      const float t =
          lane < n1 ? sum_row(scan, cs_w, ws, we, lane, vec) : 0.0f;
      const float l1 = scan_xla_lanes(t, n1);
      if (lane < n1) tot[lane] = l1;
    }
  } else {
    // each beam's geometry once (the last threads), and the window
    for (int bi = kCutoutThreads - 1 - threadIdx.x; bi < nv;
         bi += kCutoutThreads - 32) {
      const float dist = __ldg(scan + i0 + bi);
      geo_s[bi] = beam_geometry(i0 + bi, dist,
                                half_alpha_of(dist, cfg.half_width), cfg);
    }
    for (int j = threadIdx.x - 32; j < nw; j += kCutoutThreads - 32)
      r_w[j] = __ldg(scan + ws + j);
    // the last valid beam once more (beam_tap<true>); r_w[nw] is the pad
    if (threadIdx.x == 32 && we == cfg.p_valid)
      r_w[nw] = __ldg(scan + we - 1);
  }
  __syncthreads();  // the window, its prefix sums and the geometry staged

  const float* r = r_w - ws;  // r[j]: the range of beam j
  const auto cs = [cs_w, tot, ws](int j) {
    return window_prefix(cs_w, tot, ws, j);
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int bi = warp; bi < nv; bi += kCutoutWarps) {
    const BeamGeom g = geo_s[bi];
    float* o = out_s + h + bi * c;
    for (int k = lane; k < c; k += 64) {  // taps k and k + 32 together
      const float v0 = beam_tap<true>(g, (float)k, r, cs, cfg);
      const float v1 =
          beam_tap<true>(g, (float)min(k + 32, c - 1), r, cs, cfg);
      o[k] = v0;
      if (k + 32 < c) o[k + 32] = v1;
    }
  }

  // out_s[q] goes to dst[q]: [qa, qe) the 16-byte-aligned middle, [h, qa)
  // and [qe, h + n) the head and tail it shares with the next tiles' words
  const int n = nv * c;
  const int qa = min(round4(h), h + n);
  const int qe = max((h + n) & ~3, qa);
  float* dst = out + (s - h);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();  // the tile staged, visible to the copy engine
  if (threadIdx.x == 0 && qe > qa)
    bulk_copy_s2g(dst + qa, out_s + qa, (uint32_t)(qe - qa) * 4u);
  const int t = threadIdx.x;
  if (t < qa - h)
    dst[h + t] = out_s[h + t];
  else if (t >= 4 && t - 4 < h + n - qe)
    dst[qe + t - 4] = out_s[qe + t - 4];
  if (threadIdx.x == 0 && qe > qa) bulk_wait_read();
}

// the half-window angle of each range, as K1 computes it (a probe for the
// card's checks: K1's atanf against another implementation's)
__global__ void cutout_half_alpha_kernel(const float* __restrict__ scans,
                                         float* __restrict__ out, long long n,
                                         float half_width) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = half_alpha_of(scans[i], half_width);
}

}  // namespace

// The launch geometry of K1 at p beams a stream and c taps: beams a tile,
// tiles a stream, the reach of a tap (beams) and the dynamic shared memory
// a block asks for (bytes); returns 1 where p exceeds the prefix sum's
// 16^4 beams.
extern "C" int cutout_geometry(int p, int c, float window_width,
                               float inv_angle, int* tile, int* tiles,
                               int* reach, long long* smem) {
  *tile = kCutoutTile;
  *tiles = (p + kCutoutTile - 1) / kCutoutTile;
  *reach = cutout_reach(p, c, 0.5f * window_width, inv_angle);
  *smem = cutout_smem(p, c, *reach);
  return p > kScanMaxBeams ? 1 : 0;
}

extern "C" int cutout_launch(const void* scans, void* out, int b, int p,
                             int p_valid, int c, float window_width,
                             float window_depth, float padding_val,
                             float inv_c1, float inv_angle, float inv_depth,
                             int centered, int area_mode, void* stream) {
  if (b == 0) return (int)cudaSuccess;
  if (p > kScanMaxBeams || c < 2 || p_valid < 1 || p_valid > p)
    return (int)cudaErrorInvalidValue;
  const float half_width = 0.5f * window_width;
  const int reach = cutout_reach(p, c, half_width, inv_angle);
  const size_t smem = (size_t)cutout_smem(p, c, reach);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cutout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const CutoutCfg cfg = {p_valid,     c,      half_width, window_depth,
                         padding_val, inv_c1, inv_angle,  inv_depth,
                         centered,    area_mode};
  const dim3 grid(b, (p + kCutoutTile - 1) / kCutoutTile);
  cutout_kernel<<<grid, kCutoutThreads, smem, (cudaStream_t)stream>>>(
      (const float*)scans, (float*)out, p, reach, cfg);
  return (int)cudaGetLastError();
}

extern "C" int cutout_half_alpha_launch(const void* scans, void* out,
                                        long long n, float window_width,
                                        void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  cutout_half_alpha_kernel<<<(unsigned)((n + threads - 1) / threads),
                             threads, 0, (cudaStream_t)stream>>>(
      (const float*)scans, (float*)out, n, 0.5f * window_width);
  return (int)cudaGetLastError();
}
