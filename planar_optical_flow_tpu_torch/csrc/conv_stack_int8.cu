// The int8 conv stacks for Hopper (sm_90a): K5, K8, K9 and K10 (int8
// backbone + gate embed), K7 (int8 detection head) and K16 (the tap-row
// check).
//
// Each replaces a kernel of planar_optical_flow_tpu/ops/pallas/conv_stack.py:
//   K5  fused_backbone_int8_p2 (l1_mode="mm", int8 output, with
//       embed_weights; body _layer1_p2_mm, _run_plan_int8_p2,
//       _run_plan_int8_pm, _embed_acc_pm);
//   K8  fused_backbone_int8_p2cut (_backbone_int8_p2cut_kernel: the cutout
//       block, cutout_kernel.cutout_block, feeding K5's body);
//   K9  fused_backbone_int8_pm with layer1_weights (_layer1_pm), and
//       fused_backbone_int8_p2 with l1_mode="repack"/"blend" (_layer1_p2),
//       which JAX makes bit-identical to it;
//   K10 fused_backbone_int8 (_backbone_int8_kernel, _run_plan_int8,
//       _conv_int8_cat / _conv_int8, _embed_epilogue);
//   K7  fused_head_int8_pm (_head_int8_pm_kernel, _HEAD_PLAN,
//       _head_cls_reg); K10's head, fused_head_int8, computes the same
//       function and runs on this kernel;
//   K16 check_byte_shift (_shift_rows_int8).
//
// What they compute, per cutout:
//   K5: layer 1 from the f32 cutout (3 taps in f32 with 1/in_scale folded
//       into the weights, leaky, rint, clip to +-127), then backbone layers
//       2-6 (conv, conv, pool/2, conv, conv, conv, pool/2) as int8 x int8 ->
//       int32 convs with the f32 epilogue
//         q = clip(rint(leaky(f32(acc) * s_eff + b_eff)), -127, 127),
//       int8 feats (L/4 positions x 256) at the last layer's scale, and
//       zx = bf16(feats @ (W * feat_scale) + b) on bf16 operands with f32
//       accumulation.
//   K8: K1's cutouts of the block's beams (cutout.cuh, the same arithmetic
//       as K1), then K5: bit-identical to K1 followed by K5.
//   K9: K5 with the other layer-1 rounding: the unscaled taps, leaky, then
//       one true division by in_scale, rint, clip.
//   K10: layers 2-6 and the embed on the int8 layer-1 activation read from
//       device memory ((N*L, 64), made by plain torch with K9's layer-1
//       rounding). Either int8 feats as K5/K9, or (the int8-conv, bf16-
//       carry configuration) the last layer dequantized: feats are the
//       bf16 of its f32 post-leaky value and zx = bf16(bf16(feats) @ W + b)
//       with the unscaled W.
//   K7: head convs (conv, conv, conv, pool/2, conv, conv) on the int8
//       template; the last conv is dequantized (no requant); the f32 mean
//       over positions (a sequential sum, then one division); cls and reg
//       from bf16(mean) and bf16 weights with f32 accumulation.
//   K16: left[r] = x[r - 1] and right[r] = x[r + 1] of an int8 (rows, 128)
//       array, zero at the ends of each length-L cutout, read through the
//       packed tile's loader and the tap addresses the int8 convs use.
//
// Design. Every kernel keeps a block's cutouts in shared memory across all
// its layers: device memory sees the f32 cutouts (or the int8 template) in
// and the outputs only. The TPU kernels' position-major rows and pack-2
// lanes are TPU layout devices and are not carried over: the int32 sums are
// the same in any layout.
//
// K5/K8/K9/K10 and K7 run on wgmma_conv.cuh: 16 cutouts a block in the
// packed tile (cutouts back to back, one or two zero rows between them),
// wgmma m64nNk32 s8 products (N = 64-256) with both operands in shared
// memory, the weights staged by cp.async into a 4 x 16 KB ring two chunks
// ahead of use (the host lays them out in the descriptor's core-matrix
// order, int8_tiles.wgmma_weights), two warp groups, 256 threads and one
// block per SM. They work against the int8 tensor-core rate: one
// instruction covers 64 rows x up to 256 channels, each weight byte crosses
// L2 once per 16 cutouts, off the critical path, and the 7-position head
// stage fills 7 of 8 rows. The per-stage split (PERF.md) shows what is
// left: the epilogues, which both warp groups run at once while the tensor
// cores idle, and a barrier every chunk.

// The gate embed of K5/K8/K9/K10 is a second kernel, embed_kernel
// (embed.cuh, shared with K2), launched by the same entry over all N
// cutouts on the feats the first one wrote: 128 cutouts a block, We^T
// staged in shared memory by cp.async, bf16 mma.sync.m16n8k16 with the
// contraction in K-order, so that each zx is the same chain of products and
// f32 sums as the embed of K13 (serve_cell_wg.cu, on embed.cuh's
// embed_frag_a): K13 stays equal to the bit to K9 -> K6 -> K7.
//
// K10 fills the tile from its int8 input rows instead of computing layer 1;
// with bf16 feats its last conv writes the bf16 rows straight to device
// memory. K8 is K5's block with K1's cutout block in front: a block takes
// 16 beams of one stream (grid: stream x tile), loads its stream's whole
// scan (the taps of a close beam reach ~180 beams away), computes the
// scan's prefix sum in area mode, and the cutouts of its own beams into the
// f32 cutout buffer its layer 1 reads: the (N, L) cutout tensor never
// exists in device memory, and K8's outputs are K1 -> K5's bits. K16 is
// one small launch of the packed tile's loader and tap addresses on a
// known pattern.
//
// Bound on this card (NVIDIA H100, 1,979 TOP/s int8, 989 TFLOP/s bf16):
// tensor-core operations: about 15.1 M int8 operations per cutout for the
// backbone convs at L=56 and 0.9 M bf16 for the embed, 28.9 M int8 for K7 at
// L/4=14, against ~0.4 KB (K5/K9; K8 reads the 4-byte range instead of the
// 224-byte cutout), ~7.2 KB (K10: 3.6 KB of act1 in, 3.5 KB of int8 or 7 KB
// of bf16 feats out) and ~3.6 KB (K7) of device-memory traffic per cutout.
// K16 is bound by its launch.

#include "cutout.cuh"
#include "embed.cuh"
#include "int8_wg.cuh"

namespace {

// a backbone block's tile region (each of two): the packed tiles of its
// stages and its int8 feats rows
size_t backbone_region(int l, int T) {
  const size_t r = backbone_tiles(l, T), f = (size_t)T * (l / 4) * 256;
  return round128(r > f ? r : f);
}

size_t backbone_smem(int l, int L1, int T) {
  return kRingBytes + 2 * backbone_region(l, T) +
         (L1 != kRead ? (size_t)T * l * sizeof(float) : 0);
}

// a head block's tile region (each of two): the packed tiles of its stages
// and the last conv's f32 rows
size_t head_region(int l4, int T) { return round128(head_tiles(l4, T)); }

size_t head_smem(int l4, int T) {
  return kRingBytes + 2 * head_region(l4, T) +
         (size_t)T * 128 * sizeof(float);
}

// cutouts a block: the most (kWgTile, halved) whose shared memory fits
int backbone_tile(int l, int L1) {
  int T = kWgTile;
  while (T > 1 && backbone_smem(l, L1, T) > kSmemMax) T /= 2;
  return T;
}

int head_tile(int l4) {
  int T = kWgTile;
  while (T > 1 && head_smem(l4, T) > kSmemMax) T /= 2;
  return T;
}

// K5 (L1 = kFold), K9 (kDivide) and K10 (kRead): layer 1 (or the int8 act1
// rows) and the five tail convs on wgmma_conv.cuh; feats out (int8 rows
// through shared memory, or with F_OUT the bf16 rows straight out). The gate
// embed is embed_kernel's. Shared memory: the ring, two tile regions of R
// bytes, the f32 cutouts (kFold/kDivide).
template <int L1, bool F_OUT>
__global__ void __launch_bounds__(kWgThreads, 1)
    backbone_int8_kernel(const void* __restrict__ in,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1, float in_scale,
                         const __grid_constant__ TailWeights tw,
                         void* __restrict__ feats, int n, int L, int T,
                         int R) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sb = reinterpret_cast<float*>(smem_raw + kStages * kStageBytes);
  int8_t* bufa = reinterpret_cast<int8_t*>(smem_raw + kRingBytes);
  int8_t* bufb = bufa + R;
  float* cut_s = reinterpret_cast<float*>(bufb + R);
  const int c0 = blockIdx.x * T;
  const int nv = min(T, n - c0);
  const int L4 = L / 4;
  // the weight chunks of the five convs, in the order they are used
  auto sched = [&](int j, const int8_t*& src, int& bytes) {
    return backbone_chunk(j, tw, L, T, src, bytes);
  };

  Ring ring = ring_start(smem_raw, sched);
  zero_smem(bufa, R);
  zero_smem(bufb, R);
  if (L1 != kRead) {
    const float* cut = static_cast<const float*>(in);
    for (int idx = threadIdx.x; idx < nv * L; idx += kWgThreads)
      cut_s[idx] = cut[(size_t)c0 * L + idx];
  }
  __syncthreads();
  if (L1 == kRead) {
    load_packed<64>(static_cast<const int8_t*>(in), bufa, c0, nv, L, T);
  } else {
    layer1_packed<L1>(cut_s, w1, b1, in_scale, bufa, nv, L, T);
  }
  __syncthreads();
  backbone_convs<F_OUT ? kWgPoolBf16 : kWgPoolRows>(
      bufa, bufb, R, feats, L, T, nv, c0, ring, sched, sb, tw);
  if (!F_OUT) {
    __syncthreads();
    // the block's feats rows, contiguous in device memory as in bufb
    uint4* dst = reinterpret_cast<uint4*>(static_cast<int8_t*>(feats) +
                                          (size_t)c0 * L4 * 256);
    for (int idx = threadIdx.x; idx < nv * L4 * 16; idx += kWgThreads)
      dst[idx] = reinterpret_cast<const uint4*>(bufb)[idx];
  }
  cp_async_wait<0>();  // the zero copies past the last chunk
}

// K8 (K5 with K1's cutouts in front): the cutouts of T beams of one
// stream, i0 .. i0 + T - 1 (grid: stream x tile; the last tile of a stream
// may be partial), then K5's layer 1 and five tail convs. The block loads
// its stream's scan (p floats: the taps of a close beam reach far), takes
// its prefix sum in area mode (cutout.cuh scan_xla), and computes its
// beams' taps with K1's arithmetic (cutout_tap) into the f32 cutouts that
// layer 1 reads. Shared memory: the ring, two tile regions of R bytes, the
// f32 cutouts (T x L), then the stream's ranges (p), prefix sums (p + 1),
// the prefix sum's row totals and the block's half-window angles (T).
__global__ void __launch_bounds__(kWgThreads, 1)
    backbone_int8_cut_kernel(const float* __restrict__ scans,
                             const CutoutCfg cfg, int p,
                             const float* __restrict__ w1,
                             const float* __restrict__ b1,
                             const __grid_constant__ TailWeights tw,
                             int8_t* __restrict__ feats, int T, int R) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int L = cfg.c, L4 = L / 4;
  float* sb = reinterpret_cast<float*>(smem_raw + kStages * kStageBytes);
  int8_t* bufa = reinterpret_cast<int8_t*>(smem_raw + kRingBytes);
  int8_t* bufb = bufa + R;
  float* cut_s = reinterpret_cast<float*>(bufb + R);
  float* r_s = cut_s + T * L;
  float* cs_s = r_s + p;  // cs_s[i] = sum of beams < i
  float* scratch = cs_s + p + 1;
  float* ha_s = scratch + scan_scratch_floats(p);
  const int i0 = blockIdx.y * T;
  const int nv = min(T, p - i0);
  const float* scan = scans + (size_t)blockIdx.x * p;
  const int c0 = blockIdx.x * p + i0;  // the block's first row
  // the weight chunks of the five convs, in the order they are used
  auto sched = [&](int j, const int8_t*& src, int& bytes) {
    return backbone_chunk(j, tw, L, T, src, bytes);
  };

  Ring ring = ring_start(smem_raw, sched);
  zero_smem(bufa, R);
  zero_smem(bufb, R);
  for (int i = threadIdx.x; i < p; i += kWgThreads) {
    const float r = scan[i];
    r_s[i] = r;
    cs_s[i + 1] = r;
  }
  if (threadIdx.x < nv)
    ha_s[threadIdx.x] = half_alpha_of(scan[i0 + threadIdx.x],
                                      cfg.half_width);
  if (threadIdx.x == 0) cs_s[0] = 0.0f;
  __syncthreads();
  if (cfg.area_mode) scan_xla(cs_s + 1, p, scratch);
  for (int idx = threadIdx.x; idx < nv * L; idx += kWgThreads) {
    const int c = idx / L;
    cut_s[idx] = cutout_tap(r_s, cs_s, i0 + c, idx - c * L, ha_s[c], cfg);
  }
  __syncthreads();
  layer1_packed<kFold>(cut_s, w1, b1, 1.0f, bufa, nv, L, T);
  __syncthreads();
  backbone_convs<kWgPoolRows>(bufa, bufb, R, nullptr, L, T, nv, c0, ring,
                              sched, sb, tw);
  __syncthreads();
  // the block's feats rows, contiguous in device memory as in bufb
  uint4* dst = reinterpret_cast<uint4*>(feats + (size_t)c0 * L4 * 256);
  for (int idx = threadIdx.x; idx < nv * L4 * 16; idx += kWgThreads)
    dst[idx] = reinterpret_cast<const uint4*>(bufb)[idx];
  cp_async_wait<0>();  // the zero copies past the last chunk
}

// K16: x (n * L, 128) int8 -> left[r] = x[r - 1], right[r] = x[r + 1]
// within each length-L cutout (zero at its ends), read through the packed
// tile's loader and tap addresses (load_packed, packed_at), which every
// int8 conv (K5, K7-K10, K12, K13) reads its taps through: blocks of
// kWgTile cutouts.
__global__ void __launch_bounds__(kWgThreads)
    row_shift_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ left,
                     int8_t* __restrict__ right, int n, int L) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* ptile = reinterpret_cast<int8_t*>(smem_raw);
  const int c0 = blockIdx.x * kWgTile;
  const int nv = min(kWgTile, n - c0);
  const int PS = pstride(L), rows = prows(L, kWgTile);
  zero_smem(ptile, ptile_bytes(L, 128, kWgTile));
  __syncthreads();
  load_packed<128>(x, ptile, c0, nv, L, kWgTile);
  __syncthreads();
  for (int idx = threadIdx.x; idx < nv * L * 128; idx += kWgThreads) {
    const int c = idx / (L * 128);
    const int rem = idx - c * L * 128;
    const int p = rem >> 7, ch = rem & 127;
    const size_t o = ((size_t)(c0 + c) * L + p) * 128 + ch;
    left[o] = *packed_at(ptile, rows, c * PS + p, ch);
    right[o] = *packed_at(ptile, rows, c * PS + p + 2, ch);
  }
}

// K7: the head on wgmma_conv.cuh: five convs, the f32 mean over positions,
// cls and reg. Shared memory: the ring, two tile regions of R bytes, the
// means (T x 128 f32).
__global__ void __launch_bounds__(kWgThreads, 1)
    head_int8_kernel(const int8_t* __restrict__ tmpl,
                     const __grid_constant__ HeadWeights hw,
                     float* __restrict__ cls, float* __restrict__ reg, int n,
                     int L4, int nc, int T, int R) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sb = reinterpret_cast<float*>(smem_raw + kStages * kStageBytes);
  int8_t* bufa = reinterpret_cast<int8_t*>(smem_raw + kRingBytes);
  int8_t* bufb = bufa + R;
  float* means = reinterpret_cast<float*>(bufb + R);
  const int c0 = blockIdx.x * T;
  const int nv = min(T, n - c0);
  // the weight chunks of the five convs, in the order they are used
  auto sched = [&](int j, const int8_t*& src, int& bytes) {
    return head_chunk(j, hw, L4, T, src, bytes);
  };

  Ring ring = ring_start(smem_raw, sched);
  zero_smem(bufa, R);
  zero_smem(bufb, R);
  __syncthreads();
  load_packed<256>(tmpl, bufa, c0, nv, L4, T);
  __syncthreads();
  head_convs(bufa, bufb, R, means, L4, T, nv, c0, ring, sched, sb, hw, cls,
             reg, nc);
  cp_async_wait<0>();  // the zero copies past the last chunk
}

// K8: K5's shared memory at T cutouts a block, and the scan's at p beams
// a stream
size_t cut_smem(int l, int p, int T) {
  return backbone_smem(l, kFold, T) +
         ((size_t)2 * p + 1 + scan_scratch_floats(p) + T) * sizeof(float);
}

// cutouts a K8 block: the most (kWgTile, halved) whose shared memory fits
int cut_tile(int l, int p) {
  int T = kWgTile;
  while (T > 1 && cut_smem(l, p, T) > kSmemMax) T /= 2;
  return T;
}

TailWeights tail_weights(const void* const* p) {
  TailWeights tw;
  fill_convs(tw, p);
  return tw;
}

template <int L1, bool F_OUT>
int launch_backbone(const void* in, const void* w1, const void* b1,
                    float in_scale, const TailWeights& tw, const void* we_t,
                    const void* be, void* feats, void* zx, int n, int l,
                    cudaStream_t stream) {
  const int T = backbone_tile(l, L1);
  const size_t smem = backbone_smem(l, L1, T);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)backbone_int8_kernel<L1, F_OUT>, smem);
  if (err) return err;
  backbone_int8_kernel<L1, F_OUT><<<(n + T - 1) / T, kWgThreads, smem,
                                    stream>>>(
      in, (const float*)w1, (const float*)b1, in_scale, tw, feats, n, l, T,
      (int)backbone_region(l, T));
  err = (int)cudaGetLastError();
  if (err) return err;
  return F_OUT ? launch_embed<bf16>(feats, we_t, be, zx, n, l / 4 * 256,
                                    stream)
               : launch_embed<int8_t>(feats, we_t, be, zx, n, l / 4 * 256,
                                      stream);
}

}  // namespace

// The launch geometry of K5/K9/K10 (which: 0, l1_mode as for
// backbone_int8_launch) or K7 (which: 1, l = l4): cutouts a block, rows a
// cutout in the packed tile and dynamic shared memory (bytes);
// int8_tiles.backbone_geometry / head_geometry mirror it.
extern "C" int int8_wg_geometry(int which, int l, int l1_mode, int* tile,
                                int* rows, long long* smem) {
  if (which == 0) {
    *tile = backbone_tile(l, l1_mode);
    *rows = pstride(l);
    *smem = (long long)backbone_smem(l, l1_mode, *tile);
  } else {
    *tile = head_tile(l);
    *rows = pstride(l);
    *smem = (long long)head_smem(l, *tile);
  }
  return 0;
}

// The chunking of layer `layer` (0-4) of the backbone tail (which: 0) or
// the head (which: 1): output channels a pass and K bytes a chunk, which
// int8_tiles.wgmma_weights lays out
extern "C" int int8_wg_plan(int which, int layer, int* ns, int* kc) {
  return int8_plan_of(which, layer, ns, kc);
}

// dynamic shared memory a launch at these lengths asks for (bytes); l1_mode
// and bf16_out as for backbone_int8_launch
extern "C" long long backbone_int8_smem_bytes(int l, int l1_mode,
                                              int bf16_out) {
  (void)bf16_out;  // bf16 feats go straight to device memory
  return (long long)backbone_smem(l, l1_mode, backbone_tile(l, l1_mode));
}

extern "C" long long backbone_int8_cut_smem_bytes(int l, int p) {
  return (long long)cut_smem(l, p, cut_tile(l, p));
}

// The launch geometry of K8 at cutout length l and p beams a stream:
// cutouts a block, rows a cutout in the packed tile and dynamic shared
// memory (bytes); int8_tiles.cut_geometry mirrors it
extern "C" int backbone_int8_cut_geometry(int l, int p, int* tile, int* rows,
                                          long long* smem) {
  *tile = cut_tile(l, p);
  *rows = pstride(l);
  *smem = (long long)cut_smem(l, p, *tile);
  return 0;
}

extern "C" long long head_int8_smem_bytes(int l4) {
  return (long long)head_smem(l4, head_tile(l4));
}

// K5 (l1_mode 0: f32 cutouts, 1/in_scale folded into (w1, b1)), K9
// (l1_mode 1: f32 cutouts, unscaled (w1, b1), one division by in_scale after
// the leaky) and K10 (l1_mode 2: int8 act1 (n * l, 64); w1, b1 unused).
// tail: the 15 pointers (w, s_eff, b_eff) of layers 2-6, each w laid out by
// int8_tiles.wgmma_weights. bf16_out (K10 only): bf16 feats of the
// dequantized last layer instead of int8 feats. Two launches: the backbone,
// then the gate embed on its feats.
extern "C" int backbone_int8_launch(const void* in, const void* w1,
                                    const void* b1, float in_scale,
                                    const void* const* tail, const void* we_t,
                                    const void* be, void* feats, void* zx,
                                    int n, int l, int l1_mode, int bf16_out,
                                    void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const TailWeights tw = tail_weights(tail);
  cudaStream_t st = (cudaStream_t)stream;
  if (l1_mode == kFold && !bf16_out)
    return launch_backbone<kFold, false>(in, w1, b1, 1.0f, tw, we_t, be,
                                         feats, zx, n, l, st);
  if (l1_mode == kDivide && !bf16_out)
    return launch_backbone<kDivide, false>(in, w1, b1, in_scale, tw, we_t,
                                           be, feats, zx, n, l, st);
  if (l1_mode == kRead)
    return bf16_out ? launch_backbone<kRead, true>(in, nullptr, nullptr, 1.0f,
                                                   tw, we_t, be, feats, zx, n,
                                                   l, st)
                    : launch_backbone<kRead, false>(in, nullptr, nullptr,
                                                    1.0f, tw, we_t, be, feats,
                                                    zx, n, l, st);
  return (int)cudaErrorInvalidValue;
}

// K8: scans (b, p) f32 with p a multiple of 8 -> feats (b * p * l/4, 256)
// int8 and zx (b * p, 128) bf16, as K1 (the cutout arguments as for
// cutout_launch, with c = l) followed by K5 (w1, b1, tail, we_t, be as for
// backbone_int8_launch in l1_mode 0, each w of tail laid out by
// int8_tiles.wgmma_weights). Two launches: the cutouts and the backbone,
// then K5's gate embed on its feats.
extern "C" int backbone_int8_cut_launch(
    const void* scans, int b, int p, int p_valid, int l, float window_width,
    float window_depth, float padding_val, float inv_c1, float inv_angle,
    float inv_depth, int centered, int area_mode, const void* w1,
    const void* b1, const void* const* tail, const void* we_t, const void* be,
    void* feats, void* zx, void* stream) {
  const int n = b * p;
  if (n == 0) return (int)cudaSuccess;
  if (p % 8) return (int)cudaErrorInvalidValue;
  const int T = cut_tile(l, p);
  const size_t smem = cut_smem(l, p, T);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)backbone_int8_cut_kernel, smem);
  if (err) return err;
  const CutoutCfg cfg = {p_valid, l, 0.5f * window_width, window_depth,
                         padding_val, inv_c1, inv_angle, inv_depth,
                         centered, area_mode};
  cudaStream_t st = (cudaStream_t)stream;
  backbone_int8_cut_kernel<<<dim3(b, (p + T - 1) / T), kWgThreads, smem,
                             st>>>(
      (const float*)scans, cfg, p, (const float*)w1, (const float*)b1,
      tail_weights(tail), (int8_t*)feats, T, (int)backbone_region(l, T));
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_embed<int8_t>(feats, we_t, be, zx, n, l / 4 * 256, st);
}

// K16: x (rows, 128) int8, rows a multiple of l
extern "C" int row_shift_launch(const void* x, void* left, void* right,
                                int rows, int l, void* stream) {
  const int n = rows / l;
  if (n == 0) return (int)cudaSuccess;
  const size_t smem = ptile_bytes(l, 128, kWgTile);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)row_shift_kernel, smem);
  if (err) return err;
  const int grid = (n + kWgTile - 1) / kWgTile;
  row_shift_kernel<<<grid, kWgThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)x, (int8_t*)left, (int8_t*)right, n, l);
  return (int)cudaGetLastError();
}

// K7: head: the 15 pointers (w, s_eff, b_eff) of the five head convs, each w
// laid out by int8_tiles.wgmma_weights
extern "C" int head_int8_launch(const void* tmpl, const void* const* head,
                                const void* wc, const void* bc, const void* wr,
                                const void* br, void* cls, void* reg, int n,
                                int l4, int nc, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const int T = head_tile(l4);
  const size_t smem = head_smem(l4, T);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)head_int8_kernel, smem);
  if (err) return err;
  head_int8_kernel<<<(n + T - 1) / T, kWgThreads, smem,
                     (cudaStream_t)stream>>>(
      (const int8_t*)tmpl, head_weights(head, wc, bc, wr, br), (float*)cls,
      (float*)reg, n, l4, nc, T, (int)head_region(l4, T));
  return (int)cudaGetLastError();
}
