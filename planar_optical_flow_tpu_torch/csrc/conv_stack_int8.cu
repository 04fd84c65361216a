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
//       array, zero at the ends of each length-L cutout, read with the
//       tile loader K10 uses and the tap address of every int8 conv.
//
// Design (int8_stack.cuh has the conv, layer 1, the backbone tail and the
// head, shared with serve_cell.cu): a block owns kTile cutouts and keeps
// their activations in shared memory across every layer, as K2/K4 do:
// device memory sees the f32 cutouts (or the int8 template) in and the
// outputs only. The TPU kernels' position-major rows and pack-2 lanes are
// TPU layout devices and are not carried over: the int32 sums are the same
// in any layout.
//
// K10 fills the tile from its int8 input rows instead of computing layer 1,
// and with bf16 feats its last conv writes bf16 values over the free buffer
// (the embed reads them there). K8's block loads its stream's whole scan
// (the taps of a close beam reach ~180 beams away), computes the scan's
// prefix sum in area mode, and the cutouts of its own 8 beams into the f32
// cutout buffer K5 reads: the (N, L) cutout tensor never exists in device
// memory. Its blocks never straddle two streams (the padded scan length is
// a multiple of kTile). K16 is one small launch of the same loader and tap
// addressing on a known pattern.
//
// Bound: tensor-core operations at the int8 peak: about 16.1 M operations
// per cutout for K5/K8/K9 at L=56 (the bf16 embed included), 16.0 M for
// K10, and 28.9 M for K7 at L/4=14, against ~0.4 KB (K5/K9; K8 reads the
// 4-byte range instead of the 224-byte cutout), ~7.2 KB (K10: 3.6 KB of act1
// in, 3.5 KB of int8 or 7 KB of bf16 feats out) and ~3.6 KB (K7) of
// device-memory traffic. Positions are padded to 16 per MMA tile, which
// wastes 12% of the backbone's and up to 56% of K7's last two convs (7
// positions in a 16-row tile). K16 is bound by its launch.

#include "cutout.cuh"
#include "int8_stack.cuh"

namespace {

// K5 (L1 = kFold), K9 (kDivide) and K10 (kRead). Shared memory: two tile
// buffers of kTile * S bytes, then the f32 cutouts (kFold/kDivide). With
// F_OUT the last conv writes bf16 feats (kTile x L/4 x 256) from the start
// of buf1, which is free by then, into the space after it.
template <int L1, bool F_OUT>
__global__ void __launch_bounds__(kThreads)
    backbone_int8_kernel(const void* __restrict__ in,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1, float in_scale,
                         const TailWeights tw, const bf16* __restrict__ we_t,
                         const bf16* __restrict__ be, void* __restrict__ feats,
                         bf16* __restrict__ zx, int n, int L, int S) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* buf0 = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* buf1 = buf0 + (size_t)kTile * S;
  float* cut_s = reinterpret_cast<float*>(buf1 + (size_t)kTile * S);
  const int c0 = blockIdx.x * kTile;
  const int nv = min(kTile, n - c0);

  zero_smem(buf0, kTile * S);
  zero_smem(buf1, kTile * S);
  if (L1 != kRead) {
    const float* cut = static_cast<const float*>(in);
    for (int idx = threadIdx.x; idx < nv * L; idx += kThreads)
      cut_s[idx] = cut[(size_t)c0 * L + idx];
  }
  __syncthreads();

  if (L1 == kRead) {
    load_rows<64>(static_cast<const int8_t*>(in), buf0, c0, nv, L, S);
  } else {
    layer1_tile<L1>(cut_s, w1, b1, in_scale, buf0, nv, L, S);
  }
  __syncthreads();
  backbone_tail<F_OUT, true>(buf0, buf1, tw, we_t, be, feats,
                             zx + (size_t)c0 * 128, c0, nv, L, S);
}

// K8: (B, p) f32 scans (p a multiple of kTile) -> K5's outputs for the B * p
// beams. Shared memory: K5's two tiles and f32 cutouts, then the stream's
// ranges (p), prefix sums (p + 1), the prefix sum's row totals and the
// block's half-window angles (kTile).
__global__ void __launch_bounds__(kThreads)
    backbone_int8_cut_kernel(const float* __restrict__ scans,
                             const CutoutCfg cfg, int p,
                             const float* __restrict__ w1,
                             const float* __restrict__ b1,
                             const TailWeights tw,
                             const bf16* __restrict__ we_t,
                             const bf16* __restrict__ be,
                             int8_t* __restrict__ feats,
                             bf16* __restrict__ zx, int n, int S) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int L = cfg.c;
  int8_t* buf0 = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* buf1 = buf0 + (size_t)kTile * S;
  float* cut_s = reinterpret_cast<float*>(buf1 + (size_t)kTile * S);
  float* r_s = cut_s + kTile * L;
  float* cs_s = r_s + p;  // cs_s[i] = sum of beams < i
  float* scratch = cs_s + p + 1;
  float* ha_s = scratch + scan_scratch_floats(p);
  const int c0 = blockIdx.x * kTile;
  const int nv = min(kTile, n - c0);
  const int beam0 = c0 % p;
  const float* scan = scans + (size_t)(c0 / p) * p;

  zero_smem(buf0, kTile * S);
  zero_smem(buf1, kTile * S);
  for (int i = threadIdx.x; i < p; i += kThreads) {
    const float r = scan[i];
    r_s[i] = r;
    cs_s[i + 1] = r;
  }
  if (threadIdx.x < nv)
    ha_s[threadIdx.x] = half_alpha_of(scan[beam0 + threadIdx.x],
                                      cfg.half_width);
  if (threadIdx.x == 0) cs_s[0] = 0.0f;
  __syncthreads();
  if (cfg.area_mode) scan_xla(cs_s + 1, p, scratch);

  for (int idx = threadIdx.x; idx < nv * L; idx += kThreads) {
    const int c = idx / L;
    cut_s[idx] = cutout_tap(r_s, cs_s, beam0 + c, idx - c * L, ha_s[c], cfg);
  }
  __syncthreads();
  layer1_tile<kFold>(cut_s, w1, b1, 1.0f, buf0, nv, L, S);
  __syncthreads();
  backbone_tail<false, true>(buf0, buf1, tw, we_t, be, feats,
                             zx + (size_t)c0 * 128, c0, nv, L, S);
}

// K16: x (n * L, 128) int8 -> left[r] = x[r - 1], right[r] = x[r + 1]
// within each length-L cutout (zero at its ends), through load_rows and
// TAP_ROW as the convs read their taps.
__global__ void __launch_bounds__(kThreads)
    row_shift_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ left,
                     int8_t* __restrict__ right, int n, int L, int S) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* tile = reinterpret_cast<int8_t*>(smem_raw);
  const int c0 = blockIdx.x * kTile;
  const int nv = min(kTile, n - c0);
  constexpr int LD = ld_of(128);
  zero_smem(tile, kTile * S);
  __syncthreads();
  load_rows<128>(x, tile, c0, nv, L, S);
  __syncthreads();
  for (int idx = threadIdx.x; idx < nv * L * 128; idx += kThreads) {
    const int c = idx / (L * 128);
    const int rem = idx - c * L * 128;
    const int p = rem >> 7, ch = rem & 127;
    const size_t o = ((size_t)(c0 + c) * L + p) * 128 + ch;
    left[o] = TAP_ROW(tile, c, S, LD, 0, 0, p)[ch];
    right[o] = TAP_ROW(tile, c, S, LD, 0, 2, p)[ch];
  }
}

// K7. Shared memory: two tile buffers of kTile * S bytes, then the means.
__global__ void __launch_bounds__(kThreads)
    head_int8_kernel(const int8_t* __restrict__ tmpl, const HeadWeights hw,
                     float* __restrict__ cls, float* __restrict__ reg, int n,
                     int L4, int nc, int S) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* buf0 = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* buf1 = buf0 + (size_t)kTile * S;
  float* means = reinterpret_cast<float*>(buf1 + (size_t)kTile * S);  // T x 128
  const int c0 = blockIdx.x * kTile;
  const int nv = min(kTile, n - c0);

  zero_smem(buf0, kTile * S);
  zero_smem(buf1, kTile * S);
  __syncthreads();
  load_rows<256>(tmpl, buf0, c0, nv, L4, S);
  __syncthreads();
  head_body(buf0, buf1, means, hw, cls, reg, c0, nv, L4, nc, S);
}

// tile stride S and dynamic shared memory of a backbone launch
size_t backbone_int8_smem(int l, int L1, bool f_out, int* S) {
  *S = backbone_stride(l);
  size_t bytes = 2 * (size_t)kTile * *S;
  if (L1 != kRead) bytes += (size_t)kTile * l * sizeof(float);
  if (f_out) {
    const size_t fb_end =
        (size_t)kTile * *S + (size_t)kTile * (l / 4) * 256 * sizeof(bf16);
    bytes = bytes > fb_end ? bytes : fb_end;
  }
  return bytes;
}

// K8: K5's shared memory and the scan's, at p beams a stream
size_t backbone_int8_cut_smem(int l, int p, int* S) {
  return backbone_int8_smem(l, kFold, false, S) +
         ((size_t)2 * p + 1 + scan_scratch_floats(p) + kTile) * sizeof(float);
}

size_t head_int8_smem(int l4, int* S) {
  *S = head_stride(l4);
  return 2 * (size_t)kTile * *S + (size_t)kTile * 128 * sizeof(float);
}

size_t row_shift_smem(int l, int* S) {
  *S = round16((pad16(l) + 2) * ld_of(128));
  return (size_t)kTile * *S;
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
  int S;
  const size_t smem = backbone_int8_smem(l, L1, F_OUT, &S);
  int err = set_smem((const void*)backbone_int8_kernel<L1, F_OUT>, smem);
  if (err) return err;
  const int grid = (n + kTile - 1) / kTile;
  backbone_int8_kernel<L1, F_OUT><<<grid, kThreads, smem, stream>>>(
      in, (const float*)w1, (const float*)b1, in_scale, tw, (const bf16*)we_t,
      (const bf16*)be, feats, (bf16*)zx, n, l, S);
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory a launch at these lengths asks for (bytes); l1_mode
// and bf16_out as for backbone_int8_launch
extern "C" long long backbone_int8_smem_bytes(int l, int l1_mode,
                                              int bf16_out) {
  int S;
  return (long long)backbone_int8_smem(l, l1_mode, bf16_out != 0, &S);
}

extern "C" long long backbone_int8_cut_smem_bytes(int l, int p) {
  int S;
  return (long long)backbone_int8_cut_smem(l, p, &S);
}

extern "C" long long head_int8_smem_bytes(int l4) {
  int S;
  return (long long)head_int8_smem(l4, &S);
}

// K5 (l1_mode 0: f32 cutouts, 1/in_scale folded into (w1, b1)), K9
// (l1_mode 1: f32 cutouts, unscaled (w1, b1), one division by in_scale after
// the leaky) and K10 (l1_mode 2: int8 act1 (n * l, 64); w1, b1 unused).
// tail: the 15 pointers (w, s_eff, b_eff) of layers 2-6. bf16_out (K10
// only): bf16 feats of the dequantized last layer instead of int8 feats.
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
// backbone_int8_launch in l1_mode 0).
extern "C" int backbone_int8_cut_launch(
    const void* scans, int b, int p, int p_valid, int l, float window_width,
    float window_depth, float padding_val, float inv_c1, float inv_angle,
    float inv_depth, int centered, int area_mode, const void* w1,
    const void* b1, const void* const* tail, const void* we_t, const void* be,
    void* feats, void* zx, void* stream) {
  const int n = b * p;
  if (n == 0) return (int)cudaSuccess;
  if (p % kTile) return (int)cudaErrorInvalidValue;
  int S;
  const size_t smem = backbone_int8_cut_smem(l, p, &S);
  int err = set_smem((const void*)backbone_int8_cut_kernel, smem);
  if (err) return err;
  const CutoutCfg cfg = {p_valid, l, 0.5f * window_width, window_depth,
                         padding_val, inv_c1, inv_angle, inv_depth,
                         centered, area_mode};
  backbone_int8_cut_kernel<<<n / kTile, kThreads, smem,
                             (cudaStream_t)stream>>>(
      (const float*)scans, cfg, p, (const float*)w1, (const float*)b1,
      tail_weights(tail), (const bf16*)we_t, (const bf16*)be, (int8_t*)feats,
      (bf16*)zx, n, S);
  return (int)cudaGetLastError();
}

// K16: x (rows, 128) int8, rows a multiple of l
extern "C" int row_shift_launch(const void* x, void* left, void* right,
                                int rows, int l, void* stream) {
  const int n = rows / l;
  if (n == 0) return (int)cudaSuccess;
  int S;
  const size_t smem = row_shift_smem(l, &S);
  int err = set_smem((const void*)row_shift_kernel, smem);
  if (err) return err;
  const int grid = (n + kTile - 1) / kTile;
  row_shift_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)x, (int8_t*)left, (int8_t*)right, n, l, S);
  return (int)cudaGetLastError();
}

// K7: head: the 15 pointers (w, s_eff, b_eff) of the five head convs
extern "C" int head_int8_launch(const void* tmpl, const void* const* head,
                                const void* wc, const void* bc, const void* wr,
                                const void* br, void* cls, void* reg, int n,
                                int l4, int nc, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  int S;
  const size_t smem = head_int8_smem(l4, &S);
  int err = set_smem((const void*)head_int8_kernel, smem);
  if (err) return err;
  const int grid = (n + kTile - 1) / kTile;
  head_int8_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)tmpl, head_weights(head, wc, bc, wr, br), (float*)cls,
      (float*)reg, n, l4, nc, S);
  return (int)cudaGetLastError();
}
