// The int8 wgmma stacks' device code, shared by K5/K8/K9/K10 and K7
// (conv_stack_int8.cu), K12 (serve_cell.cu) and K13 (serve_cell_wg.cu),
// the last two through gate_head_wg.cuh: the conv plans, the
// backbone's layer 1 into the packed tile, the chunk schedules of the
// backbone tail and the head, and the two stacks' conv sequences. The
// convs themselves are wgmma_conv.cuh's, the gate embed's A fragment
// embed.cuh's.

#pragma once

#include "embed.cuh"
#include "wgmma_conv.cuh"

namespace {

// the plans of the wgmma convs, (Cin, Cout, row tiles, n64 tiles) a warp
// group; int8_tiles.BACKBONE_PLAN and HEAD_PLAN mirror them
using BbPlan0 = ConvPlan<64, 64, 4, 1>;
using BbPlan1 = ConvPlan<64, 128, 2, 2>;
using BbPlan2 = ConvPlan<128, 128, 2, 2>;  // layers 4 and 5
using BbPlan4 = ConvPlan<128, 256, 2, 2>;
using HdPlan0 = ConvPlan<256, 256, 2, 2>;  // head convs 1 and 2
using HdPlan2 = ConvPlan<256, 512, 2, 2>;
using HdPlan3 = ConvPlan<512, 256, 1, 4>;
using HdPlan4 = ConvPlan<256, 128, 1, 2>;

// the chunking of layer `layer` (0-4) of the backbone tail (which: 0) or
// the head (which: 1): output channels a pass and K bytes a chunk
inline int int8_plan_of(int which, int layer, int* ns, int* kc) {
  static const int plan[2][5][2] = {
      {{BbPlan0::NS, BbPlan0::KC}, {BbPlan1::NS, BbPlan1::KC},
       {BbPlan2::NS, BbPlan2::KC}, {BbPlan2::NS, BbPlan2::KC},
       {BbPlan4::NS, BbPlan4::KC}},
      {{HdPlan0::NS, HdPlan0::KC}, {HdPlan0::NS, HdPlan0::KC},
       {HdPlan2::NS, HdPlan2::KC}, {HdPlan3::NS, HdPlan3::KC},
       {HdPlan4::NS, HdPlan4::KC}}};
  if (which < 0 || which > 1 || layer < 0 || layer > 4)
    return (int)cudaErrorInvalidValue;
  *ns = plan[which][layer][0];
  *kc = plan[which][layer][1];
  return 0;
}

// the largest packed tile of a backbone block's stages (bytes)
inline size_t backbone_tiles(int l, int T) {
  return imax(ptile_bytes(l, 64, T), ptile_bytes(l / 2, 128, T));
}

// the largest packed tile of a head block's stages, or its last conv's
// f32 rows (bytes)
inline size_t head_tiles(int l4, int T) {
  const size_t r = imax(ptile_bytes(l4, 256, T), ptile_bytes(l4 / 2, 512, T));
  const size_t f = (size_t)T * (l4 / 2) * 128 * sizeof(float);
  return r > f ? r : f;
}

// Backbone layer 1 from the block's f32 cutouts (nv x L in cut_s) into the
// zeroed packed tile: ((xl * w0 + x * w1) + xr * w2) + b, each f32 step
// rounded once, leaky (kDivide: then one division by in_scale), rint, clip
// (K5's and K8's weights have 1/in_scale folded in, kFold); each
// consumer thread keeps the weights of 4 channels in registers and writes
// them as one 4-byte store, 16 positions at a time.
template <int L1>
__device__ __forceinline__ void layer1_packed(const float* cut_s,
                                              const float* __restrict__ w1,
                                              const float* __restrict__ b1,
                                              float in_scale, int8_t* tile,
                                              int nv, int L, int T) {
  const int ch = 4 * (threadIdx.x & 15);
  const int S = pstride(L), rows = prows(L, T);
  float w[3][4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int t = 0; t < 3; ++t) w[t][j] = w1[64 * t + ch + j];
    b[j] = b1[ch + j];
  }
  for (int r = threadIdx.x >> 4; r < nv * L; r += kWgThreads / 16) {
    const int c = r / L, p = r - c * L;
    const float x = cut_s[r];
    const float xl = p > 0 ? cut_s[r - 1] : 0.0f;
    const float xr = p < L - 1 ? cut_s[r + 1] : 0.0f;
    char q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(xl, w[0][j]), __fmul_rn(x, w[1][j])),
                    __fmul_rn(xr, w[2][j])),
          b[j]);
      const float y =
          L1 == kDivide ? __fdiv_rn(leaky(a), in_scale) : leaky(a);
      q[j] = (char)requant(y);
    }
    *reinterpret_cast<char4*>(packed_at(tile, rows, c * S + 1 + p, ch)) =
        make_char4(q[0], q[1], q[2], q[3]);
  }
}

// Chunk j of the backbone tail's stream (its five convs in the order they
// run, for a block of T cutouts of length L), if j is within it; otherwise
// j drops past it.
__device__ __forceinline__ bool backbone_chunk(int& j, const TailWeights& tw,
                                               int L, int T,
                                               const int8_t*& src,
                                               int& bytes) {
  const int L2 = L / 2;
  return chunk_of<BbPlan0>(j, tw.w[0], L, T, src, bytes) ||
         chunk_of<BbPlan1>(j, tw.w[1], L, T, src, bytes) ||
         chunk_of<BbPlan2>(j, tw.w[2], L2, T, src, bytes) ||
         chunk_of<BbPlan2>(j, tw.w[3], L2, T, src, bytes) ||
         chunk_of<BbPlan4>(j, tw.w[4], L2, T, src, bytes);
}

// the same for the head's five convs at L4 positions
__device__ __forceinline__ bool head_chunk(int& j, const HeadWeights& hw,
                                           int L4, int T, const int8_t*& src,
                                           int& bytes) {
  const int L8 = L4 / 2;
  return chunk_of<HdPlan0>(j, hw.w[0], L4, T, src, bytes) ||
         chunk_of<HdPlan0>(j, hw.w[1], L4, T, src, bytes) ||
         chunk_of<HdPlan2>(j, hw.w[2], L4, T, src, bytes) ||
         chunk_of<HdPlan3>(j, hw.w[3], L8, T, src, bytes) ||
         chunk_of<HdPlan4>(j, hw.w[4], L8, T, src, bytes);
}

// Backbone layers 2-6 on the layer-1 tile in bufa (bufb zeroed; both R
// bytes; the caller synchronises after filling bufa): the last conv pools
// into `feats` as EPI5 says (kWgPoolRows: int8 rows in bufb; kWgPoolCell:
// int8 rows in bufb at the cell's pitch; kWgPoolBf16: bf16 rows into device
// memory from cutout c0 on). bufa and bufb are clobbered.
template <int EPI5, class Sched>
__device__ __forceinline__ void backbone_convs(int8_t* bufa, int8_t* bufb,
                                               int R, void* feats, int L,
                                               int T, int nv, int c0,
                                               Ring& ring, const Sched& sched,
                                               float* sb,
                                               const TailWeights& tw) {
  const int L2 = L / 2;
  conv_wg<64, 64, 4, 1, kWgStore>(bufa, bufb, L, T, nv, c0, ring, sched, sb,
                                  tw.s[0], tw.b[0]);
  __syncthreads();
  zero_smem(bufa, R);
  __syncthreads();
  conv_wg<64, 128, 2, 2, kWgPool>(bufb, bufa, L, T, nv, c0, ring, sched, sb,
                                  tw.s[1], tw.b[1]);
  __syncthreads();
  zero_smem(bufb, R);
  __syncthreads();
  conv_wg<128, 128, 2, 2, kWgStore>(bufa, bufb, L2, T, nv, c0, ring, sched, sb,
                                    tw.s[2], tw.b[2]);
  __syncthreads();
  zero_smem(bufa, R);
  __syncthreads();
  conv_wg<128, 128, 2, 2, kWgStore>(bufb, bufa, L2, T, nv, c0, ring, sched, sb,
                                    tw.s[3], tw.b[3]);
  __syncthreads();
  conv_wg<128, 256, 2, 2, EPI5>(bufa, EPI5 == kWgPoolBf16 ? feats : bufb, L2,
                                T, nv, c0, ring, sched, sb, tw.s[4], tw.b[4]);
}

// The head on the packed int8 template tile in bufa (bufb zeroed; both R
// bytes; the caller synchronises after filling bufa): convs (conv, conv,
// conv, pool/2, conv, conv), the last one dequantized into f32 rows over
// bufb; the f32 mean over positions (a sequential sum, then one division)
// into `means` (T x 128 f32); cls and reg of the block's cutouts, rows c0
// .. c0 + nv - 1 of the outputs. bufa and bufb are clobbered.
template <class Sched>
__device__ __forceinline__ void head_convs(int8_t* bufa, int8_t* bufb, int R,
                                           float* means, int L4, int T,
                                           int nv, int c0, Ring& ring,
                                           const Sched& sched, float* sb,
                                           const HeadWeights& hw,
                                           float* __restrict__ cls,
                                           float* __restrict__ reg, int nc) {
  const int L8 = L4 / 2;
  conv_wg<256, 256, 2, 2, kWgStore>(bufa, bufb, L4, T, nv, c0, ring, sched, sb,
                                    hw.s[0], hw.b[0]);
  __syncthreads();
  zero_smem(bufa, R);
  __syncthreads();
  conv_wg<256, 256, 2, 2, kWgStore>(bufb, bufa, L4, T, nv, c0, ring, sched, sb,
                                    hw.s[1], hw.b[1]);
  __syncthreads();
  zero_smem(bufb, R);
  __syncthreads();
  conv_wg<256, 512, 2, 2, kWgPool>(bufa, bufb, L4, T, nv, c0, ring, sched, sb,
                                   hw.s[2], hw.b[2]);
  __syncthreads();
  zero_smem(bufa, R);
  __syncthreads();
  conv_wg<512, 256, 1, 4, kWgStore>(bufb, bufa, L8, T, nv, c0, ring, sched, sb,
                                    hw.s[3], hw.b[3]);
  __syncthreads();
  // the last conv is dequantized: f32 rows into the free region
  float* fout = reinterpret_cast<float*>(bufb);
  conv_wg<256, 128, 1, 2, kWgMean>(bufa, fout, L8, T, nv, c0, ring, sched, sb,
                                   hw.s[4], hw.b[4]);
  __syncthreads();
  head_mean(fout, means, nv, L8);
  __syncthreads();
  head_cls_reg(means, hw, cls, reg, c0, nv, nc);
}

}  // namespace
