// The bf16 backbones for Hopper (sm_90a): K2 (with its layer 1 and its gate
// embed) and K14's bf16 backbone, one kernel on wgmma_conv.cuh.
//
// Replaces:
//   K2  planar_optical_flow_tpu/ops/pallas/conv_stack.py fused_backbone_v2
//       with embed_weights (_backbone_kernel, _run_plan, _conv_rolled,
//       _embed_epilogue), after XLA's backbone_layer1 (:102), which the
//       bf16 v3 step runs in front of it: (N, L) f32 cutouts -> layer 1 (1
//       -> 64, f32, leaky, bf16) -> convs 64 -> 64, 64 -> 128 + pool, 128
//       -> 128, 128 -> 128, 128 -> 256 + pool -> bf16 feats (N * L/4, 256)
//       and zx = bf16(feats_flat @ We + be);
//   K14 planar_optical_flow_tpu/ops/pallas/fused_drow.py fused_backbone
//       (_backbone_kernel) with compute_dtype bf16: the same six convs, layer
//       1 on bf16-rounded cutouts as _conv3 takes it, no embed -> (N, L/4,
//       256) f32 feats holding bf16 values.
//
// Layer 1 (template parameter L1), per position from the block's f32
// cutouts staged in shared memory, straight into the packed bf16 tile:
//   kXla   (K2): backbone_layer1 as torch runs it on the card, ((xl * w0 + x
//          * w1) + xr * w2) + b with every operation rounded once (no FMA
//          contraction), leaky, bf16 round-to-nearest-even;
//   kConv3 (K14): the taps rounded to bf16 first (the weights arrive as
//          bf16 values), xl * w0, two fmaf (each product exact), + b, leaky,
//          bf16;
//   kRead  (K2 on its JAX interface): the bf16 act1 rows (N * L, 64) loaded
//          into the tile. backbone_layer1 -> kRead equals kXla to the bit.
//
// Design: K5's (conv_stack_int8.cu) in bf16, as K4 (head_bf16.cu) uses the
// header. A block keeps T cutouts (8 at L = 56: a bf16 tile takes twice
// K5's bytes) back to back in a packed, channel-block-major tile; each conv
// is wgmma.mma_async m64nNk16 bf16 x bf16 -> f32 with both operands in
// shared memory, the weights streamed through the 4 x 16 KB ring by every
// thread's cp.async two chunks ahead of use, in the order the convs use
// them (laid out once by the host: int8_tiles.wgmma_weights, esize 2).
// Epilogue: leaky(acc + b) in f32, the max-pool on the f32 sums, stored as
// bf16. It is hoisted (conv_wg's HOIST: the biases in registers, a row
// slab's pool shuffles before its stores), which took K2's backbone kernel
// from 10.3 to 8.0-8.4 ms and its pooled epilogues from 19 to 10 us of a
// block's 56 (NVIDIA H100 80GB HBM3, 700 W; experiments/
// torch_backbone_bf16_split.py). The rows around each cutout's L positions
// are zero (zero_pads, the only zeroing: every other row is written) and
// feed the neighbouring cutout's taps as SAME padding. The last conv's
// epilogue pools straight into the feats rows in device memory (bf16, or
// f32 holding the bf16 values for K14), so the stores spread over its
// products. At L = 56 each tile is about 64 KB: 56 x 64 channels in 8 row
// tiles, 28 x 128 in 4. Layer 1's loop has one trip count for every
// thread: ptxas serializes the products when a warpgroup instruction sits
// on a path only some threads take.
//
// K2's gate embed is embed.cuh's embed_kernel<bf16> over the feats the
// first kernel wrote, launched by the same entry (as K5's).
//
// Bound on this card (NVIDIA H100, 989 TFLOP/s bf16): tensor-core
// operations, 15.1 MFLOP a cutout for the five convs at L = 56 and 0.9 for
// the embed, against 224 bytes of cutout in and 7 KB (K2, bf16) or 14 KB
// (K14, f32) of feats out. Each block streams 516 KB of weights from L2
// (the convs' 467 KB, conv 2's twice: once per row group), once per 8
// cutouts.

#include "embed.cuh"
#include "wgmma_conv.cuh"

namespace {

// layer-1 forms; the read mode is int8_stack.cuh's kRead (2)
enum Bf16Layer1 { kXla = 0, kConv3 = 1 };

// the plans of the five convs, (Cin, Cout, row tiles, n64 tiles, warp
// groups along N); int8_tiles.BACKBONE_BF16_PLAN mirrors them
using BfPlan0 = ConvPlan<64, 64, 4, 1, 1, bf16>;
using BfPlan1 = ConvPlan<64, 128, 2, 2, 1, bf16>;
using BfPlan2 = ConvPlan<128, 128, 2, 2, 1, bf16>;  // convs 4 and 5
using BfPlan4 = ConvPlan<128, 256, 2, 2, 1, bf16>;

struct BackboneBf16Weights {
  const float* w1;     // layer 1 (3, 64) f32 (K14: bf16 values)
  const float* b1;     // (64,)
  const int8_t* w[5];  // convs 2-6, laid out by int8_tiles.wgmma_weights
  const float* b[5];
};

// a block's tile region (each of two): the larger packed bf16 tile of its
// two lengths (the last conv writes device memory)
size_t backbone_bf16_region(int l, int T) {
  return round128(imax(ptile_bytes(l, 64 * 2, T),
                       ptile_bytes(l / 2, 128 * 2, T)));
}

size_t backbone_bf16_smem(int l, int L1, int T) {
  return kRingBytes + 2 * backbone_bf16_region(l, T) +
         (L1 != kRead ? (size_t)T * l * sizeof(float) : 0);
}

// cutouts a block: the most (kWgTile, halved) whose shared memory fits
int backbone_bf16_tile(int l, int L1) {
  int T = kWgTile;
  while (T > 1 && backbone_bf16_smem(l, L1, T) > kSmemMax) T /= 2;
  return T;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Layer 1 of the block's nv cutouts (f32, nv x L in cut_s) into the zeroed
// packed tile (64 channels): warp w computes channels 8w .. 8w + 7 (one
// 16-byte channel block) of 32 consecutive rows a pass, lane by row, and
// every thread runs ceil(T * L / 32) passes, storing only its real rows.
template <int L1>
__device__ __forceinline__ void layer1_bf16(const float* cut_s,
                                            const float* __restrict__ w1,
                                            const float* __restrict__ b1,
                                            bf16* tile, int nv, int L,
                                            int T) {
  const int ch = 8 * (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int S = pstride(L), rows = prows(L, T);
  float w[3][8], b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int t = 0; t < 3; ++t) w[t][j] = w1[64 * t + ch + j];
    b[j] = b1[ch + j];
  }
  const int iters = (T * L + 31) / 32;
  for (int it = 0; it < iters; ++it) {
    const int r = 32 * it + lane;  // row of the block's cutouts
    const int c = r / L, p = r - c * L;
    const bool real = r < nv * L;  // else nothing is read or stored
    float x = real ? cut_s[r] : 0.0f;
    float xl = real && p > 0 ? cut_s[r - 1] : 0.0f;
    float xr = real && p < L - 1 ? cut_s[r + 1] : 0.0f;
    if (L1 == kConv3) {
      x = bf16r(x);
      xl = bf16r(xl);
      xr = bf16r(xr);
    }
    float y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float a;
      if (L1 == kXla) {
        a = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(xl, w[0][j]),
                                          __fmul_rn(x, w[1][j])),
                                __fmul_rn(xr, w[2][j])),
                      b[j]);
      } else {
        a = fmaf(xr, w[2][j], fmaf(x, w[1][j], __fmul_rn(xl, w[0][j])));
        a = __fadd_rn(a, b[j]);
      }
      y[j] = leaky(a);
    }
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(y[2 * j], y[2 * j + 1]);
    if (real)
      *reinterpret_cast<uint4*>(packed_at(tile, rows, c * S + 1 + p, ch)) =
          raw;
  }
}

// Zero the rows of a packed bf16 tile of C channels (length L, T cutouts,
// nv of them real) that no store fills: each cutout's rows before and after
// its L positions, and every row past the real cutouts that a 64-row tile
// reads. Layer 1, a load or a conv's epilogue writes every other row, so the
// tile needs no other zeroing.
template <int C>
__device__ __forceinline__ void zero_pads(bf16* tile, int L, int T, int nv) {
  const int S = pstride(L), rows = prows(L, T);
  const int P = S - L;                   // pad rows a cutout: 1 or 2
  const int n = nv * P + rows - nv * S;  // pad rows of the tile
  for (int idx = threadIdx.x; idx < n * (C / 8); idx += kWgThreads) {
    const int cb = idx / n, k = idx - cb * n;
    const int j = k % P;  // the cutout's row before (0) or after its rows
    const int r = k < nv * P ? (k / P) * S + (j ? L + j : 0)
                             : nv * S + (k - nv * P);
    *reinterpret_cast<uint4*>(packed_at(tile, rows, r, 8 * cb)) =
        make_uint4(0, 0, 0, 0);
  }
}

// Layer 1 (or act1's rows, kRead) and the five convs of T cutouts a block;
// the last conv's epilogue pools straight into the feats rows of FO in
// device memory (bf16: K2; float: K14). Shared memory: the ring, two tile
// regions of R bytes, the f32 cutouts (not for kRead). The stores of the
// pads, of layer 1 and of each tile's load reach the products through the
// next conv's own fence and barrier; a barrier after each conv frees its
// input tile (and the biases) for the next one.
template <int L1, typename FO>
__global__ void __launch_bounds__(kWgThreads, 1)
    backbone_bf16_kernel(const void* __restrict__ in,
                         const __grid_constant__ BackboneBf16Weights bw,
                         FO* __restrict__ feats, int n, int L, int T, int R) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sb = reinterpret_cast<float*>(smem_raw + kStages * kStageBytes);
  bf16* bufa = reinterpret_cast<bf16*>(smem_raw + kRingBytes);
  bf16* bufb = reinterpret_cast<bf16*>(smem_raw + kRingBytes + R);
  float* cut_s = reinterpret_cast<float*>(smem_raw + kRingBytes + 2 * R);
  const int c0 = blockIdx.x * T;
  const int nv = min(T, n - c0);
  const int L2 = L / 2;
  constexpr int kOut =
      std::is_same<FO, float>::value ? kWgPoolF32 : kWgPoolBf16;
  // the weight chunks of the five convs, in the order they are used
  auto sched = [&](int j, const int8_t*& src, int& bytes) {
    return chunk_of<BfPlan0>(j, bw.w[0], L, T, src, bytes) ||
           chunk_of<BfPlan1>(j, bw.w[1], L, T, src, bytes) ||
           chunk_of<BfPlan2>(j, bw.w[2], L2, T, src, bytes) ||
           chunk_of<BfPlan2>(j, bw.w[3], L2, T, src, bytes) ||
           chunk_of<BfPlan4>(j, bw.w[4], L2, T, src, bytes);
  };

  Ring ring = ring_start(smem_raw, sched);
  zero_pads<64>(bufa, L, T, nv);  // layer 1's tile
  zero_pads<64>(bufb, L, T, nv);  // conv 1's
  if (L1 == kRead) {
    load_packed<64>(static_cast<const bf16*>(in), bufa, c0, nv, L, T);
  } else {
    const float* cut = static_cast<const float*>(in);
    for (int idx = threadIdx.x; idx < nv * L; idx += kWgThreads)
      cut_s[idx] = cut[(size_t)c0 * L + idx];
    __syncthreads();
    layer1_bf16<L1>(cut_s, bw.w1, bw.b1, bufa, nv, L, T);
  }
  // each conv with its epilogue hoisted (HOIST)
  conv_wg<64, 64, 4, 1, kWgStore, 1, true>(bufa, bufb, L, T, nv, c0, ring,
                                           sched, sb, nullptr, bw.b[0]);
  __syncthreads();
  zero_pads<128>(bufa, L2, T, nv);
  conv_wg<64, 128, 2, 2, kWgPool, 1, true>(bufb, bufa, L, T, nv, c0, ring,
                                           sched, sb, nullptr, bw.b[1]);
  __syncthreads();
  zero_pads<128>(bufb, L2, T, nv);
  conv_wg<128, 128, 2, 2, kWgStore, 1, true>(bufa, bufb, L2, T, nv, c0, ring,
                                             sched, sb, nullptr, bw.b[2]);
  __syncthreads();
  zero_pads<128>(bufa, L2, T, nv);
  conv_wg<128, 128, 2, 2, kWgStore, 1, true>(bufb, bufa, L2, T, nv, c0, ring,
                                             sched, sb, nullptr, bw.b[3]);
  __syncthreads();
  conv_wg<128, 256, 2, 2, kOut, 1, true>(bufa, feats, L2, T, nv, c0, ring,
                                         sched, sb, nullptr, bw.b[4]);
  cp_async_wait<0>();  // the zero copies past the last chunk
}

template <int L1, typename FO>
int launch_backbone_bf16(const void* in, const BackboneBf16Weights& bw,
                         void* feats, int n, int l, cudaStream_t stream) {
  const int T = backbone_bf16_tile(l, L1);
  const size_t smem = backbone_bf16_smem(l, L1, T);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)backbone_bf16_kernel<L1, FO>, smem);
  if (err) return err;
  backbone_bf16_kernel<L1, FO><<<(n + T - 1) / T, kWgThreads, smem,
                                 stream>>>(
      in, bw, (FO*)feats, n, l, T, (int)backbone_bf16_region(l, T));
  return (int)cudaGetLastError();
}

}  // namespace

// The launch geometry at cutout length l in layer-1 mode l1_mode (as for
// backbone_bf16_launch): cutouts a block, rows a cutout in the packed tile
// and dynamic shared memory (bytes); int8_tiles.backbone_bf16_geometry
// mirrors it
extern "C" int backbone_bf16_geometry(int l, int l1_mode, int* tile,
                                      int* rows, long long* smem) {
  *tile = backbone_bf16_tile(l, l1_mode);
  *rows = pstride(l);
  *smem = (long long)backbone_bf16_smem(l, l1_mode, *tile);
  return 0;
}

// The chunking of conv `layer` (0-4, convs 2-6): output channels a pass
// and K elements a chunk, which int8_tiles.wgmma_weights lays out
extern "C" int backbone_bf16_plan(int layer, int* ns, int* kc) {
  static const int plan[5][2] = {
      {BfPlan0::NS, BfPlan0::KC}, {BfPlan1::NS, BfPlan1::KC},
      {BfPlan2::NS, BfPlan2::KC}, {BfPlan2::NS, BfPlan2::KC},
      {BfPlan4::NS, BfPlan4::KC}};
  if (layer < 0 || layer > 4) return (int)cudaErrorInvalidValue;
  *ns = plan[layer][0];
  *kc = plan[layer][1];
  return 0;
}

extern "C" long long backbone_bf16_smem_bytes(int l, int l1_mode) {
  return (long long)backbone_bf16_smem(l, l1_mode,
                                       backbone_bf16_tile(l, l1_mode));
}

// l1_mode 0 (K2, kXla): in = (n, l) f32 cutouts -> feats (n * l/4, 256)
// bf16 and zx (n, 128) bf16; 1 (K14, kConv3): in = the cutouts -> feats (n,
// l/4, 256) f32, no embed (we_t, be, zx unused); 2 (K2, kRead): in = act1
// (n * l, 64) bf16, outputs as mode 0. w: the 12 pointers w1 (3, 64) f32,
// b1 (64,) f32 (unused in mode 2), then (w, b) of convs 2-6, each w laid
// out by int8_tiles.wgmma_weights in bf16, b f32. we_t (128, l/4 * 256)
// bf16, be (128,) bf16. Modes 0 and 2 launch twice: the backbone, then the
// gate embed on its feats.
extern "C" int backbone_bf16_launch(const void* in, const void* const* w,
                                    const void* we_t, const void* be,
                                    void* feats, void* zx, int n, int l,
                                    int l1_mode, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (l % 4 || l < 4) return (int)cudaErrorInvalidValue;
  BackboneBf16Weights bw;
  bw.w1 = (const float*)w[0];
  bw.b1 = (const float*)w[1];
  for (int i = 0; i < 5; ++i) {
    bw.w[i] = (const int8_t*)w[2 + 2 * i];
    bw.b[i] = (const float*)w[3 + 2 * i];
  }
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (l1_mode == kConv3)
    return launch_backbone_bf16<kConv3, float>(in, bw, feats, n, l, st);
  if (l1_mode == kXla)
    err = launch_backbone_bf16<kXla, bf16>(in, bw, feats, n, l, st);
  else if (l1_mode == kRead)
    err = launch_backbone_bf16<kRead, bf16>(in, bw, feats, n, l, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err) return err;
  return launch_embed<bf16>(feats, we_t, be, zx, n, l / 4 * 256, st);
}
