// K4 (the bf16 detection head) and K14's head in bf16 for Hopper (sm_90a).
//
// K4 replaces planar_optical_flow_tpu/ops/pallas/conv_stack.py
// fused_head_v2 (_head_kernel, _head_cls_reg): head convs (conv, conv,
// conv, pool/2, conv, conv) on the bf16 template, the f32 mean over
// positions and the cls/reg linears. K14's bf16 head replaces
// planar_optical_flow_tpu/ops/pallas/fused_drow.py fused_head (_head_kernel)
// with compute_dtype bf16: the same convs on f32 feats, each rounded to
// bf16 as the tile is loaded (_conv3 casts every conv input), and its mean
// over the bf16 activations of the last conv as jnp.mean takes it: the f32
// sum times the f32 reciprocal of the count (XLA's form of a division by a
// constant), rounded to bf16 for cls/reg. One kernel, head_bf16_kernel<FE>,
// computes both (FE: the feats' type).
//
// Design: K7's (conv_stack_int8.cu) on wgmma_conv.cuh in bf16. A block
// keeps T cutouts (8 at the flagship L/4 = 14: a bf16 tile takes twice
// K7's bytes) back to back in a packed, channel-block-major tile; each conv
// is wgmma.mma_async m64nNk16 bf16 x bf16 -> f32 with both operands in
// shared memory, the weights streamed through the 4 x 16 KB ring by every
// thread's cp.async in the order the convs use them. The 14-position convs
// fill two 64-row tiles (one a warp group); the 7-position ones fill one,
// which both warp groups share, each taking half of N (the plans' WGN = 2).
// The host lays the weights out once per set of weights
// (conv_stack.head_weights_bf16, int8_tiles.wgmma_weights).
//
// Rounding: bf16 operands, f32 sums (in wgmma's order), bias +
// LeakyReLU(0.1) in f32, the activation stored as bf16 (the max-pool taken
// on the f32 sums: the epilogue is monotone and bf16 rounding too, so it is
// the same value), the position mean in f32 (K4: a running sum of the f32
// activations, then one division; K14: a running sum of their bf16
// values, times the reciprocal), cls/reg from bf16(mean) and the bf16
// weights with f32 sums.
//
// Bound: tensor-core operations (28.9 MFLOP a cutout at L/4 = 14 against
// 7 KB of device-memory traffic, 14 KB for K14's f32 feats). Each block
// streams all 2.56 MB of the conv weights from L2, once per 8 cutouts.

#include "wgmma_conv.cuh"

namespace {

// the plans of K4's convs, (Cin, Cout, row tiles, n64 tiles, warp groups
// along N); int8_tiles.HEAD_BF16_PLAN mirrors them
using HbPlan0 = ConvPlan<256, 256, 1, 4, 1, bf16>;  // convs 1 and 2
using HbPlan2 = ConvPlan<256, 512, 1, 4, 1, bf16>;
using HbPlan3 = ConvPlan<512, 256, 1, 2, 2, bf16>;
using HbPlan4 = ConvPlan<256, 128, 1, 1, 2, bf16>;

struct HeadBf16Weights {
  const int8_t* w[5];  // laid out by int8_tiles.wgmma_weights
  const float* b[5];
  const bf16* wc;
  const float* bc;
  const bf16* wr;
  const float* br;
};

// a block's tile region (each of two): the packed bf16 tiles of its stages
// and the last conv's f32 rows
size_t head_bf16_region(int l4, int T) {
  size_t r = imax(ptile_bytes(l4, 256 * 2, T), ptile_bytes(l4 / 2, 512 * 2, T));
  const size_t f = (size_t)T * (l4 / 2) * 128 * sizeof(float);
  return round128(r > f ? r : f);
}

size_t head_bf16_smem(int l4, int T) {
  return kRingBytes + 2 * head_bf16_region(l4, T) +
         (size_t)T * 128 * sizeof(float);
}

// cutouts a block: the most (kWgTile, halved) whose shared memory fits
int head_bf16_tile(int l4) {
  int T = kWgTile;
  while (T > 1 && head_bf16_smem(l4, T) > kSmemMax) T /= 2;
  return T;
}

// K14's f32 feats rows (n * L4, 256) of cutouts c0 .. c0 + nv - 1, each
// rounded to bf16, into the zeroed packed tile at load_packed's rows
__device__ __forceinline__ void load_packed(const float* __restrict__ src,
                                            bf16* tile, int c0, int nv,
                                            int L, int T) {
  constexpr int V = 256 / 8;  // 8-channel vectors a row
  const int S = pstride(L), rows = prows(L, T);
  for (int idx = threadIdx.x; idx < nv * L * V; idx += kWgThreads) {
    const int r = idx / V, v = idx - r * V;  // r: row of the block's cutouts
    const int c = r / L, p = r - c * L;
    const float4* f = reinterpret_cast<const float4*>(
        src + ((size_t)c0 * L + r) * 256 + 8 * v);
    const float4 a = f[0], b = f[1];
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    h[0] = __floats2bfloat162_rn(a.x, a.y);
    h[1] = __floats2bfloat162_rn(a.z, a.w);
    h[2] = __floats2bfloat162_rn(b.x, b.y);
    h[3] = __floats2bfloat162_rn(b.z, b.w);
    *reinterpret_cast<uint4*>(packed_at(tile, rows, c * S + 1 + p, 8 * v)) =
        raw;
  }
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// FE bf16: K4, on the bf16 template; FE float: K14's bf16 head, on f32
// feats. Shared memory: the ring, the biases, two tile regions of R bytes,
// the means (T x 128 f32).
template <typename FE>
__global__ void __launch_bounds__(kWgThreads, 1)
    head_bf16_kernel(const FE* __restrict__ feats,
                     const __grid_constant__ HeadBf16Weights hw,
                     float* __restrict__ cls, float* __restrict__ reg, int n,
                     int L4, int nc, int T, int R) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sb = reinterpret_cast<float*>(smem_raw + kStages * kStageBytes);
  bf16* bufa = reinterpret_cast<bf16*>(smem_raw + kRingBytes);
  bf16* bufb = reinterpret_cast<bf16*>(smem_raw + kRingBytes + R);
  float* means = reinterpret_cast<float*>(smem_raw + kRingBytes + 2 * R);
  const int c0 = blockIdx.x * T;
  const int nv = min(T, n - c0);
  const int L8 = L4 / 2;
  // the weight chunks of the five convs, in the order they are used
  auto sched = [&](int j, const int8_t*& src, int& bytes) {
    return chunk_of<HbPlan0>(j, hw.w[0], L4, T, src, bytes) ||
           chunk_of<HbPlan0>(j, hw.w[1], L4, T, src, bytes) ||
           chunk_of<HbPlan2>(j, hw.w[2], L4, T, src, bytes) ||
           chunk_of<HbPlan3>(j, hw.w[3], L8, T, src, bytes) ||
           chunk_of<HbPlan4>(j, hw.w[4], L8, T, src, bytes);
  };
  int8_t* za = reinterpret_cast<int8_t*>(bufa);
  int8_t* zb = reinterpret_cast<int8_t*>(bufb);

  Ring ring = ring_start(smem_raw, sched);
  zero_smem(za, R);
  zero_smem(zb, R);
  __syncthreads();
  if constexpr (sizeof(FE) == 2) {
    load_packed<256>(feats, bufa, c0, nv, L4, T);
  } else {
    load_packed(feats, bufa, c0, nv, L4, T);
  }
  __syncthreads();
  conv_wg<256, 256, 1, 4, kWgStore, 1>(bufa, bufb, L4, T, nv, c0, ring, sched,
                                       sb, nullptr, hw.b[0]);
  __syncthreads();
  zero_smem(za, R);
  __syncthreads();
  conv_wg<256, 256, 1, 4, kWgStore, 1>(bufb, bufa, L4, T, nv, c0, ring, sched,
                                       sb, nullptr, hw.b[1]);
  __syncthreads();
  zero_smem(zb, R);
  __syncthreads();
  conv_wg<256, 512, 1, 4, kWgPool, 1>(bufa, bufb, L4, T, nv, c0, ring, sched,
                                      sb, nullptr, hw.b[2]);
  __syncthreads();
  zero_smem(za, R);
  __syncthreads();
  conv_wg<512, 256, 1, 2, kWgStore, 2>(bufb, bufa, L8, T, nv, c0, ring, sched,
                                       sb, nullptr, hw.b[3]);
  __syncthreads();
  // the last conv's f32 rows into the free region
  float* fout = reinterpret_cast<float*>(bufb);
  conv_wg<256, 128, 1, 1, kWgMean, 2>(bufa, fout, L8, T, nv, c0, ring, sched,
                                      sb, nullptr, hw.b[4]);
  __syncthreads();

  // the mean over positions: K4 a running sum, then one division; K14 a
  // running sum of the activations' bf16 values, times the reciprocal
  constexpr bool kK14 = sizeof(FE) == 4;
  const float inv = 1.0f / (float)L8;
  for (int idx = threadIdx.x; idx < nv * 128; idx += kWgThreads) {
    const int c = idx >> 7, ch = idx & 127;
    const float* f = fout + (size_t)c * L8 * 128 + ch;
    float s = kK14 ? bf16r(f[0]) : f[0];
    for (int r = 1; r < L8; ++r) s += kK14 ? bf16r(f[r * 128]) : f[r * 128];
    means[idx] = kK14 ? s * inv : s / (float)L8;
  }
  __syncthreads();

  // cls / reg: bf16(mean) @ bf16 weights, f32 accumulate, + f32 bias
  for (int idx = threadIdx.x; idx < nv * (nc + 2); idx += kWgThreads) {
    const int c = idx / (nc + 2), j = idx - c * (nc + 2);
    const bool is_cls = j < nc;
    const bf16* w = is_cls ? hw.wc + j : hw.wr + (j - nc);
    const int ldw = is_cls ? nc : 2;
    float acc = 0.0f;
    for (int k = 0; k < 128; ++k)
      acc += bf16r(means[c * 128 + k]) * __bfloat162float(w[k * ldw]);
    if (is_cls)
      cls[(size_t)(c0 + c) * nc + j] = acc + hw.bc[j];
    else
      reg[(size_t)(c0 + c) * 2 + (j - nc)] = acc + hw.br[j - nc];
  }
  cp_async_wait<0>();  // the zero copies past the last chunk
}

}  // namespace

// The launch geometry of K4 at l4 positions: cutouts a block, rows a cutout
// in the packed tile and dynamic shared memory (bytes);
// int8_tiles.head_bf16_geometry mirrors it
extern "C" int head_bf16_geometry(int l4, int* tile, int* rows,
                                  long long* smem) {
  *tile = head_bf16_tile(l4);
  *rows = pstride(l4);
  *smem = (long long)head_bf16_smem(l4, *tile);
  return 0;
}

// The chunking of conv `layer` (0-4): output channels a pass and K
// elements a chunk, which int8_tiles.wgmma_weights lays out
extern "C" int head_bf16_plan(int layer, int* ns, int* kc) {
  static const int plan[5][2] = {
      {HbPlan0::NS, HbPlan0::KC}, {HbPlan0::NS, HbPlan0::KC},
      {HbPlan2::NS, HbPlan2::KC}, {HbPlan3::NS, HbPlan3::KC},
      {HbPlan4::NS, HbPlan4::KC}};
  if (layer < 0 || layer > 4) return (int)cudaErrorInvalidValue;
  *ns = plan[layer][0];
  *kc = plan[layer][1];
  return 0;
}

extern "C" long long head_bf16_smem_bytes(int l4) {
  return (long long)head_bf16_smem(l4, head_bf16_tile(l4));
}

namespace {

template <typename FE>
int launch_head_bf16(const void* feats, const void* const* convs,
                     const void* wc, const void* bc, const void* wr,
                     const void* br, void* cls, void* reg, int n, int l4,
                     int nc, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const int T = head_bf16_tile(l4);
  const size_t smem = head_bf16_smem(l4, T);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)head_bf16_kernel<FE>, smem);
  if (err) return err;
  HeadBf16Weights hw;
  for (int i = 0; i < 5; ++i) {
    hw.w[i] = (const int8_t*)convs[2 * i];
    hw.b[i] = (const float*)convs[2 * i + 1];
  }
  hw.wc = (const bf16*)wc;
  hw.bc = (const float*)bc;
  hw.wr = (const bf16*)wr;
  hw.br = (const float*)br;
  head_bf16_kernel<FE><<<(n + T - 1) / T, kWgThreads, smem,
                         (cudaStream_t)stream>>>(
      (const FE*)feats, hw, (float*)cls, (float*)reg, n, l4, nc, T,
      (int)head_bf16_region(l4, T));
  return (int)cudaGetLastError();
}

}  // namespace

// K4: feats (n * l4, 256) bf16; convs: the 10 pointers (w, b) of the five
// head convs, each w laid out by int8_tiles.wgmma_weights
extern "C" int head_bf16_launch(const void* feats, const void* const* convs,
                                const void* wc, const void* bc, const void* wr,
                                const void* br, void* cls, void* reg, int n,
                                int l4, int nc, void* stream) {
  return launch_head_bf16<bf16>(feats, convs, wc, bc, wr, br, cls, reg, n, l4,
                                nc, stream);
}

// K14's bf16 head: feats (n, l4, 256) f32; the other arguments as for
// head_bf16_launch
extern "C" int fused_head_bf16_launch(const void* feats,
                                      const void* const* convs, const void* wc,
                                      const void* bc, const void* wr,
                                      const void* br, void* cls, void* reg,
                                      int n, int l4, int nc, void* stream) {
  return launch_head_bf16<float>(feats, convs, wc, bc, wr, br, cls, reg, n,
                                 l4, nc, stream);
}
