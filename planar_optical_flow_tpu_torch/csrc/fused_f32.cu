// K14 in f32: the fused DROW backbone and head of make_fused_stream_step,
// for Hopper (sm_90a), on split-bf16 wgmma products. (K14's bf16 mode is
// fused_drow.cu.)
//
// Replaces planar_optical_flow_tpu/ops/pallas/fused_drow.py fused_backbone
// (_backbone_kernel) and fused_head (_head_kernel) with compute_dtype f32.
// The backbone takes (N, L) f32 cutouts through the six k=3 SAME convs (1 ->
// 64 -> 64 -> 128, pool/2, 128 -> 128 -> 256, pool/2) to (N, L/4, 256) f32
// feats; the head takes the feats through 256 -> 256 -> 512, pool/2, 512 ->
// 256 -> 128, the mean over positions (a running sum times the f32
// reciprocal of the count, XLA's form of jnp.mean) and the cls/reg linears.
// BatchNorm is folded into every conv, LeakyReLU 0.1 after each.
//
// Products: split bf16 ("3xBF16"). Every f32 operand x is held as two bf16
// values, hi = bf16(x) and lo = bf16(x - hi) (x - hi exact in f32), which
// carry x to 2^-17 of its size in the same 4 bytes; a * b is taken as hi *
// hi + hi * lo + lo * hi (lo * lo, ~2^-18 relative, is dropped) by three
// wgmma.mma_async m64nNk16 .f32.bf16.bf16 products into one f32
// accumulator: ~1e-5 relative a product, inside the rtol 1e-3 the JAX test
// holds the f32 kernels to, which one bf16 product (2^-9) misses. Layer 1
// (Cin = 1) stays per position in f32 FFMA. The epilogue is leaky(acc + b)
// in f32 (a max-pool is taken on the sums: the epilogue is monotone, so it
// gives the same value), then split again into the next conv's hi and lo.
//
// Why split bf16 and not 3xTF32 (tf32 hi and lo, three m64nNk8 tf32
// products; experiments/fused_f32_tf32.cu): a tf32 lo copy of the tile does
// not fit beside it, so A's and the weights' lo parts had to be made on the
// chip for every k8 step, and the block was bound by that staging and its
// shared-memory traffic, not by the tensor cores: on an H100 SXM the
// 3xTF32 kernels take 2.7x these kernels' time
// (experiments/torch_fused_f32_tf32.py). Split bf16 keeps hi and lo in the
// bytes of the f32 value: the tiles hold both (the epilogue writes them),
// the host lays the weights' hi and lo out once, and the kernel is K4's:
// two wgmma warp groups on operands in shared memory.
//
// Layout: wgmma_conv.cuh's packed, channel-block-major tile of cutouts (8
// bf16 channels a 16-byte block, the tap a row offset, the pool pair an even
// row and the next one), its weight ring (4 stages of 16 KB, every thread's
// cp.async two chunks ahead of use, no producer warp) and descriptors, with
// two changes, so that this conv is its own (conv_x3) and wgmma_conv.cuh,
// which builds K4, K5, K7, K9 and K10, is not touched:
// * A tile is a pair: the hi tile, then the lo tile, each with its spill.
// * Tight tiles. A tile's channel blocks lie T * S + 2 rows apart (the rows
//   that hold data) instead of the extent of its 64-row tiles; the rows a
//   64-row tile reads past them belong to dropped output rows and read the
//   next channel block, or, past the last block, a spill kept in the tile.
//   This halves the head's 512-channel tiles at 7 positions (34 rows, not
//   66), so that 4 cutouts fit a block beside the ring.
// A weight chunk is NS output channels x KC of K: its hi part, then its lo
// part, each in the descriptor's core-matrix order (int8_tiles.
// plan_weights_f32). T = 4 cutouts a block at the flagship lengths (L = 56,
// L/4 = 14): the backbone's 4 and 2 row tiles alternate between the two
// warp groups; the head's one row tile is shared by both, each taking half
// of N (WGN = 2). Every product is issued unconditionally (a warp group past
// the last row tile multiplies the last one again and drops it): a wgmma on
// a divergent path is serialized.
//
// Bound: tensor-core operations, 3 x (15.2 MFLOP backbone, 28.9 MFLOP head)
// a cutout at L = 56 in bf16 at 989 TFLOP/s dense; each block streams the
// weights' hi and lo (0.93 MB backbone, 5.11 MB head, the bytes of the f32
// weights) from L2.

#include "wgmma_conv.cuh"

namespace {

constexpr int kF32Tile = 4;  // most cutouts a block

// rows of a channel block of a tight tile: T cutouts, their zero rows and
// row 0
__host__ __device__ constexpr int trows(int l, int T) {
  return T * pstride(l) + 2;
}
// bytes of one tight bf16 tile of c channels: its rows, and the rows the
// last channel block's 64-row tiles read past them
__host__ __device__ constexpr int ttile_bytes(int l, int c, int T) {
  return trows(l, T) * c * 2 + (m_tiles(l, T) * 64 + 2 - trows(l, T)) * 16;
}

// the lo tile of the pair at `hi` (length l, c channels)
__device__ __forceinline__ bf16* lo_of(bf16* hi, int l, int c, int T) {
  return hi + ttile_bytes(l, c, T) / 2;
}
__device__ __forceinline__ const bf16* lo_of(const bf16* hi, int l, int c,
                                             int T) {
  return hi + ttile_bytes(l, c, T) / 2;
}

// (y0, y1)'s hi and lo, as bf16 pairs
__device__ __forceinline__ void split2(float y0, float y1, __nv_bfloat162& h,
                                       __nv_bfloat162& l) {
  h = __floats2bfloat162_rn(y0, y1);
  l = __floats2bfloat162_rn(__fsub_rn(y0, __low2float(h)),
                            __fsub_rn(y1, __high2float(h)));
}

// K a chunk: the largest multiple of 16 (one instruction) dividing k whose
// hi and lo parts for ns channels fill at most a ring stage;
// int8_tiles.chunk_k_x3 mirrors it
__host__ __device__ constexpr int chunk_k_x3(int k, int ns) {
  int best = 16;
  for (int kc = 16; kc <= k; kc += 16)
    if (k % kc == 0 && ns * kc * 4 <= kStageBytes) best = kc;
  return best;
}

// one conv's place in the kernel's plan (int8_tiles.FUSED_BACKBONE_F32_PLAN,
// FUSED_HEAD_F32_PLAN): MT row tiles x NJ n64 tiles a warp group, WGN warp
// groups along N (as wgmma_conv.cuh's ConvPlan)
template <int CIN, int COUT, int MT, int NJ, int WGN>
struct X3Plan {
  static constexpr int NW = 64 * NJ;   // channels a warp group's product
  static constexpr int NS = NW * WGN;  // output channels a pass
  static constexpr int K = 3 * CIN;
  static constexpr int KC = chunk_k_x3(K, NS);  // K a chunk
  static constexpr int NKC = K / KC;   // chunks a pass
  static constexpr int NSL = COUT / NS;  // passes a row group
  static constexpr int HALF = NS * KC * 2;  // bytes of a chunk's hi part
  static constexpr int CHUNK = 2 * HALF;    // hi, then lo
  static constexpr int SPC = KC / 16;  // instructions a chunk, each of hi/lo
  static_assert(WGN == 1 || WGN == 2, "plan");
  static_assert(CIN % 16 == 0 && COUT % NS == 0 && CHUNK <= kStageBytes,
                "plan");
  __host__ __device__ static int groups(int l, int T) {
    const int per = WGN == 1 ? 2 * MT : MT;
    return (m_tiles(l, T) + per - 1) / per;
  }
};

enum X3Epilogue {
  kXStore = 0,     // into a tight tile pair of the same length
  kXPool = 1,      // pooled, into a tight tile pair of length L / 2
  kXPoolRows = 2,  // pooled f32 rows (cutout c0 + c, L / 2, COUT) into
                   // device memory
  kXRows = 3,      // f32 rows (c, L, COUT) into shared memory
};

// One k=3 SAME conv over the tight tile pair `in` of the block's T cutouts
// (nv of them real, the first one cutout c0; CIN channels, length L) ->
// `out` as EPI says (a pair of COUT channels, or f32 rows). The weights
// stream through wgmma_conv.cuh's ring (sched names the kernel's chunks,
// chunk_of<X3Plan<...>> this conv's); the bias is copied to shared memory
// (sb) first. Each k16 step issues hi * hi, hi * lo and lo * hi.
template <int CIN, int COUT, int MT, int NJ, int EPI, int WGN, class Sched>
__device__ __forceinline__ void conv_x3(const bf16* in, void* out, int L,
                                        int T, int nv, int c0, Ring& ring,
                                        const Sched& sched, float* sb,
                                        const float* __restrict__ bias) {
  using P = X3Plan<CIN, COUT, MT, NJ, WGN>;
  const int S = pstride(L), L2 = L / 2, rows = trows(L, T);
  const int tiles = m_tiles(L, T), groups = P::groups(L, T);
  const bf16* in_lo = lo_of(in, L, CIN, T);
  const int wg = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  // this warp group's channels of a pass, and its B operand's first bytes
  const int n_wg = WGN == 2 ? wg * P::NW : 0;

  for (int i = threadIdx.x; i < COUT; i += kWgThreads) sb[i] = bias[i];
  fence_async_shared();  // the tile's stores, for the async proxy
  __syncthreads();
  for (int grp = 0; grp < groups; ++grp) {
    // row tiles of this warp group: grp * 2MT + 2i + wg, or (WGN = 2)
    // grp * MT + i
    int m0[MT];
    bool live[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int t = WGN == 1 ? grp * 2 * MT + 2 * i + wg : grp * MT + i;
      live[i] = t < tiles;
      m0[i] = min(t, tiles - 1) * 64;
    }
    for (int ns = 0; ns < P::NSL; ++ns) {
      float acc[MT][NJ * 32];  // n8 block b of row tile i: acc[i][4b ..]
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < NJ * 32; ++e) acc[i][e] = 0.0f;

      // a chunk's products are one group, as in wgmma_conv.cuh's conv_wg
      wgmma_fence();
      for (int kc = 0; kc < P::NKC; ++kc) {
        if (kc > 0) wgmma_wait<1>();
        const int8_t* wb = next_chunk(ring, sched, ring.i + kc);
#pragma unroll
        for (int s = 0; s < P::SPC; ++s) {
          const int k = kc * P::KC + 16 * s;
          const int tap = k / CIN, ch = k - tap * CIN;
          const uint64_t bh = gmma_desc(wb + 2 * s * P::NS * 16 + n_wg * 16,
                                        P::NS * 16, 128);
          const uint64_t bl = bh + (P::HALF >> 4);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const uint64_t ah = gmma_desc(
                packed_at(in, rows, m0[i] + tap, ch), rows * 16, 128);
            const uint64_t al = gmma_desc(
                packed_at(in_lo, rows, m0[i] + tap, ch), rows * 16, 128);
            wgmma_bf16<P::NW>(acc[i], ah, bh);
            wgmma_bf16<P::NW>(acc[i], ah, bl);
            wgmma_bf16<P::NW>(acc[i], al, bh);
          }
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      ring.i += P::NKC;

      // epilogue: this thread's rows g and g + 8 of each 16-row slab
      constexpr bool kPooled = EPI == kXPool || EPI == kXPoolRows;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0[i] + 16 * wq + g + 8 * h;
          const int c = m / S, p = m - c * S;
          const bool keep = live[i] && c < nv && p < L;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int n = ns * P::NS + n_wg + 64 * j + 8 * jj + 2 * tq;
              const float v0 = acc[i][32 * j + 4 * jj + 2 * h];
              const float v1 = acc[i][32 * j + 4 * jj + 2 * h + 1];
              if (kPooled) {
                // positions 2r, 2r+1 are rows m (g even) and m + 1, lanes
                // `lane` and `lane ^ 4`: the even lane pools column n, the
                // odd one column n + 1, into output position p / 2; the
                // even lane stores the pair (n, n + 1)
                const int odd = g & 1;
                const float v = fmaxf(
                    odd ? v1 : v0, __shfl_xor_sync(kFull, odd ? v0 : v1, 4));
                const float y = leaky(__fadd_rn(v, sb[n + odd]));
                const float y1 = __shfl_xor_sync(kFull, y, 4);
                if (!keep || odd) continue;
                const int r = p / 2;
                if (EPI == kXPool) {
                  bf16* o = static_cast<bf16*>(out);
                  const int orow = c * pstride(L2) + 1 + r;
                  __nv_bfloat162 hh, ll;
                  split2(y, y1, hh, ll);
                  *reinterpret_cast<__nv_bfloat162*>(
                      packed_at(o, trows(L2, T), orow, n)) = hh;
                  *reinterpret_cast<__nv_bfloat162*>(
                      packed_at(lo_of(o, L2, COUT, T), trows(L2, T), orow,
                                n)) = ll;
                } else {
                  *reinterpret_cast<float2*>(
                      static_cast<float*>(out) +
                      ((size_t)(c0 + c) * L2 + r) * COUT + n) =
                      make_float2(y, y1);
                }
                continue;
              }
              if (!keep) continue;
              const float y0 = leaky(__fadd_rn(v0, sb[n]));
              const float y1 = leaky(__fadd_rn(v1, sb[n + 1]));
              if (EPI == kXStore) {
                bf16* o = static_cast<bf16*>(out);
                __nv_bfloat162 hh, ll;
                split2(y0, y1, hh, ll);
                *reinterpret_cast<__nv_bfloat162*>(
                    packed_at(o, rows, m + 1, n)) = hh;
                *reinterpret_cast<__nv_bfloat162*>(
                    packed_at(lo_of(o, L, COUT, T), rows, m + 1, n)) = ll;
              } else {
                *reinterpret_cast<float2*>(static_cast<float*>(out) +
                                           ((size_t)c * L + p) * COUT + n) =
                    make_float2(y0, y1);
              }
            }
        }
    }
  }
}

// 4 f32 values split into the hi and lo tiles of a pair at (row, ch)
__device__ __forceinline__ void store_split4(bf16* hi, bf16* lo, int rows,
                                             int row, int ch, float a,
                                             float b, float c, float d) {
  __nv_bfloat162 h0, l0, h1, l1;
  split2(a, b, h0, l0);
  split2(c, d, h1, l1);
  *reinterpret_cast<__nv_bfloat162*>(packed_at(hi, rows, row, ch)) = h0;
  *reinterpret_cast<__nv_bfloat162*>(packed_at(hi, rows, row, ch + 2)) = h1;
  *reinterpret_cast<__nv_bfloat162*>(packed_at(lo, rows, row, ch)) = l0;
  *reinterpret_cast<__nv_bfloat162*>(packed_at(lo, rows, row, ch + 2)) = l1;
}

// Rows (n * L, C) f32 of cutouts c0 .. c0 + nv - 1 from device memory into
// a zeroed tight tile pair, split
template <int C>
__device__ __forceinline__ void load_pair(const float* __restrict__ src,
                                          bf16* tile, int c0, int nv, int L,
                                          int T) {
  constexpr int V = C / 4;  // 16-byte f32 vectors a row
  const int S = pstride(L), rows = trows(L, T);
  bf16* lo = lo_of(tile, L, C, T);
  for (int idx = threadIdx.x; idx < nv * L * V; idx += kWgThreads) {
    const int r = idx / V, v = idx - r * V;  // r: row of the block's cutouts
    const int c = r / L, p = r - c * L;
    const float4 x =
        reinterpret_cast<const float4*>(src + ((size_t)c0 * L + r) * C)[v];
    store_split4(tile, lo, rows, c * S + 1 + p, 4 * v, x.x, x.y, x.z, x.w);
  }
}

// Layer 1 (Cin = 1) of cutouts c0 .. c0 + nv - 1 into a zeroed tight tile
// pair of 64 channels: acc = ((xl * w0 + x * w1) + xr * w2) + b over the
// taps of position p (zero beyond the cutout), then leaky, split; 4
// channels a thread, consecutive positions on consecutive threads. w: (3,
// 64), b: (64,).
__device__ __forceinline__ void layer1_pair(const float* __restrict__ cut,
                                            bf16* tile, int c0, int nv,
                                            int L, int T,
                                            const float* __restrict__ w,
                                            const float* __restrict__ b) {
  const int S = pstride(L), rows = trows(L, T), nr = nv * L;
  bf16* lo = lo_of(tile, L, 64, T);
  // the same trip count for every thread, the store predicated: with a
  // loop bound that differed between threads ptxas placed a warpgroup.arrive
  // on a divergent path and serialized the products (C7520)
  const int iters = (16 * T * L + kWgThreads - 1) / kWgThreads;
  for (int it = 0; it < iters; ++it) {
    const int idx0 = threadIdx.x + it * kWgThreads;
    const bool ok = idx0 < 16 * nr;
    const int idx = ok ? idx0 : 0;
    const int q = idx / nr, r = idx - q * nr;  // channels 4q.., row r
    const int c = r / L, p = r - c * L;
    const float* x = cut + (size_t)(c0 + c) * L;
    const float xl = p > 0 ? x[p - 1] : 0.0f, xm = x[p];
    const float xr = p + 1 < L ? x[p + 1] : 0.0f;
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(w) + q);
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(w + 64) + q);
    const float4 w2 = __ldg(reinterpret_cast<const float4*>(w + 128) + q);
    const float4 bb = __ldg(reinterpret_cast<const float4*>(b) + q);
    auto tap3 = [&](float a0, float a1, float a2, float bias) {
      float acc = __fmul_rn(xl, a0);
      acc = fmaf(xm, a1, acc);
      acc = fmaf(xr, a2, acc);
      return leaky(__fadd_rn(acc, bias));
    };
    if (ok)
      store_split4(tile, lo, rows, c * S + 1 + p, 4 * q,
                   tap3(w0.x, w1.x, w2.x, bb.x), tap3(w0.y, w1.y, w2.y, bb.y),
                   tap3(w0.z, w1.z, w2.z, bb.z),
                   tap3(w0.w, w1.w, w2.w, bb.w));
  }
}

// ---- the kernels --------------------------------------------------------

// the plans, (Cin, Cout, row tiles, n64 tiles, warp groups along N);
// int8_tiles.FUSED_BACKBONE_F32_PLAN and FUSED_HEAD_F32_PLAN mirror them
using BxPlan0 = X3Plan<64, 64, 2, 1, 1>;    // conv 2: 4 row tiles at 56
using BxPlan1 = X3Plan<64, 128, 2, 1, 1>;   // conv 3, pool: two passes
using BxPlan2 = X3Plan<128, 128, 1, 2, 1>;  // convs 4, 5: 2 row tiles
using BxPlan4 = X3Plan<128, 256, 1, 2, 1>;  // conv 6, pool: two passes
using HxPlan0 = X3Plan<256, 256, 1, 2, 2>;  // convs 1, 2: one row tile
using HxPlan2 = X3Plan<256, 512, 1, 2, 2>;  // conv 3, pool: two passes
using HxPlan3 = X3Plan<512, 256, 1, 2, 2>;
using HxPlan4 = X3Plan<256, 128, 1, 1, 2>;

struct BackboneF32 {
  const float* w1;     // layer 1 (3, 64)
  const float* b1;
  const int8_t* w[5];  // convs 2-6, laid out by int8_tiles.plan_weights_f32
  const float* b[5];
};

struct HeadF32 {
  const int8_t* w[5];  // laid out by int8_tiles.plan_weights_f32
  const float* b[5];
  const float* wc;     // (128, nc)
  const float* bc;
  const float* wr;     // (128, 2)
  const float* br;
};

// a block's tile region (each of two): the largest tile pair it holds
size_t backbone_f32_region(int l, int T) {
  return round128(2 * imax(ttile_bytes(l, 64, T), ttile_bytes(l / 2, 128, T)));
}
size_t backbone_f32_smem(int l, int T) {
  return kRingBytes + 2 * backbone_f32_region(l, T);
}
size_t head_f32_region(int l4, int T) {
  return round128(imax(2 * imax(ttile_bytes(l4, 256, T),
                                ttile_bytes(l4 / 2, 512, T)),
                       T * (l4 / 2) * 128 * 4));
}
size_t head_f32_smem(int l4, int T) {
  return kRingBytes + 2 * head_f32_region(l4, T) + (size_t)T * 128 * 4;
}

// cutouts a block: the most (kF32Tile, halved) whose shared memory fits
template <class F>
int f32_tile(int l, F smem_of) {
  int T = kF32Tile;
  while (T > 1 && smem_of(l, T) > kSmemMax) T /= 2;
  return T;
}

// Shared memory: the ring, the bias, two tile regions of R bytes.
__global__ void __launch_bounds__(kWgThreads, 1)
    backbone_x3_kernel(const float* __restrict__ cut,
                       const __grid_constant__ BackboneF32 bw,
                       float* __restrict__ feats, int n, int L, int T,
                       int R) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sb = reinterpret_cast<float*>(smem_raw + kStages * kStageBytes);
  bf16* bufa = reinterpret_cast<bf16*>(smem_raw + kRingBytes);
  bf16* bufb = reinterpret_cast<bf16*>(smem_raw + kRingBytes + R);
  const int c0 = blockIdx.x * T;
  const int nv = min(T, n - c0);
  const int L2 = L / 2;
  // the weight chunks of the five wgmma convs, in the order they are used
  auto sched = [&](int j, const int8_t*& src, int& bytes) {
    return chunk_of<BxPlan0>(j, bw.w[0], L, T, src, bytes) ||
           chunk_of<BxPlan1>(j, bw.w[1], L, T, src, bytes) ||
           chunk_of<BxPlan2>(j, bw.w[2], L2, T, src, bytes) ||
           chunk_of<BxPlan2>(j, bw.w[3], L2, T, src, bytes) ||
           chunk_of<BxPlan4>(j, bw.w[4], L2, T, src, bytes);
  };
  int8_t* za = reinterpret_cast<int8_t*>(bufa);
  int8_t* zb = reinterpret_cast<int8_t*>(bufb);

  Ring ring = ring_start(smem_raw, sched);
  zero_smem(za, R);
  zero_smem(zb, R);
  __syncthreads();
  layer1_pair(cut, bufa, c0, nv, L, T, bw.w1, bw.b1);
  __syncthreads();
  conv_x3<64, 64, 2, 1, kXStore, 1>(bufa, bufb, L, T, nv, c0, ring, sched,
                                    sb, bw.b[0]);
  __syncthreads();
  zero_smem(za, R);
  __syncthreads();
  conv_x3<64, 128, 2, 1, kXPool, 1>(bufb, bufa, L, T, nv, c0, ring, sched,
                                    sb, bw.b[1]);
  __syncthreads();
  zero_smem(zb, R);
  __syncthreads();
  conv_x3<128, 128, 1, 2, kXStore, 1>(bufa, bufb, L2, T, nv, c0, ring, sched,
                                      sb, bw.b[2]);
  __syncthreads();
  zero_smem(za, R);
  __syncthreads();
  conv_x3<128, 128, 1, 2, kXStore, 1>(bufb, bufa, L2, T, nv, c0, ring, sched,
                                      sb, bw.b[3]);
  __syncthreads();
  conv_x3<128, 256, 1, 2, kXPoolRows, 1>(bufa, feats, L2, T, nv, c0, ring,
                                         sched, sb, bw.b[4]);
  cp_async_wait<0>();  // the zero copies past the last chunk
}

// Shared memory: the ring, the bias, two tile regions of R bytes, the means
// (T x 128 f32).
__global__ void __launch_bounds__(kWgThreads, 1)
    head_x3_kernel(const float* __restrict__ feats,
                   const __grid_constant__ HeadF32 hw,
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
  auto sched = [&](int j, const int8_t*& src, int& bytes) {
    return chunk_of<HxPlan0>(j, hw.w[0], L4, T, src, bytes) ||
           chunk_of<HxPlan0>(j, hw.w[1], L4, T, src, bytes) ||
           chunk_of<HxPlan2>(j, hw.w[2], L4, T, src, bytes) ||
           chunk_of<HxPlan3>(j, hw.w[3], L8, T, src, bytes) ||
           chunk_of<HxPlan4>(j, hw.w[4], L8, T, src, bytes);
  };
  int8_t* za = reinterpret_cast<int8_t*>(bufa);
  int8_t* zb = reinterpret_cast<int8_t*>(bufb);

  Ring ring = ring_start(smem_raw, sched);
  zero_smem(za, R);
  zero_smem(zb, R);
  __syncthreads();
  load_pair<256>(feats, bufa, c0, nv, L4, T);
  __syncthreads();
  conv_x3<256, 256, 1, 2, kXStore, 2>(bufa, bufb, L4, T, nv, c0, ring, sched,
                                      sb, hw.b[0]);
  __syncthreads();
  zero_smem(za, R);
  __syncthreads();
  conv_x3<256, 256, 1, 2, kXStore, 2>(bufb, bufa, L4, T, nv, c0, ring, sched,
                                      sb, hw.b[1]);
  __syncthreads();
  zero_smem(zb, R);
  __syncthreads();
  conv_x3<256, 512, 1, 2, kXPool, 2>(bufa, bufb, L4, T, nv, c0, ring, sched,
                                     sb, hw.b[2]);
  __syncthreads();
  zero_smem(za, R);
  __syncthreads();
  conv_x3<512, 256, 1, 2, kXStore, 2>(bufb, bufa, L8, T, nv, c0, ring, sched,
                                      sb, hw.b[3]);
  __syncthreads();
  // the last conv's f32 rows into the free region
  float* fout = reinterpret_cast<float*>(bufb);
  conv_x3<256, 128, 1, 1, kXRows, 2>(bufa, fout, L8, T, nv, c0, ring, sched,
                                     sb, hw.b[4]);
  __syncthreads();

  // the mean over positions: a running sum times the f32 reciprocal of L8
  for (int idx = threadIdx.x; idx < nv * 128; idx += kWgThreads) {
    const int c = idx >> 7, ch = idx & 127;
    const float* f = fout + (size_t)c * L8 * 128 + ch;
    float s = f[0];
    for (int r = 1; r < L8; ++r) s += f[r * 128];
    means[idx] = s * (1.0f / (float)L8);
  }
  __syncthreads();

  // cls / reg: the means @ the f32 linears, + bias
  for (int idx = threadIdx.x; idx < nv * (nc + 2); idx += kWgThreads) {
    const int c = idx / (nc + 2), j = idx - c * (nc + 2);
    const bool is_cls = j < nc;
    const float* w = is_cls ? hw.wc + j : hw.wr + (j - nc);
    const int ldw = is_cls ? nc : 2;
    float acc = 0.0f;
    for (int k = 0; k < 128; ++k) acc += means[c * 128 + k] * w[k * ldw];
    if (is_cls)
      cls[(size_t)(c0 + c) * nc + j] = acc + hw.bc[j];
    else
      reg[(size_t)(c0 + c) * 2 + (j - nc)] = acc + hw.br[j - nc];
  }
  cp_async_wait<0>();  // the zero copies past the last chunk
}

}  // namespace

// The launch geometry of the f32 backbone (which = 0, l the cutout length)
// or head (1, l = L/4): cutouts a block, rows a cutout in the packed tile
// and dynamic shared memory (bytes); int8_tiles.fused_backbone_f32_geometry
// and fused_head_f32_geometry mirror it
extern "C" int fused_f32_geometry(int which, int l, int* tile, int* rows,
                                  long long* smem) {
  if (which != 0 && which != 1) return (int)cudaErrorInvalidValue;
  if (which == 0) {
    *tile = f32_tile(l, backbone_f32_smem);
    *smem = (long long)backbone_f32_smem(l, *tile);
  } else {
    *tile = f32_tile(l, head_f32_smem);
    *smem = (long long)head_f32_smem(l, *tile);
  }
  *rows = pstride(l);
  return 0;
}

// The chunking of conv `layer` (0-4) of the backbone (which = 0) or head
// (1): output channels a pass and K elements a chunk, which
// int8_tiles.plan_weights_f32 lays out
extern "C" int fused_f32_plan(int which, int layer, int* ns, int* kc) {
  static const int plan[2][5][2] = {
      {{BxPlan0::NS, BxPlan0::KC}, {BxPlan1::NS, BxPlan1::KC},
       {BxPlan2::NS, BxPlan2::KC}, {BxPlan2::NS, BxPlan2::KC},
       {BxPlan4::NS, BxPlan4::KC}},
      {{HxPlan0::NS, HxPlan0::KC}, {HxPlan0::NS, HxPlan0::KC},
       {HxPlan2::NS, HxPlan2::KC}, {HxPlan3::NS, HxPlan3::KC},
       {HxPlan4::NS, HxPlan4::KC}}};
  if (which < 0 || which > 1 || layer < 0 || layer > 4)
    return (int)cudaErrorInvalidValue;
  *ns = plan[which][layer][0];
  *kc = plan[which][layer][1];
  return 0;
}

extern "C" long long fused_backbone_f32_smem_bytes(int l) {
  return (long long)backbone_f32_smem(l, f32_tile(l, backbone_f32_smem));
}

extern "C" long long fused_head_f32_smem_bytes(int l4) {
  return (long long)head_f32_smem(l4, f32_tile(l4, head_f32_smem));
}

// cut (n, l) f32 -> feats (n, l/4, 256) f32; convs: the 12 pointers of
// layer 1's (w (3, 64), b) and of the five wgmma convs' (w, b), each w laid
// out by int8_tiles.plan_weights_f32
extern "C" int fused_backbone_f32_launch(const void* cut,
                                         const void* const* convs,
                                         void* feats, int n, int l,
                                         void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const int T = f32_tile(l, backbone_f32_smem);
  const size_t smem = backbone_f32_smem(l, T);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)backbone_x3_kernel, smem);
  if (err) return err;
  BackboneF32 bw;
  bw.w1 = (const float*)convs[0];
  bw.b1 = (const float*)convs[1];
  for (int i = 0; i < 5; ++i) {
    bw.w[i] = (const int8_t*)convs[2 * i + 2];
    bw.b[i] = (const float*)convs[2 * i + 3];
  }
  backbone_x3_kernel<<<(n + T - 1) / T, kWgThreads, smem,
                       (cudaStream_t)stream>>>(
      (const float*)cut, bw, (float*)feats, n, l, T,
      (int)backbone_f32_region(l, T));
  return (int)cudaGetLastError();
}

// feats (n, l4, 256) f32 -> cls (n, nc), reg (n, 2) f32; convs: the 10
// pointers (w, b) of the five head convs, each w laid out by
// int8_tiles.plan_weights_f32; wc (128, nc), wr (128, 2) f32
extern "C" int fused_head_f32_launch(const void* feats,
                                     const void* const* convs, const void* wc,
                                     const void* bc, const void* wr,
                                     const void* br, void* cls, void* reg,
                                     int n, int l4, int nc, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const int T = f32_tile(l4, head_f32_smem);
  const size_t smem = head_f32_smem(l4, T);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)head_x3_kernel, smem);
  if (err) return err;
  HeadF32 hw;
  for (int i = 0; i < 5; ++i) {
    hw.w[i] = (const int8_t*)convs[2 * i];
    hw.b[i] = (const float*)convs[2 * i + 1];
  }
  hw.wc = (const float*)wc;
  hw.bc = (const float*)bc;
  hw.wr = (const float*)wr;
  hw.br = (const float*)br;
  head_x3_kernel<<<(n + T - 1) / T, kWgThreads, smem,
                   (cudaStream_t)stream>>>(
      (const float*)feats, hw, (float*)cls, (float*)reg, n, l4, nc, T,
      (int)head_f32_region(l4, T));
  return (int)cudaGetLastError();
}
