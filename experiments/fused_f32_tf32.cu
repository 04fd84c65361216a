// K14 in f32 on 3xTF32 wgmma products: the route the f32 fused DROW
// backbone and head took before csrc/fused_f32.cu (split bf16), kept so that
// the two can be timed in one run. experiments/torch_fused_f32_tf32.py
// builds this file against the package's csrc/ headers, lays out its f32
// weights (tf32_weights there: one k8 step a chunk) and times it beside the
// shipped kernels. No module of the package loads it.
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
// Products: 3xTF32. The tensor core takes tf32 operands: f32 values whose
// low 13 mantissa bits are clear. Each operand x splits into hi = x with
// those bits cleared and lo = (x - hi, exact in f32) with them cleared, and
// a * b is taken as hi * hi + hi * lo + lo * hi (lo * lo, ~2^-20 relative,
// is dropped) by three wgmma.mma_async m64nNk8 .f32.tf32.tf32 products into
// one f32 accumulator: ~3e-6 relative a product, against the rtol 1e-3 the
// JAX test holds the f32 kernels to, which one TF32 product (2^-11) misses.
// Layer 1 (Cin = 1) stays per position in FFMA. The epilogue is leaky(acc +
// b) in f32; a max-pool is taken on the sums (the epilogue is monotone, so
// it gives the same value).
//
// Layout: wgmma_conv.cuh's packed, channel-block-major tile of cutouts (4
// f32 channels a 16-byte block, the tap a row offset, the pool pair an even
// row and the next one), its weight chunks in descriptor order (chunk_of)
// and its no-swizzle K-major descriptors, with four changes. They change the
// conv's main loop, so this conv is its own (conv_tf32) and wgmma_conv.cuh,
// which builds K4, K5, K7, K9 and K10, is not touched:
// * A staged a chunk at a time. A chunk is one k8 step; before its barrier
//   all threads copy the A slice it multiplies (the group's 64-row tiles,
//   its tap and 8 channels) from the f32 tile into a 3-stage ring, split
//   into hi and lo, so that every product reads both operands from shared
//   memory. A lo copy of the whole tile would not fit; A from registers
//   (split as the fragment is loaded) was tried: ptxas serialized its
//   products (C7513), because the next chunk's fragment is written while the
//   last one's products run.
// * The weights split in shared memory. A chunk is one k8 step of NS
//   output channels (NS x 32 bytes). The producer's threads copy their own
//   pieces of each chunk by cp.async into a ring of raw stages, DR chunks
//   ahead of use, and when they land split the same pieces into the
//   chunk's split stage, hi and lo; a raw stage is its thread's alone, so
//   it is free again at once. The f32 weights cross L2 once a block; their
//   lo parts never leave the SM.
// * A producer warp group. Splitting both operands is ~160 instructions a
//   thread a chunk when all 256 threads of the two MMA warp groups share it
//   between barriers, more than the chunk's ~384 cycles of products: a
//   third warp group does it and signals each staged chunk on a named
//   barrier (FULL), the MMA warp groups free each stage on another (EMPTY).
//   The products then wait for nothing but the tensor cores. (K4/K5/K7 have
//   no producer because ptxas caps a 384-thread block at 168 registers; the
//   MMA warp groups here need ~155.)
// * Tight tiles. A tile's channel blocks lie T * S + 2 rows apart (the rows
//   that hold data) instead of the extent of its 64-row tiles; the rows a
//   64-row tile reads past them belong to dropped output rows and read the
//   next channel block, or, past the last block, a spill kept in the region.
//   This halves the head's 512-channel tile at 7 positions (34 rows, not
//   66), so that 4 cutouts fit a block beside the rings.
// T = 4 cutouts a block at the flagship lengths (L = 56, L/4 = 14): the
// backbone's 4 and 2 row tiles alternate between the two warp groups; the
// head's one row tile is shared by both, each taking half of N (WGN = 2).
// Every product is issued unconditionally (a warp group past the last row
// tile multiplies the last one again and drops it): a wgmma on a divergent
// path is serialized.
//
// Bound: tensor-core operations. At L = 56, 15.2 MFLOP a cutout for the
// backbone and 28.9 MFLOP for the head, three times over in TF32 at 495
// TFLOP/s dense; each block streams the f32 weights (0.93 MB backbone, 5.11
// MB head) from L2.

#include "wgmma_conv.cuh"

namespace {

constexpr int kF32Tile = 4;                  // most cutouts a block
constexpr uint32_t kTf32Bits = 0xffffe000u;  // the bits a tf32 value keeps

__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & kTf32Bits);
}
__device__ __forceinline__ float tf32_lo(float x, float hi) {
  return tf32_hi(__fsub_rn(x, hi));
}
__device__ __forceinline__ void split4(const float4 x, float4& h, float4& l) {
  h = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
  l = make_float4(tf32_lo(x.x, h.x), tf32_lo(x.y, h.y), tf32_lo(x.z, h.z),
                  tf32_lo(x.w, h.w));
}

// rows of a channel block of a tight tile: T cutouts, their zero rows and
// row 0
__host__ __device__ constexpr int trows(int l, int T) {
  return T * pstride(l) + 2;
}
// bytes of a tight tile of c f32 channels: its rows, and the rows the last
// channel block's 64-row tiles read past them
__host__ __device__ constexpr int ttile_bytes(int l, int c, int T) {
  return trows(l, T) * c * 4 + (m_tiles(l, T) * 64 + 2 - trows(l, T)) * 16;
}

// one conv's place in the kernel's plan (the shipped kernels' plans,
// int8_tiles.FUSED_BACKBONE_F32_PLAN and FUSED_HEAD_F32_PLAN): MT row
// tiles x NJ n64 tiles a warp group, WGN warp groups along N (as
// wgmma_conv.cuh's ConvPlan); a chunk is one k8 step
template <int CIN, int COUT, int MT, int NJ, int WGN>
struct Tf32Plan {
  static constexpr int NW = 64 * NJ;   // channels a warp group's product
  static constexpr int NS = NW * WGN;  // output channels a pass
  static constexpr int K = 3 * CIN;
  static constexpr int KC = 8;         // K a chunk: one instruction
  static constexpr int NKC = K / KC;   // chunks a pass
  static constexpr int NSL = COUT / NS;  // passes a row group
  static constexpr int CHUNK = NS * KC * 4;  // bytes a chunk
  static constexpr int GT = WGN == 1 ? 2 * MT : MT;  // row tiles a group
  static constexpr int ABYTES = GT * 64 * KC * 4 * 2;  // A's hi + lo a chunk
  static_assert(WGN == 1 || WGN == 2, "plan");
  static_assert(CIN % KC == 0 && COUT % NS == 0, "plan");
  __host__ __device__ static int groups(int l, int T) {
    return (m_tiles(l, T) + GT - 1) / GT;
  }
};

// D (64 x N) += A (64 x 8 tf32) * B (8 x N tf32), both K-major through
// descriptors; scale-a 1, scale-b 1 (tf32 takes no transpose)
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           uint64_t desc_a, uint64_t desc_b);
WG_MMA(wgmma_tf32, float, "+f", 64, 32, "m64n64k8.f32.tf32.tf32", "32",
       "33", "34", ", 1, 1")
WG_MMA(wgmma_tf32, float, "+f", 128, 64, "m64n128k8.f32.tf32.tf32", "64",
       "65", "66", ", 1, 1")

// ---- roles and barriers ------------------------------------------------
// A block is three warp groups: 0 and 1 issue the products and run the
// epilogues (the consumers), 2 feeds them (the producer): it copies the
// weights, splits them and A's slices into hi and lo, and signals each
// staged chunk on a named barrier. The roles are whole warp groups, so no
// product sits on a path that only some threads of a warp group take.

constexpr int kF32Threads = 384;
constexpr int kConsumers = 256;  // warp groups 0 and 1
constexpr int kProducer = 128;   // warp group 2
constexpr int kSplit = 3;        // split stages (weights and A)
// named barriers: 1 + s, stage s staged (FULL); 1 + kSplit + s, stage s
// free (EMPTY); 0 is __syncthreads
constexpr int kFull0 = 1, kEmpty0 = 1 + kSplit;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- the weights: the producer's raw ring and the split stages ---------
// Each producer thread copies its own 16-byte pieces of every chunk (piece
// o = 16 * (thread + 128 v)) into a ring of DR raw stages of RSB bytes, DR
// chunks ahead of use, and splits the same pieces when they land: hi and lo
// into the chunk's split stage (kSplit stages of 2 RSB bytes: hi, then lo
// at RSB). No thread reads another's raw pieces, so a raw stage is free
// again once its owner has split it.

struct Tf32Ring {
  int8_t* raw;        // DR x RSB
  int8_t* bst;        // kSplit x 2 RSB
  const int8_t* any;  // a global address the zero-size copies name
  int i;              // chunks used
};

// A producer thread: copy its pieces of chunk j (sched names it; zeros past
// the chunk's bytes and past the last chunk) into raw stage j % DR, one
// cp.async group.
template <int RSB, int DR, class Sched>
__device__ __forceinline__ void stage_raw(const Tf32Ring& r,
                                          const Sched& sched, int j, int pt) {
  const int8_t* src = r.any;
  int bytes = 0;
  sched(j, src, bytes);
  int8_t* dst = r.raw + (size_t)(j % DR) * RSB;
#pragma unroll
  for (int v = 0; v < RSB / (16 * kProducer); ++v) {
    const int o = 16 * (pt + v * kProducer);
    const bool in = o < bytes;
    cp_async16(dst + o, in ? src + o : r.any, in ? 16 : 0);
  }
  cp_async_commit();
}

// The ring at `smem` (raw stages, then split stages); the producer (pt its
// thread, or -1) puts the kernel's first DR chunks on their way.
template <int RSB, int DR, class Sched>
__device__ __forceinline__ Tf32Ring ring_start_tf32(unsigned char* smem,
                                                    const Sched& sched,
                                                    int pt) {
  Tf32Ring r;
  r.raw = reinterpret_cast<int8_t*>(smem);
  r.bst = r.raw + DR * RSB;
  int bytes;
  sched(0, r.any, bytes);
  r.i = 0;
  if (pt >= 0)
    for (int j = 0; j < DR; ++j) stage_raw<RSB, DR>(r, sched, j, pt);
  return r;
}

// ---- the conv -----------------------------------------------------------

enum Tf32Epilogue {
  kTfStore = 0,     // into a tight tile of the same length
  kTfPool = 1,      // pooled, into a tight tile of length L / 2
  kTfPoolRows = 2,  // pooled rows (cutout c0 + c, L / 2, COUT) into device
                    // memory
  kTfRows = 3,      // rows (c, L, COUT) into shared memory
};

// One k=3 SAME conv over the tight tile `in` of the block's T cutouts (nv of
// them real, the first one cutout c0; CIN f32 channels, length L) -> `out`
// as EPI says; every thread of the block calls it, wg its warp group.
//
// Chunk c (one k8 step of NS output channels) goes through split stage s =
// c % kSplit. The producer waits for the stage to be free (EMPTY[s], from
// chunk c - kSplit), splits its pieces of the weights from the raw ring
// into it (raw stages of RSB bytes, DR deep; sched names the kernel's
// chunks, chunk_of<Tf32Plan<...>> this conv's) and puts chunk c + DR on
// its way, splits A's slice (the group's 64-row tiles, the chunk's tap and
// 8 channels) into A stage s of `as` (AST bytes a stage), fences, and
// arrives on FULL[s]. The consumers wait on FULL[s], issue the products of
// both halves (hi * hi, hi * lo, lo * hi), and, once the wait before the
// next chunk has retired those of chunk c - 1, free its stage. The bias is
// copied to shared memory (sb) first. No product is issued under a branch
// that depends on the data: a warp group past the last row tile multiplies
// the last one again and drops the result.
template <int CIN, int COUT, int MT, int NJ, int EPI, int WGN, int RSB,
          int DR, int AST, class Sched>
__device__ __forceinline__ void conv_tf32(const float* in, float* out, int L,
                                          int T, int nv, int c0, int wg,
                                          Tf32Ring& ring, const Sched& sched,
                                          float* as, float* sb,
                                          const float* __restrict__ bias) {
  using P = Tf32Plan<CIN, COUT, MT, NJ, WGN>;
  static_assert(P::CHUNK <= RSB && P::ABYTES <= AST, "plan");
  constexpr int RA = P::GT * 64;  // rows of a staged A slice
  const int S = pstride(L), L2 = L / 2, rows = trows(L, T);
  const int tiles = m_tiles(L, T), groups = P::groups(L, T);

  for (int i = threadIdx.x; i < COUT; i += kF32Threads) sb[i] = bias[i];
  __syncthreads();
  if (wg == 2) {  // the producer
    const int pt = threadIdx.x - kConsumers;
    for (int grp = 0; grp < groups; ++grp)
      for (int ns = 0; ns < P::NSL; ++ns, ring.i += P::NKC)
        for (int kc = 0; kc < P::NKC; ++kc) {
          const int c = ring.i + kc, s = c % kSplit;
          if (c >= kSplit) bar_sync(kEmpty0 + s, kF32Threads);
          // the weights: this thread's pieces, split; chunk c + DR copied
          cp_async_wait<DR - 1>();
          const int8_t* raw = ring.raw + (size_t)(c % DR) * RSB;
          int8_t* st = ring.bst + (size_t)s * 2 * RSB;
#pragma unroll
          for (int v = 0; v < RSB / (16 * kProducer); ++v) {
            const int o = 16 * (pt + v * kProducer);
            float4 h, l;
            split4(*reinterpret_cast<const float4*>(raw + o), h, l);
            *reinterpret_cast<float4*>(st + o) = h;
            *reinterpret_cast<float4*>(st + RSB + o) = l;
          }
          stage_raw<RSB, DR>(ring, sched, c + DR, pt);
          // A's slice: [16-byte K block][row][4 floats], hi then lo
          const int tap = kc * 8 / CIN, ch = kc * 8 - tap * CIN;
          float* sa = as + (size_t)s * (AST / 4);
#pragma unroll
          for (int v = 0; v < 2 * RA / kProducer; ++v) {
            const int q = pt + v * kProducer;  // 16-byte block of the slice
            const int kb = q / RA, r = q - kb * RA;
            const int t = min(grp * P::GT + r / 64, tiles - 1);
            float4 h, l;
            split4(*reinterpret_cast<const float4*>(packed_at(
                       in, rows, t * 64 + (r & 63) + tap, ch + 4 * kb)),
                   h, l);
            *reinterpret_cast<float4*>(sa + (size_t)q * 4) = h;
            *reinterpret_cast<float4*>(sa + (size_t)(2 * RA + q) * 4) = l;
          }
          fence_async_shared();
          bar_arrive(kFull0 + s, kF32Threads);
        }
    return;
  }

  // the consumers
  const int wq = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  // this warp group's channels of a pass, and its B operand's first bytes
  const int n_wg = WGN == 2 ? wg * P::NW : 0;
  // descriptors of split stage 0 and A stage 0 (a stage is a multiple of
  // 16 bytes further: its descriptor that many 16-byte units more)
  const uint64_t bh0 = gmma_desc(ring.bst + n_wg * 16, P::NS * 16, 128);
  const uint64_t bl0 = bh0 + (RSB >> 4);
  for (int grp = 0; grp < groups; ++grp) {
    // row tiles of this warp group: grp * 2MT + 2i + wg, or (WGN = 2)
    // grp * MT + i; the slot of each in the staged slice
    int m0[MT];
    bool live[MT];
    uint64_t ah0[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int slot = WGN == 1 ? 2 * i + wg : i;
      const int t = grp * P::GT + slot;
      live[i] = t < tiles;
      m0[i] = min(t, tiles - 1) * 64;
      ah0[i] = gmma_desc(as + slot * 64 * 4, RA * 16, 128);
    }
    for (int ns = 0; ns < P::NSL; ++ns) {
      float acc[MT][NJ * 32];  // n8 block b of row tile i: acc[i][4b ..]
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < NJ * 32; ++e) acc[i][e] = 0.0f;

      wgmma_fence();
      for (int kc = 0; kc < P::NKC; ++kc) {
        const int c = ring.i + kc, s = c % kSplit;
        bar_sync(kFull0 + s, kF32Threads);
        const uint64_t bo = (uint64_t)(s * 2 * RSB) >> 4;
        const uint64_t ao = (uint64_t)(s * AST) >> 4;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const uint64_t ah = ah0[i] + ao, al = ah + (RA * 32 >> 4);
          wgmma_tf32<P::NW>(acc[i], ah, bh0 + bo);
          wgmma_tf32<P::NW>(acc[i], ah, bl0 + bo);
          wgmma_tf32<P::NW>(acc[i], al, bh0 + bo);
        }
        wgmma_commit();
        if (kc > 0) {
          wgmma_wait<1>();
          bar_arrive(kEmpty0 + (c - 1) % kSplit, kF32Threads);
        }
      }
      wgmma_wait<0>();
      ring.i += P::NKC;
      bar_arrive(kEmpty0 + (ring.i - 1) % kSplit, kF32Threads);

      // epilogue: this thread's rows g and g + 8 of each 16-row slab
      constexpr bool kPooled = EPI == kTfPool || EPI == kTfPoolRows;
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
                // odd one column n + 1, into output position p / 2
                const int odd = g & 1;
                const float v = fmaxf(
                    odd ? v1 : v0, __shfl_xor_sync(kFull, odd ? v0 : v1, 4));
                if (!keep) continue;
                const int col = n + odd;
                const float y = leaky(__fadd_rn(v, sb[col]));
                const int r = p / 2;
                if (EPI == kTfPool)
                  *packed_at(out, trows(L2, T), c * pstride(L2) + 1 + r,
                             col) = y;
                else
                  out[((size_t)(c0 + c) * L2 + r) * COUT + col] = y;
                continue;
              }
              if (!keep) continue;
              const float2 y = make_float2(leaky(__fadd_rn(v0, sb[n])),
                                           leaky(__fadd_rn(v1, sb[n + 1])));
              if (EPI == kTfStore)
                *reinterpret_cast<float2*>(packed_at(out, rows, m + 1, n)) =
                    y;
              else
                *reinterpret_cast<float2*>(out + ((size_t)c * L + p) * COUT +
                                           n) = y;
            }
        }
    }
  }
}

// Rows (n * L, C) f32 of cutouts c0 .. c0 + nv - 1 from device memory into
// a zeroed tight tile
template <int C>
__device__ __forceinline__ void load_tight(const float* __restrict__ src,
                                           float* tile, int c0, int nv,
                                           int L, int T) {
  constexpr int V = C / 4;  // 16-byte vectors a row
  const int S = pstride(L), rows = trows(L, T);
  for (int idx = threadIdx.x; idx < nv * L * V; idx += kF32Threads) {
    const int r = idx / V, v = idx - r * V;  // r: row of the block's cutouts
    const int c = r / L, p = r - c * L;
    *reinterpret_cast<float4*>(packed_at(tile, rows, c * S + 1 + p, 4 * v)) =
        reinterpret_cast<const float4*>(src + ((size_t)c0 * L + r) * C)[v];
  }
}

// Layer 1 (Cin = 1) of cutouts c0 .. c0 + nv - 1 into a zeroed tight tile of
// 64 channels: acc = ((xl * w0 + x * w1) + xr * w2) + b over the taps of
// position p (zero beyond the cutout), then leaky; 4 channels a thread,
// consecutive positions on consecutive threads. w: (3, 64), b: (64,).
__device__ __forceinline__ void layer1_tight(const float* __restrict__ cut,
                                             float* tile, int c0, int nv,
                                             int L, int T,
                                             const float* __restrict__ w,
                                             const float* __restrict__ b) {
  const int S = pstride(L), rows = trows(L, T), nr = nv * L;
  for (int idx = threadIdx.x; idx < 16 * nr; idx += kF32Threads) {
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
    *reinterpret_cast<float4*>(packed_at(tile, rows, c * S + 1 + p, 4 * q)) =
        make_float4(tap3(w0.x, w1.x, w2.x, bb.x), tap3(w0.y, w1.y, w2.y, bb.y),
                    tap3(w0.z, w1.z, w2.z, bb.z),
                    tap3(w0.w, w1.w, w2.w, bb.w));
  }
}

// ---- the kernels --------------------------------------------------------

// the plans, (Cin, Cout, row tiles, n64 tiles, warp groups along N); a
// chunk of each is 384 cycles of the SM's tensor cores (the head's last
// 192) at T = 4; the same plans as csrc/fused_f32.cu's.
using BtPlan0 = Tf32Plan<64, 64, 2, 1, 1>;    // conv 2: 4 row tiles at 56
using BtPlan1 = Tf32Plan<64, 128, 2, 1, 1>;   // conv 3, pool: two passes
using BtPlan2 = Tf32Plan<128, 128, 1, 2, 1>;  // convs 4, 5: 2 row tiles
using BtPlan4 = Tf32Plan<128, 256, 1, 2, 1>;  // conv 6, pool: two passes
using HtPlan0 = Tf32Plan<256, 256, 1, 2, 2>;  // convs 1, 2: one row tile
using HtPlan2 = Tf32Plan<256, 512, 1, 2, 2>;  // conv 3, pool: two passes
using HtPlan3 = Tf32Plan<512, 256, 1, 2, 2>;
using HtPlan4 = Tf32Plan<256, 128, 1, 1, 2>;

// Each kernel's raw stage (its largest chunk), raw ring depth and A stage
// (bytes): the backbone's chunks are at most 4 KB (128 channels) and its
// groups 4 row tiles, the head's 8 KB and 1 row tile; the depths fill the
// shared memory the tiles leave.
constexpr int kBbRaw = 4096, kBbDepth = 7, kBbA = 16384;
constexpr int kHdRaw = 8192, kHdDepth = 3, kHdA = 4096;
constexpr int kBiasBytes = 2048;  // a conv's bias (at most 512 f32)
// where a kernel's tile regions start: after the raw ring, the split
// stages, the bias and the A stages
__host__ __device__ constexpr int tiles_at(int rsb, int dr, int ast) {
  return dr * rsb + kSplit * 2 * rsb + kBiasBytes + kSplit * ast;
}

struct BackboneF32 {
  const float* w1;     // layer 1 (3, 64)
  const float* b1;
  const int8_t* w[5];  // convs 2-6, laid out by tf32_weights
  const float* b[5];
};

struct HeadF32 {
  const int8_t* w[5];  // laid out by tf32_weights
  const float* b[5];
  const float* wc;     // (128, nc)
  const float* bc;
  const float* wr;     // (128, 2)
  const float* br;
};

// a block's tile region (each of two)
size_t backbone_f32_region(int l, int T) {
  return round128(imax(ttile_bytes(l, 64, T), ttile_bytes(l / 2, 128, T)));
}
size_t backbone_f32_smem(int l, int T) {
  return tiles_at(kBbRaw, kBbDepth, kBbA) + 2 * backbone_f32_region(l, T);
}
size_t head_f32_region(int l4, int T) {
  return round128(imax(imax(ttile_bytes(l4, 256, T),
                            ttile_bytes(l4 / 2, 512, T)),
                       T * (l4 / 2) * 128 * 4));
}
size_t head_f32_smem(int l4, int T) {
  return tiles_at(kHdRaw, kHdDepth, kHdA) + 2 * head_f32_region(l4, T) +
         (size_t)T * 128 * 4;
}

// cutouts a block: the most (kF32Tile, halved) whose shared memory fits
template <class F>
int f32_tile(int l, F smem_of) {
  int T = kF32Tile;
  while (T > 1 && smem_of(l, T) > kSmemMax) T /= 2;
  return T;
}

// Shared memory: the weight ring (raw and split stages), the bias, the A
// stages, two tile regions of R bytes.
__global__ void __launch_bounds__(kF32Threads, 1)
    backbone_tf32_kernel(const float* __restrict__ cut,
                         const __grid_constant__ BackboneF32 bw,
                         float* __restrict__ feats, int n, int L, int T,
                         int R) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kAt = tiles_at(kBbRaw, kBbDepth, kBbA);
  float* sb = reinterpret_cast<float*>(smem_raw + (kBbDepth + 2 * kSplit) *
                                                      kBbRaw);
  float* as = sb + kBiasBytes / 4;
  float* bufa = reinterpret_cast<float*>(smem_raw + kAt);
  float* bufb = reinterpret_cast<float*>(smem_raw + kAt + R);
  const int c0 = blockIdx.x * T;
  const int nv = min(T, n - c0);
  const int L2 = L / 2;
  // the warp group, uniform across the warp; the producer's own thread
  const int wg = __shfl_sync(kFull, threadIdx.x / 128, 0);
  const int pt = wg == 2 ? threadIdx.x - kConsumers : -1;
  // the weight chunks of the five wgmma convs, in the order they are used
  auto sched = [&](int j, const int8_t*& src, int& bytes) {
    return chunk_of<BtPlan0>(j, bw.w[0], L, T, src, bytes) ||
           chunk_of<BtPlan1>(j, bw.w[1], L, T, src, bytes) ||
           chunk_of<BtPlan2>(j, bw.w[2], L2, T, src, bytes) ||
           chunk_of<BtPlan2>(j, bw.w[3], L2, T, src, bytes) ||
           chunk_of<BtPlan4>(j, bw.w[4], L2, T, src, bytes);
  };
  int8_t* za = reinterpret_cast<int8_t*>(bufa);
  int8_t* zb = reinterpret_cast<int8_t*>(bufb);

  Tf32Ring ring = ring_start_tf32<kBbRaw, kBbDepth>(smem_raw, sched, pt);
  zero_smem(za, R);
  zero_smem(zb, R);
  __syncthreads();
  layer1_tight(cut, bufa, c0, nv, L, T, bw.w1, bw.b1);
  __syncthreads();
  conv_tf32<64, 64, 2, 1, kTfStore, 1, kBbRaw, kBbDepth, kBbA>(
      bufa, bufb, L, T, nv, c0, wg, ring, sched, as, sb, bw.b[0]);
  __syncthreads();
  zero_smem(za, R);
  __syncthreads();
  conv_tf32<64, 128, 2, 1, kTfPool, 1, kBbRaw, kBbDepth, kBbA>(
      bufb, bufa, L, T, nv, c0, wg, ring, sched, as, sb, bw.b[1]);
  __syncthreads();
  zero_smem(zb, R);
  __syncthreads();
  conv_tf32<128, 128, 1, 2, kTfStore, 1, kBbRaw, kBbDepth, kBbA>(
      bufa, bufb, L2, T, nv, c0, wg, ring, sched, as, sb, bw.b[2]);
  __syncthreads();
  zero_smem(za, R);
  __syncthreads();
  conv_tf32<128, 128, 1, 2, kTfStore, 1, kBbRaw, kBbDepth, kBbA>(
      bufb, bufa, L2, T, nv, c0, wg, ring, sched, as, sb, bw.b[3]);
  __syncthreads();
  conv_tf32<128, 256, 1, 2, kTfPoolRows, 1, kBbRaw, kBbDepth, kBbA>(
      bufa, feats, L2, T, nv, c0, wg, ring, sched, as, sb, bw.b[4]);
  cp_async_wait<0>();
}

// Shared memory: the weight ring (raw and split stages), the bias, the A
// stages, two tile regions of R bytes, the means (T x 128 f32).
__global__ void __launch_bounds__(kF32Threads, 1)
    head_tf32_kernel(const float* __restrict__ feats,
                     const __grid_constant__ HeadF32 hw,
                     float* __restrict__ cls, float* __restrict__ reg, int n,
                     int L4, int nc, int T, int R) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kAt = tiles_at(kHdRaw, kHdDepth, kHdA);
  float* sb = reinterpret_cast<float*>(smem_raw + (kHdDepth + 2 * kSplit) *
                                                      kHdRaw);
  float* as = sb + kBiasBytes / 4;
  float* bufa = reinterpret_cast<float*>(smem_raw + kAt);
  float* bufb = reinterpret_cast<float*>(smem_raw + kAt + R);
  float* means = reinterpret_cast<float*>(smem_raw + kAt + 2 * R);
  const int c0 = blockIdx.x * T;
  const int nv = min(T, n - c0);
  const int L8 = L4 / 2;
  const int wg = __shfl_sync(kFull, threadIdx.x / 128, 0);
  const int pt = wg == 2 ? threadIdx.x - kConsumers : -1;
  auto sched = [&](int j, const int8_t*& src, int& bytes) {
    return chunk_of<HtPlan0>(j, hw.w[0], L4, T, src, bytes) ||
           chunk_of<HtPlan0>(j, hw.w[1], L4, T, src, bytes) ||
           chunk_of<HtPlan2>(j, hw.w[2], L4, T, src, bytes) ||
           chunk_of<HtPlan3>(j, hw.w[3], L8, T, src, bytes) ||
           chunk_of<HtPlan4>(j, hw.w[4], L8, T, src, bytes);
  };
  int8_t* za = reinterpret_cast<int8_t*>(bufa);
  int8_t* zb = reinterpret_cast<int8_t*>(bufb);

  Tf32Ring ring = ring_start_tf32<kHdRaw, kHdDepth>(smem_raw, sched, pt);
  zero_smem(za, R);
  zero_smem(zb, R);
  __syncthreads();
  load_tight<256>(feats, bufa, c0, nv, L4, T);
  __syncthreads();
  conv_tf32<256, 256, 1, 2, kTfStore, 2, kHdRaw, kHdDepth, kHdA>(
      bufa, bufb, L4, T, nv, c0, wg, ring, sched, as, sb, hw.b[0]);
  __syncthreads();
  zero_smem(za, R);
  __syncthreads();
  conv_tf32<256, 256, 1, 2, kTfStore, 2, kHdRaw, kHdDepth, kHdA>(
      bufb, bufa, L4, T, nv, c0, wg, ring, sched, as, sb, hw.b[1]);
  __syncthreads();
  zero_smem(zb, R);
  __syncthreads();
  conv_tf32<256, 512, 1, 2, kTfPool, 2, kHdRaw, kHdDepth, kHdA>(
      bufa, bufb, L4, T, nv, c0, wg, ring, sched, as, sb, hw.b[2]);
  __syncthreads();
  zero_smem(za, R);
  __syncthreads();
  conv_tf32<512, 256, 1, 2, kTfStore, 2, kHdRaw, kHdDepth, kHdA>(
      bufb, bufa, L8, T, nv, c0, wg, ring, sched, as, sb, hw.b[3]);
  __syncthreads();
  // the last conv's f32 rows into the free region
  float* fout = bufb;
  conv_tf32<256, 128, 1, 1, kTfRows, 2, kHdRaw, kHdDepth, kHdA>(
      bufa, fout, L8, T, nv, c0, wg, ring, sched, as, sb, hw.b[4]);
  __syncthreads();

  // the mean over positions: a running sum times the f32 reciprocal of L8
  for (int idx = threadIdx.x; idx < nv * 128; idx += kF32Threads) {
    const int c = idx >> 7, ch = idx & 127;
    const float* f = fout + (size_t)c * L8 * 128 + ch;
    float s = f[0];
    for (int r = 1; r < L8; ++r) s += f[r * 128];
    means[idx] = s * (1.0f / (float)L8);
  }
  __syncthreads();

  // cls / reg: the means @ the f32 linears, + bias
  for (int idx = threadIdx.x; idx < nv * (nc + 2); idx += kF32Threads) {
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
  cp_async_wait<0>();  // the empty groups past the last chunk
}

}  // namespace

// The launch geometry of the f32 backbone (which = 0, l the cutout length)
// or head (1, l = L/4): cutouts a block, rows a cutout in the packed tile
// and dynamic shared memory (bytes)
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
// tf32_weights lays out
extern "C" int fused_f32_plan(int which, int layer, int* ns, int* kc) {
  static const int plan[2][5] = {
      {BtPlan0::NS, BtPlan1::NS, BtPlan2::NS, BtPlan2::NS, BtPlan4::NS},
      {HtPlan0::NS, HtPlan0::NS, HtPlan2::NS, HtPlan3::NS, HtPlan4::NS}};
  if (which < 0 || which > 1 || layer < 0 || layer > 4)
    return (int)cudaErrorInvalidValue;
  *ns = plan[which][layer];
  *kc = BtPlan0::KC;
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
// out by tf32_weights
extern "C" int fused_backbone_f32_launch(const void* cut,
                                         const void* const* convs,
                                         void* feats, int n, int l,
                                         void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const int T = f32_tile(l, backbone_f32_smem);
  const size_t smem = backbone_f32_smem(l, T);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)backbone_tf32_kernel, smem);
  if (err) return err;
  BackboneF32 bw;
  bw.w1 = (const float*)convs[0];
  bw.b1 = (const float*)convs[1];
  for (int i = 0; i < 5; ++i) {
    bw.w[i] = (const int8_t*)convs[2 * i + 2];
    bw.b[i] = (const float*)convs[2 * i + 3];
  }
  backbone_tf32_kernel<<<(n + T - 1) / T, kF32Threads, smem,
                         (cudaStream_t)stream>>>(
      (const float*)cut, bw, (float*)feats, n, l, T,
      (int)backbone_f32_region(l, T));
  return (int)cudaGetLastError();
}

// feats (n, l4, 256) f32 -> cls (n, nc), reg (n, 2) f32; convs: the 10
// pointers (w, b) of the five head convs, each w laid out by
// tf32_weights; wc (128, nc), wr (128, 2) f32
extern "C" int fused_head_f32_launch(const void* feats,
                                     const void* const* convs, const void* wc,
                                     const void* bc, const void* wr,
                                     const void* br, void* cls, void* reg,
                                     int n, int l4, int nc, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const int T = f32_tile(l4, head_f32_smem);
  const size_t smem = head_f32_smem(l4, T);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)head_tf32_kernel, smem);
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
  head_tf32_kernel<<<(n + T - 1) / T, kF32Threads, smem,
                     (cudaStream_t)stream>>>(
      (const float*)feats, hw, (float*)cls, (float*)reg, n, l4, nc, T,
      (int)head_f32_region(l4, T));
  return (int)cudaGetLastError();
}
