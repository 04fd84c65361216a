// The int8 conv of K5 (with its K9/K10 modes) and K7 for Hopper: wgmma s8
// products on weights staged in shared memory, over a packed tile of
// kWgTile cutouts.
//
// Packed tile. A block keeps its cutouts' activations in shared memory.
// Cutout c's position p sits in row c * S + 1 + p with S = pstride(L) = L +
// 1 rounded up to even: every cutout is followed by one or two zero rows,
// and row 0 is zero. A k=3 SAME conv is one product over K = 3 * Cin whose
// A row m reads rows m, m + 1, m + 2; row m = c * S + p is output position
// p of cutout c, and the rows with p >= L (they read a neighbour's rows)
// are computed and dropped. Cutouts run back to back, so a 64-row wgmma
// tile spans several of them: the head's 7-position stage uses 7 of every 8
// rows, not 7 of 16. S is even, so the max-pool pair (2r, 2r + 1) of a
// cutout is an even row and the next one: rows g and g + 1 of one lane quad
// of the accumulator, one shuffle apart. The tile is stored channel-block
// major: channels 16b .. 16b + 15 of all its rows, 16 bytes a row, then the
// next block (packed_at). So any 8 consecutive rows of a block are one
// 128-byte core matrix of a no-swizzle K-major wgmma operand, and the tap t
// is the operand's start row plus t (a swizzled layout could not start at
// any row).
//
// Products. wgmma.mma_async m64nNk32 s8 x s8 -> s32 (exact), N = 64 NJ of
// 64, 128 or 256, A (64 rows x 32 bytes of K) straight from the tile and B
// (N output channels x 32 bytes of K, K-major) from the staged weights, both
// through no-swizzle descriptors. A warp group holds MT 64-row tiles x N
// channels of accumulators, so each staged weight byte feeds MT x 64 rows.
// A chunk's products are one commit group; a warp group keeps two in
// flight and waits only where the ring needs a stage back.
//
// Weights through shared memory. Each conv's weights come laid out by the
// host (int8_tiles.wgmma_weights) in chunks of NS = 64 * NJ output channels
// x KC bytes of K, each chunk the core-matrix order the descriptor reads
// ([k16 block][n8 group][8 rows][16 bytes]: the core matrices along N
// adjacent, as along M in the tile) and contiguous. Every chunk of
// every conv of the kernel streams, in the order the warp groups use them,
// through a ring of kStages stages: all 256 threads copy it with 16-byte
// cp.async two chunks ahead of use, so the two warp groups multiply one
// chunk while the next two load. Each weight byte crosses L2 once per block
// (per group of 2 * MT row tiles: one group at the flagship lengths but for
// the 56-position backbone convs). The block is the two warp groups and
// nothing else: no thread is a producer. A producer warp or warp group
// would cut every thread's registers to 168 (ptxas allocates wgmma kernels
// by warp group; setmaxnreg did not lift it), and ptxas serializes the
// products when their registers run short or when a product or its
// registers sit on a path only some threads take (a thread-0 copy loop
// inside the pipeline did that).
//
// Epilogue: as int8_stack.cuh, bit for bit: max-pool on the int32 sums, then
// q = clip(rint(leaky(f32(acc) * s_eff + b_eff)), -127, 127) with __f*_rn.

#pragma once

#include "int8_stack.cuh"

namespace {

constexpr int kWgTile = 16;          // most cutouts a block (K5/K9/K10, K7)
constexpr int kWgThreads = 256;      // two warp groups
constexpr int kStageBytes = 16384;   // one weight chunk
constexpr int kStages = 4;           // the weight ring
constexpr int kScaleBytes = 2 * 512 * 4;  // a conv's s_eff and b_eff

// rows a cutout takes in the packed tile
__host__ __device__ constexpr int pstride(int l) { return (l + 2) & ~1; }
// 64-row wgmma tiles over the packed rows of a block of T cutouts
__host__ __device__ constexpr int m_tiles(int l, int T) {
  return (T * pstride(l) + 63) / 64;
}
// rows of a packed tile: every row its 64-row tiles read
__host__ __device__ constexpr int prows(int l, int T) {
  return m_tiles(l, T) * 64 + 2;
}
// bytes of a packed tile of C channels
__host__ __device__ constexpr int ptile_bytes(int l, int c, int T) {
  return prows(l, T) * c;
}

// channel ch of row r of a packed tile of `rows` rows (K16 checks this
// address, the one every conv's A operand and epilogue use)
template <typename P>
__device__ __forceinline__ P* packed_at(P* tile, int rows, int r, int ch) {
  return tile + ((size_t)(ch >> 4) * rows + r) * 16 + (ch & 15);
}

// Rows (n * L, C) int8 of cutouts c0 .. c0 + nv - 1 from device memory into
// a zeroed packed tile of a block of T cutouts (K10's act1, K7's template;
// K16 checks it)
template <int C>
__device__ __forceinline__ void load_packed(const int8_t* __restrict__ src,
                                            int8_t* tile, int c0, int nv,
                                            int L, int T) {
  constexpr int V = C / 16;  // 16-byte vectors a row
  const int S = pstride(L), rows = prows(L, T);
  for (int idx = threadIdx.x; idx < nv * L * V; idx += kWgThreads) {
    const int r = idx / V, v = idx - r * V;  // r: row of the block's cutouts
    const int c = r / L, p = r - c * L;
    *reinterpret_cast<uint4*>(packed_at(tile, rows, c * S + 1 + p, 16 * v)) =
        reinterpret_cast<const uint4*>(src + ((size_t)c0 * L + r) * C)[v];
  }
}

// the largest K chunk (a multiple of 32 dividing k) with ns * kc bytes in a
// stage; int8_tiles.chunk_k mirrors it
__host__ __device__ constexpr int chunk_k(int k, int ns) {
  int best = 32;
  for (int kc = 32; kc <= k; kc += 32)
    if (k % kc == 0 && ns * kc <= kStageBytes) best = kc;
  return best;
}

// one conv's place in the kernel's plan (int8_tiles.BACKBONE_PLAN/HEAD_PLAN)
template <int CIN, int COUT, int MT, int NJ>
struct ConvPlan {
  static constexpr int NS = 64 * NJ;           // output channels a pass
  static constexpr int K = 3 * CIN;
  static constexpr int KC = chunk_k(K, NS);    // K bytes a chunk
  static constexpr int NKC = K / KC;           // chunks a pass
  static constexpr int NSL = COUT / NS;        // passes a row group
  static constexpr int CHUNK = NS * KC;        // bytes a chunk
  static_assert(COUT % NS == 0 && CHUNK <= kStageBytes, "plan");
  static_assert(CHUNK % 16 == 0, "copies move 16-byte units");
  static constexpr int SPC = KC / 32;          // k32 steps a chunk
  // row groups: 2 warp groups x MT row tiles each
  __host__ __device__ static int groups(int l, int T) {
    return (m_tiles(l, T) + 2 * MT - 1) / (2 * MT);
  }
};

// ---- PTX wrappers ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// src_bytes (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's shared-memory writes (stores, finished copies) visible to
// the async proxy that wgmma reads its operands through
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// no-swizzle K-major descriptor: core matrices of 8 rows x 16 bytes; lbo
// the byte step between core matrices along K, sbo along M (A) or N (B)
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int lbo,
                                              int sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (64 x N s32) += A (64 x 32 s8) * B (32 x N s8), both through
// descriptors, one instruction for N = 64, 128 or 256. D fragment (PTX ISA,
// wgmma s32): warp w of the group owns rows 16w..16w+15; lane 4g + q holds
// rows g / g + 8 at columns 8j + 2q, 8j + 2q + 1 in d[4j .. 4j + 3].
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32],
                                             uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64],
                                             uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128],
                                             uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121,"
      "%122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// ---- the weight ring ---------------------------------------------------

constexpr int kAhead = 2;  // chunks in flight ahead of the one in use

// the ring's stages and the chunks of the kernel's sequence used so far
// (every thread walks the same sequence)
struct Ring {
  int8_t* buf;        // kStages x kStageBytes
  const int8_t* any;  // a global address the zero-size copies name
  int i;              // chunks used
};

// Chunk j of one conv's stream, if j is within it: the conv's chunks are
// [row group][pass][k chunk], and the host lays each pass's chunks out back
// to back, so every row group reads w from the start again. Otherwise j
// drops past this conv's chunks.
template <class P>
__device__ __forceinline__ bool chunk_of(int& j, const int8_t* w, int l,
                                         int T, const int8_t*& src,
                                         int& bytes) {
  const int per = P::NSL * P::NKC, n = P::groups(l, T) * per;
  if (j >= n) {
    j -= n;
    return false;
  }
  src = w + (size_t)(j % per) * P::CHUNK;
  bytes = P::CHUNK;
  return true;
}

// Every thread: copy its part of chunk j of the kernel's sequence (sched(j,
// src, bytes) names it, false past the last chunk: then zeros) into its
// stage, as one cp.async group. Chunks are at most kStageBytes, so a thread
// copies exactly kStageBytes / (16 * kWgThreads) pieces.
template <class Sched>
__device__ __forceinline__ void stage_chunk(const Ring& r, const Sched& sched,
                                            int j) {
  const int8_t* src = nullptr;
  int bytes = 0;  // stays 0 past the last chunk
  sched(j, src, bytes);
  int8_t* dst = r.buf + (size_t)(j % kStages) * kStageBytes;
#pragma unroll
  for (int v = 0; v < kStageBytes / (16 * kWgThreads); ++v) {
    const int o = 16 * (threadIdx.x + v * kWgThreads);
    const bool in = o < bytes;
    cp_async16(dst + o, in ? src + o : r.any, in ? 16 : 0);
  }
  cp_async_commit();
}

// The ring at `smem` and the kernel's first kAhead chunks on their way.
template <class Sched>
__device__ __forceinline__ Ring ring_start(unsigned char* smem,
                                           const Sched& sched) {
  Ring r;
  r.buf = reinterpret_cast<int8_t*>(smem);
  int bytes;
  sched(0, r.any, bytes);
  r.i = 0;
  for (int j = 0; j < kAhead; ++j) stage_chunk(r, sched, j);
  return r;
}

// Chunk c in shared memory for every thread (its copies done and fenced,
// then the block's barrier), and chunk c + kAhead on its way into the stage
// of chunk c + kAhead - kStages, which every warp group has finished with:
// a warp group keeps at most one group of products, of chunk c - 1, in
// flight across this barrier.
template <class Sched>
__device__ __forceinline__ const int8_t* next_chunk(const Ring& r,
                                                    const Sched& sched,
                                                    int c) {
  cp_async_wait<kAhead - 1>();
  fence_async_shared();
  __syncthreads();
  stage_chunk(r, sched, c + kAhead);
  return r.buf + (size_t)(c % kStages) * kStageBytes;
}

// ---- the conv ----------------------------------------------------------

enum WgEpilogue {
  kWgStore = 0,     // int8 into a packed tile of the same length
  kWgPool = 1,      // pooled int8 into a packed tile of length L / 2
  kWgPoolRows = 2,  // pooled int8 rows (c, L/2, COUT) into shared memory
  kWgPoolBf16 = 3,  // pooled bf16 of the f32 activation, rows into device
                    // memory (cutout c0 + c)
  kWgMean = 4,      // f32 activation rows (c, L, COUT) into shared memory
};

// One k=3 SAME int8 conv over the packed tile `in` of the block's T cutouts
// (nv of them real, the first one cutout c0; CIN channels, length L) ->
// `out` as EPI says. The weights stream through the ring (sched names the
// kernel's chunks; chunk_of<ConvPlan<...>> this conv's); the epilogue reads
// s_eff and b_eff from shared memory (sb, kScaleBytes), where the conv
// copies them first: from device memory their latency held every
// epilogue's dependent chain. No product is
// issued under a branch that depends on the data: a warp group past the
// last row tile multiplies the last one again and drops the result (a wgmma
// on a divergent path is serialized).
template <int CIN, int COUT, int MT, int NJ, int EPI, class Sched>
__device__ __forceinline__ void conv_wg(const int8_t* in, void* out, int L,
                                        int T, int nv, int c0, Ring& ring,
                                        const Sched& sched, float* sb,
                                        const float* __restrict__ s_eff,
                                        const float* __restrict__ b_eff) {
  using P = ConvPlan<CIN, COUT, MT, NJ>;
  const int S = pstride(L), L2 = L / 2, rows = prows(L, T);
  const int tiles = m_tiles(L, T), groups = P::groups(L, T);
  const int wg = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;

  for (int i = threadIdx.x; i < COUT; i += kWgThreads) {
    sb[i] = s_eff[i];
    sb[COUT + i] = b_eff[i];
  }
  fence_async_shared();  // the tile's stores, for the async proxy
  __syncthreads();
  for (int grp = 0; grp < groups; ++grp) {
    // row tiles of this warp group: grp * 2MT + 2i + wg
    int m0[MT];
    bool live[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int t = grp * 2 * MT + 2 * i + wg;
      live[i] = t < tiles;
      m0[i] = min(t, tiles - 1) * 64;
    }
    for (int ns = 0; ns < P::NSL; ++ns) {
      int acc[MT][NJ * 32];  // n8 block b of row tile i: acc[i][4b ..]
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < NJ * 32; ++e) acc[i][e] = 0;

      // A chunk's products are one group; before a chunk's barrier only the
      // chunk before's group may be in flight, so the stage the barrier
      // hands back to the copies (two chunks back) is free.
      wgmma_fence();
      for (int kc = 0; kc < P::NKC; ++kc) {
        if (kc > 0) wgmma_wait<1>();
        const int8_t* wb = next_chunk(ring, sched, ring.i + kc);
#pragma unroll
        for (int s = 0; s < P::SPC; ++s) {
          const int k = kc * P::KC + 32 * s;
          const int tap = k / CIN, kb = (k - tap * CIN) / 16;
          const uint64_t desc_b =
              gmma_desc(wb + 2 * s * P::NS * 16, P::NS * 16, 128);
#pragma unroll
          for (int i = 0; i < MT; ++i)
            wgmma_s8<P::NS>(acc[i],
                            gmma_desc(packed_at(in, rows, m0[i] + tap,
                                                16 * kb),
                                      rows * 16, 128),
                            desc_b);
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      ring.i += P::NKC;

      // epilogue: this thread's rows g and g + 8 of each 16-row slab
      constexpr bool kPooled =
          EPI == kWgPool || EPI == kWgPoolRows || EPI == kWgPoolBf16;
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
              const int n = ns * P::NS + 64 * j + 8 * jj + 2 * tq;
              const int v0 = acc[i][32 * j + 4 * jj + 2 * h];
              const int v1 = acc[i][32 * j + 4 * jj + 2 * h + 1];
              if (kPooled) {
                // positions 2r, 2r+1 are rows m (g even) and m + 1, lanes
                // `lane` and `lane ^ 4`: the even lane pools column n, the
                // odd one column n + 1, into output position p / 2
                const int odd = g & 1;
                const int v = max(odd ? v1 : v0,
                                  __shfl_xor_sync(kFull, odd ? v0 : v1, 4));
                if (!keep) continue;
                const int col = n + odd;
                const float y = scale_leaky(v, sb[col], sb[COUT + col]);
                const int r = p / 2;
                if (EPI == kWgPool) {
                  *packed_at(static_cast<int8_t*>(out), prows(L2, T),
                             c * pstride(L2) + 1 + r, col) =
                      (int8_t)requant(y);
                } else if (EPI == kWgPoolRows) {
                  static_cast<int8_t*>(out)[((size_t)c * L2 + r) * COUT + col] =
                      (int8_t)requant(y);
                } else {
                  static_cast<bf16*>(out)[((size_t)(c0 + c) * L2 + r) * COUT +
                                          col] = __float2bfloat16_rn(y);
                }
                continue;
              }
              if (!keep) continue;
              const float y0 = scale_leaky(v0, sb[n], sb[COUT + n]);
              const float y1 = scale_leaky(v1, sb[n + 1], sb[COUT + n + 1]);
              if (EPI == kWgStore) {
                *reinterpret_cast<char2*>(
                    packed_at(static_cast<int8_t*>(out), rows, m + 1, n)) =
                    make_char2((char)requant(y0), (char)requant(y1));
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

}  // namespace
