// The wgmma convs of K5 (with its K9/K10 modes), K7 and K13 (int8) and of
// K2, K4 and K14's bf16 backbone and head (bf16) for Hopper: products on
// weights staged in shared memory, over a packed tile of cutouts.
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
// major: 16 bytes of channels (16 int8 or 8 bf16) of all its rows, then the
// next block (packed_at). So any 8 consecutive rows of a block are one
// 128-byte core matrix of a no-swizzle K-major wgmma operand, and the tap t
// is the operand's start row plus t (a swizzled layout could not start at
// any row).
//
// Products. wgmma.mma_async m64nNk32 s8 x s8 -> s32 (exact) or m64nNk16
// bf16 x bf16 -> f32: 32 bytes of K an instruction either way, N = 64 NJ of
// 64, 128 or 256, A (64 rows x 32 bytes of K) straight from the tile and B
// (N output channels x 32 bytes of K, K-major) from the staged weights, both
// through no-swizzle descriptors. A warp group holds MT 64-row tiles x N
// channels of accumulators, so each staged weight byte feeds MT x 64 rows.
// Where a block has fewer row tiles than warp groups (K4's 7-position
// convs: one tile of 8 cutouts), the plan's WGN = 2 splits a pass's N
// between the two warp groups instead. A chunk's products are one commit
// group; a warp group keeps two in flight and waits only where the ring
// needs a stage back.
//
// Weights through shared memory. Each conv's weights come laid out by the
// host (int8_tiles.wgmma_weights) in chunks of NS = 64 * NJ * WGN output
// channels x KC elements of K, each chunk the core-matrix order the
// descriptor reads ([16-byte K block][n8 group][8 rows][16 bytes]: the core
// matrices along N adjacent, as along M in the tile) and contiguous. Every
// chunk of every conv of the kernel streams, in the order the warp groups
// use them, through a ring of kStages stages: all 256 threads copy it with
// 16-byte cp.async two chunks ahead of use, so the two warp groups multiply
// one chunk while the next two load. Each weight byte crosses L2 once per
// block (per group of row tiles: one group at the flagship lengths but for
// the 56-position backbone convs). The block is the two warp groups and
// nothing else: no thread is a producer. A producer warp or warp group
// would cut every thread's registers to 168 (ptxas allocates wgmma kernels
// by warp group; setmaxnreg did not lift it), and ptxas serializes the
// products when their registers run short or when a product or its
// registers sit on a path only some threads take (a thread-0 copy loop
// inside the pipeline did that).
//
// Epilogue, int8: as int8_stack.cuh, bit for bit: max-pool on the int32
// sums, then q = clip(rint(leaky(f32(acc) * s_eff + b_eff)), -127, 127)
// with __f*_rn. bf16: leaky(acc + b) in f32 (the max-pool on the sums,
// which gives the same value: the epilogue is monotone), stored as bf16.

#pragma once

#include <type_traits>

#include "int8_stack.cuh"

namespace {

constexpr int kWgTile = 16;          // most cutouts a block
constexpr int kWgThreads = 256;      // two warp groups
constexpr int kStageBytes = 16384;   // one weight chunk
constexpr int kStages = 4;           // the weight ring
constexpr int kScaleBytes = 2 * 512 * 4;  // a conv's s_eff and b_eff
// the ring, then a conv's s_eff/b_eff: where a wgmma kernel's tiles start
constexpr int kRingBytes = kStages * kStageBytes + kScaleBytes;
constexpr size_t kSmemMax = 232448;  // dynamic shared memory a block may use

inline size_t round128(size_t x) { return (x + 127) / 128 * 128; }

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
// bytes of a packed tile of rows of cb bytes
__host__ __device__ constexpr int ptile_bytes(int l, int cb, int T) {
  return prows(l, T) * cb;
}

// channel ch of row r of a packed tile of `rows` rows of P (K16 checks this
// address, the one every conv's A operand and epilogue use)
template <typename P>
__device__ __forceinline__ P* packed_at(P* tile, int rows, int r, int ch) {
  constexpr int E = 16 / sizeof(P);  // channels of a 16-byte block
  return tile + ((size_t)(ch / E) * rows + r) * E + (ch % E);
}

// Rows (n * L, C) of cutouts c0 .. c0 + nv - 1 from device memory into a
// zeroed packed tile of a block of T cutouts (K10's act1, K7's template,
// K4's feats; K16 checks it)
template <int C, typename E>
__device__ __forceinline__ void load_packed(const E* __restrict__ src,
                                            E* tile, int c0, int nv, int L,
                                            int T) {
  constexpr int VE = 16 / sizeof(E);  // channels a 16-byte vector
  constexpr int V = C / VE;           // vectors a row
  const int S = pstride(L), rows = prows(L, T);
  for (int idx = threadIdx.x; idx < nv * L * V; idx += kWgThreads) {
    const int r = idx / V, v = idx - r * V;  // r: row of the block's cutouts
    const int c = r / L, p = r - c * L;
    *reinterpret_cast<uint4*>(packed_at(tile, rows, c * S + 1 + p, VE * v)) =
        reinterpret_cast<const uint4*>(src + ((size_t)c0 * L + r) * C)[v];
  }
}

// the largest K chunk (elements of es bytes, a multiple of 32 bytes
// dividing k) with ns * kc elements in a stage; int8_tiles.chunk_k mirrors
// it
__host__ __device__ constexpr int chunk_k(int k, int ns, int es = 1) {
  const int step = 32 / es;
  int best = step;
  for (int kc = step; kc <= k; kc += step)
    if (k % kc == 0 && ns * kc * es <= kStageBytes) best = kc;
  return best;
}

// one conv's place in the kernel's plan (int8_tiles.BACKBONE_PLAN,
// HEAD_PLAN, HEAD_BF16_PLAN): MT row tiles x NJ n64 tiles a warp group,
// WGN warp groups along N (1: the two warp groups take alternate row
// tiles; 2: both take the same row tiles and half of N each), E the
// operands' type
template <int CIN, int COUT, int MT, int NJ, int WGN = 1,
          typename E = int8_t>
struct ConvPlan {
  static constexpr int NW = 64 * NJ;           // channels a warp group's product
  static constexpr int NS = NW * WGN;          // output channels a pass
  static constexpr int K = 3 * CIN;
  static constexpr int KSTEP = 32 / (int)sizeof(E);  // K an instruction
  static constexpr int KC = chunk_k(K, NS, sizeof(E));  // K a chunk
  static constexpr int NKC = K / KC;           // chunks a pass
  static constexpr int NSL = COUT / NS;        // passes a row group
  static constexpr int CHUNK = NS * KC * (int)sizeof(E);  // bytes a chunk
  static_assert(WGN == 1 || WGN == 2, "plan");
  static_assert(COUT % NS == 0 && CHUNK <= kStageBytes, "plan");
  static_assert(CHUNK % 16 == 0, "copies move 16-byte units");
  static constexpr int SPC = KC / KSTEP;       // instructions a chunk
  // row groups: MT row tiles of each of 2 warp groups, or of both
  __host__ __device__ static int groups(int l, int T) {
    const int per = WGN == 1 ? 2 * MT : MT;
    return (m_tiles(l, T) + per - 1) / per;
  }
};

// ---- PTX wrappers ------------------------------------------------------

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

// D (64 x N) += A (64 x 32 bytes of K) * B (32 bytes of K x N), both
// through descriptors, one instruction for N = 64, 128 or 256: s8 -> s32
// (wgmma_s8) or bf16 -> f32 (wgmma_bf16, both operands K-major). D fragment
// (PTX ISA): warp w of the group owns rows 16w..16w+15; lane 4g + q holds
// rows g / g + 8 at columns 8j + 2q, 8j + 2q + 1 in d[4j .. 4j + 3].
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b);
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2],
                                           uint64_t desc_a, uint64_t desc_b);

// the accumulator operand lists ("%0, ..., %R-1" and C(d[0]), ...)
#define WG_D32(C, d) \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]), \
  C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), \
  C(d[15]), C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]), C(d[21]), \
  C(d[22]), C(d[23]), C(d[24]), C(d[25]), C(d[26]), C(d[27]), C(d[28]), \
  C(d[29]), C(d[30]), C(d[31])
#define WG_L32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31"
#define WG_D64(C, d) \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]), \
  C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), \
  C(d[15]), C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]), C(d[21]), \
  C(d[22]), C(d[23]), C(d[24]), C(d[25]), C(d[26]), C(d[27]), C(d[28]), \
  C(d[29]), C(d[30]), C(d[31]), C(d[32]), C(d[33]), C(d[34]), C(d[35]), \
  C(d[36]), C(d[37]), C(d[38]), C(d[39]), C(d[40]), C(d[41]), C(d[42]), \
  C(d[43]), C(d[44]), C(d[45]), C(d[46]), C(d[47]), C(d[48]), C(d[49]), \
  C(d[50]), C(d[51]), C(d[52]), C(d[53]), C(d[54]), C(d[55]), C(d[56]), \
  C(d[57]), C(d[58]), C(d[59]), C(d[60]), C(d[61]), C(d[62]), C(d[63])
#define WG_L64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_D128(C, d) \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]), \
  C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), \
  C(d[15]), C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]), C(d[21]), \
  C(d[22]), C(d[23]), C(d[24]), C(d[25]), C(d[26]), C(d[27]), C(d[28]), \
  C(d[29]), C(d[30]), C(d[31]), C(d[32]), C(d[33]), C(d[34]), C(d[35]), \
  C(d[36]), C(d[37]), C(d[38]), C(d[39]), C(d[40]), C(d[41]), C(d[42]), \
  C(d[43]), C(d[44]), C(d[45]), C(d[46]), C(d[47]), C(d[48]), C(d[49]), \
  C(d[50]), C(d[51]), C(d[52]), C(d[53]), C(d[54]), C(d[55]), C(d[56]), \
  C(d[57]), C(d[58]), C(d[59]), C(d[60]), C(d[61]), C(d[62]), C(d[63]), \
  C(d[64]), C(d[65]), C(d[66]), C(d[67]), C(d[68]), C(d[69]), C(d[70]), \
  C(d[71]), C(d[72]), C(d[73]), C(d[74]), C(d[75]), C(d[76]), C(d[77]), \
  C(d[78]), C(d[79]), C(d[80]), C(d[81]), C(d[82]), C(d[83]), C(d[84]), \
  C(d[85]), C(d[86]), C(d[87]), C(d[88]), C(d[89]), C(d[90]), C(d[91]), \
  C(d[92]), C(d[93]), C(d[94]), C(d[95]), C(d[96]), C(d[97]), C(d[98]), \
  C(d[99]), C(d[100]), C(d[101]), C(d[102]), C(d[103]), C(d[104]), \
  C(d[105]), C(d[106]), C(d[107]), C(d[108]), C(d[109]), C(d[110]), \
  C(d[111]), C(d[112]), C(d[113]), C(d[114]), C(d[115]), C(d[116]), \
  C(d[117]), C(d[118]), C(d[119]), C(d[120]), C(d[121]), C(d[122]), \
  C(d[123]), C(d[124]), C(d[125]), C(d[126]), C(d[127])
#define WG_L128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127"

// one specialization: FN<N> on R accumulators of T (constraint CON); A, B
// and P the operand numbers of the descriptors and of the scale-d flag
#define WG_MMA(FN, T, CON, N, R, SHAPE, A, B, P, TAIL)                   \
  template <>                                                           \
  __device__ __forceinline__ void FN<N>(T(&d)[R], uint64_t desc_a,      \
                                        uint64_t desc_b) {              \
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %" P ", 0;\n"     \
                 "wgmma.mma_async.sync.aligned." SHAPE " {" WG_L##R     \
                 "}, %" A ", %" B ", p" TAIL ";\n}\n"                    \
                 : WG_D##R(CON, d)                                      \
                 : "l"(desc_a), "l"(desc_b), "r"(1));                   \
  }

WG_MMA(wgmma_s8, int, "+r", 64, 32, "m64n64k32.s32.s8.s8", "32", "33", "34",
       "")
WG_MMA(wgmma_s8, int, "+r", 128, 64, "m64n128k32.s32.s8.s8", "64", "65",
       "66", "")
WG_MMA(wgmma_s8, int, "+r", 256, 128, "m64n256k32.s32.s8.s8", "128", "129",
       "130", "")
// bf16: scale-a 1, scale-b 1, neither operand transposed (both K-major)
WG_MMA(wgmma_bf16, float, "+f", 64, 32, "m64n64k16.f32.bf16.bf16", "32",
       "33", "34", ", 1, 1, 0, 0")
WG_MMA(wgmma_bf16, float, "+f", 128, 64, "m64n128k16.f32.bf16.bf16", "64",
       "65", "66", ", 1, 1, 0, 0")
WG_MMA(wgmma_bf16, float, "+f", 256, 128, "m64n256k16.f32.bf16.bf16", "128",
       "129", "130", ", 1, 1, 0, 0")

template <int N>
__device__ __forceinline__ void wgmma_acc(int (&d)[N / 2], uint64_t a,
                                          uint64_t b) {
  wgmma_s8<N>(d, a, b);
}
template <int N>
__device__ __forceinline__ void wgmma_acc(float (&d)[N / 2], uint64_t a,
                                          uint64_t b) {
  wgmma_bf16<N>(d, a, b);
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
  kWgStore = 0,     // into a packed tile of the same length
  kWgPool = 1,      // pooled, into a packed tile of length L / 2
  kWgPoolRows = 2,  // pooled int8 rows (c, L/2, COUT) into shared memory
  kWgPoolBf16 = 3,  // pooled bf16 of the f32 activation, rows into device
                    // memory (cutout c0 + c)
  kWgMean = 4,      // f32 activation rows (c, L, COUT) into shared memory
  kWgPoolCell = 5,  // as kWgPoolRows, cutout c's rows at c * cell_pitch
  kWgPoolF32 = 6,   // as kWgPoolBf16, the bf16 values stored as f32
};

// bytes from one cutout's pooled int8 rows to the next in K13's feats
// (kWgPoolCell): L/2 x COUT and 16 more, so that the rows g of an mma
// fragment fall in different banks
__host__ __device__ constexpr int cell_pitch(int l2, int cout) {
  return l2 * cout + 16;
}

// the activation of one sum: int8 sums scaled (s_eff, b_eff), bf16 ones
// biased (b), then leaky
__device__ __forceinline__ float act_of(int v, float s, float b) {
  return scale_leaky(v, s, b);
}
__device__ __forceinline__ float act_of(float v, float, float b) {
  return leaky(__fadd_rn(v, b));
}
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }

// an activation stored as the next conv's operand: requantized int8, or
// bf16
__device__ __forceinline__ void store_act(int8_t* p, float y) {
  *p = (int8_t)requant(y);
}
__device__ __forceinline__ void store_act(bf16* p, float y) {
  *p = __float2bfloat16_rn(y);
}
__device__ __forceinline__ void store_act2(int8_t* p, float y0, float y1) {
  *reinterpret_cast<char2*>(p) = make_char2((char)requant(y0),
                                            (char)requant(y1));
}
__device__ __forceinline__ void store_act2(bf16* p, float y0, float y1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y0, y1);
}

// One k=3 SAME conv over the packed tile `in` of the block's T cutouts (nv
// of them real, the first one cutout c0; CIN channels of E, length L) ->
// `out` as EPI says. The weights stream through the ring (sched names the
// kernel's chunks; chunk_of<ConvPlan<...>> this conv's); the epilogue reads
// s_eff (int8 only) and b_eff from shared memory (sb, kScaleBytes), where
// the conv copies them first: from device memory their latency held every
// epilogue's dependent chain. With HOIST (bf16 convs) the epilogue takes
// the latency out of each element's chain: each thread reads its pass's
// biases into registers while the pass's last products run, and a pooled
// epilogue makes all of a row slab's pool shuffles before its first store
// (a shuffle cannot move across the branch before a store, so each element
// waited for its own; K2's pooled epilogues took 19 of its 56 us a block
// without HOIST). No product is issued under a branch that depends on the
// data: a warp group past the last row tile multiplies the last one again
// and drops the result (a wgmma on a divergent path is serialized).
template <int CIN, int COUT, int MT, int NJ, int EPI, int WGN = 1,
          bool HOIST = false, typename E = int8_t, class Sched>
__device__ __forceinline__ void conv_wg(const E* in, void* out, int L,
                                        int T, int nv, int c0, Ring& ring,
                                        const Sched& sched, float* sb,
                                        const float* __restrict__ s_eff,
                                        const float* __restrict__ b_eff) {
  using P = ConvPlan<CIN, COUT, MT, NJ, WGN, E>;
  using Acc = typename std::conditional<sizeof(E) == 1, int, float>::type;
  static_assert(!HOIST || sizeof(E) == 2, "hoisted epilogue: bf16 convs");
  const int S = pstride(L), L2 = L / 2, rows = prows(L, T);
  const int tiles = m_tiles(L, T), groups = P::groups(L, T);
  const int wg = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  // this warp group's channels of a pass, and its B operand's first bytes
  const int n_wg = WGN == 2 ? wg * P::NW : 0;

  for (int i = threadIdx.x; i < COUT; i += kWgThreads) {
    if (sizeof(E) == 1) sb[i] = s_eff[i];
    sb[COUT + i] = b_eff[i];
  }
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
      Acc acc[MT][NJ * 32];  // n8 block b of row tile i: acc[i][4b ..]
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
          const int k = kc * P::KC + P::KSTEP * s;
          const int tap = k / CIN, ch = k - tap * CIN;
          const uint64_t desc_b = gmma_desc(
              wb + 2 * s * P::NS * 16 + n_wg * 16, P::NS * 16, 128);
#pragma unroll
          for (int i = 0; i < MT; ++i)
            wgmma_acc<P::NW>(
                acc[i],
                gmma_desc(packed_at(in, rows, m0[i] + tap, ch), rows * 16,
                          128),
                desc_b);
        }
        wgmma_commit();
      }
      float2 bias[NJ][8];  // HOIST: columns n, n + 1 of each n8 block
      if constexpr (HOIST) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            bias[j][jj] = *reinterpret_cast<const float2*>(
                sb + COUT + ns * P::NS + n_wg + 64 * j + 8 * jj + 2 * tq);
      }
      wgmma_wait<0>();
      ring.i += P::NKC;

      // epilogue: this thread's rows g and g + 8 of each 16-row slab
      constexpr bool kPooled = EPI == kWgPool || EPI == kWgPoolRows ||
                               EPI == kWgPoolBf16 || EPI == kWgPoolCell ||
                               EPI == kWgPoolF32;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0[i] + 16 * wq + g + 8 * h;
          const int c = m / S, p = m - c * S;
          const bool keep = live[i] && c < nv && p < L;
          Acc pooled[NJ][8];  // HOIST, pooled: the slab's pooled sums
          if constexpr (HOIST) {
            if constexpr (kPooled) {
              const int odd = g & 1;
#pragma unroll
              for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int jj = 0; jj < 8; ++jj) {
                  const Acc v0 = acc[i][32 * j + 4 * jj + 2 * h];
                  const Acc v1 = acc[i][32 * j + 4 * jj + 2 * h + 1];
                  pooled[j][jj] = vmax(
                      odd ? v1 : v0, __shfl_xor_sync(kFull, odd ? v0 : v1, 4));
                }
            }
            if (!keep) continue;
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int n = ns * P::NS + n_wg + 64 * j + 8 * jj + 2 * tq;
              const Acc v0 = acc[i][32 * j + 4 * jj + 2 * h];
              const Acc v1 = acc[i][32 * j + 4 * jj + 2 * h + 1];
              if (kPooled) {
                // positions 2r, 2r+1 are rows m (g even) and m + 1, lanes
                // `lane` and `lane ^ 4`: the even lane pools column n, the
                // odd one column n + 1, into output position p / 2
                const int odd = g & 1;
                Acc v;
                if constexpr (HOIST)
                  v = pooled[j][jj];
                else
                  v = vmax(odd ? v1 : v0,
                           __shfl_xor_sync(kFull, odd ? v0 : v1, 4));
                if (!keep) continue;
                const int col = n + odd;
                float y;
                if constexpr (HOIST)
                  y = leaky(__fadd_rn(v, odd ? bias[j][jj].y : bias[j][jj].x));
                else
                  y = act_of(v, sb[col], sb[COUT + col]);
                const int r = p / 2;
                if (EPI == kWgPool) {
                  store_act(packed_at(static_cast<E*>(out), prows(L2, T),
                                      c * pstride(L2) + 1 + r, col),
                            y);
                } else if (EPI == kWgPoolRows) {
                  static_cast<int8_t*>(out)[((size_t)c * L2 + r) * COUT + col] =
                      (int8_t)requant(y);
                } else if (EPI == kWgPoolCell) {
                  static_cast<int8_t*>(out)[(size_t)c * cell_pitch(L2, COUT) +
                                            r * COUT + col] =
                      (int8_t)requant(y);
                } else if (EPI == kWgPoolF32) {
                  static_cast<float*>(out)[((size_t)(c0 + c) * L2 + r) * COUT +
                                           col] =
                      __bfloat162float(__float2bfloat16_rn(y));
                } else {
                  static_cast<bf16*>(out)[((size_t)(c0 + c) * L2 + r) * COUT +
                                          col] = __float2bfloat16_rn(y);
                }
                continue;
              }
              if (!keep) continue;
              float y0, y1;
              if constexpr (HOIST) {
                y0 = leaky(__fadd_rn(v0, bias[j][jj].x));
                y1 = leaky(__fadd_rn(v1, bias[j][jj].y));
              } else {
                y0 = act_of(v0, sb[n], sb[COUT + n]);
                y1 = act_of(v1, sb[n + 1], sb[COUT + n + 1]);
              }
              if (EPI == kWgStore) {
                store_act2(packed_at(static_cast<E*>(out), rows, m + 1, n), y0,
                           y1);
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
