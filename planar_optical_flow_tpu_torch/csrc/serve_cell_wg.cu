// K13 (the whole int8 serving cell) for Hopper (sm_90a).
//
// K13 replaces planar_optical_flow_tpu/ops/pallas/serve_cell.py
// serve_cell_int8 (kernel _cell_kernel): on a carried step, K9's backbone
// (the divide-after-leaky layer 1, the int8 tail, the gate embed with zx
// rounded to bf16), then K6's int8 gate and K7's int8 head on the fresh
// template, equal to that chain to the bit.
//
// Design: the three kernels' device code in one block. A block takes T
// cutouts (16 at L = 56) of one stream, rows i0 .. i0 + T - 1 (grid:
// stream x tile; the last tile of a stream may be partial), and keeps them
// in shared memory from the cutouts to cls/reg:
//   backbone  K9's: layer 1 into the packed tile, the five tail convs on
//             wgmma_conv.cuh (int8_wg.cuh backbone_convs); the last conv
//             writes the int8 feats as rows at cell_pitch into shared
//             memory, never to device memory;
//   embed     zx of the block's rows with embed_kernel's fragments,
//             instruction and k order (int8_wg.cuh embed_frag_a), so its
//             bits are K9's; each warp reads its columns of the embed
//             weights from L2 into registers, 16 k16 steps ahead;
//   gate      K6's: attention once a row from zx in shared memory and the
//             CARRIED zt of the band's rows in device memory; then the
//             carried template in 512-column chunks (256 past a half
//             window of 8), the tile's rows and a window - 1 row halo
//             staged byte-transposed, the exact int32 mix on mma.m16n8k32
//             with the quantized band as A (one m16 tile: the block's
//             rows), blended over the feats rows in place;
//   head      the new template to new_t and into the packed tile, then
//             K7's convs, mean and cls/reg (int8_wg.cuh head_convs).
// The backbone's and the head's conv weights, laid out once by the host
// (int8_tiles.plan_weights), stream through one 4 x 16 KB ring in the order
// the stages use them; the embed's, laid out once as well
// (int8_tiles.embed_weights), go from L2 to registers. A block reads only
// the carried zt and t and writes only fresh buffers, so no block reads
// what another writes. The gate and head stage is one device function,
// gate_head_tile (gate_head_wg.cuh, which K12 runs alone), on feats rows
// and zx in shared memory.
//
// Shared memory at L = 56, T = 16: the ring and a conv's scales (69,632
// bytes), two regions of 66,560 (the largest of the packed tiles of either
// stack, the head's f32 rows, the pitched feats rows and the staged
// template), the means (8 KB), zx (4 KB), the quantized band (2 KB) and the
// f32 cutouts (3.5 KB): 220,672 of 232,448 bytes, one block an SM.
//
// Bound: int8 tensor-core operations (K9's ~15.1 M and K7's ~28.9 M a
// cutout at L = 56), against ~11 KB of device memory a cutout (the f32
// cutout, the carried template and new_t at 3.5 KB each) and the
// weights, which each block reads from L2: 0.92 MB of embed weights and
// 1.2 MB of conv weights.

#include "gate_head_wg.cuh"

namespace {

constexpr int kEmbedK = 64;      // K of an embed weight chunk (128 x 64 bf16)
constexpr int kEmbedDepth = 16;  // the embed's k16 steps in flight
static_assert(128 * kEmbedK * 2 == kStageBytes, "an embed chunk, a stage");

// the weights of the cell, each conv's and the embed's laid out once
struct CellWeights {
  TailWeights tw;    // backbone layers 2-6 (int8_tiles.plan_weights)
  const int8_t* we;  // W^T (128, D) bf16 in 64-k chunks (embed_weights)
  const bf16* be;
  HeadWeights hw;    // the head (int8_tiles.plan_weights) and cls/reg
};

// a block's region (each of two): the packed tiles of both stacks, the
// head's f32 rows, the pitched feats rows of the embed's m16 tile, the
// staged template
size_t cell_region(int l, int T) {
  const int l4 = l / 4;
  size_t r = backbone_tiles(l, T);
  const size_t parts[3] = {head_tiles(l4, T),
                           (size_t)kCellRows * cell_pitch(l4, 256),
                           (size_t)gate_tb_bytes(2)};
  for (size_t p : parts) r = p > r ? p : r;
  return round128(r);
}

size_t cell_smem(int l, int T) {
  return kRingBytes + 2 * cell_region(l, T) +
         (size_t)T * 128 * (sizeof(float) + sizeof(bf16)) +
         (size_t)kCellRows * kMaxWindow * sizeof(int) +
         (size_t)T * l * sizeof(float);
}

// cutouts a block: the most (16, halved) whose shared memory fits
int cell_tile(int l) {
  int T = kWgTile;
  while (T > 1 && cell_smem(l, T) > kSmemMax) T /= 2;
  return T;
}

// The gate embed of the block's rows: zx = bf16(feats @ We + be), rows
// (cutouts) g and g + 8 of one m16 tile, feats row c at feats + c * xp;
// warp w takes the 16 columns 16w .. 16w + 15 over the nk chunks of W^T
// (chunk kc: k = 64 kc .. 64 kc + 63, [8-element k block][column][8
// elements]), read straight from L2 into registers P k16 steps ahead of
// their products: no barrier and no ring stage (streamed through the ring,
// the chunks held every block's embed to a barrier each and two chunks in
// flight: 31.3 us a block against 22.5, experiments/torch_cell_split.py).
// Only rows < nv are stored, into zx_s.
template <int P>
__device__ __forceinline__ void cell_embed(const int8_t* feats, int xp,
                                           int nk,
                                           const int8_t* __restrict__ we,
                                           const bf16* __restrict__ be,
                                           bf16* zx_s, int nv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int8_t* ra = feats + (size_t)g * xp;
  const int8_t* rb = ra + (size_t)8 * xp;
  // this lane's bytes of column 16w + g, k block 0 of chunk 0; + 128: the
  // column 8 on, + 2048: the next k block
  const int8_t* wl = we + (size_t)(16 * warp + g) * 16 + 4 * tq;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  const int steps = nk * (kEmbedK / 16);
  uint32_t bq[P][4];
  auto load = [&](uint32_t (&b)[4], int st) {
    const int8_t* p = wl + (size_t)(st >> 2) * kStageBytes +
                      (size_t)(st & 3) * 4096;
    b[0] = ldg32(p);
    b[1] = ldg32(p + 2048);
    b[2] = ldg32(p + 128);
    b[3] = ldg32(p + 2048 + 128);
  };
#pragma unroll
  for (int p = 0; p < P; ++p) load(bq[p], p);
  for (int st0 = 0; st0 < steps; st0 += P) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int st = st0 + p;
      uint32_t a[4];
      embed_frag_a(a, ra, rb, st * 16 + 2 * tq);
      const uint32_t b0[2] = {bq[p][0], bq[p][1]};
      const uint32_t b1[2] = {bq[p][2], bq[p][3]};
      mma_bf16(acc[0], a, b0);
      mma_bf16(acc[1], a, b1);
      if (st + P < steps) load(bq[p], st + P);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g + 8 * h;
    if (row >= nv) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 16 * warp + 8 * j + 2 * tq;
      bf16* z = zx_s + (size_t)row * 128 + col;
      z[0] = __float2bfloat16(
          __fadd_rn(acc[j][2 * h], __bfloat162float(be[col])));
      z[1] = __float2bfloat16(
          __fadd_rn(acc[j][2 * h + 1], __bfloat162float(be[col + 1])));
    }
  }
}

// K13. Shared memory: the ring and the scales, bufa and bufb (R bytes
// each), the means (T x 128 f32), zx (T x 128 bf16), the quantized band (16
// x kMaxWindow ints), the f32 cutouts (T x L).
__global__ void __launch_bounds__(kWgThreads, 1)
    serve_cell_wg_kernel(const float* __restrict__ cutouts,
                         const bf16* __restrict__ zt,
                         const int8_t* __restrict__ t,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const __grid_constant__ CellWeights cw,
                         int8_t* __restrict__ new_t,
                         bf16* __restrict__ new_z, float* __restrict__ sim,
                         float* __restrict__ cls, float* __restrict__ reg,
                         const __grid_constant__ CellArgs ca) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int T = ca.T, R = ca.R, L = ca.L, L4 = L / 4;
  float* sb = reinterpret_cast<float*>(smem_raw + kStages * kStageBytes);
  int8_t* bufa = reinterpret_cast<int8_t*>(smem_raw + kRingBytes);
  int8_t* bufb = bufa + R;
  float* means = reinterpret_cast<float*>(bufb + R);
  bf16* zx_s = reinterpret_cast<bf16*>(means + T * 128);
  int* q_s = reinterpret_cast<int*>(zx_s + T * 128);
  float* cut_s = reinterpret_cast<float*>(q_s + kCellRows * kMaxWindow);
  const int i0 = blockIdx.y * T;
  const int nv = min(T, ca.ct - i0);
  const size_t row0 = (size_t)blockIdx.x * ca.ct;  // the stream's row 0
  const int c0 = (int)(row0 + i0);                  // the block's row 0
  const int nk = L4 * 256 / kEmbedK;                // embed chunks
  // the weight chunks of the backbone's and the head's convs, in the
  // order the stages use them
  auto sched = [&](int j, const int8_t*& src, int& bytes) {
    return backbone_chunk(j, cw.tw, L, T, src, bytes) ||
           head_chunk(j, cw.hw, L4, T, src, bytes);
  };

  // ---- K9: layer 1 (divide after the leaky), the int8 tail ----
  Ring ring = ring_start(smem_raw, sched);
  zero_smem(bufa, R);
  zero_smem(bufb, R);
  for (int idx = threadIdx.x; idx < nv * L; idx += kWgThreads)
    cut_s[idx] = cutouts[(size_t)c0 * L + idx];
  __syncthreads();
  layer1_packed<kDivide>(cut_s, w1, b1, ca.in_scale, bufa, nv, L, T);
  __syncthreads();
  backbone_convs<kWgPoolCell>(bufa, bufb, R, nullptr, L, T, nv, c0, ring,
                              sched, sb, cw.tw);
  __syncthreads();

  // ---- the gate embed of the block's rows ----
  cell_embed<kEmbedDepth>(bufb, cell_pitch(L4, 256), nk, cw.we, cw.be, zx_s,
                          nv);
  __syncthreads();

  // ---- K6 and K7 ----
  gate_head_tile(zx_s, bufa, bufb, q_s, means, zt, t, new_t, new_z, sim, cls,
                 reg, row0, i0, nv, L4, ca, ring, sched, sb, cw.hw);
  cp_async_wait<0>();  // the zero copies past the last chunk
}

}  // namespace

// The launch geometry of K13 at cutout length l: cutouts a block, rows a
// cutout in the packed tile and dynamic shared memory (bytes);
// int8_tiles.cell_geometry mirrors it
extern "C" int cell_geometry(int l, int* tile, int* rows, long long* smem) {
  *tile = cell_tile(l);
  *rows = pstride(l);
  *smem = (long long)cell_smem(l, *tile);
  return 0;
}

extern "C" long long serve_cell_int8_smem_bytes(int l) {
  return (long long)cell_smem(l, cell_tile(l));
}

// The chunking of the convs (as conv_stack_int8.cu's int8_wg_plan) and K
// of an embed chunk, which int8_tiles lays out
extern "C" int int8_wg_plan(int which, int layer, int* ns, int* kc) {
  return int8_plan_of(which, layer, ns, kc);
}

extern "C" int cell_embed_k() { return kEmbedK; }

// K13: cutouts (n, l) f32; zt (n, 128) bf16 and t (n, l/4 * 256) int8, the
// carry (n a multiple of ct); w1, b1: the unscaled layer 1 ((3, 64), (64,)
// f32) and in_scale; tail: the 15 pointers (w, s_eff, b_eff) of the
// backbone's layers 2-6 and head those of the five head convs, each w laid
// out by int8_tiles.plan_weights; we: the embed's W^T (128, l/4 * 256)
// bf16 with the feats scale folded in, laid out by int8_tiles.
// embed_weights, be (128,) bf16; wc .. br the cls/reg weights -> new_t (n,
// l/4 * 256) int8, new_z (n, 128) bf16, sim (n, window) f32, cls (n, nc)
// f32, reg (n, 2) f32.
extern "C" int serve_cell_int8_launch(
    const void* cutouts, const void* zt, const void* t, const void* w1,
    const void* b1, float in_scale, const void* const* tail, const void* we,
    const void* be, const void* const* head, const void* wc, const void* bc,
    const void* wr, const void* br, void* new_t, void* new_z, void* sim,
    void* cls, void* reg, int n, int ct, int ct_valid, int window, int l,
    int nc, float alpha, float beta, float s_x, float s_t127, float s_out,
    void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (window < 1 || window > kMaxWindow || ct < 1 || n % ct ||
      (l / 4 * 256) % gate_cols(1))
    return (int)cudaErrorInvalidValue;
  const int T = cell_tile(l);
  const size_t smem = cell_smem(l, T);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)serve_cell_wg_kernel, smem);
  if (err) return err;
  CellWeights cw;
  fill_convs(cw.tw, tail);
  cw.we = (const int8_t*)we;
  cw.be = (const bf16*)be;
  cw.hw = head_weights(head, wc, bc, wr, br);
  const CellArgs ca = {ct,       ct_valid, window, l,   nc,
                       T,        (int)cell_region(l, T), in_scale,
                       alpha,    beta,     s_x,    s_t127, s_out};
  const dim3 grid(n / ct, (ct + T - 1) / T);
  serve_cell_wg_kernel<<<grid, kWgThreads, smem, (cudaStream_t)stream>>>(
      (const float*)cutouts, (const bf16*)zt, (const int8_t*)t,
      (const float*)w1, (const float*)b1, cw, (int8_t*)new_t, (bf16*)new_z,
      (float*)sim, (float*)cls, (float*)reg, ca);
  return (int)cudaGetLastError();
}
