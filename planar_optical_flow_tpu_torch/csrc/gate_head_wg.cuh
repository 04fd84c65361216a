// The gate and head stage of the int8 serving cell, shared by K12
// (serve_cell.cu: K6 then K7 on the current features) and K13
// (serve_cell_wg.cu: after K9's backbone and the gate embed in the same
// block): gate_head_tile, on a tile of at most 16 rows of one stream whose
// zx and int8 features sit in shared memory.
//
// The gate is K6's (gate.cu gate_int8_rows_kernel), one m16 tile: the
// banded attention once a row (band_gate.cuh band_attention, one warp a
// row) from zx in shared memory and the CARRIED zt of the band's rows in
// device memory; then the carried template in 512-column chunks (256 past
// a half window of 8), the tile's rows and a window - 1 row halo staged
// byte-transposed, the exact int32 mix on mma.m16n8k32 with the quantized
// band as A, blended over the feature rows in place. The head is K7's
// (int8_wg.cuh head_convs) on the new template in the packed tile, its
// weights through the block's ring. A block reads only the carried zt and
// t and writes only fresh buffers, so no block reads what another writes.

#pragma once

#include "band_gate.cuh"
#include "int8_wg.cuh"

namespace {

constexpr int kCellRows = 16;    // the mix's m16 tile: the most rows a block
static_assert(kWgTile == kCellRows, "a block's rows are one m16 tile");

// the scalars of the cell (K12 leaves L and in_scale unused)
struct CellArgs {
  int ct, ct_valid, window, L, nc, T, R;
  float in_scale, alpha, beta, s_x, s_t127, s_out;
};

// template columns a gate chunk: 512 for a half window up to 8 (one k32
// step of the band), 256 above (two)
__host__ __device__ constexpr int gate_cols(int kt) { return 512 / kt; }
// bytes of the staged template of a chunk: 8 kt row quads of cols + 8 words
__host__ __device__ constexpr int gate_tb_bytes(int kt) {
  return 8 * kt * (gate_cols(kt) + 8) * 4;
}

// The gate and the head of a tile of nv <= 16 rows i0 .. of one stream
// (row0: the stream's first row): K6 on the rows' zx (zx_s, row r at r *
// 128) and int8 features (x, row r at r * cell_pitch(L4, 256), in bufb),
// with the stream's carried zt and template t in device memory -> new_z,
// sim and new_t (device memory), then K7 on the new template -> cls, reg.
// bufa and bufb (R bytes each), q_s (16 x kMaxWindow ints) and means (T x
// 128 f32) are the block's; the head's weights come through the ring.
template <class Sched>
__device__ __forceinline__ void gate_head_tile(
    const bf16* zx_s, int8_t* bufa, int8_t* bufb, int* q_s, float* means,
    const bf16* __restrict__ zt, const int8_t* __restrict__ t,
    int8_t* __restrict__ new_t, bf16* __restrict__ new_z,
    float* __restrict__ sim, float* __restrict__ cls,
    float* __restrict__ reg, size_t row0, int i0, int nv, int L4,
    const CellArgs& ca, Ring& ring, const Sched& sched, float* sb,
    const HeadWeights& hw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int window = ca.window, hw2 = window / 2;
  const int d = L4 * 256, xp = cell_pitch(L4, 256);
  int8_t* x = bufb;
  const int kt_n = hw2 > 8 ? 2 : 1;  // k32 steps: staged rows 32 kt_n
  const int H = 8 * kt_n;            // staged rows above the tile
  // the template's chunks: cc columns, staged in bufa as row quads
  const int cc = gate_cols(kt_n), pitch = cc + 8, nch = d / cc;
  uint32_t* tb = reinterpret_cast<uint32_t*>(bufa);
  // this thread's staging unit: row quad uq, columns ucol .. ucol + 15
  const int uq = threadIdx.x / (cc / 16), ucol = 16 * (threadIdx.x % (cc / 16));
  uint4 tr[4];
  auto load_t = [&](int col0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = i0 - H + 4 * uq + e;
      tr[e] = make_uint4(0u, 0u, 0u, 0u);
      if (j >= 0 && j < ca.ct)
        tr[e] = __ldg(reinterpret_cast<const uint4*>(
            t + (row0 + j) * d + col0 + ucol));
    }
  };

  // ---- the banded attention of the rows: sim, new_z, q ----
  for (int r = warp; r < kCellRows; r += kWarps) {
    if (r < nv) {
      const int i = i0 + r;
      const BandLane br = band_attention(zx_s + r * 128, zt + row0 * 128, i,
                                         ca.ct_valid, window, lane);
      if (lane < window) q_s[r * kMaxWindow + lane] = quantize_attn(br.attn);
      z_mix_and_sim(zx_s + r * 128, zt + row0 * 128,
                    new_z + (row0 + i) * 128, sim + (row0 + i) * window, i,
                    window, br, bf16_round(br.attn), ca.alpha, ca.beta, lane);
    } else if (lane < window) {
      q_s[r * kMaxWindow + lane] = 0;
    }
  }
  __syncthreads();

  // ---- the band as mma.m16n8k32's A: A[r][k] = q[r][k - H - r + hw] ----
  uint32_t a[2][4];
#pragma unroll
  for (int kt = 0; kt < 2; ++kt)
#pragma unroll
    for (int reg4 = 0; reg4 < 4; ++reg4) {
      const int rr = g + 8 * (reg4 & 1);
      const int kb = 32 * kt + 16 * (reg4 >> 1) + 4 * tq;
      uint32_t w = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = kb + e - H - rr + hw2;  // band lane of (rr, k)
        const int qv = kt < kt_n && kk >= 0 && kk < window
                           ? q_s[rr * kMaxWindow + kk] : 0;
        w |= ((uint32_t)qv & 0xffu) << (8 * e);
      }
      a[kt][reg4] = w;
    }

  // ---- the template mix, chunk by chunk, blended over x in place ----
  load_t(0);
  for (int ch = 0; ch < nch; ++ch) {
    const int col0 = ch * cc;
    transpose_quad(tb + uq * pitch + ucol, tr);
    __syncthreads();
    if (ch + 1 < nch) load_t(col0 + cc);  // the next chunk during this one
    for (int jn = 0; jn < cc / 64; ++jn) {
      const int n0 = warp * (cc / 8) + 8 * jn;
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        if (kt < kt_n) {
          const uint32_t* bq = tb + (8 * kt + tq) * pitch + n0 + g;
          const uint32_t b[2] = {bq[0], bq[4 * pitch]};
          mma_s8(acc, a[kt], b);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        if (r < nv) {
          char2* px = reinterpret_cast<char2*>(x + (size_t)r * xp + col0 +
                                               n0 + 2 * tq);
          const char2 xv = *px;
          *px = make_char2(
              (char)blend_requant(acc[2 * h], xv.x, ca.alpha, ca.beta,
                                  ca.s_x, ca.s_t127, ca.s_out),
              (char)blend_requant(acc[2 * h + 1], xv.y, ca.alpha, ca.beta,
                                  ca.s_x, ca.s_t127, ca.s_out));
        }
      }
    }
    __syncthreads();
  }

  // ---- the new template to new_t and into the head's packed tile ----
  const int R = ca.R, T = ca.T;
  zero_smem(bufa, R);
  __syncthreads();
  const int S4 = pstride(L4), rows4 = prows(L4, T);
  for (int idx = threadIdx.x; idx < nv * L4 * 16; idx += kWgThreads) {
    const int c = idx / (L4 * 16), v = idx - c * (L4 * 16);
    const uint4 o =
        *reinterpret_cast<const uint4*>(x + (size_t)c * xp + 16 * v);
    *reinterpret_cast<uint4*>(new_t + (row0 + i0 + c) * d + 16 * v) = o;
    *reinterpret_cast<uint4*>(
        packed_at(bufa, rows4, c * S4 + 1 + (v >> 4), 16 * (v & 15))) = o;
  }
  __syncthreads();
  zero_smem(bufb, R);
  __syncthreads();

  // ---- K7 on the new template ----
  head_convs(bufa, bufb, R, means, L4, T, nv, (int)(row0 + i0), ring, sched,
             sb, hw, cls, reg, ca.nc);
}

}  // namespace
