// The int8 conv stacks' device code of K8 (conv_stack_int8.cu) and K12
// (serve_cell.cu): the int8 tensor-core conv over a block's tile of
// cutouts, backbone layer 1 into the tile, the backbone tail + gate embed,
// and the head. K5/K9/K10, K7 and K13 share the epilogue arithmetic, the
// weight structs and the head's mean and cls/reg from here, and run their
// convs on wgmma_conv.cuh.
//
// A block owns kTile cutouts and keeps their activations in shared memory
// across every layer: per cutout, rows of C int8 channels padded to C + 16
// bytes (the eight rows an MMA fragment load touches then fall in different
// banks); row 0 and the rows past the last position are zero, position p
// sits in row p + 1. A k=3 SAME conv is then one product over K = 3 * Cin,
// the A row of output position p reading rows p, p + 1, p + 2 of the
// buffer. The products run on the int8 tensor cores with
// mma.sync.m16n8k32 (s8 x s8 -> s32, exact); a warp task is eight
// 16-position tiles x 16 output channels, so each weight fragment, read from
// global memory (L2 resident), feeds eight products. The weights come as
// (Cout, 3 * Cin): each output channel's taps are contiguous, the column
// operand's layout.
//
// The epilogue of a conv is
//   q = clip(rint(leaky(f32(acc) * s_eff + b_eff)), -127, 127),
// every f32 step spelled with __f*_rn intrinsics in the JAX order, so no
// multiply-add is contracted; rint is round-half-to-even. Max-pool is taken
// on the int32 sums before the epilogue: the epilogue is monotone, so this
// gives the same bits as pooling after it (conv_stack.py _scale_leaky).

#pragma once

#include "common.cuh"

namespace {

constexpr int kTile = 8;    // cutouts per block (= the embed MMA's rows)
constexpr int kPad = 16;    // shared-memory row padding (bytes)
constexpr int kMTiles = 8;  // 16-position tiles per warp task
constexpr int kNTiles = 2;  // 8-channel tiles per warp task
static_assert(kTile % kMTiles == 0,
              "a warp task's tiles must not run past the block's cutouts");

enum Epilogue { kStore = 0, kPool = 1, kMean = 2 };
// how a backbone block gets its layer-1 activation
enum Layer1 { kFold = 0, kDivide = 1, kRead = 2 };

__host__ __device__ constexpr int ld_of(int c) { return c + kPad; }
__host__ __device__ inline int pad16(int x) { return (x + 15) / 16 * 16; }
inline int imax(int a, int b) { return a > b ? a : b; }
inline int round16(int x) { return (x + 15) / 16 * 16; }

// f32(acc) * s_eff + b_eff with two roundings, then leaky
__device__ __forceinline__ float scale_leaky(int acc, float s, float b) {
  return leaky(__fadd_rn(__fmul_rn(__int2float_rn(acc), s), b));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const void* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t bf16x2_of(int8_t lo, int8_t hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D += A (16x16 bf16, row) * B (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void zero_smem(int8_t* p, int n_bytes) {
  const uint4 z = make_uint4(0, 0, 0, 0);
  uint4* q = reinterpret_cast<uint4*>(p);
  for (int i = threadIdx.x; i < n_bytes / 16; i += blockDim.x) q[i] = z;
}

// The row that tap t (0 left, 1 centre, 2 right) of position p0 + r of
// cutout c reads in a zero-padded tile of rows of LD bytes: position p sits
// in row p + 1, so the tap reads row p0 + t + r; rows 0 and L + 1 stay
// zero, which is the SAME padding at both ends of the cutout. K16 checks
// this addressing. (A macro: as an inline function the same expression
// compiled to a slower inner loop in conv_s8.)
#define TAP_ROW(tile, c, S, LD, p0, t, r) \
  ((tile) + (size_t)(c) * (S) + (size_t)((p0) + (t) + (r)) * (LD))

// Rows (n * L, C) int8 of cutouts c0 .. c0 + nv - 1 from device memory into
// a zeroed tile: position p of cutout c at row p + 1.
template <int C>
__device__ void load_rows(const int8_t* __restrict__ src, int8_t* tile,
                          int c0, int nv, int L, int S) {
  constexpr int V = C / 16;  // 16-byte vectors per row
  constexpr int kShift = C == 64 ? 2 : C == 128 ? 3 : 4;
  static_assert(V == 1 << kShift, "C must be 64, 128 or 256");
  for (int idx = threadIdx.x; idx < nv * L * V; idx += kThreads) {
    const int c = idx / (L * V);
    const int rem = idx - c * L * V;
    const int p = rem >> kShift, v = rem & (V - 1);
    reinterpret_cast<uint4*>(tile + (size_t)c * S +
                             (size_t)(p + 1) * ld_of(C))[v] =
        reinterpret_cast<const uint4*>(src + ((size_t)(c0 + c) * L + p) * C)[v];
  }
}

// One k=3 SAME int8 conv over the block's kTile cutouts: `in` (CIN channels,
// L positions, per-cutout stride S bytes) -> `out` (COUT channels, int8
// requantized; pooled to L/2 positions for kPool) or, into `fout`, the f32
// activation (kMean: kTile x L x COUT). W: (COUT, 3*CIN) int8.
// Fragment layouts (PTX ISA, mma.m16n8k32 .s8): lane = 4 * g + tq; A
// registers hold rows g / g+8 at k = 4tq.. and 16+4tq..; B registers hold
// column g at k = 4tq.. and 16+4tq..; D holds rows g / g+8 at columns 2tq,
// 2tq+1.
template <int CIN, int COUT, int EPI>
__device__ void conv_s8(const int8_t* in, int8_t* out, void* fout, int S,
                        int L, const int8_t* __restrict__ W,
                        const float* __restrict__ s_eff,
                        const float* __restrict__ b_eff) {
  constexpr int LDI = ld_of(CIN), LDO = ld_of(COUT), K = 3 * CIN;
  constexpr int NG = COUT / (8 * kNTiles);
  static_assert(CIN % 32 == 0 && COUT % (8 * kNTiles) == 0, "shape");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int mt = pad16(L) / 16;  // tiles per cutout
  const int tasks = (kTile * mt / kMTiles) * NG;
  for (int task = warp; task < tasks; task += kWarps) {
    const int ng = task % NG;
    const int u0 = (task / NG) * kMTiles;  // first tile of this task
    int acc[kMTiles][kNTiles][4];
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    const int8_t* wrow[kNTiles];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
      wrow[j] = W + (size_t)((ng * kNTiles + j) * 8 + g) * K + 4 * tq;
    for (int t = 0; t < 3; ++t) {
      for (int kk = 0; kk < CIN; kk += 32) {
        uint32_t b[kNTiles][2];
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          b[j][0] = ldg32(wrow[j] + t * CIN + kk);
          b[j][1] = ldg32(wrow[j] + t * CIN + kk + 16);
        }
#pragma unroll
        for (int i = 0; i < kMTiles; ++i) {
          const int u = u0 + i, c = u / mt, m = u - c * mt;
          const int8_t* ap = TAP_ROW(in, c, S, LDI, 16 * m, t, g) + kk + 4 * tq;
          const uint32_t a[4] = {lds32(ap), lds32(ap + 8 * LDI),
                                 lds32(ap + 16), lds32(ap + 8 * LDI + 16)};
#pragma unroll
          for (int j = 0; j < kNTiles; ++j) mma_s8(acc[i][j], a, b[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
      const int u = u0 + i, c = u / mt, m = u - c * mt;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const int n = (ng * kNTiles + j) * 8 + 2 * tq;
        const float s0 = s_eff[n], s1 = s_eff[n + 1];
        const float b0 = b_eff[n], b1 = b_eff[n + 1];
        if (EPI == kPool) {
          // positions 2r, 2r+1 are rows g, g^1: lanes `lane`, `lane ^ 4`
          int v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = max(acc[i][j][e], __shfl_xor_sync(kFull, acc[i][j][e], 4));
          if ((g & 1) == 0) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int pos = 16 * m + g + 8 * h;
              if (pos >= L) continue;
              const float y0 = scale_leaky(v[2 * h], s0, b0);
              const float y1 = scale_leaky(v[2 * h + 1], s1, b1);
              *reinterpret_cast<char2*>(
                  out + (size_t)c * S + (size_t)(pos / 2 + 1) * LDO + n) =
                  make_char2((char)requant(y0), (char)requant(y1));
            }
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int pos = 16 * m + g + 8 * h;
            if (pos >= L) continue;
            const float y0 = scale_leaky(acc[i][j][2 * h], s0, b0);
            const float y1 = scale_leaky(acc[i][j][2 * h + 1], s1, b1);
            if (EPI == kStore) {
              *reinterpret_cast<char2*>(out + (size_t)c * S +
                                        (size_t)(pos + 1) * LDO + n) =
                  make_char2((char)requant(y0), (char)requant(y1));
            } else {
              float* f = static_cast<float*>(fout) +
                         ((size_t)c * L + pos) * COUT + n;
              f[0] = y0;
              f[1] = y1;
            }
          }
        }
      }
    }
  }
}

// the backbone's five int8 tail convs (layers 2-6), as
// quant.kernel_stack_weights lays them out
struct TailWeights {
  const int8_t* w[5];
  const float* s[5];
  const float* b[5];
};

// the head's five int8 convs (the last one dequantized) and the bf16
// cls/reg linears with f32 biases
struct HeadWeights {
  const int8_t* w[5];
  const float* s[5];
  const float* b[5];
  const bf16* wc;
  const float* bc;
  const bf16* wr;
  const float* br;
};

// pointers (w, s_eff, b_eff) x 5 -> a weight struct's conv fields
template <typename T>
void fill_convs(T& t, const void* const* p) {
  for (int i = 0; i < 5; ++i) {
    t.w[i] = static_cast<const int8_t*>(p[3 * i]);
    t.s[i] = static_cast<const float*>(p[3 * i + 1]);
    t.b[i] = static_cast<const float*>(p[3 * i + 2]);
  }
}

// the head's weights from the 15 conv pointers and the cls/reg weights
inline HeadWeights head_weights(const void* const* head, const void* wc,
                                const void* bc, const void* wr,
                                const void* br) {
  HeadWeights hw;
  fill_convs(hw, head);
  hw.wc = (const bf16*)wc;
  hw.bc = (const float*)bc;
  hw.wr = (const bf16*)wr;
  hw.br = (const float*)br;
  return hw;
}

// tile stride S of a backbone block: the largest of its three stages
inline int backbone_stride(int l) {
  return round16(imax(imax((pad16(l) + 2) * ld_of(64),
                           (pad16(l / 2) + 2) * ld_of(128)),
                      (pad16(l / 4) + 2) * ld_of(256)));
}

// tile stride S of a head block
inline int head_stride(int l4) {
  return round16(imax((pad16(l4) + 2) * ld_of(256),
                      (pad16(l4 / 2) + 2) * ld_of(512)));
}

// Backbone layer 1 from the block's f32 cutouts (nv x L in cut_s) into the
// zeroed tile buf0: ((xl * w0 + x * w1) + xr * w2) + b, leaky; kFold has
// 1/in_scale folded into w and b, kDivide divides after the leaky.
template <int L1>
__device__ __forceinline__ void layer1_tile(const float* cut_s,
                                            const float* __restrict__ w1,
                                            const float* __restrict__ b1,
                                            float in_scale, int8_t* buf0,
                                            int nv, int L, int S) {
  for (int idx = threadIdx.x; idx < nv * L * 64; idx += kThreads) {
    const int c = idx / (L * 64);
    const int rem = idx - c * L * 64;
    const int p = rem >> 6, ch = rem & 63;
    const float* x = cut_s + c * L;
    const float xl = p > 0 ? x[p - 1] : 0.0f;
    const float xr = p < L - 1 ? x[p + 1] : 0.0f;
    const float a = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(xl, w1[ch]), __fmul_rn(x[p], w1[64 + ch])),
                  __fmul_rn(xr, w1[128 + ch])),
        b1[ch]);
    const float y = L1 == kDivide ? __fdiv_rn(leaky(a), in_scale) : leaky(a);
    buf0[(size_t)c * S + (size_t)(p + 1) * ld_of(64) + ch] =
        (int8_t)requant(y);
  }
}

// Backbone layers 2-6 and the gate embed on the layer-1 tile in buf0 (buf1
// zeroed; the caller synchronises after filling buf0). The int8 feats end
// in buf1 (rows 1..L/4 of each cutout) and in `feats` ((n * L/4, 256) rows
// from cutout c0 on); zx row g goes to zx_rows + g * 128 for g < nv.
__device__ __forceinline__ void backbone_tail(
    int8_t* buf0, int8_t* buf1, const TailWeights& tw,
    const bf16* __restrict__ we_t, const bf16* __restrict__ be,
    int8_t* __restrict__ feats, bf16* __restrict__ zx_rows, int c0, int nv,
    int L, int S) {
  const int L2 = L / 2, L4 = L / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  conv_s8<64, 64, kStore>(buf0, buf1, nullptr, S, L, tw.w[0], tw.s[0], tw.b[0]);
  __syncthreads();
  zero_smem(buf0, kTile * S);
  __syncthreads();
  conv_s8<64, 128, kPool>(buf1, buf0, nullptr, S, L, tw.w[1], tw.s[1], tw.b[1]);
  __syncthreads();
  zero_smem(buf1, kTile * S);
  __syncthreads();
  conv_s8<128, 128, kStore>(buf0, buf1, nullptr, S, L2, tw.w[2], tw.s[2], tw.b[2]);
  __syncthreads();
  zero_smem(buf0, kTile * S);
  __syncthreads();
  conv_s8<128, 128, kStore>(buf1, buf0, nullptr, S, L2, tw.w[3], tw.s[3], tw.b[3]);
  __syncthreads();
  zero_smem(buf1, kTile * S);
  __syncthreads();
  conv_s8<128, 256, kPool>(buf0, buf1, nullptr, S, L2, tw.w[4], tw.s[4],
                           tw.b[4]);
  __syncthreads();

  // feats: rows 1..L4 of buf1 -> (N * L4, 256) int8
  for (int idx = threadIdx.x; idx < nv * L4 * 16; idx += kThreads) {
    const int c = idx / (L4 * 16);
    const int rem = idx - c * L4 * 16;
    const int p = rem >> 4, v = rem & 15;
    reinterpret_cast<uint4*>(feats + ((size_t)(c0 + c) * L4 + p) * 256)[v] =
        reinterpret_cast<const uint4*>(buf1 + (size_t)c * S +
                                       (size_t)(p + 1) * ld_of(256))[v];
  }

  // gate embed zx = feats_flat @ We + be on bf16 operands (int8 values are
  // exact in bf16): m16n8k16 products with the block's 8 cutouts as rows g
  // (rows g+8 are zero); contraction index k = p * 256 + ch. Warp w owns
  // output columns 16w .. 16w+15 over the whole contraction. Rows g >= nv
  // (past the last cutout) only feed outputs that are not stored.
  {
    const int K = L4 * 256;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int8_t* arow = buf1 + (size_t)g * S;
    const bf16* wrow0 = we_t + (size_t)((2 * warp) * 8 + g) * K + 2 * tq;
    const bf16* wrow1 = wrow0 + (size_t)8 * K;
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      const int8_t* ap = arow + (size_t)((k0 >> 8) + 1) * ld_of(256) +
                         (k0 & 255) + 2 * tq;
      a[0] = bf16x2_of(ap[0], ap[1]);
      a[2] = bf16x2_of(ap[8], ap[9]);
      a[1] = a[3] = 0u;
      const uint32_t bw0[2] = {ldg32(wrow0 + k0), ldg32(wrow0 + k0 + 8)};
      const uint32_t bw1[2] = {ldg32(wrow1 + k0), ldg32(wrow1 + k0 + 8)};
      mma_bf16(acc[0], a, bw0);
      mma_bf16(acc[1], a, bw1);
    }
    if (g < nv) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = (2 * warp + j) * 8 + 2 * tq;
        bf16* z = zx_rows + (size_t)g * 128 + col;
        z[0] = __float2bfloat16(__fadd_rn(acc[j][0], __bfloat162float(be[col])));
        z[1] = __float2bfloat16(
            __fadd_rn(acc[j][1], __bfloat162float(be[col + 1])));
      }
    }
  }
}

// The f32 mean over positions of the head's last activation (nv x L8 x 128
// f32 rows from fout): a sequential sum, then one division, into means.
__device__ __forceinline__ void head_mean(const float* fout, float* means,
                                          int nv, int L8) {
  for (int idx = threadIdx.x; idx < nv * 128; idx += kThreads) {
    const int c = idx >> 7, ch = idx & 127;
    const float* f = fout + (size_t)c * L8 * 128 + ch;
    float s = f[0];
    for (int p = 1; p < L8; ++p) s = __fadd_rn(s, f[p * 128]);
    means[idx] = __fdiv_rn(s, (float)L8);
  }
}

// cls / reg of cutouts c0 .. c0 + nv - 1: bf16(mean) @ bf16 weights, f32
// accumulate, + f32 bias (the products of two bf16 values are exact in f32)
__device__ __forceinline__ void head_cls_reg(const float* means,
                                             const HeadWeights& hw,
                                             float* __restrict__ cls,
                                             float* __restrict__ reg, int c0,
                                             int nv, int nc) {
  for (int idx = threadIdx.x; idx < nv * (nc + 2); idx += kThreads) {
    const int c = idx / (nc + 2), j = idx - c * (nc + 2);
    const bool is_cls = j < nc;
    const bf16* w = is_cls ? hw.wc + j : hw.wr + (j - nc);
    const int ldw = is_cls ? nc : 2;
    float acc = 0.0f;
    for (int k = 0; k < 128; ++k)
      acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(__float2bfloat16(
                                         means[c * 128 + k])),
                                     __bfloat162float(w[k * ldw])));
    if (is_cls)
      cls[(size_t)(c0 + c) * nc + j] = __fadd_rn(acc, hw.bc[j]);
    else
      reg[(size_t)(c0 + c) * 2 + (j - nc)] = __fadd_rn(acc, hw.br[j - nc]);
  }
}

// The head on the int8 template tile in buf0 (buf1 zeroed; the caller
// synchronises after filling buf0): convs (conv, conv, conv, pool/2, conv,
// conv), the last one dequantized into f32 over buf1; the f32 mean over
// positions (a sequential sum, then one division) into `means` (kTile x
// 128 f32); cls and reg of cutouts c0 .. c0 + nv - 1 from bf16(mean) and
// bf16 weights with f32 accumulation. buf0 and buf1 are clobbered.
__device__ __forceinline__ void head_body(int8_t* buf0, int8_t* buf1,
                                          float* means, const HeadWeights& hw,
                                          float* __restrict__ cls,
                                          float* __restrict__ reg, int c0,
                                          int nv, int L4, int nc, int S) {
  const int L8 = L4 / 2;
  conv_s8<256, 256, kStore>(buf0, buf1, nullptr, S, L4, hw.w[0], hw.s[0],
                            hw.b[0]);
  __syncthreads();
  zero_smem(buf0, kTile * S);
  __syncthreads();
  conv_s8<256, 256, kStore>(buf1, buf0, nullptr, S, L4, hw.w[1], hw.s[1],
                            hw.b[1]);
  __syncthreads();
  zero_smem(buf1, kTile * S);
  __syncthreads();
  conv_s8<256, 512, kPool>(buf0, buf1, nullptr, S, L4, hw.w[2], hw.s[2],
                           hw.b[2]);
  __syncthreads();
  zero_smem(buf0, kTile * S);
  __syncthreads();
  conv_s8<512, 256, kStore>(buf1, buf0, nullptr, S, L8, hw.w[3], hw.s[3],
                            hw.b[3]);
  __syncthreads();
  // the last conv is dequantized: f32 activations into the free buffer
  float* fout = reinterpret_cast<float*>(buf1);
  conv_s8<256, 128, kMean>(buf0, nullptr, fout, S, L8, hw.w[4], hw.s[4],
                           hw.b[4]);
  __syncthreads();

  head_mean(fout, means, nv, L8);
  __syncthreads();
  head_cls_reg(means, hw, cls, reg, c0, nv, nc);
}

}  // namespace
