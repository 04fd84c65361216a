// K5 (int8 backbone + gate embed) and K7 (int8 detection head) for Hopper
// (sm_90a).
//
// K5 replaces planar_optical_flow_tpu/ops/pallas/conv_stack.py
// fused_backbone_int8_p2 (l1_mode="mm", int8 output, with embed_weights;
// body _layer1_p2_mm, _run_plan_int8_p2, _run_plan_int8_pm, _embed_acc_pm).
// K7 replaces fused_head_int8_pm (_head_int8_pm_kernel, _HEAD_PLAN,
// _head_cls_reg).
//
// What they compute, per cutout:
//   K5: layer 1 from the f32 cutout (3 taps in f32 with 1/in_scale folded
//       into the weights, leaky, rint, clip to +-127), then backbone layers
//       2-6 (conv, conv, pool/2, conv, conv, conv, pool/2) as int8 x int8 ->
//       int32 convs with the f32 epilogue
//         q = clip(rint(leaky(f32(acc) * s_eff + b_eff)), -127, 127),
//       int8 feats (L/4 positions x 256) at the last layer's scale, and
//       zx = bf16(feats @ (W * feat_scale) + b) on bf16 operands with f32
//       accumulation.
//   K7: head convs (conv, conv, conv, pool/2, conv, conv) on the int8
//       template; the last conv is dequantized (no requant); the f32 mean
//       over positions (a sequential sum, then one division); cls and reg
//       from bf16(mean) and bf16 weights with f32 accumulation.
// Every f32 step is spelled with __f*_rn intrinsics in the JAX order, so no
// multiply-add is contracted; rint is round-half-to-even. Max-pool is taken
// on the int32 sums before the epilogue: the epilogue is monotone, so this
// gives the same bits as pooling after it (conv_stack.py _scale_leaky).
//
// Design. A block owns kTile cutouts and keeps their activations in shared
// memory across every layer, as K2/K4 do: device memory sees the f32 cutouts
// (or the int8 template) in and the outputs only. Per cutout, rows of C int8
// channels padded to C + 16 bytes (the eight rows an MMA fragment load
// touches then fall in different banks); row 0 and the rows past the last
// position are zero, position p sits in row p + 1. A k=3 SAME conv is then
// one product over K = 3 * Cin, the A row of output position p reading rows
// p, p + 1, p + 2 of the buffer. The products run on the int8 tensor cores
// with mma.sync.m16n8k32 (s8 x s8 -> s32, exact); a warp task is eight
// 16-position tiles x 16 output channels, so each weight fragment, read from
// global memory (L2 resident), feeds eight products. The weights come as
// (Cout, 3 * Cin): each output channel's taps are contiguous, the column
// operand's layout. The TPU kernels' position-major rows and pack-2 lanes
// are TPU layout devices and are not carried over: the int32 sums are the
// same in any layout.
//
// Bound: tensor-core operations at the int8 peak: about 16.1 M operations
// per cutout for K5 at L=56 (the bf16 embed included) and 28.9 M for K7 at
// L/4=14, against ~0.4 KB and ~3.6 KB of device-memory traffic. Positions
// are padded to 16 per MMA tile, which wastes 12% of K5's and up to 56% of
// K7's last two convs (7 positions in a 16-row tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;    // cutouts per block (= the embed MMA's rows)
constexpr int kPad = 16;    // shared-memory row padding (bytes)
constexpr int kMTiles = 8;  // 16-position tiles per warp task
constexpr int kNTiles = 2;  // 8-channel tiles per warp task
static_assert(kTile % kMTiles == 0,
              "a warp task's tiles must not run past the block's cutouts");
constexpr unsigned kFull = 0xffffffffu;

enum Epilogue { kStore = 0, kPool = 1, kMean = 2 };

__host__ __device__ constexpr int ld_of(int c) { return c + kPad; }
__host__ __device__ inline int pad16(int x) { return (x + 15) / 16 * 16; }
inline int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float leaky(float v) {
  return v > 0.0f ? v : __fmul_rn(0.1f, v);
}

// f32(acc) * s_eff + b_eff with two roundings, then leaky
__device__ __forceinline__ float scale_leaky(int acc, float s, float b) {
  return leaky(__fadd_rn(__fmul_rn(__int2float_rn(acc), s), b));
}

__device__ __forceinline__ int requant(float v) {
  return (int)fminf(fmaxf(rintf(v), -127.0f), 127.0f);
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

// D += A (16x32 s8, row) * B (32x8 s8, col), s32 accumulate
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

__device__ void zero_smem(int8_t* p, int n_bytes) {
  const uint4 z = make_uint4(0, 0, 0, 0);
  uint4* q = reinterpret_cast<uint4*>(p);
  for (int i = threadIdx.x; i < n_bytes / 16; i += blockDim.x) q[i] = z;
}

// One k=3 SAME int8 conv over the block's kTile cutouts: `in` (CIN channels,
// L positions, per-cutout stride S bytes) -> `out` (COUT channels, int8
// requantized; pooled to L/2 positions for kPool) or, for kMean, the f32
// activation into `fout` (kTile x L x COUT). W: (COUT, 3*CIN) int8.
// Fragment layouts (PTX ISA, mma.m16n8k32 .s8): lane = 4 * g + tq; A
// registers hold rows g / g+8 at k = 4tq.. and 16+4tq..; B registers hold
// column g at k = 4tq.. and 16+4tq..; D holds rows g / g+8 at columns 2tq,
// 2tq+1.
template <int CIN, int COUT, int EPI>
__device__ void conv_s8(const int8_t* in, int8_t* out, float* fout, int S,
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
          const int8_t* ap = in + (size_t)c * S +
                             (size_t)(16 * m + t + g) * LDI + kk + 4 * tq;
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
              if (pos < L) {
                *reinterpret_cast<char2*>(
                    out + (size_t)c * S + (size_t)(pos / 2 + 1) * LDO + n) =
                    make_char2((char)requant(scale_leaky(v[2 * h], s0, b0)),
                               (char)requant(scale_leaky(v[2 * h + 1], s1, b1)));
              }
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
              float* f = fout + ((size_t)c * L + pos) * COUT + n;
              f[0] = y0;
              f[1] = y1;
            }
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    backbone_int8_kernel(const float* __restrict__ cut,
                         const float* __restrict__ w1, const float* __restrict__ b1,
                         const int8_t* __restrict__ w2, const float* __restrict__ s2,
                         const float* __restrict__ c2,
                         const int8_t* __restrict__ w3, const float* __restrict__ s3,
                         const float* __restrict__ c3,
                         const int8_t* __restrict__ w4, const float* __restrict__ s4,
                         const float* __restrict__ c4,
                         const int8_t* __restrict__ w5, const float* __restrict__ s5,
                         const float* __restrict__ c5,
                         const int8_t* __restrict__ w6, const float* __restrict__ s6,
                         const float* __restrict__ c6,
                         const bf16* __restrict__ we_t, const bf16* __restrict__ be,
                         int8_t* __restrict__ feats, bf16* __restrict__ zx,
                         int n, int L, int S) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* buf0 = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* buf1 = buf0 + (size_t)kTile * S;
  float* cut_s = reinterpret_cast<float*>(buf1 + (size_t)kTile * S);
  const int c0 = blockIdx.x * kTile;
  const int nv = min(kTile, n - c0);
  const int L2 = L / 2, L4 = L / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  zero_smem(buf0, kTile * S);
  zero_smem(buf1, kTile * S);
  for (int idx = threadIdx.x; idx < nv * L; idx += kThreads)
    cut_s[idx] = cut[(size_t)c0 * L + idx];
  __syncthreads();

  // layer 1: ((xl * w0 + x * w1) + xr * w2) + b, 1/in_scale folded in
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
    buf0[(size_t)c * S + (size_t)(p + 1) * ld_of(64) + ch] =
        (int8_t)requant(leaky(a));
  }
  __syncthreads();
  conv_s8<64, 64, kStore>(buf0, buf1, nullptr, S, L, w2, s2, c2);
  __syncthreads();
  zero_smem(buf0, kTile * S);
  __syncthreads();
  conv_s8<64, 128, kPool>(buf1, buf0, nullptr, S, L, w3, s3, c3);
  __syncthreads();
  zero_smem(buf1, kTile * S);
  __syncthreads();
  conv_s8<128, 128, kStore>(buf0, buf1, nullptr, S, L2, w4, s4, c4);
  __syncthreads();
  zero_smem(buf0, kTile * S);
  __syncthreads();
  conv_s8<128, 128, kStore>(buf1, buf0, nullptr, S, L2, w5, s5, c5);
  __syncthreads();
  zero_smem(buf1, kTile * S);
  __syncthreads();
  conv_s8<128, 256, kPool>(buf0, buf1, nullptr, S, L2, w6, s6, c6);
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
  // output columns 16w .. 16w+15 over the whole contraction.
  {
    const int K = L4 * 256;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int8_t* arow = buf1 + (size_t)g * S;
    const bf16* wrow0 = we_t + (size_t)((2 * warp) * 8 + g) * K + 2 * tq;
    const bf16* wrow1 = wrow0 + (size_t)8 * K;
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int8_t* ap = arow + (size_t)((k0 >> 8) + 1) * ld_of(256) +
                         (k0 & 255) + 2 * tq;
      const uint32_t a[4] = {bf16x2_of(ap[0], ap[1]), 0u,
                             bf16x2_of(ap[8], ap[9]), 0u};
      const uint32_t bw0[2] = {ldg32(wrow0 + k0), ldg32(wrow0 + k0 + 8)};
      const uint32_t bw1[2] = {ldg32(wrow1 + k0), ldg32(wrow1 + k0 + 8)};
      mma_bf16(acc[0], a, bw0);
      mma_bf16(acc[1], a, bw1);
    }
    if (g < nv) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = (2 * warp + j) * 8 + 2 * tq;
        bf16* z = zx + (size_t)(c0 + g) * 128 + col;
        z[0] = __float2bfloat16(__fadd_rn(acc[j][0], __bfloat162float(be[col])));
        z[1] = __float2bfloat16(
            __fadd_rn(acc[j][1], __bfloat162float(be[col + 1])));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    head_int8_kernel(const int8_t* __restrict__ tmpl,
                     const int8_t* __restrict__ w1, const float* __restrict__ s1,
                     const float* __restrict__ c1,
                     const int8_t* __restrict__ w2, const float* __restrict__ s2,
                     const float* __restrict__ c2,
                     const int8_t* __restrict__ w3, const float* __restrict__ s3,
                     const float* __restrict__ c3,
                     const int8_t* __restrict__ w4, const float* __restrict__ s4,
                     const float* __restrict__ c4,
                     const int8_t* __restrict__ w5, const float* __restrict__ s5,
                     const float* __restrict__ c5,
                     const bf16* __restrict__ wc, const float* __restrict__ bc,
                     const bf16* __restrict__ wr, const float* __restrict__ br,
                     float* __restrict__ cls, float* __restrict__ reg, int n,
                     int L4, int nc, int S) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* buf0 = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* buf1 = buf0 + (size_t)kTile * S;
  float* means = reinterpret_cast<float*>(buf1 + (size_t)kTile * S);  // T x 128
  const int c0 = blockIdx.x * kTile;
  const int nv = min(kTile, n - c0);
  const int L8 = L4 / 2;

  zero_smem(buf0, kTile * S);
  zero_smem(buf1, kTile * S);
  __syncthreads();
  for (int idx = threadIdx.x; idx < nv * L4 * 16; idx += kThreads) {
    const int c = idx / (L4 * 16);
    const int rem = idx - c * L4 * 16;
    const int p = rem >> 4, v = rem & 15;
    reinterpret_cast<uint4*>(buf0 + (size_t)c * S +
                             (size_t)(p + 1) * ld_of(256))[v] =
        reinterpret_cast<const uint4*>(tmpl + ((size_t)(c0 + c) * L4 + p) * 256)[v];
  }
  __syncthreads();
  conv_s8<256, 256, kStore>(buf0, buf1, nullptr, S, L4, w1, s1, c1);
  __syncthreads();
  zero_smem(buf0, kTile * S);
  __syncthreads();
  conv_s8<256, 256, kStore>(buf1, buf0, nullptr, S, L4, w2, s2, c2);
  __syncthreads();
  zero_smem(buf1, kTile * S);
  __syncthreads();
  conv_s8<256, 512, kPool>(buf0, buf1, nullptr, S, L4, w3, s3, c3);
  __syncthreads();
  zero_smem(buf0, kTile * S);
  __syncthreads();
  conv_s8<512, 256, kStore>(buf1, buf0, nullptr, S, L8, w4, s4, c4);
  __syncthreads();
  // the last conv is dequantized: f32 activations into the free buffer
  float* fout = reinterpret_cast<float*>(buf1);
  conv_s8<256, 128, kMean>(buf0, nullptr, fout, S, L8, w5, s5, c5);
  __syncthreads();

  // mean over positions: sequential f32 sum, then one division
  for (int idx = threadIdx.x; idx < nv * 128; idx += kThreads) {
    const int c = idx >> 7, ch = idx & 127;
    const float* f = fout + (size_t)c * L8 * 128 + ch;
    float s = f[0];
    for (int p = 1; p < L8; ++p) s = __fadd_rn(s, f[p * 128]);
    means[idx] = __fdiv_rn(s, (float)L8);
  }
  __syncthreads();

  // cls / reg: bf16(mean) @ bf16 weights, f32 accumulate, + f32 bias (the
  // products of two bf16 values are exact in f32)
  for (int idx = threadIdx.x; idx < nv * (nc + 2); idx += kThreads) {
    const int c = idx / (nc + 2), j = idx - c * (nc + 2);
    const bool is_cls = j < nc;
    const bf16* w = is_cls ? wc + j : wr + (j - nc);
    const int ldw = is_cls ? nc : 2;
    float acc = 0.0f;
    for (int k = 0; k < 128; ++k)
      acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(__float2bfloat16(
                                         means[c * 128 + k])),
                                     __bfloat162float(w[k * ldw])));
    if (is_cls)
      cls[(size_t)(c0 + c) * nc + j] = __fadd_rn(acc, bc[j]);
    else
      reg[(size_t)(c0 + c) * 2 + (j - nc)] = __fadd_rn(acc, br[j - nc]);
  }
}

int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int round16(int x) { return (x + 15) / 16 * 16; }

size_t backbone_int8_smem(int l, int* S) {
  *S = round16(imax(imax((pad16(l) + 2) * ld_of(64),
                         (pad16(l / 2) + 2) * ld_of(128)),
                    (pad16(l / 4) + 2) * ld_of(256)));
  return 2 * (size_t)kTile * *S + (size_t)kTile * l * sizeof(float);
}

size_t head_int8_smem(int l4, int* S) {
  *S = round16(imax((pad16(l4) + 2) * ld_of(256),
                    (pad16(l4 / 2) + 2) * ld_of(512)));
  return 2 * (size_t)kTile * *S + (size_t)kTile * 128 * sizeof(float);
}

}  // namespace

// dynamic shared memory a launch at these lengths asks for (bytes)
extern "C" long long backbone_int8_smem_bytes(int l) {
  int S;
  return (long long)backbone_int8_smem(l, &S);
}

extern "C" long long head_int8_smem_bytes(int l4) {
  int S;
  return (long long)head_int8_smem(l4, &S);
}

extern "C" int backbone_int8_launch(
    const void* cut, const void* w1, const void* b1, const void* w2,
    const void* s2, const void* c2, const void* w3, const void* s3,
    const void* c3, const void* w4, const void* s4, const void* c4,
    const void* w5, const void* s5, const void* c5, const void* w6,
    const void* s6, const void* c6, const void* we_t, const void* be,
    void* feats, void* zx, int n, int l, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  int S;
  const size_t smem = backbone_int8_smem(l, &S);
  int err = set_smem((const void*)backbone_int8_kernel, smem);
  if (err) return err;
  const int grid = (n + kTile - 1) / kTile;
  backbone_int8_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)cut, (const float*)w1, (const float*)b1,
      (const int8_t*)w2, (const float*)s2, (const float*)c2,
      (const int8_t*)w3, (const float*)s3, (const float*)c3,
      (const int8_t*)w4, (const float*)s4, (const float*)c4,
      (const int8_t*)w5, (const float*)s5, (const float*)c5,
      (const int8_t*)w6, (const float*)s6, (const float*)c6,
      (const bf16*)we_t, (const bf16*)be, (int8_t*)feats, (bf16*)zx, n, l, S);
  return (int)cudaGetLastError();
}

extern "C" int head_int8_launch(
    const void* tmpl, const void* w1, const void* s1, const void* c1,
    const void* w2, const void* s2, const void* c2, const void* w3,
    const void* s3, const void* c3, const void* w4, const void* s4,
    const void* c4, const void* w5, const void* s5, const void* c5,
    const void* wc, const void* bc, const void* wr, const void* br, void* cls,
    void* reg, int n, int l4, int nc, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  int S;
  const size_t smem = head_int8_smem(l4, &S);
  int err = set_smem((const void*)head_int8_kernel, smem);
  if (err) return err;
  const int grid = (n + kTile - 1) / kTile;
  head_int8_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)tmpl, (const int8_t*)w1, (const float*)s1,
      (const float*)c1, (const int8_t*)w2, (const float*)s2, (const float*)c2,
      (const int8_t*)w3, (const float*)s3, (const float*)c3,
      (const int8_t*)w4, (const float*)s4, (const float*)c4,
      (const int8_t*)w5, (const float*)s5, (const float*)c5, (const bf16*)wc,
      (const float*)bc, (const bf16*)wr, (const float*)br, (float*)cls,
      (float*)reg, n, l4, nc, S);
  return (int)cudaGetLastError();
}
