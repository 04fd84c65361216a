// K14: the fused DROW backbone and head of the round-1 serving step, f32 and
// bf16, for Hopper (sm_90a).
//
// Replaces planar_optical_flow_tpu/ops/pallas/fused_drow.py fused_backbone
// (kernel _backbone_kernel) and fused_head (_head_kernel), which
// make_fused_stream_step runs. The backbone takes (N, L) f32 cutouts through
// all six k=3 SAME convs (1 -> 64 -> 64 -> 128, pool/2, 128 -> 128 -> 256,
// pool/2) to (N, L/4, 256) f32 feats; the head takes feats through 256 ->
// 256 -> 512, pool/2, 512 -> 256 -> 128, the mean over positions and the
// cls/reg linears. BatchNorm is folded into every conv, LeakyReLU 0.1 after
// each.
//
// Rounding follows the JAX kernels' _conv3 in each compute dtype:
// * f32: f32 operands, products and sums throughout (FFMA: TF32 operands
//   would miss the JAX test's 1e-3 bar);
// * bf16: every conv input rounded to bf16 (the cutouts and the head's f32
//   feats included), bf16 weights, f32 accumulation + bias + leaky, each
//   activation stored in bf16 (max-pool commutes with the monotonic
//   rounding); the feats leave as f32 holding those bf16 values; the head
//   averages the bf16 activations of its last conv in f32, rounds the mean
//   to bf16 and multiplies it by the bf16 linears with f32 accumulation.
// The mean over positions is a running sum times the f32 reciprocal of the
// count, the form XLA gives jnp.mean's division by a constant.
//
// Both modes keep a tile of cutouts in shared memory across every layer, so
// device memory sees the cutouts, the weights and the outputs only.
// * bf16: K2's and K4's tensor-core conv layer (conv_bf16.cuh), 8 cutouts a
//   backbone block and 4 a head block, with layer 1 (Cin = 1) computed per
//   position from the cutouts.
// * f32: a register-tiled FFMA product per layer: each thread computes 4
//   consecutive positions of one cutout x 8 output channels (the head 8 x
//   4), reading the activations from shared memory (rows of C + 4 floats;
//   position p in row p + 1, zero rows around) and the weights through
//   L1/L2. 4 cutouts a block (an f32 activation is 4 times a bf16 one), one
//   block an SM, 512 threads so that enough weight loads are in flight (256
//   threads: 1.6x slower for the backbone, 1.3x for the head, on the H100;
//   the head's 4 x 8 tasks 1.2x slower than 8 x 4).
// Both handle a partial last tile (N need not be a multiple of the tile).
//
// Bound: operations. At L=56, ~15.2 MFLOP a cutout for the backbone and
// ~28.9 MFLOP for the head, against 224 B in and 14 KB out (the backbone)
// and 14 KB in (the head): f32 at 67 TFLOP/s, bf16 at 989 TFLOP/s.

#include "conv_bf16.cuh"

namespace {

// ---------------------------------------------------------------- bf16
constexpr int kTileBackbone = 8;  // cutouts per block
constexpr int kTileHead = 4;
constexpr int kMTilesBackbone = 8;  // 16-position tiles per warp task
constexpr int kMTilesHead = 4;

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Layer 1 (Cin = 1) of cutouts c0 .. c0 + nv - 1 into rows p + 1 of `out`
// (64 channels a row, stride ldo, S per cutout): acc = ((xl * w0 + x * w1) +
// xr * w2) + b over the taps of position p, zero beyond the cutout. bf16
// mode rounds the cutout values to bf16 (the weights arrive rounded), so
// every product is exact in f32.
template <typename Out, bool kRound>
__device__ void layer1(const float* __restrict__ cut, Out* out, int c0,
                       int nv, int L, int S, int ldo,
                       const Out* __restrict__ w, const float* __restrict__ b) {
  for (int idx = threadIdx.x; idx < nv * L * 64; idx += blockDim.x) {
    const int c = idx / (L * 64);
    const int rem = idx - c * L * 64;
    const int p = rem >> 6, co = rem & 63;
    const float* x = cut + (size_t)(c0 + c) * L;
    float xl = p > 0 ? x[p - 1] : 0.0f, xm = x[p];
    float xr = p + 1 < L ? x[p + 1] : 0.0f;
    if (kRound) {
      xl = bf16r(xl);
      xm = bf16r(xm);
      xr = bf16r(xr);
    }
    float acc = xl * (float)w[co];
    acc = fmaf(xm, (float)w[64 + co], acc);
    acc = fmaf(xr, (float)w[128 + co], acc);
    const float v = leaky(acc + b[co]);
    out[(size_t)c * S + (size_t)(p + 1) * ldo + co] = (Out)v;
  }
}

__global__ void __launch_bounds__(kThreads)
    backbone_bf16_kernel(const float* __restrict__ cut,
                         const bf16* __restrict__ w1, const float* __restrict__ b1,
                         const bf16* __restrict__ w2, const float* __restrict__ b2,
                         const bf16* __restrict__ w3, const float* __restrict__ b3,
                         const bf16* __restrict__ w4, const float* __restrict__ b4,
                         const bf16* __restrict__ w5, const float* __restrict__ b5,
                         const bf16* __restrict__ w6, const float* __restrict__ b6,
                         float* __restrict__ feats, int n, int L, int S) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int T = kTileBackbone;
  bf16* buf0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* buf1 = buf0 + (size_t)T * S;
  float* stage = reinterpret_cast<float*>(buf1 + (size_t)T * S) +
                 (threadIdx.x >> 5) * 256;
  const int c0 = blockIdx.x * T;
  const int nv = min(T, n - c0);
  const int L2 = L / 2, L4 = L / 4;

  zero_smem(buf0, T * S);
  zero_smem(buf1, T * S);
  __syncthreads();
  layer1<bf16, true>(cut, buf0, c0, nv, L, S, ld_of(64), w1, b1);
  __syncthreads();
  conv_layer<64, 64, kStore, kMTilesBackbone>(buf0, buf1, nullptr, S, L, T, w2, b2, stage);
  __syncthreads();
  zero_smem(buf0, T * S);
  __syncthreads();
  conv_layer<64, 128, kPool, kMTilesBackbone>(buf1, buf0, nullptr, S, L, T, w3, b3, stage);
  __syncthreads();
  zero_smem(buf1, T * S);
  __syncthreads();
  conv_layer<128, 128, kStore, kMTilesBackbone>(buf0, buf1, nullptr, S, L2, T, w4, b4, stage);
  __syncthreads();
  zero_smem(buf0, T * S);
  __syncthreads();
  conv_layer<128, 128, kStore, kMTilesBackbone>(buf1, buf0, nullptr, S, L2, T, w5, b5, stage);
  __syncthreads();
  zero_smem(buf1, T * S);
  __syncthreads();
  conv_layer<128, 256, kPool, kMTilesBackbone>(buf0, buf1, nullptr, S, L2, T, w6, b6, stage);
  __syncthreads();

  // feats: rows 1..L4 of buf1 -> (N, L4, 256) f32
  for (int idx = threadIdx.x; idx < nv * L4 * 128; idx += kThreads) {
    const int c = idx / (L4 * 128);
    const int rem = idx - c * L4 * 128;
    const int p = rem >> 7, v = rem & 127;
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        buf1 + (size_t)c * S + (size_t)(p + 1) * ld_of(256) + 2 * v));
    *reinterpret_cast<float2*>(feats + ((size_t)(c0 + c) * L4 + p) * 256 +
                               2 * v) = f;
  }
}

// the cls/reg linears of the block's cutouts: acc over the 128 means (rounded
// to bf16 first in bf16 mode) times the weights, + f32 bias
template <typename W, bool kRound>
__device__ void cls_reg(const float* means, const W* __restrict__ wc,
                        const float* __restrict__ bc, const W* __restrict__ wr,
                        const float* __restrict__ br, float* __restrict__ cls,
                        float* __restrict__ reg, int c0, int nv, int nc) {
  for (int idx = threadIdx.x; idx < nv * (nc + 2); idx += blockDim.x) {
    const int c = idx / (nc + 2), j = idx - c * (nc + 2);
    const bool is_cls = j < nc;
    const W* w = is_cls ? wc + j : wr + (j - nc);
    const int ldw = is_cls ? nc : 2;
    float acc = 0.0f;
    for (int k = 0; k < 128; ++k) {
      const float m = means[c * 128 + k];
      acc += (kRound ? bf16r(m) : m) * (float)w[k * ldw];
    }
    if (is_cls)
      cls[(size_t)(c0 + c) * nc + j] = acc + bc[j];
    else
      reg[(size_t)(c0 + c) * 2 + (j - nc)] = acc + br[j - nc];
  }
}

__global__ void __launch_bounds__(kThreads)
    head_bf16_kernel(const float* __restrict__ feats,
                     const bf16* __restrict__ w1, const float* __restrict__ b1,
                     const bf16* __restrict__ w2, const float* __restrict__ b2,
                     const bf16* __restrict__ w3, const float* __restrict__ b3,
                     const bf16* __restrict__ w4, const float* __restrict__ b4,
                     const bf16* __restrict__ w5, const float* __restrict__ b5,
                     const bf16* __restrict__ wc, const float* __restrict__ bc,
                     const bf16* __restrict__ wr, const float* __restrict__ br,
                     float* __restrict__ cls, float* __restrict__ reg, int n,
                     int L4, int nc, int S) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int T = kTileHead;
  bf16* buf0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* buf1 = buf0 + (size_t)T * S;
  float* stage_all = reinterpret_cast<float*>(buf1 + (size_t)T * S);
  float* means = stage_all + kWarps * 256;  // T x 128
  float* stage = stage_all + (threadIdx.x >> 5) * 256;
  const int c0 = blockIdx.x * T;
  const int nv = min(T, n - c0);
  const int L8 = L4 / 2;

  zero_smem(buf0, T * S);
  zero_smem(buf1, T * S);
  __syncthreads();
  // the f32 feats, rounded to bf16, into rows 1..L4
  for (int idx = threadIdx.x; idx < nv * L4 * 128; idx += kThreads) {
    const int c = idx / (L4 * 128);
    const int rem = idx - c * L4 * 128;
    const int p = rem >> 7, v = rem & 127;
    const float2 f = *reinterpret_cast<const float2*>(
        feats + ((size_t)(c0 + c) * L4 + p) * 256 + 2 * v);
    *reinterpret_cast<__nv_bfloat162*>(
        buf0 + (size_t)c * S + (size_t)(p + 1) * ld_of(256) + 2 * v) =
        __floats2bfloat162_rn(f.x, f.y);
  }
  __syncthreads();
  conv_layer<256, 256, kStore, kMTilesHead>(buf0, buf1, nullptr, S, L4, T, w1, b1, stage);
  __syncthreads();
  zero_smem(buf0, T * S);
  __syncthreads();
  conv_layer<256, 256, kStore, kMTilesHead>(buf1, buf0, nullptr, S, L4, T, w2, b2, stage);
  __syncthreads();
  zero_smem(buf1, T * S);
  __syncthreads();
  conv_layer<256, 512, kPool, kMTilesHead>(buf0, buf1, nullptr, S, L4, T, w3, b3, stage);
  __syncthreads();
  zero_smem(buf0, T * S);
  __syncthreads();
  conv_layer<512, 256, kStore, kMTilesHead>(buf1, buf0, nullptr, S, L8, T, w4, b4, stage);
  __syncthreads();
  conv_layer<256, 128, kMeanRound, kMTilesHead>(buf0, nullptr, means, S, L8, T, w5, b5, stage);
  __syncthreads();
  cls_reg<bf16, true>(means, wc, bc, wr, br, cls, reg, c0, nv, nc);
}

// ----------------------------------------------------------------- f32
constexpr int kTileF32 = 4;  // cutouts per block
constexpr int kF32Threads = 512;  // 16 warps: more loads in flight
// a thread task: RM positions x RN channels; the backbone takes 4 x 8, the
// head 8 x 4 (half the weight loads per multiply-add; its lengths, 14 and 7
// at L=56, pad to multiples of 8 as they do to 4)
constexpr int kRMBackbone = 4, kRNBackbone = 8;
constexpr int kRMHead = 8, kRNHead = 4;

__host__ __device__ inline int rup(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int ldf(int c) { return c + 4; }

__device__ void zero_f32(float* p, int n) {
  float4* q = reinterpret_cast<float4*>(p);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
    q[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One k=3 SAME conv over the tile in f32: `in` (CIN channels, L positions
// and zero rows up to rup(L, RM) + 1) -> `out` (COUT channels; pooled to
// L/2 with POOL, L even). A task: positions p0 .. p0 + RM - 1 of one cutout
// x channels g * RN .. g * RN + RN - 1; the three taps are rows p0 + r + t
// of `in`. Outputs at positions >= L are written as zero (the next layer's
// padding).
template <int CIN, int COUT, bool POOL, int kRM, int kRN>
__device__ void conv_f32(const float* in, float* out, int S, int L, int T,
                         const float* __restrict__ W,
                         const float* __restrict__ bias) {
  constexpr int LDI = ldf(CIN), LDO = ldf(COUT), NG = COUT / kRN;
  const int mg = rup(L, kRM) / kRM;  // position groups a cutout
  const int tasks = T * mg * NG;
  for (int task = threadIdx.x; task < tasks; task += blockDim.x) {
    const int g = task % NG, m = task / NG;
    const int c = m / mg, p0 = (m - c * mg) * kRM;
    const float* a = in + (size_t)c * S + (size_t)p0 * LDI;
    const float* w = W + g * kRN;
    float acc[kRM][kRN];
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int j = 0; j < kRN; ++j) acc[r][j] = 0.0f;
    for (int t = 0; t < 3; ++t) {
      for (int k = 0; k < CIN; k += 4) {
        float av[kRM][4];
#pragma unroll
        for (int r = 0; r < kRM; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(
              a + (size_t)(r + t) * LDI + k);
          av[r][0] = v.x;
          av[r][1] = v.y;
          av[r][2] = v.z;
          av[r][3] = v.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* wr = w + (size_t)(t * CIN + k + kk) * COUT;
          float bv[kRN];
#pragma unroll
          for (int j = 0; j < kRN; j += 4) {
            const float4 b4 = __ldg(reinterpret_cast<const float4*>(wr + j));
            bv[j] = b4.x;
            bv[j + 1] = b4.y;
            bv[j + 2] = b4.z;
            bv[j + 3] = b4.w;
          }
#pragma unroll
          for (int r = 0; r < kRM; ++r)
#pragma unroll
            for (int j = 0; j < kRN; ++j)
              acc[r][j] = fmaf(av[r][kk], bv[j], acc[r][j]);
        }
      }
    }
    float bb[kRN];
#pragma unroll
    for (int j = 0; j < kRN; ++j) bb[j] = bias[g * kRN + j];
    if (!POOL) {
#pragma unroll
      for (int r = 0; r < kRM; ++r) {
        const bool live = p0 + r < L;
        float v[kRN];
#pragma unroll
        for (int j = 0; j < kRN; ++j)
          v[j] = live ? leaky(acc[r][j] + bb[j]) : 0.0f;
        float* o = out + (size_t)c * S + (size_t)(p0 + r + 1) * LDO + g * kRN;
#pragma unroll
        for (int j = 0; j < kRN; j += 4)
          *reinterpret_cast<float4*>(o + j) =
              make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRM; r += 2) {
        const bool live = p0 + r < L;  // L even: p0 + r + 1 < L too
        float v[kRN];
#pragma unroll
        for (int j = 0; j < kRN; ++j)
          v[j] = live ? fmaxf(leaky(acc[r][j] + bb[j]),
                              leaky(acc[r + 1][j] + bb[j]))
                      : 0.0f;
        float* o = out + (size_t)c * S + (size_t)((p0 + r) / 2 + 1) * LDO +
                   g * kRN;
#pragma unroll
        for (int j = 0; j < kRN; j += 4)
          *reinterpret_cast<float4*>(o + j) =
              make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
    }
  }
}

__global__ void __launch_bounds__(kF32Threads)
    backbone_f32_kernel(const float* __restrict__ cut,
                        const float* __restrict__ w1, const float* __restrict__ b1,
                        const float* __restrict__ w2, const float* __restrict__ b2,
                        const float* __restrict__ w3, const float* __restrict__ b3,
                        const float* __restrict__ w4, const float* __restrict__ b4,
                        const float* __restrict__ w5, const float* __restrict__ b5,
                        const float* __restrict__ w6, const float* __restrict__ b6,
                        float* __restrict__ feats, int n, int L, int S) {
  extern __shared__ __align__(128) float fsm[];
  constexpr int T = kTileF32;
  float* buf0 = fsm;
  float* buf1 = fsm + (size_t)T * S;
  const int c0 = blockIdx.x * T;
  const int nv = min(T, n - c0);
  const int L2 = L / 2, L4 = L / 4;

  zero_f32(buf0, T * S);
  zero_f32(buf1, T * S);
  __syncthreads();
  layer1<float, false>(cut, buf0, c0, nv, L, S, ldf(64), w1, b1);
  __syncthreads();
  conv_f32<64, 64, false, kRMBackbone, kRNBackbone>(buf0, buf1, S, L, T, w2, b2);
  __syncthreads();
  zero_f32(buf0, T * S);
  __syncthreads();
  conv_f32<64, 128, true, kRMBackbone, kRNBackbone>(buf1, buf0, S, L, T, w3, b3);
  __syncthreads();
  zero_f32(buf1, T * S);
  __syncthreads();
  conv_f32<128, 128, false, kRMBackbone, kRNBackbone>(buf0, buf1, S, L2, T, w4, b4);
  __syncthreads();
  zero_f32(buf0, T * S);
  __syncthreads();
  conv_f32<128, 128, false, kRMBackbone, kRNBackbone>(buf1, buf0, S, L2, T, w5, b5);
  __syncthreads();
  zero_f32(buf1, T * S);
  __syncthreads();
  conv_f32<128, 256, true, kRMBackbone, kRNBackbone>(buf0, buf1, S, L2, T, w6, b6);
  __syncthreads();

  for (int idx = threadIdx.x; idx < nv * L4 * 64; idx += kF32Threads) {
    const int c = idx / (L4 * 64);
    const int rem = idx - c * L4 * 64;
    const int p = rem >> 6, v = rem & 63;
    *reinterpret_cast<float4*>(feats + ((size_t)(c0 + c) * L4 + p) * 256 +
                               4 * v) =
        *reinterpret_cast<const float4*>(buf1 + (size_t)c * S +
                                         (size_t)(p + 1) * ldf(256) + 4 * v);
  }
}

__global__ void __launch_bounds__(kF32Threads)
    head_f32_kernel(const float* __restrict__ feats,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ w3, const float* __restrict__ b3,
                    const float* __restrict__ w4, const float* __restrict__ b4,
                    const float* __restrict__ w5, const float* __restrict__ b5,
                    const float* __restrict__ wc, const float* __restrict__ bc,
                    const float* __restrict__ wr, const float* __restrict__ br,
                    float* __restrict__ cls, float* __restrict__ reg, int n,
                    int L4, int nc, int S) {
  extern __shared__ __align__(128) float fsm[];
  constexpr int T = kTileF32;
  float* buf0 = fsm;
  float* buf1 = fsm + (size_t)T * S;
  float* means = buf1 + (size_t)T * S;  // T x 128
  const int c0 = blockIdx.x * T;
  const int nv = min(T, n - c0);
  const int L8 = L4 / 2;

  zero_f32(buf0, T * S);
  zero_f32(buf1, T * S);
  __syncthreads();
  for (int idx = threadIdx.x; idx < nv * L4 * 64; idx += kF32Threads) {
    const int c = idx / (L4 * 64);
    const int rem = idx - c * L4 * 64;
    const int p = rem >> 6, v = rem & 63;
    *reinterpret_cast<float4*>(buf0 + (size_t)c * S +
                               (size_t)(p + 1) * ldf(256) + 4 * v) =
        *reinterpret_cast<const float4*>(
            feats + ((size_t)(c0 + c) * L4 + p) * 256 + 4 * v);
  }
  __syncthreads();
  conv_f32<256, 256, false, kRMHead, kRNHead>(buf0, buf1, S, L4, T, w1, b1);
  __syncthreads();
  zero_f32(buf0, T * S);
  __syncthreads();
  conv_f32<256, 256, false, kRMHead, kRNHead>(buf1, buf0, S, L4, T, w2, b2);
  __syncthreads();
  zero_f32(buf1, T * S);
  __syncthreads();
  conv_f32<256, 512, true, kRMHead, kRNHead>(buf0, buf1, S, L4, T, w3, b3);
  __syncthreads();
  zero_f32(buf0, T * S);
  __syncthreads();
  conv_f32<512, 256, false, kRMHead, kRNHead>(buf1, buf0, S, L8, T, w4, b4);
  __syncthreads();
  zero_f32(buf1, T * S);
  __syncthreads();
  conv_f32<256, 128, false, kRMHead, kRNHead>(buf0, buf1, S, L8, T, w5, b5);
  __syncthreads();
  // the mean over positions: a running sum times the f32 reciprocal of L8
  for (int idx = threadIdx.x; idx < nv * 128; idx += kF32Threads) {
    const int c = idx >> 7, ch = idx & 127;
    const float* col = buf1 + (size_t)c * S + ldf(128) + ch;
    float s = col[0];
    for (int p = 1; p < L8; ++p) s += col[(size_t)p * ldf(128)];
    means[idx] = s * (1.0f / (float)L8);
  }
  __syncthreads();
  cls_reg<float, false>(means, wc, bc, wr, br, cls, reg, c0, nv, nc);
}

// ------------------------------------------------------ shared memory
// Per-cutout stride S (elements) of a buffer that holds every activation of
// the stack: (length, channels) pairs; bytes for the whole block.
size_t backbone_smem(int l, int f32, int* S) {
  if (f32) {
    constexpr int m = kRMBackbone;
    *S = imax(imax((rup(l, m) + 2) * ldf(64), (rup(l / 2, m) + 2) * ldf(128)),
              (rup(l / 4, m) + 2) * ldf(256));
    return 2 * (size_t)kTileF32 * *S * sizeof(float);
  }
  *S = imax(imax((pad16(l) + 2) * ld_of(64), (pad16(l / 2) + 2) * ld_of(128)),
            (pad16(l / 4) + 2) * ld_of(256));
  return 2 * (size_t)kTileBackbone * *S * sizeof(bf16) +
         kWarps * 256 * sizeof(float);
}

size_t head_smem(int l4, int f32, int* S) {
  if (f32) {
    constexpr int m = kRMHead;
    *S = imax((rup(l4, m) + 2) * ldf(256), (rup(l4 / 2, m) + 2) * ldf(512));
    return (2 * (size_t)kTileF32 * *S + kTileF32 * 128) * sizeof(float);
  }
  *S = imax((pad16(l4) + 2) * ld_of(256), (pad16(l4 / 2) + 2) * ld_of(512));
  return 2 * (size_t)kTileHead * *S * sizeof(bf16) +
         (kWarps * 256 + kTileHead * 128) * sizeof(float);
}

}  // namespace

// dynamic shared memory a launch at these lengths asks for (bytes)
extern "C" long long fused_backbone_smem_bytes(int l, int f32) {
  int S;
  return (long long)backbone_smem(l, f32, &S);
}

extern "C" long long fused_head_smem_bytes(int l4, int f32) {
  int S;
  return (long long)head_smem(l4, f32, &S);
}

// w[0..5] / b[0..5]: the six convs' (3*Cin, Cout) weights (f32, or bf16 for
// f32 == 0) and f32 biases; cut (n, l) f32 -> feats (n, l/4, 256) f32
extern "C" int fused_backbone_launch(const void* cut, const void* const* w,
                                     const void* const* b, void* feats, int n,
                                     int l, int f32, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  int S;
  const size_t smem = backbone_smem(l, f32, &S);
  const float* const* bb = (const float* const*)b;
  if (f32) {
    const float* const* ww = (const float* const*)w;
    int err = set_smem((const void*)backbone_f32_kernel, smem);
    if (err) return err;
    backbone_f32_kernel<<<(n + kTileF32 - 1) / kTileF32, kF32Threads, smem,
                          (cudaStream_t)stream>>>(
        (const float*)cut, ww[0], bb[0], ww[1], bb[1], ww[2], bb[2], ww[3],
        bb[3], ww[4], bb[4], ww[5], bb[5], (float*)feats, n, l, S);
  } else {
    const bf16* const* ww = (const bf16* const*)w;
    int err = set_smem((const void*)backbone_bf16_kernel, smem);
    if (err) return err;
    backbone_bf16_kernel<<<(n + kTileBackbone - 1) / kTileBackbone, kThreads,
                           smem, (cudaStream_t)stream>>>(
        (const float*)cut, ww[0], bb[0], ww[1], bb[1], ww[2], bb[2], ww[3],
        bb[3], ww[4], bb[4], ww[5], bb[5], (float*)feats, n, l, S);
  }
  return (int)cudaGetLastError();
}

// w[0..4] / b[0..4]: the five head convs, w[5] / b[5] cls (128, nc), w[6] /
// b[6] reg (128, 2); feats (n, l4, 256) f32 -> cls (n, nc), reg (n, 2) f32
extern "C" int fused_head_launch(const void* feats, const void* const* w,
                                 const void* const* b, void* cls, void* reg,
                                 int n, int l4, int nc, int f32,
                                 void* stream) {
  if (n == 0) return (int)cudaSuccess;
  int S;
  const size_t smem = head_smem(l4, f32, &S);
  const float* const* bb = (const float* const*)b;
  if (f32) {
    const float* const* ww = (const float* const*)w;
    int err = set_smem((const void*)head_f32_kernel, smem);
    if (err) return err;
    head_f32_kernel<<<(n + kTileF32 - 1) / kTileF32, kF32Threads, smem,
                      (cudaStream_t)stream>>>(
        (const float*)feats, ww[0], bb[0], ww[1], bb[1], ww[2], bb[2], ww[3],
        bb[3], ww[4], bb[4], ww[5], bb[5], ww[6], bb[6], (float*)cls,
        (float*)reg, n, l4, nc, S);
  } else {
    const bf16* const* ww = (const bf16* const*)w;
    int err = set_smem((const void*)head_bf16_kernel, smem);
    if (err) return err;
    head_bf16_kernel<<<(n + kTileHead - 1) / kTileHead, kThreads, smem,
                       (cudaStream_t)stream>>>(
        (const float*)feats, ww[0], bb[0], ww[1], bb[1], ww[2], bb[2], ww[3],
        bb[3], ww[4], bb[4], ww[5], bb[5], ww[6], bb[6], (float*)cls,
        (float*)reg, n, l4, nc, S);
  }
  return (int)cudaGetLastError();
}
