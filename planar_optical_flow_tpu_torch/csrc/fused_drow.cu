// K14: the fused DROW backbone and head of the round-1 serving step in
// bf16, for Hopper (sm_90a). (K14's f32 mode is fused_f32.cu.)
//
// Replaces planar_optical_flow_tpu/ops/pallas/fused_drow.py fused_backbone
// (kernel _backbone_kernel) and fused_head (_head_kernel) with compute_dtype
// bf16, which make_fused_stream_step runs. The backbone takes (N, L) f32
// cutouts through all six k=3 SAME convs (1 -> 64 -> 64 -> 128, pool/2, 128
// -> 128 -> 256, pool/2) to (N, L/4, 256) f32 feats; the head takes feats
// through 256 -> 256 -> 512, pool/2, 512 -> 256 -> 128, the mean over
// positions and the cls/reg linears. BatchNorm is folded into every conv,
// LeakyReLU 0.1 after each.
//
// Rounding follows the JAX kernels' _conv3 in bf16: every conv input
// rounded to bf16 (the cutouts and the head's f32 feats included), bf16
// weights, f32 accumulation + bias + leaky, each activation stored in bf16
// (max-pool commutes with the monotonic rounding); the feats leave as f32
// holding those bf16 values; the head averages the bf16 activations of its
// last conv in f32, rounds the mean to bf16 and multiplies it by the bf16
// linears with f32 accumulation. The mean over positions is a running sum
// times the f32 reciprocal of the count, the form XLA gives jnp.mean's
// division by a constant.
//
// The kernels keep a tile of cutouts in shared memory across every layer,
// so device memory sees the cutouts, the weights and the outputs only: K2's
// and K4's tensor-core conv layer (conv_bf16.cuh), 8 cutouts a backbone
// block and 4 a head block, with layer 1 (Cin = 1) computed per position
// from the cutouts. Both handle a partial last tile (N need not be a
// multiple of the tile).
//
// Bound: operations. At L=56, ~15.2 MFLOP a cutout for the backbone and
// ~28.9 MFLOP for the head, against 224 B in and 14 KB out (the backbone)
// and 14 KB in (the head), at 989 TFLOP/s bf16.

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
// xr * w2) + b over the taps of position p, zero beyond the cutout, with
// the cutout values rounded to bf16 (the weights arrive rounded), so every
// product is exact in f32.
__device__ void layer1(const float* __restrict__ cut, bf16* out, int c0,
                       int nv, int L, int S, int ldo,
                       const bf16* __restrict__ w, const float* __restrict__ b) {
  for (int idx = threadIdx.x; idx < nv * L * 64; idx += blockDim.x) {
    const int c = idx / (L * 64);
    const int rem = idx - c * L * 64;
    const int p = rem >> 6, co = rem & 63;
    const float* x = cut + (size_t)(c0 + c) * L;
    const float xl = bf16r(p > 0 ? x[p - 1] : 0.0f), xm = bf16r(x[p]);
    const float xr = bf16r(p + 1 < L ? x[p + 1] : 0.0f);
    float acc = xl * (float)w[co];
    acc = fmaf(xm, (float)w[64 + co], acc);
    acc = fmaf(xr, (float)w[128 + co], acc);
    const float v = leaky(acc + b[co]);
    out[(size_t)c * S + (size_t)(p + 1) * ldo + co] = (bf16)v;
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
  layer1(cut, buf0, c0, nv, L, S, ld_of(64), w1, b1);
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

// the cls/reg linears of the block's cutouts: acc over the 128 means
// (rounded to bf16 first) times the weights, + f32 bias
__device__ void cls_reg(const float* means, const bf16* __restrict__ wc,
                        const float* __restrict__ bc,
                        const bf16* __restrict__ wr,
                        const float* __restrict__ br, float* __restrict__ cls,
                        float* __restrict__ reg, int c0, int nv, int nc) {
  for (int idx = threadIdx.x; idx < nv * (nc + 2); idx += blockDim.x) {
    const int c = idx / (nc + 2), j = idx - c * (nc + 2);
    const bool is_cls = j < nc;
    const bf16* w = is_cls ? wc + j : wr + (j - nc);
    const int ldw = is_cls ? nc : 2;
    float acc = 0.0f;
    for (int k = 0; k < 128; ++k) {
      const float m = means[c * 128 + k];
      acc += bf16r(m) * (float)w[k * ldw];
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
  cls_reg(means, wc, bc, wr, br, cls, reg, c0, nv, nc);
}

// ------------------------------------------------------ shared memory
// Per-cutout stride S (elements) of a buffer that holds every activation of
// the stack: (length, channels) pairs; bytes for the whole block.
size_t backbone_smem(int l, int* S) {
  *S = imax(imax((pad16(l) + 2) * ld_of(64), (pad16(l / 2) + 2) * ld_of(128)),
            (pad16(l / 4) + 2) * ld_of(256));
  return 2 * (size_t)kTileBackbone * *S * sizeof(bf16) +
         kWarps * 256 * sizeof(float);
}

size_t head_smem(int l4, int* S) {
  *S = imax((pad16(l4) + 2) * ld_of(256), (pad16(l4 / 2) + 2) * ld_of(512));
  return 2 * (size_t)kTileHead * *S * sizeof(bf16) +
         (kWarps * 256 + kTileHead * 128) * sizeof(float);
}

}  // namespace

// dynamic shared memory a launch at these lengths asks for (bytes)
extern "C" long long fused_backbone_smem_bytes(int l) {
  int S;
  return (long long)backbone_smem(l, &S);
}

extern "C" long long fused_head_smem_bytes(int l4) {
  int S;
  return (long long)head_smem(l4, &S);
}

// w[0..5] / b[0..5]: the six convs' (3*Cin, Cout) bf16 weights and f32
// biases; cut (n, l) f32 -> feats (n, l/4, 256) f32
extern "C" int fused_backbone_launch(const void* cut, const void* const* w,
                                     const void* const* b, void* feats, int n,
                                     int l, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  int S;
  const size_t smem = backbone_smem(l, &S);
  const float* const* bb = (const float* const*)b;
  const bf16* const* ww = (const bf16* const*)w;
  int err = set_smem((const void*)backbone_bf16_kernel, smem);
  if (err) return err;
  backbone_bf16_kernel<<<(n + kTileBackbone - 1) / kTileBackbone, kThreads,
                         smem, (cudaStream_t)stream>>>(
      (const float*)cut, ww[0], bb[0], ww[1], bb[1], ww[2], bb[2], ww[3],
      bb[3], ww[4], bb[4], ww[5], bb[5], (float*)feats, n, l, S);
  return (int)cudaGetLastError();
}

// w[0..4] / b[0..4]: the five head convs, w[5] / b[5] cls (128, nc), w[6] /
// b[6] reg (128, 2), bf16 weights, f32 biases; feats (n, l4, 256) f32 ->
// cls (n, nc), reg (n, 2) f32
extern "C" int fused_head_launch(const void* feats, const void* const* w,
                                 const void* const* b, void* cls, void* reg,
                                 int n, int l4, int nc, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  int S;
  const size_t smem = head_smem(l4, &S);
  const float* const* bb = (const float* const*)b;
  const bf16* const* ww = (const bf16* const*)w;
  int err = set_smem((const void*)head_bf16_kernel, smem);
  if (err) return err;
  head_bf16_kernel<<<(n + kTileHead - 1) / kTileHead, kThreads, smem,
                     (cudaStream_t)stream>>>(
      (const float*)feats, ww[0], bb[0], ww[1], bb[1], ww[2], bb[2], ww[3],
      bb[3], ww[4], bb[4], ww[5], bb[5], ww[6], bb[6], (float*)cls,
      (float*)reg, n, l4, nc, S);
  return (int)cudaGetLastError();
}
