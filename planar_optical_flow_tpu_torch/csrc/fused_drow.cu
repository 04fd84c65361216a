// K14's bf16 backbone: the fused DROW backbone of the round-1 serving step
// in bf16, for Hopper (sm_90a). (K14's bf16 head runs on K4's kernel,
// head_bf16.cu; K14's f32 mode is fused_f32.cu.)
//
// Replaces planar_optical_flow_tpu/ops/pallas/fused_drow.py fused_backbone
// (kernel _backbone_kernel) with compute_dtype bf16, which
// make_fused_stream_step runs: (N, L) f32 cutouts through all six k=3 SAME
// convs (1 -> 64 -> 64 -> 128, pool/2, 128 -> 128 -> 256, pool/2) to (N,
// L/4, 256) f32 feats. BatchNorm is folded into every conv, LeakyReLU 0.1
// after each.
//
// Rounding follows the JAX kernel's _conv3 in bf16: every conv input
// rounded to bf16 (the cutouts included), bf16 weights, f32 accumulation +
// bias + leaky, each activation stored in bf16 (max-pool commutes with the
// monotonic rounding); the feats leave as f32 holding those bf16 values.
//
// The kernel keeps a tile of cutouts in shared memory across every layer,
// so device memory sees the cutouts, the weights and the feats only: K2's
// tensor-core conv layer (conv_bf16.cuh), 8 cutouts a block, with layer 1
// (Cin = 1) computed per position from the cutouts. It handles a partial
// last tile (N need not be a multiple of the tile).
//
// Bound: operations. At L=56, ~15.2 MFLOP a cutout against 224 B in and 14
// KB out, at 989 TFLOP/s bf16.

#include "conv_bf16.cuh"

namespace {

// ---------------------------------------------------------------- bf16
constexpr int kTileBackbone = 8;  // cutouts per block
constexpr int kMTilesBackbone = 8;  // 16-position tiles per warp task

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
  conv_layer<64, 64, kStore, kMTilesBackbone>(buf0, buf1, S, L, T, w2, b2, stage);
  __syncthreads();
  zero_smem(buf0, T * S);
  __syncthreads();
  conv_layer<64, 128, kPool, kMTilesBackbone>(buf1, buf0, S, L, T, w3, b3, stage);
  __syncthreads();
  zero_smem(buf1, T * S);
  __syncthreads();
  conv_layer<128, 128, kStore, kMTilesBackbone>(buf0, buf1, S, L2, T, w4, b4, stage);
  __syncthreads();
  zero_smem(buf0, T * S);
  __syncthreads();
  conv_layer<128, 128, kStore, kMTilesBackbone>(buf1, buf0, S, L2, T, w5, b5, stage);
  __syncthreads();
  zero_smem(buf1, T * S);
  __syncthreads();
  conv_layer<128, 256, kPool, kMTilesBackbone>(buf0, buf1, S, L2, T, w6, b6, stage);
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

// ------------------------------------------------------ shared memory
// Per-cutout stride S (elements) of a buffer that holds every activation of
// the stack: (length, channels) pairs; bytes for the whole block.
size_t backbone_smem(int l, int* S) {
  *S = imax(imax((pad16(l) + 2) * ld_of(64), (pad16(l / 2) + 2) * ld_of(128)),
            (pad16(l / 4) + 2) * ld_of(256));
  return 2 * (size_t)kTileBackbone * *S * sizeof(bf16) +
         kWarps * 256 * sizeof(float);
}

}  // namespace

// dynamic shared memory a launch at these lengths asks for (bytes)
extern "C" long long fused_backbone_smem_bytes(int l) {
  int S;
  return (long long)backbone_smem(l, &S);
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
