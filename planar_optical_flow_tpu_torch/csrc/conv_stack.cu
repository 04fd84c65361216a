// K2 (backbone tail + gate embed) for Hopper (sm_90a).
//
// K2 replaces planar_optical_flow_tpu/ops/pallas/conv_stack.py
// fused_backbone_v2 (with embed_weights). K4, its head, is head_bf16.cu.
//
// A block takes a tile of cutouts and keeps the tile's activations in
// shared memory across every layer: HBM sees the input activation and the
// outputs only. The conv layer (conv_bf16.cuh, shared with K14's bf16 mode)
// holds, per cutout, rows of C bf16 channels padded to C+16, with position
// p in row p+1 and zero rows around. A k=3 SAME conv is then three shifted
// row windows of the same buffer times the tap-major (3*Cin, Cout) weight:
// out[p] = sum_t in_row[p + t] @ W[t*Cin:(t+1)*Cin]. A warp task is eight
// 16-position tiles x 32 output channels with nvcuda::wmma bf16 16x16x16
// fragments and f32 accumulators: each B fragment, read from the weights in
// global memory (L2 resident), feeds eight tile products. Positions are
// padded to a multiple of 16 per cutout; the padded outputs are written as
// zero so they serve as the next layer's padding.
//
// Rounding follows the JAX kernel: bf16 MMA operands, f32 accumulation,
// bias + LeakyReLU(0.1) in f32, the activation stored as its bf16 MMA
// operand (bf16 rounding is monotonic, so max-pool commutes with it), feats
// stored bf16, zx = bf16(feats @ We + be).
//
// Bound: tensor-core operations (about 16 MFLOP per cutout at L=56,
// against 8 KB of HBM traffic).

#include "conv_bf16.cuh"

namespace {

constexpr int kTileBackbone = 8;  // cutouts per block (= embed MMA rows)
// 16-position tiles per warp task (each B fragment feeds that many tile
// products); must divide the block's tile count, cutouts x tiles per cutout
constexpr int kMTilesBackbone = 8;
static_assert(kTileBackbone % kMTilesBackbone == 0,
              "a warp task's tiles must not run past the block's cutouts");

__global__ void __launch_bounds__(kThreads)
    backbone_tail_kernel(const bf16* __restrict__ act1,
                         const bf16* __restrict__ w2, const float* __restrict__ b2,
                         const bf16* __restrict__ w3, const float* __restrict__ b3,
                         const bf16* __restrict__ w4, const float* __restrict__ b4,
                         const bf16* __restrict__ w5, const float* __restrict__ b5,
                         const bf16* __restrict__ w6, const float* __restrict__ b6,
                         const bf16* __restrict__ we, const bf16* __restrict__ be,
                         bf16* __restrict__ feats, bf16* __restrict__ zx,
                         int n, int L, int S) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int T = kTileBackbone;
  bf16* buf0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* buf1 = buf0 + (size_t)T * S;
  float* stage_all = reinterpret_cast<float*>(buf1 + (size_t)T * S);
  const int warp = threadIdx.x >> 5;
  float* stage = stage_all + warp * 256;
  const int c0 = blockIdx.x * T;
  const int nv = min(T, n - c0);
  const int L2 = L / 2, L4 = L / 4;

  zero_smem(buf0, T * S);
  zero_smem(buf1, T * S);
  __syncthreads();
  load_rows<64>(buf0, act1, c0, nv, L, S);
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

  // feats: rows 1..L4 of buf1 -> (N*L4, 256)
  for (int idx = threadIdx.x; idx < nv * L4 * 32; idx += kThreads) {
    const int c = idx / (L4 * 32);
    const int rem = idx - c * L4 * 32;
    const int p = rem >> 5, v = rem & 31;
    reinterpret_cast<uint4*>(feats + ((size_t)(c0 + c) * L4 + p) * 256)[v] =
        reinterpret_cast<const uint4*>(buf1 + (size_t)c * S +
                                       (size_t)(p + 1) * ld_of(256))[v];
  }

  // gate embed zx = feats_flat @ We + be: one m8n32k16 product with the
  // tile's 8 cutouts as rows (row stride S); contraction index
  // k = p * 256 + ch walks position p's row of buf1. Warp w takes output
  // columns 32*(w%4).. and one half of the contraction.
  {
    const int ksteps = L4 * 16;  // K = L4 * 256
    const int nt = warp & 3, kh = warp >> 2;
    const int kbeg = kh * (ksteps / 2), kend = kh ? ksteps : ksteps / 2;
    wmma::fragment<wmma::accumulator, 8, 32, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int ks = kbeg; ks < kend; ++ks) {
      wmma::fragment<wmma::matrix_a, 8, 32, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(
          a, buf1 + (size_t)((ks >> 4) + 1) * ld_of(256) + (ks & 15) * 16, S);
      wmma::fragment<wmma::matrix_b, 8, 32, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, we + (size_t)ks * 16 * 128 + nt * 32, 128);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(stage, acc, 32, wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nv * 128; idx += kThreads) {
    const int c = idx >> 7, col = idx & 127;
    const int nt = col >> 5, cc = col & 31;
    const float v = stage_all[nt * 256 + c * 32 + cc] +
                    stage_all[(nt + 4) * 256 + c * 32 + cc] +
                    __bfloat162float(be[col]);
    zx[(size_t)(c0 + c) * 128 + col] = __float2bfloat16(v);
  }
}

size_t backbone_tail_smem(int l, int* S) {
  *S = imax(imax((pad16(l) + 2) * ld_of(64), (pad16(l / 2) + 2) * ld_of(128)),
            (pad16(l / 4) + 2) * ld_of(256));
  return 2 * (size_t)kTileBackbone * *S * sizeof(bf16) +
         kWarps * 256 * sizeof(float);
}

}  // namespace

// dynamic shared memory a launch at these lengths asks for (bytes)
extern "C" long long backbone_tail_smem_bytes(int l) {
  int S;
  return (long long)backbone_tail_smem(l, &S);
}

extern "C" int backbone_tail_launch(
    const void* act1, const void* w2, const void* b2, const void* w3,
    const void* b3, const void* w4, const void* b4, const void* w5,
    const void* b5, const void* w6, const void* b6, const void* we,
    const void* be, void* feats, void* zx, int n, int l, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  int S;
  const size_t smem = backbone_tail_smem(l, &S);
  int err = set_smem((const void*)backbone_tail_kernel, smem);
  if (err) return err;
  const int grid = (n + kTileBackbone - 1) / kTileBackbone;
  backbone_tail_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)act1, (const bf16*)w2, (const float*)b2, (const bf16*)w3,
      (const float*)b3, (const bf16*)w4, (const float*)b4, (const bf16*)w5,
      (const float*)b5, (const bf16*)w6, (const float*)b6, (const bf16*)we,
      (const bf16*)be, (bf16*)feats, (bf16*)zx, n, l, S);
  return (int)cudaGetLastError();
}
