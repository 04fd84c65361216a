// The gate embed of the backbones that write their feats to device memory,
// shared by K5/K9/K10 (conv_stack_int8.cu) and K2 (backbone_bf16.cu), and
// the A fragment of its products, which K13 (serve_cell_wg.cu, through
// int8_wg.cuh) builds its embed from: zx = bf16(feats_flat @ We + be) on
// int8 or bf16 feats, bf16 weights and f32 sums.

#pragma once

#include "int8_stack.cuh"

namespace {

// The A fragment of one k16 step of the gate embed (mma.m16n8k16 bf16 x
// bf16 -> f32): rows g and g + 8 of an m16 tile at ra and rb, columns k and
// k + 1, k + 8 and k + 9 (k = the step's first k + 2 * tq); int8 feats as
// exact bf16 pairs, bf16 feats as they are. embed_kernel (K5/K9/K10) and
// K13 build every zx from these fragments with the same instruction over k
// = 0, 16, ... from 0.0, then one f32 add of the bias and one rounding to
// bf16, so the two give the same bits.
__device__ __forceinline__ uint32_t embed_pair(const int8_t* row, int k) {
  return bf16x2_of(row[k], row[k + 1]);
}
__device__ __forceinline__ uint32_t embed_pair(const bf16* row, int k) {
  return *reinterpret_cast<const uint32_t*>(row + k);
}
template <typename TA>
__device__ __forceinline__ void embed_frag_a(uint32_t (&a)[4], const TA* ra,
                                             const TA* rb, int k) {
  a[0] = embed_pair(ra, k);
  a[1] = embed_pair(rb, k);
  a[2] = embed_pair(ra, k + 8);
  a[3] = embed_pair(rb, k + 8);
}

constexpr int kEmbRows = 128;   // cutouts a block
constexpr int kEmbK = 64;       // contraction a stage
constexpr int kEmbStages = 3;

template <typename TA>
__host__ __device__ constexpr int emb_lda() {
  return kEmbK * (int)sizeof(TA) + 16;
}
constexpr int kEmbLdb = kEmbK * 2 + 16;

template <typename TA>
constexpr size_t embed_smem() {
  return (size_t)kEmbStages * kEmbRows * (emb_lda<TA>() + kEmbLdb);
}

// zx = bf16(feats_flat @ We + be) over n cutouts: feats (n, K) int8 or bf16
// (K = L/4 * 256; int8 values are exact in bf16), we_t (128, K) bf16. Warp w
// owns rows 32 (w % 4) .. + 31 and columns 64 (w / 4) .. + 63; each output
// is one chain of mma.sync.m16n8k16 over k = 0, 16, ..., K - 16 from 0.0,
// as K13's embed (serve_cell_wg.cu cell_embed) computes it, then one f32
// add of the bias and one rounding to bf16.
template <typename TA>
__global__ void __launch_bounds__(256)
    embed_kernel(const TA* __restrict__ feats, const bf16* __restrict__ we_t,
                 const bf16* __restrict__ be, bf16* __restrict__ zx, int n,
                 int K) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int LDA = emb_lda<TA>();
  unsigned char* sa = smem_raw;
  unsigned char* sb = smem_raw + (size_t)kEmbStages * kEmbRows * LDA;
  const int r0 = blockIdx.x * kEmbRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int kt_n = K / kEmbK;

  auto load = [&](int kt) {
    const int st = kt % kEmbStages, k0 = kt * kEmbK;
    constexpr int VA = kEmbK * (int)sizeof(TA) / 16;  // vectors a row
    for (int idx = threadIdx.x; idx < kEmbRows * VA; idx += 256) {
      const int r = idx / VA, v = idx - r * VA;
      const int row = min(r0 + r, n - 1);  // rows past n: not stored
      cp_async16(sa + ((size_t)st * kEmbRows + r) * LDA + 16 * v,
                 reinterpret_cast<const unsigned char*>(
                     feats + (size_t)row * K + k0) + 16 * v);
    }
    for (int idx = threadIdx.x; idx < 128 * 8; idx += 256) {
      const int col = idx >> 3, v = idx & 7;
      cp_async16(sb + ((size_t)st * 128 + col) * kEmbLdb + 16 * v,
                 we_t + (size_t)col * K + k0 + 8 * v);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int s = 0; s < kEmbStages - 1; ++s) {
    if (s < kt_n) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kEmbStages - 2>();
    __syncthreads();
    const int st = kt % kEmbStages;
    const unsigned char* a_st = sa + (size_t)st * kEmbRows * LDA;
    const unsigned char* b_st = sb + (size_t)st * 128 * kEmbLdb;
#pragma unroll
    for (int kk = 0; kk < kEmbK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned char* ra = a_st + (size_t)(32 * wm + 16 * i + g) * LDA;
        embed_frag_a(a[i], reinterpret_cast<const TA*>(ra),
                     reinterpret_cast<const TA*>(ra + 8 * LDA), kk + 2 * tq);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned char* cb =
            b_st + (size_t)(64 * wn + 8 * j + g) * kEmbLdb + 2 * (kk + 2 * tq);
        const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(cb),
                               *reinterpret_cast<const uint32_t*>(cb + 16)};
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], a[i], b);
      }
    }
    if (kt + kEmbStages - 1 < kt_n) load(kt + kEmbStages - 1);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 32 * wm + 16 * i + g + 8 * h;
      if (row >= n) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * wn + 8 * j + 2 * tq;
        bf16* z = zx + (size_t)row * 128 + col;
        z[0] = __float2bfloat16(
            __fadd_rn(acc[i][j][2 * h], __bfloat162float(be[col])));
        z[1] = __float2bfloat16(
            __fadd_rn(acc[i][j][2 * h + 1], __bfloat162float(be[col + 1])));
      }
    }
}

template <typename TA>
int launch_embed(const void* feats, const void* we_t, const void* be,
                 void* zx, int n, int K, cudaStream_t stream) {
  const size_t smem = embed_smem<TA>();
  int err = set_smem((const void*)embed_kernel<TA>, smem);
  if (err) return err;
  embed_kernel<TA><<<(n + kEmbRows - 1) / kEmbRows, 256, smem, stream>>>(
      (const TA*)feats, (const bf16*)we_t, (const bf16*)be, (bf16*)zx, n, K);
  return (int)cudaGetLastError();
}

}  // namespace
