// The bf16 tensor-core conv layer of K2 (conv_stack.cu), shared with K14's
// bf16 backbone (fused_drow.cu): a tile of cutouts in shared memory, one
// k=3 SAME conv per call as three shifted row windows times the tap-major
// (3*Cin, Cout) weight, on nvcuda::wmma bf16 16x16x16 fragments with f32
// accumulators. Layout in shared memory, per cutout: rows of C bf16 channels
// (padded to C+16 so that the 16-byte row segments an ldmatrix reads fall in
// different banks while every row stays 32-byte aligned for wmma), row 0 and
// the rows past the last position are zero, position p sits in row p+1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPadCols = 16;  // shared-memory row padding (elements)
constexpr int kNTiles = 2;    // 16-channel tiles per warp task

enum Epilogue { kStore = 0, kPool = 1 };

__host__ __device__ inline int pad16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ constexpr int ld_of(int c) { return c + kPadCols; }
inline int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float leaky(float v) {
  return v > 0.0f ? v : 0.1f * v;
}

__device__ void zero_smem(bf16* p, int n_elems) {
  uint4 z = make_uint4(0, 0, 0, 0);
  uint4* q = reinterpret_cast<uint4*>(p);
  for (int i = threadIdx.x; i < n_elems / 8; i += blockDim.x) q[i] = z;
}

// One k=3 SAME conv layer over the tile: `in` (CIN channels, L positions)
// -> `out` (COUT channels; pooled to L/2 for kPool).
// `stage`: this warp's 16x16 f32 scratch.
template <int CIN, int COUT, int EPI, int MTILES>
__device__ void conv_layer(const bf16* in, bf16* out, int S,
                           int L, int T, const bf16* __restrict__ W,
                           const float* __restrict__ bias, float* stage) {
  constexpr int LDI = ld_of(CIN), LDO = ld_of(COUT);
  constexpr int NG = COUT / (16 * kNTiles);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = pad16(L) / 16;  // tiles per cutout
  const int tasks = (T * mt / MTILES) * NG;
  for (int task = warp; task < tasks; task += kWarps) {
    const int g = task % NG;
    const int u0 = (task / NG) * MTILES;  // first tile of this task
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MTILES][kNTiles];
    const bf16* a_base[MTILES];
#pragma unroll
    for (int i = 0; i < MTILES; ++i) {
      const int c = (u0 + i) / mt, m = (u0 + i) % mt;
      a_base[i] = in + (size_t)c * S + (size_t)16 * m * LDI;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    }
    const bf16* w_base = W + g * 16 * kNTiles;
    for (int t = 0; t < 3; ++t) {
      for (int kk = 0; kk < CIN / 16; ++kk) {
        const bf16* wrow = w_base + (size_t)(t * CIN + kk * 16) * COUT;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            b[kNTiles];
#pragma unroll
        for (int j = 0; j < kNTiles; ++j)
          wmma::load_matrix_sync(b[j], wrow + j * 16, COUT);
#pragma unroll
        for (int i = 0; i < MTILES; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, a_base[i] + t * LDI + kk * 16, LDI);
#pragma unroll
          for (int j = 0; j < kNTiles; ++j)
            wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MTILES; ++i) {
      const int c = (u0 + i) / mt, m = (u0 + i) % mt;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int n0 = (g * kNTiles + j) * 16;
        if (EPI == kStore) {
          for (int e = 0; e < 8; ++e) {
            const int idx = lane + 32 * e;
            const int r = idx >> 4, col = idx & 15;
            const int pos = 16 * m + r;
            float v = leaky(stage[idx] + bias[n0 + col]);
            if (pos >= L) v = 0.0f;
            out[(size_t)c * S + (size_t)(pos + 1) * LDO + n0 + col] =
                __float2bfloat16(v);
          }
        } else {
          for (int e = 0; e < 4; ++e) {
            const int idx = lane + 32 * e;
            const int r = idx >> 4, col = idx & 15;
            const float bb = bias[n0 + col];
            float v = fmaxf(leaky(stage[(2 * r) * 16 + col] + bb),
                            leaky(stage[(2 * r + 1) * 16 + col] + bb));
            if (16 * m + 2 * r >= L) v = 0.0f;
            out[(size_t)c * S + (size_t)(8 * m + r + 1) * LDO + n0 + col] =
                __float2bfloat16(v);
          }
        }
        __syncwarp();
      }
    }
  }
}

// Copy `rows` positions of `nv` cutouts (C bf16 each) from global rows
// src[(c0 + c) * rows + p] into the tile buffer rows p + 1.
template <int C>
__device__ void load_rows(bf16* buf, const bf16* __restrict__ src, int c0,
                          int nv, int rows, int S) {
  constexpr int V = C / 8;  // uint4 per position
  for (int idx = threadIdx.x; idx < nv * rows * V; idx += blockDim.x) {
    const int c = idx / (rows * V);
    const int rem = idx - c * rows * V;
    const int p = rem / V, v = rem - (rem / V) * V;
    reinterpret_cast<uint4*>(buf + (size_t)c * S + (size_t)(p + 1) * ld_of(C))[v] =
        reinterpret_cast<const uint4*>(
            src + ((size_t)(c0 + c) * rows + p) * C)[v];
  }
}

int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
