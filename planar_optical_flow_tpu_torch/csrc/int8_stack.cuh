// The int8 conv stacks' shared arithmetic: the epilogue of an int8 conv,
// the weight structs of the backbone tail and the head, the head's mean and
// cls/reg, and the small helpers of the gate embed's bf16 products.
// wgmma_conv.cuh (the convs of K5/K8/K9/K10, K7, K12 and K13), embed.cuh
// and int8_wg.cuh build on it.
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

// how a backbone block gets its layer-1 activation
enum Layer1 { kFold = 0, kDivide = 1, kRead = 2 };

inline int imax(int a, int b) { return a > b ? a : b; }

// f32(acc) * s_eff + b_eff with two roundings, then leaky
__device__ __forceinline__ float scale_leaky(int acc, float s, float b) {
  return leaky(__fadd_rn(__fmul_rn(__int2float_rn(acc), s), b));
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

// the backbone's five int8 tail convs (layers 2-6), each w laid out by
// int8_tiles.plan_weights
struct TailWeights {
  const int8_t* w[5];
  const float* s[5];
  const float* b[5];
};

// the head's five int8 convs (the last one dequantized; each w laid out
// by int8_tiles.plan_weights) and the bf16 cls/reg linears with f32 biases
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

}  // namespace
