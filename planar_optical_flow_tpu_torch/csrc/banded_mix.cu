// K15: the standalone banded template mix for Hopper (sm_90a).
//
// Replaces planar_optical_flow_tpu/infer/fast_gate.py banded_mix_update
// (kernel _mix_kernel). On no serving path, as in the JAX package, whose
// gates fuse the mix (K3, K6); kept as the mix primitive. Per stream of ct
// rows, in f32:
//   out[i] = alpha * x[i] + beta * acc[i],
//   acc[i] = attn[i, hw] * t[i] + sum_{o != 0} attn[i, o + hw] * t[(i + o) mod ct]
// summed in that order, o from -hw to hw: the TPU kernel's circular roll,
// which equals the zero-padded band wherever attn is 0 at the offsets that
// leave the stream. x, t and out are bf16 or f32 (out takes x's dtype);
// attn is f32.
//
// Grid (stream, D-chunk), as K3: each block stages its stream's (ct, window)
// attention in shared memory, then each thread blends 8 columns of a row.
//
// Bound: device-memory bytes: x and t read, out written, once each (3 x 7 KB
// a row in bf16 at D=3584). The template rows a block re-reads for the band
// come from L1/L2.

#include "band_gate.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    banded_mix_kernel(const float* __restrict__ attn, const T* __restrict__ x,
                      const T* __restrict__ t, T* __restrict__ out, int ct,
                      int window, int d, int d_chunk, float alpha,
                      float beta) {
  extern __shared__ float attn_s[];  // (ct, window)
  const int hw = window / 2;
  const size_t row0 = (size_t)blockIdx.x * ct;
  for (int idx = threadIdx.x; idx < ct * window; idx += kThreads)
    attn_s[idx] = attn[row0 * window + idx];
  __syncthreads();

  const int nvec = d_chunk / 8;
  const size_t col0 = (size_t)blockIdx.y * d_chunk;
  for (int idx = threadIdx.x; idx < ct * nvec; idx += kThreads) {
    const int i = idx / nvec;
    const size_t col = col0 + (size_t)(idx - i * nvec) * 8;
    const float* a = attn_s + i * window;
    float acc[8], tv[8];
    load8(t + (row0 + i) * d + col, tv);
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = __fmul_rn(a[hw], tv[q]);
    for (int k = 0; k < window; ++k) {
      if (k == hw) continue;
      int j = (i + k - hw) % ct;
      if (j < 0) j += ct;
      load8(t + (row0 + j) * d + col, tv);
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[q] += a[k] * tv[q];
    }
    float xv[8];
    load8(x + (row0 + i) * d + col, xv);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      xv[q] = __fadd_rn(__fmul_rn(alpha, xv[q]), __fmul_rn(beta, acc[q]));
    store8(out + (row0 + i) * d + col, xv);
  }
}

template <typename T>
int launch_banded_mix(const void* attn, const void* x, const void* t,
                      void* out, int n, int d, int ct, int window,
                      int d_chunk, float alpha, float beta, void* stream) {
  const size_t smem = (size_t)ct * window * sizeof(float);
  int err = set_smem((const void*)banded_mix_kernel<T>, smem);
  if (err) return err;
  const dim3 grid(n / ct, d / d_chunk);
  banded_mix_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)attn, (const T*)x, (const T*)t, (T*)out, ct, window, d,
      d_chunk, alpha, beta);
  return (int)cudaGetLastError();
}

}  // namespace

// n = streams * ct rows of d; f32: 1 for f32 x/t/out, 0 for bf16
extern "C" int banded_mix_launch(const void* attn, const void* x,
                                 const void* t, void* out, int n, int d,
                                 int ct, int window, int d_chunk, float alpha,
                                 float beta, int f32, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  return (f32 ? launch_banded_mix<float> : launch_banded_mix<bf16>)(
      attn, x, t, out, n, d, ct, window, d_chunk, alpha, beta, stream);
}
