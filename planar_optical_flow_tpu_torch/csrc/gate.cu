// K3 (bf16 and f32 gate) and K6 (int8-carry gate): the serving
// spatial-attention gate for Hopper (sm_90a).
//
// K3 replaces planar_optical_flow_tpu/infer/fast_gate.py gate_fused_flat
// (kernel _gate_fused_kernel, which computes in the features' dtype); K6
// replaces gate_fused_int8_pm with
// per_stream=True (kernel _gate_int8_pm_stream_kernel, _quantize_attn,
// _mix_requant). Both share the front half, as the JAX kernels share
// _attention_body: band_attention and z_mix_and_sim in band_gate.cuh, which
// states the math and also holds K6's int8 mix (mix_requant16), shared with
// K12 and K13. K3 mixes the bf16 template with the bf16-rounded attention:
//   new_t[i] = alpha * x[i] + beta * sum_o bf16(attn[i, o]) * t[i + o]
// and in its f32 mode (f32 embeddings, features and template; the JAX
// mix_dtype f32) the f32 template with the f32 attention, every output f32.
//
// Grid (stream, D-chunk). Each block computes the stream's banded attention
// from the (ct, 128) embeddings into shared memory (one warp per row,
// channel dot products reduced with shuffles), then applies the band to its
// D-chunk as 2*hw+1 multiply-adds per element. The TPU kernels' dense
// (ct, ct) MXU matmul is not carried over. new_t and new_z go to fresh
// buffers: the TPU kernels alias the carry, but here a block writing row i
// while another reads row i +- hw of the old template would race in place.
//
// Bound: device-memory bytes. Per cutout K3 reads x and the template (2 x 7
// KB bf16 at D=3584, 2 x 14 KB in f32) and writes new_t (7 KB; 14 KB); K6
// moves a third of the bf16 bytes in int8 (3 x 3.5 KB); all add the small
// embeddings and sim. The template rows each block re-reads for the band
// come from L1/L2.

#include "band_gate.cuh"

namespace {

__device__ __forceinline__ float mix_operand(float attn, const bf16*) {
  return bf16_round(attn);
}

__device__ __forceinline__ float mix_operand(float attn, const float*) {
  return attn;
}

// T: bf16 or float, the dtype of every embedding, feature and template
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gate_kernel(const T* __restrict__ zx, const T* __restrict__ zt,
                const T* __restrict__ x, const T* __restrict__ t,
                T* __restrict__ new_t, T* __restrict__ new_z,
                float* __restrict__ sim, int ct, int ct_valid, int window,
                int d, int d_chunk, float alpha, float beta) {
  extern __shared__ float attn_s[];  // (ct, window) attention, mix operand
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hw = window / 2;
  const size_t row0 = (size_t)blockIdx.x * ct;

  // ---- banded attention (every chunk block), sim + new_z (chunk 0) ----
  for (int i = warp; i < ct; i += kWarps) {
    const size_t row = row0 + i;
    const BandLane r = band_attention(zx + row * 128, zt + row0 * 128, i,
                                      ct_valid, window, lane);
    const float a = mix_operand(r.attn, zx);
    if (lane < window) attn_s[i * window + lane] = a;
    if (blockIdx.y == 0)
      z_mix_and_sim(zx + row * 128, zt + row0 * 128, new_z + row * 128,
                    sim + row * window, i, window, r, a, alpha, beta, lane);
  }
  __syncthreads();

  // ---- banded template mix on this block's D-chunk, 8 columns a thread ----
  const int nvec = d_chunk / 8;
  const size_t col0 = (size_t)blockIdx.y * d_chunk;
  for (int idx = threadIdx.x; idx < ct * nvec; idx += kThreads) {
    const int i = idx / nvec;
    const size_t col = col0 + (size_t)(idx - i * nvec) * 8;
    float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < window; ++k) {
      const float ak = attn_s[i * window + k];
      if (ak != 0.0f) {
        float tv[8];
        load8(t + (row0 + i + k - hw) * d + col, tv);
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[q] += ak * tv[q];
      }
    }
    float xv[8];
    load8(x + (row0 + i) * d + col, xv);
#pragma unroll
    for (int q = 0; q < 8; ++q) xv[q] = alpha * xv[q] + beta * acc[q];
    store8(new_t + (row0 + i) * d + col, xv);
  }
}

__global__ void __launch_bounds__(kThreads)
    gate_int8_kernel(const bf16* __restrict__ zx, const bf16* __restrict__ zt,
                     const int8_t* __restrict__ x, const int8_t* __restrict__ t,
                     int8_t* __restrict__ new_t, bf16* __restrict__ new_z,
                     float* __restrict__ sim, int ct, int ct_valid, int window,
                     int d, int d_chunk, float alpha, float beta, float s_x,
                     float s_t127, float s_out) {
  extern __shared__ int attn_q[];  // (ct, window) clip(rint(127 * attn))
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = (size_t)blockIdx.x * ct;

  for (int i = warp; i < ct; i += kWarps) {
    const size_t row = row0 + i;
    const BandLane r = band_attention(zx + row * 128, zt + row0 * 128, i,
                                      ct_valid, window, lane);
    if (lane < window) attn_q[i * window + lane] = quantize_attn(r.attn);
    if (blockIdx.y == 0)
      z_mix_and_sim(zx + row * 128, zt + row0 * 128, new_z + row * 128,
                    sim + row * window, i, window, r, bf16_round(r.attn),
                    alpha, beta, lane);
  }
  __syncthreads();

  // ---- int8 template mix + requant on this block's D-chunk, 16 columns a
  // thread: the 2*hw+1 products summed exactly in int32 ----
  const int nvec = d_chunk / 16;
  const size_t col0 = (size_t)blockIdx.y * d_chunk;
  for (int idx = threadIdx.x; idx < ct * nvec; idx += kThreads) {
    const int i = idx / nvec;
    const size_t col = col0 + (size_t)(idx - i * nvec) * 16;
    const size_t row = row0 + i;
    *reinterpret_cast<uint4*>(new_t + row * d + col) = mix_requant16(
        attn_q + i * window, t + row0 * d, i, window, d, col,
        *reinterpret_cast<const uint4*>(x + row * d + col), alpha, beta, s_x,
        s_t127, s_out);
  }
}

}  // namespace

// dynamic shared memory a launch asks for (bytes; the same for K3 and K6)
extern "C" long long gate_smem_bytes(int ct, int window) {
  return (long long)ct * window * sizeof(float);
}

namespace {

template <typename T>
int launch_gate(const void* zx, const void* zt, const void* x, const void* t,
                void* new_t, void* new_z, void* sim, int n, int d, int ct,
                int ct_valid, int window, int d_chunk, float alpha,
                float beta, void* stream) {
  const size_t smem = (size_t)gate_smem_bytes(ct, window);
  int err = set_smem((const void*)gate_kernel<T>, smem);
  if (err) return err;
  const dim3 grid(n / ct, d / d_chunk);
  gate_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)zx, (const T*)zt, (const T*)x, (const T*)t, (T*)new_t,
      (T*)new_z, (float*)sim, ct, ct_valid, window, d, d_chunk, alpha, beta);
  return (int)cudaGetLastError();
}

}  // namespace

// f32: 0 for bf16 arrays (the v3 step), 1 for f32 ones (make_serve_step
// with compute_dtype=None)
extern "C" int gate_launch(const void* zx, const void* zt, const void* x,
                           const void* t, void* new_t, void* new_z, void* sim,
                           int n, int d, int ct, int ct_valid, int window,
                           int d_chunk, float alpha, float beta, int f32,
                           void* stream) {
  if (n == 0) return (int)cudaSuccess;
  return (f32 ? launch_gate<float> : launch_gate<bf16>)(
      zx, zt, x, t, new_t, new_z, sim, n, d, ct, ct_valid, window, d_chunk,
      alpha, beta, stream);
}

extern "C" int gate_int8_launch(const void* zx, const void* zt, const void* x,
                                const void* t, void* new_t, void* new_z,
                                void* sim, int n, int d, int ct, int ct_valid,
                                int window, int d_chunk, float alpha,
                                float beta, float s_x, float s_t127,
                                float s_out, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)gate_smem_bytes(ct, window);
  int err = set_smem((const void*)gate_int8_kernel, smem);
  if (err) return err;
  const dim3 grid(n / ct, d / d_chunk);
  gate_int8_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)zx, (const bf16*)zt, (const int8_t*)x, (const int8_t*)t,
      (int8_t*)new_t, (bf16*)new_z, (float*)sim, ct, ct_valid, window, d,
      d_chunk, alpha, beta, s_x, s_t127, s_out);
  return (int)cudaGetLastError();
}
