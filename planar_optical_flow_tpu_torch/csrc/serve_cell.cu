// K12 (int8 gate + head) for Hopper (sm_90a). (K13, the whole cell, is
// serve_cell_wg.cu.)
//
// K12 replaces planar_optical_flow_tpu/infer/fast_gate.py
// gate_head_fused_int8_pm (kernel _gate_head_int8_pm_stream_kernel): K6 and
// then K7 on the fresh template, byte-identical to the pair. The math is
// the shared device code of those kernels: int8_stack.cuh (the head) and
// band_gate.cuh (attention, z mix and sim, the int8 template mix).
//
// Design. The TPU program holds a whole stream in VMEM (up to 100 MB);
// here a block owns kTile = 8 cutouts, as K8 does. The attention row of
// cutout i needs only its own current zx[i] and the CARRIED zt[i + o] and
// t[i + o], |o| <= window / 2, of its stream: each block reads those from
// device memory (L2 holds the neighbours' rows, which eight blocks share)
// and writes the new template, z and sim to fresh buffers, so no block ever
// reads a row that another writes (the TPU kernel aliases the carry). One
// warp computes each row's attention. The block's new template goes to
// device memory and, in the head's tile layout, straight into shared
// memory, where the head runs on it: K12 saves K7's read of the template
// and one launch.
//
// Shared memory (bytes, at L = 56): two regions of kTile * S (S = 9504, the
// head's tile stride), the head's means (4 KB) and the quantized attention
// (1 KB): 157 KB, one block per SM.
//
// Bound: tensor-core operations. K12 does K7's 28.9 M int8 operations per
// cutout against ~10.6 KB of device memory (x, t in, new_t out, at 3.5 KB
// each).

#include "band_gate.cuh"
#include "int8_stack.cuh"

namespace {

// The gate rows c0 .. c0 + nv - 1 (row = stream * ct + i): attention, sim
// and new z, one warp a row, the quantized attention into attn_q (row c at
// attn_q + c * kMaxWindow). zx_rows: row c's current embedding at
// zx_rows + c * 128.
__device__ __forceinline__ void gate_rows(
    const bf16* zx_rows, const bf16* __restrict__ zt, bf16* __restrict__ new_z,
    float* __restrict__ sim, int* attn_q, int c0, int nv, int ct,
    int ct_valid, int window, float alpha, float beta) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < nv; c += kWarps) {
    const int row = c0 + c;
    const int i = row % ct;
    const size_t row0 = (size_t)(row - i);
    const BandLane r = band_attention(zx_rows + (size_t)c * 128,
                                      zt + row0 * 128, i, ct_valid, window,
                                      lane);
    if (lane < window) attn_q[c * kMaxWindow + lane] = quantize_attn(r.attn);
    z_mix_and_sim(zx_rows + (size_t)c * 128, zt + row0 * 128,
                  new_z + (size_t)row * 128, sim + (size_t)row * window, i,
                  window, r, bf16_round(r.attn), alpha, beta, lane);
  }
}

// The template mix of rows c0 .. c0 + nv - 1 (rows of d = L4 * 256 int8,
// column p * 256 + ch for position p, channel ch) into new_t and into the
// zeroed head tile (position p of cutout c at row p + 1, stride S). x: row
// c's features at x_rows + c * x_stride, position p at + p * x_ld.
__device__ __forceinline__ void mix_rows(
    const int* attn_q, const int8_t* __restrict__ t, const int8_t* x_rows,
    size_t x_stride, int x_ld, int8_t* __restrict__ new_t, int8_t* tile,
    int c0, int nv, int ct, int window, int L4, int S, float alpha,
    float beta, float s_x, float s_t127, float s_out) {
  const size_t d = (size_t)L4 * 256;
  const int nvec = L4 * 16;  // 16-byte vectors a row
  for (int idx = threadIdx.x; idx < nv * nvec; idx += kThreads) {
    const int c = idx / nvec, v = idx - c * nvec;
    const int p = v >> 4, ch = (v & 15) * 16;
    const int row = c0 + c;
    const int i = row % ct;
    const size_t col = (size_t)v * 16;
    const uint4 o = mix_requant16(
        attn_q + c * kMaxWindow, t + (size_t)(row - i) * d, i, window, d, col,
        *reinterpret_cast<const uint4*>(x_rows + c * x_stride +
                                        (size_t)p * x_ld + ch),
        alpha, beta, s_x, s_t127, s_out);
    *reinterpret_cast<uint4*>(new_t + (size_t)row * d + col) = o;
    *reinterpret_cast<uint4*>(tile + (size_t)c * S +
                              (size_t)(p + 1) * ld_of(256) + ch) = o;
  }
}

// the scalars of the int8 gate
struct GateArgs {
  int ct, ct_valid, window;
  float alpha, beta, s_x, s_t127, s_out;
};

// K12. Shared memory: head tiles buf0, buf1 (kTile * S each), the means,
// the quantized attention.
__global__ void __launch_bounds__(kThreads)
    gate_head_int8_kernel(const bf16* __restrict__ zx,
                          const bf16* __restrict__ zt,
                          const int8_t* __restrict__ x,
                          const int8_t* __restrict__ t,
                          int8_t* __restrict__ new_t, bf16* __restrict__ new_z,
                          float* __restrict__ sim, const HeadWeights hw,
                          float* __restrict__ cls, float* __restrict__ reg,
                          const GateArgs ga, int n, int L4, int nc, int S) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* buf0 = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* buf1 = buf0 + (size_t)kTile * S;
  float* means = reinterpret_cast<float*>(buf1 + (size_t)kTile * S);
  int* attn_q = reinterpret_cast<int*>(means + kTile * 128);
  const int c0 = blockIdx.x * kTile;
  const int nv = min(kTile, n - c0);
  const size_t d = (size_t)L4 * 256;

  zero_smem(buf0, kTile * S);
  zero_smem(buf1, kTile * S);
  gate_rows(zx + (size_t)c0 * 128, zt, new_z, sim, attn_q, c0, nv, ga.ct,
            ga.ct_valid, ga.window, ga.alpha, ga.beta);
  __syncthreads();
  mix_rows(attn_q, t, x + (size_t)c0 * d, d, 256, new_t, buf0, c0, nv, ga.ct,
           ga.window, L4, S, ga.alpha, ga.beta, ga.s_x, ga.s_t127, ga.s_out);
  __syncthreads();
  head_body(buf0, buf1, means, hw, cls, reg, c0, nv, L4, nc, S);
}

size_t gate_head_int8_smem(int l4, int* S) {
  *S = head_stride(l4);
  return 2 * (size_t)kTile * *S +
         (size_t)kTile * (128 * sizeof(float) + kMaxWindow * sizeof(int));
}

}  // namespace

extern "C" long long gate_head_int8_smem_bytes(int l4) {
  int S;
  return (long long)gate_head_int8_smem(l4, &S);
}

// K12: zx, zt (n, 128) bf16; x, t (n, l4 * 256) int8 (n a multiple of ct);
// head: the 15 pointers (w, s_eff, b_eff) of the five head convs, then the
// cls/reg weights -> new_t (n, l4 * 256) int8, new_z (n, 128) bf16, sim
// (n, window) f32, cls (n, nc) f32, reg (n, 2) f32.
extern "C" int gate_head_int8_launch(
    const void* zx, const void* zt, const void* x, const void* t, void* new_t,
    void* new_z, void* sim, const void* const* head, const void* wc,
    const void* bc, const void* wr, const void* br, void* cls, void* reg,
    int n, int ct, int ct_valid, int window, int l4, int nc, float alpha,
    float beta, float s_x, float s_t127, float s_out, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (window > kMaxWindow) return (int)cudaErrorInvalidValue;
  int S;
  const size_t smem = gate_head_int8_smem(l4, &S);
  int err = set_smem((const void*)gate_head_int8_kernel, smem);
  if (err) return err;
  const GateArgs ga = {ct, ct_valid, window, alpha, beta, s_x, s_t127, s_out};
  gate_head_int8_kernel<<<(n + kTile - 1) / kTile, kThreads, smem,
                          (cudaStream_t)stream>>>(
      (const bf16*)zx, (const bf16*)zt, (const int8_t*)x, (const int8_t*)t,
      (int8_t*)new_t, (bf16*)new_z, (float*)sim,
      head_weights(head, wc, bc, wr, br), (float*)cls, (float*)reg, ga, n,
      l4, nc, S);
  return (int)cudaGetLastError();
}
