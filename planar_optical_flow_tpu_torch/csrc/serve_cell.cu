// K12 (int8 gate + head) for Hopper (sm_90a). (K13, the whole cell, is
// serve_cell_wg.cu.)
//
// K12 replaces planar_optical_flow_tpu/infer/fast_gate.py
// gate_head_fused_int8_pm (kernel _gate_head_int8_pm_stream_kernel): K6 and
// then K7 on the fresh template, byte-identical to the pair.
//
// Design: K13's gate and head stage alone (gate_head_wg.cuh
// gate_head_tile). A block takes T cutouts (16 at L/4 = 14) of one stream,
// rows i0 .. i0 + T - 1 (grid: stream x tile; the last tile of a stream
// may be partial), copies their current zx and int8 feature rows into
// shared memory, then runs K6's row mix on one m16 tile (the attention
// once a row, the carried template staged byte-transposed, the exact int32
// mix on mma.m16n8k32) and K7's wgmma convs on the new template, which
// never leaves shared memory but for its copy to new_t. The head's conv
// weights, laid out once by the host (int8_tiles.plan_weights), stream
// through the 4 x 16 KB ring, the first chunks while the gate runs. A
// block reads only the carried zt and t and writes only fresh buffers, so
// no block reads what another writes (the TPU kernel aliases the carry).
//
// Shared memory at L/4 = 14, T = 16: the ring and a conv's scales (69,632
// bytes), two regions of 66,560 (the head's packed tiles and f32 rows, the
// pitched feature rows, the staged template), the means (8 KB), zx (4 KB)
// and the quantized band (2 KB): 217,088 of 232,448 bytes, one block an
// SM.
//
// Bound: int8 tensor-core operations, K7's ~28.9 M a cutout, against
// ~10.8 KB of device memory a cutout (x, the carried template and new_t at
// 3.5 KB each, the embeddings) and the head's 1.2 MB of conv weights, which
// each block reads from L2.

#include "gate_head_wg.cuh"

namespace {

// a block's region (each of two): the head's packed tiles and f32 rows,
// the block's pitched feature rows, the staged template
size_t gate_head_region(int l4, int T) {
  size_t r = head_tiles(l4, T);
  const size_t parts[2] = {(size_t)T * cell_pitch(l4, 256),
                           (size_t)gate_tb_bytes(2)};
  for (size_t p : parts) r = p > r ? p : r;
  return round128(r);
}

size_t gate_head_smem(int l4, int T) {
  return kRingBytes + 2 * gate_head_region(l4, T) +
         (size_t)T * 128 * (sizeof(float) + sizeof(bf16)) +
         (size_t)kCellRows * kMaxWindow * sizeof(int);
}

// cutouts a block: the most (16, halved) whose shared memory fits
int gate_head_block(int l4) {
  int T = kWgTile;
  while (T > 1 && gate_head_smem(l4, T) > kSmemMax) T /= 2;
  return T;
}

// K12. Shared memory: the ring and the scales, bufa and bufb (R bytes
// each), the means (T x 128 f32), zx (T x 128 bf16), the quantized band (16
// x kMaxWindow ints).
__global__ void __launch_bounds__(kWgThreads, 1)
    gate_head_int8_kernel(const bf16* __restrict__ zx,
                          const bf16* __restrict__ zt,
                          const int8_t* __restrict__ x,
                          const int8_t* __restrict__ t,
                          const __grid_constant__ HeadWeights hw,
                          int8_t* __restrict__ new_t,
                          bf16* __restrict__ new_z, float* __restrict__ sim,
                          float* __restrict__ cls, float* __restrict__ reg,
                          int L4, const __grid_constant__ CellArgs ca) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int T = ca.T, R = ca.R;
  float* sb = reinterpret_cast<float*>(smem_raw + kStages * kStageBytes);
  int8_t* bufa = reinterpret_cast<int8_t*>(smem_raw + kRingBytes);
  int8_t* bufb = bufa + R;
  float* means = reinterpret_cast<float*>(bufb + R);
  bf16* zx_s = reinterpret_cast<bf16*>(means + T * 128);
  int* q_s = reinterpret_cast<int*>(zx_s + T * 128);
  const int i0 = blockIdx.y * T;
  const int nv = min(T, ca.ct - i0);
  const size_t row0 = (size_t)blockIdx.x * ca.ct;  // the stream's row 0
  const size_t c0 = row0 + i0;                      // the block's row 0
  const int v_row = L4 * 16;                        // 16-byte vectors a row
  const int xp = cell_pitch(L4, 256);
  // the weight chunks of the head's convs, in the order they are used
  auto sched = [&](int j, const int8_t*& src, int& bytes) {
    return head_chunk(j, hw, L4, T, src, bytes);
  };

  Ring ring = ring_start(smem_raw, sched);
  // the rows' zx, and their features at the cell's pitch into bufb
  for (int idx = threadIdx.x; idx < nv * 16; idx += kWgThreads)
    reinterpret_cast<uint4*>(zx_s)[idx] =
        reinterpret_cast<const uint4*>(zx + c0 * 128)[idx];
  for (int idx = threadIdx.x; idx < nv * v_row; idx += kWgThreads) {
    const int c = idx / v_row, v = idx - c * v_row;
    *reinterpret_cast<uint4*>(bufb + (size_t)c * xp + 16 * v) =
        reinterpret_cast<const uint4*>(x + (c0 + c) * L4 * 256)[v];
  }
  __syncthreads();
  gate_head_tile(zx_s, bufa, bufb, q_s, means, zt, t, new_t, new_z, sim, cls,
                 reg, row0, i0, nv, L4, ca, ring, sched, sb, hw);
  cp_async_wait<0>();  // the zero copies past the last chunk
}

}  // namespace

// The launch geometry of K12 at l4 positions: cutouts a block, rows a
// cutout in the packed tile and dynamic shared memory (bytes);
// int8_tiles.gate_head_geometry mirrors it
extern "C" int gate_head_geometry(int l4, int* tile, int* rows,
                                  long long* smem) {
  *tile = gate_head_block(l4);
  *rows = pstride(l4);
  *smem = (long long)gate_head_smem(l4, *tile);
  return 0;
}

extern "C" long long gate_head_int8_smem_bytes(int l4) {
  return (long long)gate_head_smem(l4, gate_head_block(l4));
}

// The chunking of the convs (as conv_stack_int8.cu's int8_wg_plan), which
// int8_tiles lays out
extern "C" int int8_wg_plan(int which, int layer, int* ns, int* kc) {
  return int8_plan_of(which, layer, ns, kc);
}

// K12: zx, zt (n, 128) bf16; x, t (n, l4 * 256) int8 (n a multiple of ct,
// l4 even); head: the 15 pointers (w, s_eff, b_eff) of the five head convs,
// each w laid out by int8_tiles.plan_weights, then the cls/reg weights ->
// new_t (n, l4 * 256) int8, new_z (n, 128) bf16, sim (n, window) f32, cls
// (n, nc) f32, reg (n, 2) f32.
extern "C" int gate_head_int8_launch(
    const void* zx, const void* zt, const void* x, const void* t, void* new_t,
    void* new_z, void* sim, const void* const* head, const void* wc,
    const void* bc, const void* wr, const void* br, void* cls, void* reg,
    int n, int ct, int ct_valid, int window, int l4, int nc, float alpha,
    float beta, float s_x, float s_t127, float s_out, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (window < 1 || window > kMaxWindow || ct < 1 || n % ct ||
      (l4 * 256) % gate_cols(1))
    return (int)cudaErrorInvalidValue;
  const int T = gate_head_block(l4);
  const size_t smem = gate_head_smem(l4, T);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)gate_head_int8_kernel, smem);
  if (err) return err;
  const CellArgs ca = {ct,       ct_valid, window, 4 * l4, nc,
                       T,        (int)gate_head_region(l4, T), 1.0f,
                       alpha,    beta,     s_x,    s_t127, s_out};
  const dim3 grid(n / ct, (ct + T - 1) / T);
  gate_head_int8_kernel<<<grid, kWgThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)zx, (const bf16*)zt, (const int8_t*)x, (const int8_t*)t,
      head_weights(head, wc, bc, wr, br), (int8_t*)new_t, (bf16*)new_z,
      (float*)sim, (float*)cls, (float*)reg, l4, ca);
  return (int)cudaGetLastError();
}
