// K3 (bf16 and f32 gate) and K6 (int8-carry gate): the serving
// spatial-attention gate for Hopper (sm_90a).
//
// K3 replaces planar_optical_flow_tpu/infer/fast_gate.py gate_fused_flat
// (kernel _gate_fused_kernel, which computes in the features' dtype); K6
// replaces gate_fused_int8_pm with
// per_stream=True (kernel _gate_int8_pm_stream_kernel, _quantize_attn,
// _mix_requant). Both share the front half, as the JAX kernels share
// _attention_body: band_attention and z_mix_and_sim in band_gate.cuh, which
// states the math and also holds the int8 mix's requant (blend_requant; K6,
// K12 and K13 take the mix's sums on the tensor cores). K3 mixes the bf16 template with the bf16-rounded attention:
//   new_t[i] = alpha * x[i] + beta * sum_o bf16(attn[i, o]) * t[i + o]
// and in its f32 mode (f32 embeddings, features and template; the JAX
// mix_dtype f32) the f32 template with the f32 attention, every output f32.
//
// K3's bf16 mode is band_mix_kernel (band_mix.cuh, K15's kernel too): a
// block takes a tile of up to 32 rows of one stream, computes their
// attention once, and walks D with the template rows of the tile and its
// band's halo staged by cp.async.bulk into a ring of stages, the mix taken
// in a register window of each warp's run of rows; new_t equals gate_plain
// to the bit on the same attention.
//
// K3's f32 mode keeps gate_kernel: grid (stream, D-chunk); each block
// computes the stream's banded attention from the (ct, 128) embeddings into
// shared memory (one warp per row, channel dot products reduced with
// shuffles), then applies the band to its D-chunk as 2*hw+1 multiply-adds
// per element. The TPU kernels' dense (ct, ct) MXU matmul is not carried
// over.
//
// K6's grid is (stream, tile of kGateRows rows): each block computes the
// attention of its own rows once, then walks every column of them, the
// template rows of the tile and its band's halo staged in shared memory
// and the exact int32 mix taken on the int8 tensor cores (mma.m16n8k32,
// the quantized band as A, the byte-transposed template rows as B); see
// gate_int8_rows_kernel. K12 and K13 run the same mix on one 16-row tile
// (gate_head_wg.cuh), so their new_t is K6's bytes.
//
// new_t and new_z go to fresh buffers: the TPU kernels alias the carry,
// but here a block writing row i while another reads row i +- hw of the
// old template would race in place.
//
// Bound: device-memory bytes. Per cutout K3 reads x and the template (2 x 7
// KB bf16 at D=3584, 2 x 14 KB in f32) and writes new_t (7 KB; 14 KB); K6
// moves a third of the bf16 bytes in int8 (3 x 3.5 KB); all add the small
// embeddings and sim. K3's f32 blocks re-read the band's template rows from
// L1/L2; K6 reads each template byte (64 + 16) / 64 times from device
// memory and the band's 2*hw+1 times from shared memory.

#include "band_gate.cuh"
#include "band_mix.cuh"

namespace {

// K3's f32 mode: every embedding, feature and template f32
__global__ void __launch_bounds__(kThreads)
    gate_kernel(const float* __restrict__ zx, const float* __restrict__ zt,
                const float* __restrict__ x, const float* __restrict__ t,
                float* __restrict__ new_t, float* __restrict__ new_z,
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
    const float a = r.attn;
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

// ---- K6: a block of kGateRows rows of one stream ----------------------

constexpr int kGateRows = 64;    // rows of one stream a block
constexpr int kGateCols = 128;   // template columns a chunk
constexpr int kTbPitch = kGateCols + 8;   // words a staged row quad
constexpr int kXPitch = kGateCols + 16;   // bytes a staged x row

// The staged template of a block: KT k32 steps a 16-row tile (1 for
// window <= 17, else 2), the band's K window of row tile rt starting H rows
// above it; rows [i0 - H, i0 - H + ROWS) of the stream, in row quads.
template <int KT>
struct GateTiles {
  static constexpr int H = 8 * KT;
  static constexpr int ROWS = kGateRows - 16 + 32 * KT;
  static constexpr int QUADS = ROWS / 4;
  static constexpr int UNITS = QUADS * (kGateCols / 16);  // 4 x 16 bytes each
  static_assert(UNITS <= kThreads, "one staging unit a thread");
  static constexpr int TB_BYTES = QUADS * kTbPitch * 4;
};

// The int8 gate on the row tiles of a stream. Each block first computes
// the banded attention of its own rows once (band_attention, z_mix_and_sim:
// new_z and sim; q = clip(rint(127 * attn)) into shared memory) and packs
// its warp's row tile of the band into the A operand of mma.m16n8k32 (A[r][k]
// = q[r][k - H - r + hw] on the band, 0 off it). It then walks the template
// in chunks of kGateCols columns: the template rows [i0 - H, i0 - H + ROWS)
// of the chunk, read once from device memory into registers one chunk
// ahead, are staged byte-transposed (word (quad, c) holds rows 4 quad ..
// 4 quad + 3 of column c: the B operand's K order) by __byte_perm; x is
// staged by cp.async one chunk ahead. The exact int32 mix of each 16-row x
// 8-column tile is KT s8 mma products, and blend_requant (band_gate.cuh,
// the JAX _mix_requant's epilogue op for op) writes new_t over x in shared
// memory, from where it leaves in 16-byte stores. Rows outside [0, ct) of the stream are
// staged as zeros, so no block reads a neighbouring stream. The epilogue's
// instructions, the IEEE division's above all, and their latency set the
// pace more than the bytes do: the kernel is held to 64 registers so that
// four blocks share an SM (three, at the 80 it takes unbounded, ran slower
// on an H100).
template <int KT>
__global__ void __launch_bounds__(kThreads, 4)
    gate_int8_rows_kernel(const bf16* __restrict__ zx,
                          const bf16* __restrict__ zt,
                          const int8_t* __restrict__ x,
                          const int8_t* __restrict__ t,
                          int8_t* __restrict__ new_t, bf16* __restrict__ new_z,
                          float* __restrict__ sim, int ct, int ct_valid,
                          int window, int d, float alpha, float beta,
                          float s_x, float s_t127, float s_out) {
  using G = GateTiles<KT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* tb = reinterpret_cast<uint32_t*>(smem_raw);
  int8_t* xb = reinterpret_cast<int8_t*>(smem_raw + G::TB_BYTES);
  int* q_s = reinterpret_cast<int*>(xb + 2 * kGateRows * kXPitch);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int hw = window / 2;
  const int i0 = blockIdx.y * kGateRows;
  const int nr = min(kGateRows, ct - i0);
  const size_t row0 = (size_t)blockIdx.x * ct;
  const int nch = (d + kGateCols - 1) / kGateCols;

  // this thread's staging unit: row quad uq, columns ucol .. ucol + 15
  const int uq = threadIdx.x / (kGateCols / 16);
  const int ucol = 16 * (threadIdx.x % (kGateCols / 16));
  uint4 tr[4];
  auto load_t = [&](int col0, int cw) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = i0 - G::H + 4 * uq + e;
      tr[e] = make_uint4(0u, 0u, 0u, 0u);
      if (threadIdx.x < G::UNITS && j >= 0 && j < ct && ucol < cw)
        tr[e] = __ldg(reinterpret_cast<const uint4*>(
            t + (row0 + j) * d + col0 + ucol));
    }
  };
  auto load_x = [&](int col0, int cw, int buf) {
    const int v = cw / 16;
    for (int idx = threadIdx.x; idx < nr * v; idx += kThreads) {
      const int r = idx / v, c = idx - r * v;
      cp_async16(xb + (size_t)(buf * kGateRows + r) * kXPitch + 16 * c,
                 x + (row0 + i0 + r) * d + col0 + 16 * c);
    }
    cp_async_commit();
  };

  load_t(0, min(kGateCols, d));
  load_x(0, min(kGateCols, d), 0);

  // ---- banded attention of the block's rows: sim, new_z, q ----
  for (int r = warp; r < kGateRows; r += kWarps) {
    if (r < nr) {
      const int i = i0 + r;
      const size_t row = row0 + i;
      const BandLane br = band_attention(zx + row * 128, zt + row0 * 128, i,
                                         ct_valid, window, lane);
      if (lane < window) q_s[r * window + lane] = quantize_attn(br.attn);
      z_mix_and_sim(zx + row * 128, zt + row0 * 128, new_z + row * 128,
                    sim + row * window, i, window, br, bf16_round(br.attn),
                    alpha, beta, lane);
    } else if (lane < window) {
      q_s[r * window + lane] = 0;
    }
  }
  __syncthreads();

  // ---- this warp's A operand: row tile rt of the band ----
  const int rt = warp & 3, nh = warp >> 2;
  uint32_t a[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int rr = g + 8 * (reg & 1);
      const int kb = 32 * kt + 16 * (reg >> 1) + 4 * tq;
      uint32_t w = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = kb + e - G::H - rr + hw;  // band lane of (rr, k)
        const int qv = kk >= 0 && kk < window
                           ? q_s[(16 * rt + rr) * window + kk] : 0;
        w |= ((uint32_t)qv & 0xffu) << (8 * e);
      }
      a[kt][reg] = w;
    }

  for (int ch = 0; ch < nch; ++ch) {
    const int col0 = ch * kGateCols, cw = min(kGateCols, d - col0);
    const int buf = ch & 1;
    // the chunk's template, byte-transposed: 4 rows x 4 columns a step
    if (threadIdx.x < G::UNITS) transpose_quad(tb + uq * kTbPitch + ucol, tr);
    cp_async_wait<0>();
    __syncthreads();
    if (ch + 1 < nch) {  // the next chunk on its way during this one
      const int cw1 = min(kGateCols, d - col0 - kGateCols);
      load_t(col0 + kGateCols, cw1);
      load_x(col0 + kGateCols, cw1, buf ^ 1);
    }

    // the exact mix of row tile rt x this warp's 8-column tiles, and the
    // blend over x in place
    int8_t* xs = xb + (size_t)buf * kGateRows * kXPitch;
#pragma unroll
    for (int j = 0; j < kGateCols / 16; ++j) {
      const int n0 = 8 * (nh * (kGateCols / 16) + j);
      if (n0 >= cw) break;
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const uint32_t* bq = tb + (4 * rt + 8 * kt + tq) * kTbPitch + n0 + g;
        const uint32_t b[2] = {bq[0], bq[4 * kTbPitch]};
        mma_s8(acc, a[kt], b);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * rt + g + 8 * h;
        if (r < nr) {
          char2* px = reinterpret_cast<char2*>(xs + (size_t)r * kXPitch + n0 +
                                               2 * tq);
          const char2 xv = *px;
          *px = make_char2(
              (char)blend_requant(acc[2 * h], xv.x, alpha, beta, s_x, s_t127,
                                  s_out),
              (char)blend_requant(acc[2 * h + 1], xv.y, alpha, beta, s_x,
                                  s_t127, s_out));
        }
      }
    }
    __syncthreads();
    const int v = cw / 16;
    for (int idx = threadIdx.x; idx < nr * v; idx += kThreads) {
      const int r = idx / v, c = idx - r * v;
      *reinterpret_cast<uint4*>(new_t + (row0 + i0 + r) * d + col0 + 16 * c) =
          *reinterpret_cast<const uint4*>(xs + (size_t)r * kXPitch + 16 * c);
    }
  }
}

}  // namespace

// dynamic shared memory of a K3 f32 launch (bytes)
extern "C" long long gate_smem_bytes(int ct, int window) {
  return (long long)ct * window * sizeof(float);
}

// f32: 0 for bf16 arrays (the v3 step; band_mix_kernel), 1 for f32 ones
// (make_serve_step with compute_dtype=None; gate_kernel, in chunks of
// d_chunk columns)
extern "C" int gate_launch(const void* zx, const void* zt, const void* x,
                           const void* t, void* new_t, void* new_z, void* sim,
                           int n, int d, int ct, int ct_valid, int window,
                           int d_chunk, float alpha, float beta, int f32,
                           void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (!f32)
    return launch_band_mix<bf16, false>(zx, zt, nullptr, x, t, new_t, new_z,
                                        sim, n, d, ct, ct_valid, window,
                                        alpha, beta, stream);
  const size_t smem = (size_t)gate_smem_bytes(ct, window);
  int err = set_smem((const void*)gate_kernel, smem);
  if (err) return err;
  const dim3 grid(n / ct, d / d_chunk);
  gate_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)zx, (const float*)zt, (const float*)x, (const float*)t,
      (float*)new_t, (float*)new_z, (float*)sim, ct, ct_valid, window, d,
      d_chunk, alpha, beta);
  return (int)cudaGetLastError();
}

// dynamic shared memory of a K6 launch (bytes)
extern "C" long long gate_int8_smem_bytes(int window) {
  const int tb = window / 2 > 8 ? GateTiles<2>::TB_BYTES
                                : GateTiles<1>::TB_BYTES;
  return (long long)tb + 2 * kGateRows * kXPitch +
         (long long)kGateRows * window * sizeof(int);
}

namespace {

template <int KT>
int launch_gate_int8(const void* zx, const void* zt, const void* x,
                     const void* t, void* new_t, void* new_z, void* sim,
                     int n, int d, int ct, int ct_valid, int window,
                     float alpha, float beta, float s_x, float s_t127,
                     float s_out, void* stream) {
  const size_t smem = (size_t)gate_int8_smem_bytes(window);
  int err = set_smem((const void*)gate_int8_rows_kernel<KT>, smem);
  if (err) return err;
  const dim3 grid(n / ct, (ct + kGateRows - 1) / kGateRows);
  gate_int8_rows_kernel<KT><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)zx, (const bf16*)zt, (const int8_t*)x, (const int8_t*)t,
      (int8_t*)new_t, (bf16*)new_z, (float*)sim, ct, ct_valid, window, d,
      alpha, beta, s_x, s_t127, s_out);
  return (int)cudaGetLastError();
}

}  // namespace

// K6: d a multiple of 16, window odd and at most 33
extern "C" int gate_int8_launch(const void* zx, const void* zt, const void* x,
                                const void* t, void* new_t, void* new_z,
                                void* sim, int n, int d, int ct, int ct_valid,
                                int window, float alpha, float beta, float s_x,
                                float s_t127, float s_out, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (d % 16 || window / 2 > 16) return (int)cudaErrorInvalidValue;
  return (window / 2 > 8 ? launch_gate_int8<2> : launch_gate_int8<1>)(
      zx, zt, x, t, new_t, new_z, sim, n, d, ct, ct_valid, window, alpha,
      beta, s_x, s_t127, s_out, stream);
}
