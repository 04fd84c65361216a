// The banded template mix on row tiles of one stream, shared by gate.cu
// (K3, bf16 mode) and banded_mix.cu (K15): band_mix_kernel.
//
// K3 replaces planar_optical_flow_tpu/infer/fast_gate.py gate_fused_flat
// (kernel _gate_fused_kernel) with bf16 features; K15 replaces
// banded_mix_update (kernel _mix_kernel), the JAX package's standalone form
// of the same mix. Per stream of ct rows, hw = window / 2:
//   K3:  new_t[i] = alpha * x[i] + beta * acc[i],
//        acc[i] = sum_{k = 0 .. window-1} a[i, k] * t[i + k - hw]
//        a = bf16(attn) of band_attention, the template zero outside
//        [0, ct), acc summed from 0.0 in k order;
//   K15: out[i] = alpha * x[i] + beta * acc[i],
//        acc[i] = a[i, hw] * t[i] + sum_{k != hw} a[i, k] * t[(i + k - hw) mod ct]
//        a the f32 attention given, the o = 0 term first, then k in order.
// Every product and sum is one __fmul_rn / __fadd_rn, the blend
// __fadd_rn(__fmul_rn(alpha, x), __fmul_rn(beta, acc)), rounded once to the
// output dtype: the plain versions' op order, so K3 equals gate_plain and
// K15 banded_mix_update_plain to the bit on the same attention. A zero
// weight adds exactly 0: K3's acc starts at +0 and the rows it stages as
// zeros (and the rows >= ct_valid, whose weights are all 0) add +-0.
//
// The block: grid (stream, tile of `rows` <= kMixRows = 32 rows of it). K3
// computes the attention of its own rows once (band_attention, and
// z_mix_and_sim for new_z and sim, band_gate.cuh), from its zx rows and zt
// rows (with the band's halo) staged in shared memory by two bulk copies
// into the ring's last stage; K15 reads its rows'. The mix operand goes to
// shared memory, (window, kMixRows), k-major. The block then walks D in
// chunks of kMixPitch = 512 bytes a row, staging the template rows [i0 -
// hw, i0 + rows + hw) and the x rows [i0, i0 + rows) of a chunk in a ring
// of 2-3 stages: each row chunk is one cp.async.bulk
// (contiguous, a multiple of 16 bytes) that completes on the stage's
// mbarrier. The first stages' copies leave before the attention, whose time
// hides theirs; later chunks are in flight while one is mixed. K3 stages
// the rows outside [0, ct) as zeros, never copied; K15 copies the wrapped
// rows (j mod ct) with copies of their own, so no `%` is in the mix. No
// block reads a neighbouring stream.
//
// The mix is a register window. Warp w owns the run of kMixRun rows from r0
// = kMixRun * (w % kMixRuns) and the 256-byte slice w / kMixRuns of the
// chunk, each lane 8 bytes of it (4 bf16 or 2 f32 columns); the kMixSlices
// warps of a run share its weights. At offset k the run reads staged rows
// r0 + k .. r0 + k + kMixRun - 1; stepping to k + 1 drops the first and
// loads one row, so the kMixRun + window - 1 staged rows of a run are each
// read from shared memory once (K15 reads its kMixRun centre rows once more,
// for the o = 0 term that leads its sum). The window's slots are named
// modulo kMixRun and the k loop is unrolled by kMixRun, so the window stays
// in registers for any window. The weights of offset k for the run's rows
// are two broadcast 16-byte loads. new_t leaves from registers, a warp
// writing each row's 256 contiguous bytes of its slice. Two slices (32-row
// tiles of 512-byte row chunks) ran faster than one or four, and the copies
// spread over all warps faster than on the first threads (PERF.md;
// experiments/torch_band_gate_split.py --variants default): a block's
// refills, one bulk copy a row chunk each, cost less for fewer, larger
// copies issued by every warp.
//
// Bound: device-memory bytes: x and the template read once, the output
// written once (3 x 7 KB a row in bf16 at D = 3584; K3 adds zx, zt, new_z
// and sim); a tile's 2 hw halo rows of template come mostly from L2. The
// mix is 2 * window f32 operations an output, under the bytes' time.

#pragma once

#include "band_gate.cuh"

namespace {

constexpr int kMixRun = 8;            // rows of a warp's run
constexpr int kMixLaneRow = 256;      // bytes of a row a warp mixes: 8 a lane
constexpr int kMixSlices = 2;         // warps side by side on a row chunk
constexpr int kMixRuns = kWarps / kMixSlices;
constexpr int kMixRows = kMixRuns * kMixRun;  // rows of a stream a block
constexpr int kMixPitch = kMixSlices * kMixLaneRow;  // bytes a staged row
constexpr int kMixBarBytes = 64;      // the ring's mbarriers and K3's z one
constexpr int kSmSmemBytes = 233472;  // shared memory of an H100 SM
constexpr int kBlockReserved = 1024;  // of it, reserved for each block
static_assert(kMixRuns * kMixSlices == kWarps, "warps = runs x slices");

// the staged template rows of a tile: its rows and hw halo rows either side
__host__ __device__ constexpr int mix_t_rows(int window) {
  return kMixRows + window - 1;
}

__host__ __device__ constexpr int mix_stage_bytes(int window) {
  return (mix_t_rows(window) + kMixRows) * kMixPitch;
}

// dynamic shared memory of a block: the ring, the attention, the barriers
__host__ __device__ constexpr int mix_smem_bytes(int window, int stages) {
  return stages * mix_stage_bytes(window) + window * kMixRows * 4 +
         kMixBarBytes;
}

// three stages where two blocks still share an SM, else two
__host__ __device__ constexpr int mix_stages(int window) {
  return 2 * (mix_smem_bytes(window, 3) + kBlockReserved) <= kSmSmemBytes
             ? 3 : 2;
}

// rows a tile: ct cut into ceil(ct / kMixRows) tiles as even as they come
inline int mix_tile_rows(int ct) {
  const int n = (ct + kMixRows - 1) / kMixRows;
  return (ct + n - 1) / n;
}

// 8 bytes of a row: 4 bf16 or 2 f32 columns, as f32
template <typename T>
constexpr int kLaneCols = 8 / (int)sizeof(T);

__device__ __forceinline__ void lane_load(const bf16* p, float (&f)[4]) {
  load4(p, f);
}

__device__ __forceinline__ void lane_load(const float* p, float (&f)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  f[0] = v.x;
  f[1] = v.y;
}

__device__ __forceinline__ void lane_store(bf16* p, const float (&f)[4]) {
  store4(p, f);
}

__device__ __forceinline__ void lane_store(float* p, const float (&f)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
}

// A block's tile and its shared memory
struct MixTile {
  unsigned char* ring;  // stages x (template rows, x rows), kMixPitch a row
  float* attn;          // the mix operand, (window, kMixRows)
  uint64_t* full;       // a barrier a stage, then K3's z barrier
  int stages, stage_bytes, window, hw, ct, i0, nr, row_bytes, nch;
  size_t row0;          // the stream's first row
};

__device__ __forceinline__ MixTile mix_tile(unsigned char* smem, int ct,
                                            int window, int row_bytes,
                                            int rows) {
  MixTile g;
  g.stages = mix_stages(window);
  g.stage_bytes = mix_stage_bytes(window);
  g.ring = smem;
  g.attn = reinterpret_cast<float*>(smem + g.stages * g.stage_bytes);
  g.full = reinterpret_cast<uint64_t*>(g.attn + window * kMixRows);
  g.window = window;
  g.hw = window / 2;
  g.ct = ct;
  g.i0 = blockIdx.y * rows;
  g.nr = min(rows, ct - g.i0);
  g.row_bytes = row_bytes;
  g.nch = (row_bytes + kMixPitch - 1) / kMixPitch;
  g.row0 = (size_t)blockIdx.x * ct;
  return g;
}

// the stream row that staged template row m holds: K15 wraps it; K3's rows
// outside the stream are -1 (staged as zeros)
template <bool kCircular>
__device__ __forceinline__ int mix_source(const MixTile& g, int m) {
  int j = g.i0 - g.hw + m;
  if (kCircular) {
    j %= g.ct;
    return j < 0 ? j + g.ct : j;
  }
  return j >= 0 && j < g.ct ? j : -1;
}

// Bulk copies of the tile's rows, every thread of the block: copy q takes
// bytes [col, col + cb) of staged template row q (q < nr + 2 hw) from `t`,
// or of x row q - nr - 2 hw from `x` (rows of row_bytes), to `st` at
// `pitch` bytes a row, the x rows after mix_t_rows of them. Lane l of warp
// w issues copy l * kWarps + w, so every warp issues an eighth of them: a
// warp's copies leave one lane after another, and the next chunk barrier
// waits for the slowest warp. Each warp announces its bytes on `bar` before
// its lanes copy: one arrival a warp a phase.
template <bool kCircular>
__device__ __forceinline__ void mix_copy(const MixTile& g, uint64_t* bar,
                                         unsigned char* st, int pitch,
                                         const void* t, const void* x,
                                         int row_bytes, int col, int cb) {
  const int nt = g.nr + 2 * g.hw;
  const int q = (threadIdx.x & 31) * kWarps + (threadIdx.x >> 5);
  const unsigned char* src = nullptr;
  unsigned char* dst = nullptr;
  if (q < nt) {
    const int j = mix_source<kCircular>(g, q);
    if (j >= 0) {
      src = static_cast<const unsigned char*>(t) + (g.row0 + j) * row_bytes +
            col;
      dst = st + q * pitch;
    }
  } else if (q < nt + g.nr) {
    const int r = q - nt;
    src = static_cast<const unsigned char*>(x) +
          (g.row0 + g.i0 + r) * row_bytes + col;
    dst = st + (mix_t_rows(g.window) + r) * pitch;
  }
  const unsigned copies = __ballot_sync(kFull, src != nullptr);
  if ((threadIdx.x & 31) == 0) mbar_arrive_expect_tx(bar, __popc(copies) * cb);
  __syncwarp();
  if (src != nullptr) bulk_copy_g2s(dst, src, cb, bar);
}

// the copies of chunk ch into its stage
template <bool kCircular>
__device__ __forceinline__ void mix_issue(const MixTile& g, const void* x,
                                          const void* t, int ch) {
  const int s = ch % g.stages, col = ch * kMixPitch;
  mix_copy<kCircular>(g, g.full + s, g.ring + s * g.stage_bytes, kMixPitch,
                      t, x, g.row_bytes, col, min(kMixPitch, g.row_bytes - col));
}

// K3: zero the template rows outside the stream in stages [s0, s1); no copy
// writes them
__device__ __forceinline__ void mix_zero_rows(const MixTile& g, int s0,
                                              int s1) {
  constexpr int kVecs = kMixPitch / 16;
  const int nt = g.nr + 2 * g.hw;
  for (int idx = threadIdx.x; idx < (s1 - s0) * nt * kVecs; idx += kThreads) {
    const int v = idx % kVecs, m = idx / kVecs % nt;
    const int s = s0 + idx / (kVecs * nt);
    if (mix_source<false>(g, m) < 0)
      *reinterpret_cast<uint4*>(g.ring + s * g.stage_bytes + m * kMixPitch +
                                16 * v) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The ring's barriers (and K3's z barrier), then the copies of the first
// `chunks` chunks
template <bool kCircular>
__device__ __forceinline__ void mix_begin(const MixTile& g, const void* x,
                                          const void* t, int chunks) {
  if (threadIdx.x == 0) {
    for (int s = 0; s <= g.stages; ++s) mbar_init(g.full + s, kWarps);
    mbar_init_fence();
  }
  __syncthreads();
  for (int ch = 0; ch < min(chunks, g.nch); ++ch)
    mix_issue<kCircular>(g, x, t, ch);
}

// The mix sums of a warp's run: acc[u] of run row u, from the staged
// template rows at `tr` (the run's first staged row, this lane's bytes) and
// the weights a[k * kMixRows + u] of offset k
template <typename T, bool kCircular>
__device__ __forceinline__ void mix_run(const unsigned char* tr,
                                        const float* a, int window,
                                        float (&acc)[kMixRun][kLaneCols<T>]) {
  constexpr int C = kLaneCols<T>;
  const int hw = window / 2;
  auto row = [&](int m, float (&v)[C]) {
    lane_load(reinterpret_cast<const T*>(tr + m * kMixPitch), v);
  };
  auto weights = [&](int k, float (&w)[kMixRun]) {
    const float4 w0 = *reinterpret_cast<const float4*>(a + k * kMixRows);
    const float4 w1 = *reinterpret_cast<const float4*>(a + k * kMixRows + 4);
    w[0] = w0.x;
    w[1] = w0.y;
    w[2] = w0.z;
    w[3] = w0.w;
    w[4] = w1.x;
    w[5] = w1.y;
    w[6] = w1.z;
    w[7] = w1.w;
  };
  if (kCircular) {  // K15: the o = 0 term leads the sum
    float w[kMixRun];
    weights(hw, w);
#pragma unroll
    for (int u = 0; u < kMixRun; ++u) {
      float v[C];
      row(u + hw, v);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[u][c] = __fmul_rn(w[u], v[c]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kMixRun; ++u)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[u][c] = 0.0f;
  }
  float win[kMixRun][C];  // staged row m of the run in slot m % kMixRun
#pragma unroll
  for (int m = 0; m < kMixRun - 1; ++m) row(m, win[m]);
  for (int k0 = 0; k0 < window; k0 += kMixRun) {
#pragma unroll
    for (int j = 0; j < kMixRun; ++j) {
      const int k = k0 + j;
      if (k < window) {
        row(k + kMixRun - 1, win[(j + kMixRun - 1) % kMixRun]);
        if (!kCircular || k != hw) {
          float w[kMixRun];
          weights(k, w);
#pragma unroll
          for (int u = 0; u < kMixRun; ++u)
#pragma unroll
            for (int c = 0; c < C; ++c)
              acc[u][c] = __fadd_rn(
                  acc[u][c], __fmul_rn(w[u], win[(j + u) % kMixRun][c]));
        }
      }
    }
  }
}

// The walk over D: wait for a chunk's stage, mix each run, blend with x and
// store; once every warp is done with the stage, refill it with the chunk
// `stages` ahead
template <typename T, bool kCircular>
__device__ __forceinline__ void mix_walk(const MixTile& g, const T* x,
                                         const T* t, T* out, float alpha,
                                         float beta) {
  constexpr int C = kLaneCols<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp % kMixRuns * kMixRun;
  const int lb = warp / kMixRuns * kMixLaneRow + 8 * lane;  // row bytes
  const int d = g.row_bytes / (int)sizeof(T);
  for (int ch = 0; ch < g.nch; ++ch) {
    const int s = ch % g.stages;
    const int cb = min(kMixPitch, g.row_bytes - ch * kMixPitch);
    mbar_wait(g.full + s, (ch / g.stages) & 1);
    const unsigned char* st = g.ring + s * g.stage_bytes;
    if (r0 < g.nr && lb < cb) {
      float acc[kMixRun][C];
      mix_run<T, kCircular>(st + r0 * kMixPitch + lb, g.attn + r0, g.window,
                            acc);
      const unsigned char* xs =
          st + (mix_t_rows(g.window) + r0) * kMixPitch + lb;
      T* o = out + (g.row0 + g.i0 + r0) * d +
             (ch * kMixPitch + lb) / (int)sizeof(T);
#pragma unroll
      for (int u = 0; u < kMixRun; ++u) {
        if (r0 + u < g.nr) {
          float v[C];
          lane_load(reinterpret_cast<const T*>(xs + u * kMixPitch), v);
#pragma unroll
          for (int c = 0; c < C; ++c)
            v[c] = __fadd_rn(__fmul_rn(alpha, v[c]),
                             __fmul_rn(beta, acc[u][c]));
          lane_store(o + (size_t)u * d, v);
        }
      }
    }
    __syncthreads();  // every warp is done with stage s
    if (ch + g.stages < g.nch) mix_issue<kCircular>(g, x, t, ch + g.stages);
  }
}

// K3 (kCircular false; bf16 zx, zt, x, t, new_t, new_z; attn unused) and
// K15 (kCircular true; attn (streams * ct, window) f32, x, t, out bf16 or
// f32; zx, zt, new_z, sim unused). rows: mix_tile_rows(ct).
//
// K3 stages the embeddings its attention reads, zt rows [i0 - hw, i0 + nr +
// hw) and zx rows [i0, i0 + nr) at 256 bytes a row, in the ring's last
// stage, whose first chunk it copies after the attention; band_attention
// and z_mix_and_sim then read shared memory through stream-based pointers.
// They read no row outside those unless the whole tile lies past
// ct_valid + hw (they then read row ct_valid - 1): such a tile reads device
// memory.
template <typename T, bool kCircular>
__global__ void __launch_bounds__(kThreads, 2)
    band_mix_kernel(const T* __restrict__ zx, const T* __restrict__ zt,
                    const float* __restrict__ attn, const T* __restrict__ x,
                    const T* __restrict__ t, T* __restrict__ out,
                    T* __restrict__ new_z, float* __restrict__ sim, int ct,
                    int ct_valid, int window, int d, int rows, float alpha,
                    float beta) {
  extern __shared__ __align__(16) unsigned char mix_smem[];
  const MixTile g = mix_tile(mix_smem, ct, window, d * (int)sizeof(T), rows);
  if constexpr (kCircular) {  // the given attention of the block's rows
    mix_begin<true>(g, x, t, g.stages);
    for (int idx = threadIdx.x; idx < kMixRows * window; idx += kThreads) {
      const int r = idx / window, k = idx - r * window;
      g.attn[k * kMixRows + r] =
          r < g.nr ? attn[(g.row0 + g.i0 + r) * window + k] : 0.0f;
    }
    __syncthreads();
  } else {  // the attention of the block's rows, once: new_z, sim, bf16(a)
    const int last = g.stages - 1;
    const bool zs = ct_valid - 1 >= g.i0 - g.hw;  // stage the embeddings
    mix_begin<false>(g, x, t, zs ? last : g.stages);
    mix_zero_rows(g, 0, zs ? last : g.stages);
    const T* zx_s = zx + g.row0 * 128;  // row i of the stream at i * 128
    const T* zt_s = zt + g.row0 * 128;
    if (zs) {
      unsigned char* st = g.ring + last * g.stage_bytes;
      mix_copy<false>(g, g.full + g.stages, st, 256, zt, zx, 256, 0, 256);
      zt_s = reinterpret_cast<const T*>(st) - (g.i0 - g.hw) * 128;
      zx_s = reinterpret_cast<const T*>(st + mix_t_rows(window) * 256) -
             g.i0 * 128;
      mbar_wait(g.full + g.stages, 0);
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < kMixRows; r += kWarps) {
      float a = 0.0f;
      if (r < g.nr) {
        const int i = g.i0 + r;
        const BandLane br = band_attention(zx_s + i * 128, zt_s, i, ct_valid,
                                           window, lane);
        a = bf16_round(br.attn);
        z_mix_and_sim(zx_s + i * 128, zt_s, new_z + (g.row0 + i) * 128,
                      sim + (g.row0 + i) * window, i, window, br, a, alpha,
                      beta, lane);
      }
      if (lane < window) g.attn[lane * kMixRows + r] = a;
    }
    __syncthreads();
    if (zs) {  // the last stage is the ring's again
      mix_zero_rows(g, last, g.stages);
      if (last < g.nch) mix_issue<false>(g, x, t, last);
    }
  }
  mix_walk<T, kCircular>(g, x, t, out, alpha, beta);
}

// Launch band_mix_kernel<T, kCircular> over n / ct streams; d * sizeof(T)
// a multiple of 16, window odd and at most 31
template <typename T, bool kCircular>
int launch_band_mix(const void* zx, const void* zt, const void* attn,
                    const void* x, const void* t, void* out, void* new_z,
                    void* sim, int n, int d, int ct, int ct_valid, int window,
                    float alpha, float beta, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if ((d * sizeof(T)) % 16 || window % 2 == 0 || window > 31)
    return (int)cudaErrorInvalidValue;
  const int rows = mix_tile_rows(ct);
  const size_t smem = (size_t)mix_smem_bytes(window, mix_stages(window));
  int err = set_smem((const void*)band_mix_kernel<T, kCircular>, smem);
  if (err) return err;
  const dim3 grid(n / ct, (ct + rows - 1) / rows);
  band_mix_kernel<T, kCircular><<<grid, kThreads, smem,
                                  (cudaStream_t)stream>>>(
      (const T*)zx, (const T*)zt, (const float*)attn, (const T*)x,
      (const T*)t, (T*)out, (T*)new_z, (float*)sim, ct, ct_valid, window, d,
      rows, alpha, beta);
  return (int)cudaGetLastError();
}

}  // namespace

// (rows a tile, tiles a stream, ring stages, dynamic shared memory bytes)
// of a band_mix_kernel launch
extern "C" void band_mix_geometry(int ct, int window, int* rows, int* tiles,
                                  int* stages, long long* smem) {
  *rows = mix_tile_rows(ct);
  *tiles = (ct + *rows - 1) / *rows;
  *stages = mix_stages(window);
  *smem = mix_smem_bytes(window, *stages);
}
