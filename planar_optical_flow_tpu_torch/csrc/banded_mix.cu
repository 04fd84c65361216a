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
// It runs K3's mix (band_mix.cuh, band_mix_kernel<T, true>): tiles of up to
// 32 rows of one stream, the template rows of a chunk and their wrapped
// halo staged by cp.async.bulk, the mix in a register window; the o = 0
// term first and every step __fmul_rn / __fadd_rn, so the output equals
// banded_mix_update_plain to the bit.
//
// Bound: device-memory bytes: x and t read, out written, once each (3 x 7 KB
// a row in bf16 at D=3584).

#include "band_mix.cuh"

// n = streams * ct rows of d; f32: 1 for f32 x/t/out, 0 for bf16
extern "C" int banded_mix_launch(const void* attn, const void* x,
                                 const void* t, void* out, int n, int d,
                                 int ct, int window, float alpha, float beta,
                                 int f32, void* stream) {
  return (f32 ? launch_band_mix<float, true> : launch_band_mix<bf16, true>)(
      nullptr, nullptr, attn, x, t, out, nullptr, nullptr, n, d, ct, ct,
      window, alpha, beta, stream);
}
