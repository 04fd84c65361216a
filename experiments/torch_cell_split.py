"""Per-stage split of K13 (serve_cell_int8, ``csrc/serve_cell_wg.cu``) and
same-call timing of its source variants, on one CUDA card, at the shapes of
``chip_smoke.py``'s K13 check (B=384, 480 rows a stream, 56 cutout points,
the carry made by K9 from scan 0).

The method of ``torch_int8_split.py``: the sources of
``planar_optical_flow_tpu_torch/csrc`` are copied into
``build/stage_split/cell-<variant>/`` and instrumented there, thread 0 of
every block writing ``%globaltimer`` into a buffer of 64 stamps a block at
the points of ``STAMPS`` (each just after a block-wide barrier): the
start, layer 1, the five backbone convs, the gate embed, the attention, the
template mix, the new template's copy, and the head. The shipped kernel
carries no timing code. Each variant (``VARIANTS``, text replacements of
the shipped sources: the embed through the ring, the embed 8 k16 steps
ahead, the mix's tiles unrolled, the first template chunk loaded before
the attention, the attention's band loop unrolled) is built instrumented, loaded in place of
the shipped library, held to the bit against the unfused chain K9 -> K6 ->
K7, timed with CUDA events with the stamps off, in turns (in the order
given, then reversed), and then run once with the stamps on; the mean time
of each stage a block is printed. The chain's three kernels are timed in
the same call.

Run from the repo root: ``python3 experiments/torch_cell_split.py`` (every
variant) or with the names of the variants to run.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs_  # noqa: E402
from planar_optical_flow_tpu_torch.ops.kernels import _build  # noqa: E402

STAMP_DEF = r'''
__device__ unsigned long long* g_stamps;
#define STAMP(i) do { if (g_stamps && threadIdx.x == 0) { unsigned long long t_; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
  g_stamps[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 64 + (i)] = t_; } } while (0)
'''

# (text in serve_cell_wg.cu, the stamp's label): a stamp after each, in
# order (each text follows a __syncthreads())
STAMPS = [
    ("  // ---- K9: layer 1 (divide after the leaky), the int8 tail ----\n",
     "start"),
    ("  layer1_packed<kDivide>(cut_s, w1, b1, ca.in_scale, bufa, nv, L, T);\n"
     "  __syncthreads();\n", "cutouts and layer 1"),
    ("                              sched, sb, cw.tw);\n  __syncthreads();\n",
     "backbone convs 2-6"),
    ("  // ---- K6 and K7 ----\n", "gate embed"),
    ("  __syncthreads();\n\n  // ---- the band as mma.m16n8k32's A: A[r][k] = "
     "q[r][k - H - r + hw] ----\n", "attention"),
    ("  // ---- the new template to new_t and into the head's packed tile "
     "----\n", "template mix"),
    ("  // ---- K7 on the new template ----\n", "new template out"),
]
END = ("  cp_async_wait<0>();  // the zero copies past the last chunk\n}\n\n}"
       "  // namespace", "head")

# the embed streamed through the ring as 16 KB chunks after the backbone's
# and before the head's (the first version of the kernel), in place of its
# register prefetch
_RING_EMBED = r'''template <class Sched>
__device__ __forceinline__ void cell_embed_ring(const int8_t* feats, int xp,
                                                int nk, Ring& ring,
                                                const Sched& sched,
                                                const bf16* __restrict__ be,
                                                bf16* zx_s, int nv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int8_t* ra = feats + (size_t)g * xp;
  const int8_t* rb = ra + (size_t)8 * xp;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int kc = 0; kc < nk; ++kc) {
    const int8_t* wb = next_chunk(ring, sched, ring.i + kc);
#pragma unroll
    for (int s = 0; s < kEmbedK / 16; ++s) {
      uint32_t a[4];
      embed_frag_a(a, ra, rb, kc * kEmbedK + 16 * s + 2 * tq);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int8_t* bp =
            wb + ((size_t)(2 * s) * 128 + 16 * warp + 8 * j + g) * 16 + 4 * tq;
        const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(bp),
                               *reinterpret_cast<const uint32_t*>(bp + 2048)};
        mma_bf16(acc[j], a, b);
      }
    }
  }
  ring.i += nk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g + 8 * h;
    if (row >= nv) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 16 * warp + 8 * j + 2 * tq;
      bf16* z = zx_s + (size_t)row * 128 + col;
      z[0] = __float2bfloat16(
          __fadd_rn(acc[j][2 * h], __bfloat162float(be[col])));
      z[1] = __float2bfloat16(
          __fadd_rn(acc[j][2 * h + 1], __bfloat162float(be[col + 1])));
    }
  }
}

// The gate and the head of a tile'''

RING = [
    ("// The gate and the head of a tile", _RING_EMBED),
    ("    return backbone_chunk(j, cw.tw, L, T, src, bytes) ||\n"
     "           head_chunk(j, cw.hw, L4, T, src, bytes);\n",
     "    if (backbone_chunk(j, cw.tw, L, T, src, bytes)) return true;\n"
     "    if (j < nk) {\n      src = cw.we + (size_t)j * kStageBytes;\n"
     "      bytes = kStageBytes;\n      return true;\n    }\n"
     "    j -= nk;\n    return head_chunk(j, cw.hw, L4, T, src, bytes);\n"),
    ("  cell_embed<kEmbedDepth>(bufb, cell_pitch(L4, 256), nk, cw.we, cw.be, "
     "zx_s,\n                          nv);",
     "  cell_embed_ring(bufb, cell_pitch(L4, 256), nk, ring, sched, cw.be, "
     "zx_s, nv);"),
]
# the embed 8 k16 steps ahead instead of 16
LDG8 = [("cell_embed<kEmbedDepth>(", "cell_embed<8>(")]
# the mix's 8-column tiles unrolled by 4 (their count is known at run time)
UNROLL4 = [("    for (int jn = 0; jn < cc / 64; ++jn) {",
            "#pragma unroll 4\n    for (int jn = 0; jn < cc / 64; ++jn) {")]

# the first template chunk loaded before the attention, not after it
EARLY_T = [("  // ---- the template mix, chunk by chunk, blended over x in place "
            "----\n  load_t(0);\n",
            "  // ---- the template mix, chunk by chunk, blended over x in place "
            "----\n"),
           ("  // ---- the banded attention of the rows: sim, new_z, q ----\n",
            "  load_t(0);\n"
            "  // ---- the banded attention of the rows: sim, new_z, q ----\n")]
# the attention's loop over the band unrolled by 4 (band_gate.cuh, shared
# with K3 and K6), so that its loads of the carried rows overlap
UNROLL_ATTN = [("band_gate.cuh",
                "  BandLane r = {0.0f, false, 0.0f};\n"
                "  for (int k = 0; k < window; ++k) {",
                "  BandLane r = {0.0f, false, 0.0f};\n#pragma unroll 4\n"
                "  for (int k = 0; k < window; ++k) {")]

VARIANTS = {"shipped": [], "ring": RING, "ldg8": LDG8, "u4": UNROLL4,
            "early_t": EARLY_T, "unroll_attn": UNROLL_ATTN,
            "both": EARLY_T + UNROLL_ATTN}


def build(name, reps):
    src = os.path.join(ROOT, "planar_optical_flow_tpu_torch", "csrc")
    dst = os.path.join(ROOT, "build", "stage_split", f"cell-{name}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    cu = os.path.join(dst, "serve_cell_wg.cu")
    for rep in reps:  # (old, new) in serve_cell_wg.cu, or (file, old, new)
        f, a, b = rep if len(rep) == 3 else ("serve_cell_wg.cu", *rep)
        q = os.path.join(dst, f)
        text = open(q).read()
        assert a in text, (name, a)
        open(q, "w").write(text.replace(a, b))
    text = open(cu).read()
    for i, (anchor, _) in enumerate(STAMPS):
        assert text.count(anchor) == 1, (name, anchor)
        text = text.replace(anchor, anchor + f"  STAMP({i});\n")
    assert text.count(END[0]) == 1
    text = text.replace(
        END[0], f"  __syncthreads();\n  STAMP({len(STAMPS)});\n" + END[0])
    open(cu, "w").write(STAMP_DEF + text + (
        '\nextern "C" int set_stamps(void* p) {\n'
        '  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n'))
    out = os.path.join(dst, "serve_cell_wg.so")
    return subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", out, cu],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), out


def report(name, stamps, n_blocks):
    st = stamps.reshape(-1, 64)[:n_blocks, :len(STAMPS) + 1].cpu().numpy()
    st = st.astype(np.int64)
    st = st[(st > 0).all(1)]
    d = np.diff(st, axis=1) / 1e3  # us
    tot = (st[:, -1] - st[:, 0]) / 1e3
    print(f"[cell-{name}] {len(st)} blocks, mean {tot.mean():.2f} us a block")
    labels = [lab for _, lab in STAMPS[1:]] + [END[1]]
    for i, lab in enumerate(labels):
        print(f"[cell-{name}]   {d[:, i].mean():9.2f} us "
              f"({d[:, i].mean() / tot.mean() * 100:5.1f}%)  {lab}")


def main(names):
    from planar_optical_flow_tpu_torch.infer.calibration import (
        calibrate_serve_v3,
    )
    from planar_optical_flow_tpu_torch.infer.fast_gate import gate_int8
    from planar_optical_flow_tpu_torch.infer.streaming import int8_weights
    from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs
    from planar_optical_flow_tpu_torch.ops.kernels import fold
    from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout
    from planar_optical_flow_tpu_torch.ops.kernels.serve_cell import (
        cell_embed, serve_cell_int8,
    )

    t0 = time.perf_counter()
    procs = {n: build(n, VARIANTS[n]) for n in names}
    libs = {}
    for n, (p, out) in procs.items():
        log, _ = p.communicate()
        print(f"[cell-{n}] nvcc rc {p.returncode} "
              f"({time.perf_counter() - t0:.1f} s)")
        for line in log.splitlines():
            if any(s in line for s in ("registers", "spill", "rror",
                                       "C751", "C7520")):
                print(f"[cell-{n}] {line.strip()[:160]}")
        if p.returncode == 0:
            libs[n] = ctypes.CDLL(out)
    dev = torch.device("cuda")
    card = cs_.card_line()
    model = cs_.build_model(0, dev)
    rng = np.random.default_rng(0)
    scans = torch.tensor(rng.uniform(0.5, 25.0, (2, cs_.BATCH, cs_.NUM_PTS)),
                         dtype=torch.float32, device=dev)
    calib = calibrate_serve_v3(model, cs_.CUTOUT_KW, scans[0][:8],
                               num_pts=cs_.NUM_PTS, device=dev)
    det = model.dr_spaam
    w = int8_weights(det, calib, dev)
    head_w = fold.head_linear_weights(det.head)
    gp = fold.fold_gate_params(det.gate)
    c, p_pad = 56, 480
    n, d = cs_.BATCH * p_pad, 14 * 256
    ckw = dict(num_cutout_pts=c, window_width=1.0, window_depth=0.5,
               padding_val=29.99, centered=True, area_mode=True, p_valid=450)
    bb, hd = cs.backbone_weights_int8(w.backbone), cs.head_weights_int8(w.head)
    emb = cell_embed(w.embed)
    gkw = dict(ct=p_pad, ct_valid=450, alpha=gp.alpha,
               window_size=gp.window_size, s_x=w.feat_scale,
               s_t=w.tmpl_scale, s_out=w.tmpl_scale)
    kw13 = dict(gkw, l=c, in_scale=w.in_scale, num_classes=1)
    with torch.inference_mode():
        feats0, zt = cs.backbone_int8_pm(
            cutout(F.pad(scans[0], (0, p_pad - 450)), **ckw), w.layer1_div,
            bb, w.embed, l=c, in_scale=w.in_scale)
        tmpl = torch.clamp(torch.round(feats0.float().reshape(n, d)
                                       * (w.feat_scale / w.tmpl_scale)),
                           -127, 127).to(torch.int8)
        del feats0
        cut = cutout(F.pad(scans[1], (0, p_pad - 450)), **ckw)
        x, zx = cs.backbone_int8_pm(cut, w.layer1_div, bb, w.embed, l=c,
                                    in_scale=w.in_scale)
        chain = gate_int8(zx, zt, x.reshape(n, d), tmpl, **gkw)
        chain += cs.head_int8(chain[0].reshape(-1, 256), hd, head_w,
                              num_classes=1, l4=14)
        t6 = chain[0]
        k9 = lambda: cs.backbone_int8_pm(cut, w.layer1_div, bb, w.embed, l=c,
                                         in_scale=w.in_scale)
        k6 = lambda: gate_int8(zx, zt, x.reshape(n, d), tmpl, **gkw)
        k7 = lambda: cs.head_int8(t6.reshape(-1, 256), hd, head_w,
                                  num_classes=1, l4=14)
        k13 = lambda: serve_cell_int8(cut, zt, tmpl, w.layer1_div, bb, emb,
                                      hd, head_w, **kw13)
        chain_ms = {k: cs_.time_ms(f, 10) for k, f in
                    (("K9", k9), ("K6", k6), ("K7", k7))}
        print(f"[cell] the chain at {p_pad} rows: {json.dumps(chain_ms)} ms, "
              f"sum {sum(chain_ms.values()):.3f} on {card}", flush=True)
        order = [v for v in names if v in libs]
        times = {v: [] for v in order}
        for v in order + order[::-1]:
            _build._LOADED["serve_cell_wg"] = libs[v]
            got = k13()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, chain))
            print(f"[cell-{v}] equals K9 -> K6 -> K7: {same}", flush=True)
            times[v].append(cs_.time_ms(k13, 10))
        for v in order:
            ms = json.dumps([round(t, 4) for t in times[v]])
            print(f"[cell-{v}] K13 {ms} ms on {card}", flush=True)
            _build._LOADED["serve_cell_wg"] = libs[v]
            stamps = torch.zeros(n // 16 * 64, dtype=torch.int64, device=dev)
            assert libs[v].set_stamps(ctypes.c_void_p(stamps.data_ptr())) == 0
            k13()
            torch.cuda.synchronize()
            assert libs[v].set_stamps(ctypes.c_void_p(0)) == 0
            report(v, stamps, n // 16)
        _build._LOADED.pop("serve_cell_wg", None)


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
