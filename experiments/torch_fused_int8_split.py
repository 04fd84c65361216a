"""Per-stage split of K8 (backbone_int8_cut, ``csrc/conv_stack_int8.cu``
``backbone_int8_cut_kernel``) and K12 (gate_head_int8,
``csrc/serve_cell.cu``), on one CUDA card, at the shapes of
``chip_smoke.py``'s checks (B=384, 456 rows a stream, 56 cutout points,
window 11; K12 on p2's features with scan 1's as the carried template).

The method of ``torch_cell_split.py``: the sources of
``planar_optical_flow_tpu_torch/csrc`` are copied into
``build/stage_split/fused-<kernel>/`` and instrumented there, thread 0 of
every block writing ``%globaltimer`` into a buffer of 64 stamps a block at
the points of ``K8_STAMPS`` / ``K12_STAMPS`` (each just after a block-wide
barrier): K8's start, the stream's scan and prefix sum, the taps, layer 1,
the five tail convs and the feats rows out; K12's start, the load of zx and
the feature rows, the attention, the template mix, the new template's copy
and the head. The shipped kernels carry no timing code. The unfused chains
(K1 -> K5 and K6 -> K7) and the shipped K8 and K12 are timed with CUDA
events; then each instrumented library is loaded in place of the shipped
one, held to the bit against the shipped kernel's outputs, timed with the
stamps off and run once with them on; the mean time of each stage a block
is printed, with the blocks a launch and the waves they make on the card's
SMs.

Run from the repo root: ``python3 experiments/torch_fused_int8_split.py``.
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

# (file, text, the stamp's label, whether a barrier goes before the stamp):
# a stamp after each text, in order; K8's feats copy and K12's head end
# without a barrier of their own
K8_STAMPS = [
    ("conv_stack_int8.cu",
     "  const int c0 = blockIdx.x * p + i0;  // the block's first row\n",
     "start", False),
    ("conv_stack_int8.cu",
     "  if (cfg.area_mode) scan_xla(cs_s + 1, p, scratch);\n",
     "scan, half-angles, prefix sum", False),
    ("conv_stack_int8.cu",
     "    cut_s[idx] = cutout_tap(r_s, cs_s, i0 + c, idx - c * L, ha_s[c], "
     "cfg);\n  }\n  __syncthreads();\n", "taps", False),
    ("conv_stack_int8.cu",
     "  layer1_packed<kFold>(cut_s, w1, b1, 1.0f, bufa, nv, L, T);\n"
     "  __syncthreads();\n", "layer 1", False),
    ("conv_stack_int8.cu",
     "  backbone_convs<kWgPoolRows>(bufa, bufb, R, nullptr, L, T, nv, c0, "
     "ring,\n                              sched, sb, tw);\n"
     "  __syncthreads();\n", "tail convs 2-6", False),
    ("conv_stack_int8.cu",
     "\n  for (int idx = threadIdx.x; idx < nv * L4 * 16; idx += kWgThreads)\n"
     "    dst[idx] = reinterpret_cast<const uint4*>(bufb)[idx];\n",
     "feats out", True),
]
K12_STAMPS = [
    ("serve_cell.cu", "  Ring ring = ring_start(smem_raw, sched);\n", "start",
     False),
    ("serve_cell.cu",
     "        reinterpret_cast<const uint4*>(x + (c0 + c) * L4 * 256)[v];\n"
     "  }\n  __syncthreads();\n", "zx and feature rows in", False),
    ("gate_head_wg.cuh",
     "  __syncthreads();\n\n  // ---- the band as mma.m16n8k32's A: A[r][k] = "
     "q[r][k - H - r + hw] ----\n", "attention", False),
    ("gate_head_wg.cuh",
     "  // ---- the new template to new_t and into the head's packed tile "
     "----\n", "template mix", False),
    ("gate_head_wg.cuh", "  // ---- K7 on the new template ----\n",
     "new template out", False),
    ("serve_cell.cu",
     "  gate_head_tile(zx_s, bufa, bufb, q_s, means, zt, t, new_t, new_z, "
     "sim, cls,\n                 reg, row0, i0, nv, L4, ca, ring, sched, "
     "sb, hw);\n", "head", True),
]
KERNELS = {"k8": ("conv_stack_int8", K8_STAMPS),
           "k12": ("serve_cell", K12_STAMPS)}


def build(name):
    """Copy the sources, add the stamps of kernel ``name`` and start its
    ``nvcc``: (process, library path)."""
    source, stamps = KERNELS[name]
    src = os.path.join(ROOT, "planar_optical_flow_tpu_torch", "csrc")
    dst = os.path.join(ROOT, "build", "stage_split", f"fused-{name}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for i, (f, text, _, barrier) in enumerate(stamps):
        q = os.path.join(dst, f)
        body = open(q).read()
        assert body.count(text) == 1, (name, text)
        stamp = ("  __syncthreads();\n" if barrier else "") + f"  STAMP({i});\n"
        open(q, "w").write(body.replace(text, text + stamp))
    cu = os.path.join(dst, f"{source}.cu")
    body = open(cu).read()
    open(cu, "w").write(STAMP_DEF + body + (
        '\nextern "C" int set_stamps(void* p) {\n'
        '  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n'))
    out = os.path.join(dst, f"{source}.so")
    return subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", out, cu],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), out


def report(name, stamps, n_blocks, n_stamps, labels):
    st = stamps.reshape(-1, 64)[:n_blocks, :n_stamps].cpu().numpy()
    st = st.astype(np.int64)
    st = st[(st > 0).all(1)]
    d = np.diff(st, axis=1) / 1e3  # us
    tot = (st[:, -1] - st[:, 0]) / 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[{name}] {len(st)} blocks ({n_blocks / sms:.1f} waves on {sms} "
          f"SMs), mean {tot.mean():.2f} us a block")
    for i, lab in enumerate(labels[1:]):
        print(f"[{name}]   {d[:, i].mean():9.2f} us "
              f"({d[:, i].mean() / tot.mean() * 100:5.1f}%)  {lab}")


def main():
    from planar_optical_flow_tpu_torch.infer.calibration import (
        calibrate_serve_v3,
    )
    from planar_optical_flow_tpu_torch.infer.fast_gate import (
        gate_head_int8, gate_int8,
    )
    from planar_optical_flow_tpu_torch.infer.streaming import int8_weights
    from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs
    from planar_optical_flow_tpu_torch.ops.kernels import fold
    from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout

    t0 = time.perf_counter()
    procs = {k: build(k) for k in KERNELS}
    libs = {}
    for k, (p, out) in procs.items():
        log, _ = p.communicate()
        print(f"[{k}] nvcc rc {p.returncode} ({time.perf_counter() - t0:.1f} "
              "s)")
        for line in log.splitlines():
            if any(s in line for s in ("registers", "spill", "rror", "C751",
                                       "C7520")):
                print(f"[{k}] {line.strip()[:160]}")
        if p.returncode == 0:
            libs[k] = ctypes.CDLL(out)
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
    c, p_pad, b = 56, 456, cs_.BATCH
    n, d, l4 = b * p_pad, 14 * 256, 14
    ckw = dict(num_cutout_pts=c, window_width=1.0, window_depth=0.5,
               padding_val=29.99, centered=True, area_mode=True, p_valid=450)
    bb, hd = cs.backbone_weights_int8(w.backbone), cs.head_weights_int8(w.head)
    gkw = dict(ct=p_pad, ct_valid=450, alpha=gp.alpha,
               window_size=gp.window_size, s_x=w.feat_scale,
               s_t=w.tmpl_scale, s_out=w.tmpl_scale)
    kw12 = dict(gkw, num_classes=1, l4=l4)
    with torch.inference_mode():
        sp = [F.pad(s, (0, p_pad - 450)) for s in scans]
        k1 = lambda: cutout(sp[0], **ckw)
        cut = k1()
        k5 = lambda: cs.backbone_int8(cut, w.layer1, bb, w.embed, l=c)
        k8 = lambda: cs.backbone_int8_cut(sp[0], w.layer1, bb, w.embed, **ckw)
        x, zx = k8()
        f2, zx2 = cs.backbone_int8_cut(sp[1], w.layer1, bb, w.embed, **ckw)
        tmpl = torch.clamp(torch.round(f2.float().reshape(n, d)
                                       * (w.feat_scale / w.tmpl_scale)),
                           -127, 127).to(torch.int8)
        x = x.reshape(n, d)
        del f2
        k6 = lambda: gate_int8(zx, zx2, x, tmpl, **gkw)
        t6 = k6()[0]
        k7 = lambda: cs.head_int8(t6.reshape(-1, 256), hd, head_w,
                                  num_classes=1, l4=l4)
        k12 = lambda: gate_head_int8(zx, zx2, x, tmpl, hd, head_w, **kw12)
        ref = {"k8": k8(), "k12": k12()}
        ms = {k: cs_.time_ms(f, 10) for k, f in
              (("K1", k1), ("K5", k5), ("K8", k8), ("K6", k6), ("K7", k7),
               ("K12", k12))}
        print(f"[fused] shipped at {p_pad} rows: {json.dumps(ms)} ms on "
              f"{card}", flush=True)
        blocks = b * -(-p_pad // 16)
        for k, (source, stamps) in KERNELS.items():
            if k not in libs:
                continue
            fn = k8 if k == "k8" else k12
            _build._LOADED[source] = libs[k]
            got = fn()
            torch.cuda.synchronize()
            same = all(torch.equal(a, r) for a, r in zip(got, ref[k]))
            print(f"[{k}] instrumented equals shipped: {same}; stamps off "
                  f"{cs_.time_ms(fn, 10):.4f} ms", flush=True)
            buf = torch.zeros(blocks * 64, dtype=torch.int64, device=dev)
            assert libs[k].set_stamps(ctypes.c_void_p(buf.data_ptr())) == 0
            fn()
            torch.cuda.synchronize()
            assert libs[k].set_stamps(ctypes.c_void_p(0)) == 0
            report(k, buf, blocks, len(stamps), [st[2] for st in stamps])
            _build._LOADED.pop(source, None)


if __name__ == "__main__":
    main()
