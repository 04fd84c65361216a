"""Per-stage split of the int8c kernels K5 (backbone_int8) and K7
(head_int8) on one CUDA card, at the flagship shapes of ``chip_smoke.py``
(B=384, 456 rows a stream, 56 cutout points).

The sources of ``planar_optical_flow_tpu_torch/csrc`` are copied into
``build/stage_split/`` and instrumented there: thread 0 of every block
writes ``%globaltimer`` after each ``__syncthreads()`` of the kernel
functions named below (and at their start and end) into a buffer of 64
stamps a block. The shipped kernels carry no timing code. The instrumented
library is loaded in place of the shipped one, its outputs are checked
against the shipped kernel's, and the mean time between stamps is printed
per stage, labelled with the statement before each barrier.

Run from the repo root: ``python3 experiments/torch_int8_split.py``.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

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


# the mma.sync backbone (int8_stack.cuh's backbone_tail, before the wgmma
# kernels) ran the gate embed in the kernel: a barrier before it splits it
# off (the wgmma sources have no such line)
PRE = [("  // gate embed zx", "  __syncthreads();\n  // gate embed zx")]


def body_span(text, name):
    for m in re.finditer(r"\b" + re.escape(name) + r"\s*\(", text):
        i, depth = m.end(), 1
        while depth:
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            i += 1
        j = i
        while text[j] in " \n\t":
            j += 1
        if text[j] == "{":
            k, depth = j + 1, 1
            while depth:
                depth += {"{": 1, "}": -1}.get(text[k], 0)
                k += 1
            return j, k
    raise RuntimeError(f"no body for {name}")


def instrument(text, name, offset, sync="__syncthreads();", end_sync=True):
    a, b = body_span(text, name)
    body = text[a + 1:b - 1]
    labels = ["start"]
    out, k, last = [], offset + 1, 0
    for m in re.finditer(re.escape(sync), body):
        prev = body[:m.start()].rstrip()
        stmt = prev[prev.rfind(";", 0, len(prev) - 1) + 1:].strip()
        stmt = stmt.split("\n")[-1] if len(stmt) > 70 else stmt
        labels.append(" ".join(stmt.split())[:70])
        out.append(body[last:m.end()] + f" STAMP({k});")
        last = m.end()
        k += 1
    out.append(body[last:])
    if end_sync:
        labels.append("end")
    tail = f"\n  {sync} STAMP({k});\n" if end_sync else ""
    new = "{\n  STAMP(" + str(offset) + ");" + "".join(out) + tail + "}"
    return text[:a] + new + text[b:], labels


def build_timed(funcs, tag, sync="__syncthreads();",
                source="conv_stack_int8.cu"):
    """funcs: [(file, function, offset, end_sync)] -> (lib, labels) of the
    instrumented ``csrc/<source>``"""
    src = os.path.join(ROOT, "planar_optical_flow_tpu_torch", "csrc")
    dst = os.path.join(ROOT, "build", "stage_split", tag)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for a, b in PRE:
        q = os.path.join(dst, "int8_stack.cuh")
        t_ = open(q).read().replace(a, b)
        open(q, "w").write(t_)
    labels = {}
    for fname, func, off, end_sync in funcs:
        p = os.path.join(dst, fname)
        text = open(p).read()
        text, lab = instrument(text, func, off, sync, end_sync)
        open(p, "w").write(text)
        labels[func] = (off, lab)
    cu = os.path.join(dst, source)
    text = open(cu).read()
    open(cu, "w").write(STAMP_DEF + text + (
        '\nextern "C" int set_stamps(void* p) {\n'
        '  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n'))
    out = os.path.join(dst, "libtimed.so")
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", out, cu]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    print(f"[split-{tag}] nvcc {time.perf_counter() - t0:.1f} s rc {res.returncode}")
    if res.returncode:
        print(res.stdout[-4000:], res.stderr[-4000:])
        raise SystemExit(1)
    return ctypes.CDLL(out), labels


def report(tag, stamps, labels, ms):
    st = stamps.cpu().numpy().astype(np.int64)
    print(f"[split-{tag}] {st.shape[0]} blocks; kernel {ms:.3f} ms (CUDA events)")
    for func, (off, lab) in labels.items():
        cols = st[:, off:off + len(lab)]
        ok = (cols > 0).all(1)
        cols = cols[ok]
        if not len(cols):
            continue
        d = np.diff(cols, axis=1) / 1e3  # us
        tot = (cols[:, -1] - cols[:, 0]) / 1e3
        print(f"[split-{tag}] {func}: {len(cols)} blocks, mean {tot.mean():.2f} us a block")
        for i in range(d.shape[1]):
            print(f"[split-{tag}]   {d[:, i].mean():9.2f} us "
                  f"({d[:, i].mean() / tot.mean() * 100:5.1f}%)  -> {lab[i + 1]}")
    first = st[st > 0].min()
    last = st.max()
    print(f"[split-{tag}] span of all stamps {(last - first) / 1e6:.3f} ms")


def main(tag, funcs, sync="__syncthreads();"):
    from planar_optical_flow_tpu_torch.infer.calibration import calibrate_serve_v3
    from planar_optical_flow_tpu_torch.infer.streaming import int8_weights
    from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs
    from planar_optical_flow_tpu_torch.ops.kernels import fold
    from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout
    import torch.nn.functional as F

    lib, labels = build_timed(funcs, tag, sync)
    dev = torch.device("cuda")
    model = cs_.build_model(0, dev)
    rng = np.random.default_rng(0)
    scans = torch.tensor(rng.uniform(0.5, 25.0, (3, cs_.BATCH, cs_.NUM_PTS)),
                         dtype=torch.float32, device=dev)
    calib = calibrate_serve_v3(model, cs_.CUTOUT_KW, scans[0][:8],
                               num_pts=cs_.NUM_PTS, device=dev)
    det = model.dr_spaam
    w = int8_weights(det, calib, dev)
    head_w = fold.head_linear_weights(det.head)
    c = 56
    p_pad = 456
    ckw = dict(num_cutout_pts=c, window_width=1.0, window_depth=0.5,
               padding_val=29.99, centered=True, area_mode=True, p_valid=450)
    with torch.inference_mode():
        flat = cutout(F.pad(scans[0], (0, p_pad - 450)), **ckw)
        feats, zx = cs.backbone_int8(flat, w.layer1, w.backbone, w.embed, l=c)
        t7 = feats.reshape(-1, 256)
        k5 = lambda: cs.backbone_int8(flat, w.layer1, w.backbone, w.embed, l=c)
        k7 = lambda: cs.head_int8(t7, w.head, head_w, num_classes=1, l4=c // 4)
        ref5, ref7 = k5(), k7()
        ms = {"K5": cs_.time_ms(k5, 5), "K7": cs_.time_ms(k7, 5)}
        print(f"[split-{tag}] shipped kernels: {json.dumps(ms)}")
        _build._LOADED["conv_stack_int8"] = lib
        for name, fn, ref in (("K5", k5, ref5), ("K7", k7, ref7)):
            stamps = torch.zeros(200000 * 64, dtype=torch.int64, device=dev)
            fn()
            t = cs_.time_ms(fn, 3, 1)
            stamps.zero_()
            assert lib.set_stamps(ctypes.c_void_p(stamps.data_ptr())) == 0
            got = fn()
            torch.cuda.synchronize()
            assert lib.set_stamps(ctypes.c_void_p(0)) == 0
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            print(f"[split-{tag}] {name} instrumented equals shipped: {same}")
            n = (got[0].shape[0] if name == "K7" else flat.shape[0])
            report(f"{tag}-{name}", stamps.reshape(-1, 64)[:(n + 7) // 8], labels, t)
        _build._LOADED.pop("conv_stack_int8")


# the kernel functions instrumented (file, function, first stamp, a stamp
# at the end): the wgmma kernels of this tree, or with --parent, run in a
# checkout from before them, the mma.sync kernels (head_body and
# backbone_tail of int8_stack.cuh)
STAGES = [("conv_stack_int8.cu", "backbone_int8_kernel", 0, True),
          ("conv_stack_int8.cu", "head_int8_kernel", 32, True)]
PARENT_STAGES = [("conv_stack_int8.cu", "head_int8_kernel", 0, False),
                 ("int8_stack.cuh", "head_body", 8, True),
                 ("conv_stack_int8.cu", "backbone_int8_kernel", 32, False),
                 ("int8_stack.cuh", "backbone_tail", 40, True)]

if __name__ == "__main__":
    parent = "--parent" in sys.argv[1:]
    main("parent" if parent else "wgmma", PARENT_STAGES if parent else STAGES)
