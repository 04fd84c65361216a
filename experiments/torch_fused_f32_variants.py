"""Same-call timing of source variants of K14 in f32 (``fused_backbone`` and
``fused_head``, ``csrc/fused_f32.cu``) on one CUDA card, at the shapes of
``chip_smoke.py``'s phase 4 (B=384 streams x 450 cutouts of 56 points), in
the method of ``torch_gate_variants.py``: each variant is a copy of
``planar_optical_flow_tpu_torch/csrc`` in ``build/variants/<name>/`` with
text replacements (``[file, old, new]``) or whole files swapped in
(``[file, "__file__", path in the repo]``), built in parallel, loaded in
place of the shipped library one after the other, compared to the bit
with the shipped kernels' outputs (a variant that drops work is timing
only and says so) and timed with CUDA events, in turns (the order given,
then reversed).

Run from the repo root, e.g.
``python3 experiments/torch_fused_f32_variants.py '{"shipped": []}'``.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "experiments"))
import chip_smoke as cs_  # noqa: E402
from planar_optical_flow_tpu_torch.ops.kernels import _build  # noqa: E402
from torch_fused_f32_split import inputs  # noqa: E402

LIB = "fused_f32"


def build(variants):
    src = os.path.join(ROOT, "planar_optical_flow_tpu_torch", "csrc")
    procs = {}
    for name, reps in variants.items():
        d = os.path.join(ROOT, "build", "variants", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        for f, a, b in reps:
            p = os.path.join(d, f)
            if a == "__file__":  # the whole file from a path in the repo
                shutil.copy(os.path.join(ROOT, b), p)
                continue
            t = open(p).read()
            assert a in t, (name, a)
            open(p, "w").write(t.replace(a, b))
        out = os.path.join(d, f"{LIB}.so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", out,
             os.path.join(d, f"{LIB}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (p, out) in procs.items():
        log, _ = p.communicate()
        print(f"[{name}] nvcc rc {p.returncode}")
        for line in log.splitlines():
            if any(s in line for s in ("registers", "spill", "rror",
                                       "Performance Loss")):
                print(f"[{name}] {line.strip()[:200]}")
        if p.returncode == 0:
            libs[name] = ctypes.CDLL(out)
    return libs


def main(variants):
    from planar_optical_flow_tpu_torch.ops.kernels import fused_drow as fd

    libs = build(variants)
    dev = torch.device("cuda")
    card = cs_.card_line()
    f32 = torch.float32
    with torch.inference_mode():
        cut, w_bb, w_hd = inputs(dev)
        feats = fd.fused_backbone(cut, w_bb, compute_dtype=f32)
        fns = {"backbone": lambda: (fd.fused_backbone(cut, w_bb,
                                                      compute_dtype=f32),),
               "head": lambda: fd.fused_head(feats, w_hd, compute_dtype=f32)}
        refs = {k: fn() for k, fn in fns.items()}
        torch.cuda.synchronize()
        order = [n for n in variants if n in libs]
        times = {n: {k: [] for k in fns} for n in order}
        same = {n: {} for n in order}
        for name in order + order[::-1]:
            _build._LOADED[LIB] = libs[name]
            for k, fn in fns.items():
                got = fn()
                torch.cuda.synchronize()
                same[name][k] = all(torch.equal(a, b)
                                    for a, b in zip(got, refs[k]))
                times[name][k].append(cs_.time_ms(fn, 5))
        for name in order:
            print(f"[{name}] " + " ".join(
                f"{k} {json.dumps([round(t, 4) for t in v])} ms "
                f"(equal to shipped: {same[name][k]})"
                for k, v in times[name].items()) + f" on {card}", flush=True)


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
