"""Same-call timing of source variants of K6 (gate_int8, ``csrc/gate.cu``)
and K4 (head, ``csrc/head_bf16.cu``) on one CUDA card, at the flagship
shapes of ``chip_smoke.py`` (B=384, 456 rows a stream, 56 cutout points).

Each variant is a copy of ``planar_optical_flow_tpu_torch/csrc`` in
``build/variants/<name>/`` with text replacements (``[file, old, new]``)
or whole files swapped in (``[file, "__file__", path in the repo]``);
both sources of every variant are built in parallel, loaded in place of the
shipped libraries one after the other, checked to the bit against the
shipped kernels' outputs and timed with CUDA events, in turns (each variant
twice, in the order given and then reversed). Comparing versions in one
call keeps the card and its neighbours the same.

Run from the repo root, e.g.
``python3 experiments/torch_gate_variants.py '{"shipped": []}'``.
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
from torch_gate_head_split import inputs  # noqa: E402

LIBS = ("gate", "head_bf16")


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
        for lib in LIBS:
            out = os.path.join(d, f"{lib}.so")
            procs[name, lib] = (subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o", out,
                 os.path.join(d, f"{lib}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for (name, lib), (p, out) in procs.items():
        log, _ = p.communicate()
        print(f"[{name}] nvcc {lib}.cu rc {p.returncode}")
        for line in log.splitlines():
            if any(s in line for s in ("registers", "spill", "rror",
                                       "Performance Loss")):
                print(f"[{name}] {lib}: {line.strip()[:200]}")
        if p.returncode == 0:
            libs.setdefault(name, {})[lib] = ctypes.CDLL(out)
    return libs


def main(variants):
    from planar_optical_flow_tpu_torch.infer.fast_gate import gate_int8
    from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs

    libs = build(variants)
    dev = torch.device("cuda")
    card = cs_.card_line()
    with torch.inference_mode():
        k6_args, k6_kw, t4, conv_w, head_w = inputs(dev)
        laid = cs.head_weights_bf16(conv_w)
        fns = {"K6": lambda: gate_int8(*k6_args, **k6_kw),
               "K4": lambda: cs.head(t4, laid, head_w, num_classes=1,
                                     l4=14)}
        refs = {k: fn() for k, fn in fns.items()}
        torch.cuda.synchronize()
        order = [n for n in variants if n in libs]
        times = {n: {k: [] for k in fns} for n in order}
        for name in order + order[::-1]:
            for lib, handle in libs[name].items():
                _build._LOADED[lib] = handle
            for k, fn in fns.items():
                got = fn()
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, refs[k]))
                if k == "K6" and not same:
                    print(f"[{name}] K6 differs from the shipped kernel")
                times[name][k].append(cs_.time_ms(fn, 10))
        for name in order:
            print(f"[{name}] " + " ".join(
                f"{k} {json.dumps([round(t, 4) for t in v])} ms"
                for k, v in times[name].items()) + f" on {card}", flush=True)


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
