"""Per-stage split and same-call source variants of the bf16 backbone
kernel (``csrc/backbone_bf16.cu``): K2 from the cutouts (layer 1, the five
convs, the feats out, then the gate embed kernel) and K14's bf16 backbone,
on one CUDA card at the shapes of ``chip_smoke.py``'s phase 4 (B=384; K2 at
456 rows a stream, N = 175,104; K14 on the module cutouts of 450, N =
172,800; 56 cutout points).

* Split (the default): the method of ``torch_int8_split.py``. The sources
  are copied into ``build/stage_split/`` and instrumented there: thread 0
  of every block writes ``%globaltimer`` after each ``__syncthreads()`` of
  ``backbone_bf16_kernel``; the instrumented outputs are checked against the
  shipped ones, and the mean time between stamps is printed per stage in us
  a block. The embed kernel's share is the whole K2 call (CUDA events) less
  the backbone kernel's (``torch.profiler``).
* ``--phases``: a copy of ``csrc/`` in which thread 0 of every block adds
  up, per conv, the time from a pass's first product to its last product
  done (the products and the waits for their weight chunks) and from there
  to the end of the pass's epilogue, in device-wide counters
  (``%globaltimer``); printed in us a block beside the split's conv times.
* ``--variants '{"name": [[file, old, new], ...], ...}'``: each variant is a
  copy of ``csrc/`` with those text replacements, built in parallel and
  loaded in place of the shipped library one after the other; K2 and K14
  are timed with CUDA events and held against the shipped outputs (equal
  to the bit, or the max abs difference) in the same call. ``--plans
  '{"name": [[Cin, Cout, MT, NJ, WGN], ...]}'`` gives a variant its own
  ``int8_tiles.BACKBONE_BF16_PLAN`` (the weights are laid out for it).

Run from the repo root: ``python3 experiments/torch_backbone_bf16_split.py``.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "experiments"))
import chip_smoke as cs_  # noqa: E402
import torch_int8_split as split  # noqa: E402
from planar_optical_flow_tpu_torch.ops.kernels import _build  # noqa: E402

LIB = "backbone_bf16"
STAGES = [("backbone_bf16.cu", "backbone_bf16_kernel", 0, True)]


def inputs(dev):
    """K2's cutouts (K1 on a padded scan batch) and weights, K14's module
    cutouts and weights, as chip_smoke.py's phase 4 makes them."""
    import torch.nn.functional as F

    from planar_optical_flow_tpu_torch.infer.streaming import (
        _encode_single, _sanitize_scan,
    )
    from planar_optical_flow_tpu_torch.ops.geometry import get_laser_phi
    from planar_optical_flow_tpu_torch.ops.kernels import fold
    from planar_optical_flow_tpu_torch.ops.kernels import fused_drow as fd
    from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout

    model = cs_.build_model(0, dev)
    rng = np.random.default_rng(0)
    scans = torch.tensor(rng.uniform(0.5, 25.0, (1, cs_.BATCH, cs_.NUM_PTS)),
                         dtype=torch.float32, device=dev)
    det = model.dr_spaam
    c = cs_.CUTOUT_KW["num_cutout_pts"]
    p_pad = -(-cs_.NUM_PTS // 8) * 8
    flat = cutout(F.pad(scans[0], (0, p_pad - cs_.NUM_PTS)),
                  num_cutout_pts=c, window_width=1.0, window_depth=0.5,
                  padding_val=29.99, centered=True, area_mode=True,
                  p_valid=cs_.NUM_PTS)
    layer1, tail = fold.backbone_stack_weights(det.backbone)
    gp = fold.fold_gate_params(det.gate, dtype=torch.bfloat16)
    cut14 = _encode_single(_sanitize_scan(scans[0],
                                          cs_.CUTOUT_KW["padding_val"]),
                           get_laser_phi(num_pts=cs_.NUM_PTS),
                           cs_.CUTOUT_KW).reshape(-1, c)
    return flat, layer1, tail, (gp.w, gp.b), cut14, fd.backbone_weights(
        det.backbone)


def calls(flat, layer1, tail, emb, cut14, w_bb):
    """(name, call) of K2 and K14's bf16 backbone on weights laid out for
    the current ``int8_tiles.BACKBONE_BF16_PLAN``."""
    from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs
    from planar_optical_flow_tpu_torch.ops.kernels import fused_drow as fd

    c = cs_.CUTOUT_KW["num_cutout_pts"]
    laid, laid14 = cs.backbone_weights_bf16(tail), fd.backbone_weights_bf16(
        w_bb)
    return [("K2", lambda: cs.backbone_bf16(flat, layer1, laid, emb, l=c)),
            ("K14", lambda: (fd.fused_backbone(cut14, laid14,
                                               compute_dtype=torch.bfloat16),
                             ))]


def use(lib):
    """Load ``lib`` in place of the shipped library (its plan checked
    again)."""
    from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs

    _build._LOADED[LIB] = lib
    cs.check_backbone_bf16_plan.checked = False


def kernel_ms(fn, name):
    """Device time of each kernel of one call (torch.profiler), ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if name in ev.name or "embed_kernel" in ev.name:
            key = "embed" if "embed_kernel" in ev.name else "backbone"
            out[key] = out.get(key, 0.0) + (ev.time_range.end
                                            - ev.time_range.start) / 1e3
    return out


def run_split(dev):
    lib, labels = split.build_timed(STAGES, "bf16", source="backbone_bf16.cu")
    with torch.inference_mode():
        args = inputs(dev)
        for name, fn in calls(*args):
            ref = fn()
            ms = cs_.time_ms(fn, 10)
            per = kernel_ms(fn, "backbone_bf16_kernel")
            print(f"[split] {name} shipped: {ms:.3f} ms a call (CUDA "
                  f"events); device ms by kernel {json.dumps(per)}",
                  flush=True)
            use(lib)
            stamps = torch.zeros(30000 * 64, dtype=torch.int64, device=dev)
            t = cs_.time_ms(fn, 3, 1)
            assert lib.set_stamps(ctypes.c_void_p(stamps.data_ptr())) == 0
            got = fn()
            torch.cuda.synchronize()
            assert lib.set_stamps(ctypes.c_void_p(0)) == 0
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            print(f"[split] {name} instrumented equals shipped: {same}")
            n = (args[0] if name == "K2" else args[4]).shape[0]
            blocks = -(-n // 8)  # 8 cutouts a block
            split.report(f"bf16-{name}", stamps.reshape(-1, 64)[:blocks],
                         labels, t)
            _build._LOADED.pop(LIB)


# the --phases instrumentation of wgmma_conv.cuh's conv_wg: (old, new)
_T = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"('
PHASES = [
    ("#pragma once\n", "#pragma once\n__device__ unsigned long long g_phase[8];\n"),
    ("  const int n_wg = WGN == 2 ? wg * P::NW : 0;\n",
     "  const int n_wg = WGN == 2 ? wg * P::NW : 0;\n"
     "  unsigned long long t0_, t1_;\n"
     "  constexpr int key_ = CIN == 64 ? (COUT == 64 ? 0 : 1)\n"
     "                                 : (COUT == 128 ? 2 : 3);\n"),
    ("      wgmma_fence();\n      for (int kc = 0;",
     "      " + _T + "t0_));\n      wgmma_fence();\n      for (int kc = 0;"),
    ("      ring.i += P::NKC;\n",
     "      ring.i += P::NKC;\n      " + _T + "t1_));\n"
     "      if (threadIdx.x == 0) atomicAdd(&g_phase[key_], t1_ - t0_);\n"),
    ("        }\n    }\n  }\n}\n\n}  // namespace",
     "        }\n      { unsigned long long t2_; " + _T + "t2_));\n"
     "        if (threadIdx.x == 0) atomicAdd(&g_phase[4 + key_], t2_ - t1_); }"
     "\n    }\n  }\n}\n\n}  // namespace"),
]
PHASE_READ = """
extern "C" int phase_read(unsigned long long* host) {
  static const unsigned long long zero[8] = {};
  cudaMemcpyFromSymbol(host, g_phase, sizeof(zero));
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
"""


def run_phases(dev):
    src = os.path.join(ROOT, "planar_optical_flow_tpu_torch", "csrc")
    d = os.path.join(ROOT, "build", "phases_bf16")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d)
    p = os.path.join(d, "wgmma_conv.cuh")
    t = open(p).read()
    for a, b in PHASES:
        assert t.count(a) == 1, a
        t = t.replace(a, b)
    open(p, "w").write(t)
    cu = os.path.join(d, "backbone_bf16.cu")
    open(cu, "a").write(PHASE_READ)
    out = os.path.join(d, "lib.so")
    res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", out, cu],
                         capture_output=True, text=True)
    print(f"[phases] nvcc rc {res.returncode}", flush=True)
    if res.returncode:
        print(res.stdout[-3000:], res.stderr[-3000:])
        raise SystemExit(1)
    lib = ctypes.CDLL(out)
    host = (ctypes.c_ulonglong * 8)()
    names = ("conv 1 (64 -> 64)", "conv 2 (64 -> 128, pool)",
             "convs 3 and 4 (128 -> 128)", "conv 5 (128 -> 256, pool)")
    with torch.inference_mode():
        args = inputs(dev)
        for name, fn in calls(*args):
            ref = fn()
            use(lib)
            fn()
            torch.cuda.synchronize()
            lib.phase_read(host)
            got = fn()
            torch.cuda.synchronize()
            assert lib.phase_read(host) == 0
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            blocks = -(-(args[0] if name == "K2" else args[4]).shape[0] // 8)
            print(f"[phases] {name}: instrumented equals shipped: {same}; "
                  f"{blocks} blocks", flush=True)
            for k, what in enumerate(names):
                print(f"[phases] {name} {what}: products and their chunk "
                      f"waits {host[k] / blocks / 1e3:.2f} us a block, "
                      f"epilogues {host[4 + k] / blocks / 1e3:.2f} us",
                      flush=True)
            _build._LOADED.pop(LIB)


def run_variants(dev, variants, plans):
    from planar_optical_flow_tpu_torch.ops.kernels import int8_tiles

    src = os.path.join(ROOT, "planar_optical_flow_tpu_torch", "csrc")
    procs = {}
    for name, reps in variants.items():
        d = os.path.join(ROOT, "build", "variants_bf16", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        for f, a, b in reps:
            p = os.path.join(d, f)
            t = open(p).read()
            assert a in t, (name, a)
            open(p, "w").write(t.replace(a, b))
        out = os.path.join(d, "lib.so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", out,
             os.path.join(d, "backbone_bf16.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (p, out) in procs.items():
        log, _ = p.communicate()
        notes = {}
        for line in log.splitlines():
            code = line.partition("(C75")[2][:2]
            if code:
                notes[code] = notes.get(code, 0) + 1
            if ("registers" in line or "spill" in line or "rror" in line) \
                    and "embed" not in line:
                print(f"[{name}] {line.strip()[:200]}")
        print(f"[{name}] nvcc rc {p.returncode}, notes C75xx "
              f"{json.dumps(notes)}", flush=True)
        if p.returncode == 0:
            libs[name] = ctypes.CDLL(out)
    shipped_plan = int8_tiles.BACKBONE_BF16_PLAN
    with torch.inference_mode():
        args = inputs(dev)
        refs = {name: fn() for name, fn in calls(*args)}
        for turn in range(2):
            for name, lib in libs.items():
                int8_tiles.BACKBONE_BF16_PLAN = tuple(
                    tuple(p) for p in plans.get(name, shipped_plan))
                use(lib)
                for what, fn in calls(*args):
                    got = fn()
                    same = all(torch.equal(a, b)
                               for a, b in zip(got, refs[what]))
                    err = max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(got, refs[what]))
                    ms = cs_.time_ms(fn, 10)
                    per = kernel_ms(fn, "backbone_bf16_kernel")
                    print(f"[variant {turn}] {name} {what}: {ms:.3f} ms "
                          f"(device {json.dumps(per)}), equal to shipped: "
                          f"{same} (max abs diff {err:.3e})", flush=True)
                _build._LOADED.pop(LIB)
        int8_tiles.BACKBONE_BF16_PLAN = shipped_plan


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", type=json.loads, default=None)
    ap.add_argument("--plans", type=json.loads, default={})
    ap.add_argument("--phases", action="store_true")
    a = ap.parse_args()
    dev = torch.device("cuda")
    print(f"[card] {cs_.card_line()}", flush=True)
    if a.phases:
        run_phases(dev)
    elif a.variants is None:
        run_split(dev)
    else:
        run_variants(dev, a.variants, a.plans)


if __name__ == "__main__":
    main()
