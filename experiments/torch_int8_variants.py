"""Same-call timing of source variants of the int8c kernels K5
(backbone_int8) and K7 (head_int8) on one CUDA card, at the flagship shapes
of ``chip_smoke.py`` (B=384, 456 rows a stream, 56 cutout points).

Each variant is a copy of ``planar_optical_flow_tpu_torch/csrc`` in
``build/variants/<name>/`` with text replacements (``[file, old, new]``) or
whole files swapped in (``[file, "__file__", path in the repo]``); all are
built in parallel, loaded in place of the shipped library one after the
other, checked against the plain versions and timed with CUDA events. A
second JSON argument can swap int8_tiles' plans or layout function for a
variant (``{name: {"BACKBONE_PLAN": ..., "HEAD_PLAN": ...,
"LAYOUT_FROM": path}}``). Comparing versions in one call keeps the card
and its neighbours the same.

Run from the repo root, e.g.
``python3 experiments/torch_int8_variants.py '{"shipped": []}'``.
"""
import ctypes, json, os, shutil, subprocess, sys, time
import numpy as np, torch
import torch.nn.functional as F
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs_
from planar_optical_flow_tpu_torch.ops.kernels import _build

VARIANTS = json.loads(sys.argv[1])  # {name: [[file, old, new], ...]}
PY = json.loads(sys.argv[2]) if len(sys.argv) > 2 else {}  # {name: {attr: plan}}
src = os.path.join(ROOT, "planar_optical_flow_tpu_torch", "csrc")
procs = {}
for name, reps in VARIANTS.items():
    d = os.path.join(ROOT, "build", "variants", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d)
    for f, a, b in reps:
        p = os.path.join(d, f)
        if a == "__file__":  # replace the whole file
            shutil.copy(os.path.join(ROOT, b), p)
            continue
        t = open(p).read()
        assert a in t, (name, a)
        open(p, "w").write(t.replace(a, b))
    out = os.path.join(d, "lib.so")
    procs[name] = (subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", out,
                                     os.path.join(d, "conv_stack_int8.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
libs = {}
for name, (p, out) in procs.items():
    log, _ = p.communicate()
    print(f"[{name}] nvcc rc {p.returncode}")
    for line in log.splitlines():
        if any(s in line for s in ("registers", "spill", "C75", "rror")) and "embed" not in line:
            print(f"[{name}] {line.strip()[:200]}")
    if p.returncode == 0:
        libs[name] = ctypes.CDLL(out)

from planar_optical_flow_tpu_torch.infer.calibration import calibrate_serve_v3
from planar_optical_flow_tpu_torch.infer.streaming import int8_weights
from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs, fold
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout
dev = torch.device("cuda")
model = cs_.build_model(0, dev)
rng = np.random.default_rng(0)
scans = torch.tensor(rng.uniform(0.5, 25.0, (2, cs_.BATCH, cs_.NUM_PTS)), dtype=torch.float32, device=dev)
calib = calibrate_serve_v3(model, cs_.CUTOUT_KW, scans[0][:8], num_pts=cs_.NUM_PTS, device=dev)
det = model.dr_spaam
w = int8_weights(det, calib, dev)
head_w = fold.head_linear_weights(det.head)
c = 56
ckw = dict(num_cutout_pts=c, window_width=1.0, window_depth=0.5, padding_val=29.99,
           centered=True, area_mode=True, p_valid=450)
with torch.inference_mode():
    flat = cutout(F.pad(scans[0], (0, 6)), **ckw)
    ref5 = cs.backbone_int8_plain(flat, w.layer1, w.backbone, w.embed, l=c)
    t7 = ref5[0].to(dev).reshape(-1, 256)
    ref7 = cs.head_int8_plain(t7, w.head, head_w, l4=c // 4)
    from planar_optical_flow_tpu_torch.ops.kernels import int8_tiles
    saved = {k: getattr(int8_tiles, k) for k in ("BACKBONE_PLAN", "HEAD_PLAN")}
    saved_layout = int8_tiles.wgmma_weights
    for name, lib in libs.items():
        _build._LOADED["conv_stack_int8"] = lib
        cs._wg_inputs.checked = False
        for k, v in saved.items():
            setattr(int8_tiles, k, tuple(tuple(x) for x in PY.get(name, {}).get(k, v)))
        int8_tiles.wgmma_weights = saved_layout
        if "LAYOUT_FROM" in PY.get(name, {}):
            import importlib.util
            spec = importlib.util.spec_from_file_location("lay", os.path.join(ROOT, PY[name]["LAYOUT_FROM"]))
            lay = importlib.util.module_from_spec(spec); spec.loader.exec_module(lay)
            int8_tiles.wgmma_weights = lay.wgmma_weights
        try:
            g5 = cs.backbone_int8(flat, w.layer1, w.backbone, w.embed, l=c)
            g7 = cs.head_int8(t7, w.head, head_w, num_classes=1, l4=c // 4)
            torch.cuda.synchronize()
        except Exception as e:
            print(f"[{name}] FAILED {e}")
            continue
        d5 = (g5[0].int() - ref5[0].int()).abs()
        ok5 = int(d5.max()) <= 1 and float((d5 > 0).float().mean()) < 5e-3
        e7 = max(float((g7[k] - ref7[k]).abs().max()) for k in range(2))
        ms5 = cs_.time_ms(lambda: cs.backbone_int8(flat, w.layer1, w.backbone, w.embed, l=c), 10)
        ms7 = cs_.time_ms(lambda: cs.head_int8(t7, w.head, head_w, num_classes=1, l4=c // 4), 10)
        print(f"[{name}] K5 {ms5:.3f} ms (feats ok {ok5}, zx err {float((g5[1].float()-ref5[1].float()).abs().max()):.3e}) "
              f"K7 {ms7:.3f} ms (err {e7:.3e}) on {cs_.card_line()}", flush=True)
    _build._LOADED.pop("conv_stack_int8", None)
