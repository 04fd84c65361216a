"""Per-stage split of the int8 gate K6 (gate_int8) and the bf16 head K4
(head) on one CUDA card, at the flagship shapes of ``chip_smoke.py``
(B=384, 456 rows a stream, 56 cutout points), with the method of
``torch_int8_split.py``: an instrumented copy of the source in
``build/stage_split/`` where thread 0 of every block writes
``%globaltimer`` after each ``__syncthreads()`` of the kernel functions
named below. The instrumented kernels' outputs are checked against the
shipped ones, and the mean time between stamps is printed per stage.

Run from the repo root: ``python3 experiments/torch_gate_head_split.py``
(the kernels of this tree) or with ``--parent`` in a checkout of the
kernels from before the redesign (K6 on a (stream, D-chunk) grid, K4 on
``nvcuda::wmma``).
"""
import ctypes
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "experiments"))
import chip_smoke as cs_  # noqa: E402
import torch_int8_split as split  # noqa: E402
from planar_optical_flow_tpu_torch.ops.kernels import _build  # noqa: E402

# (library, [(file, function, first stamp, a stamp at the end)])
STAGES = {
    "K6": ("gate", [("gate.cu", "gate_int8_rows_kernel", 0, True)]),
    "K4": ("head_bf16", [("head_bf16.cu", "head_bf16_kernel", 0, True)]),
}
PARENT_STAGES = {
    "K6": ("gate", [("gate.cu", "gate_int8_kernel", 0, True)]),
    "K4": ("conv_stack", [("conv_stack.cu", "head_kernel", 0, True)]),
}


def inputs(dev):
    """K6's and K4's inputs as chip_smoke.py's phase 4 makes them."""
    from planar_optical_flow_tpu_torch.infer.calibration import (
        calibrate_serve_v3,
    )
    from planar_optical_flow_tpu_torch.infer.fast_gate import gate
    from planar_optical_flow_tpu_torch.infer.streaming import int8_weights
    from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs
    from planar_optical_flow_tpu_torch.ops.kernels import fold
    from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout

    model = cs_.build_model(0, dev)
    rng = np.random.default_rng(0)
    scans = torch.tensor(rng.uniform(0.5, 25.0, (2, cs_.BATCH, cs_.NUM_PTS)),
                         dtype=torch.float32, device=dev)
    calib = calibrate_serve_v3(model, cs_.CUTOUT_KW, scans[0][:8],
                               num_pts=cs_.NUM_PTS, device=dev)
    det = model.dr_spaam
    w = int8_weights(det, calib, dev)
    gp = fold.fold_gate_params(det.gate, dtype=torch.bfloat16)
    c, p_pad = 56, 456
    n, d = cs_.BATCH * p_pad, 14 * 256
    ckw = dict(num_cutout_pts=c, window_width=1.0, window_depth=0.5,
               padding_val=29.99, centered=True, area_mode=True, p_valid=450)
    cuts = [cutout(F.pad(s, (0, p_pad - 450)), **ckw) for s in scans]
    f8 = [cs.backbone_int8(ct, w.layer1, w.backbone, w.embed, l=c)
          for ct in cuts]
    tmpl = torch.clamp(torch.round(f8[1][0].float().reshape(n, d)
                                   * (w.feat_scale / w.tmpl_scale)),
                       -127, 127).to(torch.int8)
    k6_args = (f8[0][1], f8[1][1], f8[0][0].reshape(n, d), tmpl)
    k6_kw = dict(ct=p_pad, ct_valid=450, alpha=gp.alpha,
                 window_size=gp.window_size, s_x=w.feat_scale,
                 s_t=w.tmpl_scale, s_out=w.tmpl_scale)
    layer1, tail = fold.backbone_stack_weights(det.backbone)
    bf = [cs.backbone_tail(cs.backbone_layer1(ct, layer1), tail,
                           (gp.w, gp.b), l=c) for ct in cuts]
    t4 = gate(bf[0][1], bf[1][1], bf[0][0].reshape(n, d),
              bf[1][0].reshape(n, d), ct=p_pad, ct_valid=450, alpha=gp.alpha,
              window_size=gp.window_size)[0].reshape(-1, 256)
    conv_w, head_w = fold.head_stack_weights(det.head)
    return k6_args, k6_kw, t4, conv_w, head_w


def main(stages, tag):
    from planar_optical_flow_tpu_torch.infer.fast_gate import gate_int8
    from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs

    dev = torch.device("cuda")
    with torch.inference_mode():
        k6_args, k6_kw, t4, conv_w, head_w = inputs(dev)
        laid = (cs.head_weights_bf16(conv_w)
                if hasattr(cs, "head_weights_bf16") else conv_w)
        fns = {"K6": lambda: gate_int8(*k6_args, **k6_kw),
               "K4": lambda: cs.head(t4, laid, head_w, num_classes=1,
                                     l4=14)}
        for name, fn in fns.items():
            lib_name, funcs = stages[name]
            lib, labels = split.build_timed(funcs, f"{tag}-{name}",
                                            source=f"{lib_name}.cu")
            ref = fn()
            ms = cs_.time_ms(fn, 5)
            print(f"[split-{tag}] shipped {name}: {ms:.4f} ms on "
                  f"{cs_.card_line()}", flush=True)
            shipped = _build._LOADED[lib_name]
            _build._LOADED[lib_name] = lib
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
            st = stamps.reshape(-1, 64)
            used = int((st[:, 0] > 0).sum())
            split.report(f"{tag}-{name}", st[:used], labels, t)
            _build._LOADED[lib_name] = shipped
    print(json.dumps({"split": tag, "done": True}))


if __name__ == "__main__":
    parent = "--parent" in sys.argv[1:]
    main(PARENT_STAGES if parent else STAGES, "parent" if parent else "new")
