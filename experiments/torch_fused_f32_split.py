"""Per-stage split of K14 in f32, the fused backbone and head that
``make_fused_stream_step`` runs by default (``fused_backbone`` and
``fused_head`` with ``compute_dtype`` f32), on one CUDA card, at the shapes
of ``chip_smoke.py``'s phase 4 (B=384 streams x 450 cutouts of 56 points,
N = 172,800), with the method of ``torch_int8_split.py``: an instrumented
copy of the source in ``build/stage_split/`` where thread 0 of every block
writes ``%globaltimer`` after each ``__syncthreads()`` of the kernels named
below. The instrumented kernels' outputs are checked against the shipped
ones, and the mean time between stamps is printed per stage (the load,
each conv, the mean and cls/reg), in us a block.

Run from the repo root: ``python3 experiments/torch_fused_f32_split.py``
(the split-bf16 wgmma kernels of ``csrc/fused_f32.cu``) or, in a checkout of
the kernels from before them, with ``--parent`` (the FFMA kernels of
``csrc/fused_drow.cu``).
"""
import ctypes
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "experiments"))
import chip_smoke as cs_  # noqa: E402
import torch_int8_split as split  # noqa: E402
from planar_optical_flow_tpu_torch.ops.kernels import _build  # noqa: E402

# (library, [(file, function, first stamp, a stamp at the end)])
STAGES = {
    "backbone": ("fused_f32",
                 [("fused_f32.cu", "backbone_x3_kernel", 0, True)]),
    "head": ("fused_f32", [("fused_f32.cu", "head_x3_kernel", 0, True)]),
}
PARENT_STAGES = {
    "backbone": ("fused_drow",
                 [("fused_drow.cu", "backbone_f32_kernel", 0, True)]),
    "head": ("fused_drow", [("fused_drow.cu", "head_f32_kernel", 0, True)]),
}


def inputs(dev):
    """The module cutouts of one sanitized scan batch and the f32 weights,
    as chip_smoke.py's phase 4 makes them (laid out once where this tree
    can)."""
    from planar_optical_flow_tpu_torch.infer.streaming import (
        _encode_single, _sanitize_scan,
    )
    from planar_optical_flow_tpu_torch.ops.geometry import get_laser_phi
    from planar_optical_flow_tpu_torch.ops.kernels import fused_drow as fd

    model = cs_.build_model(0, dev)
    rng = np.random.default_rng(0)
    scans = torch.tensor(rng.uniform(0.5, 25.0, (1, cs_.BATCH, cs_.NUM_PTS)),
                         dtype=torch.float32, device=dev)
    det = model.dr_spaam
    c = cs_.CUTOUT_KW["num_cutout_pts"]
    cut = _encode_single(_sanitize_scan(scans[0],
                                        cs_.CUTOUT_KW["padding_val"]),
                         get_laser_phi(num_pts=cs_.NUM_PTS),
                         cs_.CUTOUT_KW).reshape(-1, c)
    w_bb, w_hd = fd.backbone_weights(det.backbone), fd.head_weights(det.head)
    if hasattr(fd, "backbone_weights_f32"):
        w_bb, w_hd = fd.backbone_weights_f32(w_bb), fd.head_weights_f32(w_hd)
    return cut, w_bb, w_hd


def main(stages, tag):
    from planar_optical_flow_tpu_torch.ops.kernels import fused_drow as fd

    dev = torch.device("cuda")
    f32 = torch.float32
    with torch.inference_mode():
        cut, w_bb, w_hd = inputs(dev)
        feats = fd.fused_backbone(cut, w_bb, compute_dtype=f32)
        fns = {"backbone": lambda: (fd.fused_backbone(cut, w_bb,
                                                      compute_dtype=f32),),
               "head": lambda: fd.fused_head(feats, w_hd, compute_dtype=f32)}
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
