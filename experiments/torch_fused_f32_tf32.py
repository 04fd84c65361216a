"""K14 in f32, split bf16 (the shipped ``csrc/fused_f32.cu``) against
3xTF32 (``experiments/fused_f32_tf32.cu``), in one run on one CUDA card, at
the shapes of ``chip_smoke.py``'s phase 4 (B=384 streams x 450 cutouts of
56 points, N = 172,800).

The 3xTF32 source is built against the package's ``csrc/`` headers (one
``nvcc``, the package's flags; its ptxas report is printed), its f32
weights are laid out for its k8 chunks (:func:`tf32_weights`), and its
backbone and head are held against the plain versions at ``chip_smoke``'s
``TOL_K14_F32`` (rtol 1e-3 + atol 1e-4 x max|plain|), each on the same
inputs as the shipped kernels (the head on the shipped backbone's feats).
Both are then timed with CUDA events in turns: shipped, 3xTF32, 3xTF32,
shipped.

Run from the repo root: ``python3 experiments/torch_fused_f32_tf32.py``.
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
from planar_optical_flow_tpu_torch.ops.kernels import fused_drow as fd  # noqa: E402
from planar_optical_flow_tpu_torch.ops.kernels import int8_tiles as it  # noqa: E402
from torch_fused_f32_split import inputs  # noqa: E402

TF32_KC = 8  # K a chunk of the 3xTF32 kernel: one m64nNk8 instruction


def build():
    """Compile ``fused_f32_tf32.cu`` in a copy of ``csrc/`` -> its library."""
    dst = os.path.join(ROOT, "build", "tf32")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "planar_optical_flow_tpu_torch",
                                 "csrc"), dst)
    cu = os.path.join(dst, "fused_f32_tf32.cu")
    shutil.copy(os.path.join(ROOT, "experiments", "fused_f32_tf32.cu"), cu)
    out = os.path.join(dst, "fused_f32_tf32.so")
    res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", out, cu],
                         capture_output=True, text=True)
    print(f"[tf32] nvcc rc {res.returncode}")
    for line in (res.stdout + res.stderr).splitlines():
        if any(s in line for s in ("registers", "spill", "rror", "C75")):
            print(f"[tf32] {line.strip()[:220]}")
    if res.returncode:
        raise RuntimeError("fused_f32_tf32.cu does not build")
    lib = ctypes.CDLL(out)
    for fn, argtypes in (
            (lib.fused_backbone_f32_launch,
             [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
            (lib.fused_head_f32_launch,
             [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p])):
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def tf32_weights(pairs, plan, chans, head):
    """The pointer order of the 3xTF32 launches: each wgmma conv's f32
    ``(Cout, 3*Cin)`` in k8 chunks of its plan, with its bias; the
    backbone's layer 1 first, the head's linears last, as they are."""
    convs = pairs[1:6] if not head else pairs[:5]
    ws, bs = fd._kernel_weights(convs, chans, torch.float32, "tf32")
    out = []
    if not head:
        w1, b1 = fd._kernel_weights(pairs[:1], fd.BACKBONE_CHANNELS[:2],
                                    torch.float32, "tf32")
        out += [w1[0], b1[0]]
    for w, b, (_, _, _, nj, wgn) in zip(ws, bs, plan):
        out += [it.wgmma_weights(w.t().contiguous(), nj, wgn, TF32_KC), b]
    if head:
        for w, b in pairs[5:]:
            out += [w.float().contiguous(), b.float().contiguous()]
    return out


def within(got, ref):
    rtol, atol = cs_.TOL_K14_F32
    return bool(((got - ref).abs() <= rtol * ref.abs()
                 + atol * float(ref.abs().max())).all())


def main():
    lib = build()
    # the plain versions in f32, as chip_smoke.py runs them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    f32 = torch.float32
    stream = _build.stream_ptr(dev)
    with torch.inference_mode():
        cut, w_bb, w_hd = inputs(dev)
        n, length = cut.shape
        tb = tf32_weights(w_bb.pairs, it.FUSED_BACKBONE_F32_PLAN,
                          fd.BACKBONE_CHANNELS[1:], False)
        th = tf32_weights(w_hd.pairs, it.FUSED_HEAD_F32_PLAN,
                          fd.HEAD_CHANNELS, True)
        pb = fd._ptr_array(tb, cut.device)
        ph = fd._ptr_array(th, cut.device)
        feats = fd.fused_backbone(cut, w_bb, compute_dtype=f32)
        l4 = feats.shape[1]
        fb = torch.empty_like(feats)
        cls = torch.empty(n, 1, dtype=f32, device=dev)
        reg = torch.empty(n, 2, dtype=f32, device=dev)

        def tf32_backbone():
            _build.check(lib.fused_backbone_f32_launch(
                cut.data_ptr(), pb, fb.data_ptr(), n, length, stream),
                "tf32 backbone")
            return (fb,)

        def tf32_head():
            _build.check(lib.fused_head_f32_launch(
                feats.data_ptr(), ph, *ph[10:], cls.data_ptr(),
                reg.data_ptr(), n, l4, 1, stream), "tf32 head")
            return cls, reg

        fns = {
            "backbone": {
                "shipped": lambda: (fd.fused_backbone(cut, w_bb,
                                                      compute_dtype=f32),),
                "3xtf32": tf32_backbone},
            "head": {
                "shipped": lambda: fd.fused_head(feats, w_hd,
                                                 compute_dtype=f32),
                "3xtf32": tf32_head}}
        refs = {"backbone": (fd.fused_backbone_plain(cut, w_bb.pairs,
                                                     compute_dtype=f32),),
                "head": fd.fused_head_plain(feats, w_hd.pairs,
                                            compute_dtype=f32)}
        ok = True
        for stack, by_route in fns.items():
            for route, fn in by_route.items():
                got = [g.clone() for g in fn()]
                torch.cuda.synchronize()
                errs = [cs_.max_err(g, r) for g, r in zip(got, refs[stack])]
                good = all(within(g, r) for g, r in zip(got, refs[stack]))
                ok &= good
                print(f"[tf32] {stack} {route}: max_abs_err={max(errs):.3e} "
                      f"within TOL_K14_F32: {good}", flush=True)
        times = {s: {r: [] for r in by} for s, by in fns.items()}
        for route in ("shipped", "3xtf32", "3xtf32", "shipped"):
            for stack, by_route in fns.items():
                times[stack][route].append(
                    cs_.time_ms(by_route[route], cs_.F32_ITERS))
        card = cs_.card_line()
        for stack, by_route in times.items():
            for route, ts in by_route.items():
                print(f"[tf32] {stack} {route}: "
                      f"{json.dumps([round(t, 4) for t in ts])} ms on {card}")
    print(json.dumps({"tf32": "done", "ok": ok}))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
