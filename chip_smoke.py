#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

Drives the port's main path, streaming FlowDROW serving on the bf16 ``v3``
engine, at the flagship working point (window 11, 56 cutout points, area
mode, 450 beams, B=384 streams) with random weights made from ``--seed``.

Phases:
1. the card's name and power limit, CUDA version and capability; TF32 off
   for the f32 reference;
2. build every kernel from ``planar_optical_flow_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel), with the ``-Xptxas -v`` report;
3. the model, from a seeded ``torch.Generator``, with seeded BN stats;
4. each kernel (K1 cutout, K2 backbone tail, K3 gate, K4 head) at the
   flagship shapes against its plain PyTorch version on the same inputs,
   then timed with CUDA events beside the plain version;
5. the slice: ``StreamingRunner(engine="v3")`` for 1 bootstrap + 5
   carried steps with one per-stream reset, every launch counter set to 0
   just before and read just after; outputs finite, of the expected shape
   and within the JAX package's bf16-vs-f32 tolerance of
   ``engine="module"`` on the same scans;
6. the kernels line, the card line and the result line.

Any failed check raises: the script then exits non-zero and prints no
result line. Run: ``python3 chip_smoke.py`` (needs one CUDA card).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import time

import numpy as np

H100_BF16_FLOPS = 989e12   # dense tensor-core peak (NVIDIA data sheet)
H100_F32_FLOPS = 67e12     # f32 outside the tensor cores
H100_HBM_BYTES = 3.35e12   # HBM3 bytes/s
CUTOUT_KW = dict(fixed=True, centered=True, window_width=1.0,
                 window_depth=0.5, num_cutout_pts=56, padding_val=29.99,
                 area_mode=True, gather_mode="matmul")
NUM_PTS = 450
WINDOW = 11
BATCH = 384             # streams (bench.py's working point)
STEPS = 6               # 1 bootstrap + 5 carried
TIMED_ITERS = 20        # launches per kernel timing
TOL_CUTOUT = 2e-3       # absolute (tests/test_cutout_kernel.py)
TOL_BF16 = 2e-2         # x max|plain| (tests/test_fast_gate.py)
SOURCES = {
    "cutout": ("planar_optical_flow_tpu_torch/csrc/cutout.cu",
               "planar_optical_flow_tpu/ops/pallas/cutout_kernel.py:159"),
    "backbone_tail": ("planar_optical_flow_tpu_torch/csrc/conv_stack.cu",
                      "planar_optical_flow_tpu/ops/pallas/conv_stack.py:302"),
    "gate": ("planar_optical_flow_tpu_torch/csrc/gate.cu",
             "planar_optical_flow_tpu/infer/fast_gate.py:274"),
    "head": ("planar_optical_flow_tpu_torch/csrc/conv_stack.cu",
             "planar_optical_flow_tpu/ops/pallas/conv_stack.py:340"),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"FAIL: {msg}")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, ref):
    return float((got.float() - ref.float()).abs().max())


def bound(flops, flop_rate, nbytes):
    t_ops = flops / flop_rate * 1e3
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def build_model(seed, device):
    import torch

    from planar_optical_flow_tpu_torch.models import FlowDrow

    gen = torch.Generator().manual_seed(seed)
    model = FlowDrow(window_size=WINDOW, pedestrian_only=True,
                     num_cutout_pts=CUTOUT_KW["num_cutout_pts"],
                     generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return model.to(device).eval()


def cutout_ops(scan_p, c, p_valid):
    """f32 operations K1 needs on these scans: ~20 per tap for the index
    math, lerp, clip and centering, plus one add per beam of each area-mode
    band (data-dependent)."""
    import torch

    from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import (
        _tap_indices,
    )

    b, p = scan_p.shape
    ha = torch.atan(0.5 * CUTOUT_KW["window_width"]
                    / torch.clamp(scan_p, min=1e-2))
    inds = _tap_indices(p, c, ha, math.radians(0.5))
    span = inds[..., -1:] - inds[..., :1]
    tap_w = span / (c - 1)
    a_lo = torch.round(torch.clamp(inds - 0.5 * tap_w, 0, p_valid - 1))
    a_hi = torch.maximum(torch.round(torch.clamp(inds + 0.5 * tap_w, 0,
                                                 p_valid - 1)), a_lo)
    band = torch.where(span > c, a_hi - a_lo + 1, torch.zeros_like(a_lo))
    return 20.0 * b * p * c + float(band.sum())


def kernel_phase(model, scans, device, iters):
    """Phase 4: each kernel against its plain version, and timed."""
    import torch
    import torch.nn.functional as F

    from planar_optical_flow_tpu_torch.infer.fast_gate import gate, gate_plain
    from planar_optical_flow_tpu_torch.ops.kernels import fold
    from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
        backbone_layer1, backbone_tail, backbone_tail_plain, head, head_plain,
    )
    from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import (
        cutout, cutout_plain,
    )

    det = model.dr_spaam
    b = scans.shape[1]
    c = CUTOUT_KW["num_cutout_pts"]
    l4 = c // 4
    p_pad = -(-NUM_PTS // 8) * 8
    n = b * p_pad
    d = l4 * 256
    ckw = dict(num_cutout_pts=c, window_width=CUTOUT_KW["window_width"],
               window_depth=CUTOUT_KW["window_depth"],
               padding_val=CUTOUT_KW["padding_val"], centered=True,
               area_mode=True, p_valid=NUM_PTS)
    layer1, tail = fold.backbone_stack_weights(det.backbone)
    conv_w, head_w = fold.head_stack_weights(det.head)
    gp = fold.fold_gate_params(det.gate, dtype=torch.bfloat16)
    results = {}

    def record(name, pairs, rel, ms, plain_ms, bound_pair):
        """``pairs``: (kernel, plain) outputs. ``rel`` None: absolute
        tolerance TOL_CUTOUT; else each output within rel * max|plain|."""
        errs = [max_err(g, r) for g, r in pairs]
        lims = [TOL_CUTOUT if rel is None
                else rel * max(float(r.float().abs().max()), 1e-6)
                for _, r in pairs]
        ok = all(e <= lim for e, lim in zip(errs, lims))
        print(f"[kernel] {name}: max_abs_err={max(errs):.3e} "
              f"limits={[float(f'{lim:.3e}') for lim in lims]} "
              f"ms={ms:.4f} plain_ms={plain_ms:.3f} "
              f"bound_ms={bound_pair[0]:.4f} ({bound_pair[1]}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        check(ok, f"{name} kernel disagrees with its plain version")
        results[name] = dict(max_abs_err=max(errs), ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_pair[0],
                             bound_by=bound_pair[1])

    with torch.inference_mode():
        # K1
        scan_p = F.pad(scans[0], (0, p_pad - NUM_PTS))
        got = cutout(scan_p, **ckw)
        torch.cuda.synchronize()
        ref = cutout_plain(scan_p, **ckw)
        record("cutout", [(got, ref)], None,
               time_ms(lambda: cutout(scan_p, **ckw), iters),
               time_ms(lambda: cutout_plain(scan_p, **ckw), 3, 1),
               bound(cutout_ops(scan_p, c, NUM_PTS), H100_F32_FLOPS,
                     4.0 * n + 4.0 * n * c))

        # K2 on this scan's layer-1 activation
        act1 = backbone_layer1(got, layer1)
        feats, zx = backbone_tail(act1, tail, (gp.w, gp.b), l=c)
        torch.cuda.synchronize()
        feats_p, zx_p = backbone_tail_plain(act1, tail, (gp.w, gp.b), l=c)
        flops2 = 2.0 * n * (c * 3 * (64 * 64 + 64 * 128)
                            + (c // 2) * 3 * (2 * 128 * 128 + 128 * 256)
                            + d * 128)
        bytes2 = (n * c * 64 * 2 + n * d * 2 + n * 128 * 2
                  + sum(w.numel() * 2 + bb.numel() * 4 for w, bb in tail)
                  + gp.w.numel() * 2)
        record("backbone_tail", [(feats, feats_p), (zx, zx_p)], TOL_BF16,
               time_ms(lambda: backbone_tail(act1, tail, (gp.w, gp.b), l=c),
                       iters),
               time_ms(lambda: backbone_tail_plain(act1, tail, (gp.w, gp.b),
                                                   l=c), 3, 1),
               bound(flops2, H100_BF16_FLOPS, bytes2))
        del feats_p, zx_p

        # K3, carried: a second scan's features as the template
        feats2, zx2 = backbone_tail(
            backbone_layer1(cutout(F.pad(scans[1], (0, p_pad - NUM_PTS)),
                                   **ckw), layer1),
            tail, (gp.w, gp.b), l=c)
        x, t = feats.reshape(n, d), feats2.reshape(n, d)
        gkw = dict(ct=p_pad, ct_valid=NUM_PTS, alpha=gp.alpha,
                   window_size=gp.window_size)
        got3 = gate(zx, zx2, x, t, **gkw)
        torch.cuda.synchronize()
        ref3 = gate_plain(zx, zx2, x, t, **gkw)
        hw = WINDOW // 2
        valid_pairs = sum(min(i + hw, NUM_PTS - 1) - max(i - hw, 0) + 1
                          for i in range(NUM_PTS)) * b
        flops3 = 2.0 * valid_pairs * (d + 2 * 128) + 3.0 * n * d
        bytes3 = 3.0 * n * d * 2 + 3.0 * n * 128 * 2 + n * WINDOW * 4
        record("gate", list(zip(got3, ref3)), TOL_BF16,
               time_ms(lambda: gate(zx, zx2, x, t, **gkw), iters),
               time_ms(lambda: gate_plain(zx, zx2, x, t, **gkw), 3, 1),
               bound(flops3, H100_F32_FLOPS, bytes3))
        del ref3

        # K4 on the gate's new template
        tmpl = got3[0].reshape(-1, 256)
        cls, reg = head(tmpl, conv_w, head_w, num_classes=1, l4=l4)
        torch.cuda.synchronize()
        cls_p, reg_p = head_plain(tmpl, conv_w, head_w, l4=l4)
        flops4 = 2.0 * n * (l4 * 3 * (256 * 256 * 2 + 256 * 512)
                            + (l4 // 2) * 3 * (512 * 256 + 256 * 128)
                            + 128 * 3)
        bytes4 = (n * d * 2 + n * 3 * 4
                  + sum(w.numel() * 2 + bb.numel() * 4 for w, bb in conv_w))
        record("head", [(cls, cls_p), (reg, reg_p)], TOL_BF16,
               time_ms(lambda: head(tmpl, conv_w, head_w, num_classes=1,
                                    l4=l4), iters),
               time_ms(lambda: head_plain(tmpl, conv_w, head_w, l4=l4), 3, 1),
               bound(flops4, H100_BF16_FLOPS, bytes4))
    return results


def compare_engines(got, ref, step):
    """The JAX package's bf16-vs-f32 tolerance (tests/test_fast_gate.py):
    correlation > 0.99 and max|v3 - module| < 0.15 * max(|module|, 1)."""
    import torch

    for k in ("pred_cls", "pred_reg", "pred_flow"):
        a, r = got[k].float(), ref[k].float()
        check(a.shape == r.shape, f"step {step} {k} shape {tuple(a.shape)}")
        check(bool(torch.isfinite(a).all()), f"step {step} {k} not finite")
        corr = float(torch.corrcoef(torch.stack([a.ravel(), r.ravel()]))[0, 1])
        diff = float((a - r).abs().max())
        lim = 0.15 * max(float(r.abs().max()), 1.0)
        print(f"[slice] step {step} {k}: corr={corr:.5f} "
              f"max_diff={diff:.4g} lim={lim:.4g}", flush=True)
        check(corr > 0.99 and diff < lim,
              f"step {step} {k}: v3 vs module corr {corr} diff {diff}")


def slice_phase(model, scans, device, reset_step, reset_stream):
    """Phase 5: the v3 runner against the module runner."""
    import torch

    from planar_optical_flow_tpu_torch.infer.fast_gate import gate
    from planar_optical_flow_tpu_torch.infer.streaming import StreamingRunner
    from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
        backbone_tail, head,
    )
    from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout

    wrappers = {"cutout": cutout, "backbone_tail": backbone_tail,
                "gate": gate, "head": head}
    b = scans.shape[1]
    v3 = StreamingRunner(model, CUTOUT_KW, num_pts=NUM_PTS, engine="v3",
                         device=device)
    ref = StreamingRunner(model, CUTOUT_KW, num_pts=NUM_PTS,
                          engine="module", device=device)
    for w in wrappers.values():
        w.launches = 0
    step_ms, outs = [], []
    for i, scan in enumerate(scans):
        if i == reset_step:
            v3.reset(streams=[reset_stream])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = v3(scan)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[slice] launches during the v3 run: {json.dumps(launches)}")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")

    for i, scan in enumerate(scans):
        if i == reset_step:
            ref.reset(streams=[reset_stream])
        r = ref(scan)
        out = outs[i]
        check(tuple(out["pred_flow"].shape) == (b, NUM_PTS, 2),
              f"pred_flow shape {tuple(out['pred_flow'].shape)}")
        check(tuple(out["det_keep"].shape) == (b, 64), "det_keep shape")
        compare_engines(out, r, i)
    carried = step_ms[1:]
    return launches, step_ms, float(np.median(carried))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, BN statistics and scans")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from planar_optical_flow_tpu_torch.ops.kernels import _build

    device = torch.device("cuda")
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, capability "
          f"{torch.cuda.get_device_capability(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s for "
          f"{sorted(report)}", flush=True)
    for name, rep in sorted(report.items()):
        for line in rep["log"].splitlines():
            if any(s in line for s in ("Compiling entry", "registers",
                                       "spill")):
                print(f"[ptxas {name}] {line.strip()}")

    p_pad = -(-NUM_PTS // 8) * 8
    c = CUTOUT_KW["num_cutout_pts"]
    for lib, fn, arg in (("cutout", "cutout_smem_bytes", (p_pad,)),
                         ("conv_stack", "backbone_tail_smem_bytes", (c,)),
                         ("gate", "gate_smem_bytes", (p_pad, WINDOW)),
                         ("conv_stack", "head_smem_bytes", (c // 4,))):
        f = getattr(_build.load(lib), fn)
        f.restype = ctypes.c_longlong
        f.argtypes = [ctypes.c_int] * len(arg)
        print(f"[smem] {fn[:-len('_smem_bytes')]}: {f(*arg)} bytes of "
              "dynamic shared memory per block")

    model = build_model(args.seed, device)
    rng = np.random.default_rng(args.seed)
    scans = torch.tensor(rng.uniform(0.5, 25.0, (STEPS, BATCH, NUM_PTS)),
                         dtype=torch.float32, device=device)
    scans[2, 3, 17] = float("nan")  # the sanitize guard on the main path

    results = kernel_phase(model, scans, device, TIMED_ITERS)
    torch.cuda.empty_cache()
    launches, step_ms, carried_ms = slice_phase(
        model, scans, device, reset_step=3, reset_stream=BATCH // 2)
    print(f"[slice] B={BATCH} step_ms="
          f"{json.dumps([round(s, 3) for s in step_ms])} carried median "
          f"{carried_ms:.3f} ms = {BATCH / carried_ms * 1e3:.1f} scans/s on "
          f"{card}", flush=True)

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
