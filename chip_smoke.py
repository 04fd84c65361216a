#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

Drives the port's main paths, streaming FlowDROW serving on the int8c
engine (the JAX package's serving default) and on the bf16 ``v3`` engine,
at the flagship working point (window 11, 56 cutout points, area mode, 450
beams, B=384 streams) with random weights made from ``--seed``.

Phases:
1. the card's name and power limit, CUDA version and capability; TF32 off
   for the f32 reference;
2. build every kernel from ``planar_optical_flow_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel), with the ``-Xptxas -v`` report and
   each kernel's dynamic shared memory;
3. the model, from a seeded ``torch.Generator``, with seeded BN stats, and
   the int8 calibration on ``scans[0][:8]`` (as ``bench.py`` calibrates);
4. each kernel at the flagship shapes against its plain PyTorch version on
   the same inputs, then timed with CUDA events beside the plain version:
   K1 cutout, K2 backbone tail, K3 gate, K4 head (bf16: within 2e-2 x
   max|plain|), then K5 int8 backbone, K6 int8 gate, K7 int8 head (int8
   outputs within 1 LSB with under 5e-3 of them off by one, float outputs
   within 2e-2 x max|plain|);
5. the slices, each for 1 bootstrap + 5 carried steps with one per-stream
   reset, every launch counter set to 0 just before and read just after:
   ``StreamingRunner(engine="v3")`` (K1-K4 launched) within the JAX
   package's bf16-vs-f32 tolerance of ``engine="module"`` on the same
   scans, and ``StreamingRunner(engine="int8c")`` (K1, K5-K7 launched, K2-K4
   not) at the JAX int8c-vs-f32 bar (corr > 0.95 on cls and flow); a
   second int8c runner built from the saved ``calibration.json`` gives
   bit-identical carries for two steps;
6. the kernels line, the card line and the result line.

Any failed check raises: the script then exits non-zero and prints no
result line. Run: ``python3 chip_smoke.py`` (needs one CUDA card).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

H100_BF16_FLOPS = 989e12   # dense tensor-core peak (NVIDIA data sheet)
H100_INT8_OPS = 1979e12    # dense int8 tensor-core peak
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
TOL_INT8_SHARE = 5e-3   # int8 off by one LSB (tests/test_fast_gate.py)
CORR_INT8 = 0.95        # int8c vs module (tests/test_fast_gate.py)
CALIB_SCANS = 8         # calibration batch (bench.py:65)
# the restore check's calibration.json (listed in .gitignore)
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke")
SOURCES = {
    "cutout": ("planar_optical_flow_tpu_torch/csrc/cutout.cu",
               "planar_optical_flow_tpu/ops/pallas/cutout_kernel.py:159"),
    "backbone_tail": ("planar_optical_flow_tpu_torch/csrc/conv_stack.cu",
                      "planar_optical_flow_tpu/ops/pallas/conv_stack.py:302"),
    "gate": ("planar_optical_flow_tpu_torch/csrc/gate.cu",
             "planar_optical_flow_tpu/infer/fast_gate.py:274"),
    "head": ("planar_optical_flow_tpu_torch/csrc/conv_stack.cu",
             "planar_optical_flow_tpu/ops/pallas/conv_stack.py:340"),
    "backbone_int8": ("planar_optical_flow_tpu_torch/csrc/conv_stack_int8.cu",
                      "planar_optical_flow_tpu/ops/pallas/conv_stack.py:1102"),
    "gate_int8": ("planar_optical_flow_tpu_torch/csrc/gate.cu",
                  "planar_optical_flow_tpu/infer/fast_gate.py:679"),
    "head_int8": ("planar_optical_flow_tpu_torch/csrc/conv_stack_int8.cu",
                  "planar_optical_flow_tpu/ops/pallas/conv_stack.py:1277"),
}
V3_KERNELS = ("cutout", "backbone_tail", "gate", "head")
INT8C_KERNELS = ("cutout", "backbone_int8", "gate_int8", "head_int8")


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
    """``flops`` at ``flop_rate``, or a list of (operations, rate) pairs
    run one after the other, against ``nbytes`` at the HBM rate."""
    mix = flops if isinstance(flops, list) else [(flops, flop_rate)]
    t_ops = sum(n / rate for n, rate in mix) * 1e3
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def wrappers():
    """Every kernel wrapper by name (each carries a ``launches`` count)."""
    from planar_optical_flow_tpu_torch.infer.fast_gate import gate, gate_int8
    from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
        backbone_int8, backbone_tail, head, head_int8,
    )
    from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout

    return {"cutout": cutout, "backbone_tail": backbone_tail, "gate": gate,
            "head": head, "backbone_int8": backbone_int8,
            "gate_int8": gate_int8, "head_int8": head_int8}


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


def int8_kernel_phase(model, scans, calib, device, iters):
    """Phase 4, int8c: K5-K7 against their plain versions at the flagship
    shapes, on the scales of ``calib``, and timed."""
    import torch
    import torch.nn.functional as F

    from planar_optical_flow_tpu_torch.infer.fast_gate import (
        gate_int8, gate_int8_plain,
    )
    from planar_optical_flow_tpu_torch.infer.streaming import int8c_weights
    from planar_optical_flow_tpu_torch.ops.kernels import fold
    from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
        backbone_int8, backbone_int8_plain, head_int8, head_int8_plain,
    )
    from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout

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
    w = int8c_weights(det, calib, device)
    head_w = fold.head_linear_weights(det.head)
    gp = fold.fold_gate_params(det.gate)
    results = {}

    def record(name, int8_pairs, float_pairs, ms, plain_ms, bound_pair):
        """int8 outputs within 1 LSB with under TOL_INT8_SHARE of them off
        by one; float outputs within TOL_BF16 * max|plain|."""
        errs, ok, notes = [], True, []
        for g, r in int8_pairs:
            diff = (g.int() - r.int()).abs()
            share = float((diff > 0).float().mean())
            errs.append(float(diff.max()))
            ok &= errs[-1] <= 1 and share < TOL_INT8_SHARE
            notes.append(f"int8 max={errs[-1]:.0f} share={share:.3e}")
        for g, r in float_pairs:
            errs.append(max_err(g, r))
            lim = TOL_BF16 * max(float(r.float().abs().max()), 1e-6)
            ok &= errs[-1] <= lim
            notes.append(f"err={errs[-1]:.3e} lim={lim:.3e}")
        print(f"[kernel] {name}: {'; '.join(notes)} ms={ms:.4f} "
              f"plain_ms={plain_ms:.3f} bound_ms={bound_pair[0]:.4f} "
              f"({bound_pair[1]}) {'ok' if ok else 'MISMATCH'}", flush=True)
        check(ok, f"{name} kernel disagrees with its plain version")
        results[name] = dict(max_abs_err=max(errs), ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_pair[0],
                             bound_by=bound_pair[1])

    def feats_of(scan):
        flat = cutout(F.pad(scan, (0, p_pad - NUM_PTS)), **ckw)
        return flat, backbone_int8(flat, w.layer1, w.backbone, w.embed, l=c)

    with torch.inference_mode():
        # K5 on the cutouts of scan 0
        flat, (feats, zx) = feats_of(scans[0])
        k5 = (flat, w.layer1, w.backbone, w.embed)
        torch.cuda.synchronize()
        feats_p, zx_p = backbone_int8_plain(*k5, l=c)
        conv5 = 2.0 * (c * 3 * (64 * 64 + 64 * 128)
                       + (c // 2) * 3 * (2 * 128 * 128 + 128 * 256))
        bytes5 = (n * c * 4 + n * d + n * 128 * 2 + w.embed[0].numel() * 2
                  + sum(t.numel() * t.element_size()
                        for layer in w.backbone for t in layer))
        record("backbone_int8", [(feats, feats_p)], [(zx, zx_p)],
               time_ms(lambda: backbone_int8(*k5, l=c), iters),
               time_ms(lambda: backbone_int8_plain(*k5, l=c), 3, 1),
               bound([(n * conv5, H100_INT8_OPS),
                      (n * 2.0 * d * 128, H100_BF16_FLOPS),
                      (n * c * 64 * 7.0, H100_F32_FLOPS)], None, bytes5))
        del feats_p, zx_p

        # K6, carried: scan 1's features, rescaled to the carry scale as
        # the bootstrap does, as the template
        _, (feats2, zx2) = feats_of(scans[1])
        tmpl = torch.clamp(torch.round(feats2.float().reshape(n, d)
                                       * (w.feat_scale / w.tmpl_scale)),
                           -127, 127).to(torch.int8)
        x = feats.reshape(n, d)
        gkw = dict(ct=p_pad, ct_valid=NUM_PTS, alpha=gp.alpha,
                   window_size=gp.window_size, s_x=w.feat_scale,
                   s_t=w.tmpl_scale, s_out=w.tmpl_scale)
        got6 = gate_int8(zx, zx2, x, tmpl, **gkw)
        torch.cuda.synchronize()
        ref6 = gate_int8_plain(zx, zx2, x, tmpl, **gkw)
        hw = WINDOW // 2
        valid_pairs = sum(min(i + hw, NUM_PTS - 1) - max(i - hw, 0) + 1
                          for i in range(NUM_PTS)) * b
        ops6 = 2.0 * valid_pairs * (d + 2 * 128) + 5.0 * n * d
        bytes6 = 3.0 * n * d + 3.0 * n * 128 * 2 + n * WINDOW * 4
        record("gate_int8", [(got6[0], ref6[0])], list(zip(got6[1:],
                                                          ref6[1:])),
               time_ms(lambda: gate_int8(zx, zx2, x, tmpl, **gkw), iters),
               time_ms(lambda: gate_int8_plain(zx, zx2, x, tmpl, **gkw), 3,
                       1),
               bound(ops6, H100_F32_FLOPS, bytes6))
        del ref6

        # K7 on the gate's new template
        t7 = got6[0].reshape(-1, 256)
        cls, reg = head_int8(t7, w.head, head_w, num_classes=1, l4=l4)
        torch.cuda.synchronize()
        cls_p, reg_p = head_int8_plain(t7, w.head, head_w, l4=l4)
        conv7 = 2.0 * (l4 * 3 * (256 * 256 * 2 + 256 * 512)
                       + (l4 // 2) * 3 * (512 * 256 + 256 * 128))
        bytes7 = (n * d + n * 3 * 4 + sum(t.numel() * t.element_size()
                                          for layer in w.head for t in layer))
        record("head_int8", [], [(cls, cls_p), (reg, reg_p)],
               time_ms(lambda: head_int8(t7, w.head, head_w, num_classes=1,
                                         l4=l4), iters),
               time_ms(lambda: head_int8_plain(t7, w.head, head_w, l4=l4), 3,
                       1),
               bound([(n * conv7, H100_INT8_OPS),
                      (n * 2.0 * 128 * 3, H100_BF16_FLOPS)], None, bytes7))
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


def compare_int8c(got, ref, step):
    """The JAX int8c-vs-f32 bar (tests/test_fast_gate.py): corr > 0.95 on
    cls and flow; every float output finite."""
    import torch

    for k in ("pred_cls", "pred_reg", "pred_flow"):
        a, r = got[k].float(), ref[k].float()
        check(a.shape == r.shape, f"int8c step {step} {k} shape")
        check(bool(torch.isfinite(a).all()), f"int8c step {step} {k} not "
              "finite")
        corr = float(torch.corrcoef(torch.stack([a.ravel(), r.ravel()]))[0, 1])
        print(f"[slice-int8c] step {step} {k}: corr={corr:.5f} "
              f"max_diff={float((a - r).abs().max()):.4g}", flush=True)
        if k != "pred_reg":
            check(corr > CORR_INT8, f"int8c step {step} {k}: corr {corr}")


def drive(runner, scans, reset_step, reset_stream, keep_carries=0):
    """One slice run: every launch counter set to 0 just before, read just
    after. Returns (launches, step ms, outputs, the first carries)."""
    import torch

    for w in wrappers().values():
        w.launches = 0
    step_ms, outs, carries = [], [], []
    for i, scan in enumerate(scans):
        if i == reset_step:
            runner.reset(streams=[reset_stream])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner(scan)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
        if i < keep_carries:
            carries.append({k: v.clone() for k, v in runner._carry.items()})
    launches = {k: w.launches for k, w in wrappers().items()}
    return launches, step_ms, outs, carries


def check_outputs(out, b, what):
    """Every output of the serving contract, of its shape; float ones
    finite."""
    import torch

    shapes = {"pred_cls": (b, NUM_PTS, 1), "pred_reg": (b, NUM_PTS, 2),
              "pred_flow": (b, NUM_PTS, 2), "det_xys": (b, 64, 2),
              "det_cls": (b, 64, 1), "det_keep": (b, 64),
              "instance_mask": (b, NUM_PTS)}
    check(set(out) == set(shapes), f"{what} outputs {sorted(out)}")
    for k, shape in shapes.items():
        check(tuple(out[k].shape) == shape,
              f"{what} {k} shape {tuple(out[k].shape)}")
        if out[k].is_floating_point():
            check(bool(torch.isfinite(out[k]).all()), f"{what} {k} not "
                  "finite")


def slice_phase(model, scans, device, calib, reset_step, reset_stream):
    """Phase 5: the v3 and int8c runners against the module runner."""
    import torch

    from planar_optical_flow_tpu_torch.infer.streaming import StreamingRunner

    b = scans.shape[1]
    kw = dict(num_pts=NUM_PTS, device=device)
    ref = StreamingRunner(model, CUTOUT_KW, engine="module", **kw)
    refs = []
    for i, scan in enumerate(scans):
        if i == reset_step:
            ref.reset(streams=[reset_stream])
        out = ref(scan)
        refs.append({k: out[k] for k in ("pred_cls", "pred_reg",
                                         "pred_flow")})
    del ref

    v3 = StreamingRunner(model, CUTOUT_KW, engine="v3", **kw)
    launches_v3, ms_v3, outs, _ = drive(v3, scans, reset_step, reset_stream)
    print(f"[slice] launches during the v3 run: {json.dumps(launches_v3)}")
    for k in V3_KERNELS:
        check(launches_v3[k] > 0, f"kernel {k} was not launched on the v3 "
              "path")
    for i, out in enumerate(outs):
        check_outputs(out, b, f"v3 step {i}")
        compare_engines(out, refs[i], i)
    del v3, outs
    torch.cuda.empty_cache()

    int8c = StreamingRunner(model, CUTOUT_KW, engine="int8c", calib=calib,
                            **kw)
    launches, ms_int8c, outs, carries = drive(int8c, scans, reset_step,
                                              reset_stream, keep_carries=2)
    print(f"[slice-int8c] launches during the int8c run: "
          f"{json.dumps(launches)}")
    for k in INT8C_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched on the int8c "
              "path")
    for k in set(V3_KERNELS) - set(INT8C_KERNELS):
        check(launches[k] == 0, f"bf16 kernel {k} ran on the int8c path")
    for i, out in enumerate(outs):
        check_outputs(out, b, f"int8c step {i}")
        compare_int8c(out, refs[i], i)
    check(carries[0]["template"].dtype == torch.int8, "int8c carry dtype")
    del int8c, outs

    # a runner rebuilt from the saved calibration.json: bit-identical
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = calib.save(os.path.join(BUILD_DIR, "calibration.json"))
    restored = StreamingRunner(model, CUTOUT_KW, engine="int8c", calib=path,
                               **kw)
    for i in range(2):
        restored(scans[i])
        for k, v in restored._carry.items():
            check(torch.equal(v, carries[i][k]),
                  f"restored calibration: step {i} carry {k} differs")
    print(f"[slice-int8c] runner rebuilt from {path}: carries bit-identical "
          "for 2 steps", flush=True)
    launches.update({k: launches_v3[k] for k in V3_KERNELS
                     if k not in INT8C_KERNELS})
    return launches, ms_v3, ms_int8c


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
    from planar_optical_flow_tpu_torch.infer.calibration import (
        calibrate_serve_v3,
    )
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
                         ("conv_stack", "head_smem_bytes", (c // 4,)),
                         ("conv_stack_int8", "backbone_int8_smem_bytes",
                          (c,)),
                         ("conv_stack_int8", "head_int8_smem_bytes",
                          (c // 4,))):
        f = getattr(_build.load(lib), fn)
        f.restype = ctypes.c_longlong
        f.argtypes = [ctypes.c_int] * len(arg)
        print(f"[smem] {fn[:-len('_smem_bytes')]}: {f(*arg)} bytes of "
              "dynamic shared memory per block"
              + (" (gate_int8 the same)" if lib == "gate" else ""))

    model = build_model(args.seed, device)
    rng = np.random.default_rng(args.seed)
    scans = torch.tensor(rng.uniform(0.5, 25.0, (STEPS, BATCH, NUM_PTS)),
                         dtype=torch.float32, device=device)
    scans[2, 3, 17] = float("nan")  # the sanitize guard on the main path
    t0 = time.perf_counter()
    calib = calibrate_serve_v3(model, CUTOUT_KW, scans[0][:CALIB_SCANS],
                               num_pts=NUM_PTS, device=device)
    print(f"[calib] {time.perf_counter() - t0:.1f} s on {CALIB_SCANS} scans: "
          f"{json.dumps(calib.to_dict())}", flush=True)

    results = kernel_phase(model, scans, device, TIMED_ITERS)
    torch.cuda.empty_cache()
    results.update(int8_kernel_phase(model, scans, calib, device,
                                     TIMED_ITERS))
    torch.cuda.empty_cache()
    launches, ms_v3, ms_int8c = slice_phase(
        model, scans, device, calib, reset_step=3, reset_stream=BATCH // 2)
    for name, step_ms in (("v3", ms_v3), ("int8c", ms_int8c)):
        carried = float(np.median(step_ms[1:]))
        print(f"[slice] {name} B={BATCH} step_ms="
              f"{json.dumps([round(t, 3) for t in step_ms])} carried median "
              f"{carried:.3f} ms = {BATCH / carried * 1e3:.1f} scans/s on "
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
