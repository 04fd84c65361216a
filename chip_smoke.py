#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

Drives the port's main paths, streaming FlowDROW serving on the int8c
engine (the JAX package's serving default) and on the bf16 ``v3`` engine,
the unfused int8 configurations of ``make_serve_step_v3``
(``precision="int8"``, int8c ``layout="flat"`` and ``"pm"``), its fused
int8c programs (``layout="p2c"``, ``fuse_gate_head=True``, ``layout=
"cell"``) and the other step builders (``make_fused_stream_step`` in f32
and bf16, ``make_serve_step`` in bf16 and f32, ``make_quantized_stream_step``,
``make_serve_sequence_processor``), at the flagship working point (window
11, 56 cutout points, area mode, 450 beams, B=384 streams) with random
weights made from ``--seed``.

Phases:
1. the card's name and power limit, CUDA version and capability; TF32 off
   for the f32 reference;
2. build every kernel from ``planar_optical_flow_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel), with the ``-Xptxas -v`` report, the
   count of each source's ``C75xx`` notes (every note that says a wgmma
   was serialized printed; the bf16 backbones, K8 and K12 may carry none,
   and K8, K12 and K3/K15's band_mix_kernel no spill) and each kernel's
   dynamic shared memory; the launch geometry of band_mix_kernel (K3 bf16
   and K15: rows a tile, tiles, ring stages, shared memory) equal to
   ``fast_gate.band_mix_geometry``'s with two blocks an SM; the
   launch geometry of K5, K9, K10, K7, K4 (and K14's bf16 head, on K4's
   kernel), K2 in its three layer-1 modes (and K14's bf16 backbone, on K2's
   kernel), K8, K12, K13 and K14 f32 (cutouts a block, rows a cutout,
   shared memory) equal to ``int8_tiles``' and within the card's 232,448
   bytes;
3. the model, from a seeded ``torch.Generator``, with seeded BN stats, and
   the int8 calibration on ``scans[0][:8]`` (as ``bench.py`` calibrates);
4. each kernel at the flagship shapes against its plain PyTorch version on
   the same inputs, then timed with CUDA events beside the plain version:
   K1 cutout (its launch geometry equal to ``cutout_geometry``'s, with
   ptxas's registers; its device time from a CUDA graph of its launches
   beside the wrapper loop's; its cutouts against ``cutout_plain``'s to the bit on the
   beams whose atanf the two compute alike, the count of those that differ
   printed; the bar stays TOL_CUTOUT), K2 backbone from the cutouts (layer
   1 inside, on weights laid out once; against ``backbone_layer1`` ->
   ``backbone_tail_plain``, and equal to the bit to K2 on
   ``backbone_layer1``'s act1 and to a call on the pairs; K2 on act1 and
   the plain layer 1 timed beside it), K3 gate (its new template also
   equal to the bit to ``gate_mix_plain`` on K3's own attention, read back
   through a probe template, and to
   ``gate_plain``'s on every row whose bf16 attention the two compute
   alike), K4 head (bf16: within 2e-2 x max|plain|), then K5 int8 backbone,
   K6 int8 gate, K7 int8 head (K5, K7-K10, K12 and K13 on weights laid out
   once, as the step builder holds them, each equal to the bit to a call on
   the triples); at the
   456 rows a stream of ``"flat"`` and ``"int8"``, K10 int8 backbone on
   the int8 layer 1 (int8 and bf16 feats) and K6 and K7 on K10's feats
   (K11 and K10's head); at the 480 rows a stream of ``"pm"``, K1, K9 int8
   backbone with the divide-after-leaky layer 1, and K6 and K7 on K9's
   feats; and the K16 row-shift check (int8 outputs within 1 LSB with under
   5e-3 of them off by one, and the count of bytes that differ printed;
   float outputs within 2e-2 x max|plain|; its device time from a CUDA
   graph of its launches beside the wrapper loop's); K9
   equal to the bit to layer 1 + K10, and within JAX's fold-vs-divide bar
   of K5 (at most 4 LSB, under 2% of the feats;
   ``tests/test_conv_stack_v2.py:292-299``); then the fused kernels, each
   against its plain version (K13 at JAX's cell-vs-pm bars: its plain zx,
   summed in float64, differs from the kernel's in a bf16 last bit on some
   rows, which moves their attention) and to the bit against the unfused
   kernels on the same inputs: K8 against K1 -> K5 at 456 rows a stream,
   K12 against K6 -> K7 on p2's feats and a carried template, K13 against
   K9 -> K6 -> K7 at 480 rows with a carried template; then K14's backbone
   and head in f32 (split-bf16 wgmma, on weights laid out once, equal to
   the bit to a call on the pairs; at rtol 1e-3 + 1e-4 x max|plain|, fewer
   timed launches, with the split-bf16, 3xTF32 and FFMA bounds) and in bf16
   (the backbone on K2's kernel, the head on K4's, their weights laid out
   once, each equal to the bit to a call on the pairs) on the module
   cutouts of the 450-beam streams, K3's f32 mode
   at ct=450 (template 2e-5, z and sim 2e-4, ``tests/test_fast_gate.py``),
   K3 in bf16 at ct=450 (the serve bf16 path's rows; its new template to
   the bit as above), and K15 in bf16 on K3's own attention, equal to its
   plain version to the bit and within one bf16 ulp (or 2^-17 x max where
   the f32 sum cancels) of K3's new template;
5. the slices, each for 1 bootstrap + 5 carried steps, every launch
   counter set to 0 just before and read just after:
   ``StreamingRunner(engine="v3")`` (K1-K4 launched, K2 from the cutouts,
   never on a plain layer 1's act1; one per-stream reset) within the JAX package's bf16-vs-f32 tolerance of ``engine="module"`` on
   the same scans, and ``StreamingRunner(engine="int8c")`` (K1, K5-K7
   launched, K2-K4 not) at the JAX int8c-vs-f32 bar (corr > 0.95 on cls
   and flow); a second int8c runner built from the saved
   ``calibration.json`` gives bit-identical carries for two steps; then
   ``make_serve_step_v3`` with ``precision="int8"`` (K1, K10, K3, K7;
   corr > 0.96 against the module step), int8c ``"flat"`` (K1, K10, K6,
   K7), ``"pm"`` (K1, K9, K6, K7), ``"cell"`` (K1 6 times, K13 5, K9, K6
   and K7 once, for the bootstrap), ``"p2"`` (K1, K5, K6, K7), ``"p2c"``
   (K8, K6, K7) and ``"p2"`` with ``fuse_gate_head=True`` (K1, K5, K12 5
   times, K6 and K7 once), every int8c run at corr > 0.95, each built
   inside the counted window with its K16 check and held to its exact
   launch counts; ``"flat"`` and ``"cell"`` equal to ``"pm"``, and
   ``"p2c"`` and the fused run equal to ``"p2"``, to the bit on the valid
   rows of every carry and output; then, against the f32 module step on the
   sanitized scans: ``make_fused_stream_step`` in f32 (K14 backbone and
   head 6 times each; atol 3e-3 and ``det_keep`` agreeing on > 98% of the
   slots, ``tests/test_pallas_fused.py``) and in bf16 (the bf16 bar),
   ``make_serve_step`` in bf16 (the bf16 bar) and f32 (2e-4), K3 5 times
   each, ``make_quantized_stream_step`` (no kernel; mean |pred_cls - module|
   < 0.05, ``tests/test_quantized.py``), and ``make_serve_sequence_processor``
   over the int8c p2 step, equal to the bit to the per-step run;
6. ``[files]``: the serving CLI and the serving evaluators from files.
   The model's weights saved with ``interop.checkpoint`` and the flagship
   config (the keys of ``configs/dr_spaam.yaml``) written as JSON under
   ``build/chip_smoke/files/`` (held equal to the YAML's where PyYAML is
   installed); a synthetic ``val`` split of 4 x 200 450-beam frames;
   ``cli.infer`` on one sequence with ``--engine int8c --save-calib``
   (K1, K5, K6, K7 launched), ``--calib`` and ``--replay`` (identical
   detections), and ``--engine v3`` (K1-K4; ``--replay`` identical);
   ``DrowDetectionDataset`` with its targets on the card against the
   CPU's (class and exclude mask exact, offsets and flow within 1e-5);
   ``evaluate_detection_ap_batched`` at 64 frames a step for the module
   (K3 in f32), v3 and int8c engines, each step built by
   ``make_ap_step`` first (every frame scored, AP in [0, 1], the device
   matcher's pool equal to ``match_detections`` on every frame), the
   module engine at batch 1 over the first 100 frames against
   ``evaluate_detection_ap`` on a module runner (within 1e-6), and
   ``evaluate_flow_serving`` at 64 frames a step for module and int8c
   (finite EPE and AAE, the frames dropped). No plain version of a kernel
   may run in the phase (the plain band attention only in a bootstrap).
   Each line gives frames/s and the card;
7. ``[train]``: training at the flagship config's full width (its keys,
   ``epochs`` cut to 1) on a synthetic split of 2 x 20 train and 1 x 12 val
   450-beam frames (``train_with_val``: 49 samples of 11 scans, 6 steps of
   8; one val batch): ``cli.train`` on the detector config (``network:
   cutout_gating``, ``DetectionTask``: K1 once a step, K2-K4 never) to its
   final checkpoint; FlowDROW through ``Pipeline`` with that checkpoint
   grafted by ``load_pretrained_detector``, on ``FlowDrowTask`` (K1 once a
   step) and with ``fused_frozen_detector`` (``FlowDrowFusedTask``: K1 and
   K2 once, K3 10 times and K4 never a step, as JAX's jitted step drops the
   unread head); every launch count exact, no plain version of a kernel,
   the detector's parameters equal to the bit to the checkpoint's after
   each FlowDROW run, every loss finite, the fused task's first-batch loss
   and similarity band at the bf16 bar of the module task's; a
   ``request_stop()`` after 2 steps writes the sigterm checkpoint (rc 1)
   and a resumed run completes the epoch. Each task's step ms (median after
   the first) and the phase's seconds beside the card;
8. ``[trace train]``: ``torch.profiler`` over 3 train steps of each
   FlowDROW task (device busy share, top device operations, the time
   outside K1, or K1-K3); ``[trace]``: the same over 3 carried steps of
   the int8c runner (the JAX serving default): the device busy share, the
   top device operations and the time a step spends outside K1/K5/K6/K7
   ("not measured" where the profiler records no device time);
   ``[trace v3]``
   the same for the v3 runner, outside K1-K4 (``[trace]`` and ``[trace
   v3]`` run after ``[flow]``);
9. ``[flow]`` (after ``[trace train]``): the flow U-Net at its full width
   (64/128/256 channels, 450 beams), ``configs/prototype_flow.yaml`` read
   and written as JSON with ``epochs`` cut to 1, through ``cli.train --synthetic``
   (2 x 40 train and 1 x 15 val frames) in f32 with ``profile_steps``
   (2, 5) and in bf16: finite losses, the final checkpoint, the step ms
   (median after the first); ``[trace flow]`` reads the f32 run's trace
   back from ``run_dir/profile`` (device busy share, top device operations;
   the U-Net launches no kernel of the port); ``cli.evaluate --ckpt``
   (the module path) on the card within 1e-4 relative of ``evaluate_flow``
   on the CPU, which collects one flow field a frame; the eval-mode
   forward at B = 8, 256 and 1024 scan pairs in f32 and bf16 (wrapper
   loop and CUDA-graph device ms, scan pairs/s, the bound from
   ``flow_macs``, which counts the correlation's band; f32 at B=8 within
   1e-4 x max of the CPU's); and the
   ``[train]`` phase's detector checkpoint through ``cli.evaluate
   --synthetic`` on the module path (finite metrics, K1 once an evaluation
   batch, K2-K4 never, no plain version);
10. ``[box]`` (after ``[flow]``): the PointNet box regressor at the full
   width of ``configs/train_3d_box_regression.yaml`` (B=256 segments of
   256 points, input_dim 4, target_dim 5, dropout 0.3, augmentation on),
   read and written as JSON with ``epoch`` cut to 1, on a synthetic JRDB
   tree of ``data.write_synthetic_jrdb`` (2 train sequences and 1 val
   sequence of 40 frames x 8 boxes: the samples after augmentation and the
   B=256 steps printed, at least 4), with the LZF decoder and the CSV
   reader that served; ``cli.train`` in f32 with ``profile_steps`` (1, 4)
   (``[trace box]``: device busy share, top device operations) and in
   bf16: finite losses, the final checkpoint, the step ms (median after
   the first); ``cli.evaluate --ckpt`` on the card (metrics and
   ``baseline_*``) within 1e-4 relative of ``evaluate_box_regression`` and
   ``mean_box_baseline`` on the CPU; ``BoxRegressor.from_checkpoint`` on a
   val frame at every box centre (boxes within 1e-4 of the CPU's, ``ok``
   masks equal); the eval-mode forward at B = 256, 1024 and 4096 segments
   in f32 and bf16 (wrapper loop and CUDA-graph device ms, segments/s, the
   bound from ``box_macs``; f32 at B=256 within 1e-4 x max of the CPU's);
   the metrics' rotated IoU of 256 predictions against 8 neighbours each
   (ms, within 1e-5 of the CPU's). No kernel of the port launches in the
   phase and no plain version of one runs;
11. ``[fc]`` (after ``[box]``): the fc detectors at the flagship config's
   full width (its keys, ``network`` fc1d, fc1d_fea and fc2d, ``epochs``
   cut to 1; B=8, 11 scans, 450 beams, bf16, 56 area-mode cutout points,
   the 301-bin polar grid, ``hidden`` 256) through ``cli.train`` on
   ``[train]``'s split sizes with ``profile_steps`` (2, 4): finite losses,
   the final checkpoint, exact launches (``fc1d_fea`` K1 once a step and
   once for the final evaluation; ``fc1d`` and ``fc2d`` none), no plain
   version, the step ms (median after the first, outside the profiled
   steps) beside the forward's bound (``fc_macs``) and ``[trace fc ...]``
   (device busy share, top device operations); each checkpoint's f32
   forward and train-mode loss on one batch within 1e-4 x max of the
   CPU's; the module cutout with ``fixed=False``, ``stride=2`` and
   ``area_fast`` on 8 x 11 x 450 scans (ms; equal to the bit to the CPU's
   on every beam whose ``atan`` the two compute alike); ``SpatialDrow``'s train forward with ``banded_chunk=45`` and
   dense (ms each, within 1e-4 + 1e-4 |dense|); ``cli.export_model`` of
   ``fc2d`` and ``drow`` at B=8 loaded in a fresh process (``--load-
   artifacts``), equal to the live forward to the bit; AdaBoost fitted
   and run on the host (seconds, recall above 0.5);
12. ``[export]`` (last, after the ``[trace]`` lines): the int8c p2 and v3
   steps exported at B=384 (``infer.export_serving_engine``: export
   seconds, MB) and every other ``make_serve_step_v3`` configuration
   (``"int8"``, pm, flat, p2c, cell, p2 fused) at B=8, the flow U-Net and
   the box regressor at B=256 and the box regressor at B=8
   (``export_model``); a fresh process (``python3 chip_smoke.py
   --load-artifacts DIR``, which the phase starts) loads each through
   ``StreamingRunner.from_artifact``/``load_model`` (load seconds) and runs
   1 bootstrap + 5 carried steps on the phase's scans (the NaN included)
   and the forwards on the same inputs, and ``BoxRegressor.from_artifact``
   on 8 centres: its outputs equal the live ones and its carries' SHA-256
   the live carries' at every step, with the same launch counts (K1, K5,
   K6, K7 and K1-K4 6 times each at B=384), the forwards and boxes equal;
   the carried-step medians loaded and live; the flagship detector
   written as a reference ``.pth`` envelope, imported by
   ``cli.import_checkpoint`` and served on the int8c runner at B=384,
   equal to its source weights to the bit;
12. the kernels line, the card line and the result line.

Any failed check raises: the script then exits non-zero and prints no
result line. Run: ``python3 chip_smoke.py`` (needs one CUDA card).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np

H100_BF16_FLOPS = 989e12   # dense tensor-core peak (NVIDIA data sheet)
H100_INT8_OPS = 1979e12    # dense int8 tensor-core peak
H100_F32_FLOPS = 67e12     # f32 outside the tensor cores
H100_TF32_FLOPS = 495e12   # dense TF32 tensor-core peak
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
CORR_INT8_STACKS = 0.96  # precision="int8" vs module (test_fast_gate.py)
FOLD_LSB, FOLD_SHARE = 4, 0.02  # K9 vs K5 (tests/test_conv_stack_v2.py)
PM_TILE = 160           # make_serve_step_v3's pm_tile: "pm" pads to 480
# K13 vs its plain version: z, sim, cls, reg (tests/test_int8_serving_gate.py
# cell vs pm: z 2e-2, outputs 5e-2)
CELL_TOLS = (2e-2, 5e-2, 5e-2, 5e-2)
F32_ITERS = 10           # timed launches of the f32 K14 kernels
TOL_K14_F32 = (1e-3, 1e-4)  # rtol, atol x max|plain| (tests/test_pallas_fused)
K3_F32_TOLS = (2e-5, 2e-4, 2e-4)  # new_t, new_z, sim (tests/test_fast_gate.py)
TOL_FUSED_F32 = 3e-3     # fused vs module, absolute (tests/test_pallas_fused)
KEEP_AGREE = 0.98        # det_keep slots that agree (tests/test_pallas_fused)
TOL_SERVE_F32 = 2e-4     # make_serve_step f32 vs module (test_fast_gate.py)
QUANT_MEAN = 0.05        # mean |pred_cls| difference (tests/test_quantized.py)
# the ptxas notes C75xx that say a wgmma was serialized
SERIAL_NOTES = ("10", "11", "12", "13", "14", "15", "16", "18", "20")
# the kernels (source -> entry names) that may carry no such note and no
# spill
CLEAN_KERNELS = {"conv_stack_int8": ("backbone_int8_cut_kernel",),
                 "serve_cell": ("gate_head_int8_kernel",),
                 "gate": ("band_mix_kernel",),
                 "banded_mix": ("band_mix_kernel",)}
# the kernels line: name -> (source, the TPU kernel it replaces, wrapper,
# the phase-5 run whose launches it reports)
_CS = "planar_optical_flow_tpu/ops/pallas/conv_stack.py"
_FG = "planar_optical_flow_tpu/infer/fast_gate.py"
_FD = "planar_optical_flow_tpu/ops/pallas/fused_drow.py"
_SRC = "planar_optical_flow_tpu_torch/csrc/"
KERNELS = {
    "cutout": (_SRC + "cutout.cu",
               "planar_optical_flow_tpu/ops/pallas/cutout_kernel.py:159",
               "cutout", "int8c"),
    # K2 keeps its row's name; the v3 path enters it through backbone_bf16
    # (layer 1 inside), backbone_tail being its JAX interface on act1
    "backbone_tail": (_SRC + "backbone_bf16.cu", _CS + ":302",
                      "backbone_bf16", "v3"),
    # K3 in bf16 and K15 run band_mix.cuh's kernel (gate.cu and
    # banded_mix.cu launch it)
    "gate": (_SRC + "band_mix.cuh", _FG + ":274", "gate", "v3"),
    "head": (_SRC + "head_bf16.cu", _CS + ":340", "head", "v3"),
    "backbone_int8": (_SRC + "conv_stack_int8.cu", _CS + ":1102",
                      "backbone_int8", "int8c"),
    "gate_int8": (_SRC + "gate.cu", _FG + ":679", "gate_int8", "int8c"),
    "head_int8": (_SRC + "conv_stack_int8.cu", _CS + ":1277", "head_int8",
                  "int8c"),
    "backbone_int8_pm": (_SRC + "conv_stack_int8.cu", _CS + ":815",
                         "backbone_int8_pm", "pm"),
    # K6 and K7 again at the pm path's 480 rows a stream
    "gate_int8_pm": (_SRC + "gate.cu", _FG + ":679", "gate_int8", "pm"),
    "head_int8_pm": (_SRC + "conv_stack_int8.cu", _CS + ":1277", "head_int8",
                     "pm"),
    "backbone_int8_tail": (_SRC + "conv_stack_int8.cu", _CS + ":1361",
                           "backbone_int8_tail", "flat"),
    "backbone_int8_tail_bf16": (_SRC + "conv_stack_int8.cu", _CS + ":1361",
                                "backbone_int8_tail", "int8"),
    # K10's head and K11 compute K7's and K6's functions on the same
    # cutout-major rows, and run on those kernels (held on the flat path's
    # own rows)
    "head_int8_as_fused_head_int8": (_SRC + "conv_stack_int8.cu",
                                     _CS + ":1398", "head_int8", "flat"),
    "gate_int8_as_gate_fused_int8": (_SRC + "gate.cu", _FG + ":783",
                                     "gate_int8", "flat"),
    "row_shift": (_SRC + "conv_stack_int8.cu", _CS + ":533", "row_shift",
                  "int8"),
    "backbone_int8_cut": (_SRC + "conv_stack_int8.cu", _CS + ":1212",
                          "backbone_int8_cut", "p2c"),
    "gate_head_int8": (_SRC + "serve_cell.cu", _FG + ":567", "gate_head_int8",
                       "p2_fused"),
    "serve_cell_int8": (_SRC + "serve_cell_wg.cu",
                        "planar_optical_flow_tpu/ops/pallas/serve_cell.py:170",
                        "serve_cell_int8", "cell"),
    "fused_backbone": (_SRC + "fused_f32.cu", _FD + ":172", "fused_backbone",
                       "fused"),
    "fused_backbone_bf16": (_SRC + "backbone_bf16.cu", _FD + ":172",
                            "fused_backbone", "fused_bf16"),
    "fused_head": (_SRC + "fused_f32.cu", _FD + ":198", "fused_head",
                   "fused"),
    "fused_head_bf16": (_SRC + "head_bf16.cu", _FD + ":198", "fused_head",
                        "fused_bf16"),
    "gate_f32": (_SRC + "gate.cu", _FG + ":274", "gate", "serve_f32"),
    # on no serving path, as in JAX: the launches of its phase-4 checks
    "banded_mix": (_SRC + "band_mix.cuh", _FG + ":191", "banded_mix_update",
                   "phase4"),
}
V3_KERNELS = ("cutout", "backbone_bf16", "gate", "head")
INT8C_KERNELS = ("cutout", "backbone_int8", "gate_int8", "head_int8")
# the make_serve_step_v3 runs: (options, the launches of each wrapper in 1
# bootstrap + 5 carried steps (every other wrapper 0; K16 once, at the
# build), the run whose valid rows it must equal to the bit)
LAYOUTS = {
    "int8": (dict(precision="int8"),
             dict(cutout=6, backbone_int8_tail=6, gate=6, head_int8=6), None),
    "pm": (dict(precision="int8c", layout="pm"),
           dict(cutout=6, backbone_int8_pm=6, gate_int8=6, head_int8=6), None),
    "flat": (dict(precision="int8c", layout="flat"),
             dict(cutout=6, backbone_int8_tail=6, gate_int8=6, head_int8=6),
             "pm"),
    "cell": (dict(precision="int8c", layout="cell"),
             dict(cutout=6, serve_cell_int8=5, backbone_int8_pm=1,
                  gate_int8=1, head_int8=1), "pm"),
    "p2": (dict(precision="int8c", layout="p2"),
           dict(cutout=6, backbone_int8=6, gate_int8=6, head_int8=6), None),
    "p2c": (dict(precision="int8c", layout="p2c"),
            dict(backbone_int8_cut=6, gate_int8=6, head_int8=6), "p2"),
    "p2_fused": (dict(precision="int8c", layout="p2", fuse_gate_head=True),
                 dict(cutout=6, backbone_int8=6, gate_head_int8=5,
                      gate_int8=1, head_int8=1), "p2"),
}


def laid_weights(w):
    """The int8 weights ``w`` with every int8 conv's (K5, K7-K10, K12, K13)
    laid out once, as ``make_serve_step_v3`` holds them (the triples stay
    in ``.convs``)."""
    from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs

    return w._replace(backbone=cs.backbone_weights_int8(w.backbone),
                      head=cs.head_weights_int8(w.head))


def same_bits(name, got, ref):
    """Check that two calls' outputs are equal to the bit."""
    import torch

    ok = all(torch.equal(g, r) for g, r in zip(got, ref))
    print(f"[kernel] {name}: {'bit-identical' if ok else 'DIFFER'}",
          flush=True)
    check(ok, f"{name} differ")


def k3_bits(name, new_t, ref_t, zx, zt, x, t, kw):
    """K3's bf16 new template to the bit: equal to ``gate_mix_plain`` on
    K3's own attention (read back through a probe template), and to
    ``gate_plain``'s ``ref_t`` on every row whose bf16 attention the two
    compute alike (the rest differ by the attention's rounding, not the
    mix). Returns that attention ``(B, ct, window)``."""
    import torch

    from planar_optical_flow_tpu_torch.infer import fast_gate as fg

    ct, window = kw["ct"], kw["window_size"]
    ct_valid = kw.get("ct_valid") or ct
    a = fg.gate_attention_probe(zx, zt, ct=ct, ct_valid=ct_valid,
                                window_size=window)
    own = torch.equal(new_t, fg.gate_mix_plain(a, x, t, ct=ct,
                                               ct_valid=ct_valid,
                                               alpha=kw["alpha"]))
    a_plain = fg._attention(zx, zt, ct=ct, ct_valid=ct_valid,
                            window_size=window)[0].to(torch.bfloat16).float()
    alike = (a_plain == a).all(-1).reshape(-1)
    rows = torch.equal(new_t[alike], ref_t[alike])
    print(f"[kernel] {name} new_t: equal to the bit to gate_plain's mix on "
          f"K3's own attention: {own}; to gate_plain's new_t on the "
          f"{int(alike.sum())} of {alike.numel()} rows whose bf16 attention "
          f"the two compute alike: {rows}", flush=True)
    check(own and rows, f"{name}: new_t differs from gate_plain's mix")
    return a


def kernel_ptxas(log, kernel):
    """(notes that a wgmma was serialized, bytes spilled) of the entry
    function whose mangled name holds ``kernel``, from an ``-Xptxas -v``
    log: a note names its function; the spill line follows the entry's
    ``Compiling entry function`` line."""
    serial, spills, entry = 0, 0, ""
    for line in log.splitlines():
        code = line.partition("(C75")[2][:2]
        if code in SERIAL_NOTES and kernel in line:
            serial += 1
        if "Compiling entry function" in line:
            entry = line
        if kernel in entry and "spill stores" in line:
            words = line.replace(",", " ").split()
            spills += sum(int(words[i - 2]) for i, w in enumerate(words)
                          if w == "spill")
    return serial, spills


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


def graph_ms(fn, iters):
    """Mean device time (ms) of one of ``iters`` calls of ``fn`` captured in
    one CUDA graph and replayed between two CUDA events: the launches with
    no host work between them (the graph's gaps between launches
    included). The profiler is not used here: after it has run, this
    process's later launches cost more host time, which the step phases
    would read."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def kernel_registers(log, kernel):
    """Registers a thread of the entry function whose mangled name holds
    ``kernel``, from an ``-Xptxas -v`` log (None if it is not there)."""
    entry = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif kernel in entry and "Used" in line and "registers" in line:
            return int(line.split("Used")[1].split("registers")[0])
    return None


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
    from planar_optical_flow_tpu_torch.infer.fast_gate import (
        banded_mix_update, gate, gate_head_int8, gate_int8,
    )
    from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
        backbone_bf16, backbone_int8, backbone_int8_cut, backbone_int8_pm,
        backbone_int8_tail, backbone_tail, head, head_int8, row_shift,
    )
    from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout
    from planar_optical_flow_tpu_torch.ops.kernels.fused_drow import (
        fused_backbone, fused_head,
    )
    from planar_optical_flow_tpu_torch.ops.kernels.serve_cell import (
        serve_cell_int8,
    )

    return {"cutout": cutout, "backbone_bf16": backbone_bf16,
            "backbone_tail": backbone_tail, "gate": gate,
            "head": head, "backbone_int8": backbone_int8,
            "gate_int8": gate_int8, "head_int8": head_int8,
            "backbone_int8_pm": backbone_int8_pm,
            "backbone_int8_tail": backbone_int8_tail,
            "row_shift": row_shift, "backbone_int8_cut": backbone_int8_cut,
            "gate_head_int8": gate_head_int8,
            "serve_cell_int8": serve_cell_int8,
            "fused_backbone": fused_backbone, "fused_head": fused_head,
            "banded_mix_update": banded_mix_update}


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
        backbone_bf16, backbone_bf16_plain, backbone_layer1, backbone_tail,
        backbone_weights_bf16, head, head_plain, head_weights_bf16,
    )
    from planar_optical_flow_tpu_torch.ops.kernels import _build
    from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import (
        cutout, cutout_geometry, cutout_plain, div_f32, half_alpha_probe,
        recip,
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
        # K1: its launch geometry (as cutout_geometry mirrors it) and
        # registers, then the kernel against its plain version
        ww = CUTOUT_KW["window_width"]
        got_geo = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int(),
                   ctypes.c_longlong()]
        oversize = _build.load("cutout").cutout_geometry(
            p_pad, c, ctypes.c_float(ww), ctypes.c_float(recip(
                math.radians(0.5))), *(ctypes.byref(v) for v in got_geo))
        got_geo = tuple(v.value for v in got_geo)
        want = cutout_geometry(p_pad, c, ww)
        regs = kernel_registers(_build.build_all(("cutout",))["cutout"]["log"],
                                "cutout_kernel")
        print(f"[geometry] K1 at {p_pad} rows a stream, C={c}: {got_geo[0]} "
              f"beams a tile, {got_geo[1]} tiles a stream, {b * got_geo[1]} "
              f"blocks at B={b}, a tap's reach {got_geo[2]} beams, "
              f"{got_geo[3]} bytes of shared memory a block, {regs} "
              f"registers a thread (ptxas); cutout_geometry: {want}",
              flush=True)
        check(oversize == 0 and got_geo == want, f"K1 geometry {got_geo}")
        scan_p = F.pad(scans[0], (0, p_pad - NUM_PTS))
        got = cutout(scan_p, **ckw)
        torch.cuda.synchronize()
        ref = cutout_plain(scan_p, **ckw)
        record("cutout", [(got, ref)], None,
               time_ms(lambda: cutout(scan_p, **ckw), iters),
               time_ms(lambda: cutout_plain(scan_p, **ckw), 3, 1),
               bound(cutout_ops(scan_p, c, NUM_PTS), H100_F32_FLOPS,
                     4.0 * n + 4.0 * n * c))
        dev = graph_ms(lambda: cutout(scan_p, **ckw), iters)
        print(f"[kernel] cutout device time: {dev:.4f} ms a launch (a CUDA "
              f"graph of {iters} launches, CUDA events); wrapper loop "
              f"{results['cutout']['ms']:.4f} ms (CUDA events)", flush=True)
        # to the bit, on the beams whose half-window angle (atanf) K1 and
        # torch.atan compute alike; the bar stays TOL_CUTOUT
        alike = (half_alpha_probe(scan_p, ww) == torch.atan(div_f32(
            0.5 * ww, torch.clamp(scan_p, min=1e-2)))).reshape(-1)
        rows_eq = (got == ref).all(-1)
        print(f"[kernel] cutout vs cutout_plain at B={b}, {p_pad} rows, "
              f"C={c}: {int(rows_eq[alike].sum())} of {int(alike.sum())} "
              f"beams whose atanf the two compute alike equal to the bit "
              f"({'bit-identical' if bool(rows_eq[alike].all()) else 'DIFFER'}"
              f"); {int((~alike).sum())} beams' atanf differ, "
              f"{int((~rows_eq[~alike]).sum())} of their cutouts differ; "
              f"{int((~rows_eq).sum())} of {rows_eq.numel()} cutouts differ "
              f"in all", flush=True)

        # K2 from this scan's cutouts (layer 1 inside), on its weights laid
        # out once as the v3 step holds them
        emb = (gp.w, gp.b)
        laid2 = backbone_weights_bf16(tail)
        feats, zx = backbone_bf16(got, layer1, laid2, emb, l=c)
        torch.cuda.synchronize()
        feats_p, zx_p = backbone_bf16_plain(got, layer1, tail, emb, l=c)
        flops2 = 2.0 * n * (c * 3 * (64 * 64 + 64 * 128)
                            + (c // 2) * 3 * (2 * 128 * 128 + 128 * 256)
                            + d * 128)
        ops1 = 7.0 * n * c * 64  # layer 1: 3 products, 3 adds, the leaky
        bytes2 = (n * c * 4 + n * d * 2 + n * 128 * 2
                  + sum(w.numel() * 2 + bb.numel() * 4 for w, bb in tail)
                  + gp.w.numel() * 2)
        record("backbone_tail", [(feats, feats_p), (zx, zx_p)], TOL_BF16,
               time_ms(lambda: backbone_bf16(got, layer1, laid2, emb, l=c),
                       iters),
               time_ms(lambda: backbone_bf16_plain(got, layer1, tail, emb,
                                                   l=c), 3, 1),
               bound([(flops2, H100_BF16_FLOPS), (ops1, H100_F32_FLOPS)],
                     None, bytes2))
        del feats_p, zx_p
        # layer 1 folded in exactly: K2 on backbone_layer1's act1 (its JAX
        # interface) gives the same bits, and so do the pairs laid out in
        # the call
        act1 = backbone_layer1(got, layer1)
        same_bits("backbone_tail from the cutouts and on backbone_layer1's "
                  "act1", (feats, zx), backbone_tail(act1, laid2, emb, l=c))
        same_bits("backbone_tail on the laid-out weights and on the pairs",
                  (feats, zx), backbone_bf16(got, layer1, tail, emb, l=c))
        ms_read = time_ms(lambda: backbone_tail(act1, laid2, emb, l=c), iters)
        ms_l1 = time_ms(lambda: backbone_layer1(got, layer1), iters)
        print(f"[kernel] backbone_tail on act1 (its JAX interface) "
              f"ms={ms_read:.4f}; the plain layer 1 before it "
              f"(backbone_layer1) ms={ms_l1:.4f}", flush=True)
        del act1

        # K3, carried: a second scan's features as the template
        feats2, zx2 = backbone_bf16(
            cutout(F.pad(scans[1], (0, p_pad - NUM_PTS)), **ckw), layer1,
            laid2, emb, l=c)
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
        k3_bits("gate", got3[0], ref3[0], zx, zx2, x, t, gkw)
        del ref3

        # K4 on the gate's new template, its weights laid out once as the
        # step builders lay them out
        tmpl = got3[0].reshape(-1, 256)
        laid = head_weights_bf16(conv_w)
        cls, reg = head(tmpl, laid, head_w, num_classes=1, l4=l4)
        torch.cuda.synchronize()
        cls_p, reg_p = head_plain(tmpl, conv_w, head_w, l4=l4)
        flops4 = 2.0 * n * (l4 * 3 * (256 * 256 * 2 + 256 * 512)
                            + (l4 // 2) * 3 * (512 * 256 + 256 * 128)
                            + 128 * 3)
        bytes4 = (n * d * 2 + n * 3 * 4
                  + sum(w.numel() * 2 + bb.numel() * 4 for w, bb in conv_w))
        record("head", [(cls, cls_p), (reg, reg_p)], TOL_BF16,
               time_ms(lambda: head(tmpl, laid, head_w, num_classes=1,
                                    l4=l4), iters),
               time_ms(lambda: head_plain(tmpl, conv_w, head_w, l4=l4), 3, 1),
               bound(flops4, H100_BF16_FLOPS, bytes4))
    return results


def int8_diff(got, ref):
    """(max |got - ref|, share of elements that differ) of int8 tensors."""
    diff = (got.int() - ref.int()).abs()
    return float(diff.max()), float((diff > 0).float().mean())


def record_int8(results, name, int8_pairs, float_pairs, ms, plain_ms,
                bound_pair, float_tols=None):
    """int8 outputs within 1 LSB with under TOL_INT8_SHARE of them off by
    one; float outputs within TOL_BF16 * max|plain|, or, with
    ``float_tols``, elementwise within tol + tol * |plain| (one tol per
    float output)."""
    errs, ok, notes = [], True, []
    for g, r in int8_pairs:
        err, share = int8_diff(g, r)
        errs.append(err)
        ok &= err <= 1 and share < TOL_INT8_SHARE
        notes.append(f"int8 max={err:.0f} share={share:.3e} "
                     f"differing={int((g != r).sum())} of {r.numel()}")
    for k, (g, r) in enumerate(float_pairs):
        errs.append(max_err(g, r))
        if float_tols is None:
            lim = TOL_BF16 * max(float(r.float().abs().max()), 1e-6)
            ok &= errs[-1] <= lim
            notes.append(f"err={errs[-1]:.3e} lim={lim:.3e}")
        else:
            tol = float_tols[k]
            ok &= bool(torch_allclose(g, r, tol))
            notes.append(f"err={errs[-1]:.3e} tol={tol:g}")
    print(f"[kernel] {name}: {'; '.join(notes)} ms={ms:.4f} "
          f"plain_ms={plain_ms:.3f} bound_ms={bound_pair[0]:.6f} "
          f"({bound_pair[1]}) {'ok' if ok else 'MISMATCH'}", flush=True)
    check(ok, f"{name} kernel disagrees with its plain version")
    results[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_pair[0], bound_by=bound_pair[1])


def torch_allclose(got, ref, tol):
    """|got - ref| <= tol + tol * |ref| elementwise (numpy's allclose with
    rtol = atol = tol)."""
    import torch

    return torch.allclose(got.float(), ref.float(), rtol=tol, atol=tol)


def gate_ops(b, n, d):
    """f32 operations of the int8 gate on the n rows of b streams of
    NUM_PTS valid rows: the band's dot products and z mix, and ~5 per
    template element."""
    hw = WINDOW // 2
    valid_pairs = sum(min(i + hw, NUM_PTS - 1) - max(i - hw, 0) + 1
                      for i in range(NUM_PTS)) * b
    return 2.0 * valid_pairs * (d + 2 * 128) + 5.0 * n * d


def gate_and_head_int8(results, names, feats, zx, feats2, zx2, w, head_w,
                       gp, p_pad, b, iters):
    """K6 on ``(feats, zx)`` with the template made from ``(feats2, zx2)``
    as the bootstrap makes it, then K7 on the gate's new template, each
    against its plain version and timed, at ``p_pad`` rows a stream;
    recorded under ``names`` (gate, head)."""
    import torch

    from planar_optical_flow_tpu_torch.infer.fast_gate import (
        gate_int8, gate_int8_plain,
    )
    from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
        head_int8, head_int8_plain,
    )

    l4 = CUTOUT_KW["num_cutout_pts"] // 4
    n, d = b * p_pad, l4 * 256
    # K6, carried: the second features, rescaled to the carry scale
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
    ops6 = gate_ops(b, n, d)
    bytes6 = 3.0 * n * d + 3.0 * n * 128 * 2 + n * WINDOW * 4
    record_int8(
        results, names[0], [(got6[0], ref6[0])],
        list(zip(got6[1:], ref6[1:])),
        time_ms(lambda: gate_int8(zx, zx2, x, tmpl, **gkw), iters),
        time_ms(lambda: gate_int8_plain(zx, zx2, x, tmpl, **gkw), 3, 1),
        bound(ops6, H100_F32_FLOPS, bytes6))
    del ref6, tmpl

    # K7 on the gate's new template, on the weights laid out once and on
    # the triples
    t7 = got6[0].reshape(-1, 256)
    cls, reg = head_int8(t7, w.head, head_w, num_classes=1, l4=l4)
    torch.cuda.synchronize()
    same_bits(f"{names[1]} on the laid-out weights and on the triples",
              (cls, reg), head_int8(t7, w.head.convs, head_w, num_classes=1,
                                    l4=l4))
    cls_p, reg_p = head_int8_plain(t7, w.head, head_w, l4=l4)
    conv7 = 2.0 * (l4 * 3 * (256 * 256 * 2 + 256 * 512)
                   + (l4 // 2) * 3 * (512 * 256 + 256 * 128))
    bytes7 = (n * d + n * 3 * 4 + sum(t.numel() * t.element_size()
                                      for layer in w.head.convs
                                      for t in layer))
    record_int8(
        results, names[1], [], [(cls, cls_p), (reg, reg_p)],
        time_ms(lambda: head_int8(t7, w.head, head_w, num_classes=1, l4=l4),
                iters),
        time_ms(lambda: head_int8_plain(t7, w.head, head_w, l4=l4), 3, 1),
        bound([(n * conv7, H100_INT8_OPS),
               (n * 2.0 * 128 * 3, H100_BF16_FLOPS)], None, bytes7))


def int8_kernel_phase(model, scans, calib, device, iters):
    """Phase 4, int8c: K5-K7 against their plain versions at the flagship
    shapes, on the scales of ``calib``, and timed."""
    import torch
    import torch.nn.functional as F

    from planar_optical_flow_tpu_torch.infer.streaming import int8_weights
    from planar_optical_flow_tpu_torch.ops.kernels import fold
    from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
        backbone_int8, backbone_int8_plain,
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
    w = laid_weights(int8_weights(det, calib, device))
    head_w = fold.head_linear_weights(det.head)
    gp = fold.fold_gate_params(det.gate)
    results = {}

    def feats_of(scan):
        flat = cutout(F.pad(scan, (0, p_pad - NUM_PTS)), **ckw)
        return flat, backbone_int8(flat, w.layer1, w.backbone, w.embed, l=c)

    with torch.inference_mode():
        # K5 on the cutouts of scan 0
        flat, (feats, zx) = feats_of(scans[0])
        k5 = (flat, w.layer1, w.backbone, w.embed)
        torch.cuda.synchronize()
        same_bits("backbone_int8 on the laid-out weights and on the triples",
                  (feats, zx), backbone_int8(flat, w.layer1, w.backbone.convs,
                                             w.embed, l=c))
        feats_p, zx_p = backbone_int8_plain(*k5, l=c)
        conv5 = 2.0 * (c * 3 * (64 * 64 + 64 * 128)
                       + (c // 2) * 3 * (2 * 128 * 128 + 128 * 256))
        bytes5 = (n * c * 4 + n * d + n * 128 * 2 + w.embed[0].numel() * 2
                  + sum(t.numel() * t.element_size()
                        for layer in w.backbone.convs for t in layer))
        record_int8(
            results, "backbone_int8", [(feats, feats_p)], [(zx, zx_p)],
            time_ms(lambda: backbone_int8(*k5, l=c), iters),
            time_ms(lambda: backbone_int8_plain(*k5, l=c), 3, 1),
            bound([(n * conv5, H100_INT8_OPS),
                   (n * 2.0 * d * 128, H100_BF16_FLOPS),
                   (n * c * 64 * 7.0, H100_F32_FLOPS)], None, bytes5))
        del feats_p, zx_p

        # K6 and K7, with scan 1's features as the template
        _, (feats2, zx2) = feats_of(scans[1])
        gate_and_head_int8(results, ("gate_int8", "head_int8"), feats, zx,
                       feats2, zx2, w, head_w, gp, p_pad, b, iters)
    return results


def layouts_kernel_phase(model, scans, calib, device, iters):
    """Phase 4, the unfused int8 configurations, on the scales of ``calib``,
    at the rows a stream that each path gives its kernels. At 456
    (``"flat"`` and ``"int8"``): the plain layer 1, K10 with int8 and bf16
    feats on it, and K6 and K7 (K11 and K10's head) on K10's feats. At 480
    (``"pm"``): K1, K9, K9 against layer 1 + K10 and against K5, and K6 and
    K7 on K9's feats. Then K16."""
    import torch
    import torch.nn.functional as F

    from planar_optical_flow_tpu_torch.infer.streaming import int8_weights
    from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs
    from planar_optical_flow_tpu_torch.ops.kernels import fold, quant
    from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import (
        cutout, cutout_plain,
    )

    det = model.dr_spaam
    b = scans.shape[1]
    c = CUTOUT_KW["num_cutout_pts"]
    d = c // 4 * 256
    ckw = dict(num_cutout_pts=c, window_width=CUTOUT_KW["window_width"],
               window_depth=CUTOUT_KW["window_depth"],
               padding_val=CUTOUT_KW["padding_val"], centered=True,
               area_mode=True, p_valid=NUM_PTS)
    w = laid_weights(int8_weights(det, calib, device, "int8c"))
    w8 = laid_weights(int8_weights(det, calib, device, "int8"))
    head_w = fold.head_linear_weights(det.head)
    gp = fold.fold_gate_params(det.gate)
    results = {}
    conv_ops = 2.0 * (c * 3 * (64 * 64 + 64 * 128)
                      + (c // 2) * 3 * (2 * 128 * 128 + 128 * 256))

    def tail_ops(n):
        return [(n * conv_ops, H100_INT8_OPS),
                (n * 2.0 * d * 128, H100_BF16_FLOPS)]

    def weight_bytes(weights):
        return sum(t.numel() * t.element_size()
                   for layer in weights.convs for t in layer)

    def pad(scan, p_pad):
        return F.pad(scan, (0, p_pad - NUM_PTS))

    def layer1(flat):
        return cs.backbone_layer1(flat, w.layer1_div, out_scale=w.in_scale)

    with torch.inference_mode():
        # 456 rows a stream: "flat" and "int8"
        p_pad = -(-NUM_PTS // 8) * 8
        n = b * p_pad
        flat = cutout(pad(scans[0], p_pad), **ckw)
        act1 = layer1(flat)
        torch.cuda.synchronize()
        l1_ms = time_ms(lambda: layer1(flat), iters)
        print(f"[layer1] plain-torch layer 1 to int8 (N={n}, part of the "
              f"flat and int8 steps outside the kernels): {l1_ms:.3f} ms",
              flush=True)

        # K10, int8 feats (int8c "flat") and bf16 feats ("int8")
        for name, wts, dtype in (("backbone_int8_tail", w, torch.int8),
                                 ("backbone_int8_tail_bf16", w8,
                                  torch.bfloat16)):
            args = (act1, wts.backbone, wts.embed)
            got = cs.backbone_int8_tail(*args, l=c, out_dtype=dtype)
            torch.cuda.synchronize()
            ref = cs.backbone_int8_tail_plain(*args, l=c, out_dtype=dtype)
            pairs = [(got[0], ref[0])] if dtype == torch.int8 else []
            floats = [(got[1], ref[1])] + (
                [] if dtype == torch.int8 else [(got[0], ref[0])])
            feat_bytes = 1 if dtype == torch.int8 else 2
            nbytes = (n * c * 64 + n * d * feat_bytes + n * 128 * 2
                      + wts.embed[0].numel() * 2 + weight_bytes(wts.backbone))
            record_int8(
                results, name, pairs, floats,
                time_ms(lambda: cs.backbone_int8_tail(*args, l=c,
                                                      out_dtype=dtype), iters),
                time_ms(lambda: cs.backbone_int8_tail_plain(
                    *args, l=c, out_dtype=dtype), 3, 1),
                bound(tail_ops(n), None, nbytes))
            if dtype == torch.int8:
                feats10, zx10 = got
            else:
                tq_ms = time_ms(lambda: quant.quantize_int8(
                    got[0], w8.tmpl_scale), iters)
                print(f"[requant] the int8 step's bf16 template to int8 for "
                      f"K7 (plain torch): {tq_ms:.3f} ms", flush=True)
            del got, ref
        del act1, flat

        # K11 and K10's head: K6 and K7 on the flat path's own rows, with
        # scan 1's features as the template
        feats_t, zx_t = cs.backbone_int8_tail(
            layer1(cutout(pad(scans[1], p_pad), **ckw)), w.backbone, w.embed,
            l=c)
        gate_and_head_int8(results, ("gate_int8_as_gate_fused_int8",
                                 "head_int8_as_fused_head_int8"),
                       feats10, zx10, feats_t, zx_t, w, head_w, gp, p_pad, b,
                       iters)
        del feats10, zx10, feats_t, zx_t

        # 480 rows a stream: "pm"
        p_pad = -(-NUM_PTS // PM_TILE) * PM_TILE
        n = b * p_pad
        flat = cutout(pad(scans[0], p_pad), **ckw)
        torch.cuda.synchronize()
        err = max_err(flat, cutout_plain(pad(scans[0], p_pad), **ckw))
        print(f"[kernel] cutout at {p_pad} rows a stream: max_abs_err="
              f"{err:.3e} (limit {TOL_CUTOUT})", flush=True)
        check(err <= TOL_CUTOUT, f"cutout at {p_pad} rows disagrees with its "
              "plain version")

        # K9; layer 1 + K10 (same f32 order) to the bit; K5 (1/in_scale
        # folded into layer 1) to JAX's bar
        k9 = (flat, w.layer1_div, w.backbone, w.embed)
        feats9, zx9 = cs.backbone_int8_pm(*k9, l=c, in_scale=w.in_scale)
        torch.cuda.synchronize()
        same_bits("backbone_int8_pm on the laid-out weights and on the "
                  "triples", (feats9, zx9),
                  cs.backbone_int8_pm(flat, w.layer1_div, w.backbone.convs,
                                      w.embed, l=c, in_scale=w.in_scale))
        ref = cs.backbone_int8_pm_plain(*k9, l=c, in_scale=w.in_scale)
        nbytes9 = (n * c * 4 + n * d + n * 128 * 2 + w.embed[0].numel() * 2
                   + weight_bytes(w.backbone))
        record_int8(
            results, "backbone_int8_pm", [(feats9, ref[0])],
            [(zx9, ref[1])],
            time_ms(lambda: cs.backbone_int8_pm(*k9, l=c,
                                                in_scale=w.in_scale), iters),
            time_ms(lambda: cs.backbone_int8_pm_plain(
                *k9, l=c, in_scale=w.in_scale), 3, 1),
            bound(tail_ops(n) + [(n * c * 64 * 8.0, H100_F32_FLOPS)], None,
                  nbytes9))
        del ref
        feats10, zx10 = cs.backbone_int8_tail(layer1(flat), w.backbone,
                                              w.embed, l=c)
        same = torch.equal(feats9, feats10) and torch.equal(zx9, zx10)
        print(f"[kernel] K9 vs layer 1 + K10 at {p_pad} rows a stream: feats "
              f"and zx {'bit-identical' if same else 'DIFFER'}", flush=True)
        check(same, "K9 differs from plain layer 1 + K10")
        del feats10, zx10
        feats5, _ = cs.backbone_int8(flat, w.layer1, w.backbone, w.embed, l=c)
        err, share = int8_diff(feats9, feats5)
        print(f"[kernel] K9 vs K5 (divide vs fold): max {err:.0f} LSB, "
              f"share {share:.4e} (bar: <= {FOLD_LSB} LSB, share < "
              f"{FOLD_SHARE})", flush=True)
        check(err <= FOLD_LSB and share < FOLD_SHARE,
              f"K9 vs K5: {err} LSB, share {share}")
        del feats5, flat

        # K6 and K7 on the pm path's rows (30 dead rows a stream)
        feats_t, zx_t = cs.backbone_int8_pm(
            cutout(pad(scans[1], p_pad), **ckw), w.layer1_div, w.backbone,
            w.embed, l=c, in_scale=w.in_scale)
        gate_and_head_int8(results, ("gate_int8_pm", "head_int8_pm"), feats9,
                       zx9, feats_t, zx_t, w, head_w, gp, p_pad, b, iters)
        del feats9, zx9, feats_t, zx_t

        # K16 on the JAX check's pattern
        x_np, l, exp_left, exp_right = cs.row_shift_pattern()
        x = torch.from_numpy(x_np).to(device)
        left, right = cs.row_shift(x, l=l)
        torch.cuda.synchronize()
        ok = (np.array_equal(left.cpu().numpy(), exp_left)
              and np.array_equal(right.cpu().numpy(), exp_right))
        print(f"[kernel] row_shift (K16) on the 8 x 128 pattern: "
              f"{'expected rows' if ok else 'WRONG ROWS'}", flush=True)
        check(ok, "K16 row-shift check failed on the card")

        def taps_plain():
            return cs._taps_plain(x.reshape(-1, l, 128))

        record_int8(results, "row_shift",
                    [(left, taps_plain()[0].reshape(x.shape)),
                     (right, taps_plain()[1].reshape(x.shape))], [],
                    time_ms(lambda: cs.row_shift(x, l=l), iters),
                    time_ms(taps_plain, iters),
                    bound(0.0, H100_INT8_OPS, 3.0 * x.numel()))
        dev = graph_ms(lambda: cs.row_shift(x, l=l), iters)
        print(f"[kernel] row_shift (K16) device time: {dev:.4f} ms a launch "
              f"(a CUDA graph of {iters} launches, CUDA events); wrapper "
              f"loop {results['row_shift']['ms']:.4f} ms (CUDA events)",
              flush=True)
    return results




def fused_kernel_phase(model, scans, calib, device, iters):
    """Phase 4, the fused int8c kernels on the scales of ``calib``: K8 at
    456 rows a stream against its plain version and, to the bit, against K1
    -> K5; K12 on p2's feats with scan 1's features as the carried template
    against its plain version and K6 -> K7; K13 at 480 rows with a carry
    made by K9 from scan 0, against its plain version and K9 -> K6 -> K7.
    Each on the weights laid out once, equal to the bit to a call on the
    triples, and timed beside its plain version."""
    import torch
    import torch.nn.functional as F

    from planar_optical_flow_tpu_torch.infer.fast_gate import (
        gate_head_int8, gate_head_int8_plain, gate_int8,
    )
    from planar_optical_flow_tpu_torch.infer.streaming import int8_weights
    from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs
    from planar_optical_flow_tpu_torch.ops.kernels import fold
    from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout
    from planar_optical_flow_tpu_torch.ops.kernels.serve_cell import (
        cell_embed, serve_cell_int8, serve_cell_int8_plain,
    )

    det = model.dr_spaam
    b = scans.shape[1]
    c = CUTOUT_KW["num_cutout_pts"]
    l4 = c // 4
    d = l4 * 256
    ckw = dict(num_cutout_pts=c, window_width=CUTOUT_KW["window_width"],
               window_depth=CUTOUT_KW["window_depth"],
               padding_val=CUTOUT_KW["padding_val"], centered=True,
               area_mode=True, p_valid=NUM_PTS)
    w = laid_weights(int8_weights(det, calib, device))
    head_w = fold.head_linear_weights(det.head)
    gp = fold.fold_gate_params(det.gate)
    results = {}
    backbone_ops = 2.0 * (c * 3 * (64 * 64 + 64 * 128)
                          + (c // 2) * 3 * (2 * 128 * 128 + 128 * 256))
    head_ops = 2.0 * (l4 * 3 * (256 * 256 * 2 + 256 * 512)
                      + (l4 // 2) * 3 * (512 * 256 + 256 * 128))
    weight_bytes = sum(t.numel() * t.element_size()
                       for layer in w.backbone.convs + w.head.convs
                       for t in layer)

    def gkw(p_pad):
        return dict(ct=p_pad, ct_valid=NUM_PTS, alpha=gp.alpha,
                    window_size=gp.window_size, s_x=w.feat_scale,
                    s_t=w.tmpl_scale, s_out=w.tmpl_scale)

    def carried(feats, n):
        # a carried template: features rescaled to the carry's scale, as
        # the bootstrap makes it
        return torch.clamp(torch.round(feats.float().reshape(n, d)
                                       * (w.feat_scale / w.tmpl_scale)),
                           -127, 127).to(torch.int8)

    with torch.inference_mode():
        # K8 at 456 rows a stream
        p_pad = -(-NUM_PTS // 8) * 8
        n = b * p_pad
        scan_p = F.pad(scans[0], (0, p_pad - NUM_PTS))
        # the weights laid out once, as make_serve_step_v3 holds them
        k8 = (scan_p, w.layer1, w.backbone, w.embed)
        got = cs.backbone_int8_cut(*k8, **ckw)
        torch.cuda.synchronize()
        same_bits("backbone_int8_cut on the laid-out weights and on the "
                  "triples", got,
                  cs.backbone_int8_cut(scan_p, w.layer1, w.backbone.convs,
                                       w.embed, **ckw))
        ref = cs.backbone_int8_cut_plain(*k8, **ckw)
        record_int8(
            results, "backbone_int8_cut", [(got[0], ref[0])],
            [(got[1], ref[1])],
            time_ms(lambda: cs.backbone_int8_cut(*k8, **ckw), iters),
            time_ms(lambda: cs.backbone_int8_cut_plain(*k8, **ckw), 3, 1),
            bound([(n * backbone_ops, H100_INT8_OPS),
                   (n * 2.0 * d * 128, H100_BF16_FLOPS),
                   (n * c * 64 * 7.0 + cutout_ops(scan_p, c, NUM_PTS),
                    H100_F32_FLOPS)], None,
                  n * 4.0 + n * d + n * 128 * 2 + w.embed[0].numel() * 2
                  + weight_bytes))
        del ref
        same_bits(f"K8 vs K1 -> K5 at {p_pad} rows a stream", got,
             cs.backbone_int8(cutout(scan_p, **ckw), w.layer1, w.backbone,
                              w.embed, l=c))

        # K12 on p2's feats (scan 0) and scan 1's features as the template
        x, zx = got[0].reshape(n, d), got[1]
        feats2, zx2 = cs.backbone_int8_cut(
            F.pad(scans[1], (0, p_pad - NUM_PTS)), w.layer1, w.backbone,
            w.embed, **ckw)
        tmpl = carried(feats2, n)
        del feats2, got
        k12 = (zx, zx2, x, tmpl, w.head, head_w)
        kw12 = dict(gkw(p_pad), num_classes=1, l4=l4)
        got = gate_head_int8(*k12, **kw12)
        torch.cuda.synchronize()
        same_bits("gate_head_int8 on the laid-out weights and on the "
                  "triples", got,
                  gate_head_int8(zx, zx2, x, tmpl, w.head.convs, head_w,
                                 **kw12))
        ref = gate_head_int8_plain(*k12, **kw12)
        record_int8(
            results, "gate_head_int8", [(got[0], ref[0])],
            list(zip(got[1:], ref[1:])),
            time_ms(lambda: gate_head_int8(*k12, **kw12), iters),
            time_ms(lambda: gate_head_int8_plain(*k12, **kw12), 3, 1),
            bound([(n * head_ops, H100_INT8_OPS),
                   (n * 2.0 * 128 * 3, H100_BF16_FLOPS),
                   (gate_ops(b, n, d), H100_F32_FLOPS)], None,
                  3.0 * n * d + 3.0 * n * 128 * 2 + n * WINDOW * 4
                  + n * 3 * 4 + weight_bytes))
        del ref
        chain = gate_int8(zx, zx2, x, tmpl, **gkw(p_pad))
        chain += cs.head_int8(chain[0].reshape(-1, 256), w.head, head_w,
                              num_classes=1, l4=l4)
        same_bits(f"K12 vs K6 -> K7 at {p_pad} rows a stream", got, chain)
        del got, chain, x, zx, zx2, tmpl

        # K13 at 480 rows a stream, the carry from K9 on scan 0
        p_pad = -(-NUM_PTS // 32) * 32
        n = b * p_pad
        feats0, zt = cs.backbone_int8_pm(
            cutout(F.pad(scans[0], (0, p_pad - NUM_PTS)), **ckw),
            w.layer1_div, w.backbone, w.embed, l=c, in_scale=w.in_scale)
        tmpl = carried(feats0, n)
        del feats0
        cut = cutout(F.pad(scans[1], (0, p_pad - NUM_PTS)), **ckw)
        # the weights laid out once, as make_serve_step_v3 holds them
        k13 = (cut, zt, tmpl, w.layer1_div, w.backbone, cell_embed(w.embed),
               w.head, head_w)
        kw13 = dict(gkw(p_pad), l=c, in_scale=w.in_scale, num_classes=1)
        got = serve_cell_int8(*k13, **kw13)
        torch.cuda.synchronize()
        same_bits("serve_cell_int8 on the laid-out weights and on the "
                  "triples", got,
                  serve_cell_int8(cut, zt, tmpl, w.layer1_div,
                                  w.backbone.convs, w.embed, w.head.convs,
                                  head_w, **kw13))
        ref = serve_cell_int8_plain(*k13, **kw13)
        # the plain zx (float64 sums) and the kernel's (the MMA's f32 sums)
        # differ in a bf16 last bit on some rows, and inside the cell that
        # moves those rows' attention: K13 is held to its plain version at
        # JAX's own cell-vs-pm bars (z 2e-2, sim, cls and reg 5e-2), and to
        # the bit to the unfused kernels below
        record_int8(
            results, "serve_cell_int8", [(got[0], ref[0])],
            list(zip(got[1:], ref[1:])),
            time_ms(lambda: serve_cell_int8(*k13, **kw13), iters),
            time_ms(lambda: serve_cell_int8_plain(*k13, **kw13), 3, 1),
            bound([(n * (backbone_ops + head_ops), H100_INT8_OPS),
                   (n * 2.0 * (d * 128 + 128 * 3), H100_BF16_FLOPS),
                   (n * c * 64 * 8.0 + gate_ops(b, n, d),
                    H100_F32_FLOPS)], None,
                  n * c * 4.0 + 3.0 * n * d + 3.0 * n * 128 * 2
                  + n * WINDOW * 4 + n * 3 * 4 + w.embed[0].numel() * 2
                  + weight_bytes), float_tols=CELL_TOLS)
        del ref
        x, zx = cs.backbone_int8_pm(cut, w.layer1_div, w.backbone, w.embed,
                                    l=c, in_scale=w.in_scale)
        chain = gate_int8(zx, zt, x.reshape(n, d), tmpl, **gkw(p_pad))
        chain += cs.head_int8(chain[0].reshape(-1, 256), w.head, head_w,
                              num_classes=1, l4=l4)
        same_bits(f"K13 vs K9 -> K6 -> K7 at {p_pad} rows a stream", got,
                  chain)
    return results


def within_bf16_ulp(got, ref):
    """``|got - ref|`` within one bf16 spacing at the larger of the two,
    elementwise, or within 2^-17 x max|ref| where the f32 sum cancels to
    near zero (its own rounding error, not bf16's, then decides)."""
    import torch

    got, ref = got.float(), ref.float()
    top = torch.maximum(got.abs(), ref.abs())
    ulp = torch.exp2(torch.floor(torch.log2(torch.clamp(top, min=2.0 ** -126)))
                     - 7)
    floor = 2.0 ** -17 * float(ref.abs().max())
    return bool(((got - ref).abs() <= torch.clamp(ulp, min=floor)).all())


def k14_k15_kernel_phase(model, scans, device):
    """Phase 4, the kernels of the other step builders: K14 (backbone and
    head, f32 and bf16) on the module cutouts of the sanitized 450-beam
    streams, K3's f32 mode at ct=450 on K14's f32 feats, and K15 in bf16
    on those feats rounded, against its plain version and against K3's new
    template on K3's own attention. Returns (results, K15's launches)."""
    import torch

    from planar_optical_flow_tpu_torch.infer import fast_gate as fg
    from planar_optical_flow_tpu_torch.infer.streaming import (
        _encode_single, _sanitize_scan,
    )
    from planar_optical_flow_tpu_torch.ops.geometry import get_laser_phi
    from planar_optical_flow_tpu_torch.ops.kernels import fold
    from planar_optical_flow_tpu_torch.ops.kernels import fused_drow as fd

    det = model.dr_spaam
    b = scans.shape[1]
    c = CUTOUT_KW["num_cutout_pts"]
    l4 = c // 4
    n, d = b * NUM_PTS, l4 * 256
    phi = get_laser_phi(num_pts=NUM_PTS)
    w_bb = fd.backbone_weights(det.backbone)
    w_hd = fd.head_weights(det.head)
    results = {}
    bb_ops = 2.0 * n * (c * 3 * (64 + 64 * 64 + 64 * 128)
                        + (c // 2) * 3 * (2 * 128 * 128 + 128 * 256))
    hd_ops = 2.0 * n * (l4 * 3 * (2 * 256 * 256 + 256 * 512)
                        + (l4 // 2) * 3 * (512 * 256 + 256 * 128) + 128 * 3)

    def w_bytes(weights, dt_bytes):
        return sum(w.numel() * dt_bytes + bb.numel() * 4 for w, bb in weights)

    def record_f32(name, pairs, ms, plain_ms, ops, nbytes):
        """Each output within rtol * |plain| + atol * max|plain|. The bound
        is split bf16's (three bf16 products for each f32 one, the kernel's
        route and the least time the card takes for the f32 work at the
        bar); the 3xTF32 and FFMA bounds beside it."""
        rtol, atol = TOL_K14_F32
        errs = [max_err(g, r) for g, r in pairs]
        ok = all(bool(((g - r).abs() <= rtol * r.abs()
                       + atol * float(r.abs().max())).all())
                 for g, r in pairs)
        bound_pair = bound(3 * ops, H100_BF16_FLOPS, nbytes)
        tf32 = bound(3 * ops, H100_TF32_FLOPS, nbytes)
        ffma = bound(ops, H100_F32_FLOPS, nbytes)
        print(f"[kernel] {name}: max_abs_err={max(errs):.3e} (rtol {rtol}, "
              f"atol {atol} x max) ms={ms:.4f} plain_ms={plain_ms:.3f} "
              f"bound_ms={bound_pair[0]:.4f} ({bound_pair[1]}; split bf16: "
              f"3 x ops at {H100_BF16_FLOPS / 1e12:.0f} TFLOP/s) "
              f"tf32x3_bound_ms={tf32[0]:.4f} ({tf32[1]}; 3 x ops at "
              f"{H100_TF32_FLOPS / 1e12:.0f} TFLOP/s) ffma_bound_ms="
              f"{ffma[0]:.4f} ({ffma[1]}; ops at {H100_F32_FLOPS / 1e12:.0f} "
              f"TFLOP/s) {'ok' if ok else 'MISMATCH'}", flush=True)
        check(ok, f"{name} kernel disagrees with its plain version")
        results[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_pair[0], bound_by=bound_pair[1])

    # the weights laid out once, as make_fused_stream_step holds them
    laid = {torch.float32: (fd.backbone_weights_f32(w_bb),
                            fd.head_weights_f32(w_hd)),
            torch.bfloat16: (fd.backbone_weights_bf16(w_bb),
                             fd.head_weights_bf16(w_hd))}
    with torch.inference_mode():
        cut = _encode_single(_sanitize_scan(scans[0], CUTOUT_KW["padding_val"]),
                             phi, CUTOUT_KW).reshape(n, c)
        feats = {}
        for name, dt, iters in (("fused_backbone", torch.float32, F32_ITERS),
                                ("fused_backbone_bf16", torch.bfloat16,
                                 TIMED_ITERS)):
            wk = laid[dt][0]
            got = fd.fused_backbone(cut, wk, compute_dtype=dt)
            torch.cuda.synchronize()
            same_bits(f"{name} on the laid-out weights and on the pairs",
                      (got,), (fd.fused_backbone(cut, w_bb,
                                                 compute_dtype=dt),))
            ref = fd.fused_backbone_plain(cut, w_bb, compute_dtype=dt)
            nbytes = (n * c * 4.0 + n * d * 4.0
                      + w_bytes(w_bb, dt.itemsize))
            args = (time_ms(lambda: fd.fused_backbone(cut, wk,
                                                      compute_dtype=dt),
                            iters, 1),
                    time_ms(lambda: fd.fused_backbone_plain(
                        cut, w_bb, compute_dtype=dt), 1, 1))
            if dt == torch.float32:
                record_f32(name, [(got, ref)], *args, bb_ops, nbytes)
            else:
                record_int8(results, name, [], [(got, ref)], *args,
                            bound(bb_ops, H100_BF16_FLOPS, nbytes))
            feats[dt] = got
            del ref

        for name, dt, iters in (("fused_head", torch.float32, F32_ITERS),
                                ("fused_head_bf16", torch.bfloat16,
                                 TIMED_ITERS)):
            f, wk = feats[dt], laid[dt][1]
            got = fd.fused_head(f, wk, compute_dtype=dt)
            torch.cuda.synchronize()
            same_bits(f"{name} on the laid-out weights and on the pairs",
                      got, fd.fused_head(f, w_hd, compute_dtype=dt))
            ref = fd.fused_head_plain(f, w_hd, compute_dtype=dt)
            nbytes = n * d * 4.0 + n * 3 * 4.0 + w_bytes(w_hd, dt.itemsize)
            args = (time_ms(lambda: fd.fused_head(f, wk, compute_dtype=dt),
                            iters, 1),
                    time_ms(lambda: fd.fused_head_plain(f, w_hd,
                                                        compute_dtype=dt),
                            1, 1))
            pairs = list(zip(got, ref))
            if dt == torch.float32:
                record_f32(name, pairs, *args, hd_ops, nbytes)
            else:
                record_int8(results, name, [], pairs, *args,
                            bound(hd_ops, H100_BF16_FLOPS, nbytes))
        del feats[torch.bfloat16]

        # K3 f32 at ct=450: scan 0's f32 feats, scan 1's as the template
        gp = fold.fold_gate_params(det.gate)
        x = feats[torch.float32].reshape(n, d)
        cut1 = _encode_single(_sanitize_scan(scans[1],
                                             CUTOUT_KW["padding_val"]),
                              phi, CUTOUT_KW).reshape(n, c)
        t = fd.fused_backbone(cut1, laid[torch.float32][0],
                              compute_dtype=None).reshape(n, d)
        del cut1, feats
        zx, zt = fg.embed(gp, x), fg.embed(gp, t)
        gkw = dict(ct=NUM_PTS, alpha=gp.alpha, window_size=gp.window_size)
        got = fg.gate(zx, zt, x, t, **gkw)
        torch.cuda.synchronize()
        ref = fg.gate_plain(zx, zt, x, t, **gkw)
        ok = all(bool(torch.allclose(g, r, rtol=tol, atol=tol))
                 for g, r, tol in zip(got, ref, K3_F32_TOLS))
        errs = [max_err(g, r) for g, r in zip(got, ref)]
        k3 = (time_ms(lambda: fg.gate(zx, zt, x, t, **gkw), TIMED_ITERS),
              time_ms(lambda: fg.gate_plain(zx, zt, x, t, **gkw), 1, 1),
              bound(gate_ops(b, n, d), H100_F32_FLOPS,
                    3.0 * n * d * 4 + 3.0 * n * 128 * 4 + n * WINDOW * 4))
        print(f"[kernel] gate_f32 at ct={NUM_PTS}: max_abs_err="
              f"{[float(f'{e:.3e}') for e in errs]} tols={K3_F32_TOLS} "
              f"ms={k3[0]:.4f} plain_ms={k3[1]:.3f} bound_ms={k3[2][0]:.4f} "
              f"({k3[2][1]}) {'ok' if ok else 'MISMATCH'}", flush=True)
        check(ok, "gate_f32 kernel disagrees with its plain version")
        results["gate_f32"] = dict(max_abs_err=max(errs), ms=k3[0],
                                   plain_ms=k3[1], bound_ms=k3[2][0],
                                   bound_by=k3[2][1])
        del got, ref

        # K3 in bf16 at ct=450 (the serve bf16 path's rows) on the same
        # rows, its new template to the bit; K15 in bf16 on K3's own
        # attention
        gp16 = fold.fold_gate_params(det.gate, dtype=torch.bfloat16)
        x16, t16 = x.to(torch.bfloat16), t.to(torch.bfloat16)
        del x, t, zx, zt
        zx16, zt16 = fg.embed(gp16, x16), fg.embed(gp16, t16)
        kw16 = dict(ct=NUM_PTS, alpha=gp.alpha, window_size=WINDOW)
        k3_t = fg.gate(zx16, zt16, x16, t16, **kw16)[0]
        torch.cuda.synchronize()
        attn = k3_bits(f"gate at ct={NUM_PTS}", k3_t,
                       fg.gate_plain(zx16, zt16, x16, t16, **kw16)[0], zx16,
                       zt16, x16, t16, kw16)
        k3_t = k3_t.reshape(b, NUM_PTS, d)
        x3, t3 = x16.reshape(b, NUM_PTS, d), t16.reshape(b, NUM_PTS, d)
        fg.banded_mix_update.launches = 0
        got = fg.banded_mix_update(attn, x3, t3, gp.alpha, WINDOW)
        torch.cuda.synchronize()
        launches = fg.banded_mix_update.launches
        ref = fg.banded_mix_update_plain(attn, x3, t3, gp.alpha, WINDOW)
        ok_plain, ok_k3 = torch.equal(got, ref), within_bf16_ulp(got, k3_t)
        err = max_err(got, ref)
        k15 = (time_ms(lambda: fg.banded_mix_update(attn, x3, t3, gp.alpha,
                                                    WINDOW), TIMED_ITERS),
               time_ms(lambda: fg.banded_mix_update_plain(
                   attn, x3, t3, gp.alpha, WINDOW), 1, 1),
               bound(2.0 * WINDOW * n * d + 3.0 * n * d, H100_F32_FLOPS,
                     3.0 * n * d * 2 + n * WINDOW * 4))
        print(f"[kernel] banded_mix (K15) at ({b}, {NUM_PTS}, {d}) bf16: "
              f"max_abs_err={err:.3e} equal to its plain version to the bit: "
              f"{ok_plain}; within 1 bf16 ulp of K3's new template on K3's "
              f"attention: {ok_k3} (max diff {max_err(got, k3_t):.3e}) "
              f"ms={k15[0]:.4f} plain_ms={k15[1]:.3f} bound_ms="
              f"{k15[2][0]:.4f} ({k15[2][1]})", flush=True)
        check(ok_plain, "K15 differs from its plain version")
        check(ok_k3, "K15 disagrees with K3's mix on the same attention")
        results["banded_mix"] = dict(max_abs_err=err, ms=k15[0],
                                     plain_ms=k15[1], bound_ms=k15[2][0],
                                     bound_by=k15[2][1])
    return results, launches


def compare_engines(got, ref, step, label="slice"):
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
        print(f"[{label}] step {step} {k}: corr={corr:.5f} "
              f"max_diff={diff:.4g} lim={lim:.4g}", flush=True)
        check(corr > 0.99 and diff < lim,
              f"{label} step {step} {k}: vs module corr {corr} diff {diff}")


def compare_int8c(got, ref, step, bar=CORR_INT8, label="int8c"):
    """The JAX int8-vs-f32 bars (tests/test_fast_gate.py): corr > ``bar``
    on cls and flow; every float output finite."""
    import torch

    for k in ("pred_cls", "pred_reg", "pred_flow"):
        a, r = got[k].float(), ref[k].float()
        check(a.shape == r.shape, f"{label} step {step} {k} shape")
        check(bool(torch.isfinite(a).all()), f"{label} step {step} {k} not "
              "finite")
        corr = float(torch.corrcoef(torch.stack([a.ravel(), r.ravel()]))[0, 1])
        print(f"[slice-{label}] step {step} {k}: corr={corr:.5f} "
              f"max_diff={float((a - r).abs().max()):.4g}", flush=True)
        if k != "pred_reg":
            check(corr > bar, f"{label} step {step} {k}: corr {corr}")


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


def check_outputs(out, b, what, slots=64):
    """Every output of the serving contract, of its shape (``slots``
    detection slots: 64 for the top-64 NMS, NUM_PTS for the full one);
    float ones finite."""
    import torch

    shapes = {"pred_cls": (b, NUM_PTS, 1), "pred_reg": (b, NUM_PTS, 2),
              "pred_flow": (b, NUM_PTS, 2), "det_xys": (b, slots, 2),
              "det_cls": (b, slots, 1), "det_keep": (b, slots),
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
    check(launches_v3["backbone_tail"] == 0, "the v3 path read a layer-1 "
          "activation (backbone_tail) instead of K2's own layer 1")
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


def layouts_slice_phase(model, scans, device, calib):
    """Phase 5, the configurations of ``make_serve_step_v3`` in
    ``LAYOUTS``, each built and run (1 bootstrap + 5 carried steps) with
    every launch counter set to 0 just before and read just after, against
    the f32 module step on the same scans, and held to its exact launch
    counts and, where ``LAYOUTS`` names one, to the bit to an earlier run's
    valid rows. Returns ({config: launches}, {config: step ms})."""
    import torch

    from planar_optical_flow_tpu_torch.infer.streaming import (
        make_serve_step_v3, make_stream_step,
    )
    from planar_optical_flow_tpu_torch.ops.kernels import conv_stack

    b = scans.shape[1]
    ref_step = make_stream_step(model, CUTOUT_KW, NUM_PTS, with_nms=False,
                                device=device)
    refs, tmpl = [], None
    for scan in scans:
        tmpl, out = ref_step(tmpl, scan)
        refs.append({k: out[k] for k in ("pred_cls", "pred_reg",
                                         "pred_flow")})
    del tmpl, ref_step
    torch.cuda.empty_cache()

    def valid(carry):
        return {k: v.reshape(b, -1, v.shape[-1])[:, :NUM_PTS].clone()
                for k, v in carry.items()}

    references = {ref for _, _, ref in LAYOUTS.values() if ref}
    all_launches, all_ms, kept = {}, {}, {}
    for name, (opts, counts, ref) in LAYOUTS.items():
        for wr in wrappers().values():
            wr.launches = 0
        # the K16 check runs once per device and process: forget that it
        # ran, so that each configuration's build runs it again
        conv_stack._ROW_SHIFT_OK.clear()
        step = make_serve_step_v3(model, CUTOUT_KW, calib=calib,
                                  num_pts=NUM_PTS, device=device, **opts)
        carry, step_ms, steps = None, [], []
        for i, scan in enumerate(scans):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry, out = step(carry, scan)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            check_outputs(out, b, f"{name} step {i}")
            compare_int8c(out, refs[i], i, CORR_INT8_STACKS if name == "int8"
                          else CORR_INT8, name)
            if name in references or ref:
                steps.append((valid(carry), out))
            if ref:
                ref_carry, ref_out = kept[ref][i]
                got_carry, got_out = steps[-1]
                same = (all(torch.equal(got_carry[k], ref_carry[k])
                            for k in ref_carry)
                        and all(torch.equal(got_out[k], ref_out[k])
                                for k in ref_out))
                check(same, f"{name} and {ref} differ at step {i}")
        launches = {k: wr.launches for k, wr in wrappers().items()}
        print(f"[slice-{name}] launches during the {name} run: "
              f"{json.dumps(launches)}", flush=True)
        want = dict.fromkeys(launches, 0)
        want.update(counts, row_shift=1)
        check(launches == want, f"{name} launches {launches}, expected "
              f"{want}")
        want_dtype = torch.bfloat16 if name == "int8" else torch.int8
        check(carry["template"].dtype == want_dtype, f"{name} carry dtype")
        if ref:
            print(f"[slice-{name}] int8c {name} and {ref}: carries and "
                  f"outputs bit-identical on the valid rows for "
                  f"{len(scans)} steps", flush=True)
        if name in references:
            kept[name] = steps
        all_launches[name], all_ms[name] = launches, step_ms
        del step, carry, out, steps
        torch.cuda.empty_cache()
    return all_launches, all_ms


def engines_slice_phase(model, scans, device, calib):
    """Phase 5, the other step builders on the sanitized scans (the fused
    step does not sanitize, as in JAX), each built and run (1 bootstrap + 5
    carried steps) with every launch counter set to 0 just before and read
    just after, held to its exact launch counts and to the f32 module step.
    Returns ({run: launches}, {run: step ms})."""
    import torch

    from planar_optical_flow_tpu_torch.infer import streaming as st
    from planar_optical_flow_tpu_torch.ops.kernels import conv_stack

    clean = st._sanitize_scan(scans, CUTOUT_KW["padding_val"])
    b = scans.shape[1]
    ref_step = st.make_stream_step(model, CUTOUT_KW, NUM_PTS, device=device)
    refs, tmpl = [], None
    for scan in clean:
        tmpl, out = ref_step(tmpl, scan)
        refs.append({k: out[k] for k in ("pred_cls", "pred_reg", "pred_flow",
                                         "det_keep")})
    del tmpl, ref_step
    torch.cuda.empty_cache()

    def fused_f32(out, ref, i, name):
        for k in ("pred_cls", "pred_reg", "pred_flow"):
            diff = float((out[k] - ref[k]).abs().max())
            print(f"[slice-{name}] step {i} {k}: max_diff={diff:.4g} "
                  f"(atol {TOL_FUSED_F32})", flush=True)
            check(diff <= TOL_FUSED_F32, f"{name} step {i} {k}: {diff}")
        agree = float((out["det_keep"] == ref["det_keep"]).float().mean())
        print(f"[slice-{name}] step {i} det_keep agreement {agree:.5f}",
              flush=True)
        check(agree > KEEP_AGREE, f"{name} step {i} det_keep {agree}")

    def serve_f32(out, ref, i, name):
        for k in ("pred_cls", "pred_reg", "pred_flow"):
            ok = bool(torch.allclose(out[k], ref[k], rtol=TOL_SERVE_F32,
                                     atol=TOL_SERVE_F32))
            print(f"[slice-{name}] step {i} {k}: max_diff="
                  f"{float((out[k] - ref[k]).abs().max()):.4g} "
                  f"(rtol = atol = {TOL_SERVE_F32}) {'ok' if ok else 'FAIL'}",
                  flush=True)
            check(ok, f"{name} step {i} {k} beyond {TOL_SERVE_F32}")

    def quantized(out, ref, i, name):
        for k in ("pred_cls", "pred_reg", "pred_flow"):
            check(bool(torch.isfinite(out[k]).all()), f"{name} {k} finite")
        mean = float((out["pred_cls"] - ref["pred_cls"]).abs().mean())
        print(f"[slice-{name}] step {i} mean |pred_cls - module| = "
              f"{mean:.4g} (bar {QUANT_MEAN})", flush=True)
        check(mean < QUANT_MEAN, f"{name} step {i} mean diff {mean}")

    def bf16(out, ref, i, name):
        compare_engines(out, ref, i, f"slice-{name}")

    kw = dict(num_pts=NUM_PTS, device=device)
    runs = {
        "fused": (lambda: st.make_fused_stream_step(model, CUTOUT_KW, **kw),
                  dict(fused_backbone=6, fused_head=6), fused_f32),
        "fused_bf16": (lambda: st.make_fused_stream_step(
            model, CUTOUT_KW, compute_dtype=torch.bfloat16, **kw),
            dict(fused_backbone=6, fused_head=6), bf16),
        "serve_bf16": (lambda: st.make_serve_step(model, CUTOUT_KW, **kw),
                       dict(gate=5), bf16),
        "serve_f32": (lambda: st.make_serve_step(
            model, CUTOUT_KW, compute_dtype=None, **kw), dict(gate=5),
            serve_f32),
        "quantized": (lambda: st.make_quantized_stream_step(
            model, CUTOUT_KW, clean[0][:CALIB_SCANS], **kw), {}, quantized),
    }
    all_launches, all_ms = {}, {}
    for name, (build, counts, compare) in runs.items():
        for wr in wrappers().values():
            wr.launches = 0
        step = build()
        carry, step_ms = None, []
        for i, scan in enumerate(clean):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry, out = step(carry, scan)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            check_outputs(out, b, f"{name} step {i}", slots=NUM_PTS)
            compare(out, refs[i], i, name)
        launches = {k: wr.launches for k, wr in wrappers().items()}
        print(f"[slice-{name}] launches during the {name} run: "
              f"{json.dumps(launches)}", flush=True)
        want = dict.fromkeys(launches, 0)
        want.update(counts)
        check(launches == want, f"{name} launches {launches}, expected "
              f"{want}")
        all_launches[name], all_ms[name] = launches, step_ms
        del step, carry, out
        torch.cuda.empty_cache()

    # the int8c p2 step as a sequence processor: equal to the bit to the
    # per-step run, carry and every output
    step = st.make_serve_step_v3(model, CUTOUT_KW, calib=calib,
                                 precision="int8c", **kw)
    carry, outs = None, []
    for scan in scans:
        carry, out = step(carry, scan)
        outs.append(out)
    for wr in wrappers().values():
        wr.launches = 0
    conv_stack._ROW_SHIFT_OK.clear()  # the build runs the K16 check again
    process = st.make_serve_sequence_processor(
        model, CUTOUT_KW, output_fields=None, calib=calib, precision="int8c",
        **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    end, stacked = process(scans)
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: wr.launches for k, wr in wrappers().items()}
    same = (all(torch.equal(end[k], carry[k]) for k in carry)
            and all(torch.equal(stacked[k][t], o[k])
                    for t, o in enumerate(outs) for k in o))
    print(f"[slice-sequence] make_serve_sequence_processor (int8c p2) over "
          f"{len(scans)} scans: {seq_ms:.1f} ms, launches "
          f"{json.dumps(launches)}; equal to the per-step run: {same}",
          flush=True)
    check(same, "the sequence processor differs from the per-step run")
    want = dict.fromkeys(launches, 0)
    want.update(cutout=6, backbone_int8=6, gate_int8=6, head_int8=6,
                row_shift=1)
    check(launches == want, f"sequence launches {launches}")
    all_launches["sequence"] = launches
    return all_launches, all_ms


# the "files" phase: the flagship config with the keys of
# configs/dr_spaam.yaml (written as JSON: the card's machine may have no
# PyYAML), a synthetic val split of FILES_SEQS x FILES_FRAMES 450-beam
# frames, the evaluators at FILES_BATCH frames a step
FLAGSHIP_CFG = {
    "tag": "", "epochs": 50, "batch_size": 8, "grad_norm_clip": 0.0,
    "num_workers": 0, "num_scans": 10, "use_data_augumentation": False,
    "train_with_val": True, "focal_loss_gamma": 0.0,
    "pedestrian_only": True, "compute_dtype": "bfloat16",
    "data_dir": "./data/DROWv2-data", "log_dir": "./logs",
    "network": "cutout_spatial",
    "similarity_kwargs": {"alpha": 0.5, "window_size": WINDOW},
    "cutout_kwargs": CUTOUT_KW,
    "polar_grid_kwargs": {"min_range": 0.0, "max_range": 30.0,
                          "range_bin_size": 0.1, "tsdf_clip": 1.0,
                          "normalize": True},
}
FILES_SEQS, FILES_FRAMES = 4, 200
FILES_BATCH = 64
FILES_FIRST = 100       # frames of the batch-1 module check
TOL_AP_LOOP = 1e-6      # batched module vs its runner loop (JAX's bar)
TOL_TARGETS = 1e-5      # the dataset's float targets, card vs CPU
# every plain version of a kernel: none may run on the card
PLAIN = {
    "ops.kernels.cutout_kernel": ("cutout_plain",),
    "ops.kernels.conv_stack": (
        "backbone_tail_plain", "head_plain", "backbone_bf16_plain",
        "backbone_int8_plain", "backbone_int8_pm_plain",
        "backbone_int8_tail_plain", "head_int8_plain",
        "backbone_int8_cut_plain", "row_shift_plain"),
    "infer.fast_gate": ("gate_plain", "gate_int8_plain",
                        "gate_head_int8_plain", "banded_mix_update_plain",
                        "_band_attention", "_banded_mix_xla"),
    "ops.kernels.serve_cell": ("serve_cell_int8_plain",),
    "ops.kernels.fused_drow": ("fused_backbone_plain", "fused_head_plain"),
}
# the plain band attention also gives a stream's first scan its
# self-similarity (``gate_bootstrap``, which has no kernel in the JAX
# package either): it may run once for each bootstrap, and no more
BOOTSTRAP = ("infer.streaming", "gate_bootstrap", "_band_attention")


@contextlib.contextmanager
def counting_plain():
    """Every plain version of :data:`PLAIN`, and the bootstrap of
    :data:`BOOTSTRAP`, replaced in its module's namespace (where its
    callers look it up) by a counting call of itself. Yields a function
    that returns the calls of plain versions so far, by name, less those
    the bootstraps made."""
    import importlib

    saved, calls = {}, {}
    for mod, names in (*PLAIN.items(), (BOOTSTRAP[0], BOOTSTRAP[1:2])):
        m = importlib.import_module(f"planar_optical_flow_tpu_torch.{mod}")
        for name in names:
            saved[(m, name)] = fn = getattr(m, name)
            calls[name] = 0

            def counted(*args, _fn=fn, _name=name, **kwargs):
                calls[_name] += 1
                return _fn(*args, **kwargs)

            setattr(m, name, counted)
    def plain_calls():
        out = dict(calls)
        out[BOOTSTRAP[2]] -= out.pop(BOOTSTRAP[1])
        return out

    try:
        yield plain_calls
    finally:
        for (m, name), fn in saved.items():
            setattr(m, name, fn)


def timed(step, events):
    """``step`` with each call between two CUDA events appended to
    ``events`` (host gaps inside the call included)."""
    import torch

    def run(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*args)
        end.record()
        events.append((start, end))
        return out

    return run


def host_seconds(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` between two device synchronizations -> (its
    result, its seconds on the host clock)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(events):
    import torch

    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


class _FirstFrames:
    """The first ``n`` samples of a detection dataset, as
    ``evaluate_detection_ap`` reads one."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n
        self.scans_flat, self.cur_idx = ds.scans_flat, ds.cur_idx[:n]

    def __len__(self):
        return self.n

    def gt_centers(self, i):
        return self.ds.gt_centers(i)


def same_frames(what, got, ref):
    """Per-frame CLI results equal to the bit."""
    check(len(got) == len(ref), f"{what}: {len(got)} vs {len(ref)} frames")
    for i, (g, r) in enumerate(zip(got, ref)):
        for k in ("dets", "conf", "flow"):
            check(g[k].dtype == r[k].dtype and np.array_equal(g[k], r[k]),
                  f"{what}: frame {i} {k} differs")


def pool_matches(captured):
    """Every frame's matched pool of the device matcher against
    ``detection_ap.match_detections`` on the same detections
    (``evaluator.match_frames``). Returns the frames checked."""
    from planar_optical_flow_tpu_torch.eval import evaluator

    args, got = captured
    want = evaluator.match_frames(*args)
    check(all(np.array_equal(g.cpu().numpy(), w) for g, w in zip(got, want)),
          "device matcher: a frame's pool differs from match_detections")
    return int(args[5].sum())


def files_phase(model, device, seed, card):
    """The ``[files]`` phase: the serving CLI and the serving evaluators
    from files on the card, at the flagship working point."""
    from planar_optical_flow_tpu_torch.data import (
        list_sequences, write_synthetic_drow_split,
    )
    from planar_optical_flow_tpu_torch.interop.checkpoint import save_weights
    from planar_optical_flow_tpu_torch.pipeline import normalize_config
    from planar_optical_flow_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    root = os.path.join(BUILD_DIR, "files")
    weights = save_weights(model, os.path.join(root, "weights.pt"))
    cfg_path = os.path.join(root, "dr_spaam.json")
    with open(cfg_path, "w") as f:
        json.dump(FLAGSHIP_CFG, f, indent=1)
    cfg = normalize_config(load_config(cfg_path))
    try:
        import yaml  # noqa: F401
    except ImportError:
        note = "PyYAML not installed: configs/dr_spaam.yaml not read"
    else:
        yaml_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "configs", "dr_spaam.yaml")
        check(normalize_config(load_config(yaml_path)) == cfg,
              "configs/dr_spaam.yaml and the JSON config differ")
        note = "equal to normalize_config(load_config(configs/dr_spaam.yaml))"
    check(cfg["model"]["type"] == "flow_drow", "flagship model type")
    print(f"[files] weights {weights}, config {cfg_path}: {note}; {card}",
          flush=True)

    t0 = time.perf_counter()
    data = os.path.join(root, "drow")
    write_synthetic_drow_split(data, "val", num_sequences=FILES_SEQS,
                               num_frames=FILES_FRAMES, seed=seed,
                               num_pts=NUM_PTS)
    stem = list_sequences(data, "val")[0]
    print(f"[files] split: {FILES_SEQS} x {FILES_FRAMES} frames of {NUM_PTS} "
          f"beams written in {time.perf_counter() - t0:.2f} s; {card}",
          flush=True)

    with counting_plain() as plain_calls:
        _files_checks(model, device, card, cfg, cfg_path, weights, stem,
                      data, root)
        calls = plain_calls()
    check(not any(calls.values()), f"a plain version ran on the card: "
          f"{json.dumps({k: v for k, v in calls.items() if v})}")
    print(f"[files] no plain version of a kernel ran in the phase; the "
          f"phase took {time.perf_counter() - t_phase:.1f} s on {card}",
          flush=True)


def _files_checks(model, device, card, cfg, cfg_path, weights, stem, data,
                  root):
    """Steps 3-6 of the ``[files]`` phase."""
    import torch

    from planar_optical_flow_tpu_torch.cli import infer as infer_cli
    from planar_optical_flow_tpu_torch.data import DrowDetectionDataset
    from planar_optical_flow_tpu_torch.eval import evaluator
    from planar_optical_flow_tpu_torch.infer.streaming import StreamingRunner

    ckw = cfg["dataset"]["cutout_kwargs"]

    # 3. the serving CLI on one sequence
    def cli(*extra):
        for w in wrappers().values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, frames, loop_s = infer_cli.infer(
            ["--cfg", cfg_path, "--ckpt", weights, "--sequence",
             stem + ".csv", *extra])
        total = time.perf_counter() - t0
        check(rc == 0 and len(frames) == FILES_FRAMES, f"cli {extra}: rc "
              f"{rc}, {len(frames)} frames")
        launches = {k: w.launches for k, w in wrappers().items()}
        return frames, loop_s, total, launches

    calib_dir = os.path.join(root, "calib")
    os.makedirs(calib_dir, exist_ok=True)
    first, s_int8, tot, launches = cli("--engine", "int8c", "--save-calib",
                                       calib_dir)
    for k in INT8C_KERNELS:
        check(launches[k] > 0, f"the int8c CLI run did not launch {k}")
    for k in set(V3_KERNELS) - set(INT8C_KERNELS):
        check(launches[k] == 0, f"bf16 kernel {k} ran on the int8c CLI run")
    print(f"[files] cli int8c --save-calib: {FILES_FRAMES} frames, "
          f"{FILES_FRAMES / s_int8:.1f} frames/s per frame ({s_int8:.3f} s "
          f"of frame loop, {tot:.2f} s in all); launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}; "
          f"{sum(len(f['dets']) for f in first)} detections; {card}",
          flush=True)
    again, s_calib, _, _ = cli("--engine", "int8c", "--calib", calib_dir)
    same_frames("cli int8c --calib", again, first)
    replay, s_replay, _, launches = cli("--engine", "int8c", "--calib",
                                        calib_dir, "--replay")
    same_frames("cli int8c --replay", replay, first)
    for k in INT8C_KERNELS:
        check(launches[k] > 0, f"the int8c --replay run did not launch {k}")
    print(f"[files] cli int8c --calib: identical detections, "
          f"{FILES_FRAMES / s_calib:.1f} frames/s per frame; --replay: "
          f"identical, {FILES_FRAMES / s_replay:.1f} frames/s; {card}",
          flush=True)
    v3, s_v3, _, launches = cli("--engine", "v3")
    for k in V3_KERNELS:
        check(launches[k] > 0, f"the v3 CLI run did not launch {k}")
    v3_replay, s_v3_replay, _, _ = cli("--engine", "v3", "--replay")
    same_frames("cli v3 --replay", v3_replay, v3)
    print(f"[files] cli v3: {FILES_FRAMES / s_v3:.1f} frames/s per frame, "
          f"--replay {FILES_FRAMES / s_v3_replay:.1f} (identical); "
          f"{sum(len(f['dets']) for f in v3)} detections; {card}",
          flush=True)

    # 4. the dataset's targets on the card against the CPU's
    kw = dict(num_scans=cfg["dataset"]["num_scans"],
              pedestrian_only=cfg["dataset"]["pedestrian_only"])
    t0 = time.perf_counter()
    ds = DrowDetectionDataset(data, "val", device=device, **kw)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = DrowDetectionDataset(data, "val", device="cpu", **kw)
    t_cpu = time.perf_counter() - t0
    for k in ("target_cls", "exclude_mask"):
        check(getattr(ds, k).dtype == getattr(ref, k).dtype
              and np.array_equal(getattr(ds, k), getattr(ref, k)),
              f"dataset {k}: card and CPU differ in "
              f"{int((getattr(ds, k) != getattr(ref, k)).sum())} points")
    errs = {k: float(np.abs(getattr(ds, k) - getattr(ref, k)).max())
            for k in ("target_reg", "target_flow")}
    check(max(errs.values()) <= TOL_TARGETS, f"dataset targets {errs}")
    print(f"[files] dataset: {len(ds)} samples of {kw['num_scans'] + 1} "
          f"scans, built in {t_card:.2f} s (targets on the card), "
          f"{t_cpu:.2f} s on the CPU; cls and exclude mask equal, max err "
          f"{json.dumps(errs)}; {card}", flush=True)

    # 5. detection AP, every engine, FILES_BATCH frames a step: each step
    # built (and timed) first, then handed to the evaluator
    steps = -(-len(ds) // FILES_BATCH)
    all_frames = evaluator.DetectionEvalFrames.from_dataset(ds)
    orig = evaluator.match_batched
    for engine in ("module", "v3", "int8c"):
        step, build_s = host_seconds(
            evaluator.make_ap_step, model, ckw, engine, NUM_PTS,
            calib_scans=all_frames.scans[:8], device=device)
        events, captured = [], []

        def spy(*args):
            out = orig(*args)
            captured.append((args, out))
            return out

        evaluator.match_batched = spy
        try:
            res, took = host_seconds(
                evaluator.evaluate_detection_ap_batched, model, ckw,
                all_frames, batch_streams=FILES_BATCH,
                step=timed(step, events), device=device)
        finally:
            evaluator.match_batched = orig
        check(res["num_frames"] == len(ds) and 0.0 <= res["ap"] <= 1.0,
              f"AP {engine}: {res}")
        check(len(captured) == 1, "one matcher call")
        n = pool_matches(captured[0])
        ms = event_ms(events)
        check(len(ms) == steps, f"AP {engine}: {len(ms)} steps")
        med = float(np.median(ms))
        print(f"[files] ap {engine}: ap {res['ap']:.6f}, peak_f1 "
              f"{res['peak_f1']:.6f}, eer {res['eer']:.6f} (random "
              f"weights); the step build {build_s:.3f} s (with its "
              f"calibration); {res['num_frames']} frames in {steps} steps "
              f"of {FILES_BATCH}: the call {took:.3f} s = "
              f"{res['num_frames'] / took:.1f} frames/s, a step median "
              f"{med:.3f} ms (first {ms[0]:.3f}) = "
              f"{FILES_BATCH / med * 1e3:.1f} frames/s; pool equal to "
              f"match_detections on all {n} frames; {card}", flush=True)
    first_n = _FirstFrames(ds, FILES_FIRST)
    frames = evaluator.DetectionEvalFrames(
        ds.scans_flat[ds.cur_idx[:FILES_FIRST]],
        [ds.gt_centers(i) for i in range(FILES_FIRST)])
    batched = evaluator.evaluate_detection_ap_batched(
        model, ckw, frames, batch_streams=1, engine="module", device=device)
    loop = evaluator.evaluate_detection_ap(
        StreamingRunner(model, ckw, num_pts=NUM_PTS, engine="module",
                        device=device), first_n)
    check(batched["num_frames"] == loop["num_frames"] == FILES_FIRST
          and abs(batched["ap"] - loop["ap"]) <= TOL_AP_LOOP,
          f"batched module AP {batched} vs its runner loop {loop}")
    print(f"[files] ap module, batch 1, first {FILES_FIRST} frames: batched "
          f"{batched['ap']:.9f}, runner loop {loop['ap']:.9f} (bar "
          f"{TOL_AP_LOOP}); {card}", flush=True)

    # 6. flow through the serving engines: the runner built (and timed)
    # as the evaluator builds it, one batch's steps timed on it, then the
    # evaluator's call with its calibration
    n_eval = len(ds) // FILES_BATCH * FILES_BATCH
    first = ds.batch(np.arange(FILES_BATCH))["scans"]
    for engine in ("module", "int8c"):
        runner, build_s = host_seconds(
            StreamingRunner, model, ckw, num_pts=NUM_PTS, with_nms=False,
            engine=engine, calib_scans=(first[:, -1] if engine == "int8c"
                                        else None), device=device)
        events = []
        run = timed(runner, events)
        scans = torch.as_tensor(first, device=device)
        for t in range(scans.shape[1]):
            run(scans[:, t])
        ms = event_ms(events)
        med = float(np.median(ms))
        res, took = host_seconds(
            evaluator.evaluate_flow_serving, model, ckw, ds, engine=engine,
            calib=runner.calibration, num_pts=NUM_PTS,
            batch_streams=FILES_BATCH, device=device)
        check(math.isfinite(res["epe"]) and math.isfinite(res["aae"])
              and res["num_frames"] == n_eval
              and res["frames_dropped"] == len(ds) - n_eval,
              f"flow {engine}: {res}")
        print(f"[files] flow {engine}: epe {res['epe']:.6f}, aae "
              f"{res['aae']:.6f} (random weights); the runner build "
              f"{build_s:.3f} s (with its calibration); {res['num_frames']} "
              f"frames ({res['frames_dropped']} dropped), "
              f"{kw['num_scans'] + 1} steps of {FILES_BATCH} a batch: the "
              f"call with that calibration {took:.3f} s = "
              f"{res['num_frames'] / took:.1f} frames/s, a step of the "
              f"first batch median {med:.3f} ms (first {ms[0]:.3f}) = "
              f"{FILES_BATCH / med * 1e3:.1f} scans/s; {card}", flush=True)


# the "train" phase: the flagship config (epochs cut to 1) on a synthetic
# split of TRAIN_SEQS x TRAIN_FRAMES train and 1 x VAL_FRAMES val frames
TRAIN_SEQS, TRAIN_FRAMES, VAL_FRAMES = 2, 20, 12
TRAIN_STOP = 2          # steps before the preemption


def train_launches(num_scans):
    """The launches a train step makes (cutout K1, backbone_bf16 K2, gate
    K3, head K4) on each run; the fused task runs K3 once a carried scan."""
    return {
        "detector": dict(cutout=1, backbone_bf16=0, gate=0, head=0),
        "flow_module": dict(cutout=1, backbone_bf16=0, gate=0, head=0),
        "flow_fused": dict(cutout=1, backbone_bf16=1, gate=num_scans,
                           head=0),
    }


def train_wrappers():
    """The wrappers of the kernels a train step may launch (K1-K4)."""
    from planar_optical_flow_tpu_torch.infer import fast_gate
    from planar_optical_flow_tpu_torch.ops.kernels import (
        conv_stack, cutout_kernel,
    )

    return {"cutout": cutout_kernel.cutout,
            "backbone_bf16": conv_stack.backbone_bf16,
            "gate": fast_gate.gate, "head": conv_stack.head}


def train_counts(zero=False):
    fns = train_wrappers()
    if zero:
        for fn in fns.values():
            fn.launches = 0
    return {k: fn.launches for k, fn in fns.items()}


def run_scalars(run_dir, key):
    with open(os.path.join(run_dir, "tb", "scalars.jsonl")) as f:
        return [r["value"] for r in map(json.loads, f) if r["key"] == key]


def check_launches(what, got, steps, per_step, extra_cutouts=0):
    want = {k: n * steps for k, n in per_step.items()}
    want["cutout"] += extra_cutouts
    check(got == want, f"[train] {what}: launches {got}, want {want}")


class _StopAfter:
    """A loader that asks the trainer to stop after ``n`` batches."""

    def __init__(self, loader, trainer, n):
        self.loader, self.trainer, self.n = loader, trainer, n

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if i == self.n:
                self.trainer.request_stop()
            yield batch


def _bf16_bar(what, got, ref):
    """JAX's bf16 bar: corr > 0.99, max |d| < 0.05 max(|ref|, 1)."""
    got = np.asarray(got, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    err = float(np.abs(got - ref).max())
    corr = float(np.corrcoef(got, ref)[0, 1]) if ref.size > 1 else 1.0
    check(np.isfinite(got).all() and corr > 0.99
          and err < 0.05 * max(np.abs(ref).max(), 1.0),
          f"[train] {what}: corr {corr}, max abs err {err}")
    return corr, err


def train_phase(device, seed, card):
    """The ``[train]`` phase: the detector through ``cli.train``, then
    FlowDROW on its frozen checkpoint, on the module and the fused task."""
    import torch

    from planar_optical_flow_tpu_torch.cli import train as train_cli
    from planar_optical_flow_tpu_torch.data import write_synthetic_drow_split
    from planar_optical_flow_tpu_torch.pipeline import (
        Pipeline, normalize_config,
    )
    from planar_optical_flow_tpu_torch.train import tasks
    from planar_optical_flow_tpu_torch.train.fused_frozen import (
        frozen_detector_forward,
    )
    from planar_optical_flow_tpu_torch.train.trainer import to_device

    t_phase = time.perf_counter()
    root = os.path.join(BUILD_DIR, "train")
    shutil.rmtree(root, ignore_errors=True)
    data, logs = os.path.join(root, "drow"), os.path.join(root, "logs")
    write_synthetic_drow_split(data, "train", num_sequences=TRAIN_SEQS,
                               num_frames=TRAIN_FRAMES, seed=seed,
                               num_pts=NUM_PTS)
    write_synthetic_drow_split(data, "val", num_sequences=1,
                               num_frames=VAL_FRAMES, seed=seed + 1,
                               num_pts=NUM_PTS)
    flat = dict(FLAGSHIP_CFG, epochs=1, data_dir=data, log_dir=logs)
    per_step = train_launches(flat["num_scans"])
    cfg_path = os.path.join(root, "detector.json")
    with open(cfg_path, "w") as f:
        json.dump(dict(flat, network="cutout_gating", tag="detector"), f)
    ms = {}

    with counting_plain() as plain_calls:
        # 1. the detector through the CLI, to its final checkpoint
        handlers = {s: signal.getsignal(s)
                    for s in (signal.SIGINT, signal.SIGTERM)}
        train_counts(zero=True)
        t0 = time.perf_counter()
        try:
            rc = train_cli.main(["--cfg", cfg_path] + (
                ["--cpu"] if torch.device(device).type == "cpu" else []))
        finally:
            for s, h in handlers.items():
                signal.signal(s, h)
        det_s = time.perf_counter() - t0
        check(rc == 0, f"[train] cli.train on the detector: rc {rc}")
        (run,) = [d for d in os.listdir(logs) if d.endswith("_detector")]
        run_dir = os.path.join(logs, run)
        det_ckpt = os.path.join(run_dir, "ckpt", "ckpt_final")
        check(os.path.isfile(os.path.join(det_ckpt, "weights.pt")),
              "[train] the detector's final checkpoint")
        losses = run_scalars(run_dir, "TRAIN_loss")
        steps = len(losses)
        # the final evaluation encodes its val batch on K1 too
        check_launches("detector", train_counts(), steps,
                       per_step["detector"], extra_cutouts=1)
        check(steps > 0 and np.isfinite(losses).all(),
              f"[train] detector: {steps} steps, losses {losses}")
        ms["detector"] = run_scalars(run_dir, "TRAIN_step_ms")
        final = json.load(open(os.path.join(run_dir, "output",
                                            "final_metrics.json")))
        print(f"[train] detector: cli.train --cfg (network cutout_gating, "
              f"dr-spaam, DetectionTask, bf16), {steps} steps of "
              f"{flat['batch_size']} x {flat['num_scans'] + 1} scans of "
              f"{NUM_PTS} beams, losses "
              f"{json.dumps([round(x, 5) for x in losses])}, val "
              f"{json.dumps({k: round(float(v), 5) for k, v in final.items()})}"
              f", {det_s:.1f} s with its dataset and evaluation; {card}",
              flush=True)

        # 2./3. FlowDROW on the grafted detector: module task, fused task
        det_state = torch.load(os.path.join(det_ckpt, "weights.pt"),
                               map_location="cpu", weights_only=True)
        pipes = {}
        for what, fused in (("flow_module", False), ("flow_fused", True)):
            cfg = normalize_config(dict(flat, tag=what,
                                        fused_frozen_detector=fused))
            cfg["model"]["pretrained_detector"] = det_ckpt
            pipe = Pipeline(cfg, device=device, install_signal_handlers=False)
            det = pipe.model.dr_spaam
            for n, t in det.state_dict().items():
                if not n.endswith("num_batches_tracked"):
                    check(torch.equal(t.cpu(), det_state[n]),
                          f"[train] {what}: {n} not grafted")
            start = {n: p.detach().clone() for n, p in det.named_parameters()}
            train_counts(zero=True)
            rc = pipe.train()
            got = train_counts()
            run_dir = pipe.logger.run_dir
            losses = run_scalars(run_dir, "TRAIN_loss")
            check(rc == 0 and len(losses) == len(pipe.train_loader)
                  and np.isfinite(losses).all(),
                  f"[train] {what}: rc {rc}, losses {losses}")
            check_launches(what, got, len(losses), per_step[what])
            for n, p in det.named_parameters():
                check(torch.equal(p, start[n]),
                      f"[train] {what}: detector parameter {n} moved")
            ms[what] = run_scalars(run_dir, "TRAIN_step_ms")
            pipes[what] = (pipe, losses)
            print(f"[train] {what}: {type(pipe.task).__name__}, "
                  f"{len(losses)} steps, launches {json.dumps(got)} "
                  f"({json.dumps(per_step[what])} a step), losses "
                  f"{json.dumps([round(x, 5) for x in losses])}; the "
                  f"detector's parameters equal to the bit to the "
                  f"checkpoint's; {card}", flush=True)
        calls = plain_calls()
    check(not any(calls.values()), f"[train] a plain version ran: "
          f"{json.dumps({k: v for k, v in calls.items() if v})}")

    # the fused task against the module task: the first training loss of
    # each run (the same weights and first batch, bf16), and on one batch
    # the similarity band and loss of the f32 model
    (pipe_m, loss_m), (pipe_f, loss_f) = pipes.values()
    corr_l, err_l = _bf16_bar("first-batch loss", [loss_f[0]], [loss_m[0]])
    batch = to_device(pipe_f.train_set.batch(np.arange(8)), device)
    model = pipe_f.model
    with torch.no_grad():
        task_m = tasks.FlowDrowTask(**{k: getattr(pipe_f.task, k) for k in (
            "cutout_kwargs", "focal_loss_gamma", "pedestrian_only",
            "num_pts")})
        sim_m = model.dr_spaam(task_m._encode(batch["scans"]), False)[2]
        kw = pipe_f.cfg["dataset"]["cutout_kwargs"]
        sim_f = frozen_detector_forward(
            model.dr_spaam, batch["scans"], alpha=pipe_f.task.alpha,
            window_size=pipe_f.task.window_size, num_pts=NUM_PTS,
            ct_len=kw["num_cutout_pts"], window_width=kw["window_width"],
            window_depth=kw["window_depth"], padding_val=kw["padding_val"],
            centered=kw["centered"], area_mode=kw["area_mode"],
            with_head=False)[2]
        l_m = float(task_m.loss(model, batch, False)[0])
        l_f = float(pipe_f.task.loss(model, batch, False)[0])
    corr_s, err_s = _bf16_bar("sim_band", sim_f.cpu(), sim_m.cpu())
    _bf16_bar("f32-model loss", [l_f], [l_m])
    print(f"[train] fused vs module task: first training loss "
          f"{loss_f[0]:.6f} vs {loss_m[0]:.6f}; on one batch of the f32 "
          f"model sim_band corr {corr_s:.6f}, max abs err {err_s:.5f}, loss "
          f"{l_f:.6f} vs {l_m:.6f} (bar: corr > 0.99, max |d| < 0.05 "
          f"max(|ref|, 1)); {card}", flush=True)

    # preemption: a stop after TRAIN_STOP steps, then a resume
    cfg = normalize_config(dict(flat, tag="preempt",
                                fused_frozen_detector=True))
    cfg["model"]["pretrained_detector"] = det_ckpt
    pipe = Pipeline(cfg, device=device, install_signal_handlers=False)
    pipe.train_loader = _StopAfter(pipe.train_loader, pipe.trainer,
                                   TRAIN_STOP)
    rc = pipe.train()
    check(rc == 1 and pipe.state.step == TRAIN_STOP
          and pipe.sigterm_ckpt_exists(),
          f"[train] preemption: rc {rc}, step {pipe.state.step}")
    resumed = Pipeline(cfg, device=device, install_signal_handlers=False)
    resumed.load_sigterm_ckpt()
    check((resumed.state.step, resumed.state.epoch) == (TRAIN_STOP, 0),
          "[train] the sigterm checkpoint's counters")
    for n, t in pipe.model.state_dict().items():
        check(torch.equal(resumed.model.state_dict()[n], t),
              f"[train] the sigterm checkpoint's {n}")
    rc = resumed.train()
    n_steps = len(resumed.train_loader)
    check(rc == 0 and resumed.state.epoch == 1
          and resumed.state.step == TRAIN_STOP + n_steps,
          f"[train] resume: rc {rc}, step {resumed.state.step}")
    print(f"[train] preemption: request_stop() after {TRAIN_STOP} steps -> "
          f"rc 1, {pipe.logger.sigterm_ckpt} written; restored equal to the "
          f"bit, resumed to epoch 1 at step {resumed.state.step}; {card}",
          flush=True)
    for what, t in ms.items():
        print(f"[train] {what} step_ms {json.dumps([round(x, 3) for x in t])}"
              f" median after the first {float(np.median(t[1:])):.3f} ms "
              f"(B={flat['batch_size']}, {flat['num_scans'] + 1} scans of "
              f"{NUM_PTS} beams, bf16) on {card}", flush=True)
    print(f"[train] the phase took {time.perf_counter() - t_phase:.1f} s on "
          f"{card}", flush=True)
    return pipes, cfg_path, det_ckpt


# the device operations of each traced runner's kernels, by the names they
# appear under in the profiler
TRACE_KERNELS = {
    "int8c": {"K1": ("cutout_kernel",),
              "K5": ("backbone_int8", "embed_kernel"),
              "K6": ("gate_int8_rows_kernel",), "K7": ("head_int8",)},
    "v3": {"K1": ("cutout_kernel",),
           "K2": ("backbone_bf16_kernel", "embed_kernel"),
           "K3": ("band_mix_kernel",), "K4": ("head_bf16_kernel",)},
    "flow_module": {"K1": ("cutout_kernel",)},
    "flow_fused": {"K1": ("cutout_kernel",),
                   "K2": ("backbone_bf16_kernel", "embed_kernel"),
                   "K3": ("band_mix_kernel",)},
}


def trace_phase(model, scans, device, calib, engine="int8c", steps=3,
                top=12):
    """The ``[trace]`` phase: ``torch.profiler`` (CPU + CUDA activities)
    over ``steps`` carried steps of ``StreamingRunner(engine=engine)``
    (after its bootstrap and one carried step); prints the device busy
    share of the window, the top device operations by time and the time a
    step spends outside its kernels (``TRACE_KERNELS``: K1/K5/K6/K7 for
    int8c, K1-K4 for v3), or "not measured" where the profiler recorded no
    device time. Lines ``[trace]`` (int8c) or ``[trace v3]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from planar_optical_flow_tpu_torch.infer.streaming import StreamingRunner

    runner = StreamingRunner(model, CUTOUT_KW, engine=engine,
                             calib=calib if engine == "int8c" else None,
                             num_pts=NUM_PTS, device=device)
    tag = "[trace]" if engine == "int8c" else f"[trace {engine}]"
    ours = TRACE_KERNELS[engine]
    runner(scans[0])
    runner(scans[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for scan in scans[2:2 + steps]:
            runner(scan)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    what = "int8c p2" if engine == "int8c" else engine
    print(f"{tag} {steps} carried {what} steps at B={scans.shape[1]}: "
          f"{wall_ms:.3f} ms a step (host clock)", flush=True)
    report_trace(tag, prof, wall_ms, steps, ours, top)


def report_trace(tag, prof, wall_ms, steps, ours, top):
    """The device busy share of a profiled window of ``steps`` steps, its
    top device operations and each kernel's time a step (``ours``: label
    -> device operation names), or "not measured" where the profiler
    recorded no device time."""
    from torch.autograd import DeviceType

    report_spans(tag, [(ev.name, ev.time_range.start, ev.time_range.end)
                       for ev in prof.events()
                       if ev.device_type == DeviceType.CUDA],
                 wall_ms, steps, ours, top)


def report_spans(tag, events, wall_ms, steps, ours, top):
    """:func:`report_trace` on ``(name, start us, end us)`` device
    events."""
    names = "/".join(ours) or "the port's kernels"
    spans, by_name = [], {}
    for name, start, end in events:
        spans.append((start, end))
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + (end - start) / 1e3, cnt + 1)
    if not spans:
        print(f"{tag} device busy share: not measured (the profiler "
              "recorded no device time); top device operations: not "
              f"measured; time outside {names}: not measured", flush=True)
        return
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3 / steps
    print(f"{tag} device busy {busy:.3f} ms a step = share "
          f"{busy / wall_ms:.4f} of the host-clock step", flush=True)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (tot, cnt) in ranked[:top]:
        print(f"{tag} device op {tot / steps:.4f} ms a step, "
              f"{cnt / steps:g} a step: {name[:150]}", flush=True)
    per = {k: sum(t for n, (t, _) in by_name.items()
                  if any(s in n for s in subs)) / steps
           for k, subs in ours.items()}
    inside = sum(per.values())
    other_dev = sum(t for t, _ in by_name.values()) / steps - inside
    print(f"{tag} a step: " + ", ".join(f"{k} {v:.4f} ms"
                                       for k, v in per.items())
          + f"; outside {names} {wall_ms - inside:.4f} ms (other device "
          f"ops {other_dev:.4f} ms, device idle {wall_ms - busy:.4f} ms)",
          flush=True)


def trace_train_phase(pipes, device, steps=3, top=12):
    """``[trace train]``: ``torch.profiler`` over ``steps`` train steps of
    each FlowDROW pipeline of the ``[train]`` phase (after one untraced
    step), on the first batch of its train split: the device busy share,
    the top device operations, and the time a step spends outside its
    kernels (K1 for the module task, K1-K3 for the fused one). The steps
    go on training the phase's models."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from planar_optical_flow_tpu_torch.train.trainer import to_device

    for what, (pipe, _) in pipes.items():
        tag = f"[trace train {what}]"
        batch = to_device(pipe.train_set.batch(
            np.arange(pipe.train_loader.batch_size)), device)
        trainer, state = pipe.trainer, pipe.state
        state, tb = trainer.train_step(state, batch)
        float(tb["loss"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                state, tb = trainer.train_step(state, batch)
                float(tb["loss"])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        print(f"{tag} {steps} steps of {type(pipe.task).__name__}: "
              f"{wall_ms:.3f} ms a step (host clock, under the profiler)",
              flush=True)
        report_trace(tag, prof, wall_ms, steps, TRACE_KERNELS[what], top)


# the "flow" phase: configs/prototype_flow.yaml (epochs cut to 1, written
# as JSON) through cli.train and cli.evaluate on the synthetic split of
# cli.train --synthetic (2 x 40 train and 1 x 15 val frames of 450 beams),
# in f32 and in bf16; the eval-mode forward at the working points of
# experiments/bench_workloads.py:69-99
FLOW_YAML = os.path.join("configs", "prototype_flow.yaml")
FLOW_PROFILE = (2, 5)   # profile_steps of the f32 run
FLOW_BATCHES = (8, 256, 1024)
FLOW_ITERS = 20         # timed forward calls a batch and dtype
TOL_FLOW_EVAL = 1e-4    # EPE/AAE, card against the CPU (relative)
TOL_FLOW_FWD = 1e-4     # the f32 forward at B=8, card against the CPU
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def flow_macs(model, num_pts):
    """Multiply-adds of one scan pair's forward: every conv block's
    ``L_out * C_out * C_in * k`` (the encoders twice) and the banded patch
    correlation at the bottleneck, ``P x (2d+1) x 3C`` (what the function
    needs, not the ``P x P`` product that the port computes)."""
    lens, macs = {}, 0
    length = num_pts
    for name in ("encoder_0", "encoder_1", "encoder_2"):
        conv = getattr(model, name).conv
        length = (length - 1) // conv.stride[0] + 1
        lens[name] = length
        macs += 2 * length * conv.weight.numel()
    macs += (lens["encoder_2"] * (2 * model.max_displacement + 1) * 3
             * model.encoder_2.conv.out_channels)
    macs += lens["encoder_1"] * model.decoder_1.conv.weight.numel()
    macs += lens["encoder_0"] * model.decoder_0.conv.weight.numel()
    head = (model.flow_reg_linear.weight if model.linear_head
            else model.flow_reg.conv.weight)
    return macs + num_pts * head.numel()


def run_dir_of(logs, tag):
    (run,) = [d for d in os.listdir(logs) if d.endswith(f"_{tag}")]
    return os.path.join(logs, run)


def flow_phase(device, card, det_cfg, det_ckpt):
    """The ``[flow]`` phase: the flow U-Net trained through ``cli.train``
    (f32, with a ``profile_steps`` window, and bf16), its final checkpoint
    scored through ``cli.evaluate``'s module path against ``evaluate_flow``
    on the CPU, the eval-mode forward timed at ``FLOW_BATCHES``, and the
    ``[train]`` phase's detector scored on the module path with exact K1
    launches."""
    import torch

    from planar_optical_flow_tpu_torch.cli import evaluate as evaluate_cli
    from planar_optical_flow_tpu_torch.cli import train as train_cli
    from planar_optical_flow_tpu_torch.data import (
        BatchLoader, FlowScanPairDataset,
    )
    from planar_optical_flow_tpu_torch.eval import evaluate_flow
    from planar_optical_flow_tpu_torch.interop.checkpoint import load_weights
    from planar_optical_flow_tpu_torch.models import get_model
    from planar_optical_flow_tpu_torch.pipeline import normalize_config
    from planar_optical_flow_tpu_torch.train import (
        Trainer, create_train_state, make_optimizer, tasks,
    )
    from planar_optical_flow_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    root = os.path.join(BUILD_DIR, "flow")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    data, logs = os.path.join(root, "drow"), os.path.join(root, "logs")
    flow_cfg = load_config(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), FLOW_YAML))
    batch = flow_cfg["batch_size"]

    def cfg_file(name, **trainer):
        cfg = normalize_config(dict(flow_cfg, epochs=1, log_dir=logs,
                                    compute_dtype=trainer.pop("dtype")))
        cfg["pipeline"]["Logger"]["tag"] = name
        cfg["pipeline"]["Trainer"].update(trainer)
        path = os.path.join(root, f"{name}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        return cfg, path

    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                 signal.SIGTERM)}
    runs = {}
    with counting_plain() as plain_calls:
        for what, dtype, profile in (("f32", None, FLOW_PROFILE),
                                     ("bf16", "bfloat16", ())):
            cfg, path = cfg_file(f"flow_{what}", dtype=dtype,
                                 profile_steps=list(profile))
            t0 = time.perf_counter()
            try:
                rc = train_cli.main(["--cfg", path, "--synthetic", data])
            finally:
                for s, h in handlers.items():
                    signal.signal(s, h)
            secs = time.perf_counter() - t0
            run_dir = run_dir_of(logs, f"flow_{what}")
            losses = run_scalars(run_dir, "TRAIN_loss")
            ckpt = os.path.join(run_dir, "ckpt", "ckpt_final")
            check(rc == 0 and len(losses) > FLOW_PROFILE[1]
                  and np.isfinite(losses).all()
                  and os.path.isfile(os.path.join(ckpt, "weights.pt")),
                  f"[flow] cli.train {what}: rc {rc}, losses {losses}")
            ms = run_scalars(run_dir, "TRAIN_step_ms")
            final = json.load(open(os.path.join(run_dir, "output",
                                                "final_metrics.json")))
            runs[what] = (run_dir, ckpt, ms)
            print(f"[flow] cli.train --cfg {FLOW_YAML} (epochs 1) "
                  f"--synthetic, {what}: {len(losses)} steps of "
                  f"{batch} scan pairs of {NUM_PTS} beams, "
                  f"losses {json.dumps([round(x, 5) for x in losses])}, val "
                  f"{json.dumps({k: round(float(v), 5) for k, v in final.items()})}"
                  f", final checkpoint {ckpt}; {secs:.1f} s with its data "
                  f"and evaluation", flush=True)
            print(f"[flow] {what} step_ms "
                  f"{json.dumps([round(x, 3) for x in ms])} median after "
                  f"the first {float(np.median(ms[1:])):.3f} ms (B="
                  f"{batch}, {NUM_PTS} beams, {what}) on "
                  f"{card}", flush=True)
        trace_window("[trace flow]", runs["f32"][0], FLOW_PROFILE,
                     runs["f32"][2], "f32 steps of FlowUNetTask")

        # the f32 checkpoint through cli.evaluate's module path, on the card
        _, eval_path = cfg_file("flow_eval", dtype=None)
        ckpt = runs["f32"][1]
        t0 = time.perf_counter()
        got = evaluate_cli.evaluate(["--cfg", eval_path, "--ckpt", ckpt,
                                     "--synthetic", data])
        eval_s = time.perf_counter() - t0
        calls = plain_calls()
    check(not any(calls.values()), f"[flow] a plain version ran: "
          f"{json.dumps({k: v for k, v in calls.items() if v})}")

    # ... and by evaluate_flow on the CPU, from the same files
    model_cfg = normalize_config(flow_cfg)["model"]
    cpu_model = load_weights(get_model(model_cfg), ckpt)
    val = FlowScanPairDataset(data, "val")
    loader = BatchLoader(val, batch, shuffle=False)
    state = create_train_state(cpu_model, make_optimizer(
        {"scheduler_kwargs": flow_cfg["scheduler_kwargs"]}, 1))
    ref, outs = evaluate_flow(tasks.FlowUNetTask(), state, loader,
                              collect_outputs=True)
    flows = np.concatenate([o["pred_flow"] for o in outs])
    check(set(got) == set(ref) == {"epe", "aae"}
          and all(math.isfinite(v) for v in got.values()),
          f"[flow] cli.evaluate: {got}")
    rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in ref}
    check(all(r <= TOL_FLOW_EVAL for r in rel.values()),
          f"[flow] cli.evaluate {got} vs the CPU's evaluate_flow {ref}")
    check(flows.shape == (len(loader) * batch, NUM_PTS, 2)
          and np.isfinite(flows).all(),
          f"[flow] evaluate_flow collected {flows.shape}")
    print(f"[flow] cli.evaluate --ckpt {ckpt} (module path, card): "
          f"{json.dumps(got)} in {eval_s:.1f} s; evaluate_flow on the CPU "
          f"(TF32 off on the card): {json.dumps(ref)}, relative difference "
          f"{json.dumps(rel)} (bar {TOL_FLOW_EVAL}); collect_outputs: "
          f"{flows.shape[0]} flow fields of {flows.shape[1:]} for "
          f"{len(loader) * batch} frames; {card}",
          flush=True)

    # the eval-mode forward at the bench's working points
    model = load_weights(get_model(model_cfg), ckpt).to(device)
    pairs = val.batch(np.arange(max(FLOW_BATCHES)) % len(val))["scan_pair"]
    macs = flow_macs(model, NUM_PTS)
    with torch.no_grad():
        for b in FLOW_BATCHES:
            x = torch.as_tensor(pairs[:b], device=device)
            for dtype in (torch.float32, torch.bfloat16):
                a, c = x[:, 0].to(dtype), x[:, 1].to(dtype)
                out = model(a, c)
                ms = time_ms(lambda: model(a, c), FLOW_ITERS)
                dev_ms = graph_ms(lambda: model(a, c), FLOW_ITERS)
                check(out.shape == (b, NUM_PTS, 2) and out.dtype == dtype
                      and bool(torch.isfinite(out).all()),
                      f"[flow] forward B={b} {dtype}")
                peak = (H100_F32_FLOPS if dtype == torch.float32
                        else H100_BF16_FLOPS)
                note = ""
                if b == FLOW_BATCHES[0] and dtype == torch.float32:
                    ref_out = cpu_model(x[:, 0].cpu(), x[:, 1].cpu())
                    err = max_err(out.cpu(), ref_out)
                    top = float(ref_out.abs().max())
                    check(err <= TOL_FLOW_FWD * top,
                          f"[flow] forward B={b}: {err} vs the CPU's")
                    note = (f"; max |card - CPU| {err:.3g} = "
                            f"{err / top:.3g} x max (bar {TOL_FLOW_FWD})")
                print(f"[flow] forward B={b} {str(dtype)[6:]}: {ms:.4f} ms "
                      f"a call = {b / ms * 1e3:.1f} scan pairs/s (wrapper "
                      f"loop); device {dev_ms:.4f} ms (a CUDA graph of "
                      f"{FLOW_ITERS} calls) = {b / dev_ms * 1e3:.1f}; "
                      f"{macs * b / 1e9:.3f} GMAC, bound "
                      f"{2 * macs * b / peak * 1e3:.4f} ms at "
                      f"{peak / 1e12:g} TFLOP/s{note}; {card}", flush=True)

    # the [train] phase's detector on the module path: K1 once a batch
    n_eval = [0]
    eval_step = Trainer.eval_step

    def counted(self, st, batch):
        n_eval[0] += 1
        return eval_step(self, st, batch)

    with counting_plain() as plain_calls:
        Trainer.eval_step = counted
        train_counts(zero=True)
        try:
            t0 = time.perf_counter()
            det = evaluate_cli.evaluate(["--cfg", det_cfg, "--ckpt",
                                         det_ckpt, "--synthetic",
                                         os.path.join(root, "det")])
            det_s = time.perf_counter() - t0
        finally:
            Trainer.eval_step = eval_step
        got_launches = train_counts()
        calls = plain_calls()
    check(not any(calls.values()), f"[flow] a plain version ran on the "
          f"DROW module path: "
          f"{json.dumps({k: v for k, v in calls.items() if v})}")
    want = dict(cutout=n_eval[0], backbone_bf16=0, gate=0, head=0)
    check(n_eval[0] > 0 and got_launches == want,
          f"[flow] DROW module path: launches {got_launches}, want {want}")
    check(set(det) == {"cls_loss", "reg_loss", "fg_ratio"}
          and all(math.isfinite(v) for v in det.values()),
          f"[flow] DROW module path: {det}")
    print(f"[flow] cli.evaluate --cfg detector --ckpt {det_ckpt} "
          f"--synthetic (module path, card): {json.dumps(det)}, "
          f"{n_eval[0]} batches, launches {json.dumps(got_launches)} (K1 "
          f"once a batch, no plain version) in {det_s:.1f} s; {card}",
          flush=True)
    print(f"[flow] the phase took {time.perf_counter() - t_phase:.1f} s on "
          f"{card}", flush=True)


# the "box" phase: configs/train_3d_box_regression.yaml (epoch cut to 1,
# written as JSON) on a synthetic JRDB tree of the port's
# write_synthetic_jrdb (2 train sequences and 1 val sequence of
# BOX_FRAMES x BOX_BOXES), through cli.train in f32 (a profile_steps window)
# and bf16, cli.evaluate and BoxRegressor; the eval-mode forward at
# BOX_BATCHES segments
BOX_YAML = os.path.join("configs", "train_3d_box_regression.yaml")
BOX_FRAMES, BOX_BOXES = 40, 8
BOX_PROFILE = (1, 4)    # profile_steps of the f32 run
BOX_BATCHES = (256, 1024, 4096)
BOX_ITERS = 10          # timed forward calls a batch and dtype
TOL_BOX_EVAL = 1e-4     # metrics and baseline, card against the CPU
TOL_BOX_INFER = 1e-4    # BoxRegressor boxes, card against the CPU
TOL_BOX_FWD = 1e-4      # the f32 forward at B=256, x max |CPU|
TOL_BOX_IOU = 1e-5      # the rotated IoU, card against the CPU


def box_macs(model, num_points):
    """Multiply-adds of one segment's forward: the per-point Dense layers
    on each of ``num_points`` points, then the head on the pooled
    feature."""
    from torch import nn

    def macs(module):
        return sum(m.weight.numel() for m in module.modules()
                   if isinstance(m, nn.Linear))

    return (macs(model.backbone) * num_points
            + sum(macs(getattr(model, f)) for f in ("fc1", "fc2", "fc3")))


def trace_window(tag, run_dir, window, step_ms, what, card="", ours=None):
    """A run's ``profile_steps`` trace, read back from ``{run_dir}/
    profile``: its device busy share against the host clock of the
    profiled steps, the top device operations and the time outside the
    port's kernels (``ours``: their device operations by kernel, as
    :data:`TRACE_KERNELS` names them)."""
    start, stop = window
    path = os.path.join(run_dir, "profile",
                        f"steps_{start}_{stop}.pt.trace.json")
    check(os.path.isfile(path) and os.path.getsize(path) > 0,
          f"{tag} no profile_steps trace at {path}")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    # TRAIN_step_ms of the steps that ran inside the window
    wall_ms = sum(step_ms[start:stop]) / (stop - start)
    print(f"{tag} profile_steps {list(window)}: {stop - start} {what}, "
          f"{wall_ms:.3f} ms a step (host clock, under the profiler); trace "
          f"{path} ({os.path.getsize(path)} bytes, {len(events)} events)"
          + (f"; {card}" if card else ""), flush=True)
    report_spans(tag, dev, wall_ms, stop - start, ours or {}, 12)


def box_phase(device, card):
    """The ``[box]`` phase: the PointNet box regressor trained through
    ``cli.train`` (f32 with a ``profile_steps`` window, and bf16) on a
    synthetic JRDB tree, its final checkpoint scored through
    ``cli.evaluate`` (metrics and the mean-box baseline) against the CPU,
    served through ``BoxRegressor`` against the CPU, the eval-mode forward
    timed at ``BOX_BATCHES`` and the rotated IoU of the metrics timed. No
    kernel of the port and no plain version of one may run."""
    import torch

    from planar_optical_flow_tpu_torch.cli import evaluate as evaluate_cli
    from planar_optical_flow_tpu_torch.cli import train as train_cli
    from planar_optical_flow_tpu_torch.data import (
        BatchLoader, JrdbBoxRegressionDataset, JrdbHandle, native,
        write_synthetic_jrdb,
    )
    from planar_optical_flow_tpu_torch.eval import (
        evaluate_box_regression, mean_box_baseline,
    )
    from planar_optical_flow_tpu_torch.infer import BoxRegressor
    from planar_optical_flow_tpu_torch.interop.checkpoint import load_weights
    from planar_optical_flow_tpu_torch.models import get_model
    from planar_optical_flow_tpu_torch.ops.rotated_iou import (
        rotated_iou_3d_paired,
    )
    from planar_optical_flow_tpu_torch.train import (
        create_train_state, make_optimizer, tasks,
    )
    from planar_optical_flow_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    root = os.path.join(BUILD_DIR, "box")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    data, logs = os.path.join(root, "jrdb"), os.path.join(root, "logs")
    t0 = time.perf_counter()
    seqs = write_synthetic_jrdb(data, num_frames=BOX_FRAMES,
                                boxes_per_frame=BOX_BOXES)
    box_cfg = load_config(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), BOX_YAML))
    ds_cfg = dict(box_cfg["dataset"], data_dir=data)
    batch = box_cfg["dataloader"]["batch_size"]
    train_set = JrdbBoxRegressionDataset("train", ds_cfg)
    n_steps = len(train_set) // batch
    print(f"[box] synthetic JRDB {seqs} ({BOX_FRAMES} frames x {BOX_BOXES} "
          f"boxes a sequence) in {time.perf_counter() - t0:.1f} s: "
          f"{len(train_set)} train samples after augmentation = {n_steps} "
          f"steps of B={batch} (input_size "
          f"{ds_cfg['input_size']}, dropout {box_cfg['model']['dropout']}); "
          f"LZF decoder and CSV reader: {native.status()} (else the Python "
          f"decoder and np.loadtxt); {card}", flush=True)
    check(n_steps >= 4, f"[box] {n_steps} train steps of B={batch}")

    def cfg_file(name, **trainer):
        cfg = json.loads(json.dumps(box_cfg))
        cfg["dataset"]["data_dir"] = data
        cfg["pipeline"]["Trainer"].update(epoch=1, **trainer)
        cfg["pipeline"]["Logger"].update(log_dir=logs, tag=name)
        path = os.path.join(root, f"{name}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        return cfg, path

    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                 signal.SIGTERM)}
    runs = {}
    with counting_plain() as plain_calls:
        for what, dtype, profile in (("f32", None, BOX_PROFILE),
                                     ("bf16", "bfloat16", ())):
            _, path = cfg_file(f"box_{what}", compute_dtype=dtype,
                               profile_steps=list(profile))
            t0 = time.perf_counter()
            try:
                rc = train_cli.main(["--cfg", path])
            finally:
                for s, h in handlers.items():
                    signal.signal(s, h)
            secs = time.perf_counter() - t0
            run_dir = run_dir_of(logs, f"box_{what}")
            losses = run_scalars(run_dir, "TRAIN_loss")
            ckpt = os.path.join(run_dir, "ckpt", "ckpt_final")
            check(rc == 0 and len(losses) == n_steps
                  and np.isfinite(losses).all()
                  and os.path.isfile(os.path.join(ckpt, "weights.pt")),
                  f"[box] cli.train {what}: rc {rc}, losses {losses}")
            ms = run_scalars(run_dir, "TRAIN_step_ms")
            with open(os.path.join(run_dir, "output",
                                   "final_metrics.json")) as f:
                final = {k: round(float(v), 5) for k, v in json.load(f)
                         .items()}
            runs[what] = (run_dir, ckpt, ms)
            print(f"[box] cli.train --cfg {BOX_YAML} (epoch 1), {what}: "
                  f"{len(losses)} steps of {batch} segments of "
                  f"{ds_cfg['input_size']} points, losses "
                  f"{json.dumps([round(x, 5) for x in losses])}, val "
                  f"{json.dumps(final)}, final checkpoint {ckpt}; "
                  f"{secs:.1f} s with its data and evaluation; {card}",
                  flush=True)
            print(f"[box] {what} step_ms "
                  f"{json.dumps([round(x, 3) for x in ms])} median after "
                  f"the first {float(np.median(ms[1:])):.3f} ms = "
                  f"{batch / float(np.median(ms[1:])) * 1e3:.1f} segments/s "
                  f"(B={batch}, {what}) on {card}", flush=True)
        trace_window("[trace box]", runs["f32"][0], BOX_PROFILE,
                     runs["f32"][2], "f32 steps of BoxRegressionTask", card)

        # the f32 checkpoint through cli.evaluate's module path, on the card
        ckpt = runs["f32"][1]
        _, eval_path = cfg_file("box_eval", compute_dtype=None)
        t0 = time.perf_counter()
        got = evaluate_cli.evaluate(["--cfg", eval_path, "--ckpt", ckpt])
        eval_s = time.perf_counter() - t0

        # BoxRegressor on one val frame's cloud, at every box centre
        frame = JrdbHandle("val", ds_cfg)[0]
        centers = frame["boxes"][:, :3]
        oris = frame["boxes"][:, -1]
        reg = BoxRegressor.from_checkpoint(ckpt, ds_cfg, device=device)
        t0 = time.perf_counter()
        boxes, ok = reg(frame["points"], centers, oris)
        infer_ms = (time.perf_counter() - t0) * 1e3

        # the eval-mode forward and the metrics' rotated IoU
        model = load_weights(get_model(box_cfg["model"]), ckpt).to(device)
        val = JrdbBoxRegressionDataset("val", ds_cfg)
        segs = val.batch(np.arange(max(BOX_BATCHES)) % len(val))
        macs = box_macs(model, ds_cfg["input_size"])
        fwd = {}
        with torch.no_grad():
            for b in BOX_BATCHES:
                x32 = torch.as_tensor(segs["input"][:b], device=device)
                for dt in (torch.float32, torch.bfloat16):
                    x = x32.to(dt)
                    out = model(x)
                    check(out.shape == (b, 5) and out.dtype == dt
                          and bool(torch.isfinite(out).all()),
                          f"[box] forward B={b} {dt}")
                    fwd[b, dt] = (out, time_ms(lambda: model(x), BOX_ITERS),
                                  graph_ms(lambda: model(x), BOX_ITERS))
                    del out
                torch.cuda.empty_cache()
            nb = torch.as_tensor(segs["target_neighbor"][:batch],
                                 device=device)
            pred = fwd[batch, torch.float32][0]
            dc = torch.as_tensor(segs["det_center"][:batch], device=device)
            ori = pred[:, -1] + torch.as_tensor(segs["input"][:batch, 0, -1],
                                                device=device)
            pboxes = torch.cat([dc[:, :2], (pred[:, 0] + dc[:, -1])[:, None],
                                pred[:, 1:-1], ori[:, None]], dim=1)
            # the targets de-canonicalized the same way: boxes whose IoU
            # with their neighbours is live (1 with themselves), where a
            # briefly trained model's predictions may overlap nothing
            tgt = torch.as_tensor(segs["target"][:batch], device=device)
            bc = torch.as_tensor(segs["box_center"][:batch], device=device)
            tboxes = torch.cat([bc[:, :2], (tgt[:, 0] + dc[:, -1])[:, None],
                                tgt[:, 1:-1],
                                (tgt[:, -1] + ori - pred[:, -1])[:, None]],
                               dim=1)
            both = torch.cat([pboxes, tboxes])[:, None]
            iou = rotated_iou_3d_paired(both, torch.cat([nb, nb]))
            iou_ms = time_ms(lambda: rotated_iou_3d_paired(pboxes[:, None],
                                                           nb), BOX_ITERS)
            iou_dev = graph_ms(lambda: rotated_iou_3d_paired(
                pboxes[:, None], nb), BOX_ITERS)
        calls = plain_calls()
    launched = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    check(not launched, f"[box] a kernel of the port launched: {launched}")
    check(not any(calls.values()), f"[box] a plain version ran: "
          f"{json.dumps({k: v for k, v in calls.items() if v})}")

    # ... and the same on the CPU, from the same files
    cpu_model = load_weights(get_model(box_cfg["model"]), ckpt)
    cpu_val = JrdbBoxRegressionDataset("val", ds_cfg)
    state = create_train_state(cpu_model, make_optimizer(
        box_cfg["pipeline"]["Optim"], 1))
    ref = evaluate_box_regression(
        tasks.BoxRegressionTask(is_3d=ds_cfg.get("is_3d", True)), state,
        BatchLoader(cpu_val, batch, shuffle=False))
    ref.update({"baseline_" + k: v for k, v in
                mean_box_baseline(cpu_val, device="cpu").items()})
    check(set(got) == set(ref) and len(got) == 8
          and all(math.isfinite(v) for v in got.values()),
          f"[box] cli.evaluate: {got} vs {ref}")
    rel = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in ref}
    check(all(got[k] == round(ref[k], 6) or r <= TOL_BOX_EVAL
              for k, r in rel.items()),
          f"[box] cli.evaluate {got} vs the CPU's {ref}")
    print(f"[box] cli.evaluate --ckpt {ckpt} (module path, card): "
          f"{json.dumps(got)} in {eval_s:.1f} s; evaluate_box_regression "
          f"and mean_box_baseline on the CPU: "
          f"{json.dumps({k: round(v, 6) for k, v in ref.items()})}, "
          f"relative difference {json.dumps(rel)} (bar {TOL_BOX_EVAL}, or "
          f"equal to 6 places); {card}", flush=True)

    ref_boxes, ref_ok = BoxRegressor.from_checkpoint(
        ckpt, ds_cfg, device="cpu")(frame["points"], centers, oris)
    err = float(np.abs(boxes - ref_boxes).max())
    check(np.array_equal(ok, ref_ok) and ok.all()
          and err <= TOL_BOX_INFER, f"[box] BoxRegressor: max |card - CPU| "
          f"{err}, ok {ok} vs {ref_ok}")
    print(f"[box] BoxRegressor.from_checkpoint on val frame 0 "
          f"({len(frame['points'])} points, {len(centers)} box centres): "
          f"{infer_ms:.1f} ms a call (host clock, crop and resample on the "
          f"host included), boxes within {err:.3g} of the CPU's (bar "
          f"{TOL_BOX_INFER}), ok masks equal; {card}", flush=True)

    for (b, dt), (out, ms, dev_ms) in fwd.items():
        peak = H100_F32_FLOPS if dt == torch.float32 else H100_BF16_FLOPS
        note = ""
        if b == batch and dt == torch.float32:
            with torch.no_grad():
                ref_out = cpu_model(torch.as_tensor(segs["input"][:b]))
            err = max_err(out.cpu(), ref_out)
            top = float(ref_out.abs().max())
            check(err <= TOL_BOX_FWD * top,
                  f"[box] forward B={b}: {err} vs the CPU's")
            note = (f"; max |card - CPU| {err:.3g} = {err / top:.3g} x max "
                    f"(bar {TOL_BOX_FWD})")
        print(f"[box] forward B={b} {str(dt)[6:]}: {ms:.4f} ms a call = "
              f"{b / ms * 1e3:.1f} segments/s (wrapper loop); device "
              f"{dev_ms:.4f} ms (a CUDA graph of {BOX_ITERS} calls) = "
              f"{b / dev_ms * 1e3:.1f}; {macs * b / 1e9:.3f} GMAC, bound "
              f"{2 * macs * b / peak * 1e3:.4f} ms at {peak / 1e12:g} "
              f"TFLOP/s = {dev_ms / (2 * macs * b / peak * 1e3):.2f} x the "
              f"bound{note}; {card}", flush=True)

    ref_iou = rotated_iou_3d_paired(both.cpu(), torch.cat([nb, nb]).cpu())
    # a briefly trained model predicts some boxes of negative volume, whose
    # "IoU" (as in JAX) divides by a clamped difference of volumes, so ulps
    # of the card's sin/cos move it by any amount: the bar holds the rows
    # of positive volume (the targets' and most predictions')
    diff = (iou.cpu() - ref_iou).abs()
    posed = (both[:, 0, 3:6].prod(dim=1) > 0).cpu()
    err = float(diff[posed].max())
    ill, ill_top = 0.0, 0.0
    if (~posed).any():
        ill_top = float(ref_iou[~posed].abs().max())
        ill = float((diff[~posed] / ref_iou[~posed].abs().clamp(min=1.0))
                    .max())
    valid = torch.as_tensor(segs["target_neighbor_valid"][:batch])
    best = torch.where(valid, ref_iou[batch:], -1.0).amax(dim=1)
    check(iou.shape == (2 * batch, nb.shape[1]) and err <= TOL_BOX_IOU
          and bool(posed[batch:].all()) and bool((best > 0.999).all()),
          f"[box] rotated IoU: max |card - CPU| {err}, the targets' best "
          f"{best.min()}")
    print(f"[box] rotated_iou_3d_paired of {batch} predictions x "
          f"{nb.shape[1]} neighbours: {iou_ms:.4f} ms a call (wrapper "
          f"loop), device {iou_dev:.4f} ms (a CUDA graph of {BOX_ITERS} "
          f"calls); on the predictions and on the targets (the targets' "
          f"best IoU over their valid neighbours {float(best.mean()):.6f} "
          f"on average): max |card - CPU| {err:.3g} on the "
          f"{int(posed.sum())} boxes of positive volume (bar "
          f"{TOL_BOX_IOU}); {int((~posed).sum())} predictions of negative "
          f"volume, whose values reach {ill_top:.4g}, differ by up to "
          f"{ill:.3g} x max(|CPU|, 1); {card}", flush=True)
    print(f"[box] launches of the port's kernels in the phase: 0 of "
          f"{len(kernels)} wrappers, no plain version; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s on {card}", flush=True)


# the [fc] phase: the fc detectors at the flagship config's full width (its
# keys with network fc1d / fc1d_fea / fc2d, epochs cut to 1: B=8, 11 scans,
# 56 area-mode cutout points with the matmul gather, the 301-bin polar grid
# from 0 to 30 m, hidden 256, bf16) on [train]'s split sizes; the cutout's
# training options, the banded gate, the stateless export and AdaBoost
FC_NETWORKS = ("fc1d", "fc1d_fea", "fc2d")
FC_PROFILE = (2, 4)     # profile_steps of each run
FC_BANDED_CHUNK = 45    # banded_chunk of the gate check (450 = 10 x 45)
FC_ITERS = 5            # timed calls of the cutout options and the gate
TOL_FC = 1e-4           # card against the CPU, x max |CPU| ([flow], [box])
TOL_BANDED = 1e-4       # banded against dense (tests/test_models_shapes.py)
ADA_RECALL = 0.5        # AdaBoost's recall bar (tests/test_adaboost.py)


def fc_macs(model):
    """Multiply-adds of one beam's forward of a ``PolarGridDetector``: the
    embedding of its ``S*R`` column, the two k=3 convs and the heads."""
    return sum(m.weight.numel() for m in (model.embed, model.ctx1.conv,
                                          model.ctx2.conv, model.cls,
                                          model.reg))


def fc_phase(device, seed, card):
    """The ``[fc]`` phase: ``cli.train`` on each fc network with exact
    launches (``fc1d_fea`` K1 once a step and once for the final
    evaluation, the others none) and a ``profile_steps`` window; one f32
    forward and train-mode loss of each checkpoint on the card against the
    CPU; the module cutout with ``fixed=False``, ``stride=2`` and
    ``area_fast`` against the CPU; ``SpatialDrow``'s train forward banded
    against dense; ``cli.export_model`` of ``fc2d`` and ``drow`` loaded in a
    fresh process, equal to the live forward to the bit; AdaBoost on the
    host."""
    import torch

    from planar_optical_flow_tpu_torch.cli import (
        export_model as export_cli,
    )
    from planar_optical_flow_tpu_torch.cli import train as train_cli
    from planar_optical_flow_tpu_torch.data import (
        DrowDetectionDataset, write_synthetic_drow_split,
    )
    from planar_optical_flow_tpu_torch.data.synthetic import (
        make_synthetic_drow_sequence,
    )
    from planar_optical_flow_tpu_torch.interop.checkpoint import (
        load_weights, save_weights,
    )
    from planar_optical_flow_tpu_torch.models import (
        AdaBoostPersonDetector, SpatialDrow, fc_in_features_of, get_model,
    )
    from planar_optical_flow_tpu_torch.ops import (
        scans_to_cutout, scans_to_polar_grid,
    )
    from planar_optical_flow_tpu_torch.ops.geometry import get_laser_phi
    from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import (
        div_f32,
    )
    from planar_optical_flow_tpu_torch.pipeline import normalize_config
    from planar_optical_flow_tpu_torch.train import tasks
    from planar_optical_flow_tpu_torch.train.trainer import to_device

    t_phase = time.perf_counter()
    root = os.path.join(BUILD_DIR, "fc")
    shutil.rmtree(root, ignore_errors=True)
    data, logs = os.path.join(root, "drow"), os.path.join(root, "logs")
    write_synthetic_drow_split(data, "train", num_sequences=TRAIN_SEQS,
                               num_frames=TRAIN_FRAMES, seed=seed,
                               num_pts=NUM_PTS)
    write_synthetic_drow_split(data, "val", num_sequences=1,
                               num_frames=VAL_FRAMES, seed=seed + 1,
                               num_pts=NUM_PTS)
    flat = dict(FLAGSHIP_CFG, epochs=1, data_dir=data, log_dir=logs)
    b, s = flat["batch_size"], flat["num_scans"] + 1
    cpu_flag = ["--cpu"] if torch.device(device).type == "cpu" else []

    # 1. cli.train on each network, launches counted from 0 before each run
    kernels = wrappers()
    handlers = {sig: signal.getsignal(sig) for sig in (signal.SIGINT,
                                                       signal.SIGTERM)}
    runs = {}
    with counting_plain() as plain_calls:
        for net in FC_NETWORKS:
            cfg = normalize_config(dict(flat, network=net, tag=net))
            cfg["pipeline"]["Trainer"]["profile_steps"] = list(FC_PROFILE)
            path = os.path.join(root, f"{net}.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            for fn in kernels.values():
                fn.launches = 0
            t0 = time.perf_counter()
            try:
                rc = train_cli.main(["--cfg", path] + cpu_flag)
            finally:
                for sig, h in handlers.items():
                    signal.signal(sig, h)
            secs = time.perf_counter() - t0
            launched = {k: fn.launches for k, fn in kernels.items()
                        if fn.launches}
            run_dir = run_dir_of(logs, net)
            losses = run_scalars(run_dir, "TRAIN_loss")
            ms = run_scalars(run_dir, "TRAIN_step_ms")
            ckpt = os.path.join(run_dir, "ckpt", "ckpt_final")
            check(rc == 0 and len(losses) > FC_PROFILE[1]
                  and np.isfinite(losses).all()
                  and os.path.isfile(os.path.join(ckpt, "weights.pt")),
                  f"[fc] cli.train {net}: rc {rc}, losses {losses}")
            # fc1d_fea encodes on K1 (fixed=True, stride 1) once a step and
            # once for the final evaluation's val batch
            want = {"cutout": len(losses) + 1} if net == "fc1d_fea" else {}
            check(launched == want, f"[fc] {net}: launches {launched}, "
                  f"want {want}")
            model = get_model(cfg["model"], in_features=fc_in_features_of(cfg))
            macs = fc_macs(model)
            r = fc_in_features_of(cfg) // s
            nbytes = 2 * (b * s * r * NUM_PTS + sum(
                p.numel() for p in model.parameters()) + b * NUM_PTS * 3)
            t_bound, by = bound(2 * macs * b * NUM_PTS, H100_BF16_FLOPS,
                                nbytes)
            clean = ms[1:FC_PROFILE[0]] + ms[FC_PROFILE[1]:]
            med = float(np.median(clean))
            runs[net] = (cfg, path, ckpt)
            print(f"[fc] cli.train --cfg (network {net}, PolarGridDetector "
                  f"on S*R = {s} x {r} = {s * r} features a beam, hidden "
                  f"{model.embed.out_features}, bf16): {len(losses)} steps "
                  f"of {b} x {s} scans of {NUM_PTS} beams, losses "
                  f"{json.dumps([round(x, 5) for x in losses])}, final "
                  f"checkpoint {ckpt}, launches {json.dumps(launched)} "
                  f"(want {json.dumps(want)}); {secs:.1f} s with its "
                  f"dataset and evaluation; {card}", flush=True)
            print(f"[fc] {net} step_ms {json.dumps([round(x, 3) for x in ms])}"
                  f" median after the first, outside the profiled steps "
                  f"{list(range(*FC_PROFILE))}: {med:.3f} ms; the forward "
                  f"{macs * b * NUM_PTS / 1e9:.3f} GMAC ({macs} a beam), "
                  f"bound {t_bound:.4f} ms ({by}: bf16 at "
                  f"{H100_BF16_FLOPS / 1e12:g} TFLOP/s, {nbytes / 1e6:.1f} MB "
                  f"at {H100_HBM_BYTES / 1e12:g} TB/s); {card}", flush=True)
            trace_window(f"[trace fc {net}]", run_dir, FC_PROFILE, ms,
                         f"steps of DetectionTask ({net}, bf16)", card,
                         {"K1": ("cutout_kernel",)} if want else None)
        calls = plain_calls()
    check(not any(calls.values()), f"[fc] a plain version ran: "
          f"{json.dumps({k: v for k, v in calls.items() if v})}")

    # 2. each checkpoint in f32, one batch: the forward and the train-mode
    # loss on the card against the CPU (fc1d_fea's CPU side takes the
    # card's K1 columns: K1 is held against its plain version in phase 4)
    ds = DrowDetectionDataset(data, "train", num_scans=flat["num_scans"],
                              pedestrian_only=True, train_with_val=True,
                              device=device)
    batch = ds.batch(np.arange(b))
    on = {"card": to_device(batch, device), "cpu": to_device(batch, "cpu")}
    for net, (cfg, _, ckpt) in runs.items():
        task = tasks.DetectionTask(
            cutout_kwargs=cfg["dataset"]["cutout_kwargs"],
            pedestrian_only=True, num_pts=NUM_PTS, encoding=net,
            polar_grid_kwargs=cfg["dataset"]["polar_grid_kwargs"])
        res = {}
        for where, dev in (("card", device), ("cpu", "cpu")):
            model = load_weights(get_model(
                cfg["model"], in_features=fc_in_features_of(cfg)),
                ckpt).to(dev)
            bt = on[where]
            with torch.no_grad():
                enc = (res["card"][0].cpu() if where == "cpu"
                       and net == "fc1d_fea" else task._encode(bt["scans"]))
                fwd = model(enc, False)
                cls, reg, _ = task._losses(*model(enc, True), bt)
            res[where] = (enc, fwd, float(cls + reg))
        (_, f_card, l_card), (_, f_cpu, l_cpu) = res["card"], res["cpu"]
        err = max(max_err(g.cpu(), r) for g, r in zip(f_card, f_cpu))
        top = max(float(r.abs().max()) for r in f_cpu)
        l_err = abs(l_card - l_cpu)
        check(err <= TOL_FC * top and l_err <= TOL_FC * abs(l_cpu),
              f"[fc] {net} card vs CPU: forward {err} (max {top}), loss "
              f"{l_card} vs {l_cpu}")
        print(f"[fc] {net} f32 on one batch of {b}: forward max |card - "
              f"CPU| {err:.3g} = {err / top:.3g} x max; train-mode loss "
              f"{l_card:.7f} vs {l_cpu:.7f} (bar {TOL_FC} x max); {card}",
              flush=True)

    # 3. the module cutout's training options on B x S scans, card vs CPU:
    # every division is one IEEE division on both devices (div_f32), so the
    # cutouts are equal to the bit on the beams whose window angle (atan)
    # the two compute alike; a beam whose atan differs in an ulp may move a
    # tap's band edge by one beam
    rng = np.random.default_rng(seed)
    scans = torch.tensor(rng.uniform(0.5, 25.0, (b, s, NUM_PTS)),
                         dtype=torch.float32)
    scans_d = scans.to(device)
    phi = get_laser_phi(num_pts=NUM_PTS)
    ww = CUTOUT_KW["window_width"]
    for name, opts in (("fixed=False", dict(fixed=False)),
                       ("stride=2", dict(stride=2)),
                       ("area_fast", dict(gather_mode="gather",
                                          area_fast=True))):
        kw = dict(CUTOUT_KW, **opts)
        got = scans_to_cutout(scans_d, phi, **kw).cpu()
        ref = scans_to_cutout(scans, phi, **kw)
        dists = scans_d[..., ::kw.get("stride", 1)]
        if not kw["fixed"]:
            dists = dists[..., -1:, :].expand(dists.shape)
        alike = (torch.atan(div_f32(0.5 * ww, torch.clamp(
            dists, min=1e-2))).cpu() == torch.atan(div_f32(
                0.5 * ww, torch.clamp(dists.cpu(), min=1e-2))))
        alike = alike.transpose(-1, -2)  # (B, P', S), as the cutouts
        rows_eq = (got == ref).all(-1)
        err = max_err(got, ref)
        err_other = max_err(got[~alike], ref[~alike]) if (~alike).any() \
            else 0.0
        check(got.shape == ref.shape and bool(rows_eq[alike].all())
              and bool(torch.isfinite(got).all()),
              f"[fc] cutout {name}: {int((~rows_eq[alike]).sum())} beams "
              f"whose atan agrees differ")
        ms = time_ms(lambda: scans_to_cutout(scans_d, phi, **kw), FC_ITERS)
        print(f"[fc] module cutout {name} (gather_mode "
              f"{kw['gather_mode']}, area mode) on {b} x {s} x {NUM_PTS} "
              f"scans -> {tuple(got.shape)}: {ms:.3f} ms a call; card against "
              f"CPU: the {int(alike.sum())} beams whose atan agrees equal to "
              f"the bit, {int((~alike).sum())} beams' atan differ (max |card "
              f"- CPU| there {err_other:.3g}, {int((~rows_eq).sum())} "
              f"cutouts differ in all; max {err:.3g}); {card}", flush=True)

    # 4. SpatialDrow's train forward, the banded gate against the dense one
    gen = torch.Generator().manual_seed(seed)
    cut = CUTOUT_KW["num_cutout_pts"]
    dense = SpatialDrow(0.5, WINDOW, True, cut, generator=gen).to(device)
    banded = SpatialDrow(0.5, WINDOW, True, cut,
                         banded_chunk=FC_BANDED_CHUNK, generator=gen)
    banded = banded.to(device)
    banded.load_state_dict(dense.state_dict())
    x = scans_to_cutout(scans_d, phi, **CUTOUT_KW)  # (B, P, S, C)
    with torch.no_grad():
        out_d = dense(x, True)
        out_b = banded(x, True)
        ms_d = time_ms(lambda: dense(x, True), FC_ITERS, warmup=1)
        ms_b = time_ms(lambda: banded(x, True), FC_ITERS, warmup=1)
    for name, g, r in zip(("cls", "reg", "sim_band"), out_b, out_d):
        excess = float(((g - r).abs() - TOL_BANDED * r.abs()).max())
        check(excess <= TOL_BANDED, f"[fc] banded {name}: {excess}")
    errs = [max_err(g, r) for g, r in zip(out_b, out_d)]
    print(f"[fc] SpatialDrow train forward on {tuple(x.shape)} cutouts, "
          f"window {WINDOW}, f32: banded_chunk={FC_BANDED_CHUNK} "
          f"{ms_b:.3f} ms, dense {ms_d:.3f} ms a call; max |banded - dense| "
          f"cls {errs[0]:.3g}, reg {errs[1]:.3g}, sim_band {errs[2]:.3g} "
          f"(bar {TOL_BANDED} + {TOL_BANDED} x |dense|); {card}", flush=True)
    del dense, banded, out_d, out_b
    torch.cuda.empty_cache()

    # 5. cli.export_model of fc2d (its checkpoint) and drow (seeded
    # weights) at B=8, loaded in a fresh process
    out_root = os.path.join(root, "export")
    os.makedirs(out_root)
    drow_cfg = normalize_config(dict(flat, network="cutout", tag="drow"))
    drow_path = os.path.join(root, "drow.json")
    with open(drow_path, "w") as f:
        json.dump(drow_cfg, f)
    drow_w = save_weights(get_model(drow_cfg["model"], cut, generator=gen),
                          os.path.join(root, "drow_weights.pt"))
    fc_cfg, fc_path, fc_ckpt = runs["fc2d"]
    grid = scans_to_polar_grid(scans_d, **fc_cfg["dataset"][
        "polar_grid_kwargs"])
    spec = {"models": [], "device": str(device)}
    live = {}
    for name, cfg, path, weights, x_in in (
            ("fc2d", fc_cfg, fc_path, fc_ckpt, grid),
            ("drow", drow_cfg, drow_path, drow_w, x)):
        out = os.path.join(out_root, name)
        t0 = time.perf_counter()
        check(export_cli.main(["--cfg", path, "--ckpt", weights, "--out",
                               out, "--batch", str(b), "--num-pts",
                               str(NUM_PTS)] + cpu_flag) == 0,
              f"[fc] cli.export_model {name}")
        secs = time.perf_counter() - t0
        model = load_weights(get_model(
            cfg["model"], cut, in_features=fc_in_features_of(cfg)),
            weights).to(device).eval()
        with torch.no_grad():
            live[name] = (tuple(o.cpu() for o in model(x_in)), secs,
                          tuple(x_in.shape))
        torch.save([x_in.cpu()], out + ".inputs.pt")
        spec["models"].append({"name": name, "path": out})
    with open(os.path.join(out_root, "spec.json"), "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--load-artifacts",
         out_root], capture_output=True, text=True,
        timeout=EXPORT_LOAD_TIMEOUT)
    load_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
    check(proc.returncode == 0, f"[fc] the loading process exited "
          f"{proc.returncode}")
    loaded = torch.load(os.path.join(out_root, "loaded.pt"),
                        weights_only=False)
    for name, (want, secs, shape) in live.items():
        got = loaded[name]["out"]
        check(len(got) == len(want) and all(
            g.dtype == w.dtype and torch.equal(g, w)
            for g, w in zip(got, want)),
            f"[fc] {name}: the loaded forward differs from the live one")
        print(f"[fc] cli.export_model {name} at B={b} (input {shape}): "
              f"{secs:.1f} s; loaded in a fresh process, its (cls, reg) "
              f"equal to the live forward to the bit; {card}", flush=True)
    print(f"[fc] the loading process {load_wall:.1f} s", flush=True)

    # 6. AdaBoost on the host (float64 numpy, as in JAX)
    seq = make_synthetic_drow_sequence(num_frames=40, num_people=3, seed=3)
    phi = get_laser_phi(num_pts=seq["scans"].shape[-1])
    t0 = time.perf_counter()
    ada = AdaBoostPersonDetector(n_estimators=20)
    ada.fit(seq["scans"][:30], seq["wps"][:30])
    fit_s = time.perf_counter() - t0
    hits = total = 0
    frames = [t for t in range(1, 40) if len(seq["wps"][t])]
    t0 = time.perf_counter()
    for t in frames:
        xy, _ = ada.detect(seq["scans"][t], phi, prev_scan=seq["scans"][t - 1])
        for rr, a in seq["wps"][t]:
            g = np.array([rr * np.cos(a), rr * np.sin(a)])
            total += 1
            hits += bool(len(xy)) and bool(
                np.linalg.norm(xy - g, axis=1).min() < 0.6)
    det_s = time.perf_counter() - t0
    check(total > 0 and hits / total > ADA_RECALL,
          f"[fc] AdaBoost recall {hits}/{total}")
    print(f"[fc] AdaBoost (host numpy): fit {len(ada.clf.stumps)} stumps on "
          f"30 frames in {fit_s:.3f} s, detect {det_s / len(frames) * 1e3:.2f}"
          f" ms a frame; recall {hits}/{total} = {hits / total:.3f} (bar "
          f"> {ADA_RECALL})", flush=True)
    print(f"[fc] the phase took {time.perf_counter() - t_phase:.1f} s on "
          f"{card}", flush=True)


# the [export] phase: the serving configurations other than int8c p2 and
# v3 (exported at B=EXPORT_SMALL), the stateless models' batch, the box
# regressor's centres, and the reference detector's checkpoint
EXPORT_SMALL = 8
EXPORT_LAYOUTS = ("int8", "pm", "flat", "p2c", "cell", "p2_fused")
EXPORT_MODEL_BATCH = 256
EXPORT_BOX_CENTRES = 8
EXPORT_LOAD_TIMEOUT = 600  # seconds for the loading process


def carry_digests(carry):
    """SHA-256 of every carry tensor's bytes, by name: the loading process
    and this one compare their carries through these (a B=384 carry is
    0.67-1.3 GB a step)."""
    import hashlib

    import torch

    return {k: hashlib.sha256(v.contiguous().view(-1).view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()
        for k, v in sorted(carry.items())}


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_serving(step_or_runner, scans, is_runner):
    """Bootstrap + carried steps on ``scans``: every launch counter set to
    0 just before and read just after. Returns (outputs on the host,
    carry digests, step ms, launches)."""
    for w in wrappers().values():
        w.launches = 0
    outs, digests, step_ms, carry = [], [], [], None
    for scan in scans:
        sync(scan.device)
        t0 = time.perf_counter()
        if is_runner:
            out = step_or_runner(scan)
            carry = step_or_runner._carry
        else:
            carry, out = step_or_runner(carry, scan)
        sync(scan.device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append({k: v.cpu() for k, v in out.items()})
        digests.append(carry_digests(carry))
    launches = {k: w.launches for k, w in wrappers().items()}
    return outs, digests, step_ms, launches


def reference_state_dict(detector):
    """A SpatialDrow's ``state_dict`` under the reference's keys and
    layouts, as ``FlowDROW_pretrained`` holds it (``dr_spaam.`` + the
    reference DROW names: conv blocks ``conv_block_{1-4}.{i}.{0 conv, 1
    BatchNorm}``, ``conv_cls``/``conv_reg`` pointwise convs ``(out, in,
    1)``, the gate embedding a full-width conv ``(128, 256, L)``)."""
    import re

    out = {}
    for key, v in detector.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        v = v.detach().cpu()
        m = re.fullmatch(r"(?:backbone|head)\.block(\d)\.blocks\.(\d+)\."
                         r"(conv|bn)\.(\w+)", key)
        if m:
            idx = 0 if m.group(3) == "conv" else 1
            ref = f"conv_block_{m.group(1)}.{m.group(2)}.{idx}.{m.group(4)}"
        elif key.startswith(("head.cls.", "head.reg.")):
            ref = "conv_" + key[len("head."):]
            v = v[:, :, None] if v.ndim == 2 else v
        elif key == "gate.embed.weight":  # columns over (l, c)
            ref = "gate.conv.0.weight"
            v = v.reshape(v.shape[0], -1, 256).permute(0, 2, 1)
        elif key.startswith("gate.embed."):
            ref = "gate.conv.0." + key.rsplit(".", 1)[1]
        elif key.startswith("gate.embed_bn."):
            ref = "gate.conv.1." + key.rsplit(".", 1)[1]
        else:
            raise KeyError(f"no reference name for {key}")
        out["dr_spaam." + ref] = v.contiguous().clone()
    return out


def export_phase(model, scans, device, calib, card):
    """The ``[export]`` phase: the int8c p2 and v3 steps at B=384, every
    other ``make_serve_step_v3`` configuration at B=8, the flow U-Net and
    the box regressor (``export_model``) exported; loaded in a fresh
    process (``python3 chip_smoke.py --load-artifacts DIR``: no live step
    is reused there) and held to the live steps and forwards to the bit,
    with the same launches; the flagship detector written as a reference
    ``.pth``, imported by ``cli.import_checkpoint`` and served on the int8c
    runner to the bit of the source weights."""
    import torch

    from planar_optical_flow_tpu_torch.cli import (
        import_checkpoint as import_cli,
    )
    from planar_optical_flow_tpu_torch.infer import (
        BoxRegressor, StreamingRunner, export_model, export_serving_engine,
        make_serve_step_v3,
    )
    from planar_optical_flow_tpu_torch.interop.checkpoint import (
        load_weights, save_weights,
    )
    from planar_optical_flow_tpu_torch.models import get_model
    from planar_optical_flow_tpu_torch.pipeline import normalize_config

    t_phase = time.perf_counter()
    root = os.path.join(BUILD_DIR, "export")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    torch.save(scans.cpu(), os.path.join(root, "scans.pt"))
    spec = {"serving": [], "models": []}
    live = {}

    def size_mb(path):
        return sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path)) / 1e6

    def export(name, opts, batch):
        step = make_serve_step_v3(model, CUTOUT_KW, num_pts=NUM_PTS,
                                  device=device, **opts)
        path = os.path.join(root, name)
        t0 = time.perf_counter()
        export_serving_engine(path, step, (batch, NUM_PTS),
                              meta={"engine": name})
        secs = time.perf_counter() - t0
        live[name] = dict(zip(("outs", "digests", "ms", "launches"),
                              run_serving(step, scans[:, :batch], False)),
                          export_s=secs, mb=size_mb(path))
        spec["serving"].append({"name": name, "path": path, "batch": batch})
        del step
        torch.cuda.empty_cache()

    export("int8c", dict(precision="int8c", calib=calib), BATCH)
    export("v3", dict(precision="bf16"), BATCH)
    for name in EXPORT_LAYOUTS:
        export(name, dict(LAYOUTS[name][0], calib=calib), EXPORT_SMALL)

    # the stateless models at their full widths, seeded weights
    gen = torch.Generator().manual_seed(7)
    rng = np.random.default_rng(7)
    flow = get_model({"type": "flow_unet"}, generator=gen).to(device).eval()
    box = get_model({"type": "box_reg"}, generator=gen).to(device).eval()
    box_cfg = {"is_3d": True, "input_size": 256, "radius_segment": 0.5,
               "input_with_angle": True, "min_segment_size": 1}
    model_inputs = {
        "flow_unet": (flow, tuple(torch.tensor(rng.normal(
            0, 3, (EXPORT_MODEL_BATCH, NUM_PTS, 2)), dtype=torch.float32,
            device=device) for _ in range(2))),
        "box_reg": (box, (torch.tensor(rng.normal(
            0, 1, (EXPORT_MODEL_BATCH, 256, 4)), dtype=torch.float32,
            device=device),)),
        "box_reg_b8": (box, (torch.zeros(EXPORT_BOX_CENTRES, 256, 4,
                                         device=device),)),
    }
    with torch.no_grad():
        for name, (net, inputs) in model_inputs.items():
            path = os.path.join(root, name)
            t0 = time.perf_counter()
            export_model(path, net, inputs, meta={
                "model_type": name.split("_b")[0]})
            live[name] = dict(export_s=time.perf_counter() - t0,
                              mb=size_mb(path), out=net(*inputs).cpu())
            torch.save([t.cpu() for t in inputs],
                       os.path.join(path + ".inputs.pt"))
            spec["models"].append({"name": name, "path": path})
    weights = save_weights(box, os.path.join(root, "box_weights.pt"))
    points = rng.uniform(-3, 3, (4000, 3)).astype(np.float32)
    centres = rng.uniform(-2, 2, (EXPORT_BOX_CENTRES, 3)).astype(np.float32)
    np.savez(os.path.join(root, "box_frame.npz"), points=points,
             centres=centres)
    boxes, ok = BoxRegressor.from_checkpoint(weights, box_cfg,
                                             device=device)(points, centres)
    spec["box"] = {"path": os.path.join(root, "box_reg_b8"),
                   "cfg": box_cfg}
    spec["device"] = str(device)
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(spec, f)

    # the programs in a fresh process
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--load-artifacts",
         root], capture_output=True, text=True, timeout=EXPORT_LOAD_TIMEOUT)
    load_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
    check(proc.returncode == 0, f"[export] the loading process exited "
          f"{proc.returncode}")
    loaded = torch.load(os.path.join(root, "loaded.pt"), weights_only=False)

    for job in spec["serving"]:
        name = job["name"]
        want, got = live[name], loaded[name]
        for i, (o_l, o_e) in enumerate(zip(want["outs"], got["outs"])):
            check(set(o_l) == set(o_e), f"[export] {name} step {i} keys")
            for k in o_l:
                check(o_l[k].dtype == o_e[k].dtype
                      and torch.equal(o_l[k], o_e[k]),
                      f"[export] {name} step {i} {k} differs from the live "
                      "step")
        check(want["digests"] == got["digests"],
              f"[export] {name}: the loaded carries differ from the live "
              "step's")
        check(want["launches"] == got["launches"],
              f"[export] {name} launches: live {want['launches']}, loaded "
              f"{got['launches']}")
        ran = {k: v for k, v in want["launches"].items() if v}
        if name in ("int8c", "v3"):
            need = INT8C_KERNELS if name == "int8c" else V3_KERNELS
            check(device.type != "cuda"
                  or all(ran.get(k) == STEPS for k in need),
                  f"[export] {name}: launches {ran}")
            ms_l = float(np.median(want["ms"][1:]))
            ms_e = float(np.median(got["ms"][1:]))
            print(f"[export] {name} B={BATCH}: export {want['export_s']:.1f} "
                  f"s, {want['mb']:.1f} MB, load {got['load_s']:.1f} s; "
                  f"{STEPS} steps equal to the live step to the bit, "
                  f"launches {json.dumps(ran)} both; carried median live "
                  f"{ms_l:.3f} ms = {BATCH / ms_l * 1e3:.1f} scans/s, "
                  f"loaded {ms_e:.3f} ms = {BATCH / ms_e * 1e3:.1f} scans/s "
                  f"on {card}", flush=True)
    small = {job["name"]: round(live[job["name"]]["export_s"], 1)
             for job in spec["serving"] if job["batch"] == EXPORT_SMALL}
    print(f"[export] B={EXPORT_SMALL}, each equal to its live step to the "
          f"bit with the same launches (export s): {json.dumps(small)}",
          flush=True)
    for job in spec["models"]:
        name = job["name"]
        check(torch.equal(live[name]["out"], loaded[name]["out"]),
              f"[export] {name}: the loaded forward differs from the live "
              "one")
    got_boxes, got_ok = loaded["box"]
    check(np.array_equal(got_ok, ok) and np.array_equal(got_boxes, boxes),
          "[export] BoxRegressor.from_artifact differs from "
          "from_checkpoint")
    print(f"[export] export_model equal to the live forward: flow_unet "
          f"B={EXPORT_MODEL_BATCH} ({live['flow_unet']['mb']:.1f} MB), "
          f"box_reg B={EXPORT_MODEL_BATCH} ({live['box_reg']['mb']:.1f} "
          f"MB); BoxRegressor.from_artifact on {EXPORT_BOX_CENTRES} centres "
          f"equal to from_checkpoint; the loading process {load_wall:.1f} s",
          flush=True)

    # a reference .pth of the flagship detector through cli.import_checkpoint
    cfg_path = os.path.join(root, "flagship.json")
    with open(cfg_path, "w") as f:
        json.dump(FLAGSHIP_CFG, f)
    model_cfg = normalize_config(dict(FLAGSHIP_CFG))["model"]
    source = get_model(model_cfg, CUTOUT_KW["num_cutout_pts"])
    source.dr_spaam.load_state_dict(model.dr_spaam.state_dict())
    ref = reference_state_dict(source.dr_spaam)
    # the reference's own flow head, which the importer skips
    ref["flow_conv1.0.weight"] = torch.zeros(128, WINDOW, 3)
    pth = os.path.join(root, "flagship.pth")
    torch.save({"epoch": 40, "it": 40000.0, "model_state": ref,
                "optimizer_state": {}}, pth)
    out_dir = os.path.join(root, "imported")
    check(import_cli.main(["--pth", pth, "--cfg", cfg_path, "--out",
                           out_dir]) == 0, "[export] cli.import_checkpoint")
    imported = load_weights(get_model(model_cfg,
                                      CUTOUT_KW["num_cutout_pts"]), out_dir)
    runs = []
    for net in (source, imported):
        runner = StreamingRunner(net, CUTOUT_KW, num_pts=NUM_PTS,
                                 engine="int8c", calib=calib, device=device)
        runs.append(run_serving(runner, scans, True)[:2])
        del runner
        torch.cuda.empty_cache()
    same = all(torch.equal(a[k], b[k]) for a, b in zip(runs[0][0],
                                                       runs[1][0])
               for k in a) and runs[0][1] == runs[1][1]
    check(same, "[export] the imported checkpoint serves other outputs "
          "than its source weights")
    print(f"[export] reference .pth ({len(ref)} tensors) -> "
          f"cli.import_checkpoint -> int8c runner at B={BATCH}: {STEPS} "
          f"steps equal to the source weights' to the bit; the phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def load_artifacts(root):
    """``--load-artifacts DIR``: the loading side of the ``[export]`` and
    ``[fc]`` phases, in a process of its own. Runs every serving artifact
    of ``DIR/spec.json`` through ``StreamingRunner.from_artifact`` on the
    saved scans, every model artifact on its saved inputs and, where the
    spec names one, ``BoxRegressor.from_artifact`` on the saved frame;
    writes ``DIR/loaded.pt``."""
    import torch

    from planar_optical_flow_tpu_torch.infer import (
        BoxRegressor, StreamingRunner, load_model,
    )

    with open(os.path.join(root, "spec.json")) as f:
        spec = json.load(f)
    device = torch.device(spec["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    # as the exporting process runs: f32 convolutions and products in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    if spec.get("serving"):
        scans = torch.load(os.path.join(root, "scans.pt")).to(device)
    for job in spec.get("serving", ()):
        t0 = time.perf_counter()
        runner = StreamingRunner.from_artifact(job["path"])
        load_s = time.perf_counter() - t0
        outs, digests, step_ms, launches = run_serving(
            runner, scans[:, :job["batch"]], True)
        results[job["name"]] = dict(outs=outs, digests=digests, ms=step_ms,
                                    launches=launches, load_s=load_s)
        del runner
        torch.cuda.empty_cache()
    for job in spec["models"]:
        engine = load_model(job["path"])
        inputs = torch.load(job["path"] + ".inputs.pt")
        out = engine(*inputs)
        results[job["name"]] = {"out": tuple(o.cpu() for o in out)
                                if isinstance(out, (tuple, list))
                                else out.cpu()}
    if "box" in spec:
        frame = np.load(os.path.join(root, "box_frame.npz"))
        results["box"] = BoxRegressor.from_artifact(
            spec["box"]["path"], spec["box"]["cfg"])(frame["points"],
                                                     frame["centres"])
    torch.save(results, os.path.join(root, "loaded.pt"))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, BN statistics and scans")
    ap.add_argument("--load-artifacts", default=None, metavar="DIR",
                    help="the [export] phase's loading process (run by the "
                         "phase itself)")
    args = ap.parse_args(argv)
    if args.load_artifacts:
        return load_artifacts(args.load_artifacts)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from planar_optical_flow_tpu_torch.infer.calibration import (
        calibrate_serve_v3,
    )
    from planar_optical_flow_tpu_torch.infer import fast_gate
    from planar_optical_flow_tpu_torch.ops.kernels import _build, int8_tiles

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
        notes = {}
        for line in rep["log"].splitlines():
            # notes C7510-C7516 and C7518-C7520 say that a wgmma was
            # serialized; C7517 and C7519 that a wait or an arrive was
            # injected
            code = line.partition("(C75")[2][:2]
            if code:
                notes[f"C75{code}"] = notes.get(f"C75{code}", 0) + 1
            if code in SERIAL_NOTES or any(
                    s in line for s in ("Compiling entry", "registers",
                                        "spill", "Performance Loss")):
                print(f"[ptxas {name}] {line.strip()}")
        print(f"[ptxas {name}] notes: {json.dumps(notes)}", flush=True)
        check(name != "backbone_bf16"
              or not any(k[3:] in SERIAL_NOTES for k in notes),
              f"ptxas serialized a wgmma of {name}: {notes}")
        for kernel in CLEAN_KERNELS.get(name, ()):
            serial, spills = kernel_ptxas(rep["log"], kernel)
            print(f"[ptxas {name}] {kernel}: {serial} notes that a wgmma "
                  f"was serialized, {spills} bytes spilled", flush=True)
            check(serial == 0 and spills == 0,
                  f"ptxas serialized a wgmma or spilled in {kernel}")

    p_pad = -(-NUM_PTS // 8) * 8
    p_pm = -(-NUM_PTS // PM_TILE) * PM_TILE
    c = CUTOUT_KW["num_cutout_pts"]
    for lib, fn, arg, note in (
            ("backbone_bf16", "backbone_bf16_smem_bytes", (c, 0), " (K2)"),
            ("backbone_bf16", "backbone_bf16_smem_bytes", (c, 2),
             " (K2 on act1)"),
            ("backbone_bf16", "backbone_bf16_smem_bytes", (c, 1),
             " (K14 bf16)"),
            ("gate", "gate_int8_smem_bytes", (WINDOW,),
             " (K6, at any rows a stream)"),
            ("head_bf16", "head_bf16_smem_bytes", (c // 4,),
             " (K4, and K14's bf16 head)"),
            ("conv_stack_int8", "backbone_int8_smem_bytes", (c, 0, 0),
             " (K5)"),
            ("conv_stack_int8", "backbone_int8_smem_bytes", (c, 1, 0),
             " (K9)"),
            ("conv_stack_int8", "backbone_int8_smem_bytes", (c, 2, 0),
             " (K10, int8 feats)"),
            ("conv_stack_int8", "backbone_int8_smem_bytes", (c, 2, 1),
             " (K10, bf16 feats)"),
            ("conv_stack_int8", "head_int8_smem_bytes", (c // 4,), ""),
            ("conv_stack_int8", "backbone_int8_cut_smem_bytes", (c, p_pad),
             " (K8)"),
            ("serve_cell", "gate_head_int8_smem_bytes", (c // 4,), " (K12)"),
            ("serve_cell_wg", "serve_cell_int8_smem_bytes", (c,), " (K13)"),
            ("gate", "gate_smem_bytes", (NUM_PTS, WINDOW),
             f" at {NUM_PTS} rows a stream (K3 f32, make_serve_step)"),
            ("fused_f32", "fused_backbone_f32_smem_bytes", (c,), " (K14 f32)"),
            ("fused_f32", "fused_head_f32_smem_bytes", (c // 4,),
             " (K14 f32)")):
        f = getattr(_build.load(lib), fn)
        f.restype = ctypes.c_longlong
        f.argtypes = [ctypes.c_int] * len(arg)
        print(f"[smem] {fn[:-len('_smem_bytes')]}: {f(*arg)} bytes of "
              f"dynamic shared memory per block{note}")

    # band_mix_kernel's launch (K3 bf16, K15) as fast_gate mirrors it
    for lib, ct, note in (("gate", p_pad, "K3 bf16"),
                          ("gate", NUM_PTS, "K3 bf16, serve bf16"),
                          ("banded_mix", NUM_PTS, "K15")):
        geo = _build.load(lib).band_mix_geometry
        geo.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
        got = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int(),
               ctypes.c_longlong()]
        geo(ct, WINDOW, *(ctypes.byref(v) for v in got))
        got = tuple(v.value for v in got)
        want = fast_gate.band_mix_geometry(ct, WINDOW)
        print(f"[geometry] {note} at {ct} rows a stream: {got[0]} rows a "
              f"tile, {got[1]} tiles, {got[2]} ring stages, {got[3]} bytes "
              f"of shared memory (fast_gate: {want})", flush=True)
        check(got == want and 2 * (got[3] + fast_gate.BLOCK_RESERVED)
              <= fast_gate.SM_SMEM_BYTES, f"{note} launch geometry {got}")

    # the launch geometry of the wgmma kernels, as the host lays out for it
    geo = _build.load("conv_stack_int8").int8_wg_geometry
    geo.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    geo4 = _build.load("head_bf16").head_bf16_geometry
    geo4.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    geo14 = _build.load("fused_f32").fused_f32_geometry
    geo14.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    geo13 = _build.load("serve_cell_wg").cell_geometry
    geo13.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    geo2 = _build.load("backbone_bf16").backbone_bf16_geometry
    geo2.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    geo8 = _build.load("conv_stack_int8").backbone_int8_cut_geometry
    geo8.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    geo12 = _build.load("serve_cell").gate_head_geometry
    geo12.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    for name, which, l, mode, want in (
            ("K5", 0, c, 0, int8_tiles.backbone_geometry(c, 0)),
            ("K9", 0, c, 1, int8_tiles.backbone_geometry(c, 1)),
            ("K10", 0, c, 2, int8_tiles.backbone_geometry(c, 2)),
            ("K7", 1, c // 4, 0, int8_tiles.head_geometry(c // 4)),
            ("K4 and K14 bf16 head", None, c // 4, None,
             int8_tiles.head_bf16_geometry(c // 4)),
            ("K2", "bf16", c, 0, int8_tiles.backbone_bf16_geometry(c, 0)),
            ("K2 on act1", "bf16", c, 2,
             int8_tiles.backbone_bf16_geometry(c, 2)),
            ("K14 bf16 backbone", "bf16", c, 1,
             int8_tiles.backbone_bf16_geometry(c, 1)),
            ("K13", "cell", c, None, int8_tiles.cell_geometry(c)),
            (f"K8 at {p_pad} beams a stream", "cut", c, p_pad,
             int8_tiles.cut_geometry(c, p_pad)),
            ("K12", "gate_head", c // 4, None,
             int8_tiles.gate_head_geometry(c // 4)),
            ("K14 f32 backbone", "f32", c, 0,
             int8_tiles.fused_backbone_f32_geometry(c)),
            ("K14 f32 head", "f32", c // 4, 1,
             int8_tiles.fused_head_f32_geometry(c // 4))):
        tile, rows, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
        if which is None:
            geo4(l, ctypes.byref(tile), ctypes.byref(rows),
                 ctypes.byref(smem))
        elif which == "cell":
            geo13(l, ctypes.byref(tile), ctypes.byref(rows),
                  ctypes.byref(smem))
        elif which == "cut":
            geo8(l, mode, ctypes.byref(tile), ctypes.byref(rows),
                 ctypes.byref(smem))
        elif which == "gate_head":
            geo12(l, ctypes.byref(tile), ctypes.byref(rows),
                  ctypes.byref(smem))
        elif which == "f32":
            check(geo14(mode, l, ctypes.byref(tile), ctypes.byref(rows),
                        ctypes.byref(smem)) == 0, f"{name} geometry")
        elif which == "bf16":
            check(geo2(l, mode, ctypes.byref(tile), ctypes.byref(rows),
                       ctypes.byref(smem)) == 0, f"{name} geometry")
        else:
            geo(which, l, mode, ctypes.byref(tile), ctypes.byref(rows),
                ctypes.byref(smem))
        got = (tile.value, rows.value, smem.value)
        print(f"[geometry] {name}: {got[0]} cutouts a block, {got[1]} rows a "
              f"cutout, {got[2]} bytes of shared memory (int8_tiles: "
              f"{want})", flush=True)
        check(got == want and got[2] <= int8_tiles.SMEM_MAX,
              f"{name} launch geometry {got}, int8_tiles {want}")

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
    results.update(layouts_kernel_phase(model, scans, calib, device,
                                        TIMED_ITERS))
    torch.cuda.empty_cache()
    results.update(fused_kernel_phase(model, scans, calib, device,
                                      TIMED_ITERS))
    torch.cuda.empty_cache()
    k14_results, k15_launches = k14_k15_kernel_phase(model, scans, device)
    results.update(k14_results)
    torch.cuda.empty_cache()
    launches, ms_v3, ms_int8c = slice_phase(
        model, scans, device, calib, reset_step=3, reset_stream=BATCH // 2)
    torch.cuda.empty_cache()
    runs, step_ms = layouts_slice_phase(model, scans, device, calib)
    torch.cuda.empty_cache()
    engine_runs, engine_ms = engines_slice_phase(model, scans, device, calib)
    runs.update(engine_runs, v3=launches, int8c=launches,
                phase4={"banded_mix_update": k15_launches})
    step_ms.update(engine_ms, v3=ms_v3, int8c=ms_int8c)
    for name in ("v3", "int8c", *LAYOUTS, *engine_ms):
        carried = float(np.median(step_ms[name][1:]))
        print(f"[slice] {name} B={BATCH} step_ms="
              f"{json.dumps([round(t, 3) for t in step_ms[name]])} carried "
              f"median {carried:.3f} ms = {BATCH / carried * 1e3:.1f} "
              f"scans/s on {card}", flush=True)

    torch.cuda.empty_cache()
    files_phase(model, device, args.seed, card)
    torch.cuda.empty_cache()
    train_pipes, det_cfg, det_ckpt = train_phase(device, args.seed, card)
    trace_train_phase(train_pipes, device)
    del train_pipes
    torch.cuda.empty_cache()
    flow_phase(device, card, det_cfg, det_ckpt)
    torch.cuda.empty_cache()
    box_phase(device, card)
    torch.cuda.empty_cache()
    fc_phase(device, args.seed, card)
    torch.cuda.empty_cache()
    trace_phase(model, scans, device, calib)
    torch.cuda.empty_cache()
    trace_phase(model, scans, device, calib, engine="v3")
    torch.cuda.empty_cache()
    export_phase(model, scans, device, calib, card)

    kernels = []
    for name, (src, replaces, wrapper, run) in KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": runs[run][wrapper],
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
