"""Streaming joint detection + flow over a recorded DROW sequence, the
port's counterpart of ``bin/infer.py``:

    python -m planar_optical_flow_tpu_torch.cli.infer --cfg cfg.json \\
        --ckpt w.pt --sequence seq.csv [--engine module|v3|int8c] [--cpu] \
        [--video out.mp4] [--trace-spans spans.json]

Feeds each scan of the sequence through a ``StreamingRunner`` (cutout,
backbone, template memory, head, flow head and NMS) on the card, or on the
CPU with ``--cpu`` (the kernels' plain versions). ``--ckpt`` is a weight
file of ``interop.checkpoint`` (a torch ``state_dict``); without it the
model keeps its seeded initial weights. ``--artifact DIR`` serves an
artifact of ``cli.export_serving`` instead (``--cfg``, ``--ckpt``,
``--engine`` and the calibration flags do not apply; the artifact must
hold batch 1 and the sequence's beam count, and ``--cpu`` must match the
device it was exported on). ``--video`` renders the scans, detections and
per-instance flow arrows with ``utils.viz.render_detection_video`` (PNG
frames in a directory named after the video where ffmpeg is missing); it
needs matplotlib. ``--trace-spans PATH`` records the runner's and the
step's spans (``utils.tracing``: the runner call, restart, bootstrap and
merge; prepare, cutout, backbone, gate, head, flow head and epilogue; the
set-up's calibration, weight layout and kernel builds) over the frame loop
and writes them to ``PATH`` as Chrome trace JSON (microseconds on the
``time.time_ns`` clock, the clock of a ``torch.profiler`` trace; each
event's args hold its step, parent span and device ms), which opens in
Perfetto.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

REPLAY_WINDOW = 16  # steps in flight under --replay


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m planar_optical_flow_tpu_torch.cli.infer")
    parser.add_argument("--cfg", default=None,
                        help="model config (.json, or .yaml with PyYAML); "
                             "required unless --artifact")
    parser.add_argument("--artifact", default=None,
                        help="serving artifact directory (cli."
                             "export_serving); replaces --cfg, --ckpt and "
                             "--engine: the artifact is self-contained")
    parser.add_argument("--ckpt", default=None,
                        help="weight file written by interop.checkpoint")
    parser.add_argument("--sequence", required=True,
                        help="path to a DROW .csv scan file (stem ok)")
    parser.add_argument("--max-frames", type=int, default=0)
    parser.add_argument("--video", default=None,
                        help="render detections and flow to this video "
                             "(needs matplotlib)")
    parser.add_argument("--conf", type=float, default=0.5)
    parser.add_argument("--world-frame", action="store_true",
                        help="match odometry by timestamp and report "
                             "detections and flow in the world frame")
    parser.add_argument("--engine", choices=("module", "v3", "int8c"),
                        default=None,
                        help="default 'module' (f32); 'v3' = the bf16 "
                             "serving kernels; 'int8c' = the int8 serving "
                             "kernels (scales from calibration.json next "
                             "to --ckpt if present, else calibrated on the "
                             "sequence's first 8 scans)")
    parser.add_argument("--calib", default=None,
                        help="a calibration.json (or a directory holding "
                             "one) for --engine int8c")
    parser.add_argument("--save-calib", default=None,
                        help="write the int8c calibration in use here")
    parser.add_argument("--replay", action="store_true",
                        help=f"keep {REPLAY_WINDOW} steps in flight and "
                             "copy each window's stacked outputs to the "
                             "host at once; the same outputs to the bit")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions) "
                             "instead of the card")
    parser.add_argument("--trace-spans", default=None, metavar="PATH",
                        help="write the runner's and step's spans of the "
                             "frame loop (and the set-up's) to PATH as "
                             "Chrome trace JSON")
    return parser


def _check_args(parser, args):
    if args.video:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            parser.error("--video needs matplotlib, which is not installed")
    if args.artifact:
        # the artifact is self-contained: these would do nothing, or
        # contradict what is baked into it
        for flag, name in ((args.cfg, "--cfg"), (args.ckpt, "--ckpt"),
                           (args.engine, "--engine"),
                           (args.calib, "--calib"),
                           (args.save_calib, "--save-calib")):
            if flag:
                parser.error(f"{name} is incompatible with --artifact")
    elif not args.cfg:
        parser.error("--cfg is required (unless --artifact is given)")
    if args.engine is None:
        args.engine = "module"
    if args.engine != "int8c":
        if args.save_calib:
            parser.error("--save-calib requires --engine int8c")
        if args.calib:
            parser.error("--calib requires --engine int8c")


def _to_host(outs: dict) -> dict:
    """Device tensors -> numpy arrays through one copy: their bytes
    concatenated on the device, copied, split again on the host."""
    keys = list(outs)
    flat = [outs[k].contiguous().reshape(-1).view(torch.uint8) for k in keys]
    host = torch.cat(flat).cpu().numpy()
    got, at = {}, 0
    for k, f in zip(keys, flat):
        t = outs[k]
        n = f.numel()
        dtype = np.dtype(str(t.dtype).replace("torch.", ""))
        got[k] = host[at:at + n].view(dtype).reshape(tuple(t.shape))
        at += n
    return got


def frame_outputs(runner, scans, replay: bool = False):
    """Each scan's runner outputs as numpy arrays, frame by frame; with
    ``replay`` the steps run ``REPLAY_WINDOW`` at a time before one copy of
    the window's stacked outputs."""
    if not replay:
        for scan in scans:
            yield _to_host(runner(scan[None]))
        return
    pending = []
    for i, scan in enumerate(scans):
        pending.append(runner(scan[None]))
        if len(pending) == REPLAY_WINDOW or i == len(scans) - 1:
            got = _to_host({k: torch.stack([o[k] for o in pending])
                            for k in pending[0]})
            for t in range(len(pending)):
                yield {k: v[t] for k, v in got.items()}
            pending = []


def serve_sequence(runner, scans, conf: float = 0.5, poses=None,
                   replay: bool = False, log=print) -> list:
    """The per-frame loop: each frame's kept detections above ``conf``
    (``dets (N, 2)``, ``conf (N,)``), its flow ``(P, 2)`` (None without a
    flow head), in the world frame when ``poses (T, 3)`` are given, and its
    ``instance_mask (P,)`` where the runner outputs one (else None)."""
    results = []
    for i, out in enumerate(frame_outputs(runner, scans, replay)):
        keep = out["det_keep"][0]
        cls = out["det_cls"][0][:, 0]
        sel = keep & (cls >= conf)
        dets = out["det_xys"][0][sel]
        flow = out["pred_flow"][0] if "pred_flow" in out else None
        if poses is not None:
            # sensor -> world: rotate by the heading, translate by the pose
            x, y, h = poses[i]
            c, s = np.cos(h), np.sin(h)
            rot = np.array([[c, -s], [s, c]])
            dets = dets @ rot.T + [x, y]
            if flow is not None:
                flow = flow @ rot.T
        inst = out["instance_mask"][0] if "instance_mask" in out else None
        results.append({"dets": dets, "conf": cls[sel], "flow": flow,
                        "instance_mask": inst})
        if log is not None and i % 50 == 0:
            log(f"frame {i}: {len(dets)} detections")
    return results


def infer(argv=None):
    """The CLI's work: -> (exit code, per-frame results, seconds of the
    frame loop)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    _check_args(parser, args)

    from planar_optical_flow_tpu_torch import resolve_device
    from planar_optical_flow_tpu_torch.data import drow_io
    from planar_optical_flow_tpu_torch.utils import tracing

    device = resolve_device("cpu" if args.cpu else "cuda")
    stem = args.sequence[:-4] if args.sequence.endswith(".csv") \
        else args.sequence
    _, scan_t, scans = drow_io.load_scan_file(stem)
    if args.max_frames:
        scans = scans[: args.max_frames]
        scan_t = scan_t[: args.max_frames]

    poses = None
    if args.world_frame:
        _, odom_t, odom = drow_io.load_odometry_file(stem)
        match = np.argmin(np.abs(scan_t[:, None] - odom_t[None, :]), axis=1)
        poses = odom[match]  # (T, 3) world pose per scan

    if args.artifact:
        runner = _artifact_runner(parser, args.artifact, scans.shape[1],
                                  device)
    else:
        runner = _model_runner(parser, args, scans, device)
    if args.save_calib:
        if runner.calibration is None:
            print("error: no calibration produced to save", file=sys.stderr)
            return 1, [], 0.0
        print(f"calibration saved to "
              f"{runner.calibration.save(args.save_calib)}")

    scans_dev = torch.as_tensor(scans, device=device)
    if args.trace_spans:
        tracing.enable()
    try:
        t0 = time.perf_counter()
        results = serve_sequence(runner, scans_dev, conf=args.conf,
                                 poses=poses, replay=args.replay)
        seconds = time.perf_counter() - t0
    finally:
        if args.trace_spans:
            tracing.enable(False)
    if args.trace_spans:
        path = tracing.write_chrome_trace(args.trace_spans)
        print(f"spans written to {path}")
    if args.video:
        from planar_optical_flow_tpu_torch.utils import viz

        viz.render_detection_video(scans, results, args.video)
        print(f"video written to {args.video}")
    return 0, results, seconds


def _artifact_runner(parser, path, num_pts, device):
    """A runner on the serving artifact at ``path``, checked against what
    the sequence needs: batch 1, ``num_pts`` beams, ``device``."""
    from planar_optical_flow_tpu_torch.infer import StreamingRunner

    runner = StreamingRunner.from_artifact(path)
    meta = runner.meta
    batches = meta.get("batches") or [meta.get("batch")]
    if 1 not in batches:
        parser.error(f"artifact was exported for batch(es) {batches}; "
                     "per-frame inference needs one that includes --batch 1")
    if meta.get("num_pts") != num_pts:
        parser.error(f"artifact expects {meta.get('num_pts')}-pt scans, "
                     f"sequence has {num_pts}")
    if runner.meta["platforms"] != [device.type]:
        parser.error(f"artifact runs on {runner.meta['platforms']}, this "
                     f"run on {device.type} (--cpu selects the CPU)")
    return runner


def _model_runner(parser, args, scans, device):
    """The runner of ``--cfg``/``--ckpt``/``--engine``."""
    from planar_optical_flow_tpu_torch.infer import (
        ServeCalibration,
        StreamingRunner,
    )
    from planar_optical_flow_tpu_torch.interop.checkpoint import load_weights
    from planar_optical_flow_tpu_torch.models import (
        STREAMING_MODEL_TYPES,
        get_model,
        num_cutout_pts_of,
    )
    from planar_optical_flow_tpu_torch.pipeline import normalize_config
    from planar_optical_flow_tpu_torch.utils.config import load_config

    cfg = normalize_config(load_config(args.cfg))
    if cfg["model"]["type"] not in STREAMING_MODEL_TYPES:
        parser.error(f"model type {cfg['model']['type']!r} does not serve "
                     f"through the streaming engines "
                     f"({'/'.join(STREAMING_MODEL_TYPES)})")
    model = get_model(cfg["model"], num_cutout_pts_of(cfg))
    if args.ckpt:
        load_weights(model, args.ckpt)

    calib = calib_scans = None
    if args.engine == "int8c":
        if args.calib:
            calib = ServeCalibration.load(args.calib)
        elif args.ckpt:
            calib = ServeCalibration.find(args.ckpt)
        if calib is None:
            # calibrate on the sequence's first scans
            calib_scans = np.asarray(scans[:8], np.float32)

    # only what this CLI reads: detections, flow where the model has a
    # flow head, and the instance ids only for the video's arrow colors
    fields = ["det_xys", "det_cls", "det_keep"]
    if cfg["model"]["type"] == "flow_drow":
        fields.append("pred_flow")
    if args.video:
        fields.append("instance_mask")
    return StreamingRunner(model, cfg["dataset"].get("cutout_kwargs", {}),
                           num_pts=scans.shape[1], engine=args.engine,
                           calib=calib, calib_scans=calib_scans,
                           output_fields=tuple(fields), device=device)


def main(argv=None) -> int:
    return infer(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
