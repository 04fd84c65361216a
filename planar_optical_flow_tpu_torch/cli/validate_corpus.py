"""Single-command real-corpus validation, the port's counterpart of
``bin/validate_corpus.py``::

    python -m planar_optical_flow_tpu_torch.cli.validate_corpus \\
        /data/DROWv2-data
    python -m planar_optical_flow_tpu_torch.cli.validate_corpus /data/JRDB \\
        --out manifest.json
    python -m planar_optical_flow_tpu_torch.cli.validate_corpus \\
        /data/DROWv2-data --checkpoint dr_spaam_e40.pth --score-ap \\
        [--engine module|v3|int8c] [--cpu]

It detects the layout (DROWv2 CSV/wc/wa/wp/odom2 per split; JRDB
train_dataset tree), reads every sequence end to end (numpy and the native
C++ CSV parser of ``data/native.py`` cross-checked where both exist),
constructs the datasets, runs one train step and one serve step on the
corpus's scans, optionally scores a checkpoint, and writes a pass/fail
manifest with the JAX CLI's stage names. Exit code 0 only when every stage
passed. ``--checkpoint`` takes a reference ``.pth`` (``interop/
torch_ckpt.py``), a port training checkpoint directory or a weights file
(``interop/checkpoint.py``); an orbax directory of the JAX package is
refused. The steps and the scoring run on the card unless ``--cpu`` is
given.

The corpus directory is never written to: flow-target preparation (which
writes ``.difodom``/``.flow`` next to the CSVs) runs on a temp copy of one
sequence.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np


# ----------------------------------------------------------------- helpers


class Manifest:
    def __init__(self):
        self.stages = []

    def run(self, name: str, fn, *args, **kwargs):
        t0 = time.time()
        rec = {"stage": name, "ok": True, "detail": ""}
        try:
            out = fn(*args, **kwargs)
            if isinstance(out, str):
                rec["detail"] = out
        except Exception as e:  # noqa: BLE001 — recorded, not swallowed
            rec["ok"] = False
            rec["detail"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc(limit=6)
            out = None
        rec["seconds"] = round(time.time() - t0, 2)
        self.stages.append(rec)
        mark = "PASS" if rec["ok"] else "FAIL"
        print(f"[{mark}] {name} ({rec['seconds']}s)"
              + (f" — {rec['detail']}" if rec["detail"] else ""),
              flush=True)
        return out

    @property
    def ok(self):
        return all(s["ok"] for s in self.stages)

    def to_dict(self, layout):
        return {"layout": layout, "ok": self.ok, "stages": self.stages}


def detect_layout(root: str) -> str:
    from glob import glob

    if os.path.isdir(os.path.join(root, "train_dataset", "timestamps")):
        return "jrdb"
    for split in ("train", "val", "test"):
        if glob(os.path.join(root, split, "*.csv")):
            return "drow"
    if glob(os.path.join(root, "*.csv")):
        return "drow-flat"
    raise SystemExit(
        f"cannot detect a corpus layout under {root}: expected either "
        "DROWv2 split dirs (train/val/test with *.csv) or a JRDB "
        "train_dataset/ tree")


def _cross_check_csv(path: str) -> str:
    """Parse with numpy AND the native C++ parser; both must agree."""
    from planar_optical_flow_tpu_torch.data import native

    try:
        py = np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)
    except ValueError as e:
        raise ValueError(f"python CSV parse failed on {path}: {e}")
    if native._load() is None:
        # availability probed apart from the parse result: read_csv returns
        # None both when the library is absent and when the parser rejects
        # the file, and the cross-check is there to surface the latter
        return "native parser not built (python only)"
    nat = native.read_csv(path)
    if nat is None:
        raise ValueError(
            f"native CSV parser rejected {path} which python parsed "
            f"({py.shape[0]}x{py.shape[1]}) — parser divergence")
    if nat.shape != py.shape:
        raise ValueError(
            f"native/python shape mismatch on {path}: "
            f"{nat.shape} vs {py.shape}")
    if not np.allclose(nat, py, rtol=1e-6, atol=1e-9):
        i = int(np.argmax(np.abs(nat - py)))
        raise ValueError(
            f"native/python value mismatch on {path} at flat index {i}: "
            f"{nat.ravel()[i]!r} vs {py.ravel()[i]!r}")
    return "native == python"


def _train_step(model, task, batch, device) -> float:
    """One optimizer step of ``task`` on ``batch`` through the trainer's
    own step -> the loss."""
    from planar_optical_flow_tpu_torch.train import (
        Trainer,
        create_train_state,
        make_optimizer,
    )
    from planar_optical_flow_tpu_torch.train.trainer import to_device

    tx = make_optimizer({"scheduler_kwargs": {}}, steps_per_epoch=1)
    state = create_train_state(model, tx)
    trainer = Trainer(None, {}, task, install_signal_handlers=False,
                      device=device)
    _, tb = trainer.train_step(state, to_device(batch, device))
    loss = float(tb["loss"])
    assert np.isfinite(loss), f"train loss not finite: {loss}"
    return loss


# --------------------------------------------------------------- DROW side


def validate_drow(root: str, manifest: Manifest, args, device):
    from planar_optical_flow_tpu_torch.data import drow_io

    splits = [s for s in ("train", "val", "test")
              if drow_io.list_sequences(root, s)]
    if args.layout == "drow-flat" or not splits:
        raise SystemExit(
            "DROWv2 corpora are expected split-wise (train/val/test "
            "subdirectories); flat directories are not a layout the "
            "reference trainers consume")

    all_stems = {s: drow_io.list_sequences(root, s) for s in splits}
    n_seq = sum(len(v) for v in all_stems.values())
    print(f"DROW layout: splits {splits}, {n_seq} sequences")

    num_pts_seen = set()

    def read_sequence(stem):
        msgs = [_cross_check_csv(stem + ".csv")]
        _, _, scans = drow_io.load_scan_file(stem)
        num_pts_seen.add(scans.shape[1])
        if not np.isfinite(scans).all():
            raise ValueError(f"{stem}.csv contains non-finite ranges")
        if os.path.exists(stem + ".odom2"):
            _, _, poses = drow_io.load_odometry_file(stem)
            if not np.isfinite(poses).all():
                raise ValueError(f"{stem}.odom2 contains non-finite poses")
        else:
            msgs.append("no .odom2")
        if os.path.exists(stem + ".wc"):
            drow_io.load_detection_file(stem)
        else:
            msgs.append("no annotations (.wc/.wa/.wp)")
        if os.path.exists(stem + ".flow"):
            drow_io.load_flow_file(stem, num_pts=scans.shape[1])
        return f"{len(scans)} scans; " + "; ".join(msgs)

    for split, stems in all_stems.items():
        for stem in stems:
            manifest.run(f"read {split}/{os.path.basename(stem)}",
                         read_sequence, stem)

    if len(num_pts_seen) > 1:
        def mixed():
            raise ValueError(f"mixed scan widths across sequences: "
                             f"{sorted(num_pts_seen)}")

        manifest.run("uniform scan width", mixed)
    num_pts = max(num_pts_seen) if num_pts_seen else 450

    # flow-target preparation on a temp copy of one sequence (never
    # written into the corpus)
    def prepare_one():
        from planar_optical_flow_tpu_torch.data import FlowScanPairDataset
        from planar_optical_flow_tpu_torch.data.prepare import prepare_split

        split = splits[0]
        stem = all_stems[split][0]
        with tempfile.TemporaryDirectory() as tmp:
            dst = os.path.join(tmp, split)
            os.makedirs(dst)
            for ext in (".csv", ".odom2", ".wc", ".wa", ".wp"):
                if os.path.exists(stem + ext):
                    shutil.copy(stem + ext, dst)
            prepare_split(tmp, split, verbose=False, device=device)
            base = os.path.join(dst, os.path.basename(stem))
            assert os.path.exists(base + ".difodom")
            assert os.path.exists(base + ".flow")
            ds = FlowScanPairDataset(tmp, split)
            n = len(ds)
            if n:
                assert np.isfinite(ds[0]["scan_pair"]).all()
            return f"difodom+flow written; FlowScanPairDataset: {n} pairs"

    manifest.run("prepare flow targets (temp copy)", prepare_one)

    # detection dataset construction over the corpus's files
    def build_detection(split):
        from planar_optical_flow_tpu_torch.data import DrowDetectionDataset

        ds = DrowDetectionDataset(root, split, num_scans=2,
                                  pedestrian_only=True, device=device)
        n = len(ds)
        if n == 0:
            return "0 samples (all-static corpus?)"
        sample = ds[0]
        for k in ("scans", "target_cls", "target_reg"):
            assert k in sample, f"missing batch key {k}"
        return f"{n} samples"

    det_split = "train" if "train" in all_stems else splits[0]
    manifest.run(f"DrowDetectionDataset({det_split})", build_detection,
                 det_split)

    # one train step + one serve step on the corpus's scans
    def train_and_serve():
        import torch

        from planar_optical_flow_tpu_torch.data import (
            BatchLoader,
            DrowDetectionDataset,
        )
        from planar_optical_flow_tpu_torch.infer.streaming import (
            make_stream_step,
        )
        from planar_optical_flow_tpu_torch.models import get_model
        from planar_optical_flow_tpu_torch.train import tasks

        cutout_kwargs = dict(fixed=True, centered=True, window_width=1.0,
                             window_depth=0.5, num_cutout_pts=16,
                             padding_val=29.99, area_mode=True)
        ds = DrowDetectionDataset(root, det_split, num_scans=2,
                                  pedestrian_only=True, device=device)
        if len(ds) < 2:
            return "skipped (not enough samples for a batch)"
        bsz = min(4, len(ds))
        batch = next(iter(BatchLoader(ds, batch_size=bsz, shuffle=False)))
        task = tasks.DetectionTask(cutout_kwargs=cutout_kwargs,
                                   num_pts=num_pts)
        model = get_model({"type": "dr-spaam", "window_size": 5,
                           "pedestrian_only": True}, 16).to(device)
        loss = _train_step(model, task, batch, device)

        serve = make_stream_step(model, cutout_kwargs, num_pts=num_pts,
                                 device=device)
        scans = torch.as_tensor(batch["scans"])[:, -1]
        tmpl, out = serve(None, scans)
        tmpl, out = serve(tmpl, scans)
        assert bool(torch.isfinite(out["pred_cls"]).all())
        return (f"train step loss {loss:.4f}; serve step "
                f"{int(out['det_keep'].sum())} detections")

    manifest.run("one train step + one serve step (real scans)",
                 train_and_serve)

    # optional: score a checkpoint
    if args.checkpoint:
        manifest.run(f"score checkpoint {os.path.basename(args.checkpoint)}",
                     score_checkpoint, root, det_split, args, num_pts,
                     device)


def load_detector(path: str, model) -> str:
    """Load the checkpoint at ``path`` into the DR-SPAAM ``model``: a
    reference ``.pth``, a port training checkpoint directory or a weights
    file. -> what was read."""
    from planar_optical_flow_tpu_torch.interop.checkpoint import (
        WEIGHTS_FILE,
        load_weights,
    )

    if path.endswith(".pth"):
        from planar_optical_flow_tpu_torch.interop import (
            import_torch_checkpoint,
        )

        sd, meta = import_torch_checkpoint(path, model, "dr-spaam")
        model.load_state_dict(sd)
        return f"reference .pth (epoch {meta.get('epoch')})"
    if os.path.isdir(path) and not os.path.exists(
            os.path.join(path, WEIGHTS_FILE)):
        raise ValueError(
            f"{path} is a directory without {WEIGHTS_FILE}: not a training "
            "checkpoint of this package. An orbax checkpoint of the JAX "
            "package cannot be read without JAX; carry flax weights across "
            "with interop.variables_to_state_dict and save them with "
            "interop.checkpoint.save_weights")
    load_weights(model, path)
    return "port weights"


def score_checkpoint(root, split, args, num_pts, device):
    from planar_optical_flow_tpu_torch.data import (
        DrowDetectionDataset,
        drow_io,
    )
    from planar_optical_flow_tpu_torch.eval import (
        DetectionEvalFrames,
        evaluate_detection_ap_batched,
    )
    from planar_optical_flow_tpu_torch.models import get_model

    cutout_kwargs = dict(fixed=True, centered=True, window_width=1.0,
                         window_depth=0.5, num_cutout_pts=56,
                         padding_val=29.99, area_mode=True)
    model = get_model({"type": "dr-spaam", "window_size": 11, "alpha": 0.5,
                       "pedestrian_only": True}, 56)
    what = load_detector(args.checkpoint, model)
    if not args.score_ap:
        return (f"checkpoint imported ({what}; pass --score-ap for an AP "
                "number)")

    # score on val when the corpus has one; otherwise the split that
    # validated (a train-only corpus is still scoreable)
    eval_split = ("val" if drow_io.list_sequences(root, "val")
                  else split)
    ds = DrowDetectionDataset(root, eval_split, num_scans=1,
                              pedestrian_only=True, device=device)
    frames = DetectionEvalFrames.from_dataset(ds)
    if args.max_frames and len(frames) > args.max_frames:
        frames = DetectionEvalFrames(frames.scans[:args.max_frames],
                                     frames.gt[:args.max_frames])
    res = evaluate_detection_ap_batched(
        model, cutout_kwargs, frames, engine=args.engine, device=device)
    return f"AP {res['ap']:.4f} over {len(frames)} frames"


# --------------------------------------------------------------- JRDB side


def validate_jrdb(root: str, manifest: Manifest, args, device):
    from planar_optical_flow_tpu_torch.data import pcd as pcd_lib
    from planar_optical_flow_tpu_torch.data.jrdb import (
        JrdbBoxRegressionDataset,
        JrdbHandle,
    )

    cfg = {"data_dir": root}
    handles = {}
    for split in ("train", "val"):
        def build(split=split):
            h = JrdbHandle(split, dict(cfg))
            handles[split] = h
            return f"{len(h.sequence_names)} sequences, {len(h)} frames"

        manifest.run(f"JrdbHandle({split})", build)

    def read_frames(split):
        h = handles.get(split)
        if h is None:
            raise ValueError(f"handle for {split} failed to build")
        n = len(h)
        limit = min(n, args.max_frames or n)
        n_pts = 0
        for i in range(limit):
            fr = h[i]
            pts = fr["points"]
            if not np.isfinite(pts).all():
                raise ValueError(
                    f"non-finite points in frame {i} of split {split}")
            n_pts += pts.shape[0] if pts.ndim == 2 else pts.shape[1]
            if len(fr["segments"]) != len(fr["boxes"]):
                raise ValueError(
                    f"frame {i}: {len(fr['segments'])} segments vs "
                    f"{len(fr['boxes'])} boxes")
        return f"{limit}/{n} frames read, ~{n_pts // max(limit, 1)} pts/frame"

    for split in ("train", "val"):
        manifest.run(f"read frames ({split})", read_frames, split)

    # decode one raw PCD file (the LZF decoder that serves)
    def cross_check_pcd():
        from glob import glob

        pcds = sorted(glob(os.path.join(
            root, "train_dataset", "pointclouds", "*", "*", "*.pcd")))
        if not pcds:
            return "no .pcd files (2-D laser corpus)"
        pts = pcd_lib.read_pcd_xyz(pcds[0])
        assert np.isfinite(pts).all()
        return f"{os.path.basename(pcds[0])}: {pts.shape[0]} points"

    manifest.run("PCD decode", cross_check_pcd)

    def build_dataset_and_step():
        from planar_optical_flow_tpu_torch.data import BatchLoader
        from planar_optical_flow_tpu_torch.models import get_model
        from planar_optical_flow_tpu_torch.train import tasks

        dcfg = {"data_dir": root, "input_size": 64, "is_3d": True}
        ds = JrdbBoxRegressionDataset("train", dcfg)
        n = len(ds)
        if n < 2:
            return f"{n} segments (not enough for a train step)"
        bsz = min(8, n)
        batch = next(iter(BatchLoader(ds, batch_size=bsz, shuffle=False)))
        model = get_model({"type": "box_reg", "input_dim": 4,
                           "target_dim": 5}).to(device)
        loss = _train_step(model, tasks.BoxRegressionTask(is_3d=True), batch,
                           device)
        return f"{n} segments; train step loss {loss:.4f}"

    manifest.run("JrdbBoxRegressionDataset + one train step",
                 build_dataset_and_step)


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Validate a real DROWv2/JRDB corpus end to end.")
    parser.add_argument("corpus", help="corpus root directory")
    parser.add_argument("--layout", choices=("auto", "drow", "jrdb"),
                        default="auto")
    parser.add_argument("--checkpoint", default=None,
                        help="reference .pth, port training checkpoint "
                             "directory or weights file to score against "
                             "the corpus (DROW layout)")
    parser.add_argument("--score-ap", action="store_true",
                        help="score the checkpoint's detection AP on the "
                             "val split")
    parser.add_argument("--engine", choices=("module", "v3", "int8c"),
                        default="v3")
    parser.add_argument("--max-frames", type=int, default=0,
                        help="cap frames read/scored per split (0 = all)")
    parser.add_argument("--out", default=None,
                        help="write the JSON manifest here")
    parser.add_argument("--cpu", action="store_true",
                        help="run the steps on the CPU (the kernels' plain "
                             "versions) instead of the card")
    args = parser.parse_args(argv)

    from planar_optical_flow_tpu_torch import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    root = os.path.abspath(os.path.expanduser(args.corpus))
    if not os.path.isdir(root):
        raise SystemExit(f"not a directory: {root}")
    layout = detect_layout(root) if args.layout == "auto" else args.layout
    args.layout = layout

    manifest = Manifest()
    if layout.startswith("drow"):
        validate_drow(root, manifest, args, device)
    else:
        validate_jrdb(root, manifest, args, device)

    doc = manifest.to_dict(layout)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
        print(f"manifest -> {args.out}")
    n_fail = sum(not s["ok"] for s in manifest.stages)
    print(f"{'OK' if manifest.ok else 'FAILED'}: "
          f"{len(manifest.stages) - n_fail}/{len(manifest.stages)} "
          "stages passed")
    return 0 if manifest.ok else 1


if __name__ == "__main__":
    sys.exit(main())
