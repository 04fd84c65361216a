"""End-to-end workflow demo on synthetic data, the port's counterpart of
``bin/demo.py``::

    python -m planar_optical_flow_tpu_torch.cli.demo --workdir /tmp/pof_demo \\
        [--cpu] [--det-epochs 3] [--flow-epochs 3] [--video]

1. synthesize a DROW-format dataset (ray-cast room + walking people) and
   its ``.difodom``/``.flow`` files,
2. train the DR-SPAAM detector (person detection on cutouts),
3. graft the trained detector into FlowDROW and train the flow head,
4. run streaming joint inference (detections + per-point flow) and report
   detection AP and flow EPE, optionally rendering a video (needs
   matplotlib).

Runs on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions) "
                             "instead of the card")
    parser.add_argument("--det-epochs", type=int, default=3)
    parser.add_argument("--flow-epochs", type=int, default=3)
    parser.add_argument("--video", action="store_true")
    args = parser.parse_args(argv)
    if args.video:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            parser.error("--video needs matplotlib, which is not installed")

    from planar_optical_flow_tpu_torch import resolve_device
    from planar_optical_flow_tpu_torch.data import write_synthetic_drow_split
    from planar_optical_flow_tpu_torch.data.prepare import prepare_split
    from planar_optical_flow_tpu_torch.eval import evaluate_detection_ap
    from planar_optical_flow_tpu_torch.infer import StreamingRunner
    from planar_optical_flow_tpu_torch.pipeline import Pipeline

    device = resolve_device("cpu" if args.cpu else "cuda")
    work = os.path.abspath(args.workdir)
    data_dir = os.path.join(work, "data")
    if not os.path.isdir(os.path.join(data_dir, "train")):
        print("== generating synthetic DROW dataset")
        write_synthetic_drow_split(data_dir, "train", num_sequences=2,
                                   num_frames=40, seed=1)
        write_synthetic_drow_split(data_dir, "val", num_sequences=1,
                                   num_frames=15, seed=7)
        prepare_split(data_dir, "train", verbose=False, device=device)
        prepare_split(data_dir, "val", verbose=False, device=device)

    cutout_kwargs = dict(fixed=True, centered=True, window_width=1.0,
                         window_depth=0.5, num_cutout_pts=16,
                         padding_val=29.99, area_mode=False)
    base = {
        "batch_size": 8,
        "num_scans": 2,
        "pedestrian_only": True,
        "data_dir": data_dir,
        "log_dir": os.path.join(work, "logs"),
        "similarity_kwargs": {"alpha": 0.5, "window_size": 5},
        "cutout_kwargs": cutout_kwargs,
        "scheduler_kwargs": {"epoch0": 0, "lr0": 1e-3, "epoch1": 20,
                             "lr1": 1e-3},
    }

    print("== stage 1: train DR-SPAAM detector")
    det_cfg = dict(base, epochs=args.det_epochs, model_type="dr-spaam",
                   name="demo_det")
    det_pipe = Pipeline(det_cfg, install_signal_handlers=False,
                        device=device)
    rc = det_pipe.train()
    if rc != 0:
        return rc
    det_ckpt = det_pipe.save_ckpt("detector")
    print(f"   detector checkpoint: {det_ckpt}")

    print("== stage 2: train FlowDROW flow head on the frozen detector")
    flow_cfg = dict(base, epochs=args.flow_epochs, model_type="flow_drow",
                    name="demo_flow")
    flow_pipe = Pipeline(flow_cfg, install_signal_handlers=False,
                         device=device)
    flow_pipe.load_pretrained_detector(det_ckpt)
    rc = flow_pipe.train()
    if rc != 0:
        return rc
    metrics = flow_pipe.evaluate()
    print(f"   flow metrics: {metrics}")

    print("== stage 3: streaming joint inference")
    runner = StreamingRunner(flow_pipe.state.model, cutout_kwargs,
                             device=device)
    ds = flow_pipe.val_set or flow_pipe.train_set
    ap = evaluate_detection_ap(runner, ds, conf_thresh=0.3)
    print(f"   detection AP over {ap['num_frames']} frames: "
          f"{ap['ap']:.3f} (peak F1 {ap['peak_f1']:.3f})")

    if args.video:
        import numpy as np

        from planar_optical_flow_tpu_torch.utils import viz

        runner.reset()
        frames, scans = [], []
        for i in range(min(len(ds), 30)):
            scan = ds.scans_flat[ds.cur_idx[i]][None]
            out = runner(scan)
            keep = out["det_keep"][0].cpu().numpy()
            conf = out["det_cls"][0][:, 0].float().cpu().numpy()
            sel = keep & (conf >= 0.3)
            frames.append({
                "dets": out["det_xys"][0].float().cpu().numpy()[sel],
                "conf": conf[sel],
                "flow": out["pred_flow"][0].float().cpu().numpy(),
            })
            scans.append(scan[0])
        path = os.path.join(work, "demo.mp4")
        viz.render_detection_video(np.stack(scans), frames, path)
        print(f"   video: {path}")

    print("== demo complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
