"""Scoring the serving engines on a DROW split, the port's counterpart of
the serving half of ``bin/evaluate.py``:

    python -m planar_optical_flow_tpu_torch.cli.evaluate --cfg cfg.json \\
        --ckpt w.pt [--synthetic DIR] --ap [--serve-flow] \\
        [--engine auto|module|v3|int8c] [--cpu]

``--ap`` scores detection AP through ``evaluate_detection_ap_batched``,
``--serve-flow`` flow EPE/AAE through ``evaluate_flow_serving`` (flow_drow
models), on the config's ``val`` split, else its ``train`` split.
``--synthetic DIR`` first writes synthetic DROW splits there and scores
those. The module-path metrics (``evaluate_flow`` and the task metrics
over a trained state) are ROADMAP item 14b; ``--artifact`` waits for item
19.
"""

from __future__ import annotations

import argparse
import sys

def _resolve_ap_engine(engine, ckpt):
    """``--engine``: "auto" picks "int8c" when a calibration.json sits
    next to ``ckpt``, else "v3" (never calibrating on the scored scans
    unasked). Returns (engine, calib)."""
    calib = None
    if engine in ("auto", "int8c") and ckpt:
        from planar_optical_flow_tpu_torch.infer import ServeCalibration

        calib = ServeCalibration.find(ckpt)
    if engine == "auto":
        engine = "int8c" if calib is not None else "v3"
    return engine, calib


def make_synthetic(out_dir: str) -> str:
    """The synthetic DROW splits of ``bin/train.py``: ``train`` (2
    sequences x 40 frames) and ``val`` (1 x 15, seed 9)."""
    from planar_optical_flow_tpu_torch.data import write_synthetic_drow_split

    write_synthetic_drow_split(out_dir, "train", num_sequences=2,
                               num_frames=40)
    write_synthetic_drow_split(out_dir, "val", num_sequences=1,
                               num_frames=15, seed=9)
    return out_dir


def eval_dataset(cfg: dict, data_dir: str, device):
    """The DROW eval set as the JAX pipeline builds it: ``val``, else
    ``train``."""
    from planar_optical_flow_tpu_torch.data import DrowDetectionDataset

    ds = cfg["dataset"]
    kwargs = dict(num_scans=ds.get("num_scans", 5),
                  pedestrian_only=ds.get("pedestrian_only", False),
                  use_augmentation=ds.get("use_augmentation", False),
                  device=device)
    try:
        return DrowDetectionDataset(data_dir, "val", **kwargs)
    except FileNotFoundError:
        return DrowDetectionDataset(
            data_dir, "train",
            train_with_val=ds.get("train_with_val", False), **kwargs)


def _rounded(d: dict, prefix: str = "") -> dict:
    return {prefix + k: round(v, 6) if isinstance(v, float) else v
            for k, v in d.items()}


def evaluate(argv=None) -> dict:
    """The CLI's work: -> the printed metrics, by name."""
    parser = argparse.ArgumentParser(
        prog="python -m planar_optical_flow_tpu_torch.cli.evaluate")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--ckpt", default=None,
                        help="weight file written by interop.checkpoint")
    parser.add_argument("--tag", default="")
    parser.add_argument("--synthetic", default=None,
                        help="write synthetic DROW splits to this "
                             "directory and score them")
    parser.add_argument("--ap", action="store_true",
                        help="score streaming detection AP")
    parser.add_argument("--serve-flow", action="store_true",
                        help="score flow EPE/AAE through the serving "
                             "engine (flow_drow models)")
    parser.add_argument("--engine", choices=("auto", "module", "v3", "int8c"),
                        default="auto",
                        help="'auto' (default) picks 'int8c' when a "
                             "calibration.json sits next to --ckpt, else "
                             "'v3'; 'module' is the f32 engine")
    parser.add_argument("--artifact", default=None,
                        help="not ported yet (ROADMAP item 19)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)
    if args.artifact:
        parser.error("--artifact is not ported yet (ROADMAP item 19: "
                     "interop and export)")
    if not (args.ap or args.serve_flow):
        parser.error("pass --ap and/or --serve-flow: the module-path "
                     "metrics are not ported yet (ROADMAP items 14b "
                     "and 18)")

    from planar_optical_flow_tpu_torch import resolve_device
    from planar_optical_flow_tpu_torch.eval import (
        evaluate_detection_ap_batched,
        evaluate_flow_serving,
    )
    from planar_optical_flow_tpu_torch.interop.checkpoint import load_weights
    from planar_optical_flow_tpu_torch.models import (
        STREAMING_MODEL_TYPES,
        get_model,
        num_cutout_pts_of,
    )
    from planar_optical_flow_tpu_torch.pipeline import normalize_config
    from planar_optical_flow_tpu_torch.utils.config import load_config

    cfg = normalize_config(load_config(args.cfg, tag=args.tag))
    mtype = cfg["model"]["type"]
    if mtype not in STREAMING_MODEL_TYPES:
        parser.error(f"model type {mtype!r} does not serve through the "
                     f"streaming engines ({'/'.join(STREAMING_MODEL_TYPES)})")
    if args.serve_flow and mtype != "flow_drow":
        parser.error("--serve-flow needs a flow-headed model "
                     f"(flow_drow), not {mtype!r}")
    device = resolve_device("cpu" if args.cpu else "cuda")

    data_dir = (make_synthetic(args.synthetic) if args.synthetic
                else cfg["dataset"]["data_dir"])
    model = get_model(cfg["model"], num_cutout_pts_of(cfg))
    if args.ckpt:
        load_weights(model, args.ckpt)
    ds = eval_dataset(cfg, data_dir, device)
    cutout_kwargs = cfg["dataset"].get("cutout_kwargs", {})

    engine, calib = _resolve_ap_engine(args.engine, args.ckpt)
    metrics = {}
    if args.engine == "auto":
        print({"ap_engine": engine})
    if args.ap:
        ap = _rounded(evaluate_detection_ap_batched(
            model, cutout_kwargs, ds, engine=engine, calib=calib,
            device=device))
        print(ap)
        metrics.update(ap)
    if args.serve_flow:
        flow = _rounded(evaluate_flow_serving(
            model, cutout_kwargs, ds, engine=engine, calib=calib,
            num_pts=ds.scans_flat.shape[-1], device=device), "serve_")
        print(flow)
        metrics.update(flow)
    return metrics


def main(argv=None) -> int:
    evaluate(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
