"""Evaluation entry point, the port's counterpart of ``bin/evaluate.py``:

    python -m planar_optical_flow_tpu_torch.cli.evaluate --cfg cfg.json \\
        [--ckpt CKPT] [--synthetic DIR] [--ap] [--serve-flow] \\
        [--engine auto|module|v3|int8c] [--cpu]

Without ``--ap``/``--serve-flow`` it takes the module path: the
``Pipeline`` of the config (any model type: the flow U-Net's, the DROW
family's, the fc detectors', the box regressor's), the weights of
``--ckpt`` loaded (a training checkpoint directory, or a weights file), and
``Pipeline.evaluate``'s means of the task's metrics over the ``val``
split, else the ``train`` split, printed rounded to 6 places. For
``box_reg`` it then prints the mean-box baseline of the same split
(``eval.mean_box_baseline``), its keys prefixed ``baseline_``: the floor
the model's ``iou`` and ``loss_*`` must beat. ``--synthetic DIR`` first
writes the synthetic corpus of ``cli.train --synthetic`` there (JRDB for
``box_reg``, else DROW splits with their ``.difodom``/``.flow`` files) and
scores that.

With ``--ap`` (detection AP through ``evaluate_detection_ap_batched``)
and/or ``--serve-flow`` (flow EPE/AAE through ``evaluate_flow_serving``,
flow_drow models) it scores a streaming type's serving engines (the fc
detectors have none, as in JAX), ``--ckpt`` being its weights, on the
``val`` split, else ``train``. With
``--artifact DIR`` they score a serving artifact of ``cli.export_serving``
instead of ``--ckpt``'s weights: the exact programs that ship (``--cfg``
still names the dataset; ``--engine`` and ``--ckpt`` do not apply). The
artifact's batch is the largest that fits the frames for ``--ap`` and the
one that scores the most frames for ``--serve-flow``.
"""

from __future__ import annotations

import argparse
import sys


def _artifact_eval_batch(meta, n_frames, num_pts, parser,
                         pick: str = "fit"):
    """The batch to score a serving artifact at, its scan width checked
    first. ``pick="fit"``: the largest exported batch that is at most
    ``n_frames`` (the AP evaluator pads the sequence to whole chunks);
    ``"coverage"``: the one that scores the most frames, ties to the larger
    (the flow evaluator drops the frames past whole batches)."""
    if int(meta["num_pts"]) != int(num_pts):
        parser.error(
            f"artifact was exported for num_pts={meta['num_pts']} but the "
            f"dataset has {num_pts}-beam scans")
    batches = meta.get("batches") or [meta["batch"]]
    fit = [int(b) for b in batches if int(b) <= n_frames]
    if not fit:
        parser.error(
            f"artifact batches {sorted(batches)} all exceed the "
            f"{n_frames} eval frames; re-export with a smaller --batch")
    if pick == "coverage":
        return max(fit, key=lambda b: ((n_frames // b) * b, b))
    return max(fit)


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
                        help="a training checkpoint directory, or a weight "
                             "file written by interop.checkpoint")
    parser.add_argument("--tag", default="")
    parser.add_argument("--synthetic", default=None,
                        help="write the synthetic corpus of cli.train "
                             "--synthetic to this directory and score it")
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
                        help="serving artifact directory (cli."
                             "export_serving): score its programs with "
                             "--ap/--serve-flow; conflicts with --engine "
                             "and --ckpt (the artifact holds both)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)
    if args.artifact:
        if args.engine != "auto":
            parser.error("--engine conflicts with --artifact (the "
                         "artifact's engine is baked in)")
        if args.ckpt:
            parser.error("--ckpt conflicts with --artifact (the artifact's "
                         "weights are baked in)")
        if not (args.ap or args.serve_flow):
            parser.error("--artifact only affects the serving-path "
                         "evaluations; pass --ap and/or --serve-flow")
    if not (args.ap or args.serve_flow):
        return _module_metrics(args)

    from planar_optical_flow_tpu_torch import resolve_device
    from planar_optical_flow_tpu_torch.cli.train import make_synthetic
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
    if args.artifact:
        # loaded before the data is made, so that a missing, foreign or
        # wrong-device artifact fails at once
        return _artifact_metrics(parser, args, cfg, device)

    data_dir = (make_synthetic(args.synthetic, device) if args.synthetic
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


def _artifact_metrics(parser, args, cfg, device) -> dict:
    """``--ap``/``--serve-flow`` on the serving artifact's programs."""
    from planar_optical_flow_tpu_torch.cli.train import make_synthetic
    from planar_optical_flow_tpu_torch.eval import (
        evaluate_detection_ap_batched,
        evaluate_flow_serving,
    )
    from planar_optical_flow_tpu_torch.eval.evaluator import (
        DetectionEvalFrames,
    )
    from planar_optical_flow_tpu_torch.infer import StreamingRunner
    from planar_optical_flow_tpu_torch.infer.export import (
        load_serving_engine,
    )

    engine = load_serving_engine(args.artifact)
    if engine.device.type != device.type:
        parser.error(f"artifact runs on {engine.device.type}, this run on "
                     f"{device.type} (--cpu selects the CPU)")
    data_dir = (make_synthetic(args.synthetic, device) if args.synthetic
                else cfg["dataset"]["data_dir"])
    ds = eval_dataset(cfg, data_dir, device)
    print({"ap_engine": "artifact", "artifact": args.artifact})
    metrics = {}
    if args.ap:
        frames = DetectionEvalFrames.from_dataset(ds)
        b = _artifact_eval_batch(engine.meta, len(frames),
                                 frames.scans.shape[1], parser)
        ap = _rounded(evaluate_detection_ap_batched(
            None, None, frames, batch_streams=b, step=engine,
            device=device))
        print(ap)
        metrics.update(ap)
    if args.serve_flow:
        num_pts = int(ds.scans_flat.shape[-1])
        b = _artifact_eval_batch(engine.meta, len(ds), num_pts, parser,
                                 pick="coverage")
        flow = _rounded(evaluate_flow_serving(
            None, None, ds, runner=StreamingRunner.from_artifact(engine),
            num_pts=num_pts, batch_streams=b, device=device), "serve_")
        print(flow)
        metrics.update(flow)
    return metrics


def _module_metrics(args) -> dict:
    """The module path: ``Pipeline.evaluate`` after ``--ckpt``, and the
    mean-box baseline of box-regression models."""
    from planar_optical_flow_tpu_torch import resolve_device
    from planar_optical_flow_tpu_torch.cli.train import make_synthetic
    from planar_optical_flow_tpu_torch.eval import mean_box_baseline
    from planar_optical_flow_tpu_torch.interop.checkpoint import load_weights
    from planar_optical_flow_tpu_torch.pipeline import (
        Pipeline,
        normalize_config,
    )
    from planar_optical_flow_tpu_torch.utils.config import load_config

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = normalize_config(load_config(args.cfg, tag=args.tag))
    mtype = cfg["model"]["type"]
    synthetic_dir = (make_synthetic(args.synthetic, device, mtype)
                     if args.synthetic else None)
    pipeline = Pipeline(cfg, synthetic_dir=synthetic_dir, device=device,
                        install_signal_handlers=False)
    if args.ckpt:
        load_weights(pipeline.model, args.ckpt)
    metrics = _rounded(pipeline.evaluate(tb_prefix="VAL"))
    print(metrics)
    if mtype == "box_reg":
        base = _rounded(mean_box_baseline(
            pipeline.val_set or pipeline.train_set, device=device),
            "baseline_")
        print(base)
        metrics.update(base)
    return metrics


def main(argv=None) -> int:
    evaluate(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
