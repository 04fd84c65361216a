"""Export a stateless model's batch inference as a deployment artifact
(``torch.export``), the port's counterpart of ``bin/export_model.py``:

    python -m planar_optical_flow_tpu_torch.cli.export_model \\
        --cfg configs/prototype_flow.yaml --ckpt CKPT --out engines/flow \\
        --batch 64,1024 [--num-pts 450] [--cpu]

For every type whose forward carries no state, with JAX's example inputs
(``pipeline._example_inputs``): the flow U-Net types
(``engine(scan_xy, scan_xy_next)``, ``(B, num_pts, 2)`` each), the box
regressor (``engine(segments)``, ``(B, input_size, input_dim)``), the
``drow`` detector (``engine(cutouts)``, ``(B, num_pts, num_scans + 1,
num_cutout_pts)``) and the fc detectors (``engine(columns)``, ``(B,
num_scans + 1, R, num_pts)``: ``R`` 1 for ``fc1d``, the cutout points for
``fc1d_fea``, the polar grid's bins for ``fc2d``); the detectors return
``(cls, reg)``. One ``model_b{B}.pt2`` a batch size and ``model.json``,
loaded with ``infer.export.load_model``; the loaded engine routes on the
input's batch. ``infer.BoxRegressor.from_artifact(dir, cfg)`` runs the
whole box-regression API on it. The streaming detectors carry a template:
export them with ``cli.export_serving``.
"""

from __future__ import annotations

import argparse
import os
import sys


def example_inputs(cfg: dict, batch: int, num_pts: int, device) -> tuple:
    """Zero inputs of the model's forward at ``batch``, shaped as JAX's
    ``pipeline._example_inputs`` shapes them."""
    import torch

    from planar_optical_flow_tpu_torch.models import (
        FC_MODEL_TYPES,
        fc_in_features_of,
        num_cutout_pts_of,
    )

    mtype = cfg["model"]["type"]
    if mtype == "box_reg":
        size = cfg["dataset"].get("input_size", 256)
        return (torch.zeros(batch, size, cfg["model"].get("input_dim", 4),
                            device=device),)
    s = cfg["dataset"].get("num_scans", 5) + 1
    if mtype in FC_MODEL_TYPES:
        return (torch.zeros(batch, s, fc_in_features_of(cfg) // s, num_pts,
                            device=device),)
    if mtype == "drow":
        return (torch.zeros(batch, num_pts, s, num_cutout_pts_of(cfg),
                            device=device),)
    x = torch.zeros(batch, num_pts, cfg["model"].get("in_channels", 2),
                    device=device)
    return (x, x)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m planar_optical_flow_tpu_torch.cli.export_model")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--ckpt", default=None,
                        help="weights file or training checkpoint (omit for "
                             "the seeded initial weights)")
    parser.add_argument("--out", required=True)
    parser.add_argument("--batch", default="256",
                        help="batch size(s) baked into the artifact; a comma "
                             "list exports one program per batch")
    parser.add_argument("--num-pts", type=int, default=450,
                        help="points per scan of a flow, drow or fc export "
                             "(box_reg takes the dataset's input_size)")
    parser.add_argument("--cpu", action="store_true",
                        help="export on the CPU (a CPU artifact)")
    args = parser.parse_args(argv)

    from planar_optical_flow_tpu_torch.utils.cli import parse_batches

    batches = parse_batches(parser, args.batch)

    from planar_optical_flow_tpu_torch import resolve_device
    from planar_optical_flow_tpu_torch.infer.export import export_model
    from planar_optical_flow_tpu_torch.interop.checkpoint import load_weights
    from planar_optical_flow_tpu_torch.models import (
        FC_MODEL_TYPES,
        FLOW_MODEL_TYPES,
        STREAMING_MODEL_TYPES,
        fc_in_features_of,
        get_model,
        num_cutout_pts_of,
    )
    from planar_optical_flow_tpu_torch.pipeline import normalize_config
    from planar_optical_flow_tpu_torch.utils.config import load_config

    cfg = normalize_config(load_config(args.cfg))
    mtype = cfg["model"]["type"]
    if mtype in STREAMING_MODEL_TYPES:
        parser.error(f"{mtype!r} is a streaming detector (it carries a "
                     "template); export it with cli.export_serving")
    stateless = (*FLOW_MODEL_TYPES, "box_reg", "drow", *FC_MODEL_TYPES)
    if mtype not in stateless:
        parser.error(f"model type {mtype!r} has no stateless export; "
                     f"{'/'.join(stateless)} do")
    device = resolve_device("cpu" if args.cpu else "cuda")
    model = get_model(cfg["model"], num_cutout_pts_of(cfg),
                      in_features=fc_in_features_of(cfg))
    if args.ckpt:
        load_weights(model, args.ckpt)
    model = model.to(device).eval()
    export_model(args.out, model,
                 [example_inputs(cfg, b, args.num_pts, device)
                  for b in batches], meta={
        "model_type": mtype,
        "cfg": os.path.abspath(args.cfg),
        "ckpt": os.path.abspath(args.ckpt) if args.ckpt else None,
    })
    total = sum(os.path.getsize(os.path.join(args.out, f))
                for f in os.listdir(args.out)) / 1e6
    print(f"exported {mtype} batch-inference artifact (batch "
          f"{','.join(map(str, batches))}, {device.type}) -> {args.out} "
          f"({total:.2f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
