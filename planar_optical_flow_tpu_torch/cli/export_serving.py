"""Export the serving step as a deployment artifact (``torch.export``), the
port's counterpart of ``bin/export_serving.py``:

    python -m planar_optical_flow_tpu_torch.cli.export_serving \\
        --cfg cfg.json --ckpt w.pt --out engines/b128 --batch 128 \\
        [--engine int8c|bf16] [--calib DIR] [--fields a,b] [--cpu]

Builds ``make_serve_step_v3`` for the config's streaming detector (weights
of ``--ckpt``, a weights file or a training checkpoint directory; without
it the seeded initial weights) on the card, or on the CPU with ``--cpu``,
and writes the artifact directory (``boot.pt2``/``step.pt2``, or
``boot_b{B}.pt2``/``step_b{B}.pt2`` for a ``--batch`` list, and
``engine.json``). Load it with ``infer.export.load_serving_engine`` or
``StreamingRunner.from_artifact``, or run it with ``cli.infer --artifact``
and ``cli.evaluate --artifact``; the serving host needs this package
(its import registers the kernels' ops) but not the model, the weights or
the calibration. A CUDA artifact runs only on a card.

``--engine int8c`` (the default, the int8 serving engine) needs the int8
scales: ``--calib``, or the ``calibration.json`` beside ``--ckpt``
(``cli.infer --engine int8c --save-calib``).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m planar_optical_flow_tpu_torch.cli.export_serving")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--ckpt", default=None,
                        help="weights file or training checkpoint (omit for "
                             "the seeded initial weights)")
    parser.add_argument("--out", required=True)
    parser.add_argument("--batch", default="128",
                        help="streams baked into the artifact; a comma list "
                             "(e.g. 1,64,128) exports one program pair per "
                             "batch and the loaded engine routes on the "
                             "scan's batch")
    parser.add_argument("--engine", choices=("int8c", "bf16"),
                        default="int8c")
    parser.add_argument("--calib", default=None,
                        help="calibration.json (or its directory) for "
                             "--engine int8c; default: the one beside "
                             "--ckpt")
    parser.add_argument("--num-pts", type=int, default=450)
    parser.add_argument("--tile", type=int, default=128,
                        help="accepted for parity with the JAX CLI (the "
                             "CUDA kernels choose their own blocks)")
    parser.add_argument("--fields", default=None,
                        help="comma list of the output fields to export "
                             "(default: all)")
    parser.add_argument("--cpu", action="store_true",
                        help="build and export on the CPU (a CPU artifact)")
    args = parser.parse_args(argv)

    from planar_optical_flow_tpu_torch.utils.cli import parse_batches

    batches = parse_batches(parser, args.batch)

    from planar_optical_flow_tpu_torch import resolve_device
    from planar_optical_flow_tpu_torch.infer import ServeCalibration
    from planar_optical_flow_tpu_torch.infer.export import (
        export_serving_engine,
    )
    from planar_optical_flow_tpu_torch.infer.streaming import (
        make_serve_step_v3,
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
    mtype = cfg["model"]["type"]
    # the v3 step is built around the attention-gate cell: only the gated
    # detectors export
    if mtype not in STREAMING_MODEL_TYPES:
        parser.error(f"serving export supports the gated streaming "
                     f"detectors ({'/'.join(STREAMING_MODEL_TYPES)}), "
                     f"not {mtype!r}")
    calib = None
    if args.engine == "int8c":
        if args.calib:
            calib = ServeCalibration.load(args.calib)
        elif args.ckpt:
            calib = ServeCalibration.find(args.ckpt)
        if calib is None:
            parser.error(
                "--engine int8c needs int8 scales: save them with `cli.infer "
                "--engine int8c --save-calib <dir of --ckpt>` or pass "
                "--calib")
    elif args.calib:
        parser.error("--calib requires --engine int8c")

    device = resolve_device("cpu" if args.cpu else "cuda")
    model = get_model(cfg["model"], num_cutout_pts_of(cfg))
    if args.ckpt:
        load_weights(model, args.ckpt)
    fields = tuple(args.fields.split(",")) if args.fields else None
    step = make_serve_step_v3(
        model, cfg["dataset"].get("cutout_kwargs", {}), calib=calib,
        num_pts=args.num_pts, precision=args.engine, tile=args.tile,
        output_fields=fields, device=device)
    shapes = [(b, args.num_pts) for b in batches]
    export_serving_engine(args.out, step,
                          shapes if len(shapes) > 1 else shapes[0], meta={
        "engine": args.engine,
        "model_type": mtype,
        "cfg": os.path.abspath(args.cfg),
        "ckpt": os.path.abspath(args.ckpt) if args.ckpt else None,
        "output_fields": list(fields) if fields else None,
    })
    total = sum(os.path.getsize(os.path.join(args.out, f))
                for f in os.listdir(args.out)) / 1e6
    print(f"exported {args.engine} serving engine (batch "
          f"{','.join(map(str, batches))}, {args.num_pts} pts, "
          f"{device.type}) -> {args.out} ({total:.2f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
