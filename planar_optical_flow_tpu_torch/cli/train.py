"""Training entry point of the port.

Counterpart of ``bin/train.py``, with its flags::

    python -m planar_optical_flow_tpu_torch.cli.train --cfg CFG [--ckpt PATH]
        [--cont] [--tag TAG] [--evaluation] [--synthetic DIR] [--cpu]

``--ckpt`` restores a training checkpoint directory (``train/checkpoint.py``)
before training or evaluating; ``--cont`` resumes from the sigterm
checkpoint of a preempted run; ``--synthetic DIR`` writes a synthetic DROW
corpus under DIR (2 x 40 train frames, 15 val frames, with their
``.difodom``/``.flow`` files) and trains on it. It runs on the card unless
``--cpu`` is given. A ``.json`` config needs no PyYAML. Returns the
trainer's rc: 0, or 1 after a preemption (the sigterm checkpoint written).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--cont", action="store_true",
                        help="resume from the sigterm checkpoint")
    parser.add_argument("--tag", default="")
    parser.add_argument("--evaluation", action="store_true")
    parser.add_argument("--synthetic", default=None,
                        help="write a synthetic corpus under DIR and train "
                             "on it")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the plain kernel versions)")
    args = parser.parse_args(argv)

    from planar_optical_flow_tpu_torch import resolve_device
    from planar_optical_flow_tpu_torch.pipeline import (
        Pipeline,
        normalize_config,
    )
    from planar_optical_flow_tpu_torch.utils.config import load_config

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = normalize_config(load_config(args.cfg, tag=args.tag))
    synthetic_dir = (_make_synthetic(args.synthetic, device)
                     if args.synthetic else None)
    pipeline = Pipeline(cfg, synthetic_dir=synthetic_dir, device=device)
    if args.ckpt:
        pipeline.load_ckpt(args.ckpt)
    elif args.cont and pipeline.sigterm_ckpt_exists():
        pipeline.load_sigterm_ckpt()

    if args.evaluation:
        metrics = pipeline.evaluate()
        print({k: round(v, 6) for k, v in metrics.items()})
        return 0
    rc = pipeline.train()
    if rc == 0:
        pipeline.save_ckpt()
        metrics = pipeline.evaluate()
        pipeline.logger.save_dict("final_metrics", metrics)
    return rc


def _make_synthetic(out_dir: str, device) -> str:
    from planar_optical_flow_tpu_torch.data import write_synthetic_drow_split
    from planar_optical_flow_tpu_torch.data.prepare import prepare_split

    write_synthetic_drow_split(out_dir, "train", num_sequences=2,
                               num_frames=40)
    write_synthetic_drow_split(out_dir, "val", num_sequences=1,
                               num_frames=15, seed=9)
    prepare_split(out_dir, "train", verbose=False, device=device)
    prepare_split(out_dir, "val", verbose=False, device=device)
    return out_dir


if __name__ == "__main__":
    sys.exit(main())
