"""Training entry point of the port.

Counterpart of ``bin/train.py``, with its flags::

    python -m planar_optical_flow_tpu_torch.cli.train --cfg CFG [--ckpt PATH]
        [--cont] [--tag TAG] [--evaluation] [--synthetic DIR] [--cpu]

``--ckpt`` restores a training checkpoint directory (``train/checkpoint.py``)
before training or evaluating; ``--cont`` resumes from the sigterm
checkpoint of a preempted run; ``--synthetic DIR`` writes a synthetic
corpus under DIR and trains on it: for ``box_reg`` a JRDB tree
(``data.jrdb.write_synthetic_jrdb``: two train sequences and one val
sequence of 3 frames x 4 boxes), else DROW splits (2 x 40 train frames, 15
val frames, with their ``.difodom``/``.flow`` files). It runs on the card
unless ``--cpu`` is given. A ``.json`` config needs no PyYAML. Returns the
trainer's rc: 0, or 1 after a preemption (the sigterm checkpoint written).

Across devices, launch one process a device with ``torch.distributed.run``
(``python -m torch.distributed.run --nproc_per_node=N -m
planar_optical_flow_tpu_torch.cli.train --cfg CFG``): each rank joins the
process group (NCCL on ``cuda:LOCAL_RANK``; Gloo on the CPU with
``--cpu``), the config's ``pipeline.mesh`` (default: ``data`` over the
world) lays the ranks out, each rank's loader reads its rows of every
batch, and rank 0 writes the synthetic corpus, the logs and the
checkpoints.
"""

from __future__ import annotations

import argparse
import os
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

    import torch.distributed as dist

    from planar_optical_flow_tpu_torch.parallel import initialize_distributed

    device = resolve_device("cpu" if args.cpu else "cuda")
    launched = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if launched:
        device = initialize_distributed(device=device)
    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    try:
        cfg = normalize_config(load_config(args.cfg, tag=args.tag))
        synthetic_dir = None
        if args.synthetic:
            if main_rank:
                make_synthetic(args.synthetic, device, cfg["model"]["type"])
            if dist.is_initialized():
                dist.barrier()
            synthetic_dir = args.synthetic
        pipeline = Pipeline(cfg, synthetic_dir=synthetic_dir, device=device)
        if args.ckpt:
            pipeline.load_ckpt(args.ckpt)
        elif args.cont and pipeline.sigterm_ckpt_exists():
            pipeline.load_sigterm_ckpt()

        if args.evaluation:
            metrics = pipeline.evaluate()
            if main_rank:
                print({k: round(v, 6) for k, v in metrics.items()})
            return 0
        rc = pipeline.train()
        if rc == 0:
            if main_rank:
                pipeline.save_ckpt()
            metrics = pipeline.evaluate()
            if main_rank:
                pipeline.logger.save_dict("final_metrics", metrics)
        return rc
    finally:
        if launched:
            dist.destroy_process_group()


def make_synthetic(out_dir: str, device, model_type: str | None = None
                   ) -> str:
    """The synthetic corpus of ``bin/train.py`` under ``out_dir``: for
    ``model_type`` ``"box_reg"`` the JRDB tree of ``write_synthetic_jrdb``
    with its defaults; else the DROW splits ``train`` (2 sequences x 40
    frames) and ``val`` (1 x 15, seed 9), with their ``.difodom``/``.flow``
    files (computed on ``device``)."""
    from planar_optical_flow_tpu_torch.data import write_synthetic_drow_split
    from planar_optical_flow_tpu_torch.data.jrdb import write_synthetic_jrdb
    from planar_optical_flow_tpu_torch.data.prepare import prepare_split

    if model_type == "box_reg":
        write_synthetic_jrdb(out_dir)
        return out_dir

    write_synthetic_drow_split(out_dir, "train", num_sequences=2,
                               num_frames=40)
    write_synthetic_drow_split(out_dir, "val", num_sequences=1,
                               num_frames=15, seed=9)
    prepare_split(out_dir, "train", verbose=False, device=device)
    prepare_split(out_dir, "val", verbose=False, device=device)
    return out_dir


if __name__ == "__main__":
    sys.exit(main())
