"""Offline ETL of DROW splits, the port's counterpart of
``bin/prepare_data.py``: writes each sequence's ``.difodom`` (odometry
differences) and ``.flow`` (per-point flow targets) next to its ``.csv``::

    python -m planar_optical_flow_tpu_torch.cli.prepare_data \\
        --data-dir data/DROWv2-data --split train val test [--cpu]

The flow targets are computed on the card unless ``--cpu`` is given
(``data/prepare.py prepare_split``).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--split", nargs="+", default=["train", "val", "test"])
    parser.add_argument("--cpu", action="store_true",
                        help="compute the flow targets on the CPU instead of "
                             "the card")
    args = parser.parse_args(argv)

    from planar_optical_flow_tpu_torch.data.prepare import prepare_split

    for split in args.split:
        stems = prepare_split(args.data_dir, split,
                              device="cpu" if args.cpu else "cuda")
        print(f"{split}: {len(stems)} sequences prepared")
    return 0


if __name__ == "__main__":
    sys.exit(main())
