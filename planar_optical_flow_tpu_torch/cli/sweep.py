"""Experiment-sweep generator, the port's counterpart of ``bin/sweep.py``:
expands a parameter grid over a base YAML config into one config a run,
and with ``--sbatch`` a SLURM launcher each that trains it with the port
under the SIGTERM@120 preemption contract::

    python -m planar_optical_flow_tpu_torch.cli.sweep \\
        --base configs/train_3d_box_regression.yaml \\
        --grid 'pipeline.Trainer.epoch=20,40' 'dataloader.batch_size=64,256' \\
        --out sweeps/boxreg [--sbatch] [--partition gpu] [--time 24:00:00]

Each generated launcher resubmits itself on preemption through ``--cont``.
Host-only; PyYAML is imported when the CLI runs, not with the package.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys


def set_nested(cfg: dict, dotted: str, value):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def parse_value(s: str):
    import yaml

    try:
        v = yaml.safe_load(s)
    except yaml.YAMLError:
        return s
    if isinstance(v, str):
        # YAML 1.1 won't float "1e-3" (needs "1.0e-3"); sweep grids over
        # learning rates shouldn't care
        try:
            return float(v)
        except ValueError:
            return v
    return v


def expand_grid(grid_specs):
    axes = []
    for spec in grid_specs:
        key, _, vals = spec.partition("=")
        axes.append([(key, parse_value(v)) for v in vals.split(",")])
    return [dict(combo) for combo in itertools.product(*axes)]


SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --partition={partition}
#SBATCH --time={time}
#SBATCH --signal=TERM@120
#SBATCH --output={out_dir}/{name}.%j.log

python -m planar_optical_flow_tpu_torch.cli.train --cfg {cfg_path} --cont
if [ $? -eq 1 ]; then
    # preempted: sigterm checkpoint written, requeue ourselves
    sbatch $0
fi
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base", required=True)
    parser.add_argument("--grid", nargs="+", required=True,
                        help="dotted.key=v1,v2 specs")
    parser.add_argument("--out", required=True)
    parser.add_argument("--sbatch", action="store_true")
    parser.add_argument("--partition", default="batch")
    parser.add_argument("--time", default="24:00:00")
    args = parser.parse_args(argv)

    import yaml

    with open(args.base) as f:
        base = yaml.safe_load(f)

    os.makedirs(args.out, exist_ok=True)
    combos = expand_grid(args.grid)
    for i, combo in enumerate(combos):
        cfg = yaml.safe_load(yaml.safe_dump(base))  # deep copy
        parts = []
        for key, val in combo.items():
            set_nested(cfg, key, val)
            parts.append(f"{key.split('.')[-1]}{val}")
        name = f"run{i:03d}_" + "_".join(parts)
        cfg["tag"] = name
        cfg_path = os.path.join(args.out, f"{name}.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        if args.sbatch:
            sb_path = os.path.join(args.out, f"{name}.sh")
            with open(sb_path, "w") as f:
                f.write(SBATCH_TEMPLATE.format(
                    name=name, partition=args.partition, time=args.time,
                    out_dir=args.out, cfg_path=cfg_path,
                ))
        print(f"wrote {cfg_path}")
    print(f"{len(combos)} configs generated under {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
