"""Readings for the check's limits: the program, its control and planted
faults over many seeds, in one process (the kernels load once).

    python3 portbench/readings.py --workload <cell> --seconds <s> \
        --plan "program=1,2,3;control=4,5,6;altered_answer=7,8,9" \
        [--f32] [--out chiprun_out/readings.jsonl]

Each run is ``harness.run`` at the cell's own size with the named program
in the runner's place (``variants.py``: ``program``, ``control``, a fault,
or ``int<bits>``, the reference at that precision); ``--f32`` holds every
output to the float32 reference whatever the configuration states
(``check.reference_bits``). One JSON line a run: the check's
numbers, whether they were within the limits, the steps compared and the
run's end-to-end numbers. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from portbench import use_checkout_caches  # noqa: E402

use_checkout_caches()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--plan", required=True)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from portbench import harness, variants
    from portbench.spec import Cell

    cell = Cell(args.workload)
    if args.f32:
        cell.config["check"]["reference_bits"] = None
    out = open(args.out, "a") if args.out else None
    try:
        for part in args.plan.split(";"):
            what, seeds = part.split("=")
            if what == "program":
                program = None
            elif what == "control":
                program = variants.control(cell.config)
            elif what.startswith("int"):
                program = variants.low_precision_reference(int(what[3:]))
            else:
                program = variants.fault(what)
            for seed in seeds.split(","):
                t0 = time.perf_counter()
                res = harness.run(cell, int(seed), args.seconds, False,
                                  program=program, log=lambda s: None)
                line = {"workload": args.workload, "what": what,
                        "reference": "f32" if args.f32 else "config",
                        "seed": int(seed), "correct": res["correct"],
                        "window": res["window"],
                        "numbers": {k: v["value"]
                                    for k, v in res["check"].items()},
                        "metrics": {k: v["value"]
                                    for k, v in res["metrics"].items()},
                        "device": res["device"],
                        "run_s": time.perf_counter() - t0}
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(line) + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
