"""Finding a cell's files by name.

``BENCHMARK.json`` at the checkout's root lists the cells, configurations
and metrics. Everything of one configuration, traffic mix or metric is a
file of its own under ``portbench/``, found by its name:

* a configuration: the ``file`` its entry names (``configs/<name>.json``);
* a traffic mix: ``traffic/<mix>.json``, whose ``"generator"`` names the
  module ``traffic/<generator>.py`` that makes the scans (its ``make``);
* a metric: ``metrics/<metric>.py``, whose ``read(ctx)`` returns the value
  or None where the run holds nothing to read;
* a reference: ``reference/<module>.py``, the plain reference the program's
  outputs are held to (its ``Reference``, ``run_streams`` and
  ``fit_batch_norm``).

Besides its sizes, a configuration may state:

* ``angle_inc_deg``: the angle between two beams (default 0.5, DROW's);
  beam ``i`` of ``P`` lies at ``(i - (P - 1) / 2) * angle_inc``. The traffic
  is cast at it and the reference reads it (:func:`angle_inc`), and where
  the key is stated the runner is given it (``angle_inc``, in radians);
* ``reference``: the reference's module (default ``model``);
* ``model_kwargs``, ``runner_kwargs``: passed as they stand to the port's
  model class and to its ``StreamingRunner``; nothing where absent.

A mix may state ``streams``, which overrides the configuration's count
(:attr:`Cell.streams`).
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_ANGLE_INC_DEG = 0.5
DEFAULT_REFERENCE = "model"


def angle_inc(cfg: dict) -> float:
    """The configuration's angle between beams, in radians."""
    return math.radians(float(cfg.get("angle_inc_deg",
                                      DEFAULT_ANGLE_INC_DEG)))


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, mix and
    metrics, read from the files under ``root``."""

    def __init__(self, workload: str, root: Path = ROOT):
        self.root = Path(root)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        entry = configs[self.workload["config"]]
        self.config = json.loads((self.root / entry["file"]).read_text())
        self.traffic = json.loads(
            (self.bench_dir / "traffic" /
             f"{self.workload['traffic']}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"]
                           if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]
        self._reference = None

    @property
    def streams(self) -> int:
        """Streams of the cell: the mix's ``streams``, else the
        configuration's."""
        return int(self.traffic.get("streams", self.config["streams"]))

    @property
    def bench_dir(self) -> Path:
        return self.root / "portbench"

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def generator(self):
        name = self.traffic["generator"]
        return _load_module(self.bench_dir / "traffic" / f"{name}.py",
                            f"portbench_traffic_{name}")

    def reference(self):
        """The module of the configuration's plain reference (loaded
        once)."""
        if self._reference is None:
            name = self.config.get("reference", DEFAULT_REFERENCE)
            self._reference = _load_module(
                self.bench_dir / "reference" / f"{name}.py",
                f"portbench_reference_{name}")
        return self._reference

    def reader(self, metric: str):
        return _load_module(self.bench_dir / "metrics" / f"{metric}.py",
                            "portbench_metric_" + metric.replace(".", "_"))
