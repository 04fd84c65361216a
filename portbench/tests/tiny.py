"""A throwaway benchmark tree at a size the CPU runs in seconds: the real
configuration with 64 beams and a few streams, a small scan pool, and
copies of the real generator, reference and metric readers, under a
temporary root."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REAL = Path(__file__).resolve().parents[1]


def tiny_root(tmp: Path, config="flowdrow-int8c", mix="steady",
              streams=3, num_pts=64, restart_mean=None, scan_hz=None,
              extra_metric=None, pool_frames=16, config_keys=None,
              mix_keys=None) -> Path:
    """Write the tree under ``tmp``; its one cell is ``tiny.<mix>``.
    ``config_keys`` and ``mix_keys`` are set in the configuration and the
    mix last."""
    root = Path(tmp)
    bench = root / "portbench"
    for sub in ("configs", "traffic", "metrics", "reference"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    cfg = json.loads((REAL / "configs" / f"{config}.json").read_text())
    cfg.update(name="tiny", streams=streams, num_pts=num_pts, calib_scans=2)
    cfg["check"]["sample_streams"] = streams
    cfg.update(config_keys or {})
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((REAL / "traffic" / f"{mix}.json").read_text())
    traffic.update(pool_sequences=4, pool_frames=pool_frames)
    if restart_mean is not None:
        traffic["restart_mean_scans"] = restart_mean
    if scan_hz is not None:
        traffic["scan_hz"] = scan_hz
    traffic.update(mix_keys or {})
    (bench / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
    shutil.copy(REAL / "traffic" / "streams.py", bench / "traffic")
    for ref in (REAL / "reference").glob("*.py"):
        shutil.copy(ref, bench / "reference")
    real = json.loads((REAL.parent / "BENCHMARK.json").read_text())
    for m in real["end_to_end"] + real["per_layer"]:
        shutil.copy(REAL / "metrics" / f"{m['name']}.py", bench / "metrics")
    per_layer = [dict(m) for m in real["per_layer"]]
    for m in per_layer:
        m.pop("workloads", None)
    if extra_metric is not None:
        name, source = extra_metric
        (bench / "metrics" / f"{name}.py").write_text(source)
        per_layer.append({"name": name, "unit": "1", "better": "higher",
                          "source": "host_clock", "layer": "test",
                          "moves": "scans_per_s"})
    bench_json = dict(real, per_layer=per_layer, configs=[{
        "name": "tiny", "source": "test",
        "file": "portbench/configs/tiny.json",
        "reduced": ["num_pts", "streams"], "why": "test"}],
        workloads=[{"name": f"tiny.{mix}", "config": "tiny", "traffic": mix,
                    "chips": 1, "why": "test"}])
    (root / "BENCHMARK.json").write_text(json.dumps(bench_json))
    return root
