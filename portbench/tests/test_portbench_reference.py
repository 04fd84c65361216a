"""The plain reference against the port's float32 path (the module engine,
plain PyTorch on the CPU), through a whole run of the harness at 64 beams:
the same weights and scans give the same outputs, restarts included."""

import pytest

from portbench import harness, variants
from portbench.spec import Cell
from portbench.tests.tiny import tiny_root

# the module engine samples its area cutouts from a 16-bit split of the
# ranges (the configuration's gather_mode: matmul), the reference from the
# float32 ranges: ~1e-4 of the outputs' spread apart
TOL = 2e-3


@pytest.mark.parametrize("config,mix", [("flowdrow-int8c", "steady"),
                                        ("drspaam-bf16", "steady"),
                                        ("flowdrow-int8c", "churn")])
def test_reference_matches_port_f32(tmp_path, config, mix):
    root = tiny_root(tmp_path, config=config, mix=mix, restart_mean=3)
    cell = Cell(f"tiny.{mix}", root=root)
    # the float32 reference, also where the configuration holds its own
    # outputs to the reference at int8
    cell.config["check"]["reference_bits"] = None
    res = harness.run(cell, 2 ** 31 + 99, 3.0, False, device="cpu",
                      program=variants.program_at("module"),
                      log=lambda s: None)
    numbers = {k: v["value"] for k, v in res["check"].items()}
    assert res["window"]["steps"] >= 3
    assert numbers["nms"] == 0
    for k in ("cls", "reg", "flow"):
        if k in numbers:
            assert numbers[k] < TOL, numbers


def test_program_within_limits_at_small_size(tmp_path):
    """The int8c program itself, as the window runs it, is correct."""
    cell = Cell("tiny.steady", root=tiny_root(tmp_path))
    res = harness.run(cell, 5, 1.5, False, device="cpu", log=lambda s: None)
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {"scans_per_s", "step_ms_p95", "setup_s"}
