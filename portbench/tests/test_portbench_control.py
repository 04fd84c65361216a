"""The check fails what it must, at a size the CPU holds: the control of
each configuration (int4 for int8c, the program's int8c path for bf16) and
every fault a one-card serving cell can have, planted in the timed path.
The cells' runs use the configuration files' own limits."""

import pytest

from portbench import harness, variants
from portbench.spec import Cell
from portbench.tests.tiny import tiny_root


def _run(tmp_path, config, program, mix="steady", seconds=4.0, seed=21):
    # 2 Hz scans of 64-frame sequences: the scene moves 7.5 times as far a
    # step as at 15 Hz, so a few dozen steps hold what a window of the real
    # cell holds (a stale template has left its scene behind); at least 30
    # steps however slow the host
    root = tiny_root(tmp_path, config=config, mix=mix, streams=4,
                     restart_mean=40, scan_hz=2, pool_frames=64)
    cell = Cell(f"tiny.{mix}", root=root)
    return harness.run(cell, seed, seconds, False, device="cpu",
                       program=program, log=lambda s: None, min_steps=30)


@pytest.mark.parametrize("config", ["flowdrow-int8c", "drspaam-bf16"])
def test_control_is_not_correct(tmp_path, config):
    cell_cfg = Cell("flowdrow-int8c.steady").config if config.startswith(
        "flow") else Cell("drspaam-bf16.steady").config
    res = _run(tmp_path, config, variants.control(cell_cfg))
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("kind", variants.FAULTS)
@pytest.mark.parametrize("config", ["flowdrow-int8c", "drspaam-bf16"])
def test_fault_is_not_correct(tmp_path, config, kind):
    res = _run(tmp_path, config, variants.fault(kind), mix="churn")
    assert not res["correct"], (kind, res["check"])


@pytest.mark.parametrize("config", ["flowdrow-int8c", "drspaam-bf16"])
def test_sound_program_is_correct_on_the_same_traffic(tmp_path, config):
    res = _run(tmp_path, config, None, mix="churn")
    assert res["correct"], res["check"]
