"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole), and ``run.py`` prints no result without a card."""

import subprocess
import sys

import pytest

from portbench.harness import BANNED, banned_modules
from portbench.spec import ROOT

PROBE = r'''
import sys
sys.path[0] = {root!r}
from pathlib import Path
from portbench import harness, variants, readings
from portbench.spec import Cell
from portbench.tests.tiny import tiny_root
root = tiny_root(Path({tmp!r}), mix="churn", restart_mean=3)
harness.run(Cell("tiny.churn", root=root), 1, 0.5, True, device="cpu",
            log=lambda s: None)
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
'''


def test_names_compared_whole():
    assert "planar_optical_flow_tpu_torch" not in BANNED
    assert banned_modules() == [] or "jax" in sys.modules


def test_nothing_of_jax_is_loaded(tmp_path):
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=str(ROOT), tmp=str(tmp_path))],
                         capture_output=True, text=True, timeout=600,
                         check=True)
    top = set(out.stdout.split())
    assert "planar_optical_flow_tpu_torch" in top
    assert top.isdisjoint(BANNED), top & set(BANNED)


@pytest.mark.parametrize("alone", [False, True])
def test_no_result_without_a_card_or_the_port(tmp_path, alone):
    import shutil
    root = ROOT
    if alone:  # only BENCHMARK.json and the benchmark's files
        shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        root = tmp_path
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "flowdrow-int8c.steady", "--seed", str(2 ** 31 + 5),
                          "--seconds", "1", "--trace", "0"], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
