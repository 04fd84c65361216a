"""On the card (``pytest -m gpu portbench/tests``): one short run of each
cell through ``run.py`` prints a correct result line."""

import json
import subprocess
import sys

import pytest

from portbench.spec import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["flowdrow-int8c.steady",
                                  "drspaam-bf16.steady",
                                  "flowdrow-int8c.churn"])
def test_cell_runs_correct(card, cell):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          cell, "--seed", str(2 ** 31 + 77), "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
