"""The harness finds a configuration, a mix and a metric by name, also ones
dropped into a throwaway tree."""

import json

from portbench import harness
from portbench.spec import ROOT, Cell
from portbench.tests.tiny import tiny_root

METRIC = '''
def read(ctx):
    return None if ctx["trace"] is None else 42.0
'''


def test_every_cell_of_the_benchmark_resolves():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = Cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.generator().make
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]).read)
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert "setup_s" in names and len(names) == len(set(names))


def test_throwaway_config_mix_and_metric(tmp_path):
    root = tiny_root(tmp_path, config="drspaam-bf16", mix="churn",
                     restart_mean=3, extra_metric=("test.answer", METRIC))
    cell = Cell("tiny.churn", root=root)
    assert cell.config["streams"] == 3 and cell.traffic["pool_frames"] == 16
    reader = cell.reader("test.answer")
    assert reader.read({"trace": object()}) == 42.0
    # a traced run on the CPU has no device trace: the reader finds nothing,
    # and the harness leaves the metric out
    res = harness.run(cell, 3, 0.5, True, device="cpu", log=lambda s: None)
    assert "test.answer" not in res["metrics"]
    assert "runner.reset_step_ms" in res["metrics"]
    assert "backbone_bf16_roofline" not in res["metrics"]
