"""The port's spans and counters (``utils/tracing.py``) on the CPU.

* tracing off: steps record no per-step span and no count, and their
  outputs equal those of steps with tracing on, to the bit;
* tracing on: a restart step's spans nest under ``runner.call`` with one
  step index, and the restart counters count the streams;
* a CPU ``torch.profiler`` session turns tracing on by itself, its span
  events are host-only (no user annotation), and nothing records after it
  stops; the Chrome trace lies on the profiler's clock;
* set-up spans record with tracing off; an exported serving step holds no
  span and equals the live step;
* the benchmark's span metrics (``portbench/metrics``) read the recorder.

Geometry: 64 beams, 16 cutout points, window 5, B=8.
"""

from __future__ import annotations

import copy
import json
import os
import time

import numpy as np
import pytest
import torch

from planar_optical_flow_tpu_torch.infer import (
    StreamingRunner,
    export_serving_engine,
    load_serving_engine,
    make_serve_step_v3,
)
from planar_optical_flow_tpu_torch.models import FlowDrow
from planar_optical_flow_tpu_torch.utils import tracing
from portbench.spec import Cell
from tests.test_torch_common import (
    CT_LEN,
    CUTOUT_KW,
    NUM_PTS,
    WINDOW,
    one_thread,  # noqa: F401 (a fixture)
)

B = 8
STEP_SPANS = {"runner.call", "runner.restart", "runner.bootstrap",
              "runner.carried", "runner.merge", "step.prepare",
              "step.cutout", "step.backbone", "step.gate", "step.head",
              "step.rescale", "step.flow_head", "step.epilogue"}


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


@pytest.fixture(autouse=True)
def _recorder():
    """Each test starts from an empty recorder with tracing off, and leaves
    it so for the tests after it."""
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


@pytest.fixture(scope="module")
def model():
    return FlowDrow(window_size=WINDOW, pedestrian_only=True,
                    num_cutout_pts=CT_LEN,
                    generator=torch.Generator().manual_seed(5)).eval()


def _scans(seed, steps=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.uniform(0.5, 20.0, (steps, B, NUM_PTS)).astype(np.float32))


def _runner(model, engine="v3", scans=None):
    return StreamingRunner(model, CUTOUT_KW, num_pts=NUM_PTS, engine=engine,
                           calib_scans=None if scans is None else scans[0],
                           device="cpu")


def _run(runner, scans, restart=(1,)):
    """Boot, then a step restarting ``restart``, then a carried step."""
    outs = [runner(scans[0])]
    runner.reset(list(restart))
    outs += [runner(scans[1]), runner(scans[2])]
    return outs


def _trace_events(tmp_path):
    path = tracing.write_chrome_trace(tmp_path / "spans.json")
    return json.loads(open(path).read())["traceEvents"]


def test_off_records_nothing(model):
    runner = _runner(model)
    tracing.reset()  # the build's set-up spans
    assert not tracing.active()
    _run(runner, _scans(0))
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


def test_on_changes_no_output(model):
    scans = _scans(0)
    off = _run(_runner(model), scans)
    tracing.enable()
    assert tracing.active()
    on = _run(_runner(model), scans)
    assert set(tracing.snapshot()["spans"]) >= STEP_SPANS - {"step.rescale"}
    for a, b in zip(off, on):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.fixture
def restarted(model):
    """A runner's restart of streams 1 and 3 of 8, traced."""
    runner = _runner(model)
    runner(_scans(1)[0])
    tracing.reset()  # the build's set-up spans
    tracing.enable()
    runner.reset([1, 3])
    runner(_scans(1)[1])
    return tracing.snapshot()


def test_restart_counts_the_streams(restarted):
    # the bootstrap runs on the two restarted streams' rows alone
    assert restarted["counters"] == {"runner.restarted_streams": 2,
                                     "runner.boot_streams": 2}


@pytest.mark.parametrize("batches,boot", [((B,), B), ((B, 2), 2)])
def test_artifact_restart_counts_the_rows_it_bootstraps(model, tmp_path,
                                                        batches, boot):
    """An artifact without a program for the two restarted streams
    bootstraps the whole batch; with one, those two alone. Either way its
    outputs and carry equal the live runner's to the bit."""
    step = make_serve_step_v3(model, CUTOUT_KW, num_pts=NUM_PTS,
                              with_nms=False, device="cpu")
    path = export_serving_engine(str(tmp_path / "engine"), step,
                                 [(b, NUM_PTS) for b in batches])
    art = StreamingRunner.from_artifact(path)
    live = StreamingRunner(model, CUTOUT_KW, num_pts=NUM_PTS, engine="v3",
                           with_nms=False, device="cpu")
    scans = _scans(1)
    for r in (art, live):
        r(scans[0])
        r.reset([1, 3])
    tracing.reset()  # the build's set-up spans
    tracing.enable()
    got = art(scans[1])
    tracing.enable(False)
    assert tracing.snapshot()["counters"] == {"runner.restarted_streams": 2,
                                              "runner.boot_streams": boot}
    want = live(scans[1])
    for got, want in ((got, want), (art._carry, live._carry)):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_restart_step_nests_under_the_call(restarted, tmp_path):
    snap = restarted
    events = _trace_events(tmp_path)
    by_name = {}
    for ev in events:
        assert ev["ph"] == "X" and ev["dur"] >= 0
        by_name.setdefault(ev["name"], []).append(ev["args"])
    assert {a["step"] for ev in events for a in [ev["args"]]} == {
        by_name["runner.call"][0]["step"]}
    assert by_name["runner.call"] == [
        {"step": by_name["runner.call"][0]["step"], "parent": None,
         "device_ms": None}]
    assert by_name["runner.restart"][0]["parent"] == "runner.call"
    for name in ("runner.bootstrap", "runner.carried", "runner.merge"):
        assert [a["parent"] for a in by_name[name]] == ["runner.restart"]
    # the two passes' stages under their pass
    assert sorted(a["parent"] for a in by_name["step.head"]) == [
        "runner.bootstrap", "runner.carried"]
    spans = snap["spans"]
    assert spans["runner.restart"]["count"] == 1
    restart = spans["runner.restart"]
    parts = sum(spans[n]["host_s"] for n in ("runner.bootstrap",
                                             "runner.carried",
                                             "runner.merge"))
    assert restart["self_s"] == pytest.approx(restart["host_s"] - parts,
                                              abs=1e-6)
    assert all(s["device_s"] is None for s in spans.values())


@pytest.fixture
def profiled(model):
    """A restart step under a CPU profiler with tracing off, then a step
    after it: (the profile, the recorder's snapshot after both steps, the
    time the profile stopped)."""
    from torch.profiler import ProfilerActivity, profile

    runner = _runner(model)
    scans = _scans(2)
    runner(scans[0])
    tracing.reset()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    assert tracing.active()
    runner.reset([2])
    runner(scans[1])
    prof.stop()
    stopped_ns = time.time_ns()
    assert not tracing.active()
    runner(scans[2])
    return prof, tracing.snapshot(), stopped_ns


def test_the_profiler_turns_tracing_on(profiled):
    from torch.autograd import DeviceType

    prof, snap, _ = profiled
    assert snap["spans"]["runner.call"]["count"] == 1  # not the step after
    assert snap["counters"]["runner.restarted_streams"] == 1
    seen = {ev.name: ev for ev in prof.events() if ev.name in STEP_SPANS}
    assert set(seen) == set(snap["spans"])
    for ev in seen.values():
        assert ev.device_type == DeviceType.CPU
        assert not ev.is_user_annotation


def test_chrome_trace_on_the_profiler_clock(profiled, tmp_path):
    prof, _, stopped_ns = profiled
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = _trace_events(tmp_path)
    assert events and all(start_ns <= 1e3 * ev["ts"]
                          and 1e3 * (ev["ts"] + ev["dur"]) <= stopped_ns
                          for ev in events)
    call = next(ev for ev in events if ev["name"] == "runner.call")
    prof_call = next(ev for ev in prof.events()
                     if ev.name == "runner.call").time_range
    assert abs(1e3 * call["ts"] - (start_ns + 1e3 * prof_call.start)) < 5e8


def test_setup_spans_record_with_tracing_off(model):
    scans = _scans(3)
    make_serve_step_v3(model, CUTOUT_KW, calib_scans=scans[0],
                       num_pts=NUM_PTS, precision="int8c", device="cpu")
    spans = tracing.snapshot()["spans"]
    assert spans["serve.calibrate"]["count"] == 1
    assert spans["serve.calibrate"]["host_s"] > 0
    assert spans["serve.weights"]["count"] == 1
    assert spans["serve.row_check"]["count"] == 1
    assert not STEP_SPANS & set(spans)


def test_exported_step_holds_no_span(model, tmp_path):
    step = make_serve_step_v3(model, CUTOUT_KW, num_pts=NUM_PTS,
                              with_nms=False, device="cpu")
    tracing.reset()  # the build's set-up spans
    tracing.enable()
    out = export_serving_engine(str(tmp_path / "engine"), step, (2, NUM_PTS))
    assert not tracing.snapshot()["spans"]
    for name in os.listdir(out):
        if name.endswith(".pt2"):
            program = torch.export.load(os.path.join(out, name))
            targets = [str(n.target) for n in program.graph.nodes
                       if n.op == "call_function"]
            assert not [t for t in targets if "profiler" in t
                        or "record_function" in t], name
    engine = load_serving_engine(out)
    scans = _scans(4)[:, :2]
    carry_l = carry_e = None
    for scan in scans:
        carry_l, want = step(carry_l, scan)
        carry_e, got = engine(carry_e, scan)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        for k in carry_l:
            assert torch.equal(carry_e[k], carry_l[k]), k


METRICS = ("runner.bootstrap_ms", "runner.merge_ms", "runner.merge_host_ms",
           "runner.boot_useful_pct", "step.rescale_ms", "step.flow_head_ms",
           "step.epilogue_ms", "step.kernel_host_ms", "setup.calibrate_s")


def _expected(snap):
    spans, cnt = snap["spans"], snap["counters"]
    calls = spans["runner.call"]["count"]
    restarts = spans["runner.restart"]["count"]

    def dev(name):
        return 1e3 * spans[name]["device_s"]

    return {
        "runner.bootstrap_ms": dev("runner.bootstrap") / restarts,
        "runner.merge_ms": dev("runner.merge") / restarts,
        "runner.merge_host_ms":
            1e3 * spans["runner.merge"]["host_s"] / restarts,
        "runner.boot_useful_pct": 100.0 * cnt["runner.restarted_streams"]
            / cnt["runner.boot_streams"],
        "step.rescale_ms": dev("step.rescale")
            / spans["step.rescale"]["count"],
        "step.flow_head_ms": dev("step.flow_head") / calls,
        "step.epilogue_ms": dev("step.epilogue") / calls,
        "step.kernel_host_ms": 1e3 * sum(
            spans[n]["host_s"] for n in ("step.cutout", "step.backbone",
                                         "step.gate", "step.head")) / calls,
        "setup.calibrate_s": spans["serve.calibrate"]["host_s"],
    }


@pytest.fixture(scope="module")
def filled(model):
    """The recorder after an int8c runner's boot, a restart of streams 1
    and 3 and a carried step on the CPU, traced; then emptied again."""
    scans = _scans(5)
    tracing.reset()
    runner = _runner(model, "int8c", scans)
    tracing.enable()
    runner(scans[0])
    runner.reset([1, 3])
    runner(scans[1])
    runner(scans[2])
    snap = tracing.snapshot()
    tracing.enable(False)
    tracing.reset()
    return snap


@pytest.mark.parametrize("metric", METRICS)
def test_span_metric_reads_the_recorder(filled, metric, monkeypatch):
    read = Cell("flowdrow-int8c.churn").reader(metric).read
    traced = {"trace": object()}
    assert read(traced) is None  # an empty recorder
    snap = copy.deepcopy(filled)
    assert snap["spans"]["runner.call"]["count"] == 3
    assert snap["spans"]["step.rescale"]["count"] == 2
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    assert read({"trace": None}) is None  # no device trace
    # a CPU run has no device markers: a device metric finds nothing
    host_only = {"runner.merge_host_ms", "runner.boot_useful_pct",
                 "step.kernel_host_ms", "setup.calibrate_s"}
    if metric not in host_only:
        assert read(traced) is None
    # with device seconds (as a card records them) every metric reads
    for i, s in enumerate(snap["spans"].values()):
        s["device_s"] = 1e-3 * (i + 1)
    want = _expected(snap)
    # the restart bootstraps the restarted streams alone
    assert want["runner.boot_useful_pct"] == pytest.approx(100.0)
    assert read(traced) == pytest.approx(want[metric])


def test_infer_cli_writes_the_spans(tmp_path):
    from planar_optical_flow_tpu_torch.cli import infer as infer_cli
    from planar_optical_flow_tpu_torch.data import write_synthetic_drow_split

    stem = write_synthetic_drow_split(str(tmp_path), "val", num_sequences=1,
                                      num_frames=4, num_people=4, seed=0,
                                      num_pts=NUM_PTS)[0]
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "network": "cutout_spatial", "pedestrian_only": True,
        "num_scans": 2, "cutout_kwargs": CUTOUT_KW,
        "similarity_kwargs": {"alpha": 0.5, "window_size": WINDOW}}))
    argv = ["--cfg", str(cfg), "--sequence", stem + ".csv", "--engine", "v3",
            "--cpu"]
    _, plain, _ = infer_cli.infer(argv)
    path = tmp_path / "spans.json"
    rc, traced, _ = infer_cli.infer(argv + ["--trace-spans", str(path)])
    assert rc == 0 and not tracing.active()
    events = json.loads(path.read_text())["traceEvents"]
    names = [ev["name"] for ev in events]
    assert names.count("runner.call") == 4
    assert {"serve.weights", "step.backbone", "step.epilogue"} <= set(names)
    for got, want in zip(traced, plain):
        for k in ("dets", "conf", "flow"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
