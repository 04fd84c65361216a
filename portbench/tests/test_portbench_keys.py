"""The configuration's beam geometry, reference module and options, and a
mix's stream count: each key reaches every reader, and where no file states
it the pool, the sample, the reference's outputs and the runner's arguments
are those of the harness before the keys existed, to the byte."""

import hashlib
import math

import numpy as np
import pytest
import torch

from portbench import check, harness, variants, weights
from portbench.spec import Cell, angle_inc
from portbench.tests.tiny import tiny_root
from portbench.traffic import streams as gen

SEED = 2 ** 31 + 4242

# sha256 (first 16 hex digits) of each array's bytes, taken with the harness
# as it was before the keys existed, on one CPU thread (the reference's
# convolutions on the CPU sum in another order on more threads)
GOLDEN = {
    "drspaam-bf16": {
        "pool": "009842fe24dd3f0c",
        "schedule": "33b4c4f172f3da3b/f482a4777c10a954",
        "sample": "c431e82c011aea2f",
        "ref_pred_cls": "eeb41a860f909f93",
        "ref_cls_logit": "bef6875a602928b7",
        "ref_pred_reg": "39eee9e571f60989"},
    "flowdrow-int8c": {
        "pool": "009842fe24dd3f0c",
        "schedule": "33b4c4f172f3da3b/f482a4777c10a954",
        "sample": "c431e82c011aea2f",
        "ref_pred_cls": "3664ac2bc4143802",
        "ref_cls_logit": "8ade02552a7f4ea0",
        "ref_pred_reg": "baf00e9690031dd7",
        "ref_pred_flow": "eae5535bfc55c70f"},
}

# what the harness handed the port's model and runner before the keys
MODEL_KEYS = {"alpha", "window_size", "pedestrian_only", "num_cutout_pts",
              "generator"}
RUNNER_KEYS = {"num_pts", "nms_min_dist", "engine", "calib_scans", "device"}


def _sha(a) -> str:
    a = np.ascontiguousarray(np.asarray(a))
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.mark.parametrize("config", sorted(GOLDEN))
def test_defaults_are_byte_identical(tmp_path, one_thread, config):
    cell = Cell("tiny.churn", root=tiny_root(
        tmp_path, config=config, mix="churn", streams=5, restart_mean=3))
    cfg = cell.config
    assert "angle_inc_deg" not in cfg and "reference" not in cfg
    p = int(cfg["num_pts"])
    streams = cell.generator().make(cell.traffic, cell.streams, p, SEED,
                                    "cpu", angle_inc=angle_inc(cfg))
    got = {"pool": _sha(streams.pool.numpy())}
    rows0 = streams.rows_at_start()
    plan = [streams.advance(k) for k in range(24)]
    got["schedule"] = (_sha(np.stack([r for r, _ in plan])) + "/"
                       + _sha(np.concatenate([rs for _, rs in plan])))
    cfg["check"]["sample_streams"] = 3
    sample = harness.sample_streams(cell, SEED)
    got["sample"] = _sha(sample.astype(np.int64))

    module = cell.reference()
    sd = weights.make_state_dict(harness.template_state_dict(cfg), SEED,
                                 "cpu")
    calib = streams.pool[torch.from_numpy(
        rows0[:int(cfg["calib_scans"])])].clone()
    pad = float(cfg["cutout"]["padding_val"])
    module.fit_batch_norm(sd, cfg, check.sanitize(calib, pad))
    rows = np.stack([r[sample] for r, _ in plan])
    boot = np.stack([np.isin(sample, rs) for _, rs in plan])
    boot[0] = True
    scans = check.sanitize(streams.pool[torch.from_numpy(
        rows.reshape(-1))].reshape(rows.shape + (p,)), pad)
    blocks = []
    module.run_streams(check.reference_for(sd, cfg, calib, module), scans,
                       boot, on_block=lambda t0, o: blocks.append(
                           {k: v.numpy().copy() for k, v in o.items()}))
    for k in blocks[0]:
        got["ref_" + k] = _sha(np.concatenate([b[k] for b in blocks]))
    assert got == GOLDEN[config]


def _reference_program(deg):
    """The float32 reference in the runner's place, its beams ``deg``
    apart whatever the configuration states."""
    def make(cell, sd, calib_scans, device, sample):
        cfg = dict(cell.config, angle_inc_deg=deg)
        return variants.LowPrecisionReference(
            cfg, cell.streams, cell.reference(), sd, calib_scans, device,
            sample, None)
    return make


@pytest.mark.parametrize("program_deg,correct", [(1.0, True), (0.5, False)])
def test_toy_geometry_through_the_harness(tmp_path, program_deg, correct):
    # 64 beams 1 degree apart: the traffic, the reference and the check's
    # NMS take the configuration's geometry; a program cast at DROW's 0.5
    # degrees serves other cutouts and other positions
    cell = Cell("tiny.steady", root=tiny_root(
        tmp_path, config="drspaam-bf16", num_pts=64,
        config_keys={"angle_inc_deg": 1.0, "reference": "model"}))
    assert angle_inc(cell.config) == math.radians(1.0)
    res = harness.run(cell, 2 ** 31 + 31, 1.5, False, device="cpu",
                      program=_reference_program(program_deg),
                      log=lambda s: None, min_steps=4)
    assert res["correct"] is correct, res["check"]
    if correct:
        assert res["check"]["nms"]["value"] == 0


def test_pool_is_cast_at_the_angle():
    params = {"pool_sequences": 2, "pool_frames": 8, "people": [2, 4],
              "scan_hz": 15}
    drow = gen.make_pool(params, 64, 7, "cpu")
    assert bool((gen.make_pool(params, 64, 7, "cpu",
                               math.radians(0.5)) == drow).all())
    assert not bool((gen.make_pool(params, 64, 7, "cpu",
                                   math.radians(1.0)) == drow).all())


def test_missing_reference_is_named(tmp_path):
    cell = Cell("tiny.steady", root=tiny_root(
        tmp_path, config_keys={"reference": "panoramic_absent"}))
    with pytest.raises(FileNotFoundError, match="panoramic_absent"):
        harness.run(cell, 1, 0.5, False, device="cpu", log=lambda s: None)


def test_mix_states_the_stream_count(tmp_path):
    cell = Cell("tiny.steady", root=tiny_root(
        tmp_path, config="drspaam-bf16", streams=3, mix_keys={"streams": 5}))
    cell.config["check"]["sample_streams"] = 12
    assert cell.streams == 5 and cell.config["streams"] == 3
    res = harness.run(cell, 2 ** 31 + 5, 0.5, False, device="cpu",
                      log=lambda s: None)
    steps = res["window"]["steps"]
    assert res["attempted"] == 5 * steps
    assert res["window"]["compared"]["streams"] == 5
    assert res["metrics"]["scans_per_s"]["value"] == pytest.approx(
        5 * steps / res["window"]["wall_s"])


class _Recorder:
    """Stands in for the port's model class or runner and keeps what it was
    given."""

    def __init__(self, calls):
        self.calls = calls

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self


def _make_runner_calls(monkeypatch, cfg):
    import planar_optical_flow_tpu_torch.infer.streaming as streaming
    import planar_optical_flow_tpu_torch.models as models

    model_calls, runner_calls = [], []
    for name in ("FlowDrow", "SpatialDrow"):
        monkeypatch.setattr(models, name, _Recorder(model_calls))
    monkeypatch.setattr(streaming, "StreamingRunner",
                        _Recorder(runner_calls))
    harness.build_model(cfg)
    monkeypatch.setattr(harness, "make_model", lambda *a: "model")
    harness.make_runner(cfg, {}, "calib", "cpu")
    return model_calls[0][1], runner_calls[0]


@pytest.mark.parametrize("workload", [
    "flowdrow-int8c.steady", "drspaam-bf16.steady", "flowdrow-int8c.churn",
    "drspaam-bf16.churn"])
def test_runner_gets_nothing_new_without_the_keys(monkeypatch, workload):
    cfg = Cell(workload).config
    model_kw, (args, runner_kw) = _make_runner_calls(monkeypatch, cfg)
    assert set(model_kw) == MODEL_KEYS
    assert set(runner_kw) == RUNNER_KEYS
    assert args == ("model", harness.cutout_kwargs(cfg))


def test_keys_reach_the_model_and_the_runner(monkeypatch):
    cfg = dict(Cell("drspaam-bf16.steady").config, angle_inc_deg=0.33,
               model_kwargs={"banded_chunk": 64},
               runner_kwargs={"output_fields": ["det_xys"]})
    model_kw, (_, runner_kw) = _make_runner_calls(monkeypatch, cfg)
    assert model_kw["banded_chunk"] == 64
    assert set(model_kw) == MODEL_KEYS | {"banded_chunk"}
    assert runner_kw["angle_inc"] == math.radians(0.33)
    assert runner_kw["output_fields"] == ["det_xys"]
    assert set(runner_kw) == RUNNER_KEYS | {"angle_inc", "output_fields"}
