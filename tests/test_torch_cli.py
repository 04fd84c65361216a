"""The port's serving CLI (``cli.infer``), evaluation CLI
(``cli.evaluate``) and weight files (``interop.checkpoint``), on the CPU.

A synthetic 64-beam DROW sequence and JAX ``init`` weights carried across
by the flax bridge and saved with ``interop.checkpoint``. The CLI's
detections equal a ``StreamingRunner`` run by hand to the bit; on the
module engine they match the JAX runner's as kept-detection sets within
1e-3.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.infer import StreamingRunner as JaxRunner
from planar_optical_flow_tpu_torch.cli import evaluate as evaluate_cli
from planar_optical_flow_tpu_torch.cli import infer as infer_cli
from planar_optical_flow_tpu_torch.data import (
    drow_io,
    write_synthetic_drow_split,
)
from planar_optical_flow_tpu_torch.infer import (
    ServeCalibration,
    StreamingRunner,
)
from planar_optical_flow_tpu_torch.interop.checkpoint import (
    load_weights,
    save_weights,
)
from planar_optical_flow_tpu_torch.models import FlowDrow, get_model

from tests.test_torch_common import one_thread  # noqa: F401
from tests.test_torch_common import (
    CT_LEN,
    CUTOUT_KW,
    NUM_PTS,
    WINDOW,
    flow_drow_pair,
    to_jax,
)

CONF = 0.3
FRAMES = 8  # --max-frames of the runs that need no whole --replay window
FIELDS = ("det_xys", "det_cls", "det_keep", "pred_flow")
FLAT_CFG = {
    "network": "cutout_spatial", "pedestrian_only": True, "num_scans": 2,
    "similarity_kwargs": {"alpha": 0.5, "window_size": WINDOW},
    "cutout_kwargs": CUTOUT_KW,
}



@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(dir, config path, weight path, sequence stem, flax model, its
    variables, the port model)."""
    root = tmp_path_factory.mktemp("cli")
    stem = write_synthetic_drow_split(str(root), "val", num_sequences=1,
                                      num_frames=20, num_people=8, seed=0,
                                      num_pts=NUM_PTS)[0]
    cfg = root / "cfg.json"
    cfg.write_text(json.dumps(FLAT_CFG))
    model, v_np, port = flow_drow_pair(seed=1)
    ckpt = save_weights(port, str(root / "w" / "weights.pt"))
    return root, str(cfg), ckpt, stem, model, to_jax(v_np), port


def _argv(served, *extra):
    _, cfg, ckpt, stem, *_ = served
    return ["--cfg", cfg, "--ckpt", ckpt, "--sequence", stem + ".csv",
            "--conf", str(CONF), "--cpu", *extra]


def _by_hand(port, scans, engine, calib=None, poses=None):
    runner = StreamingRunner(port, CUTOUT_KW, num_pts=NUM_PTS, engine=engine,
                             calib=calib, calib_scans=scans[:8] if engine ==
                             "int8c" and calib is None else None,
                             output_fields=FIELDS, device="cpu")
    return infer_cli.serve_sequence(runner, torch.from_numpy(scans),
                                    conf=CONF, poses=poses, log=None)


def _assert_bits(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for k in ("dets", "conf", "flow"):
            assert g[k].dtype == r[k].dtype
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("engine", ["module", "v3", "int8c"])
def test_infer_cli_equals_the_runner(served, engine, capsys):
    _, _, _, stem, _, _, port = served
    rc, got, _ = infer_cli.infer(_argv(served, "--engine", engine,
                                       "--max-frames", str(FRAMES)))
    assert rc == 0
    assert "frame 0:" in capsys.readouterr().out
    scans = drow_io.load_scan_file(stem)[2][:FRAMES]
    assert len(got) == len(scans)
    _assert_bits(got, _by_hand(port, scans, engine))
    assert any(len(r["dets"]) for r in got)
    for r in got:
        assert r["flow"].shape == (NUM_PTS, 2)


def test_infer_cli_world_frame_matches_jax(served):
    """--world-frame on the module engine: the port's detections, against
    the JAX runner's under the same pose transform, as kept-detection sets
    (an untrained model's tied votes may sort into other slots)."""
    _, _, _, stem, model, variables, port = served
    rc, got, _ = infer_cli.infer(_argv(served, "--world-frame",
                                       "--max-frames", str(FRAMES)))
    _, scan_t, scans = (a[:FRAMES] for a in drow_io.load_scan_file(stem))
    _, odom_t, odom = drow_io.load_odometry_file(stem)
    poses = odom[np.argmin(np.abs(scan_t[:, None] - odom_t[None]), axis=1)]
    _assert_bits(got, _by_hand(port, scans, "module", poses=poses))
    runner = JaxRunner(model, variables, CUTOUT_KW, num_pts=NUM_PTS)
    n_dets = 0
    for i, scan in enumerate(scans):
        out = runner(scan[None])
        keep = np.asarray(out["det_keep"][0])
        conf = np.asarray(out["det_cls"][0])[:, 0]
        sel = keep & (conf >= CONF)
        x, y, h = poses[i]
        rot = np.array([[np.cos(h), -np.sin(h)], [np.sin(h), np.cos(h)]])
        ref = np.asarray(out["det_xys"][0])[sel] @ rot.T + [x, y]
        dets = got[i]["dets"]
        assert dets.shape == ref.shape, i
        order = [np.lexsort(d.T[::-1]) for d in (dets, ref)]
        np.testing.assert_allclose(dets[order[0]], ref[order[1]], rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(got[i]["flow"], np.asarray(
            out["pred_flow"][0]) @ rot.T, rtol=1e-3, atol=1e-3)
        n_dets += len(ref)
    assert n_dets > 0


@pytest.mark.parametrize("engine", ["module", "int8c"])
def test_infer_cli_replay_equals_per_frame(served, engine):
    """20 frames: one whole window of 16 and the tail."""
    _, per_frame, _ = infer_cli.infer(_argv(served, "--engine", engine))
    _, replay, _ = infer_cli.infer(_argv(served, "--engine", engine,
                                         "--replay"))
    _assert_bits(replay, per_frame)


def test_infer_cli_saved_calibration(served, tmp_path):
    root, *_ = served
    short = ("--engine", "int8c", "--max-frames", str(FRAMES))
    rc, first, _ = infer_cli.infer(_argv(served, *short, "--save-calib",
                                         str(tmp_path)))
    path = tmp_path / "calibration.json"
    assert rc == 0 and path.exists()
    _, again, _ = infer_cli.infer(_argv(served, *short, "--calib",
                                        str(path)))
    _assert_bits(again, first)
    # a calibration beside the weights is found without --calib
    _, _, ckpt, *_ = served
    ServeCalibration.load(str(path)).save(os.path.dirname(ckpt))
    try:
        _, found, _ = infer_cli.infer(_argv(served, *short))
        _assert_bits(found, first)
    finally:
        os.remove(os.path.join(os.path.dirname(ckpt), "calibration.json"))


@pytest.mark.parametrize("extra,message", [
    (("--calib", "c.json"), "--calib requires --engine int8c"),
    (("--save-calib", "c.json"), "--save-calib requires --engine int8c"),
    (("--video", "out.mp4"), "item 18"),
    (("--artifact", "engine_dir"), "item 19"),
])
def test_infer_cli_parser_errors(served, extra, message, capsys):
    with pytest.raises(SystemExit) as exit_:
        infer_cli.main(_argv(served, *extra))
    assert exit_.value.code == 2
    assert message in capsys.readouterr().err


def test_evaluate_cli_synthetic(served, tmp_path):
    root, cfg, ckpt, *_ = served
    metrics = evaluate_cli.evaluate(
        ["--cfg", cfg, "--ckpt", ckpt, "--synthetic", str(tmp_path / "syn"),
         "--ap", "--serve-flow", "--cpu"])
    assert os.path.isdir(tmp_path / "syn" / "val")
    assert 0.0 <= metrics["ap"] <= 1.0 and metrics["num_frames"] > 0
    assert np.isfinite(metrics["serve_epe"]) and metrics[
        "serve_engine"] == "v3"
    # neither --ap nor --serve-flow: the module path (FlowDrowTask metrics)
    module_cfg = tmp_path / "module.json"
    module_cfg.write_text(json.dumps(dict(FLAT_CFG,
                                          log_dir=str(tmp_path / "logs"))))
    module = evaluate_cli.evaluate(["--cfg", str(module_cfg), "--ckpt", ckpt,
                                    "--synthetic", str(tmp_path / "syn"),
                                    "--cpu"])
    assert set(module) == {"epe", "aae"}
    assert all(np.isfinite(v) for v in module.values())
    with pytest.raises(SystemExit):
        evaluate_cli.main(["--cfg", cfg, "--ap", "--artifact", "x", "--cpu"])


def test_evaluate_cli_serve_flow_rejects_flowless_model(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model": {"type": "dr-spaam"}, "dataset": {},
                               "pipeline": {}}))
    with pytest.raises(SystemExit):
        evaluate_cli.main(["--cfg", str(cfg), "--serve-flow", "--cpu"])


def test_evaluate_cli_resolves_the_engine(tmp_path):
    ckpt = tmp_path / "w.pt"
    assert evaluate_cli._resolve_ap_engine("auto", str(ckpt)) == ("v3", None)
    assert evaluate_cli._resolve_ap_engine("auto", None) == ("v3", None)
    ServeCalibration(bb_in_scale=1.0, bb_act_scales=[1.0] * 5,
                     hd_in_scale=1.0, hd_act_scales=[1.0] * 5).save(
        str(tmp_path))
    engine, calib = evaluate_cli._resolve_ap_engine("auto", str(ckpt))
    assert engine == "int8c" and calib is not None
    assert evaluate_cli._resolve_ap_engine("v3", str(ckpt)) == ("v3", None)


# -------------------------------------------------------------- checkpoint


def test_weights_round_trip(served, tmp_path):
    _, _, ckpt, stem, _, _, port = served
    model = load_weights(get_model({"type": "flow_drow", "window_size":
                                    WINDOW, "pedestrian_only": True},
                                   num_cutout_pts=CT_LEN), ckpt)
    for a, b in zip(model.state_dict().values(), port.state_dict().values()):
        assert torch.equal(a, b)
    _, _, scans = drow_io.load_scan_file(stem)
    _assert_bits(_by_hand(model, scans[:6], "v3"),
                 _by_hand(port, scans[:6], "v3"))
    state = torch.load(ckpt, weights_only=True)
    missing = dict(state)
    missing.pop(next(iter(missing)))
    torch.save(missing, tmp_path / "missing.pt")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_weights(FlowDrow(window_size=WINDOW, pedestrian_only=True,
                              num_cutout_pts=CT_LEN), tmp_path / "missing.pt")
    torch.save({**state, "extra.weight": torch.zeros(1)},
               tmp_path / "extra.pt")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_weights(FlowDrow(window_size=WINDOW, pedestrian_only=True,
                              num_cutout_pts=CT_LEN), tmp_path / "extra.pt")
