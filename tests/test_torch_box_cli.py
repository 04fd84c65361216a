"""Box regression through the port's entry points, on the CPU:
``cli.train --synthetic`` then ``cli.evaluate`` on
``configs/train_3d_box_regression.yaml`` (batch and epochs cut), the
module path's metrics and the mean-box baseline against JAX's
``Pipeline.evaluate`` and ``mean_box_baseline`` on the same weights and
split, and ``BoxRegressor.from_checkpoint`` against JAX's ``BoxRegressor``
on the same weights and frame.
"""

from __future__ import annotations

import json
import math
import os

import jax
import numpy as np
import pytest

from planar_optical_flow_tpu.data import jrdb as jax_jrdb
from planar_optical_flow_tpu.eval.baseline import (
    mean_box_baseline as jax_baseline,
)
from planar_optical_flow_tpu.infer.box_regressor import (
    BoxRegressor as JaxBoxRegressor,
)
from planar_optical_flow_tpu.pipeline import Pipeline as JaxPipeline
from planar_optical_flow_tpu_torch.cli import evaluate as evaluate_cli
from planar_optical_flow_tpu_torch.cli import train as train_cli
from planar_optical_flow_tpu_torch.data import jrdb
from planar_optical_flow_tpu_torch.infer import BoxRegressor
from planar_optical_flow_tpu_torch.interop import variables_to_state_dict
from planar_optical_flow_tpu_torch.interop.checkpoint import save_weights
from planar_optical_flow_tpu_torch.models import get_model
from planar_optical_flow_tpu_torch.utils.config import load_config

from tests.test_torch_box_model import _variables
from tests.test_torch_common import REPO, one_thread  # noqa: F401

METRICS = {"iou", "loss_z", "loss_dim", "loss_ori"}


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


def _box_cfg(tmp_path, batch=8, input_size=256):
    """``configs/train_3d_box_regression.yaml`` with its batch, epochs and
    segment size cut, its data and logs under ``tmp_path``."""
    cfg = load_config(str(REPO / "configs" /
                          "train_3d_box_regression.yaml"))
    cfg["dataset"]["data_dir"] = str(tmp_path / "jrdb")
    cfg["dataloader"]["batch_size"] = batch
    cfg["dataset"]["input_size"] = input_size
    # no evaluation inside the epoch: the final one is the val split's
    # first pass (each pass draws the samples' input angles anew)
    cfg["pipeline"]["Trainer"].update(epoch=1, eval_interval=0)
    cfg["pipeline"]["Logger"].update(log_dir=str(tmp_path / "logs"),
                                     tag="box", tensorboard=False)
    path = tmp_path / "box.json"
    path.write_text(json.dumps(cfg))
    return cfg, str(path)


def test_cli_train_then_evaluate_box_reg_on_the_cpu(tmp_path, capsys):
    """``cli.train --synthetic --cpu`` writes the synthetic JRDB tree and
    trains to the final checkpoint with finite losses; ``cli.evaluate
    --ckpt`` prints the module path's metrics and the ``baseline_*``
    dict."""
    cfg, path = _box_cfg(tmp_path, input_size=64)
    data = str(tmp_path / "jrdb")
    assert train_cli.main(["--cfg", path, "--synthetic", data, "--cpu"]) == 0
    assert os.path.isdir(os.path.join(data, "train_dataset", "labels"))
    (run,) = os.listdir(tmp_path / "logs")
    run_dir = tmp_path / "logs" / run
    ckpt = run_dir / "ckpt" / "ckpt_final"
    assert (ckpt / "weights.pt").is_file()
    with open(run_dir / "tb" / "scalars.jsonl") as f:
        losses = [r["value"] for r in map(json.loads, f)
                  if r["key"] == "TRAIN_loss"]
    # 2 sequences x 3 frames x 4 boxes, each with its augmented copy
    assert len(losses) == 48 // 8 and np.isfinite(losses).all()
    final = json.loads((run_dir / "output" / "final_metrics.json")
                       .read_text())
    assert set(final) == METRICS

    capsys.readouterr()
    got = evaluate_cli.evaluate(["--cfg", path, "--ckpt", str(ckpt),
                                 "--synthetic", data, "--cpu"])
    out = capsys.readouterr().out.splitlines()
    base = {"baseline_" + k for k in METRICS}
    assert set(got) == METRICS | base
    assert all(math.isfinite(v) for v in got.values())
    assert out[-2].startswith("{'iou'") and "baseline_iou" in out[-1]
    for k, v in final.items():  # the same weights and val split
        np.testing.assert_allclose(got[k], float(v), rtol=1e-5, atol=1e-6)


def test_cli_evaluate_box_reg_matches_jax(tmp_path):
    """The same weights (JAX's pipeline init with perturbed statistics and
    a plausible head, carried across by the bridge) scored by JAX's
    ``Pipeline.evaluate`` and ``mean_box_baseline`` and by
    ``cli.evaluate``'s module path from a weights file."""
    cfg, path = _box_cfg(tmp_path, input_size=32)
    jax_jrdb.write_synthetic_jrdb(cfg["dataset"]["data_dir"], num_frames=4,
                                  boxes_per_frame=5)
    jpipe = JaxPipeline(cfg, use_mesh=False, install_signal_handlers=False)
    assert jpipe.val_loader is not None
    x = np.zeros((1, 32, 4), np.float32)
    v_np = _variables(jpipe.model, x, seed=0, head=True)
    jpipe.state = jpipe.state.replace(
        params=jax.tree_util.tree_map(np.asarray, v_np["params"]),
        batch_stats=jax.tree_util.tree_map(np.asarray,
                                           v_np["batch_stats"]))
    ref = jpipe.evaluate()
    ref.update({"baseline_" + k: v
                for k, v in jax_baseline(jpipe.val_set).items()})

    port = get_model(cfg["model"])
    port.load_state_dict(variables_to_state_dict(v_np, port))
    weights = save_weights(port, str(tmp_path / "w.pt"))
    got = evaluate_cli.evaluate(["--cfg", path, "--ckpt", weights, "--cpu"])
    assert set(got) == set(ref) == METRICS | {"baseline_" + k
                                              for k in METRICS}
    assert ref["iou"] > 0.05
    for k in got:
        # the CLI prints 6 places
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_box_regressor_from_checkpoint_matches_jax(tmp_path):
    """``BoxRegressor.from_checkpoint`` (a port weights file) against JAX's
    ``BoxRegressor`` on the same weights and frame: equal crops and masks
    (the same draws), boxes within 1e-4; a centre with no points is
    masked in both."""
    cfg, _ = _box_cfg(tmp_path, input_size=32)
    ds_cfg = cfg["dataset"]
    jax_jrdb.write_synthetic_jrdb(ds_cfg["data_dir"], num_frames=1,
                                  boxes_per_frame=6, seed=3)
    frame = jrdb.JrdbHandle("val", ds_cfg)[0]
    rng = np.random.default_rng(0)
    centers = np.concatenate([
        frame["boxes"][:, :3] + rng.normal(0, 0.05, (6, 3)),
        [[40.0, 40.0, 0.0]]]).astype(np.float32)
    oris = rng.uniform(-np.pi, np.pi, 7).astype(np.float32)

    jm = JaxBoxRegressor(None, ds_cfg).model
    v_np = _variables(jm, np.zeros((1, 32, 4), np.float32), head=True)
    ref_boxes, ref_ok = JaxBoxRegressor(
        jax.tree_util.tree_map(np.asarray, v_np), ds_cfg)(
        frame["points"], centers, oris)

    port = get_model({"type": "box_reg", "dropout": 0.0})
    port.load_state_dict(variables_to_state_dict(v_np, port))
    weights = save_weights(port, str(tmp_path / "w.pt"))
    reg = BoxRegressor.from_checkpoint(weights, ds_cfg, device="cpu")
    boxes, ok = reg(frame["points"], centers, oris)
    np.testing.assert_array_equal(ok, ref_ok)
    assert ok[:6].all() and not ok[6]
    assert boxes.shape == ref_boxes.shape == (7, 7)
    np.testing.assert_allclose(boxes, ref_boxes, rtol=1e-4, atol=1e-5)
    empty, none = reg(frame["points"], np.zeros((0, 3), np.float32))
    assert empty.shape == (0, 7) and none.shape == (0,)
    # a directory that holds no artifact
    with pytest.raises(FileNotFoundError, match="model.json"):
        BoxRegressor.from_artifact(str(tmp_path), ds_cfg, device="cpu")
