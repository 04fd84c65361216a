"""The flow U-Net through the port's CLIs, on the CPU: ``cli.train`` on
``configs/prototype_flow.yaml`` (epochs cut to 1) with ``--synthetic``,
and ``cli.evaluate``'s module path against JAX's ``Pipeline.evaluate`` on
the same weights and split, for the flow U-Net and a DROW detector
config (bar 1e-3 relative).
"""

from __future__ import annotations

import json
import math
import os

import jax
import numpy as np
import pytest

from planar_optical_flow_tpu.pipeline import Pipeline as JaxPipeline
from planar_optical_flow_tpu.pipeline import normalize_config as jax_norm
from planar_optical_flow_tpu_torch.cli import evaluate as evaluate_cli
from planar_optical_flow_tpu_torch.cli import train as train_cli
from planar_optical_flow_tpu_torch.interop import variables_to_state_dict
from planar_optical_flow_tpu_torch.interop.checkpoint import save_weights
from planar_optical_flow_tpu_torch.models import get_model, num_cutout_pts_of
from planar_optical_flow_tpu_torch.pipeline import Pipeline
from planar_optical_flow_tpu_torch.utils.config import load_config

from tests.test_torch_common import one_thread  # noqa: F401
from tests.test_torch_common import CUTOUT_KW, REPO, perturb_batch_stats
from tests.test_torch_flow_data import write_flow_corpus


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


def test_cli_train_prototype_flow_on_the_cpu(tmp_path):
    """``configs/prototype_flow.yaml`` (as JSON, one epoch) trains through
    ``cli.train --synthetic --cpu`` to its end: finite losses, the final
    checkpoint, and finite val EPE/AAE."""
    cfg = load_config(str(REPO / "configs" / "prototype_flow.yaml"))
    cfg.update(epochs=1, log_dir=str(tmp_path / "logs"), tag="flow")
    path = tmp_path / "prototype_flow.json"
    path.write_text(json.dumps(cfg))
    rc = train_cli.main(["--cfg", str(path), "--synthetic",
                         str(tmp_path / "syn"), "--cpu"])
    assert rc == 0
    (run,) = os.listdir(tmp_path / "logs")
    run_dir = tmp_path / "logs" / run
    assert (run_dir / "ckpt" / "ckpt_final" / "weights.pt").is_file()
    with open(run_dir / "tb" / "scalars.jsonl") as f:
        losses = [r["value"] for r in map(json.loads, f)
                  if r["key"] == "TRAIN_loss"]
    assert len(losses) >= 5 and np.isfinite(losses).all()
    final = json.loads((run_dir / "output" / "final_metrics.json")
                       .read_text())
    assert set(final) == {"epe", "aae"}
    assert all(math.isfinite(float(v)) for v in final.values())


def _flat_cfg(kind, data_dir, log_dir):
    if kind == "flow_unet":
        return {"model_type": "flow_unet", "batch_size": 4,
                "data_dir": data_dir, "log_dir": log_dir, "epochs": 1}
    return {"network": "cutout_gating", "pedestrian_only": True,
            "num_scans": 2, "batch_size": 4, "cutout_kwargs": CUTOUT_KW,
            "similarity_kwargs": {"alpha": 0.5, "window_size": 5},
            "data_dir": data_dir, "log_dir": log_dir, "epochs": 1}


@pytest.mark.parametrize("kind", ["flow_unet", "dr-spaam"])
def test_cli_evaluate_module_path_matches_jax(kind, tmp_path):
    """The same weights (JAX's pipeline init with perturbed statistics,
    carried across by the bridge) scored by JAX's ``Pipeline.evaluate``
    and by ``cli.evaluate`` without ``--ap``/``--serve-flow``: from a
    weights file (flow_unet) and from a training checkpoint directory
    (dr-spaam)."""
    data = write_flow_corpus(str(tmp_path / "data"), val_frames=10)
    flat = _flat_cfg(kind, data, str(tmp_path / "logs"))
    jpipe = JaxPipeline(jax_norm(dict(flat)), use_mesh=False,
                        install_signal_handlers=False)
    v_np = perturb_batch_stats(
        jax.device_get({"params": jpipe.state.params,
                        "batch_stats": jpipe.state.batch_stats}),
        np.random.default_rng(3))
    jpipe.state = jpipe.state.replace(
        params=jax.tree_util.tree_map(np.asarray, v_np["params"]),
        batch_stats=jax.tree_util.tree_map(np.asarray,
                                           v_np["batch_stats"]))
    assert jpipe.val_loader is not None
    ref = jpipe.evaluate()

    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(flat))
    if kind == "flow_unet":
        port = get_model(jpipe.cfg["model"])
        port.load_state_dict(variables_to_state_dict(v_np, port))
        ckpt = save_weights(port, str(tmp_path / "w.pt"))
    else:
        pipe = Pipeline(dict(flat), device="cpu",
                        install_signal_handlers=False)
        assert num_cutout_pts_of(pipe.cfg) == CUTOUT_KW["num_cutout_pts"]
        pipe.model.load_state_dict(variables_to_state_dict(v_np,
                                                           pipe.model))
        ckpt = pipe.save_ckpt()
        assert os.path.isdir(ckpt)
    got = evaluate_cli.evaluate(["--cfg", str(cfg_path), "--ckpt", ckpt,
                                 "--cpu"])
    assert set(got) == set(ref) and got
    for k in got:
        assert math.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, atol=1e-6,
                                   err_msg=k)


def test_cli_evaluate_flow_types_reject_serving_flags(tmp_path):
    """``--ap``/``--serve-flow`` stay streaming-only: a flow U-Net config
    is a parser error there."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model_type": "flow_unet"}))
    for flag in ("--ap", "--serve-flow"):
        with pytest.raises(SystemExit) as exit_:
            evaluate_cli.main(["--cfg", str(cfg), flag, "--cpu"])
        assert exit_.value.code == 2
