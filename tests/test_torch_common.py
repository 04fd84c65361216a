"""Shared set-up of the PyTorch port's tests, and the port's guards.

The port's tests run the JAX function and its port on the same inputs,
made from a seed with numpy, with weights carried across by the flax
bridge. Geometry: 64 beams, 16 cutout points, window 5, B=2. BatchNorm
statistics are perturbed before the bridge so that folding is exercised.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.models import FlowDrow as JaxFlowDrow
from planar_optical_flow_tpu_torch import resolve_device
from planar_optical_flow_tpu_torch.interop import variables_to_state_dict
from planar_optical_flow_tpu_torch.models import FlowDrow

NUM_PTS = 64
CT_LEN = 16
WINDOW = 5
CUTOUT_KW = dict(fixed=True, centered=True, window_width=1.0,
                 window_depth=0.5, num_cutout_pts=CT_LEN, padding_val=29.99,
                 area_mode=True, gather_mode="matmul")
REPO = Path(__file__).resolve().parents[1]


def perturb_batch_stats(variables, rng):
    """numpy copy of ``variables`` with BN means ~ N(0, 0.1) and variances
    ~ U(0.5, 2) (the init stats are 0 and 1, which folding would not
    exercise)."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v)
            elif k == "mean":
                out[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return {"params": walk(variables["params"]),
            "batch_stats": walk(variables["batch_stats"])}


def flow_drow_pair(seed: int = 0, num_pts: int = NUM_PTS,
                   ct_len: int = CT_LEN, window: int = WINDOW):
    """(flax FlowDrow, its numpy variables with perturbed BN stats, the
    port's FlowDrow carrying the same weights, on the CPU)."""
    model = JaxFlowDrow(window_size=window, pedestrian_only=True)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, num_pts, 1, ct_len)),
                           jnp.zeros((1, num_pts)), train=False)
    v_np = perturb_batch_stats(variables, np.random.default_rng(seed + 100))
    port = FlowDrow(window_size=window, pedestrian_only=True,
                    num_cutout_pts=ct_len)
    port.load_state_dict(variables_to_state_dict(v_np, port))
    return model, v_np, port.eval()


def to_jax(v_np):
    return jax.tree_util.tree_map(jnp.asarray, v_np)


def t2n(t):
    return t.detach().float().cpu().numpy()


def assert_close_to_max(got, ref, rel, what=""):
    """``max|got - ref| <= rel * max|ref|`` (the bf16 tolerance)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    lim = rel * max(np.abs(ref).max(), 1e-6)
    assert err <= lim, f"{what}: max abs err {err:.3g} > {lim:.3g}"


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread for a module of tests that run many small ops
    (one-stream serving steps, frame-by-frame loops): the suite runs six
    workers on the machine's cores, and a worker's pool of threads then
    costs more than the work it shares. Restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ guards


def test_package_imports_without_jax():
    """The port imports nothing of JAX or the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['planar_optical_flow_tpu'] = None\n"
        "import planar_optical_flow_tpu_torch.infer.streaming\n"
        "import planar_optical_flow_tpu_torch.infer.calibration\n"
        "import planar_optical_flow_tpu_torch.ops.quantized_drow\n"
        "import planar_optical_flow_tpu_torch.ops.kernels.quant\n"
        "import planar_optical_flow_tpu_torch.interop\n"
        "import planar_optical_flow_tpu_torch.models\n"
        "import planar_optical_flow_tpu_torch.models.registry\n"
        "import planar_optical_flow_tpu_torch.interop.checkpoint\n"
        "import planar_optical_flow_tpu_torch.utils.config\n"
        "import planar_optical_flow_tpu_torch.pipeline\n"
        "import planar_optical_flow_tpu_torch.ops.geometry\n"
        "import planar_optical_flow_tpu_torch.ops.targets\n"
        "import planar_optical_flow_tpu_torch.data.drow_io\n"
        "import planar_optical_flow_tpu_torch.data.synthetic\n"
        "import planar_optical_flow_tpu_torch.data.drow_detection\n"
        "import planar_optical_flow_tpu_torch.eval.detection_ap\n"
        "import planar_optical_flow_tpu_torch.eval.evaluator\n"
        "import planar_optical_flow_tpu_torch.cli.infer\n"
        "import planar_optical_flow_tpu_torch.cli.evaluate\n"
        "import planar_optical_flow_tpu_torch.cli.train\n"
        "import planar_optical_flow_tpu_torch.train\n"
        "import planar_optical_flow_tpu_torch.train.fused_frozen\n"
        "import planar_optical_flow_tpu_torch.ops.losses\n"
        "import planar_optical_flow_tpu_torch.data.loader\n"
        "import planar_optical_flow_tpu_torch.data.prepare\n"
        "import planar_optical_flow_tpu_torch.utils.logger\n"
        "import planar_optical_flow_tpu_torch.models.flow_unet\n"
        "import planar_optical_flow_tpu_torch.data.drow_flow\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'flax', "
        "'planar_optical_flow_tpu.')) and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_resolve_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()  # the default is the card
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    import json

    from planar_optical_flow_tpu_torch.cli import evaluate as evaluate_cli
    from planar_optical_flow_tpu_torch.cli import infer as infer_cli
    from planar_optical_flow_tpu_torch.data import (
        DrowDetectionDataset,
        write_synthetic_drow_split,
    )
    from planar_optical_flow_tpu_torch.eval import (
        evaluate_detection_ap,
        evaluate_detection_ap_batched,
        evaluate_flow_serving,
    )
    from planar_optical_flow_tpu_torch.infer.streaming import StreamingRunner

    stem = write_synthetic_drow_split(str(tmp_path), "val", num_sequences=1,
                                      num_frames=12, num_pts=NUM_PTS)[0]
    ds = DrowDetectionDataset(str(tmp_path), "val", num_scans=2,
                              device="cpu")
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"pedestrian_only": True,
                               "cutout_kwargs": CUTOUT_KW}))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = FlowDrow(window_size=WINDOW, pedestrian_only=True,
                    num_cutout_pts=CT_LEN)
    for engine in ("module", "v3", "int8c"):
        with pytest.raises(RuntimeError, match="cuda"):
            StreamingRunner(port, CUTOUT_KW, num_pts=NUM_PTS, engine=engine)
    from planar_optical_flow_tpu_torch.infer.streaming import (
        make_serve_step_v3,
    )

    for opts in (dict(precision="int8"), dict(precision="int8c",
                                              layout="flat"),
                 dict(precision="int8c", layout="pm"),
                 dict(precision="int8c", layout="p2c"),
                 dict(precision="int8c", layout="cell"),
                 dict(precision="int8c", fuse_gate_head=True)):
        with pytest.raises(RuntimeError, match="cuda"):
            make_serve_step_v3(port, CUTOUT_KW, num_pts=NUM_PTS,
                               calib_scans=np.zeros((1, NUM_PTS)), **opts)
    # the dataset, the evaluators and both CLIs without --cpu
    with pytest.raises(RuntimeError, match="cuda"):
        DrowDetectionDataset(str(tmp_path), "val", num_scans=2)
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate_detection_ap(StreamingRunner(port, CUTOUT_KW,
                                              num_pts=NUM_PTS), ds)
    for engine in ("module", "v3", "int8c"):
        with pytest.raises(RuntimeError, match="cuda"):
            evaluate_detection_ap_batched(port, CUTOUT_KW, ds, engine=engine)
        with pytest.raises(RuntimeError, match="cuda"):
            evaluate_flow_serving(port, CUTOUT_KW, ds, engine=engine,
                                  num_pts=NUM_PTS)
        with pytest.raises(RuntimeError, match="cuda"):
            infer_cli.main(["--cfg", str(cfg), "--sequence", stem,
                            "--engine", engine])
        with pytest.raises(RuntimeError, match="cuda"):
            evaluate_cli.main(["--cfg", str(cfg), "--ap", "--engine",
                               engine])


@pytest.mark.gpu
def test_gpu_marker_skips_without_card(cuda_device):
    """Runs only on a card: the fixture skips here with a reason."""
    assert cuda_device.type == "cuda"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")
