"""The int8 serving accuracy gate on trained weights, for the port.

The port's counterparts of ``tests/test_int8_serving_gate.py``'s
``test_int8c_ap_gate`` and ``test_int8c_flow_epe_gate``: the detector (and
the flow head) are trained in JAX inside the test with the JAX gate's own
recipe (``_train_tiny``), carried across by the flax bridge, and the port's
``module`` and ``int8c`` engines score them on the CPU (the kernels' plain
versions, which ``chip_smoke.py`` holds the card's kernels to). JAX's bars:
per seed |AP(int8c) - AP(module)| < 0.05, their mean < 0.02, module AP >
0.9; the flow gap < 0.02 + 0.25 x EPE. The port's module engine is also
held to JAX's on the same weights and frames: AP within 1e-3, EPE within
1e-3 relative. Slow tier, as the JAX gates are.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from planar_optical_flow_tpu_torch.data import DrowDetectionDataset
from planar_optical_flow_tpu_torch.eval import (
    evaluate_detection_ap_batched,
    evaluate_flow_serving,
)
from planar_optical_flow_tpu_torch.interop import variables_to_state_dict
from planar_optical_flow_tpu_torch.models import get_model

from tests.test_int8_serving_gate import CUTOUT_KW, _train_tiny


def _port_model(mtype, variables):
    port = get_model({"type": mtype, "window_size": 5,
                      "pedestrian_only": True},
                     num_cutout_pts=CUTOUT_KW["num_cutout_pts"])
    v_np = jax.tree_util.tree_map(np.asarray, dict(variables))
    port.load_state_dict(variables_to_state_dict(v_np, port))
    return port.eval()


def _port_dataset(path):
    return DrowDetectionDataset(str(path), "train", num_scans=2,
                                pedestrian_only=True, device="cpu")


@pytest.mark.slow
def test_port_int8c_ap_gate(tmp_path):
    from planar_optical_flow_tpu.eval import evaluator as jax_eval
    from planar_optical_flow_tpu.train import tasks

    deltas, aps = [], []
    for seed in (11, 17, 23):
        task = tasks.DetectionTask(cutout_kwargs=CUTOUT_KW,
                                   pedestrian_only=True)
        jax_ds, loader, model, state, step = _train_tiny(
            tmp_path / f"s{seed}", "dr-spaam", task, lr=1e-3, seed=seed)
        key = jax.random.PRNGKey(seed)
        for _ in range(5):
            for batch in loader:
                key, sk = jax.random.split(key)
                state, _ = step(state, batch, sk)

        port = _port_model("dr-spaam", state.variables)
        ds = _port_dataset(tmp_path / f"s{seed}")
        common = dict(cutout_kwargs=CUTOUT_KW, frames=ds, conf_thresh=0.3,
                      batch_streams=8, device="cpu")
        ap_f32 = evaluate_detection_ap_batched(port, engine="module",
                                               **common)["ap"]
        ap_int8 = evaluate_detection_ap_batched(port, engine="int8c",
                                                **common)["ap"]
        ap_jax = jax_eval.evaluate_detection_ap_batched(
            model, state.variables, CUTOUT_KW, jax_ds, conf_thresh=0.3,
            batch_streams=8, engine="module")["ap"]
        assert abs(ap_f32 - ap_jax) <= 1e-3, (seed, ap_f32, ap_jax)
        assert ap_f32 > 0.9, (seed, ap_f32)
        assert abs(ap_int8 - ap_f32) < 0.05, (seed, ap_int8, ap_f32)
        deltas.append(ap_int8 - ap_f32)
        aps.append((seed, round(ap_f32, 4), round(ap_int8, 4),
                    f"{ap_f32 - ap_jax:+.2g}"))
    mean_delta = float(np.mean(deltas))
    print(f"\nport int8c AP gate: per-seed (seed, module, int8c, module "
          f"- JAX module) {aps}, "
          f"deltas {[round(d, 4) for d in deltas]}, mean {mean_delta:+.4f}")
    assert abs(mean_delta) < 0.02, (mean_delta, aps)


@pytest.mark.slow
def test_port_int8c_flow_epe_gate(tmp_path):
    from planar_optical_flow_tpu.eval import evaluator as jax_eval
    from planar_optical_flow_tpu.train import tasks

    task = tasks.FlowDrowTask(cutout_kwargs=CUTOUT_KW, pedestrian_only=True)
    ds, loader, model, state, step = _train_tiny(
        tmp_path, "flow_drow", task, lr=3e-3, seed=7, flow_input=True)
    n_eval = (len(ds) // 8) * 8
    eval_batches = [ds.batch(np.arange(i, i + 8))
                    for i in range(0, n_eval, 8)]

    def mean_loss(st):
        return float(np.mean([
            float(task.loss(st.apply_fn, st.variables, b, False)[0])
            for b in eval_batches]))

    loss0 = mean_loss(state)
    key = jax.random.PRNGKey(0)
    for _ in range(3):
        for batch in loader:
            key, sk = jax.random.split(key)
            state, _ = step(state, batch, sk)
    loss1 = mean_loss(state)
    assert loss1 < 0.9 * loss0, (loss0, loss1)  # the flow head learned

    port = _port_model("flow_drow", state.variables)
    pds = _port_dataset(tmp_path)
    epes = {
        name: evaluate_flow_serving(
            port, CUTOUT_KW, pds, engine=name,
            calib_scans=pds.batch(np.arange(8))["scans"][:, -1],
            device="cpu")
        for name in ("module", "int8c")
    }
    jax_epe = jax_eval.evaluate_flow_serving(model, state.variables,
                                             CUTOUT_KW, pds)["epe"]
    print(f"\nport int8c flow gate: {epes}; JAX module EPE {jax_epe}")
    np.testing.assert_allclose(epes["module"]["epe"], jax_epe, rtol=1e-3)
    gap = abs(epes["int8c"]["epe"] - epes["module"]["epe"])
    assert gap < 0.02 + 0.25 * epes["module"]["epe"], epes
