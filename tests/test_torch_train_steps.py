"""Train steps of the port's tasks against the JAX package's, on the CPU.

``DetectionTask`` on ``drow`` and ``dr-spaam``, ``FlowDrowTask`` and
``FlowDrowFusedTask`` (the frozen detector on K1 -> K2 -> K3's plain
versions against JAX's Pallas kernels in interpret mode) on ``flow_drow``,
at 64 beams, 16 cutout points, window 5, S=3, B=2, from flax ``init``
weights with perturbed BatchNorm statistics carried across by the bridge.

Bars. Over three steps of each trainer (AMSGrad, lr 1e-3 decaying), the losses
agree to 1e-3 relative in f32 (JAX's bf16 bar under ``compute_dtype:
bfloat16`` and for the fused task), and the parameters and running
statistics to 1e-3 relative L2 over the model in f32 (2e-2 in bf16).
Element by element Adam amplifies rounding: where a gradient is at the
level of the two packages' f32 rounding (a conv or dense bias that feeds a
train-mode BatchNorm has an exact gradient of 0), AMSGrad steps +-lr on its
sign, so single elements are held to 3x the summed learning rates only.
The first step's gradients are held element by element in
``tests/test_torch_train_grads.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.models import Drow as JaxDrow
from planar_optical_flow_tpu.models import SpatialDrow as JaxSpatialDrow
from planar_optical_flow_tpu.train import Trainer as JaxTrainer
from planar_optical_flow_tpu.train import create_train_state as jax_state
from planar_optical_flow_tpu.train import make_optimizer as jax_optimizer
from planar_optical_flow_tpu.train import tasks as jax_tasks
from planar_optical_flow_tpu.utils.logger import RunLogger as JaxLogger
from planar_optical_flow_tpu_torch.interop import variables_to_state_dict
from planar_optical_flow_tpu_torch.models import Drow, FlowDrow, SpatialDrow
from planar_optical_flow_tpu_torch.train import (
    Trainer,
    create_train_state,
    exp_decay_schedule,
    make_optimizer,
    tasks,
)
from planar_optical_flow_tpu_torch.train.trainer import to_device
from planar_optical_flow_tpu_torch.utils.logger import RunLogger

from tests.test_torch_common import one_thread  # noqa: F401
from tests.test_torch_common import (
    CT_LEN,
    CUTOUT_KW,
    NUM_PTS,
    WINDOW,
    perturb_batch_stats,
    t2n,
    to_jax,
)
from tests.test_torch_train import bf16_bar

S_SCANS, BATCH, STEPS = 3, 2, 3
SCHEDULE = dict(epoch0=0, lr0=1e-3, epoch1=2, lr1=1e-4)
OPT_CFG = {"scheduler_kwargs": SCHEDULE}
KINDS = ["drow", "dr-spaam", "flow_drow", "flow_drow_fused"]
# the biases whose exact gradient is 0: they feed a train-mode BatchNorm
ZERO_GRAD = ("conv.bias", "gate.embed.bias")
STATS = ("running_mean", "running_var")


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


def _jax_model(kind):
    if kind == "drow":
        return JaxDrow(pedestrian_only=True)
    if kind == "dr-spaam":
        return JaxSpatialDrow(window_size=WINDOW, pedestrian_only=True)
    from planar_optical_flow_tpu.models import FlowDrow as JaxFlowDrow

    return JaxFlowDrow(window_size=WINDOW, pedestrian_only=True)


def _port_model(kind):
    g = torch.Generator().manual_seed(0)
    if kind == "drow":
        return Drow(pedestrian_only=True, generator=g)
    if kind == "dr-spaam":
        return SpatialDrow(window_size=WINDOW, pedestrian_only=True,
                           num_cutout_pts=CT_LEN, generator=g)
    return FlowDrow(window_size=WINDOW, pedestrian_only=True,
                    num_cutout_pts=CT_LEN, generator=g)


def _example(kind):
    x = jnp.zeros((1, NUM_PTS, S_SCANS, CT_LEN))
    return (x, jnp.zeros((1, NUM_PTS))) if kind.startswith("flow") else (x,)


def _variables(kind, seed=0):
    variables = _jax_model(kind).init(jax.random.PRNGKey(seed),
                                      *_example(kind), train=False)
    return perturb_batch_stats(variables, np.random.default_rng(seed + 100))


def _batches(n=STEPS):
    """Stacks of S consecutive scans of synthetic 64-beam sequences (walls
    and walkers; i.i.d. random ranges would clip 90% of the cutout taps to
    +-1, where flax's fast variance E[x^2] - E[x]^2 of nearly constant
    channels cancels and the f32 summation order alone moves gradients by
    percents) and random targets."""
    from planar_optical_flow_tpu_torch.data.synthetic import (
        make_synthetic_drow_sequence,
    )

    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        seqs = [make_synthetic_drow_sequence(
            num_frames=S_SCANS + 2, num_pts=NUM_PTS, seed=10 * i + j)
            for j in range(BATCH)]
        out.append({
            "scans": np.stack([s["scans"][2:] for s in seqs])
            .astype(np.float32),
            "target_cls": rng.integers(0, 2, (BATCH, NUM_PTS))
            .astype(np.int32),
            "target_reg": rng.normal(0, 0.3, (BATCH, NUM_PTS, 2))
            .astype(np.float32),
            "target_flow": rng.normal(0, 0.1, (BATCH, NUM_PTS, 2))
            .astype(np.float32),
            "exclude_mask": (rng.random((BATCH, NUM_PTS)) > 0.2)
            .astype(np.float32),
        })
    return out


def _tasks(kind, jm, port):
    """(JAX task, port task) of ``kind``."""
    common = dict(cutout_kwargs=CUTOUT_KW, pedestrian_only=True,
                  num_pts=NUM_PTS)
    if kind == "flow_drow":
        return jax_tasks.FlowDrowTask(**common), tasks.FlowDrowTask(**common)
    if kind == "flow_drow_fused":
        return (jax_tasks.FlowDrowFusedTask.for_model(jm, interpret=True,
                                                      **common),
                tasks.FlowDrowFusedTask.for_model(port, **common))
    return jax_tasks.DetectionTask(**common), tasks.DetectionTask(**common)


def _pair(kind):
    """(flax model, numpy variables, port model with the same weights)."""
    v_np = _variables(kind)
    port = _port_model(kind)
    port.load_state_dict(variables_to_state_dict(v_np, port))
    return _jax_model(kind), v_np, port


def _jax_run(kind, jm, v_np, batches, compute_dtype, tmp_path):
    """Three steps of the JAX Trainer's own jitted step."""
    jtask = _tasks(kind, jm, _port_model(kind))[0]
    tx = jax_optimizer(OPT_CFG, steps_per_epoch=STEPS)
    state = jax_state(jm, _example(kind), tx, init_kwargs={"train": False})
    params = to_jax(v_np["params"])
    state = state.replace(params=params, batch_stats=to_jax(
        v_np["batch_stats"]), opt_state=tx.init(params))
    logger = JaxLogger({"log_dir": str(tmp_path / "jax"), "tag": kind,
                        "console": False, "tensorboard": False})
    trainer = JaxTrainer(logger, {"compute_dtype": compute_dtype,
                                  "log_norms": False}, jtask,
                         install_signal_handlers=False)
    trainer._build_steps(state)
    losses = []
    for b in batches:
        state, tb = trainer._train_step(
            state, {k: jnp.asarray(v) for k, v in b.items()},
            jax.random.PRNGKey(0))
        losses.append(float(tb["loss"]))
    return losses, jax.device_get({"params": state.params,
                                   "batch_stats": state.batch_stats})


def _port_run(kind, jm, port, batches, compute_dtype, tmp_path):
    """Three steps of the port's Trainer step."""
    task = _tasks(kind, jm, port)[1]
    state = create_train_state(port, make_optimizer(OPT_CFG, STEPS))
    logger = RunLogger({"log_dir": str(tmp_path / "port"), "tag": kind,
                        "console": False, "tensorboard": False})
    trainer = Trainer(logger, {"compute_dtype": compute_dtype,
                               "log_norms": False}, task,
                      install_signal_handlers=False, device="cpu")
    losses = []
    for b in batches:
        state, tb = trainer.train_step(state, to_device(b, "cpu"))
        losses.append(float(tb["loss"]))
    return losses, state


def _rel_l2(got: list, ref: list) -> float:
    g = np.concatenate([np.ravel(a) for a in got]).astype(np.float64)
    r = np.concatenate([np.ravel(a) for a in ref]).astype(np.float64)
    return float(np.linalg.norm(g - r) / np.linalg.norm(r))


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_three_train_steps_match_jax(kind, compute_dtype, tmp_path):
    jm, v_np, port = _pair(kind)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    batches = _batches()
    ref_losses, ref_v = _jax_run(kind, jm, v_np, batches, compute_dtype,
                                 tmp_path)
    got_losses, state = _port_run(kind, jm, port, batches, compute_dtype,
                                  tmp_path)
    f32 = compute_dtype is None and kind != "flow_drow_fused"
    if f32:
        np.testing.assert_allclose(got_losses, ref_losses, rtol=1e-3)
    else:
        for g, r in zip(got_losses, ref_losses):
            bf16_bar(g, r, "loss")
    ref = variables_to_state_dict(ref_v, state.model)
    got = {n: t for n, t in state.model.state_dict().items()
           if not n.endswith("num_batches_tracked")}
    assert all(t.dtype == torch.float32 for t in got.values())
    bar = 1e-3 if f32 else 2e-2
    for which in ("params", "stats"):
        names = [n for n in got if n.endswith(STATS) == (which == "stats")]
        err = _rel_l2([t2n(got[n]) for n in names],
                      [t2n(ref[n]) for n in names])
        assert err <= bar, f"{which}: relative L2 {err:.3g} > {bar}"
    lr_sum = sum(exp_decay_schedule(steps_per_epoch=STEPS, **SCHEDULE)(k)
                 for k in range(STEPS))
    for n, t in got.items():
        if not n.endswith(STATS):
            assert np.abs(t2n(t) - t2n(ref[n])).max() <= 3 * lr_sum, n
    if kind.startswith("flow_drow"):
        # the frozen detector: parameters equal to the bit to their start,
        # statistics equal to JAX's (bf16-rounded under bf16)
        for n, t in got.items():
            if n.startswith("dr_spaam."):
                want = ref[n] if n.endswith(STATS) else start[n]
                assert torch.equal(t, want), n
