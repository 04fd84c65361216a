"""The flow U-Net's task, train steps, ``evaluate_flow`` and the trainer's
``profile_steps`` against the JAX package's, on the CPU.

Batches of B=4 scan pairs from the prepared synthetic 128-beam corpus of
``tests/test_torch_flow_data.py``; the weights come from flax ``init``
with perturbed BatchNorm statistics, carried across by the flax bridge.
Bars: the task's loss and metrics f32 1e-5 relative, bf16 JAX's bf16 bar;
three trainer steps (AMSGrad, lr 1e-3 decaying) 1e-3 relative on the
losses and 1e-3 relative L2 over the parameters and over the running
statistics in f32 (2e-2 under ``compute_dtype: bfloat16``); the first
step's gradients 1e-3 of each tensor's largest; ``evaluate_flow`` 1e-4.
"""

from __future__ import annotations

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.eval.evaluator import (
    evaluate_flow as jax_evaluate_flow,
)
from planar_optical_flow_tpu.train import Trainer as JaxTrainer
from planar_optical_flow_tpu.train import create_train_state as jax_state
from planar_optical_flow_tpu.train import make_optimizer as jax_optimizer
from planar_optical_flow_tpu.train import tasks as jax_tasks
from planar_optical_flow_tpu.utils.logger import RunLogger as JaxLogger
from planar_optical_flow_tpu_torch.data import FlowScanPairDataset
from planar_optical_flow_tpu_torch.eval import evaluate_flow
from planar_optical_flow_tpu_torch.interop import variables_to_state_dict
from planar_optical_flow_tpu_torch.train import (
    Trainer,
    create_train_state,
    make_optimizer,
    tasks,
)
from planar_optical_flow_tpu_torch.train.state import named_stats, set_stats
from planar_optical_flow_tpu_torch.train.trainer import to_device
from planar_optical_flow_tpu_torch.utils.logger import RunLogger

from tests.test_torch_common import one_thread  # noqa: F401
from tests.test_torch_common import t2n, to_jax
from tests.test_torch_flow_data import write_flow_corpus
from tests.test_torch_flow_model import flow_pair
from tests.test_torch_train import _cast_tree, bf16_bar, f32_bar
from tests.test_torch_train_steps import _rel_l2

NUM_PTS, BATCH, STEPS = 128, 4, 3
SCHEDULE = dict(epoch0=0, lr0=1e-3, epoch1=2, lr1=1e-4)
OPT_CFG = {"scheduler_kwargs": SCHEDULE}
STATS = ("running_mean", "running_var")


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(the train split's dataset, its first STEPS batches of B pairs)."""
    root = write_flow_corpus(str(tmp_path_factory.mktemp("flow")),
                             train_frames=16)
    ds = FlowScanPairDataset(root, "train")
    order = np.random.default_rng(0).permutation(len(ds))
    assert len(ds) >= STEPS * BATCH
    return ds, [ds.batch(order[i * BATCH:(i + 1) * BATCH])
                for i in range(STEPS)]


def _example():
    x = jnp.zeros((1, NUM_PTS, 2))
    return (x, x)


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flow_task_matches_jax(data, masked, dtype):
    """``FlowUNetTask.loss`` in train mode (inputs cast to the model's
    dtype, the EPE in f32, over the exclude mask when ``masked``) and
    ``metrics`` on the uncast f32 pair. Under bf16 the loss runs on
    bf16-cast statistics (the trainer's step), and the metrics on a model
    cast to bf16 whole, where flax promotes the bf16 parameters against
    the f32 pair and computes in f32."""
    jm, v_np, port = flow_pair(num_pts=NUM_PTS)
    batch = data[1][0]
    batch = dict(batch, exclude_mask=(batch["exclude_mask"] * (
        np.random.default_rng(2).random(batch["exclude_mask"].shape) > 0.3)
    ).astype(np.float32))
    jtask, task = jax_tasks.FlowUNetTask(masked), tasks.FlowUNetTask(masked)
    variables = to_jax(v_np)
    tbatch = to_device(batch, "cpu")
    with torch.no_grad():
        metrics_model = (copy.deepcopy(port).bfloat16()
                         if dtype == "bfloat16" else port)
        got_m, got_out = task.metrics(metrics_model, tbatch)
    assert got_out["pred_flow"].dtype == torch.float32
    if dtype == "bfloat16":
        variables = {k: _cast_tree(v, jnp.bfloat16)
                     for k, v in variables.items()}
        set_stats(port, {n: t.bfloat16() for n, t in
                         named_stats(port).items()})
    ref_m, _ = jtask.metrics(jm.apply, variables, _jax_batch(batch))
    ref_loss, _, ref_out, _ = jtask.loss(jm.apply, variables,
                                         _jax_batch(batch), True)
    loss, tb, out, _ = task.loss(port, tbatch, True)
    assert loss.dtype == torch.float32 and set(tb) == {"loss"}
    loss = loss.detach()
    if dtype == "bfloat16":
        bf16_bar(float(loss), float(ref_loss), "loss")
        bf16_bar(t2n(out["pred_flow"]), np.asarray(ref_out["pred_flow"],
                                                   np.float32), "pred")
        for k in ("epe", "aae"):
            bf16_bar(float(got_m[k]), float(ref_m[k]), k)
    else:
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
        for k in ("epe", "aae"):
            np.testing.assert_allclose(float(got_m[k]), float(ref_m[k]),
                                       rtol=1e-5, err_msg=k)


def _jax_run(jm, v_np, batches, compute_dtype, tmp_path):
    tx = jax_optimizer(OPT_CFG, steps_per_epoch=STEPS)
    state = jax_state(jm, _example(), tx, init_kwargs={"train": False})
    params = to_jax(v_np["params"])
    state = state.replace(params=params, batch_stats=to_jax(
        v_np["batch_stats"]), opt_state=tx.init(params))
    logger = JaxLogger({"log_dir": str(tmp_path / "jax"), "tag": "flow",
                        "console": False, "tensorboard": False})
    trainer = JaxTrainer(logger, {"compute_dtype": compute_dtype,
                                  "log_norms": False},
                         jax_tasks.FlowUNetTask(),
                         install_signal_handlers=False)
    trainer._build_steps(state)
    losses = []
    for b in batches:
        state, tb = trainer._train_step(state, _jax_batch(b),
                                        jax.random.PRNGKey(0))
        losses.append(float(tb["loss"]))
    return losses, jax.device_get({"params": state.params,
                                   "batch_stats": state.batch_stats})


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_three_flow_train_steps_match_jax(data, compute_dtype, tmp_path):
    jm, v_np, port = flow_pair(num_pts=NUM_PTS)
    batches = data[1]
    ref_losses, ref_v = _jax_run(jm, v_np, batches, compute_dtype, tmp_path)
    state = create_train_state(port, make_optimizer(OPT_CFG, STEPS))
    logger = RunLogger({"log_dir": str(tmp_path / "port"), "tag": "flow",
                        "console": False, "tensorboard": False})
    trainer = Trainer(logger, {"compute_dtype": compute_dtype,
                               "log_norms": False}, tasks.FlowUNetTask(),
                      install_signal_handlers=False, device="cpu")
    losses = []
    for b in batches:
        state, tb = trainer.train_step(state, to_device(b, "cpu"))
        losses.append(float(tb["loss"]))
    if compute_dtype is None:
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-3)
    else:
        for g, r in zip(losses, ref_losses):
            bf16_bar(g, r, "loss")
    ref = variables_to_state_dict(ref_v, state.model)
    got = {n: t for n, t in state.model.state_dict().items()
           if not n.endswith("num_batches_tracked")}
    assert all(t.dtype == torch.float32 for t in got.values())
    bar = 1e-3 if compute_dtype is None else 2e-2
    for which in ("params", "stats"):
        names = [n for n in got if n.endswith(STATS) == (which == "stats")]
        err = _rel_l2([t2n(got[n]) for n in names],
                      [t2n(ref[n]) for n in names])
        assert err <= bar, f"{which}: relative L2 {err:.3g} > {bar}"


def test_first_flow_step_gradients_match_jax(data):
    """Each parameter's gradient within 1e-3 of its tensor's largest; a
    conv bias that feeds a train-mode BatchNorm (exact gradient 0) below
    1e-4 of the largest gradient in both packages."""
    jm, v_np, port = flow_pair(num_pts=NUM_PTS)
    batch = data[1][0]
    jtask, task = jax_tasks.FlowUNetTask(), tasks.FlowUNetTask()

    def jax_loss(params):
        loss, _, _, stats = jtask.loss(
            jm.apply, {"params": params,
                       "batch_stats": to_jax(v_np["batch_stats"])},
            _jax_batch(batch), True)
        return loss, stats

    (ref_loss, _), ref_g = jax.value_and_grad(jax_loss, has_aux=True)(
        to_jax(v_np["params"]))
    loss, *_ = task.loss(port, to_device(batch, "cpu"), True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    ref = variables_to_state_dict({"params": jax.device_get(ref_g),
                                   "batch_stats": v_np["batch_stats"]}, port)
    top = max(float(np.abs(t2n(ref[n])).max())
              for n, _ in port.named_parameters())
    for n, p in port.named_parameters():
        g, r = t2n(p.grad), t2n(ref[n])
        if n.endswith("conv.bias"):
            assert max(np.abs(g).max(), np.abs(r).max()) <= 1e-4 * top, n
        else:
            f32_bar(g, r, 1e-3 * np.abs(r).max() / max(np.abs(r).max(), 1.0),
                    n)


def test_evaluate_flow_matches_jax(data):
    """The means of EPE and AAE over the batches within 1e-4, and one flow
    field a frame with ``collect_outputs``."""
    jm, v_np, port = flow_pair(num_pts=NUM_PTS)
    batches = data[1]
    tx = jax_optimizer(OPT_CFG, steps_per_epoch=STEPS)
    jstate = jax_state(jm, _example(), tx, init_kwargs={"train": False})
    jstate = jstate.replace(params=to_jax(v_np["params"]),
                            batch_stats=to_jax(v_np["batch_stats"]))
    ref = jax_evaluate_flow(jax_tasks.FlowUNetTask(), jstate, batches)
    state = create_train_state(port, make_optimizer(OPT_CFG, STEPS))
    got, outs = evaluate_flow(tasks.FlowUNetTask(), state, batches,
                              collect_outputs=True)
    assert set(got) == set(ref) == {"epe", "aae"}
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    flows = np.concatenate([o["pred_flow"] for o in outs])
    assert isinstance(flows, np.ndarray)
    assert flows.shape == (STEPS * BATCH, NUM_PTS, 2)
    assert got == evaluate_flow(tasks.FlowUNetTask(), state, batches)


def test_profile_steps_writes_a_trace(data, tmp_path):
    """``profile_steps: [1, 3]`` profiles steps 1 and 2 and writes one
    Chrome trace under ``{run_dir}/profile``; the start and stop are
    logged; ``()`` writes none."""
    _, _, port = flow_pair(num_pts=NUM_PTS)
    batches = data[1]
    for steps in ((1, 3), ()):
        logger = RunLogger({"log_dir": str(tmp_path / str(len(steps))),
                            "tag": "prof", "console": False,
                            "tensorboard": False})
        state = create_train_state(copy.deepcopy(port),
                                   make_optimizer(OPT_CFG, STEPS))
        trainer = Trainer(logger, {"epoch": 1, "profile_steps": steps,
                                   "ckpt_interval": 0, "eval_interval": 0},
                          tasks.FlowUNetTask(),
                          install_signal_handlers=False, device="cpu")
        state, rc = trainer.train(state, batches)
        assert rc == 0 and state.step == STEPS
        prof_dir = os.path.join(logger.run_dir, "profile")
        if not steps:
            assert not os.path.exists(prof_dir)
            continue
        (name,) = os.listdir(prof_dir)
        assert name == "steps_1_3.pt.trace.json"
        with open(os.path.join(prof_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        assert any("conv1d" in str(e.get("name", "")) for e in events)
        logger.flush()
        with open(os.path.join(logger.run_dir, "log.txt")) as f:
            log = f.read()
        assert "profiler trace started at step 1" in log
        assert "profiler trace stopped" in log
