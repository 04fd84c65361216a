"""The port's box-regression ops, model, task and evaluators against the
JAX package's, on the CPU.

* Rotated IoU: the matrix, paired, 3D and criterion forms against JAX at
  JAX's own bar (``rtol=1e-4, atol=1e-5``) and against the port's
  Sutherland-Hodgman oracle, on random, structured (identical, shared,
  touching and contained edges) and near-coincident boxes.
* ``BoundingBoxRegressor`` and ``TNet`` in eval mode on bridged weights
  (within 1e-4 x max |JAX|); the gradient of the max over repeated points,
  split between the tied maxima as JAX splits it.
* Three AMSGrad steps of ``BoxRegressionTask`` (dropout 0) against JAX's
  trainer: parameters and statistics to 1e-3 relative L2 in f32, 2e-2 in
  bf16 (the bars of ``tests/test_torch_train_steps.py``).
* ``BoxRegressionTask.metrics``, ``evaluate_box_regression`` and
  ``mean_box_baseline`` against JAX's.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu import ops as jax_ops
from planar_optical_flow_tpu.data import jrdb as jax_jrdb
from planar_optical_flow_tpu.data.loader import BatchLoader as JaxLoader
from planar_optical_flow_tpu.eval.baseline import (
    mean_box_baseline as jax_baseline,
)
from planar_optical_flow_tpu.eval.evaluator import (
    evaluate_box_regression as jax_evaluate,
)
from planar_optical_flow_tpu.models import get_model as jax_get_model
from planar_optical_flow_tpu.models.pointnet import (
    BoundingBoxRegressor as JaxRegressor,
)
from planar_optical_flow_tpu.models.pointnet import PointNet as JaxPointNet
from planar_optical_flow_tpu.models.pointnet import TNet as JaxTNet
from planar_optical_flow_tpu.train import Trainer as JaxTrainer
from planar_optical_flow_tpu.train import create_train_state as jax_state
from planar_optical_flow_tpu.train import make_optimizer as jax_optimizer
from planar_optical_flow_tpu.train import tasks as jax_tasks
from planar_optical_flow_tpu.utils.logger import RunLogger as JaxLogger
from planar_optical_flow_tpu_torch.data import BatchLoader, jrdb
from planar_optical_flow_tpu_torch.eval import (
    evaluate_box_regression,
    mean_box_baseline,
)
from planar_optical_flow_tpu_torch.interop import variables_to_state_dict
from planar_optical_flow_tpu_torch.models import (
    BoundingBoxRegressor,
    PointNet,
    TNet,
    get_model,
)
from planar_optical_flow_tpu_torch.ops import losses
from planar_optical_flow_tpu_torch.ops import rotated_iou as riou
from planar_optical_flow_tpu_torch.train import (
    Trainer,
    create_train_state,
    exp_decay_schedule,
    make_optimizer,
    tasks,
)
from planar_optical_flow_tpu_torch.train.trainer import to_device
from planar_optical_flow_tpu_torch.utils.logger import RunLogger

from tests.test_torch_box_data import BOX_CFG
from tests.test_torch_common import perturb_batch_stats, t2n, to_jax

# the module (``ops.rotated_iou`` the attribute is the function)
jax_riou = importlib.import_module("planar_optical_flow_tpu.ops.rotated_iou")
IOU_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_ops_nms_iou.py
STRUCTURED = np.asarray([
    [0.0, 0.0, 1.0, 1.0, 0.0],
    [0.0, 0.0, 1.0, 1.0, 0.0],        # identical
    [0.5, 0.0, 1.0, 1.0, 0.0],        # shared collinear top/bottom
    [1.0, 0.0, 1.0, 1.0, 0.0],        # edge touching only
    [1.0, 1.0, 1.0, 1.0, 0.0],        # corner touching only
    [0.0, 0.0, 4.0, 4.0, 0.2],        # contains the rotated ones
    [0.0, 0.0, 1.0, 2.0, 1.1],
    [0.0, 0.0, 1.0, 1.0, np.pi / 4],
    [0.25, 0.25, 0.5, 0.5, 0.0],      # contained, shares no boundary
    [0.0, 0.0, 2.0, 1.0, np.pi / 2],  # 90-degree rotation
], np.float32)
INPUT_SIZE, BATCH, STEPS = 32, 8, 3
SCHEDULE = dict(epoch0=0, lr0=1e-3, epoch1=2, lr1=1e-4)
STATS = ("running_mean", "running_var")


def _boxes2d(rng, n, spread=3.0):
    return np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                           rng.uniform(0.3, 3.0, (n, 2)),
                           rng.uniform(-np.pi, np.pi, (n, 1))],
                          1).astype(np.float32)


def _to3d(b, rng):
    return np.column_stack([b[:, 0], b[:, 1], rng.uniform(-1, 1, len(b)),
                            b[:, 2], b[:, 3], rng.uniform(0.5, 2, len(b)),
                            b[:, 4]]).astype(np.float32)


def _near_copies(b, rng, scale=1e-5):
    """``b`` moved by less than the on-plane band: nearly shared edges,
    where the two packages' roundings meet the band's thresholds."""
    return (b + rng.normal(0, scale, b.shape)).astype(np.float32)


# ---------------------------------------------------------------- IoU


@pytest.fixture(scope="module")
def iou_cases():
    """The cases' boxes stacked into one ``(N, K)`` block matrix, and JAX's
    matrix, paired (on the broadcast pairs) and 3D forms of it for every
    criterion: one shape, so JAX compiles its operations once."""
    rng = np.random.default_rng(7)
    near = _boxes2d(rng, 16, spread=1.0)
    blocks = {"random": (_boxes2d(rng, 40), _boxes2d(rng, 24)),
              "structured": (STRUCTURED, STRUCTURED),
              "near": (near, np.concatenate([_near_copies(near, rng), near,
                                             _boxes2d(rng, 8)]))}
    a = np.concatenate([v[0] for v in blocks.values()])
    b = np.concatenate([v[1] for v in blocks.values()])
    rows, cols, r0, c0 = {}, {}, 0, 0
    for name, (x, y) in blocks.items():
        rows[name], cols[name] = slice(r0, r0 + len(x)), slice(c0, c0 + len(y))
        r0, c0 = r0 + len(x), c0 + len(y)
    a3, b3 = _to3d(a, rng), _to3d(b, rng)
    pa = np.broadcast_to(a3[:, None], (len(a), len(b), 7))
    pb = np.broadcast_to(b3[None], (len(a), len(b), 7))
    ref = {}
    for crit in (-1, 0, 1, 2):
        ref["2d", crit] = np.asarray(jax_ops.rotated_iou(a, b, crit))
        ref["3d", crit] = np.asarray(jax_ops.rotated_iou_3d(a3, b3, crit))
    two = [0, 1, 3, 4, 6]
    ref["2d paired"] = np.asarray(jax_ops.rotated_iou_paired(pa[..., two],
                                                             pb[..., two]))
    ref["3d paired"] = np.asarray(jax_ops.rotated_iou_3d_paired(pa, pb))
    return dict(a=a, b=b, a3=a3, b3=b3, pa=pa, pb=pb, rows=rows, cols=cols,
                ref=ref)


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
@pytest.mark.parametrize("case", ["random", "structured", "near"])
def test_rotated_iou_matches_jax_and_sh(iou_cases, case, criterion):
    """The matrix form of each case against JAX and against the port's
    Sutherland-Hodgman oracle; identical boxes give 1."""
    r, c = iou_cases["rows"][case], iou_cases["cols"][case]
    a, b = iou_cases["a"][r], iou_cases["b"][c]
    got = riou.rotated_iou(a, b, criterion=criterion)
    assert got.dtype == torch.float32 and got.shape == (len(a), len(b))
    np.testing.assert_allclose(t2n(got),
                               iou_cases["ref"]["2d", criterion][r, c],
                               **IOU_TOL)
    sh = riou.rotated_iou_sh(a, b, criterion=criterion)
    np.testing.assert_allclose(t2n(got), t2n(sh), **IOU_TOL)
    if case == "structured" and criterion == -1:
        np.testing.assert_allclose(np.diag(t2n(got)), 1.0, rtol=1e-5)


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
def test_rotated_iou_3d_matches_jax(iou_cases, criterion):
    got = riou.rotated_iou_3d(iou_cases["a3"], iou_cases["b3"], criterion)
    np.testing.assert_allclose(t2n(got), iou_cases["ref"]["3d", criterion],
                               **IOU_TOL)


def test_rotated_iou_paired_and_helpers_match_jax(iou_cases):
    """The paired forms on every pair of the block matrix (the metrics'
    broadcast form: a box against its neighbours) against JAX's and the
    matrix forms; ``box_corners`` and ``aabb_iou``."""
    pa, pb = torch.tensor(iou_cases["pa"]), torch.tensor(iou_cases["pb"])
    two = [0, 1, 3, 4, 6]
    got = riou.rotated_iou_paired(pa[..., two], pb[..., two])
    np.testing.assert_allclose(t2n(got), iou_cases["ref"]["2d paired"],
                               **IOU_TOL)
    np.testing.assert_allclose(
        t2n(got), t2n(riou.rotated_iou(iou_cases["a"], iou_cases["b"])),
        rtol=1e-6, atol=1e-7)
    # broadcast (N, 1, 7) against (1, K, 7), as the metrics call it
    got = riou.rotated_iou_3d_paired(torch.tensor(iou_cases["a3"])[:, None],
                                     torch.tensor(iou_cases["b3"])[None])
    np.testing.assert_allclose(t2n(got), iou_cases["ref"]["3d paired"],
                               **IOU_TOL)
    a = iou_cases["a"]
    np.testing.assert_allclose(t2n(riou.box_corners(a[3])),
                               np.asarray(jax_riou.box_corners(a[3])),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        t2n(riou.aabb_iou(a[:24, :4], iou_cases["b"][:24, :4])),
        np.asarray(jax_riou.aabb_iou(a[:24, :4], iou_cases["b"][:24, :4])),
        rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- model


def _variables(jm, x, seed=0, head=False):
    """numpy variables of ``jm`` with perturbed statistics; with ``head``
    the regressor's last layer predicts plausible boxes (small kernel,
    bias at a pedestrian's ``[cz, l, w, h, ori]`` or ``[l, w, ori]``)."""
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    v_np = perturb_batch_stats(v, np.random.default_rng(seed + 100))
    if head:
        fc3 = v_np["params"]["fc3"]["Dense_0"]
        fc3["kernel"] = fc3["kernel"] * np.float32(0.02)
        fc3["bias"] = np.asarray(
            [0.0, 0.7, 0.5, 1.7, 0.0][-fc3["bias"].shape[0]:], np.float32)
    return v_np


def _segments(seed=0, b=BATCH, n=INPUT_SIZE, dim=4):
    return np.random.default_rng(seed).normal(0, 0.3, (b, n, dim)).astype(
        np.float32)


@pytest.mark.parametrize("which", ["regressor", "regressor_2d", "tnet"])
def test_models_eval_match_jax(which):
    dim = 3 if which == "regressor_2d" else 4
    x = _segments(dim=dim)
    if which == "tnet":
        jm, port = JaxTNet(input_dim=dim), TNet(input_dim=dim)
    else:
        tdim = 3 if which == "regressor_2d" else 5
        jm = JaxRegressor(input_dim=dim, target_dim=tdim)
        port = BoundingBoxRegressor(input_dim=dim, target_dim=tdim)
    v_np = _variables(jm, x)
    port.load_state_dict(variables_to_state_dict(v_np, port))
    ref = np.asarray(jm.apply(to_jax(v_np), jnp.asarray(x), train=False))
    got = t2n(port(torch.tensor(x)))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_registry_box_reg_takes_jax_weights():
    cfg = {"type": "box_reg", "input_dim": 4, "target_dim": 5,
           "dropout": 0.3}
    jm = jax_get_model(cfg)
    v_np = _variables(jm, _segments())
    port = get_model(cfg)
    assert type(port).__name__ == type(jm).__name__
    assert (port.input_dim, port.target_dim, port.dropout) == (4, 5, 0.3)
    port.load_state_dict(variables_to_state_dict(v_np, port), strict=True)


def test_max_over_repeated_points_splits_its_gradient_as_jax():
    """A resampled segment repeats its points, so every channel's maximum
    is tied; JAX's ``jnp.max`` and the port's ``amax`` pass the cotangent
    in equal parts to each tied point."""
    v = torch.tensor([1.0, 3.0, 3.0, 2.0], requires_grad=True)
    v.amax(dim=0).backward()
    np.testing.assert_array_equal(t2n(v.grad), [0.0, 0.5, 0.5, 0.0])
    np.testing.assert_array_equal(
        np.asarray(jax.grad(lambda a: jnp.max(a, axis=0))(
            jnp.asarray([1.0, 3.0, 3.0, 2.0]))), [0.0, 0.5, 0.5, 0.0])

    base = _segments(seed=3, b=2, n=5)
    x = np.repeat(base, [3, 1, 2, 4, 6], axis=1)  # 16 points, tied rows
    jm, port = JaxPointNet(), PointNet(4, generator=torch.Generator())
    v_np = _variables(jm, x)
    port.load_state_dict(variables_to_state_dict(v_np, port))
    w = np.random.default_rng(4).normal(0, 1, (2, 1024)).astype(np.float32)
    ref = jax.grad(lambda a: jnp.sum(
        jm.apply(to_jax(v_np), a, train=False) * w))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (port(xt) * torch.tensor(w)).sum().backward()
    got, ref = t2n(xt.grad), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())
    # the copies of a point share its gradient equally
    np.testing.assert_allclose(got[:, 0], got[:, 2], rtol=1e-6)


# ------------------------------------------------------------ training


@pytest.fixture(scope="module")
def box_data(tmp_path_factory):
    """A synthetic JRDB tree and a box-regression config at 32 points a
    segment."""
    root = tmp_path_factory.mktemp("jrdb")
    jax_jrdb.write_synthetic_jrdb(str(root), num_frames=3,
                                  boxes_per_frame=5, seed=1)
    return dict(BOX_CFG, data_dir=str(root), input_size=INPUT_SIZE)


def _batches(cfg, n=STEPS):
    ds = jrdb.JrdbBoxRegressionDataset("train", cfg, seed=0)
    idx = np.random.default_rng(0).permutation(len(ds))
    return [ds.batch(idx[i * BATCH:(i + 1) * BATCH]) for i in range(n)]


def _rel_l2(got, ref):
    g = np.concatenate([np.ravel(a) for a in got]).astype(np.float64)
    r = np.concatenate([np.ravel(a) for a in ref]).astype(np.float64)
    return float(np.linalg.norm(g - r) / np.linalg.norm(r))


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_three_box_train_steps_match_jax(box_data, compute_dtype, tmp_path):
    batches = _batches(box_data)
    jm = JaxRegressor(dropout=0.0)
    v_np = _variables(jm, batches[0]["input"], head=True)
    opt_cfg = {"scheduler_kwargs": SCHEDULE}

    tx = jax_optimizer(opt_cfg, steps_per_epoch=STEPS)
    state = jax_state(jm, (jnp.asarray(batches[0]["input"]),), tx,
                      init_kwargs={"train": False})
    params = to_jax(v_np["params"])
    state = state.replace(params=params,
                          batch_stats=to_jax(v_np["batch_stats"]),
                          opt_state=tx.init(params))
    logger = JaxLogger({"log_dir": str(tmp_path / "jax"), "tag": "box",
                        "console": False, "tensorboard": False})
    jtrainer = JaxTrainer(logger, {"compute_dtype": compute_dtype,
                                   "log_norms": False},
                          jax_tasks.BoxRegressionTask(),
                          install_signal_handlers=False)
    jtrainer._build_steps(state)
    ref_losses = []
    for b in batches:
        state, tb = jtrainer._train_step(
            state, {k: jnp.asarray(v) for k, v in b.items()},
            jax.random.PRNGKey(0))
        ref_losses.append(float(tb["loss"]))

    port = BoundingBoxRegressor(dropout=0.0)
    port.load_state_dict(variables_to_state_dict(v_np, port))
    pstate = create_train_state(port, make_optimizer(opt_cfg, STEPS))
    trainer = Trainer(RunLogger({"log_dir": str(tmp_path / "port"),
                                 "tag": "box", "console": False,
                                 "tensorboard": False}),
                      {"compute_dtype": compute_dtype, "log_norms": False},
                      tasks.BoxRegressionTask(),
                      install_signal_handlers=False, device="cpu")
    got_losses = []
    for b in batches:
        pstate, tb = trainer.train_step(pstate, to_device(b, "cpu"))
        got_losses.append(float(tb["loss"]))

    f32 = compute_dtype is None
    np.testing.assert_allclose(got_losses, ref_losses,
                               rtol=1e-3 if f32 else 2e-2)
    ref = variables_to_state_dict(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}), port)
    got = {n: t for n, t in pstate.model.state_dict().items()
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


def test_box_dropout_trains_with_its_rate():
    """Dropout 0.3 after ``fc2`` in train mode: the masks come from the
    generator (JAX's from its own RNG, so only the statistics are held):
    about 30% of the features dropped, the rest scaled by 1 / 0.7, and
    none in eval mode."""
    model = BoundingBoxRegressor(dropout=0.3)
    x = torch.tensor(_segments(b=64))
    seen = {}
    model.fc3.register_forward_pre_hook(
        lambda m, args: seen.__setitem__("x", args[0]))
    model(x, train=True, rng=torch.Generator().manual_seed(1))
    dropped = float((seen["x"] == 0).float().mean())
    model(x, train=False)
    assert 0.25 < dropped < 0.35, dropped
    assert float((seen["x"] == 0).float().mean()) < dropped - 0.2


# ------------------------------------------------- metrics and evaluators


@pytest.mark.parametrize("is_3d", [True, False])
def test_box_metrics_evaluator_and_baseline_match_jax(box_data, is_3d):
    cfg = dict(box_data, is_3d=is_3d)
    if not is_3d:  # the synthetic lasers are random ranges: a wider crop
        cfg.update(radius_segment=3.0, min_segment_size=1)
    dim, tdim = (4, 5) if is_3d else (3, 3)
    jm = JaxRegressor(input_dim=dim, target_dim=tdim, dropout=0.3)
    port = BoundingBoxRegressor(input_dim=dim, target_dim=tdim, dropout=0.3)
    batch = jrdb.JrdbBoxRegressionDataset("val", cfg).batch(np.arange(BATCH))
    v_np = _variables(jm, batch["input"], head=True)
    port.load_state_dict(variables_to_state_dict(v_np, port))
    jtask = jax_tasks.BoxRegressionTask(is_3d=is_3d)
    task = tasks.BoxRegressionTask(is_3d=is_3d)

    ref, ref_out = jtask.metrics(jm.apply, to_jax(v_np),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    got, got_out = task.metrics(port, to_device(batch, "cpu"))
    assert set(got) == set(ref) == {"iou", "loss_z", "loss_dim", "loss_ori"}
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert float(ref["iou"]) > 0.05  # plausible boxes: the IoU is live
    np.testing.assert_allclose(t2n(got_out["pred"]),
                               np.asarray(ref_out["pred"]), rtol=1e-4,
                               atol=1e-5)

    tx = jax_optimizer({"scheduler_kwargs": SCHEDULE}, 1)
    jstate = jax_state(jm, (jnp.asarray(batch["input"]),), tx,
                       init_kwargs={"train": False})
    jstate = jstate.replace(params=to_jax(v_np["params"]),
                            batch_stats=to_jax(v_np["batch_stats"]))
    state = create_train_state(port, make_optimizer(
        {"scheduler_kwargs": SCHEDULE}, 1))
    # fresh datasets: each sample's draws follow the call order
    jds = jax_jrdb.JrdbBoxRegressionDataset("val", cfg)
    ds = jrdb.JrdbBoxRegressionDataset("val", cfg)
    bsz = 4
    ref = jax_evaluate(jtask, jstate, JaxLoader(jds, bsz, shuffle=False))
    got = evaluate_box_regression(task, state,
                                  BatchLoader(ds, bsz, shuffle=False))
    assert len(ds) >= 2 * bsz
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)

    ref = jax_baseline(jds)
    got = mean_box_baseline(ds, device="cpu")
    assert set(got) == set(ref) == ({"iou", "loss_dim", "loss_ori"}
                                    | ({"loss_z"} if is_3d else set()))
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_box_regression_loss_matches_jax():
    rng = np.random.default_rng(2)
    for d, alpha in ((5, 0.5), (3, 0.3)):
        pred, tgt = (rng.normal(0, 1, (20, d)).astype(np.float32)
                     for _ in range(2))
        ref = jax_ops.box_regression_loss(jnp.asarray(pred),
                                          jnp.asarray(tgt), alpha)
        got = losses.box_regression_loss(torch.tensor(pred),
                                         torch.tensor(tgt), alpha)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
