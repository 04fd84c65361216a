"""The fc detectors of the port against the JAX package's, on the CPU: the
polar grid (``ops/polar_grid.py``), ``DetectionTask``'s fc encodings,
``PolarGridDetector`` (``models/polar_grid_net.py``), three AMSGrad steps
of an fc2d ``DetectionTask``, ``cli.train`` on a ``network: fc2d`` config
and ``cli.export_model`` of ``drow`` and ``fc2d``.

64 beams, 3 scans, ``hidden`` 32, B=2, inputs made from a seed with numpy,
weights from flax ``init`` with perturbed BatchNorm statistics carried
across by the bridge. Bars:

* the polar grid equal to the bit to JAX's compiled (``jax.jit``) grid,
  the one the JAX train step computes, on ranges sitting on and beside
  every bin edge; the one exception is a subnormal range (1e-45 m), which
  XLA's CPU flushes to zero and the port keeps;
* ``fc1d`` equal to the bit, ``fc2d`` to the bit of JAX's compiled
  encoding, ``fc1d_fea`` within 1e-4 of JAX's eager cutouts (the module
  cutout's bar, ``tests/test_torch_kernels.py``);
* ``PolarGridDetector``: f32 outputs and the running statistics after a
  train-mode forward within 1e-3 of the largest value; bf16 outputs at
  JAX's bf16 bar and their statistics within 1e-3;
* the train steps at ``tests/test_torch_train_steps.py``'s bars.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.models import get_model as jax_get_model
from planar_optical_flow_tpu.ops.polar_grid import (
    scans_to_polar_grid as jax_polar_grid,
)
from planar_optical_flow_tpu.train import Trainer as JaxTrainer
from planar_optical_flow_tpu.train import create_train_state as jax_state
from planar_optical_flow_tpu.train import make_optimizer as jax_optimizer
from planar_optical_flow_tpu.train import tasks as jax_tasks
from planar_optical_flow_tpu.utils.logger import RunLogger as JaxLogger
from planar_optical_flow_tpu_torch.cli import evaluate as evaluate_cli
from planar_optical_flow_tpu_torch.cli import export_model as export_model_cli
from planar_optical_flow_tpu_torch.cli import train as train_cli
from planar_optical_flow_tpu_torch.infer import load_model
from planar_optical_flow_tpu_torch.interop import variables_to_state_dict
from planar_optical_flow_tpu_torch.interop.checkpoint import (
    load_weights,
    save_weights,
)
from planar_optical_flow_tpu_torch.models import (
    PolarGridDetector,
    fc_in_features_of,
    get_model,
    num_cutout_pts_of,
)
from planar_optical_flow_tpu_torch.ops import scans_to_polar_grid
from planar_optical_flow_tpu_torch.ops.polar_grid import num_range_bins
from planar_optical_flow_tpu_torch.pipeline import normalize_config
from planar_optical_flow_tpu_torch.train import (
    Trainer,
    create_train_state,
    exp_decay_schedule,
    make_optimizer,
    tasks,
)
from planar_optical_flow_tpu_torch.train.state import named_stats, set_stats
from planar_optical_flow_tpu_torch.utils.logger import RunLogger

from tests.test_torch_common import one_thread  # noqa: F401
from tests.test_torch_common import (
    CUTOUT_KW,
    NUM_PTS,
    REPO,
    perturb_batch_stats,
    t2n,
    to_jax,
)
from tests.test_torch_train import _cast_tree, bf16_bar, f32_bar
from tests.test_torch_train_steps import STATS, _batches, _rel_l2

S_SCANS, BATCH, HIDDEN, STEPS = 3, 2, 32, 3
PG = dict(min_range=0.0, max_range=20.0, range_bin_size=1.0, tsdf_clip=1.0,
          normalize=True)
R_BINS = 21
CUT_FEA = dict(CUTOUT_KW, area_mode=False, gather_mode="gather")
SCHEDULE = dict(epoch0=0, lr0=1e-3, epoch1=2, lr1=1e-4)
OPT_CFG = {"scheduler_kwargs": SCHEDULE}


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


# -------------------------------------------------------------- polar grid


def _edge_scans():
    """Ranges on every bin edge of the 0.1 m grid and one f32 step to each
    side, random ranges past both ends, and the subnormal 1e-45."""
    rng = np.random.default_rng(0)
    edges = np.arange(301, dtype=np.float32) * np.float32(0.1)
    flat = np.concatenate([
        edges, np.nextafter(edges, np.float32(0)),
        np.nextafter(edges, np.float32(40)),
        rng.uniform(-1.0, 32.0, 197).astype(np.float32)]).astype(np.float32)
    return np.stack([flat, flat[::-1]]).reshape(2, 2, -1)  # (B, S, P)


@pytest.mark.parametrize("kw", [
    dict(range_bin_size=0.1),
    dict(range_bin_size=0.1, normalize=False),
    dict(range_bin_size=0.1, tsdf_clip=0.0),
    dict(min_range=0.5, max_range=20.0, range_bin_size=0.3, tsdf_clip=0.7),
])
def test_polar_grid_matches_jax_to_the_bit(kw):
    scans = _edge_scans()
    ref = np.asarray(jax.jit(lambda s: jax_polar_grid(s, **kw))(
        jnp.asarray(scans)))
    got = t2n(scans_to_polar_grid(torch.from_numpy(scans), **kw))
    bins = num_range_bins(kw.get("min_range", 0.0),
                          kw.get("max_range", 30.0), kw["range_bin_size"])
    assert got.shape == ref.shape == (2, 2, bins, scans.shape[-1])
    subnormal = (np.abs(scans) < np.finfo(np.float32).tiny) & (scans != 0)
    off = got != ref
    # where XLA flushed a subnormal range to zero, only that range's value
    assert not (off & ~subnormal[:, :, None, :]).any(), np.argwhere(off)
    assert np.all(np.abs(got[off]) < np.finfo(np.float32).tiny)


def test_polar_grid_bins_and_oracle():
    """301 bins from 0 to 30 m at 0.1 m, counted in Python floats as JAX
    counts them; the grid equal to the reference's scalar loop
    (``tests/oracles.py``, the JAX test's bar 1e-5) on random ranges."""
    from tests.oracles import polar_grid_loop

    assert num_range_bins(0.0, 30.0, 0.1) == 301
    assert num_range_bins(0.0, 20.0, 1.0) == R_BINS
    scans = np.random.default_rng(1).uniform(0.5, 19.0, (3, NUM_PTS)
                                             ).astype(np.float32)
    got = t2n(scans_to_polar_grid(torch.from_numpy(scans), **PG))
    np.testing.assert_allclose(got, polar_grid_loop(scans, **PG), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------- encodings


def _tasks(encoding):
    kw = dict(cutout_kwargs=CUT_FEA, pedestrian_only=True, num_pts=NUM_PTS,
              encoding=encoding, polar_grid_kwargs=PG)
    return jax_tasks.DetectionTask(**kw), tasks.DetectionTask(**kw)


@pytest.mark.parametrize("encoding,r", [("fc1d", 1), ("fc1d_fea", 16),
                                        ("fc2d", R_BINS)])
def test_fc_encodings_match_jax(encoding, r):
    scans = np.random.default_rng(2).uniform(
        0.5, 19.0, (BATCH, S_SCANS, NUM_PTS)).astype(np.float32)
    jtask, task = _tasks(encoding)
    got = t2n(task._encode(torch.from_numpy(scans)))
    assert got.shape == (BATCH, S_SCANS, r, NUM_PTS)
    if encoding == "fc1d_fea":
        ref = np.asarray(jtask._encode(jnp.asarray(scans)))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        ref = np.asarray(jax.jit(jtask._encode)(jnp.asarray(scans)))
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------- detector


def _detector_pair(in_r=R_BINS, seed=0):
    """(flax PolarGridDetector, numpy variables with perturbed statistics,
    the port's detector with the same weights)."""
    cfg = {"type": "fc2d", "pedestrian_only": True, "hidden": HIDDEN}
    jm = jax_get_model(cfg)
    variables = jm.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, S_SCANS, in_r, NUM_PTS)), train=False)
    v_np = perturb_batch_stats(variables, np.random.default_rng(seed + 100))
    port = get_model(cfg, in_features=S_SCANS * in_r)
    port.load_state_dict(variables_to_state_dict(v_np, port), strict=True)
    return jm, v_np, port


def _grid():
    scans = np.random.default_rng(3).uniform(
        0.5, 19.0, (BATCH, S_SCANS, NUM_PTS)).astype(np.float32)
    return np.asarray(jax.jit(lambda s: jax_polar_grid(s, **PG))(
        jnp.asarray(scans)))


@pytest.mark.parametrize("train", [False, True])
def test_polar_grid_detector_f32_matches_jax(train):
    jm, v_np, port = _detector_pair()
    grid = _grid()
    if train:
        ref, mut = jm.apply(to_jax(v_np), jnp.asarray(grid), train=True,
                            mutable=["batch_stats"])
        ref_stats = variables_to_state_dict(
            {"params": v_np["params"],
             "batch_stats": jax.device_get(mut["batch_stats"])}, port)
    else:
        ref = jm.apply(to_jax(v_np), jnp.asarray(grid), train=False)
    got = port(torch.from_numpy(grid), train=train)
    assert got[0].shape == (BATCH, NUM_PTS, 1)
    assert got[1].shape == (BATCH, NUM_PTS, 2)
    for g, r, what in zip(got, ref, ("cls", "reg")):
        f32_bar(t2n(g), np.asarray(r), 1e-3, what)
    if train:
        for n, t in named_stats(port).items():
            f32_bar(t2n(t), t2n(ref_stats[n]), 1e-3, n)


def test_polar_grid_detector_bf16_matches_jax():
    """bf16 parameters and statistics (the trainer's compute dtype) and a
    bf16 grid, in eval and train mode."""
    jm, v_np, port = _detector_pair()
    grid = _grid()
    cast = {"params": _cast_tree(to_jax(v_np["params"]), jnp.bfloat16),
            "batch_stats": _cast_tree(to_jax(v_np["batch_stats"]),
                                      jnp.bfloat16)}
    jg = jnp.asarray(grid, jnp.bfloat16)
    tg = torch.from_numpy(grid).bfloat16()
    master = dict(named_stats(port))
    for train in (False, True):
        set_stats(port, {n: t.bfloat16() for n, t in master.items()})
        if train:
            ref, mut = jm.apply(cast, jg, train=True,
                                mutable=["batch_stats"])
        else:
            ref = jm.apply(cast, jg, train=False)
        got = port(tg, train=train)
        for g, r, what in zip(got, ref, ("cls", "reg")):
            assert g.dtype == torch.bfloat16
            bf16_bar(t2n(g), np.asarray(r, np.float32),
                     f"{what} train={train}")
        if train:
            ref_stats = variables_to_state_dict(
                {"params": v_np["params"],
                 "batch_stats": jax.device_get(mut["batch_stats"])}, port)
            for n, t in named_stats(port).items():
                f32_bar(t2n(t), t2n(ref_stats[n]), 1e-3, n)


def test_polar_grid_detector_checks_its_width():
    port = get_model({"type": "fc1d"}, in_features=S_SCANS)
    assert isinstance(port, PolarGridDetector) and port.cls.out_features == 4
    with pytest.raises(ValueError, match="S\\*R"):
        port(torch.zeros(1, S_SCANS + 1, 1, NUM_PTS))


# ------------------------------------------------------------- train steps


def _steps_batches():
    """The step tests' targets with i.i.d. ranges over the grid's span, so
    that every grid row is within the TSDF clip of a hit in every batch.
    (The synthetic walls of ``_batches`` leave most rows constant over a
    batch; a row's embedding weights then have an exact gradient of 0,
    where AMSGrad steps +-lr on the two packages' rounding.)"""
    rng = np.random.default_rng(11)
    return [{"scans": rng.uniform(0.5, 19.5, (BATCH, S_SCANS, NUM_PTS))
             .astype(np.float32),
             "target_cls": b["target_cls"], "target_reg": b["target_reg"]}
            for b in _batches(STEPS)]


def _jax_run(jm, v_np, batches, compute_dtype, tmp_path):
    jtask = _tasks("fc2d")[0]
    tx = jax_optimizer(OPT_CFG, steps_per_epoch=STEPS)
    state = jax_state(jm, (jnp.zeros((1, S_SCANS, R_BINS, NUM_PTS)),), tx,
                      init_kwargs={"train": False})
    params = to_jax(v_np["params"])
    state = state.replace(params=params, batch_stats=to_jax(
        v_np["batch_stats"]), opt_state=tx.init(params))
    logger = JaxLogger({"log_dir": str(tmp_path / "jax"), "tag": "fc2d",
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


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_three_fc2d_train_steps_match_jax(compute_dtype, tmp_path):
    jm, v_np, port = _detector_pair()
    batches = _steps_batches()
    ref_losses, ref_v = _jax_run(jm, v_np, batches, compute_dtype, tmp_path)
    state = create_train_state(port, make_optimizer(OPT_CFG, STEPS))
    logger = RunLogger({"log_dir": str(tmp_path / "port"), "tag": "fc2d",
                        "console": False, "tensorboard": False})
    trainer = Trainer(logger, {"compute_dtype": compute_dtype,
                               "log_norms": False}, _tasks("fc2d")[1],
                      install_signal_handlers=False, device="cpu")
    got_losses = []
    for b in batches:
        state, tb = trainer.train_step(
            state, {k: torch.from_numpy(v) for k, v in b.items()})
        got_losses.append(float(tb["loss"]))
    f32 = compute_dtype is None
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


# -------------------------------------------------------------------- CLIs


def _cfg_file(tmp_path, network, **extra):
    """A flat config of ``network`` (``configs/dr_spaam.yaml``'s keys),
    normalized and written as JSON with the logger's console and
    tensorboard writer off -> (nested config, path)."""
    cfg = normalize_config({
        "epochs": 1, "batch_size": 4, "num_scans": S_SCANS - 1,
        "pedestrian_only": True, "network": network, "ckpt_interval": 1,
        "eval_interval": 1, "cutout_kwargs": CUT_FEA,
        "polar_grid_kwargs": PG, "log_dir": str(tmp_path / "logs"),
        **extra})
    cfg["pipeline"]["Logger"].update(console=False, tensorboard=False)
    path = tmp_path / f"{network}.json"
    path.write_text(json.dumps(cfg))
    return cfg, str(path)


def test_cli_train_fc2d(tmp_path):
    """``cli.train --cpu`` on a ``network: fc2d`` JSON config and a
    64-beam synthetic split: a ``PolarGridDetector`` on the polar grid
    trains an epoch, checkpoints and scores itself; its final checkpoint
    restores into a new ``Pipeline`` of the config, and ``cli.evaluate``
    scores it on the module path."""
    import signal

    from planar_optical_flow_tpu_torch.data import write_synthetic_drow_split
    from planar_optical_flow_tpu_torch.pipeline import Pipeline

    data = str(tmp_path / "drow")
    write_synthetic_drow_split(data, "train", num_sequences=1,
                               num_frames=14, num_pts=NUM_PTS)
    write_synthetic_drow_split(data, "val", num_sequences=1, num_frames=8,
                               num_pts=NUM_PTS, seed=7)
    cfg, path = _cfg_file(tmp_path, "fc2d", data_dir=data)
    saved = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        assert train_cli.main(["--cfg", path, "--cpu"]) == 0
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    (run,) = [r for r in os.listdir(tmp_path / "logs")
              if not r.startswith("sigterm")]
    run_dir = tmp_path / "logs" / run
    assert sorted(os.listdir(run_dir / "ckpt")) == ["ckpt_e1", "ckpt_final"]
    with open(run_dir / "tb" / "scalars.jsonl") as f:
        losses = [r["value"] for r in map(json.loads, f)
                  if r["key"] == "TRAIN_loss"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    final = json.loads((run_dir / "output" / "final_metrics.json")
                       .read_text())
    assert {"cls_loss", "reg_loss"} <= set(final)
    pipe = Pipeline(cfg, device="cpu", install_signal_handlers=False)
    assert isinstance(pipe.model, PolarGridDetector)
    assert pipe.model.in_features == S_SCANS * R_BINS
    assert pipe.task.encoding == "fc2d" and pipe.task.polar_grid_kwargs == PG
    ckpt = str(run_dir / "ckpt" / "ckpt_final")
    pipe.load_ckpt(ckpt)
    assert pipe.state.epoch == 1 and pipe.state.step == len(losses)
    # cli.evaluate's module path: Pipeline.evaluate's metrics of the
    # checkpoint, the run's own final metrics; --ap is for the DROW types
    got = evaluate_cli.evaluate(["--cfg", path, "--ckpt", ckpt, "--cpu"])
    assert got == {k: round(float(v), 6) for k, v in final.items()}
    with pytest.raises(SystemExit):
        evaluate_cli.evaluate(["--cfg", path, "--ckpt", ckpt, "--ap",
                               "--cpu"])


@pytest.mark.parametrize("network,mtype", [("cutout", "drow"),
                                           ("fc2d", "fc2d")])
def test_cli_export_model_stateless_detectors(network, mtype, tmp_path):
    """``cli.export_model --cpu`` of ``drow`` and ``fc2d`` at JAX's example
    input shapes: the loaded engine equal to the bit to the live forward of
    the same weights."""
    cfg, path = _cfg_file(tmp_path, network)
    assert cfg["model"]["type"] == mtype
    model = get_model(cfg["model"], num_cutout_pts_of(cfg),
                      generator=torch.Generator().manual_seed(5),
                      in_features=fc_in_features_of(cfg))
    weights = save_weights(model, str(tmp_path / "w.pt"))
    out = str(tmp_path / "engine")
    assert export_model_cli.main(["--cfg", path, "--ckpt", weights, "--out",
                                  out, "--batch", "2", "--num-pts",
                                  str(NUM_PTS), "--cpu"]) == 0
    engine = load_model(out)
    assert engine.meta["model_type"] == mtype
    shape = ((2, NUM_PTS, S_SCANS, 16) if mtype == "drow"
             else (2, S_SCANS, R_BINS, NUM_PTS))
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        -1.0, 1.0, shape).astype(np.float32))
    live = load_weights(get_model(cfg["model"], num_cutout_pts_of(cfg),
                                  in_features=fc_in_features_of(cfg)),
                        weights)
    with torch.no_grad():
        want = live(x)
    got = engine(x)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_new_modules_import_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['planar_optical_flow_tpu'] = None\n"
            "import planar_optical_flow_tpu_torch.ops.polar_grid\n"
            "import planar_optical_flow_tpu_torch.models.polar_grid_net\n"
            "import planar_optical_flow_tpu_torch.models.adaboost_detector\n"
            "import planar_optical_flow_tpu_torch.cli.export_model\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=str(REPO)))
