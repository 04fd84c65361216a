"""The port's trainer loop, checkpoints, preemption and training CLI, on
the CPU.

A synthetic 64-beam DROW corpus (``write_synthetic_drow_split``), FlowDROW
from flax ``init`` weights carried across by the bridge. The trainer loop
mirrors ``tests/test_train_e2e.py``'s (periodic checkpoints,
``latest_checkpoint``, evaluation; preemption, then a resume) and holds one
epoch's mean loss to the JAX ``Trainer``'s on the same corpus, loader seed
and weights, within 1e-3 in f32.
"""

from __future__ import annotations

import json
import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.data import BatchLoader as JaxLoader
from planar_optical_flow_tpu.data import (
    DrowDetectionDataset as JaxDataset,
)
from planar_optical_flow_tpu.train import Trainer as JaxTrainer
from planar_optical_flow_tpu.train import create_train_state as jax_state
from planar_optical_flow_tpu.train import make_optimizer as jax_optimizer
from planar_optical_flow_tpu.train import tasks as jax_tasks
from planar_optical_flow_tpu.utils.logger import RunLogger as JaxLogger
from planar_optical_flow_tpu_torch.cli import train as train_cli
from planar_optical_flow_tpu_torch.data import (
    DrowDetectionDataset,
    write_synthetic_drow_split,
)
from planar_optical_flow_tpu_torch.data.loader import BatchLoader
from planar_optical_flow_tpu_torch.interop.checkpoint import load_weights
from planar_optical_flow_tpu_torch.models import FlowDrow
from planar_optical_flow_tpu_torch.pipeline import Pipeline, normalize_config
from planar_optical_flow_tpu_torch.train import (
    Trainer,
    create_train_state,
    latest_checkpoint,
    make_optimizer,
    restore_checkpoint,
    save_checkpoint,
    tasks,
)
from planar_optical_flow_tpu_torch.train.checkpoint import (
    load_checkpoint_tree,
    restore_variables,
)
from planar_optical_flow_tpu_torch.utils.logger import RunLogger

from tests.test_torch_common import one_thread  # noqa: F401
from tests.test_torch_common import (
    CUTOUT_KW,
    NUM_PTS,
    WINDOW,
    flow_drow_pair,
    to_jax,
)

NUM_SCANS, BATCH = 2, 2
OPT_CFG = {"scheduler_kwargs": {"epoch0": 0, "lr0": 1e-3, "epoch1": 4,
                                "lr1": 1e-4}}
TASK_KW = dict(cutout_kwargs=CUTOUT_KW, pedestrian_only=True,
               num_pts=NUM_PTS)


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("drow"))
    write_synthetic_drow_split(d, "train", num_sequences=1, num_frames=30,
                               num_pts=NUM_PTS)
    write_synthetic_drow_split(d, "val", num_sequences=1, num_frames=12,
                               num_pts=NUM_PTS, seed=7)
    return d


def _logger_cfg(path, tag):
    return {"log_dir": str(path), "tag": tag, "console": False,
            "tensorboard": False}


def _port_setup(corpus, port):
    kw = dict(num_scans=NUM_SCANS, pedestrian_only=True, device="cpu")
    train = BatchLoader(DrowDetectionDataset(corpus, "train", **kw), BATCH,
                        seed=1)
    val = BatchLoader(DrowDetectionDataset(corpus, "val", **kw), BATCH,
                      shuffle=False)
    state = create_train_state(port, make_optimizer(OPT_CFG, len(train)))
    return train, val, state


def _step_losses(logger) -> list:
    with open(os.path.join(logger.tb_dir, "scalars.jsonl")) as f:
        return [r["value"] for r in map(json.loads, f)
                if r["key"] == "TRAIN_loss"]


def test_trainer_loop_matches_jax_and_checkpoints(corpus, tmp_path):
    jm, v_np, port = flow_drow_pair()
    # JAX: the same corpus, loader seed and weights
    jkw = dict(num_scans=NUM_SCANS, pedestrian_only=True)
    jtrain = JaxLoader(JaxDataset(corpus, "train", **jkw), BATCH, seed=1)
    tx = jax_optimizer(OPT_CFG, steps_per_epoch=len(jtrain))
    jstate = jax_state(jm, (jnp.zeros((1, NUM_PTS, NUM_SCANS + 1, 16)),
                            jnp.zeros((1, NUM_PTS))), tx,
                       init_kwargs={"train": False})
    params = to_jax(v_np["params"])
    jstate = jstate.replace(params=params, opt_state=tx.init(params),
                            batch_stats=to_jax(v_np["batch_stats"]))
    jlogger = JaxLogger(_logger_cfg(tmp_path / "jax", "loop"))
    jtrainer = JaxTrainer(jlogger, {"epoch": 1, "ckpt_interval": 0,
                                    "eval_interval": 0},
                          jax_tasks.FlowDrowTask(**TASK_KW),
                          install_signal_handlers=False)
    jstate, rc = jtrainer.train(jstate, jtrain)
    assert rc == 0
    jlogger.close()

    train, val, state = _port_setup(corpus, port)
    assert len(train) == len(jtrain)
    logger = RunLogger(_logger_cfg(tmp_path / "port", "loop"))
    trainer = Trainer(logger, {"epoch": 2, "ckpt_interval": 1,
                               "eval_interval": 1},
                      tasks.FlowDrowTask(**TASK_KW),
                      install_signal_handlers=False, device="cpu")
    state, rc = trainer.train(state, train, val)
    assert rc == 0 and state.epoch == 2 and state.step == 2 * len(train)
    logger.flush()
    got = np.mean(_step_losses(logger)[:len(train)])
    want = np.mean(_step_losses(jlogger))
    np.testing.assert_allclose(got, want, rtol=1e-3)

    # periodic checkpoints, restorable into a fresh state
    latest = latest_checkpoint(logger.ckpt_dir)
    assert latest and latest.endswith("ckpt_e2")
    assert os.path.isdir(os.path.join(logger.ckpt_dir, "ckpt_e1"))
    fresh = create_train_state(
        FlowDrow(window_size=WINDOW, pedestrian_only=True,
                 num_cutout_pts=16), make_optimizer(OPT_CFG, len(train)))
    restored = restore_checkpoint(latest, fresh)
    assert (restored.step, restored.epoch) == (state.step, state.epoch)
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    # a consumer with another optimizer takes the weights and counters
    other = create_train_state(
        FlowDrow(window_size=WINDOW, pedestrian_only=True,
                 num_cutout_pts=16), make_optimizer({"amsgrad": False}, 1))
    restore_variables(latest, other)
    assert other.step == state.step and "nu_max" not in other.opt_state
    # the weights file of a checkpoint serves the CLIs' --ckpt
    load_weights(FlowDrow(window_size=WINDOW, pedestrian_only=True,
                          num_cutout_pts=16), latest)
    tree = load_checkpoint_tree(latest)
    assert tree["step"] == state.step and "flow_out.bn.running_var" in \
        tree["batch_stats"] and "flow_out.conv.weight" in tree["params"]
    assert os.path.getsize(os.path.join(logger.tb_dir, "scalars.jsonl"))
    metrics = trainer.evaluate(restored, val)
    assert set(metrics) == {"epe", "aae"} and metrics["epe"] >= 0


class _StopAfter:
    """A loader that asks the trainer to stop after ``n`` batches."""

    def __init__(self, loader, trainer, n):
        self.loader, self.trainer, self.n = loader, trainer, n

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if i == self.n:
                self.trainer.request_stop()
            yield batch


def test_preemption_checkpoint_and_resume(corpus, tmp_path):
    """A stop after 2 steps writes the sigterm checkpoint (rc 1) outside the
    run directory; the state restored from it equals the one it was
    written from to the bit; a resumed run goes on from its epoch."""
    _, _, port = flow_drow_pair()
    train, _, state = _port_setup(corpus, port)
    logger = RunLogger(_logger_cfg(tmp_path, "pre"))
    trainer = Trainer(logger, {"epoch": 50, "ckpt_interval": 100,
                               "eval_interval": 100},
                      tasks.FlowDrowTask(**TASK_KW),
                      install_signal_handlers=False, device="cpu")
    state, rc = trainer.train(state, _StopAfter(train, trainer, 2))
    assert rc == 1 and state.step == 2 and state.epoch == 0
    assert os.path.isdir(logger.sigterm_ckpt)
    assert not logger.sigterm_ckpt.startswith(logger.run_dir)

    fresh = create_train_state(
        FlowDrow(window_size=WINDOW, pedestrian_only=True,
                 num_cutout_pts=16), make_optimizer(OPT_CFG, len(train)))
    resumed = restore_checkpoint(logger.sigterm_ckpt, fresh)
    assert (resumed.step, resumed.epoch) == (state.step, state.epoch)
    for k, v in state.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    assert resumed.opt_state["count"] == state.opt_state["count"] == 2
    for key in ("mu", "nu", "nu_max"):
        for n, t in state.opt_state[key].items():
            assert torch.equal(resumed.opt_state[key][n], t), (key, n)

    trainer2 = Trainer(logger, {"epoch": 1, "ckpt_interval": 100,
                                "eval_interval": 100},
                       tasks.FlowDrowTask(**TASK_KW),
                       install_signal_handlers=False, device="cpu")
    out, rc2 = trainer2.train(resumed, train)
    assert rc2 == 0 and out.epoch == 1
    assert out.step == 2 + len(train)
    # a save and a restore of the finished state are the identity as well
    path = save_checkpoint(str(tmp_path / "again"), out)
    assert restore_checkpoint(path, fresh).step == out.step


def _nested_cfg(tmp_path, **flat):
    cfg = normalize_config({
        "epochs": 1, "batch_size": 8, "num_scans": 1, "pedestrian_only": True,
        "network": "cutout_spatial", "ckpt_interval": 1, "eval_interval": 1,
        "similarity_kwargs": {"alpha": 0.5, "window_size": WINDOW},
        "cutout_kwargs": CUTOUT_KW, **flat})
    cfg["pipeline"]["Logger"].update(log_dir=str(tmp_path / "logs"),
                                     console=False, tensorboard=False)
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return cfg, str(path)


@pytest.fixture
def signal_handlers():
    """Restores SIGINT/SIGTERM after a test whose trainer installs its
    preemption handlers."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def test_cli_train_cpu_synthetic(tmp_path, capsys, signal_handlers):
    """``cli.train --cpu --synthetic``: FlowDROW with the fused frozen
    detector trains an epoch on the synthetic corpus, checkpoints and
    scores itself; ``--evaluation --ckpt`` re-scores the checkpoint."""
    cfg, path = _nested_cfg(tmp_path, fused_frozen_detector=True)
    syn = str(tmp_path / "syn")
    assert train_cli.main(["--cfg", path, "--synthetic", syn, "--cpu"]) == 0
    runs = os.listdir(tmp_path / "logs")
    run = next(r for r in runs if not r.startswith("sigterm"))
    ckpt = tmp_path / "logs" / run / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["ckpt_e1", "ckpt_final"]
    final = json.loads((tmp_path / "logs" / run / "output"
                        / "final_metrics.json").read_text())
    assert set(final) == {"epe", "aae"} and np.isfinite(float(final["epe"]))
    assert os.path.isfile(os.path.join(syn, "train", "synth_train_0.flow"))
    capsys.readouterr()
    assert train_cli.main(["--cfg", path, "--synthetic", syn, "--cpu",
                           "--evaluation", "--ckpt",
                           str(ckpt / "ckpt_final")]) == 0
    printed = capsys.readouterr().out
    assert f"{float(final['epe']):.4f}"[:5] in printed


def test_train_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, path = _nested_cfg(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--cfg", path])
    with pytest.raises(RuntimeError, match="cuda"):
        Pipeline(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(None, {}, None, install_signal_handlers=False)


def test_pipeline_mesh_names_its_item(tmp_path, corpus):
    """``pipeline.mesh`` in one process of one device: a data or pipe mesh
    of two cannot be built, so the pipeline falls back to no mesh with a
    warning, as JAX's does (``strict`` raises instead); a trainer given a
    mesh of several devices in one process refuses at its first step,
    naming ``torch.distributed.run`` (one process a device)."""
    from planar_optical_flow_tpu_torch.parallel import make_mesh

    cfg, _ = _nested_cfg(tmp_path, data_dir=corpus)
    for mesh in ({"data": 2}, {"pipe": 2}):
        cfg["pipeline"]["mesh"] = mesh
        pipe = Pipeline(cfg, device="cpu", install_signal_handlers=False)
        assert pipe.trainer._mesh is None
        cfg["pipeline"]["mesh"] = dict(mesh, strict=True)
        with pytest.raises(ValueError, match="strict"):
            Pipeline(cfg, device="cpu", install_signal_handlers=False)
    trainer = Trainer(None, {}, tasks.DetectionTask(),
                      mesh=make_mesh(devices=[torch.device("cpu")] * 2),
                      install_signal_handlers=False, device="cpu")
    with pytest.raises(ValueError, match="torch.distributed.run"):
        trainer._build_steps(None)


def test_batch_loader_order_matches_jax(corpus):
    """The same shuffle order, ``drop_last`` and tail wrap as JAX's
    ``BatchLoader``, epoch after epoch, with and without the prefetch
    thread."""
    ds = DrowDetectionDataset(corpus, "train", num_scans=NUM_SCANS,
                              device="cpu")
    for kw in (dict(batch_size=4, seed=3), dict(batch_size=4, seed=3,
                                                 drop_last=False),
               dict(batch_size=5, shuffle=False, drop_last=False,
                    prefetch=0)):
        ours, ref = BatchLoader(ds, **kw), JaxLoader(ds, **kw)
        assert len(ours) == len(ref)
        for _ in range(2):
            for a, b in zip(ours, ref, strict=True):
                assert a.keys() == b.keys()
                for k in a:
                    assert np.array_equal(a[k], b[k]), k


def test_prepare_split_matches_jax(tmp_path):
    """``.difodom`` and ``.flow`` files against the JAX package's."""
    from planar_optical_flow_tpu.data.prepare import (
        prepare_split as jax_prepare,
    )
    from planar_optical_flow_tpu_torch.data.prepare import prepare_split

    for which in ("port", "jax"):
        write_synthetic_drow_split(str(tmp_path / which), "train",
                                   num_sequences=1, num_frames=10,
                                   num_pts=NUM_PTS)
    stems = prepare_split(str(tmp_path / "port"), "train", verbose=False,
                          device="cpu")
    ref_stems = jax_prepare(str(tmp_path / "jax"), "train", verbose=False)
    for stem, ref in zip(stems, ref_stems, strict=True):
        for ext, atol in ((".difodom", 0.0), (".flow", 2e-8)):
            got = np.loadtxt(stem + ext, delimiter=",")
            want = np.loadtxt(ref + ext, delimiter=",")
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol,
                                       err_msg=ext)


def test_detection_task_encode_impls(corpus):
    """``encode_impl``: on CPU tensors "auto" and "xla" take the module
    cutout, as JAX takes XLA's on the CPU, and "pallas" K1's plain version;
    the two agree within the cutout kernel's bar; "pallas" on a geometry
    K1 does not cover raises. ``encoding="fc2d"`` builds and encodes the
    polar grid; an unknown encoding raises."""
    scans = torch.tensor(DrowDetectionDataset(
        corpus, "train", num_scans=NUM_SCANS, device="cpu").batch(
            np.arange(2))["scans"])
    out = {}
    for impl in ("auto", "xla", "pallas"):
        task = tasks.DetectionTask(
            cutout_kwargs=dict(CUTOUT_KW, encode_impl=impl), num_pts=NUM_PTS)
        out[impl] = task._encode(scans)
        assert out[impl].shape == (2, NUM_PTS, NUM_SCANS + 1, 16)
    assert torch.equal(out["auto"], out["xla"])
    torch.testing.assert_close(out["pallas"], out["xla"], rtol=0, atol=2e-3)
    with pytest.raises(ValueError, match="fixed=True"):
        tasks.DetectionTask(cutout_kwargs=dict(
            CUTOUT_KW, fixed=False, encode_impl="pallas"),
            num_pts=NUM_PTS)._encode(scans)
    fc2d = tasks.DetectionTask(cutout_kwargs=CUTOUT_KW, num_pts=NUM_PTS,
                               encoding="fc2d",
                               polar_grid_kwargs={"range_bin_size": 0.5})
    grid = fc2d._encode(scans)
    assert grid.shape == (2, NUM_SCANS + 1, 61, NUM_PTS)
    assert grid.dtype == torch.float32 and bool(torch.isfinite(grid).all())
    with pytest.raises(ValueError, match="encoding"):
        tasks.DetectionTask(encoding="polar")


def test_pipeline_grafts_a_detector_checkpoint(corpus, tmp_path):
    """``Pipeline.load_pretrained_detector``: a detection run's checkpoint
    (``dr-spaam``) becomes the FlowDROW model's ``dr_spaam`` submodule,
    weights and statistics; the flow head and the optimizer state stay."""
    det_cfg, _ = _nested_cfg(tmp_path / "det", network="cutout_gating",
                             data_dir=corpus, num_scans=NUM_SCANS)
    det = Pipeline(det_cfg, device="cpu", install_signal_handlers=False)
    with torch.no_grad():
        for p in det.model.parameters():
            p.add_(0.5)
    ckpt = det.save_ckpt("ckpt_det")
    flow_cfg, _ = _nested_cfg(tmp_path / "flow", data_dir=corpus,
                              num_scans=NUM_SCANS)
    flow_cfg["model"]["pretrained_detector"] = ckpt
    flow = Pipeline(flow_cfg, device="cpu", install_signal_handlers=False)
    for n, t in det.model.state_dict().items():
        assert torch.equal(flow.model.dr_spaam.state_dict()[n], t), n
    fresh = Pipeline(_nested_cfg(tmp_path / "fresh", data_dir=corpus,
                                 num_scans=NUM_SCANS)[0], device="cpu",
                     install_signal_handlers=False)
    for n, t in fresh.model.state_dict().items():
        if not n.startswith("dr_spaam."):
            assert torch.equal(flow.model.state_dict()[n], t), n
    assert flow.state.opt_state["count"] == 0


@pytest.mark.slow
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_training_converges(corpus, tmp_path, compute_dtype):
    """Thirty epochs over two batches of the synthetic corpus, for FlowDROW
    with the fused frozen detector and for the DR-SPAAM detector: the loss
    of the last epoch is below 0.8x the first's; the master weights and
    statistics stay f32."""
    from planar_optical_flow_tpu_torch.models import SpatialDrow

    g = torch.Generator().manual_seed(0)
    for model, task in (
            (FlowDrow(window_size=WINDOW, pedestrian_only=True,
                      num_cutout_pts=16, generator=g),
             tasks.FlowDrowFusedTask(alpha=0.5, window_size=WINDOW,
                                     **TASK_KW)),
            (SpatialDrow(window_size=WINDOW, pedestrian_only=True,
                         num_cutout_pts=16, generator=g),
             tasks.DetectionTask(**TASK_KW))):
        train, _, _ = _port_setup(corpus, model)
        batches = [b for _, b in zip(range(2), train)]
        state = create_train_state(model, make_optimizer(
            {"scheduler_kwargs": {"lr0": 3e-3, "lr1": 3e-3}}, 2))
        logger = RunLogger(_logger_cfg(tmp_path, type(model).__name__))
        trainer = Trainer(logger, {"epoch": 30, "ckpt_interval": 0,
                                   "eval_interval": 0,
                                   "compute_dtype": compute_dtype},
                          task, install_signal_handlers=False, device="cpu")
        state, rc = trainer.train(state, batches)
        assert rc == 0
        logger.flush()
        losses = np.reshape(_step_losses(logger), (30, 2)).mean(1)
        assert losses[-1] < 0.8 * losses[0], losses
        assert all(t.dtype == torch.float32
                   for t in state.model.state_dict().values()
                   if t.is_floating_point())
