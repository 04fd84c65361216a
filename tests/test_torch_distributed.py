"""The port's multi-process entry points on the CPU over Gloo.

Tier 1:

* the ``parallel`` modules import without JAX;
* ``initialize_distributed`` is a no-op for one process;
* the trainer's mesh checks (JAX's ``ValueError``s: dcn with pipe, a task
  without ``loss_pipelined``, a pipe axis that is not the task's stage
  count; an in-process mesh of several devices), and a mesh keeping the
  task's encode (each rank runs K1 on its rows, where JAX resolves
  ``encode_impl="auto"`` to XLA because ``pallas_call`` has no SPMD rule);
* ``cli.train`` under ``torch.distributed.run`` in a world of one with
  ``pipeline.mesh: {data: 1}``: losses and weights equal to the bit to the
  run without a mesh.

Slow (``-m slow``): four ranks on ``{data: 2, pipe: 2}`` and on ``{dcn: 2,
data: 2}`` against JAX's trainer on the same meshes (losses 1e-5 relative,
parameters and statistics 1e-3 relative L2, at lr 1e-5 as in
``tests/test_torch_parallel.py``), and ``cli.train`` over two Gloo ranks
against the single-process run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from planar_optical_flow_tpu_torch import parallel
from tests._torch_dist_worker import Ranks
from tests.test_torch_common import REPO

STATS = ("running_mean", "running_var")


def test_parallel_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['planar_optical_flow_tpu'] = None\n"
        "import planar_optical_flow_tpu_torch.parallel\n"
        "import planar_optical_flow_tpu_torch.parallel.tensor_parallel\n"
        "import planar_optical_flow_tpu_torch.parallel.comm\n"
        "import planar_optical_flow_tpu_torch.train.trainer\n"
        "import planar_optical_flow_tpu_torch.pipeline\n"
        "import tests._torch_dist_worker\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'flax', "
        "'planar_optical_flow_tpu.')) and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_initialize_distributed_one_process(monkeypatch):
    import torch.distributed as dist

    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.initialize_distributed(device="cpu") == torch.device(
        "cpu")
    assert parallel.initialize_distributed(
        "localhost:1", num_processes=1, process_id=0, device="cpu"
    ) == torch.device("cpu")
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        parallel.initialize_distributed()


def _trainer(mesh_cfg, task, tmp_path, n=8):
    from planar_optical_flow_tpu_torch.train import Trainer
    from planar_optical_flow_tpu_torch.utils.logger import RunLogger

    logger = RunLogger({"log_dir": str(tmp_path), "tag": "t",
                        "console": False, "tensorboard": False})
    mesh = parallel.make_mesh_from_config(mesh_cfg, devices=list(range(n)))
    return Trainer(logger, {"epoch": 1}, task, mesh=mesh,
                   install_signal_handlers=False, device="cpu")


def test_trainer_mesh_checks(tmp_path):
    """JAX's configuration errors, raised before any collective."""
    from planar_optical_flow_tpu_torch.train import tasks

    det = tasks.DetectionTask()
    with pytest.raises(ValueError, match="dcn axis cannot combine"):
        _trainer({"dcn": 2, "pipe": 2}, det, tmp_path)._build_steps(None)
    with pytest.raises(ValueError, match="no loss_pipelined"):
        _trainer({"pipe": 2}, tasks.FlowUNetTask(),
                 tmp_path)._build_steps(None)
    with pytest.raises(ValueError, match="2 pipeline stages"):
        _trainer({"pipe": 4}, det, tmp_path)._build_steps(None)
    with pytest.raises(ValueError, match="torch.distributed.run"):
        _trainer({"data": 2}, det, tmp_path)._build_steps(None)
    # a mesh of one position trains in this process
    _trainer({"data": 1}, det, tmp_path, n=1)._build_steps(None)


def test_trainer_mesh_keeps_the_kernel_encode(tmp_path):
    """Under a mesh the task is left as it is: ``encode_impl="auto"`` keeps
    K1 on the card on each rank's rows (JAX resolves it to XLA, since
    ``pallas_call`` has no SPMD rule; each rank here is a program of its
    own)."""
    from planar_optical_flow_tpu_torch.train import tasks

    auto = tasks.DetectionTask(cutout_kwargs={"fixed": True,
                                              "encode_impl": "auto"})
    tr = _trainer({"data": 8}, auto, tmp_path)
    assert tr._task is auto
    assert tr._task.cutout_kwargs["encode_impl"] == "auto"


# ----------------------------------------------------- cli.train launched

CT = 8


def _write_cfg(path, data_dir, log_dir, mesh=None, tag="run", lr=1e-3,
               epochs=1):
    cfg = {"batch_size": 4, "epochs": epochs, "num_scans": 2,
           "pedestrian_only": True, "data_dir": data_dir,
           "log_dir": log_dir, "network": "cutout", "name": tag,
           "ckpt_interval": 0, "eval_interval": 0, "mesh": mesh,
           "cutout_kwargs": dict(fixed=True, centered=True,
                                 window_width=1.0, window_depth=0.5,
                                 num_cutout_pts=CT, padding_val=29.99,
                                 area_mode=False),
           "scheduler_kwargs": {"epoch0": 0, "lr0": lr, "epoch1": 1,
                                "lr1": lr / 10}}
    from planar_optical_flow_tpu_torch.pipeline import normalize_config

    cfg = normalize_config(cfg)  # nested: the logger's keys are reachable
    cfg["pipeline"]["Logger"].update(console=False, tensorboard=False)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


@pytest.fixture(scope="module")
def small_corpus(tmp_path_factory):
    from planar_optical_flow_tpu_torch.data import write_synthetic_drow_split

    root = str(tmp_path_factory.mktemp("dist_corpus"))
    write_synthetic_drow_split(root, "train", num_sequences=1,
                               num_frames=14, num_pts=64)
    write_synthetic_drow_split(root, "val", num_sequences=1, num_frames=8,
                               num_pts=64, seed=9)
    return root


def _launch(nproc, cfg, timeout=300):
    """``cli.train --cfg cfg --cpu`` under ``torch.distributed.run`` on
    ``nproc`` Gloo ranks of this machine."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={nproc}", "-m",
         "planar_optical_flow_tpu_torch.cli.train", "--cfg", cfg, "--cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]


def _run_of(log_dir, tag):
    """(TRAIN_loss values, final weights) of the run ``tag``."""
    (run,) = [d for d in os.listdir(log_dir) if d.endswith("_" + tag)]
    run = os.path.join(log_dir, run)
    with open(os.path.join(run, "tb", "scalars.jsonl")) as f:
        losses = [r["value"] for r in map(json.loads, f)
                  if r["key"] == "TRAIN_loss"]
    weights = torch.load(os.path.join(run, "ckpt", "ckpt_final",
                                      "weights.pt"), weights_only=True)
    return losses, weights, run


def _plain_run(cfg):
    from planar_optical_flow_tpu_torch.cli import train as train_cli

    torch.set_num_threads(1)
    assert train_cli.main(["--cfg", cfg, "--cpu"]) == 0


def test_cli_train_world_of_one_equals_no_mesh(small_corpus, tmp_path):
    """A world of one under ``torch.distributed.run`` with ``pipeline.mesh:
    {data: 1}`` (the gradients all-reduced over a group of one) trains to
    the bit of the plain run, and writes one run directory."""
    logs = str(tmp_path / "logs")
    _launch(1, _write_cfg(tmp_path / "mesh.json", small_corpus, logs,
                          mesh={"data": 1}, tag="mesh"))
    n = torch.get_num_threads()
    try:
        _plain_run(_write_cfg(tmp_path / "plain.json", small_corpus, logs,
                              tag="plain"))
    finally:
        torch.set_num_threads(n)
    got, got_w, run = _run_of(logs, "mesh")
    want, want_w, _ = _run_of(logs, "plain")
    assert got == want and len(got) == 3
    assert set(got_w) == set(want_w)
    for k, v in want_w.items():
        assert torch.equal(got_w[k], v), k
    assert os.path.isfile(os.path.join(run, "output",
                                       "final_metrics.json"))


# ------------------------------------------------------------------ slow


@pytest.mark.slow
def test_cli_train_two_ranks_matches_one_process(small_corpus, tmp_path):
    """``cli.train`` over two Gloo ranks (``pipeline.mesh: {data: 2}``, each
    rank reading its rows) against the single-process run: the same
    losses (1e-5 relative at lr 1e-5) and weights (1e-3 relative L2); one
    run directory, rank 0's log and rank 1's own log file in it."""
    logs = str(tmp_path / "logs")
    _launch(2, _write_cfg(tmp_path / "dp.json", small_corpus, logs,
                          mesh={"data": 2}, tag="dp", lr=1e-5))
    _plain_run(_write_cfg(tmp_path / "one.json", small_corpus, logs,
                          tag="one", lr=1e-5))
    got, got_w, run = _run_of(logs, "dp")
    want, want_w, _ = _run_of(logs, "one")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    names = [k for k in want_w if not k.endswith("num_batches_tracked")]
    g = np.concatenate([got_w[k].numpy().ravel() for k in names])
    w = np.concatenate([want_w[k].numpy().ravel() for k in names])
    assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 1e-3
    assert os.path.isfile(os.path.join(run, "log_rank1.txt"))


def _four_rank_case(mesh_cfg, tmp_path, kind):
    from planar_optical_flow_tpu.train import tasks as jax_tasks
    from planar_optical_flow_tpu_torch.interop import variables_to_state_dict
    from tests.test_torch_parallel import (
        DET_TASK,
        OPT_CFG,
        _assert_train_close,
        _det_batches,
        _jax_train,
        model_pair,
    )
    from tests.test_torch_common import CT_LEN, NUM_PTS, WINDOW

    import jax.numpy as jnp

    jm, v_np, port = model_pair(kind)
    spec = (("Drow", dict(pedestrian_only=True)) if kind == "drow" else
            ("SpatialDrow", dict(window_size=WINDOW, pedestrian_only=True,
                                 num_cutout_pts=CT_LEN))) + (
        port.state_dict(),)
    batches = _det_batches()
    trainer_cfg = {"pp_microbatches": 2} if "pipe" in mesh_cfg else {}
    spawned = Ranks([{"key": "t", "kind": "train",
                      "args": dict(model=spec,
                                   task=("DetectionTask", DET_TASK),
                                   batches=batches, mesh=mesh_cfg,
                                   opt_cfg=OPT_CFG,
                                   trainer_cfg=trainer_cfg)}], 4, tmp_path)
    jax_task = jax_tasks.DetectionTask(**DET_TASK)
    losses, v = _jax_train(jm, v_np, (jnp.zeros((1, NUM_PTS, 3, CT_LEN)),),
                           jax_task, batches, mesh_cfg, tmp_path=tmp_path,
                           trainer_cfg=trainer_cfg)
    ref = {n: t.numpy() for n, t in variables_to_state_dict(v, port).items()}
    for r, res in enumerate(spawned.results()):
        _assert_train_close(res["t"], losses, ref, f"{mesh_cfg} rank {r}")


@pytest.mark.slow
def test_data_pipe_four_ranks_match_jax(tmp_path):
    """``{data: 2, pipe: 2}``: each microbatch's rows over data, ghost-batch
    BN chains averaged over the data shards, against JAX's trainer."""
    _four_rank_case({"data": 2, "pipe": 2}, tmp_path, "drow")


@pytest.mark.slow
def test_dcn_data_four_ranks_match_jax(tmp_path):
    """``{dcn: 2, data: 2}``: the batch over (dcn, data) jointly, the
    gradient sum over the joint group, against JAX's trainer."""
    _four_rank_case({"dcn": 2, "data": 2}, tmp_path, "dr-spaam")
