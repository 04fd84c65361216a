"""A rank of a multi-process test of the port's ``parallel`` package.

Imports torch and the port only. :class:`Ranks` starts ``world``
processes of this module on the CPU; each joins a Gloo group through a
``FileStore`` in the test's temporary directory (no ports to collide), runs
one intra-op thread, runs the jobs of a file in order and saves its
results::

    python -m tests._torch_dist_worker RANK WORLD STORE JOBS OUT_DIR

A job is ``{"key", "kind", "args"}``; :data:`JOBS` maps each kind to its
function. Inputs and results are numpy arrays, tensors and plain
containers (``torch.save``).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- harness


class Ranks:
    """``world`` rank processes started on ``jobs``; :meth:`results` waits
    for them."""

    def __init__(self, jobs, world: int, tmp_path):
        tmp = Path(tmp_path)
        self.dir = tmp / f"dist_{len(list(tmp.glob('dist_*')))}"
        self.dir.mkdir(parents=True)
        job_path = self.dir / "jobs.pt"
        torch.save(jobs, job_path)
        env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
        for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT"):
            env.pop(k, None)
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tests._torch_dist_worker", str(r),
             str(world), str(self.dir / "store"), str(job_path),
             str(self.dir)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def results(self, timeout: float = 240.0) -> list:
        """Each rank's results dict (key -> result). Raises with the ranks'
        output if one fails."""
        logs = []
        try:
            for p in self.procs:
                out, _ = p.communicate(timeout=timeout)
                logs.append(out)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            raise AssertionError("ranks %s failed:\n%s" % (bad, "\n".join(
                f"--- rank {r} ---\n{log[-6000:]}" for r, log in
                enumerate(logs))))
        return [torch.load(self.dir / f"rank{r}.pt", weights_only=False)
                for r in range(len(self.procs))]


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, job_path, out_dir = sys.argv[3], sys.argv[4], Path(sys.argv[5])
    torch.set_num_threads(1)
    import torch.distributed as dist

    from planar_optical_flow_tpu_torch.parallel import initialize_distributed

    initialize_distributed(coordinator=f"file://{store}",
                           num_processes=world, process_id=rank,
                           device="cpu")
    jobs = torch.load(job_path, weights_only=False)
    results = {}
    for job in jobs:
        results[job["key"]] = JOBS[job["kind"]](out_dir=out_dir,
                                                **job["args"])
    torch.save(results, out_dir / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------------- jobs


def _np(t):
    return t.detach().float().cpu().numpy()


def build_model(spec):
    """``(class name in planar_optical_flow_tpu_torch.models, kwargs,
    state_dict)`` -> the port model with those weights, or a
    ``("registry", cfg, state_dict)`` through ``get_model``."""
    from planar_optical_flow_tpu_torch import models

    kind, kwargs, state = spec
    if kind == "registry":
        model = models.get_model(kwargs)
    else:
        kwargs = dict(kwargs, generator=torch.Generator().manual_seed(0))
        model = getattr(models, kind)(**kwargs)
    model.load_state_dict(state)
    return model


def _task(spec):
    from planar_optical_flow_tpu_torch.train import tasks

    kind, kwargs = spec
    return getattr(tasks, kind)(**kwargs)


def train(out_dir, model, task, batches, mesh, opt_cfg, sharded=False,
          trainer_cfg=None, rank_tag=""):
    """Steps of the port's Trainer on ``mesh`` (None: no mesh) over the
    global ``batches``; returns the losses, the tb dicts, the whole final
    state dict, the split leaves' names and the loss of ``evaluate``."""
    import torch.distributed as dist

    from planar_optical_flow_tpu_torch.parallel import (
        make_mesh_from_config,
        state_shardings,
    )
    from planar_optical_flow_tpu_torch.train import (
        Trainer,
        create_train_state,
        make_optimizer,
    )
    from planar_optical_flow_tpu_torch.utils.logger import RunLogger

    port = build_model(model)
    state = create_train_state(port, make_optimizer(opt_cfg, len(batches)))
    m = make_mesh_from_config(mesh) if mesh is not None else None
    logger = RunLogger({"log_dir": str(out_dir / f"logs{rank_tag}_"
                                       f"{dist.get_rank()}"),
                        "tag": "t", "console": False, "tensorboard": False})
    trainer = Trainer(logger, dict(trainer_cfg or {}), _task(task), mesh=m,
                      state_sharding_fn=state_shardings if sharded else None,
                      install_signal_handlers=False, device="cpu")
    losses, tbs = [], []
    for b in batches:
        state, tb = trainer.train_step(state, trainer._place(b))
        losses.append(float(tb["loss"]))
        tbs.append({k: float(v) for k, v in tb.items()})
    split = sorted(trainer._split_names())
    shard_shapes = {n: tuple(t.shape) for n, t in
                    port.state_dict().items() if n in split}
    metrics = trainer.eval_step(state, trainer._place(batches[0]))
    trainer._unshard(state)
    return {"losses": losses, "tb": tbs, "split": split,
            "shard_shapes": shard_shapes,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "state": {n: _np(t) for n, t in port.state_dict().items()
                      if not n.endswith("num_batches_tracked")}}


def _mlp_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def mlp(out_dir, params, x, t, n_micro, mesh):
    """pipeline_apply of dense stages: the output and the gradients of
    ``mean((y - t)^2)``."""
    from planar_optical_flow_tpu_torch.parallel import (
        make_mesh_from_config,
        pipeline_apply,
    )

    ps = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
          for p in params]
    y = pipeline_apply([_mlp_stage] * len(ps), ps, torch.tensor(x),
                       make_mesh_from_config(mesh), n_microbatches=n_micro)
    loss = ((y - torch.tensor(t)) ** 2).mean()
    loss.backward()
    return {"y": _np(y), "loss": float(loss),
            "grads": [{k: _np(v.grad) for k, v in p.items()} for p in ps]}


def pytree(out_dir, w, x, mesh):
    """Stages exchanging tuple and dict activations."""
    from planar_optical_flow_tpu_torch.parallel import (
        make_mesh_from_config,
        pipeline_apply,
    )

    def s0(p, xx):
        return (xx @ p, xx[:, :2])

    def s1(p, xs):
        a, b = xs
        return {"y": a * p, "z": b}

    got = pipeline_apply([s0, s1], [torch.tensor(w), torch.tensor(2.0)],
                         torch.tensor(x), make_mesh_from_config(mesh))
    return {k: _np(v) for k, v in got.items()}


def state_chain(out_dir, x, mesh, n_micro):
    """Stage states threaded through the microbatches in order."""
    from planar_optical_flow_tpu_torch.parallel import (
        make_mesh_from_config,
        pipeline_apply,
    )

    def s0(p, s, xx):
        cnt, acc = s
        return xx * p, (cnt + 1, 0.5 * acc + xx.sum())

    def s1(p, s, xx):
        cnt, acc = s
        return xx + p, (cnt + 1, 0.5 * acc + xx.sum())

    zero = (torch.tensor(0), torch.tensor(0.0))
    out, states = pipeline_apply(
        [s0, s1], [torch.tensor(2.0), torch.tensor(1.0)], torch.tensor(x),
        make_mesh_from_config(mesh), n_microbatches=n_micro,
        stage_state=[zero, zero])
    return {"y": _np(out),
            "states": [(int(c), float(a), str(c.dtype)) for c, a in states]}


def loss_pipelined(out_dir, model, task, batch, mesh, n_micro):
    """``DetectionTask.loss_pipelined`` in train mode: the loss and tb, the
    predictions, the new statistics and the parameters' gradients."""
    from planar_optical_flow_tpu_torch.parallel import make_mesh_from_config
    from planar_optical_flow_tpu_torch.train.trainer import to_device

    port = build_model(model)
    t = _task(task)
    loss, tb, out, stats = t.loss_pipelined(
        port, to_device(batch, "cpu"), True, mesh=make_mesh_from_config(mesh),
        n_microbatches=n_micro)
    loss.backward()
    return {"loss": float(loss), "tb": {k: float(v) for k, v in tb.items()},
            "pred_cls": _np(out["pred_cls"]),
            "stats": {n: _np(v) for n, v in stats.items()},
            "grads": {n: _np(p.grad) for n, p in port.named_parameters()}}


def flow_stages(out_dir, model, pair, mesh, n_micro):
    """The flow U-Net staged encoder | decoder in train mode: the flow and
    the gradients of its mean square."""
    from planar_optical_flow_tpu_torch.parallel import (
        flow_unet_pipeline_stages,
        make_mesh_from_config,
        pipeline_apply,
    )

    port = build_model(model)
    fns, params = flow_unet_pipeline_stages(port, train=True)
    y = pipeline_apply(fns, params, (torch.tensor(pair[0]),
                                     torch.tensor(pair[1])),
                       make_mesh_from_config(mesh), n_microbatches=n_micro)
    (y ** 2).mean().backward()
    return {"y": _np(y),
            "grads": {n: _np(p.grad) for n, p in port.named_parameters()}}


def cp_gate(out_dir, w, b, alpha, window, x, template, mesh):
    """``gate_step_context_parallel``: this rank's blocks."""
    from planar_optical_flow_tpu_torch.infer.fast_gate import (
        GateParams,
        embed,
    )
    from planar_optical_flow_tpu_torch.parallel import (
        gate_step_context_parallel,
        make_mesh_from_config,
    )

    params = GateParams(w=torch.tensor(w), b=torch.tensor(b), alpha=alpha,
                        window_size=window)
    xt, tt = torch.tensor(x), torch.tensor(template)
    z_t = embed(params, tt)
    got = gate_step_context_parallel(params, xt, tt, z_t,
                                     make_mesh_from_config(mesh))
    return [_np(g) for g in got]


def serve_rank(out_dir, model, cutout_kwargs, num_pts, scans, calib_scans,
               mesh, kwargs):
    """The sharded serving step across processes: this rank's carries and
    outputs over the scans."""
    from planar_optical_flow_tpu_torch.infer.streaming import (
        make_serve_step_v3,
    )
    from planar_optical_flow_tpu_torch.parallel import make_mesh_from_config

    port = build_model(model)
    step = make_serve_step_v3(port, cutout_kwargs, num_pts=num_pts,
                              calib_scans=calib_scans,
                              mesh=make_mesh_from_config(mesh), **kwargs)
    carry, outs = None, []
    for s in scans:
        carry, out = step(carry, s)
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
    return {"template": carry["template"].cpu().numpy(), "outs": outs}


JOBS = {"train": train, "mlp": mlp, "pytree": pytree,
        "state_chain": state_chain, "loss_pipelined": loss_pipelined,
        "flow_stages": flow_stages, "cp_gate": cp_gate,
        "serve_rank": serve_rank}


if __name__ == "__main__":
    main()
