"""Preemption-safe training loop.

Counterpart of ``planar_optical_flow_tpu/train/trainer.py`` ``Trainer``:

* a step is the task's forward and loss, the backward, the optimizer
  update (clip, AMSGrad, schedule) and the running-statistics update;
  under ``compute_dtype`` (``"bfloat16"``) the model computes in that dtype
  on f32 master parameters: the running statistics are handed in cast to
  it and the updated ones cast back to f32, every layer casts the f32
  parameters to its input's dtype (the gradients reach the f32 masters
  through the casts), and the loss runs in f32;
* SIGINT/SIGTERM (or :meth:`Trainer.request_stop`) set a flag; the loop
  drains, writes the sigterm checkpoint and returns rc 1; a resumed state
  restarts at its ``epoch``;
* periodic epoch checkpoints and evaluations; scalars ``TRAIN_step_ms``
  (host clock, the step until its loss is read back), ``TRAIN_lr``,
  ``TRAIN_loss``, ``TRAIN_epoch``, the task's other values and the global
  gradient and parameter norms;
* ``profile_steps: [start, stop]`` runs steps ``start`` .. ``stop - 1``
  (counted from 0 over the run) under ``torch.profiler`` (host, and the
  card's kernels on a card) and writes the Chrome trace to
  ``{run_dir}/profile/steps_{start}_{stop}.pt.trace.json`` when the window
  closes (or the run ends first); an empty tuple, the default, turns it
  off.

With a ``mesh`` (``parallel/mesh.py``; JAX's ``trainer.py:41-65,
133-257``), one process a device (``torch.distributed.run``):

* ``data``/``dcn`` axes: each rank takes its rows of the batch (the
  loader's slice when it was built with ``process_count`` > 1, else its
  block of the whole batch); BatchNorm and the losses run over the global
  batch (``parallel.comm.data_parallel``) and the gradients are summed
  over the data group once;
* ``model`` axis: the state is replicated except the leaves
  ``state_sharding_fn`` splits (``parallel.state_shardings``), which each
  rank holds as its shard during training (``parallel/
  tensor_parallel.py``); the state is whole again in checkpoints and when
  :meth:`Trainer.train` returns;
* ``pipe`` axis: the loss runs through the task's ``loss_pipelined``
  (GPipe, ``pp_microbatches`` microbatches) on the whole batch, whose
  backward sums the gradients over pipe and data itself; it cannot
  combine with ``dcn``, the task must have ``loss_pipelined``, and the
  axis must have the task's ``pp_num_stages``.

``grad_norm_clip`` and the logged norms are the global norms (a split
leaf's squares summed over ``model``). Only rank 0 logs and writes
checkpoints, the sigterm one included; every rank restores. JAX resolves
a task's ``encode_impl="auto"`` to XLA under a mesh because ``pallas_call``
has no SPMD rule; each rank here is a program of its own, so K1 runs on
its rows as without a mesh.
"""

from __future__ import annotations

import functools
import os
import signal
import time

import torch
import torch.distributed as dist

from planar_optical_flow_tpu_torch import resolve_device
from planar_optical_flow_tpu_torch.parallel import comm
from planar_optical_flow_tpu_torch.parallel.mesh import batch_sharding
from planar_optical_flow_tpu_torch.parallel.tensor_parallel import (
    shard_state_,
    split_names,
    unshard_state_,
)
from planar_optical_flow_tpu_torch.train import checkpoint as ckpt_lib
from planar_optical_flow_tpu_torch.train.state import set_stats

CONV_IMPLS = (None, "conv", "taps", "mm3")


def compute_dtype_of(name) -> torch.dtype | None:
    """The trainer's ``compute_dtype`` key -> torch dtype (None: f32)."""
    if name in (None, "float32", "f32"):
        return None
    return {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
            "float16": torch.float16}[str(name)]


def to_device(batch: dict, device) -> dict:
    """A numpy batch -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class Trainer:
    def __init__(self, logger, cfg: dict, task, lr_schedule=None, mesh=None,
                 state_sharding_fn=None, install_signal_handlers: bool = True,
                 seed: int = 0, device="cuda"):
        if cfg.get("conv_impl") not in CONV_IMPLS:
            raise ValueError(f"unknown conv impl {cfg.get('conv_impl')!r}")
        self._logger = logger
        self._task = task
        self._lr_schedule = lr_schedule
        self._device = resolve_device(device)
        self._mesh = mesh
        self._state_sharding_fn = state_sharding_fn
        self._specs = None       # name -> spec of a model-split state
        self._sharded = False
        self._pp_microbatches = cfg.get("pp_microbatches")
        self._loss_call = None
        self._main = mesh is None or mesh.is_main
        self._ckpt_interval = cfg.get("ckpt_interval", 5)
        self._eval_interval = cfg.get("eval_interval", 5)
        self._max_epoch = cfg.get("epoch", cfg.get("epochs", 1))
        self._log_norms = bool(cfg.get("log_norms", True))
        self._compute_dtype = compute_dtype_of(cfg.get("compute_dtype"))
        self._profile_steps = tuple(cfg.get("profile_steps") or ())
        self._profiler = None
        # the dropout masks' generator, on the device; each data shard
        # draws its own rows' masks
        shard = 0 if mesh is None else mesh.data_index
        self._rng = torch.Generator(device=self._device).manual_seed(
            seed if shard == 0 else seed * 1_000_003 + shard)
        self._sigterm = False
        if install_signal_handlers:
            signal.signal(signal.SIGINT, self._sigterm_cb)
            signal.signal(signal.SIGTERM, self._sigterm_cb)

    # ------------------------------------------------------------ plumbing

    def _sigterm_cb(self, signum, frame):
        self._sigterm = True
        self._logger.info(f"received signal {signum}; checkpointing soon")

    def request_stop(self):
        """Preempt from the program (fault-injection tests)."""
        self._sigterm = True

    # ---------------------------------------------------------------- mesh

    def _build_steps(self, state):
        """JAX's checks of the mesh, then the loss call (once) and the split
        leaves (once a state is given)."""
        if (self._specs is None and self._state_sharding_fn is not None
                and state is not None):
            self._specs = self._state_sharding_fn(self._mesh, state)
        if self._loss_call is not None:
            return
        mesh, task = self._mesh, self._task
        loss_call = task.loss
        if mesh is not None:
            pipe_n = mesh.axis_size("pipe")
            if pipe_n > 1:
                if mesh.axis_size("dcn") > 1:
                    raise ValueError(
                        "a dcn axis cannot combine with a pipe axis — the "
                        "pipeline wavefront does not span DCN (each dcn "
                        "group would redundantly run the same schedule); "
                        "use {dcn, data} or {data, pipe}")
                if not hasattr(task, "loss_pipelined"):
                    raise ValueError(
                        f"mesh has a pipe axis of {pipe_n} but task "
                        f"{type(task).__name__} has no loss_pipelined — use "
                        "a data/model mesh for this task")
                n_stages = getattr(task, "pp_num_stages", None)
                if n_stages is not None and pipe_n != n_stages:
                    raise ValueError(
                        f"mesh pipe axis is {pipe_n} but "
                        f"{type(task).__name__} stages its forward into "
                        f"{n_stages} pipeline stages — set pipeline.mesh: "
                        f"{{pipe: {n_stages}}}")
                loss_call = functools.partial(
                    task.loss_pipelined, mesh=mesh,
                    n_microbatches=self._pp_microbatches)
            if mesh.size > 1 and not mesh.multi_process:
                raise ValueError(
                    f"mesh {mesh.shape}: training across devices runs one "
                    "process a device — launch with torch.distributed.run "
                    "(parallel.initialize_distributed)")
        self._loss_call = loss_call

    @property
    def _data_split(self) -> bool:
        """Whether a batch's rows split over the data axes (no pipe axis:
        the pipeline takes the whole batch)."""
        m = self._mesh
        return (m is not None and m.multi_process and bool(m.data_axes)
                and m.axis_size("pipe") == 1)

    def _split_names(self) -> set:
        if not self._sharded:
            return set()
        return set(split_names(self._specs))

    def _shard(self, state):
        if self._specs and not self._sharded and split_names(self._specs):
            shard_state_(state, self._mesh, self._specs)
            self._sharded = True

    def _unshard(self, state):
        if self._sharded:
            unshard_state_(state, self._mesh, self._specs)
            self._sharded = False

    def _sq_norm(self, tensors: dict) -> torch.Tensor:
        """The global squared L2 norm of name -> tensor: a split leaf's
        squares summed over ``model``, a replicated leaf's counted once."""
        split = self._split_names()
        rep = sum((t.float() ** 2).sum() for n, t in tensors.items()
                  if t is not None and n not in split)
        if not split:
            return torch.as_tensor(rep)
        part = sum((t.float() ** 2).sum() for n, t in tensors.items()
                   if t is not None and n in split)
        part = torch.as_tensor(part, dtype=torch.float32,
                               device=self._device).reshape(1).clone()
        comm.all_reduce_([part], self._mesh.group("model"))
        return rep + part[0]

    def _place(self, batch, local: bool = False) -> dict:
        """A loader's numpy batch -> this rank's rows on its device: the
        batch as it is when it is already the rank's slice (``local``) or
        the rows do not split, else the rank's block of it."""
        if self._data_split and not local:
            n = len(next(iter(batch.values())))
            rows = batch_sharding(self._mesh).rows(n)
            batch = {k: v[rows] for k, v in batch.items()}
        return to_device(batch, self._device)

    def _is_local(self, loader) -> bool:
        """Whether ``loader`` yields this rank's slice of each batch."""
        count = getattr(loader, "process_count", 1)
        if count <= 1:
            return False
        if not self._data_split or count != self._mesh.data_extent:
            raise ValueError(
                f"the loader slices its batches over {count} processes but "
                f"the mesh {None if self._mesh is None else self._mesh.shape}"
                " splits them over "
                f"{self._mesh.data_extent if self._data_split else 1}")
        return True

    def _stop_agreed(self) -> bool:
        """The stop flag, agreed over every rank (one rank's signal stops
        them all at the same step)."""
        if self._mesh is None or not self._mesh.multi_process:
            return self._sigterm
        flag = torch.tensor([float(self._sigterm)], device=self._device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        self._sigterm = bool(flag.item())
        return self._sigterm

    def _save(self, path: str, state):
        """Rank 0 writes the whole state (gathered over ``model`` first)."""
        sharded = self._sharded
        self._unshard(state)
        if self._main:
            ckpt_lib.save_checkpoint(path, state)
        if sharded:
            self._shard(state)

    def _info(self, msg):
        if self._main:
            self._logger.info(msg)

    def _scalar(self, key, value, step):
        if self._main:
            self._logger.add_scalar(key, value, step)

    # ---------------------------------------------------------------- step

    def train_step(self, state, batch):
        """One step on a batch of device tensors (this rank's rows under a
        data mesh) -> (state, tb dict of f32 scalars on the device)."""
        self._build_steps(state)
        self._shard(state)
        model, cdt = state.model, self._compute_dtype
        master_stats = state.batch_stats
        if cdt is not None:
            set_stats(model, {n: t.to(cdt) for n, t in master_stats.items()})
        model.zero_grad(set_to_none=True)
        data_group = self._mesh.data_group if self._data_split else None
        try:
            with comm.data_parallel(data_group):
                loss, tb, _, new_stats = self._loss_call(model, batch, True,
                                                         self._rng)
                loss.float().backward()
        except BaseException:
            set_stats(model, master_stats)
            raise
        params = state.params
        grads = {n: p.grad for n, p in params.items()}
        # the rows' shares, summed once over the data group
        comm.all_reduce_(list(grads.values()), data_group)
        tb = {k: v.detach().float() for k, v in tb.items()}
        if self._log_norms:
            with torch.no_grad():
                gsq = self._sq_norm(grads)
                psq = self._sq_norm(params)
            tb["grad_norm"] = torch.sqrt(torch.as_tensor(gsq))
            tb["param_norm"] = torch.sqrt(psq)
        state.apply_gradients(grads, new_stats, sq_norm=(
            self._sq_norm if self._split_names() else None))
        model.zero_grad(set_to_none=True)
        return state, tb

    @torch.no_grad()
    def eval_step(self, state, batch) -> dict:
        """The task's metrics on a batch (this rank's rows under a data
        mesh: means over the global batch)."""
        self._build_steps(state)
        group = self._mesh.data_group if self._data_split else None
        with comm.data_parallel(group):
            metrics, _ = self._task.metrics(state.model, batch)
        if group is not None and comm.group_size(group) > 1:
            keys = list(metrics)
            vals = torch.stack([metrics[k].float() for k in keys])
            comm.all_reduce_([vals], group)
            vals = vals / comm.group_size(group)
            metrics = dict(zip(keys, vals))
        return metrics

    # ---------------------------------------------------------------- API

    def train(self, state, train_loader, eval_loader=None):
        """Run epochs ``state.epoch`` .. ``epoch - 1``. Returns (state, rc):
        rc 1 on preemption (the sigterm checkpoint written), else 0. The
        state comes back whole (not split over ``model``)."""
        self._build_steps(state)
        local = self._is_local(train_loader)
        self._shard(state)
        try:
            for epoch in range(int(state.epoch), self._max_epoch):
                if self._stop_agreed():
                    return self._preempt(state)
                t0 = time.time()
                n_batches = len(train_loader)
                epoch_loss, n_done = 0.0, 0
                for ib, batch in enumerate(train_loader):
                    if self._stop_agreed():
                        return self._preempt(state)
                    self._maybe_profile(int(state.step))
                    t_step = time.time()
                    state, tb = self.train_step(state,
                                                self._place(batch, local))
                    step = int(state.step)
                    loss = float(tb["loss"])  # waits: the step's host time
                    self._scalar("TRAIN_step_ms",
                                 (time.time() - t_step) * 1000.0, step)
                    epoch_loss += loss
                    n_done += 1
                    if self._lr_schedule is not None:
                        self._scalar("TRAIN_lr",
                                     float(self._lr_schedule(step)), step)
                    self._scalar("TRAIN_loss", loss, step)
                    self._scalar("TRAIN_epoch",
                                 epoch + ib / max(n_batches, 1), step)
                    for k, v in tb.items():
                        if k != "loss":
                            self._scalar(f"TRAIN_{k}", float(v), step)
                state.epoch = epoch + 1
                self._info(
                    f"epoch {epoch}: loss {epoch_loss / max(n_done, 1):.6f} "
                    f"({n_done} steps, {time.time() - t0:.1f}s)")
                if self._is_interval(epoch + 1, self._ckpt_interval):
                    self._save(f"{self._logger.ckpt_dir}/ckpt_e{epoch + 1}",
                               state)
                    self._info(f"checkpoint ckpt_e{epoch + 1} saved")
                if eval_loader is not None and self._is_interval(
                        epoch + 1, self._eval_interval):
                    self.evaluate(state, eval_loader, tb_prefix="VAL")
                if self._main:
                    self._logger.flush()
            self._stop_profile()
            return state, 0
        finally:
            self._unshard(state)

    def evaluate(self, state, eval_loader, tb_prefix="VAL") -> dict:
        """Each metric's mean over the loader's batches."""
        self._build_steps(state)
        local = self._is_local(eval_loader)
        was_sharded = self._sharded
        self._shard(state)
        sums, n = {}, 0
        try:
            for batch in eval_loader:
                if self._sigterm:
                    break
                metrics = self.eval_step(state, self._place(batch, local))
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
                n += 1
        finally:
            if not was_sharded:
                self._unshard(state)
        means = {k: v / max(n, 1) for k, v in sums.items()}
        for k, v in means.items():
            self._scalar(f"{tb_prefix}_{k}", v, int(state.step))
            self._info(f"{tb_prefix} {k}: {v:.6f}")
        return means

    def _maybe_profile(self, step: int):
        """Start or stop the ``profile_steps`` window before ``step`` (rank
        0 only)."""
        if not self._profile_steps or not self._main:
            return
        start, stop = self._profile_steps
        if step == start:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self._device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()
            self._logger.info(f"profiler trace started at step {step} -> "
                              f"{self._logger.run_dir}/profile")
        elif step == stop:
            self._stop_profile()

    def _stop_profile(self):
        """Close an open ``profile_steps`` window and write its trace."""
        if self._profiler is None:
            return
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self._profiler.stop()
        start, stop = self._profile_steps
        trace_dir = os.path.join(self._logger.run_dir, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"steps_{start}_{stop}.pt.trace.json")
        self._profiler.export_chrome_trace(path)
        self._profiler, self._profile_steps = None, ()
        self._logger.info(f"profiler trace stopped -> {path}")

    def _preempt(self, state):
        self._stop_profile()
        self._save(self._logger.sigterm_ckpt, state)
        self._info(f"sigterm checkpoint saved: {self._logger.sigterm_ckpt}")
        return state, 1

    @staticmethod
    def _is_interval(epoch, interval):
        return interval > 0 and epoch % interval == 0

