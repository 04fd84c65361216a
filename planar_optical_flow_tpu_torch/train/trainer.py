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
  gradient and parameter norms.

There is one device and no mesh: a mesh raises, naming ROADMAP item 20.
"""

from __future__ import annotations

import signal
import time

import torch

from planar_optical_flow_tpu_torch import resolve_device
from planar_optical_flow_tpu_torch.train import checkpoint as ckpt_lib
from planar_optical_flow_tpu_torch.train.state import set_stats

CONV_IMPLS = (None, "conv", "taps", "mm3")


def no_mesh(what: str):
    return NotImplementedError(
        f"{what}: the port trains on one device; meshes (data, model and "
        "pipe axes) are ROADMAP.md queue 1 item 20")


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
        if mesh is not None or state_sharding_fn is not None:
            raise no_mesh("Trainer(mesh=...)")
        if cfg.get("conv_impl") not in CONV_IMPLS:
            raise ValueError(f"unknown conv impl {cfg.get('conv_impl')!r}")
        self._logger = logger
        self._task = task
        self._lr_schedule = lr_schedule
        self._device = resolve_device(device)
        self._ckpt_interval = cfg.get("ckpt_interval", 5)
        self._eval_interval = cfg.get("eval_interval", 5)
        self._max_epoch = cfg.get("epoch", cfg.get("epochs", 1))
        self._log_norms = bool(cfg.get("log_norms", True))
        self._compute_dtype = compute_dtype_of(cfg.get("compute_dtype"))
        # the dropout masks' generator, on the device
        self._rng = torch.Generator(device=self._device).manual_seed(seed)
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

    def train_step(self, state, batch):
        """One step on a batch of device tensors -> (state, tb dict of f32
        scalars on the device)."""
        model, cdt = state.model, self._compute_dtype
        master_stats = state.batch_stats
        if cdt is not None:
            set_stats(model, {n: t.to(cdt) for n, t in master_stats.items()})
        model.zero_grad(set_to_none=True)
        try:
            loss, tb, _, new_stats = self._task.loss(model, batch, True,
                                                     self._rng)
            loss.float().backward()
        except BaseException:
            set_stats(model, master_stats)
            raise
        params = state.params
        grads = {n: p.grad for n, p in params.items()}
        tb = {k: v.detach().float() for k, v in tb.items()}
        if self._log_norms:
            with torch.no_grad():
                gsq = sum((g.float() ** 2).sum() for g in grads.values()
                          if g is not None)
                psq = sum((p.float() ** 2).sum() for p in params.values())
            tb["grad_norm"] = torch.sqrt(torch.as_tensor(gsq))
            tb["param_norm"] = torch.sqrt(psq)
        state.apply_gradients(grads, new_stats)
        model.zero_grad(set_to_none=True)
        return state, tb

    @torch.no_grad()
    def eval_step(self, state, batch) -> dict:
        metrics, _ = self._task.metrics(state.model, batch)
        return metrics

    # ---------------------------------------------------------------- API

    def train(self, state, train_loader, eval_loader=None):
        """Run epochs ``state.epoch`` .. ``epoch - 1``. Returns (state, rc):
        rc 1 on preemption (the sigterm checkpoint written), else 0."""
        for epoch in range(int(state.epoch), self._max_epoch):
            if self._sigterm:
                return self._preempt(state)
            t0 = time.time()
            n_batches = len(train_loader)
            epoch_loss, n_done = 0.0, 0
            for ib, batch in enumerate(train_loader):
                if self._sigterm:
                    return self._preempt(state)
                t_step = time.time()
                state, tb = self.train_step(
                    state, to_device(batch, self._device))
                step = int(state.step)
                loss = float(tb["loss"])  # waits: the step's host time
                self._logger.add_scalar(
                    "TRAIN_step_ms", (time.time() - t_step) * 1000.0, step)
                epoch_loss += loss
                n_done += 1
                if self._lr_schedule is not None:
                    self._logger.add_scalar(
                        "TRAIN_lr", float(self._lr_schedule(step)), step)
                self._logger.add_scalar("TRAIN_loss", loss, step)
                self._logger.add_scalar(
                    "TRAIN_epoch", epoch + ib / max(n_batches, 1), step)
                for k, v in tb.items():
                    if k != "loss":
                        self._logger.add_scalar(f"TRAIN_{k}", float(v), step)
            state.epoch = epoch + 1
            self._logger.info(
                f"epoch {epoch}: loss {epoch_loss / max(n_done, 1):.6f} "
                f"({n_done} steps, {time.time() - t0:.1f}s)")
            if self._is_interval(epoch + 1, self._ckpt_interval):
                ckpt_lib.save_checkpoint(
                    f"{self._logger.ckpt_dir}/ckpt_e{epoch + 1}", state)
                self._logger.info(f"checkpoint ckpt_e{epoch + 1} saved")
            if eval_loader is not None and self._is_interval(
                    epoch + 1, self._eval_interval):
                self.evaluate(state, eval_loader, tb_prefix="VAL")
            self._logger.flush()
        return state, 0

    def evaluate(self, state, eval_loader, tb_prefix="VAL") -> dict:
        """Each metric's mean over the loader's batches."""
        sums, n = {}, 0
        for batch in eval_loader:
            if self._sigterm:
                break
            metrics = self.eval_step(state, to_device(batch, self._device))
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        means = {k: v / max(n, 1) for k, v in sums.items()}
        for k, v in means.items():
            self._logger.add_scalar(f"{tb_prefix}_{k}", v, int(state.step))
            self._logger.info(f"{tb_prefix} {k}: {v:.6f}")
        return means

    def _preempt(self, state):
        ckpt_lib.save_checkpoint(self._logger.sigterm_ckpt, state)
        self._logger.info(
            f"sigterm checkpoint saved: {self._logger.sigterm_ckpt}")
        return state, 1

    @staticmethod
    def _is_interval(epoch, interval):
        return interval > 0 and epoch % interval == 0

