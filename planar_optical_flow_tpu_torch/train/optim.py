"""Optimizers and learning-rate schedules.

Counterpart of ``planar_optical_flow_tpu/train/optim.py``: the reference's
geometric-decay schedule stepped per iteration with a fractional epoch
(:func:`exp_decay_schedule`), and Adam with AMSGrad, optionally behind
global-norm gradient clipping, with frozen parameters left alone
(:func:`make_optimizer`).

The step is optax's, written out (:class:`Optimizer`), not
``torch.optim.Adam(amsgrad=True)``: optax's ``scale_by_amsgrad`` keeps the
running maximum of the *bias-corrected* second moment, ``nu_max =
max(nu_max, nu / (1 - b2^t))``, and steps ``mu_hat / (sqrt(nu_max) +
eps)``, where torch keeps the maximum of the raw second moment and
corrects it afterwards; the two differ as soon as the second moment
falls. The learning rate of update k (counted from 0) is ``schedule(k)``,
as optax's ``scale_by_schedule`` counts. Everything runs in f32, as the
f32 master parameters do.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def exp_decay_schedule(epoch0: float, lr0: float, epoch1: float, lr1: float,
                       steps_per_epoch: int) -> Callable[[int], float]:
    """Per-step schedule: ``lr0`` until ``epoch0``, geometric decay to
    ``lr1`` at ``epoch1``, ``lr1`` after, at the fractional epoch ``step /
    steps_per_epoch``; in f32, as JAX computes it on an int32 step."""
    f32 = np.float32
    span = f32(max(epoch1 - epoch0, 1e-9))

    def schedule(step) -> float:
        epoch = f32(step) / f32(steps_per_epoch)
        frac = np.clip((epoch - f32(epoch0)) / span, f32(0.0), f32(1.0))
        return float(f32(lr0) * f32(lr1 / lr0) ** f32(frac))

    return schedule


class Optimizer:
    """optax's chain ``[clip_by_global_norm(clip)] -> scale_by_amsgrad`` (or
    ``scale_by_adam``) ``-> scale_by_schedule(-lr)``, applied to named f32
    parameters in place. ``trainable(name)`` False freezes a parameter
    (optax ``set_to_zero`` through ``multi_transform``: no state, no update,
    and its gradient is not in the clip's norm). A parameter that receives
    no gradient (``None``, e.g. a frozen detector run without autograd)
    takes a zero gradient, as JAX's stopped gradient is: with a zero state
    its update is exactly 0."""

    def __init__(self, schedule: Callable[[int], float], amsgrad: bool = True,
                 grad_norm_clip: float = 0.0,
                 trainable: Callable[[str], bool] | None = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.amsgrad = amsgrad
        self.grad_norm_clip = grad_norm_clip or 0.0
        self.trainable = trainable or (lambda name: True)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: dict) -> dict:
        """Optimizer state for ``params`` (name -> tensor): the update count
        and, for each trainable parameter, zero moments."""
        names = [n for n in params if self.trainable(n)]
        keys = ("mu", "nu", "nu_max") if self.amsgrad else ("mu", "nu")
        state = {"count": 0}
        for key in keys:
            state[key] = {n: torch.zeros_like(params[n], dtype=torch.float32)
                          for n in names}
        return state

    def _clip(self, grads: dict, sq_norm=None) -> dict:
        """optax ``clip_by_global_norm``: unchanged below the bound, else
        ``(g / norm) * bound``; ``sq_norm(grads)``, where given, is the
        squared global norm (a mesh's)."""
        clip = self.grad_norm_clip
        if clip <= 0 or not grads:
            return grads
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values())
                          if sq_norm is None else sq_norm(grads))
        keep = norm < clip
        return {n: torch.where(keep, g, (g / norm) * clip)
                for n, g in grads.items()}

    @torch.no_grad()
    def apply(self, params: dict, grads: dict, state: dict,
              sq_norm=None) -> dict:
        """One update of ``params`` (name -> f32 tensor, changed in place)
        from ``grads`` (name -> tensor or None). ``sq_norm``: see
        :meth:`_clip`. Returns the new state."""
        names = list(state["mu"])
        g = {}
        for n in names:
            gn = grads.get(n)
            g[n] = (torch.zeros_like(params[n]) if gn is None
                    else gn.detach().float())
        g = self._clip(g, sq_norm)
        count = state["count"] + 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(count))
        step_size = -self.schedule(state["count"])
        new = {"count": count, "mu": {}, "nu": {}}
        if self.amsgrad:
            new["nu_max"] = {}
        for n in names:
            mu = (1.0 - self.b1) * g[n] + self.b1 * state["mu"][n]
            nu = (1.0 - self.b2) * (g[n] * g[n]) + self.b2 * state["nu"][n]
            mu_hat = mu / bc1
            nu_hat = nu / bc2
            if self.amsgrad:
                nu_hat = torch.maximum(state["nu_max"][n], nu_hat)
                new["nu_max"][n] = nu_hat
            update = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            params[n].add_(step_size * update)
            new["mu"][n], new["nu"][n] = mu, nu
        return new


def _trainable_fn(frozen_mask):
    """``frozen_mask`` (True = train): None, a bool for every parameter, a
    dict name -> bool, or a callable name -> bool."""
    if frozen_mask is None:
        return None
    if callable(frozen_mask):
        return frozen_mask
    if isinstance(frozen_mask, dict):
        return lambda name: bool(frozen_mask[name])
    return lambda name: bool(frozen_mask)


def make_optimizer(cfg: dict, steps_per_epoch: int,
                   frozen_mask=None) -> Optimizer:
    """The training optimizer from the reference's config keys:
    ``scheduler_kwargs {epoch0, lr0, epoch1, lr1}``, ``grad_norm_clip``
    (<= 0 disables), ``amsgrad`` (default True). ``frozen_mask``: see
    :func:`_trainable_fn`."""
    sk = cfg.get("scheduler_kwargs", {})
    schedule = exp_decay_schedule(
        sk.get("epoch0", 0), sk.get("lr0", 1e-3),
        sk.get("epoch1", max(sk.get("epoch0", 0) + 1, 100)),
        sk.get("lr1", 1e-6), steps_per_epoch)
    return Optimizer(schedule, amsgrad=cfg.get("amsgrad", True),
                     grad_norm_clip=cfg.get("grad_norm_clip", 0.0),
                     trainable=_trainable_fn(frozen_mask))
