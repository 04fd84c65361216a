"""Per-workload losses and metrics ("tasks").

Counterpart of ``planar_optical_flow_tpu/train/tasks.py`` for the flow
U-Net, the detectors and the box regressor: :class:`FlowUNetTask`
(``"flow_unet"``, ``"prototype"``, ``"prototype_test"``) on scan pairs,
:class:`DetectionTask` (``"drow"``, ``"dr-spaam"`` on cutouts; ``"fc1d"``,
``"fc1d_fea"``, ``"fc2d"`` on their per-beam columns), :class:`FlowDrowTask` and :class:`FlowDrowFusedTask`
(``"flow_drow"``), and :class:`BoxRegressionTask` (``"box_reg"``) on
point segments. Each task's ``loss(model, batch, train, rng)`` returns
``(loss, tb_dict, outputs, new_batch_stats)`` and ``metrics(model, batch)``
``(metrics, outputs)``, as in JAX; the input encoding runs inside the step
on the batch's device (K1 on the card).

Mixed precision: the trainer hands the model its running statistics cast
to the compute dtype and keeps f32 master parameters, which every layer
casts to its input's dtype; :func:`_model_dtype` reads that dtype, and the
tasks cast the model's inputs to it after their f32 encoding and geometry,
as JAX casts them to the cast parameters' dtype. The losses run in f32.
``new_batch_stats`` is the whole statistics collection after the forward
(the frozen detector's included), as flax's mutable collection is.

``loss_pipelined`` is ROADMAP item 20.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from planar_optical_flow_tpu_torch.ops import losses, rotated_iou
from planar_optical_flow_tpu_torch.ops.cutout import area_s_for, scans_to_cutout
from planar_optical_flow_tpu_torch.ops.geometry import get_laser_phi
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout
from planar_optical_flow_tpu_torch.ops.polar_grid import scans_to_polar_grid
from planar_optical_flow_tpu_torch.train.state import named_stats

KERNEL_IMPLS = ("auto", "pallas", "pallas_interpret")
ENCODINGS = ("cutout", "fc1d", "fc1d_fea", "fc2d")


def _model_dtype(model) -> torch.dtype:
    """The floating dtype the model computes in for this step: its running
    statistics' dtype, which the trainer sets to the compute dtype (f32
    outside a mixed-precision step)."""
    for t in named_stats(model).values():
        if t.is_floating_point():
            return t.dtype
    return torch.float32


def _apply(model, args, train: bool, rng=None):
    """Run the model -> (outputs, the whole statistics collection after the
    forward when training, else None)."""
    out = model(*args, train=train, rng=rng)
    return out, (dict(named_stats(model)) if train else None)


@dataclass(frozen=True)
class FlowUNetTask:
    """Scan-pair planar flow: the EPE of the predicted flow, over the
    ``exclude_mask`` when ``masked``. :meth:`metrics` runs the model on the
    uncast f32 pair, as JAX does (bf16 parameters then compute in f32)."""

    masked: bool = False

    def loss(self, model, batch, train, rng=None):
        dt = _model_dtype(model)
        pair = batch["scan_pair"]
        pred, new_stats = _apply(model, (pair[:, 0].to(dt), pair[:, 1].to(dt)),
                                 train, rng)
        mask = batch.get("exclude_mask") if self.masked else None
        loss = losses.epe_loss(pred, batch["flow_target"], mask)
        return loss, {"loss": loss}, {"pred_flow": pred}, new_stats

    def metrics(self, model, batch):
        pair = batch["scan_pair"]
        pred, _ = _apply(model, (pair[:, 0], pair[:, 1]), False)
        epe, aae = losses.epe_aae(pred, batch["flow_target"])
        return {"epe": epe.mean(), "aae": aae.mean()}, {"pred_flow": pred}


@dataclass(frozen=True)
class DetectionTask:
    """Person detection: DROW / DR-SPAAM on cutouts, the fc detectors on
    per-beam columns.

    ``encoding``: ``"cutout"`` (``(B, P, S, C)``), ``"fc1d"`` (the ranges,
    ``(B, S, 1, P)``), ``"fc1d_fea"`` (the cutouts transposed, ``(B, S, C,
    P)``; K1 on the card as for ``"cutout"``) or ``"fc2d"`` (the polar grid
    of ``polar_grid_kwargs``, ``(B, S, R, P)``). The encoding runs in f32
    and is then cast to the model's dtype.

    ``cutout_kwargs["encode_impl"]``: ``"auto"`` (default: K1, the fused
    cutout kernel, on the card when the geometry allows, ``fixed=True,
    stride=1``; the module cutout ``ops/cutout.py`` on the CPU, as JAX
    takes XLA there), ``"pallas"`` (K1's wrapper: the kernel on the card,
    its plain version on the CPU; ``"pallas_interpret"`` the same) or
    ``"xla"`` (the module cutout)."""

    cutout_kwargs: dict = field(default_factory=dict)
    focal_loss_gamma: float = 0.0
    pedestrian_only: bool = False
    num_pts: int = 450
    encoding: str = "cutout"
    polar_grid_kwargs: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.encoding not in ENCODINGS:
            raise ValueError(f"unknown encoding {self.encoding!r}; known: "
                             f"{ENCODINGS}")

    def _encode_cutout(self, scans):
        """``(B, S, P)`` f32 scans -> ``(B, P, S, C)`` f32 cutouts."""
        kw = dict(self.cutout_kwargs)
        impl = kw.pop("encode_impl", "auto")
        eligible = kw.get("fixed", False) and kw.get("stride", 1) == 1
        if impl in ("pallas", "pallas_interpret") and not eligible:
            raise ValueError(
                f"cutout_kwargs encode_impl={impl!r} requires fixed=True "
                "and stride=1 (the cutout kernel's supported geometry); use "
                "encode_impl='auto' or 'xla' otherwise")
        if impl in KERNEL_IMPLS and eligible and not (
                impl == "auto" and scans.device.type == "cpu"):
            return self._encode_cutout_kernel(scans, kw)
        if impl not in (*KERNEL_IMPLS, "xla"):
            raise ValueError(f"unknown encode_impl {impl!r}")
        if kw.pop("area_mode", False):
            kw["area_mode"] = True
            kw.setdefault("area_s", area_s_for(kw.get("window_width", 1.66),
                                               kw.get("num_cutout_pts", 48)))
        return scans_to_cutout(scans.float(),
                               get_laser_phi(num_pts=self.num_pts), **kw)

    def _encode_cutout_kernel(self, scans, kw):
        """K1 over the ``B*S`` scans (no gradient flows into the encode:
        the scans are inputs)."""
        b, s, p = scans.shape
        p_pad = -(-p // 8) * 8  # the beams padded as JAX pads them
        flat = F.pad(scans.float().reshape(b * s, p), (0, p_pad - p))
        ct = cutout(flat, num_cutout_pts=kw.get("num_cutout_pts", 48),
                    window_width=kw.get("window_width", 1.66),
                    window_depth=kw.get("window_depth", 1.0),
                    padding_val=kw.get("padding_val", 29.99),
                    centered=kw.get("centered", True),
                    area_mode=bool(kw.get("area_mode", False)), p_valid=p)
        return ct.reshape(b, s, p_pad, -1)[:, :, :p].permute(0, 2, 1, 3)

    def _encode(self, scans):
        if self.encoding == "fc1d":
            # (B, S, P) ranges -> (B, S, 1, P) columns
            return scans.float()[..., None, :]
        if self.encoding == "fc1d_fea":
            # cutouts (B, P, S, C) -> (B, S, C, P) columns (the reference's
            # transpose, dataset_dr_spaam.py:452-454)
            return self._encode_cutout(scans).permute(0, 2, 3, 1)
        if self.encoding == "fc2d":
            return scans_to_polar_grid(scans, **self.polar_grid_kwargs)
        return self._encode_cutout(scans)

    def forward(self, model, batch, train, rng=None):
        encoded = self._encode(batch["scans"]).to(_model_dtype(model))
        return _apply(model, (encoded,), train, rng)

    def _losses(self, pred_cls, pred_reg, batch):
        return losses.detection_loss(
            pred_cls, pred_reg, batch["target_cls"], batch["target_reg"],
            focal_gamma=self.focal_loss_gamma,
            pedestrian_only=self.pedestrian_only)

    def loss(self, model, batch, train, rng=None):
        out, new_stats = self.forward(model, batch, train, rng)
        pred_cls, pred_reg = out[0], out[1]  # SpatialDrow also returns sim
        cls_loss, reg_loss, fg_ratio = self._losses(pred_cls, pred_reg, batch)
        loss = cls_loss + reg_loss
        tb = {"loss": loss, "cls_loss": cls_loss, "reg_loss": reg_loss,
              "fg_ratio": fg_ratio}
        return loss, tb, {"pred_cls": pred_cls, "pred_reg": pred_reg}, \
            new_stats

    def metrics(self, model, batch):
        out, _ = self.forward(model, batch, False)
        pred_cls, pred_reg = out[0], out[1]
        cls_loss, reg_loss, fg_ratio = self._losses(pred_cls, pred_reg, batch)
        return ({"cls_loss": cls_loss, "reg_loss": reg_loss,
                 "fg_ratio": fg_ratio},
                {"pred_cls": pred_cls, "pred_reg": pred_reg})


def _flow_losses(pred_flow, batch):
    loss = losses.epe_loss(pred_flow, batch["target_flow"],
                           batch["exclude_mask"])
    pred_norm = losses.epe_loss(pred_flow, torch.zeros_like(pred_flow),
                                batch["exclude_mask"])
    return loss, {"loss": loss, "avg_pred_norm": pred_norm}


@dataclass(frozen=True)
class FlowDrowTask(DetectionTask):
    """Joint detection + flow with the frozen detector: the flow EPE over
    the exclude mask."""

    def loss(self, model, batch, train, rng=None):
        dt = _model_dtype(model)
        cutouts = self._encode(batch["scans"]).to(dt)
        cur_scan = batch["scans"][:, -1].to(dt)
        (_, _, pred_flow), new_stats = _apply(model, (cutouts, cur_scan),
                                              train, rng)
        loss, tb = _flow_losses(pred_flow, batch)
        return loss, tb, {"pred_flow": pred_flow}, new_stats

    def metrics(self, model, batch):
        cutouts = self._encode(batch["scans"])
        out, _ = _apply(model, (cutouts, batch["scans"][:, -1]), False)
        pred_cls, pred_reg, pred_flow = out
        epe, aae = losses.epe_aae(pred_flow, batch["target_flow"])
        return ({"epe": epe.mean(), "aae": aae.mean()},
                {"pred_flow": pred_flow, "pred_cls": pred_cls,
                 "pred_reg": pred_reg})


@dataclass(frozen=True)
class FlowDrowFusedTask(FlowDrowTask):
    """FlowDROW training with the frozen detector on the serving kernels
    (``train/fused_frozen.py``: K1 -> K2 -> K3 x (S-1); the band is all the
    loss reads, so no K4) instead of the module; only the flow head runs in
    the module, with its statistics advancing. Requires ``fixed=True,
    stride=1`` (else the module path) and a ``flow_drow`` model with
    ``freeze_detector``. :meth:`metrics` keeps the module path.
    ``alpha``/``window_size`` must match the model's gate (the task replays
    the detector outside the module): build the task with
    :meth:`for_model`."""

    alpha: float = 0.5
    window_size: int = 7

    @classmethod
    def for_model(cls, model, **kwargs):
        """The task with ``alpha``/``window_size`` from the model."""
        kwargs.setdefault("alpha", float(model.alpha))
        kwargs.setdefault("window_size", int(model.window_size))
        return cls(**kwargs)

    def loss(self, model, batch, train, rng=None):
        from planar_optical_flow_tpu_torch.train.fused_frozen import (
            frozen_detector_forward,
        )

        kw = self.cutout_kwargs
        if not kw.get("fixed") or kw.get("stride", 1) != 1:
            return super().loss(model, batch, train, rng)
        dt = _model_dtype(model)
        scans = batch["scans"]  # (B, S, P), scan S-1 current
        _, _, sim_band = frozen_detector_forward(
            model.dr_spaam, scans, alpha=self.alpha,
            window_size=self.window_size, num_pts=self.num_pts,
            ct_len=kw.get("num_cutout_pts", 48),
            window_width=kw.get("window_width", 1.66),
            window_depth=kw.get("window_depth", 1.0),
            padding_val=kw.get("padding_val", 29.99),
            centered=kw.get("centered", True),
            area_mode=bool(kw.get("area_mode", False)), dtype=dt,
            with_head=False)
        pred_flow = model.flow_head(sim_band.to(dt), scans[:, -1].to(dt),
                                    train)
        new_stats = dict(named_stats(model)) if train else None
        loss, tb = _flow_losses(pred_flow, batch)
        return loss, tb, {"pred_flow": pred_flow}, new_stats


@dataclass(frozen=True)
class BoxRegressionTask:
    """PointNet box regression: the L1 box loss (``ops.losses.
    box_regression_loss``) in training; in :meth:`metrics` the z, dims and
    ori errors and, for each de-canonicalized prediction, the max rotated
    IoU against its padded neighbour boxes (invalid ones masked to
    ``-inf``), all samples in one batched call. :meth:`metrics` runs the
    model on the uncast f32 input, as JAX does."""

    alpha: float = 0.5
    is_3d: bool = True

    def loss(self, model, batch, train, rng=None):
        x = batch["input"].to(_model_dtype(model))
        pred, new_stats = _apply(model, (x,), train, rng)
        loss = losses.box_regression_loss(pred, batch["target"], self.alpha)
        return loss, {"loss": loss}, {"pred": pred}, new_stats

    def metrics(self, model, batch):
        pred, _ = _apply(model, (batch["input"],), False)
        target = batch["target"]
        det_center = batch["det_center"]
        input_angle = batch["input"][:, 0, -1]
        ori = pred[:, -1] + input_angle
        if self.is_3d:
            cz = pred[:, 0] + det_center[:, -1]
            loss_z = (cz - (target[:, 0] + det_center[:, -1])).abs()
            loss_dim = (pred[:, 1:-1] - target[:, 1:-1]).abs().sum(dim=1)
            # (B, 7): cx cy cz l w h rot
            boxes = torch.cat([det_center[:, :2], cz[:, None],
                               pred[:, 1:-1], ori[:, None]], dim=1)
            iou_fn = rotated_iou.rotated_iou_3d_paired
        else:
            loss_z = torch.zeros_like(ori)
            loss_dim = (pred[:, :-1] - target[:, :-1]).abs().sum(dim=1)
            # (B, 5): cx cy l w rot
            boxes = torch.cat([det_center[:, :2], pred[:, :-1],
                               ori[:, None]], dim=1)
            iou_fn = rotated_iou.rotated_iou_paired
        loss_ori = (ori - batch["rot_z"]).abs()
        # each prediction against its (K, 7|5) neighbours: (B, K)
        iou = iou_fn(boxes[:, None, :], batch["target_neighbor"])
        ious = torch.where(batch["target_neighbor_valid"], iou,
                           -torch.inf).amax(dim=1)
        return ({"iou": ious.mean(), "loss_z": loss_z.mean(),
                 "loss_dim": loss_dim.mean(), "loss_ori": loss_ori.mean()},
                {"pred": pred})
