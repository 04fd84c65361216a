"""Box-regression inference.

Counterpart of ``planar_optical_flow_tpu/infer/box_regressor.py``: given
detection centres on a point cloud, crop a radius segment around each,
resample it to the network's fixed input size, run the regressor and
de-canonicalize each prediction into a global box ``[cx, cy, (cz), l, w,
(h), rot_z]``. The crop and resample run on the host in numpy (segments
vary in length), with JAX's draws; the forward is one eval-mode call on
``device`` for all of a frame's detections.
"""

from __future__ import annotations

import numpy as np
import torch

from planar_optical_flow_tpu_torch import resolve_device
from planar_optical_flow_tpu_torch.models.pointnet import BoundingBoxRegressor


def resample_segment(segment: np.ndarray, size: int,
                     rng: np.random.Generator | None = None) -> np.ndarray:
    """Shuffle and truncate, or repeat and pad, a variable-length segment
    to ``size`` points."""
    rng = rng or np.random.default_rng(0)
    seg = segment.copy()
    if len(seg) >= size:
        rng.shuffle(seg)
        return seg[:size]
    repeat = size // len(seg)
    pad = size % len(seg)
    rng.shuffle(seg)
    seg = np.repeat(seg, repeat, axis=0)
    seg = np.vstack([seg, seg[:pad]])
    rng.shuffle(seg)
    return seg


class BoxRegressor:
    """Callable box regressor over (points, detection centres).

    ``weights``: the ``state_dict`` of a ``BoundingBoxRegressor`` of the
    config's widths, or None (random weights from seed 0). ``cfg`` takes
    the dataset keys ``input_size``, ``radius_segment``, ``is_3d``,
    ``input_with_angle`` and ``min_segment_size``. ``seed`` seeds the
    resampling draws; ``device`` (default ``"cuda"``, raising without a
    card) runs the forward.
    """

    def __init__(self, weights, cfg: dict, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.is_3d = cfg.get("is_3d", True)
        self.input_size = cfg.get("input_size", 256)
        self.radius = cfg.get("radius_segment", 0.4)
        self.input_with_angle = cfg.get("input_with_angle", True)
        self.min_segment_size = cfg.get("min_segment_size", 1)
        self._rng = np.random.default_rng(seed)
        self.in_dim = (3 if self.is_3d else 2) + (
            1 if self.input_with_angle else 0)
        self.model = BoundingBoxRegressor(
            input_dim=self.in_dim, target_dim=5 if self.is_3d else 3,
            dropout=cfg.get("dropout", 0.0))
        if weights is not None:
            self.model.load_state_dict(weights, strict=True)
        self.model = self.model.to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, cfg: dict, **kw):
        """From a port checkpoint: a training checkpoint directory, or a
        weights file written by ``interop.checkpoint.save_weights``."""
        from planar_optical_flow_tpu_torch.interop.checkpoint import (
            load_weights,
        )

        self = cls(None, cfg, **kw)
        load_weights(self.model, ckpt_path)
        return self

    @classmethod
    def from_artifact(cls, path: str, cfg: dict, **kw):
        raise NotImplementedError(
            "BoxRegressor.from_artifact is not ported yet (ROADMAP.md queue "
            "1 item 19: interop and export); use from_checkpoint")

    def generate_segments(self, points: np.ndarray, det_centers: np.ndarray):
        """Radius-crop and resample one segment per detection centre ->
        (``(N, input_size, 3|2)`` f32 segments, ``(N,)`` bool: the segment
        held enough points; a zero segment where it did not)."""
        segs, ok = [], []
        dim = 3 if self.is_3d else 2
        if len(det_centers) == 0:
            return (np.zeros((0, self.input_size, dim), np.float32),
                    np.zeros((0,), bool))
        pts = points[:, :dim]
        for c in det_centers:
            d = np.linalg.norm(pts[:, :2] - c[None, :2], axis=1)
            seg = pts[d <= self.radius]
            if len(seg) < max(self.min_segment_size, 1):
                segs.append(np.zeros((self.input_size, dim), np.float32))
                ok.append(False)
                continue
            segs.append(resample_segment(seg, self.input_size, self._rng)
                        .astype(np.float32))
            ok.append(True)
        return np.stack(segs), np.asarray(ok)

    @torch.no_grad()
    def __call__(self, points: np.ndarray, det_centers: np.ndarray,
                 det_oris: np.ndarray | None = None):
        """Regress one box per detection centre -> (``(N, 7)`` ``[cx, cy,
        cz, l, w, h, rot_z]`` in 3D, else ``(N, 5)`` ``[cx, cy, l, w,
        rot_z]``; the validity mask)."""
        det_centers = np.atleast_2d(det_centers)
        n = len(det_centers)
        if n == 0:
            width = 7 if self.is_3d else 5
            return np.zeros((0, width), np.float32), np.zeros((0,), bool)
        if det_oris is None:
            det_oris = np.zeros(n, np.float32)
        segs, ok = self.generate_segments(points, det_centers)

        inputs = segs - det_centers[:, None, : segs.shape[-1]]
        if self.input_with_angle:
            ang = np.broadcast_to(det_oris[:, None, None],
                                  (n, self.input_size, 1))
            inputs = np.concatenate([inputs, ang], axis=-1)

        x = torch.as_tensor(inputs, dtype=torch.float32, device=self.device)
        pred = self.model(x).cpu().numpy()
        rot = pred[:, -1] + det_oris
        if self.is_3d:
            cz = pred[:, 0] + det_centers[:, 2]
            boxes = np.column_stack(
                [det_centers[:, 0], det_centers[:, 1], cz,
                 pred[:, 1], pred[:, 2], pred[:, 3], rot])
        else:
            boxes = np.column_stack(
                [det_centers[:, 0], det_centers[:, 1],
                 pred[:, 0], pred[:, 1], rot])
        return boxes, ok
