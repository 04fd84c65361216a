"""Persisted int8 serving calibration.

Counterpart of ``planar_optical_flow_tpu/infer/calibration.py``, with the
same fields and the same JSON (``format_version`` 1): a
``calibration.json`` written by either package loads in the other.

The int8c serving step (``make_serve_step_v3(precision="int8c")``) needs
per-layer activation scales for the backbone and head conv stacks. They are
computed once per checkpoint on representative scans and stored next to
it::

    calib = calibrate_serve_v3(model, cutout_kwargs, calib_scans,
                               num_pts=450)
    calib.save(ckpt_dir)                      # -> ckpt_dir/calibration.json
    ...
    calib = ServeCalibration.load(ckpt_dir)   # later / other process
    step = make_serve_step_v3(model, cutout_kwargs, precision="int8c",
                              calib=calib)
"""

from __future__ import annotations

import dataclasses
import json
import os

CALIBRATION_FILENAME = "calibration.json"
_FORMAT_VERSION = 1


@dataclasses.dataclass
class ServeCalibration:
    """Activation scales for the int8 serving conv stacks.

    ``bb_*`` covers backbone layers 2..6 (layer 1's output scale is
    ``bb_in_scale``); ``hd_*`` covers head conv layers 1..5. The head's
    input scale doubles as the int8c template-carry scale.
    ``weights_checksum`` (sum of squares over the detector's parameters)
    ties the artifact to the weights it was calibrated on; the serving
    step checks it, and the geometry fields, when a restored calibration is
    passed in.
    """

    bb_in_scale: float
    bb_act_scales: list
    hd_in_scale: float
    hd_act_scales: list
    num_pts: int = 450
    num_cutout_pts: int = 48
    weights_checksum: float | None = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["format_version"] = _FORMAT_VERSION
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ServeCalibration":
        d = dict(d)
        d.pop("format_version", None)
        return cls(**d)

    def save(self, path) -> str:
        """Write to ``path`` (a directory gets ``calibration.json`` inside;
        anything else is used verbatim). Returns the file path."""
        path = os.fspath(path)
        if os.path.isdir(path):
            path = os.path.join(path, CALIBRATION_FILENAME)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        return path

    @classmethod
    def load(cls, path) -> "ServeCalibration":
        path = os.fspath(path)
        if os.path.isdir(path):
            path = os.path.join(path, CALIBRATION_FILENAME)
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def find(cls, ckpt_path) -> "ServeCalibration | None":
        """Look for a calibration file next to a checkpoint path (the path
        itself if a directory, else its parent). None if absent."""
        ckpt_path = os.fspath(ckpt_path)
        for base in (ckpt_path, os.path.dirname(ckpt_path) or "."):
            if not os.path.isdir(base):
                continue
            p = os.path.join(base, CALIBRATION_FILENAME)
            if os.path.exists(p):
                return cls.load(p)
        return None


def calibrate_serve_v3(model, cutout_kwargs, calib_scans,
                       num_pts: int = 450, **serve_kwargs) -> ServeCalibration:
    """Run int8c calibration on ``calib_scans`` (B, num_pts) f32 and return
    the persistable scales. Builds a throw-away serve step on the runtime
    encode path, so the observed distributions match serving.
    ``serve_kwargs`` go to ``make_serve_step_v3`` (``device``,
    ``calib_steps``, ``calib_percentile``, ``precision``, ``layout``,
    ``pm_tile``, ...): the scales depend on the layout's beam padding, as
    in JAX."""
    from planar_optical_flow_tpu_torch.infer.streaming import (
        make_serve_step_v3,
    )

    serve_kwargs.setdefault("precision", "int8c")
    step = make_serve_step_v3(model, cutout_kwargs, calib_scans=calib_scans,
                              num_pts=num_pts, **serve_kwargs)
    return step.calibration
