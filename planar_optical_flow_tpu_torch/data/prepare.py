"""Offline data preparation: ``.difodom`` and ``.flow`` files from raw DROW
sequences.

Counterpart of ``planar_optical_flow_tpu/data/prepare.py``: frame-to-frame
odometry deltas (the last row zero), and every scan's rigid ego-motion flow
``(v_lin + w x p) * dt`` with ``v = dpose / (dt + 1e-6)``, computed for a
whole sequence in one batched f32 pass of tensor ops on ``device`` (default
``"cuda"``; it raises without a card, ``device="cpu"`` runs on the host).
The files are written with the JAX package's formats.
"""

from __future__ import annotations

import numpy as np
import torch

from planar_optical_flow_tpu_torch import resolve_device
from planar_optical_flow_tpu_torch.data import drow_io
from planar_optical_flow_tpu_torch.ops.geometry import (
    get_laser_phi,
    rphi_to_xy,
)

_REG = 1e-6


def diff_odometry(odom_t: np.ndarray, odom: np.ndarray):
    """Frame-to-frame odometry deltas ``(dt (T,), dpose (T, 3))`` f32, the
    last row zero."""
    dt = np.concatenate([odom_t[1:] - odom_t[:-1], [0.0]]).astype(np.float32)
    dpose = np.concatenate([odom[1:] - odom[:-1], np.zeros((1, 3))]).astype(
        np.float32)
    return dt, dpose


@torch.inference_mode()
def flow_targets_for_sequence(scans: np.ndarray, dts: np.ndarray,
                              dposes: np.ndarray, device="cuda") -> np.ndarray:
    """Rigid ego-motion flow ``(T, P, 2)`` of a sequence's scans ``(T, P)``
    from per-scan ``dts (T,)`` and ``dposes (T, 3)``, in f32."""
    dev = resolve_device(device)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    scans_t, dts_t, dposes_t = put(scans), put(dts), put(dposes)
    phi = put(get_laser_phi(num_pts=scans.shape[-1]))
    v_lin = dposes_t[:, None, :2] / (dts_t[:, None, None] + _REG)
    w = dposes_t[:, 2] / (dts_t + _REG)
    x, y = rphi_to_xy(scans_t, phi)
    v_rot = torch.stack((-w[:, None] * y, w[:, None] * x), dim=-1)
    return ((v_rot + v_lin) * dts_t[:, None, None]).cpu().numpy()


def prepare_split(data_dir: str, split: str, verbose: bool = True,
                  device="cuda"):
    """Write ``.difodom`` and ``.flow`` next to each ``.csv`` of a split.
    Returns the sequence stems."""
    stems = drow_io.list_sequences(data_dir, split)
    for stem in stems:
        _, odom_t, odom = drow_io.load_odometry_file(stem)
        dt, dpose = diff_odometry(odom_t, odom)
        np.savetxt(stem + ".difodom", np.column_stack([dt, dpose]),
                   fmt="%8.6f", delimiter=",")
        _, scan_t, scans = drow_io.load_scan_file(stem)
        # each scan's nearest odometry sample by timestamp
        idx = np.argmin(np.abs(scan_t[:, None] - odom_t[None, :]), axis=1)
        flows = flow_targets_for_sequence(scans, dt[idx], dpose[idx], device)
        np.savetxt(stem + ".flow", flows.reshape(len(scans), -1),
                   fmt="%10.8f", delimiter=",")
        if verbose:
            print(f"prepared {stem}: {len(scans)} scans")
    return stems
