"""JRDB sensor-frame transforms and the ``Box3d`` helper.

Counterpart of ``planar_optical_flow_tpu/data/jrdb_transforms.py``, numpy
only. Frames: base, upper and lower velodyne, laser; x forward, y left, z
up. The laser is rotated pi/120 about z; the upper velodyne is rotated
0.085 rad and raised 0.33529 m; the lower velodyne is lowered 0.13511 m.
Each transform takes and returns ``(3, N)`` points.
"""

from __future__ import annotations

import numpy as np


def _rot_z(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)


_R_LASER = _rot_z(np.pi / 120)
_R_UPPER = _rot_z(0.085)
_T_UPPER = np.array([[0.0], [0.0], [0.33529]], dtype=np.float32)
_R_LOWER = np.eye(3, dtype=np.float32)
_T_LOWER = np.array([[0.0], [0.0], [-0.13511]], dtype=np.float32)


def transform_pts_upper_velodyne_to_base(pts):
    """``(3, N)`` points upper-velodyne -> base."""
    return _R_UPPER @ pts + _T_UPPER


def transform_pts_lower_velodyne_to_base(pts):
    return _R_LOWER @ pts + _T_LOWER


def transform_pts_laser_to_base(pts):
    return _R_LASER @ pts


def transform_pts_base_to_upper_velodyne(pts):
    return _R_UPPER.T @ (pts - _T_UPPER)


def transform_pts_base_to_lower_velodyne(pts):
    return _R_LOWER.T @ (pts - _T_LOWER)


def transform_pts_base_to_laser(pts):
    return _R_LASER.T @ pts


class Box3d:
    """Oriented 3D box for evaluation and plots: the JAX package's vertex
    convention, JRDB's ``rot_z + pi`` in the vertices included. The
    ``draw_*`` helpers plot on the caller's matplotlib axes."""

    def __init__(self, xyz, lwh, rot_z):
        self.xyz = np.asarray(xyz, np.float32).reshape(3, 1)
        self.lwh = np.asarray(lwh, np.float32).reshape(3, 1)
        self.rot_z = float(rot_z)

    @classmethod
    def from_jrdb(cls, label: dict) -> "Box3d":
        b = label["box"] if "box" in label else label
        return cls(
            [b["cx"], b["cy"], b["cz"]], [b["l"], b["w"], b["h"]], b["rot_z"]
        )

    def to_vertices(self) -> np.ndarray:
        """``(3, 8)`` corners: fl fr br bl top, then bottom."""
        unit = np.array(
            [
                [1, 1, -1, -1, 1, 1, -1, -1],
                [-1, 1, 1, -1, -1, 1, 1, -1],
                [1, 1, 1, 1, -1, -1, -1, -1],
            ],
            dtype=np.float32,
        )
        v = 0.5 * unit * self.lwh
        c, s = np.cos(self.rot_z + np.pi), np.sin(self.rot_z + np.pi)
        rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], dtype=np.float32)
        return rot @ v + self.xyz

    def draw_bev(self, ax, c="red"):
        v = self.to_vertices()
        xy = v[:2, [1, 2, 3, 0]]
        ax.plot(xy[0], xy[1], c=c, linestyle="-")
        xy = v[:2, [0, 1]]
        ax.plot(xy[0], xy[1], c=c, linestyle="--")  # front edge dashed

    def draw_fpv(self, ax, dim: int, c="red"):
        v = self.to_vertices()
        for idx in ([0, 1, 2, 3, 0], [4, 5, 6, 7, 4]):
            ax.plot(v[dim, idx], v[2, idx], c=c, linestyle="-")
        for i in range(4):
            ax.plot(v[dim, [i, i + 4]], v[2, [i, i + 4]], c=c, linestyle="-")
        ax.plot(v[dim, [0, 5]], v[2, [0, 5]], c=c, linestyle="--")
        ax.plot(v[dim, [1, 4]], v[2, [1, 4]], c=c, linestyle="--")
