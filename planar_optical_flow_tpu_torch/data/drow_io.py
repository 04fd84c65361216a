"""Readers for the DROWv2 on-disk formats.

Counterpart of ``planar_optical_flow_tpu/data/drow_io.py``:

* ``<seq>.csv``        per scan: ``seq_id, timestamp, r_0 ... r_P-1``;
* ``<seq>.wc/.wa/.wp`` per annotated scan: ``seq_id,[[r, phi], ...]`` (a
  JSON list) for wheelchairs, walking aids and pedestrians;
* ``<seq>.odom2``      per odometry sample: ``seq_id, timestamp, x, y, phi``;
* ``<seq>.difodom``    per sample: ``dt, dx, dy, dphi`` (``data/prepare.py``);
* ``<seq>.flow``       per scan: ``P * 2`` floats, the flow targets
  (``data/prepare.py``).

Numbers are parsed as float64, then cast: by the native CSV reader
(``data/native.py``; ``native.status()`` says whether it serves) where it
is available, as JAX reads them, else by ``np.loadtxt``.
"""

from __future__ import annotations

import json
import os
from glob import glob

import numpy as np

from planar_optical_flow_tpu_torch.data import native


def _read_csv_floats(path: str) -> np.ndarray:
    """A comma-separated float matrix: the native reader first, else
    ``np.loadtxt`` (also for a file the native reader refuses)."""
    out = native.read_csv(path)
    if out is not None:
        return out
    return np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)


def list_sequences(data_dir: str, split: str) -> list[str]:
    """Sequence path stems (without extension) of a DROW split."""
    return sorted(f[:-4] for f in glob(os.path.join(data_dir, split, "*.csv")))


def _require_cols(data: np.ndarray, min_cols: int, path: str) -> np.ndarray:
    if data.ndim != 2 or data.shape[1] < min_cols:
        raise ValueError(
            f"malformed DROW file {path}: expected >= {min_cols} "
            f"comma-separated columns per line, got shape {data.shape}")
    return data


def load_scan_file(seq_stem: str):
    """-> (seq_ids (T,) uint32, timestamps (T,) f32, scans (T, P) f32)."""
    data = _require_cols(_read_csv_floats(seq_stem + ".csv"), 3,
                         seq_stem + ".csv")
    return (
        data[:, 0].astype(np.uint32),
        data[:, 1].astype(np.float32),
        np.ascontiguousarray(data[:, 2:], dtype=np.float32),
    )


def load_detection_file(seq_stem: str):
    """-> (seq_ids (D,), wcs, was, wps) with per-frame lists of [r, phi]."""

    def read_one(path):
        ids, dets = [], []
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    head, tail = line.split(",", 1)
                    ids.append(int(head))
                    dets.append(json.loads(tail))
                except (ValueError, json.JSONDecodeError) as e:
                    raise ValueError(
                        f"malformed annotation line {path}:{lineno} "
                        f"(expected 'seq_id,[[r, phi], ...]'): {e}"
                    ) from None
        return ids, dets

    ids_c, wcs = read_one(seq_stem + ".wc")
    ids_a, was = read_one(seq_stem + ".wa")
    ids_p, wps = read_one(seq_stem + ".wp")
    if not (ids_c == ids_a == ids_p):
        raise ValueError(f"annotation id mismatch for {seq_stem}")
    return np.asarray(ids_c), wcs, was, wps


def load_odometry_file(seq_stem: str):
    """``.odom2`` -> (seq_ids (T,), timestamps (T,), poses (T, 3) [x y phi])."""
    data = _require_cols(_read_csv_floats(seq_stem + ".odom2"), 5,
                         seq_stem + ".odom2")
    return (
        data[:, 0].astype(np.uint32),
        data[:, 1].astype(np.float32),
        data[:, 2:5].astype(np.float32),
    )


def load_diff_odometry_file(seq_stem: str):
    """``.difodom`` -> (dt (T,), dpose (T, 3))."""
    data = _require_cols(_read_csv_floats(seq_stem + ".difodom"), 4,
                         seq_stem + ".difodom")
    return data[:, 0].astype(np.float32), data[:, 1:4].astype(np.float32)


def load_flow_file(seq_stem: str, num_pts: int = 450):
    """``.flow`` -> (T, P, 2) float32 flow targets."""
    data = _read_csv_floats(seq_stem + ".flow")
    if data.size % (num_pts * 2):
        raise ValueError(
            f"malformed flow file {seq_stem}.flow: {data.size} values is "
            f"not a whole number of scans at {num_pts} pts x 2")
    return data.reshape(-1, num_pts, 2).astype(np.float32)
