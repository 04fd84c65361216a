"""Synthetic DROW and JRDB data.

Counterpart of ``planar_optical_flow_tpu/data/synthetic.py`` (numpy only).
The repo ships no corpus, so tests and the smoke run write stand-ins. DROW:
a robot with odometry drives through a square room while cylindrical
people walk about; scans are ray-cast at the SICK S300 geometry (0.5 deg a
beam). JRDB (:func:`make_synthetic_jrdb`): 3D boxes with points sampled
inside them over background clutter. For the same seed the data, and the
files written from them, are byte-identical to the JAX package's.
"""

from __future__ import annotations

import json
import os

import numpy as np

from planar_optical_flow_tpu_torch.ops.geometry import get_laser_phi

_ROOM_HALF = 10.0
_PERSON_RADIUS = 0.3
_MAX_RANGE = 29.99


def _raycast(origin, heading, phi, people_xy):
    """Ranges of 450 beams from ``origin`` with robot ``heading`` against the
    square room walls and person cylinders. Vectorized over beams."""
    ang = heading + phi
    dx, dy = np.cos(ang), np.sin(ang)
    t_best = np.full(phi.shape, np.inf)

    # axis-aligned walls x=±H, y=±H
    for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1)):
        d = dx if axis == 0 else dy
        o = origin[axis]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (sign * _ROOM_HALF - o) / d
        other = origin[1 - axis] + t * (dy if axis == 0 else dx)
        ok = (t > 0) & (np.abs(other) <= _ROOM_HALF + 1e-6)
        t_best = np.where(ok & (t < t_best), t, t_best)

    # person cylinders
    for px, py in people_xy:
        ox, oy = origin[0] - px, origin[1] - py
        b = ox * dx + oy * dy
        c = ox * ox + oy * oy - _PERSON_RADIUS**2
        disc = b * b - c
        ok = disc >= 0
        t = -b - np.sqrt(np.where(ok, disc, 0.0))
        ok &= t > 0
        t_best = np.where(ok & (t < t_best), t, t_best)

    return np.minimum(t_best, _MAX_RANGE).astype(np.float32)


def make_synthetic_drow_sequence(num_frames=60, num_people=3, seed=0, dt=0.1,
                                 num_pts=450):
    """Simulate one DROW sequence.

    Returns a dict with ``scans (T, P)``, ``timestamps (T,)``,
    ``seq_ids (T,)``, ``odom (T, 3)`` (x, y, phi world pose) and
    ``people (T, N, 2)`` world positions, plus per-frame annotation lists
    ``wps`` (people in sensor polar coords) and empty ``wcs``/``was``.
    """
    rng = np.random.default_rng(seed)
    phi = get_laser_phi(num_pts=num_pts)

    pose = np.array([rng.uniform(-2, 2), rng.uniform(-2, 2), rng.uniform(-np.pi, np.pi)])
    vel = np.array([rng.uniform(0.5, 1.0), rng.uniform(-0.1, 0.1),
                    rng.uniform(-0.3, 0.3)])

    people = rng.uniform(-6, 6, size=(num_people, 2))
    people_vel = rng.uniform(-0.8, 0.8, size=(num_people, 2))

    scans, odom, ppl_tracks = [], [], []
    wps = []
    for t in range(num_frames):
        # integrate robot (velocity in body frame)
        c, s = np.cos(pose[2]), np.sin(pose[2])
        pose = pose + dt * np.array(
            [c * vel[0] - s * vel[1], s * vel[0] + c * vel[1], vel[2]]
        )
        pose[:2] = np.clip(pose[:2], -6, 6)
        people = np.clip(people + dt * people_vel, -8, 8)

        scans.append(_raycast(pose[:2], pose[2], phi, people))
        odom.append(pose.copy())
        ppl_tracks.append(people.copy())

        # annotations: people in sensor polar frame
        rel = people - pose[:2]
        rot = np.array([[np.cos(-pose[2]), -np.sin(-pose[2])],
                        [np.sin(-pose[2]), np.cos(-pose[2])]])
        rel = rel @ rot.T
        r = np.hypot(rel[:, 0], rel[:, 1])
        a = np.arctan2(rel[:, 1], rel[:, 0])
        vis = (r < 25.0) & (np.abs(a) < phi[-1])
        wps.append([[float(rr), float(aa)] for rr, aa, v in zip(r, a, vis) if v])

    return {
        "scans": np.stack(scans),
        "timestamps": (np.arange(num_frames) * dt).astype(np.float32),
        "seq_ids": np.arange(num_frames, dtype=np.uint32),
        "odom": np.stack(odom).astype(np.float32),
        "people": np.stack(ppl_tracks),
        "wcs": [[] for _ in range(num_frames)],
        "was": [[] for _ in range(num_frames)],
        "wps": wps,
    }


def write_synthetic_drow_split(data_dir, split="train", num_sequences=2,
                               num_frames=60, num_people=3, seed=0,
                               num_pts=450):
    """Write synthetic sequences in the DROWv2 on-disk format
    (csv/odom2/wc/wa/wp). Returns the list of sequence stems."""
    out_dir = os.path.join(data_dir, split)
    os.makedirs(out_dir, exist_ok=True)
    stems = []
    for i in range(num_sequences):
        seq = make_synthetic_drow_sequence(
            num_frames=num_frames, num_people=num_people,
            seed=seed * 1000 + i, num_pts=num_pts,
        )
        stem = os.path.join(out_dir, f"synth_{split}_{i}")
        stems.append(stem)

        rows = np.column_stack(
            [seq["seq_ids"], seq["timestamps"], seq["scans"]]
        )
        np.savetxt(stem + ".csv", rows, fmt="%.6f", delimiter=",")
        rows = np.column_stack(
            [seq["seq_ids"], seq["timestamps"], seq["odom"]]
        )
        np.savetxt(stem + ".odom2", rows, fmt="%.6f", delimiter=",")
        for ext, key in ((".wc", "wcs"), (".wa", "was"), (".wp", "wps")):
            with open(stem + ext, "w") as f:
                for sid, dets in zip(seq["seq_ids"], seq[key]):
                    f.write(f"{sid},{json.dumps(dets)}\n")
    return stems


def make_synthetic_jrdb(num_frames=4, boxes_per_frame=5, pts_per_box=64,
                        seed=0, is_3d=True):
    """Synthetic JRDB-style frames: per frame a list of 3D boxes
    ``[cx, cy, cz, l, w, h, rot_z]`` and a point cloud sampled inside them
    plus background clutter (the structure of a JRDB handle's frame)."""
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(num_frames):
        boxes = []
        pts = [rng.uniform(-8, 8, size=(256, 3)) * np.array([1, 1, 0.2])]
        for _ in range(boxes_per_frame):
            cx, cy = rng.uniform(-5, 5, size=2)
            cz = rng.uniform(-0.3, 0.3)
            l, w, h = (rng.uniform(0.4, 1.2), rng.uniform(0.3, 0.8),
                       rng.uniform(1.4, 1.9))
            rot = rng.uniform(-np.pi, np.pi)
            boxes.append([cx, cy, cz, l, w, h, rot])
            # points sampled in the oriented box
            local = rng.uniform(-0.5, 0.5, size=(pts_per_box, 3)) * [l, w, h]
            c, s = np.cos(rot), np.sin(rot)
            world = np.stack(
                [c * local[:, 0] - s * local[:, 1] + cx,
                 s * local[:, 0] + c * local[:, 1] + cy,
                 local[:, 2] + cz], axis=1)
            pts.append(world)
        frames.append({"points": np.concatenate(pts).astype(np.float32),
                       "boxes": np.asarray(boxes, dtype=np.float32)})
    return frames
