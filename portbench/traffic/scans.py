"""The scan simulator: a frozen copy of the port's ``data/synthetic.py``
DROW scenes, batched over sequences and frames and ray-cast on the device.

A robot drives through a square room (walls at +-10 m) while cylindrical
people (radius 0.3 m) walk about; the configuration's beams (DROW's 450 at
0.5 deg by default) are cast each frame and clipped at 29.99 m, as the
original does. Two changes keep long sequences alive: the robot and the
people reflect off their bounds (+-6 m and +-8 m) where the original clips
them there, so nobody ends up stuck in a corner after a minute; and the
number of people of each sequence is drawn from a range. Trajectories are
integrated on the host in float64 (a few thousand small steps, vectorised
over sequences); the ray casting runs in float64 on the device over every
frame at once, and the ranges are stored as float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ROOM_HALF = 10.0
PERSON_RADIUS = 0.3
MAX_RANGE = 29.99
ROBOT_BOUND = 6.0
PEOPLE_BOUND = 8.0
DROW_ANGLE_INC = math.radians(0.5)


def laser_phi(num_pts: int, angle_inc: float = DROW_ANGLE_INC):
    """Beam angles: ``num_pts`` beams at ``angle_inc``, centred on 0."""
    fov = (num_pts - 1) * angle_inc
    return np.linspace(-0.5 * fov, 0.5 * fov, num_pts)


def _reflect(pos, vel, bound):
    """Reflect positions beyond +-bound back inside, flipping the velocity
    component that crossed."""
    over = pos > bound
    under = pos < -bound
    pos = np.where(over, 2 * bound - pos, np.where(under, -2 * bound - pos,
                                                    pos))
    vel = np.where(over | under, -vel, vel)
    return pos, vel


def trajectories(rng, num_seq, num_frames, people_range, dt):
    """Robot poses ``(S, T, 3)`` and people ``(S, T, M, 2)`` (absent people
    far outside the room) for ``num_seq`` sequences."""
    lo, hi = people_range
    m = hi
    pose = np.stack([rng.uniform(-2, 2, num_seq), rng.uniform(-2, 2, num_seq),
                     rng.uniform(-np.pi, np.pi, num_seq)], axis=1)
    vel = np.stack([rng.uniform(0.5, 1.0, num_seq),
                    rng.uniform(-0.1, 0.1, num_seq),
                    rng.uniform(-0.3, 0.3, num_seq)], axis=1)
    people = rng.uniform(-6, 6, size=(num_seq, m, 2))
    people_vel = rng.uniform(-0.8, 0.8, size=(num_seq, m, 2))
    count = rng.integers(lo, hi + 1, num_seq)
    present = np.arange(m)[None, :] < count[:, None]
    poses = np.empty((num_seq, num_frames, 3))
    tracks = np.empty((num_seq, num_frames, m, 2))
    for t in range(num_frames):
        c, s = np.cos(pose[:, 2]), np.sin(pose[:, 2])
        pose = pose + dt * np.stack([c * vel[:, 0] - s * vel[:, 1],
                                     s * vel[:, 0] + c * vel[:, 1],
                                     vel[:, 2]], axis=1)
        for axis in (0, 1):
            crossed = np.abs(pose[:, axis]) > ROBOT_BOUND
            pose[:, axis] = np.clip(pose[:, axis], -ROBOT_BOUND, ROBOT_BOUND)
            # turn back into the room: mirror the heading across the wall
            pose[:, 2] = np.where(crossed, (np.pi - pose[:, 2]) if axis == 0
                                  else -pose[:, 2], pose[:, 2])
        people, people_vel = _reflect(people + dt * people_vel, people_vel,
                                      PEOPLE_BOUND)
        poses[:, t] = pose
        tracks[:, t] = np.where(present[..., None], people, 1e4)
    return poses, tracks


def raycast(poses, tracks, phi, device):
    """Ranges ``(S, T, P)`` float32 on ``device`` of every frame: the
    original's walls-then-cylinders cast, in float64."""
    f64 = torch.float64
    pose = torch.as_tensor(poses, dtype=f64, device=device)
    ppl = torch.as_tensor(tracks, dtype=f64, device=device)
    phi = torch.as_tensor(phi, dtype=f64, device=device)
    ang = pose[..., 2:3] + phi  # (S, T, P)
    dx, dy = torch.cos(ang), torch.sin(ang)
    ox, oy = pose[..., 0:1], pose[..., 1:2]
    best = torch.full_like(ang, math.inf)
    for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1)):
        d, o = (dx, ox) if axis == 0 else (dy, oy)
        t = (sign * ROOM_HALF - o) / d
        other = (oy + t * dy) if axis == 0 else (ox + t * dx)
        ok = (t > 0) & (other.abs() <= ROOM_HALF + 1e-6)
        best = torch.where(ok & (t < best), t, best)
    for j in range(ppl.shape[2]):
        px, py = ppl[:, :, j, 0:1], ppl[:, :, j, 1:2]
        rx, ry = ox - px, oy - py
        b = rx * dx + ry * dy
        c = rx * rx + ry * ry - PERSON_RADIUS ** 2
        disc = b * b - c
        ok = disc >= 0
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        ok &= t > 0
        best = torch.where(ok & (t < best), t, best)
    return torch.clamp(best, max=MAX_RANGE).float()
