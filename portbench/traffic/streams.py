"""The generator of stream mixes: B sensor streams in a closed loop.

A mix file (``traffic/<mix>.json``) names this module as its
``"generator"`` and sets:

* ``pool_sequences``, ``pool_frames``: the simulated sequences every stream
  plays from (``traffic/scans.py``), made from the seed during set-up and
  held in pinned host memory;
* ``people``: ``[least, most]`` people in a sequence;
* ``scan_hz``: the sensor's rate, which sets the simulator's time step;
* ``restart_mean_scans``: the mean length of a stream before it restarts on
  a new sequence (null: streams never restart).

Restarts are dealt out in blocks of :data:`BLOCK_STEPS` steps. Every block
holds the same number of restart steps and of restarted streams, the counts
that streams of geometric lengths with the stated mean would give on
average; the seed chooses which steps and which streams. So every seed asks
for the same work, in another order.

Step ``k`` of the window reads, for stream ``i``, the next frame of the
sequence the stream plays; a sequence is played forwards then backwards
(frame indices reflect at its ends), so consecutive scans of a stream are
always consecutive frames. Step 0 starts every stream; a restart at step
``k`` starts the stream on a new sequence and frame. Everything is a
function of the seed and the step index only.

A mix may also state ``streams``, the number of streams, which the harness
reads in place of the configuration's (``spec.Cell.streams``).

What the harness asks of a generator module: ``make(params, num_streams,
num_pts, seed, device, angle_inc=...)`` (``angle_inc``: the angle between
beams, in radians, from the configuration) returning an object with
``pool`` (the host scans, one a row), ``rows_at_start()``, ``advance(k)``
-> (pool rows of step ``k``, restarted streams), and
``restarts_per_block`` (0 where streams never restart).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.traffic import scans as sim

_SALT_POOL, _SALT_START, _SALT_BLOCK = 1, 2, 3
BLOCK_STEPS = 100


def _rng(seed, *salt):
    return np.random.default_rng([int(seed) % (2 ** 64), *salt])


class Streams:
    """The scans and restarts of one run (see the module docstring)."""

    def __init__(self, params: dict, num_streams: int, num_pts: int,
                 seed: int, device, angle_inc: float = sim.DROW_ANGLE_INC):
        self.params = params
        self.num_streams = b = int(num_streams)
        self.num_pts = num_pts
        self.seed = seed
        s, length = int(params["pool_sequences"]), int(params["pool_frames"])
        self.pool_sequences, self.pool_frames = s, length
        self.period = 2 * length - 2
        self.pool = make_pool(params, num_pts, seed, device, angle_inc)
        rng = _rng(seed, _SALT_START)
        self._seq = rng.integers(0, s, b)
        self._start = rng.integers(0, self.period, b)
        self._since = np.zeros(b, dtype=np.int64)  # step the segment began
        self._k = -1
        mean = params.get("restart_mean_scans")
        self.block = BLOCK_STEPS
        if mean:
            q = 1.0 - (1.0 - 1.0 / float(mean)) ** b
            self.restart_steps = int(round(self.block * q))
            self.restarts_per_block = max(
                self.restart_steps, int(round(self.block * b / float(mean))))
        else:
            self.restart_steps = self.restarts_per_block = 0
        self._blocks = {}

    def _block(self, n: int) -> dict:
        """Restarts of block ``n``: step -> (streams, sequences, frames)."""
        if n not in self._blocks:
            rng = _rng(self.seed, _SALT_BLOCK, n)
            out = {}
            if self.restart_steps:
                # step 0 starts every stream: block 0 deals from step 1
                first = 1 if n == 0 else 0
                steps = first + np.sort(rng.choice(
                    self.block - first, self.restart_steps, replace=False))
                counts = np.full(self.restart_steps,
                                 self.restarts_per_block // self.restart_steps)
                extra = rng.choice(
                    self.restart_steps,
                    self.restarts_per_block % self.restart_steps,
                    replace=False)
                counts[extra] += 1
                for step, c in zip(steps, counts):
                    ids = np.sort(rng.choice(self.num_streams, int(c),
                                             replace=False))
                    out[n * self.block + int(step)] = (
                        ids, rng.integers(0, self.pool_sequences, c),
                        rng.integers(0, self.period, c))
            self._blocks = {n: out}  # one block is live at a time
        return self._blocks[n]

    def restarts(self, k: int) -> np.ndarray:
        """Streams that restart at step ``k``."""
        got = self._block(k // self.block).get(k)
        return np.zeros(0, dtype=np.int64) if got is None else got[0]

    def advance(self, k: int) -> tuple:
        """Move to step ``k`` (steps come in order from 0): returns (pool
        rows ``(B,)``, restarted streams)."""
        if k != self._k + 1:
            raise ValueError(f"steps must come in order: {self._k} -> {k}")
        self._k = k
        restarted = self.restarts(k)
        if restarted.size:
            ids, seqs, starts = self._block(k // self.block)[k]
            self._seq[ids], self._start[ids] = seqs, starts
            self._since[ids] = k
        return self._rows(k), restarted

    def _rows(self, k: int) -> np.ndarray:
        m = (self._start + (k - self._since)) % self.period
        frame = np.where(m < self.pool_frames, m, self.period - m)
        return self._seq * self.pool_frames + frame

    def rows_at_start(self) -> np.ndarray:
        """Pool rows of step 0, before the window (set-up's scans)."""
        if self._k != -1:
            raise ValueError("rows_at_start is for set-up, before step 0")
        return self._rows(0)


def make_pool(params: dict, num_pts: int, seed: int, device,
              angle_inc: float = sim.DROW_ANGLE_INC) -> torch.Tensor:
    """The simulated sequences, ``(pool_sequences * pool_frames, num_pts)``
    float32 on the host (pinned where a card is used), cast at beams
    ``angle_inc`` radians apart."""
    s, length = int(params["pool_sequences"]), int(params["pool_frames"])
    poses, tracks = sim.trajectories(_rng(seed, _SALT_POOL), s, length,
                                     params["people"],
                                     1.0 / float(params["scan_hz"]))
    phi = sim.laser_phi(num_pts, angle_inc)
    pinned = torch.device(device).type == "cuda"
    pool = torch.empty((s * length, num_pts), dtype=torch.float32,
                       pin_memory=pinned)
    chunk = max(1, (1 << 22) // (length * num_pts))  # sequences a cast
    for i in range(0, s, chunk):
        ranges = sim.raycast(poses[i:i + chunk], tracks[i:i + chunk], phi,
                             device)
        pool[i * length:(i + ranges.shape[0]) * length] = ranges.reshape(
            -1, num_pts).cpu()
    return pool


def make(params: dict, num_streams: int, num_pts: int, seed: int, device,
         angle_inc: float = sim.DROW_ANGLE_INC):
    """The generator's entry: a :class:`Streams`."""
    return Streams(params, num_streams, num_pts, seed, device, angle_inc)
