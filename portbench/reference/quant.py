"""The control's arithmetic: the reference in a lower integer precision.

:class:`Recorder` calibrates: it keeps the largest magnitude that each named
tensor reaches while the float32 reference runs on the calibration scans.
:class:`FakeQuant` then rounds, symmetrically to ``bits`` bits, each conv's
weights per output channel and each named activation per tensor at its
recorded scale (the activations that the configuration's integer path
holds as integers: every conv input after the first, the features and the
carried template). :func:`quantized_reference` builds the reference at a
configuration's integer precision (what an int8 configuration's outputs are
held to) or one step below it (int4: the control of an int8 configuration).
"""

from __future__ import annotations

import numpy as np
import torch


class Recorder:
    """Largest magnitude of each activation seen."""

    def __init__(self):
        self.amax = {}

    def act(self, name, x):
        m = float(x.abs().max())
        self.amax[name] = max(self.amax.get(name, 0.0), m)
        return x

    def weight(self, name, w):
        return w


class FakeQuant:
    """Symmetric ``bits``-bit rounding at the recorded scales."""

    def __init__(self, amax: dict, bits: int):
        self.levels = 2 ** (bits - 1) - 1
        self.scale = {k: max(v, 1e-12) / self.levels for k, v in amax.items()}

    def _round(self, x, scale):
        return torch.clamp(torch.round(x / scale), -self.levels,
                           self.levels) * scale

    def act(self, name, x):
        return self._round(x, self.scale[name])

    def weight(self, name, w):
        amax = w.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True)
        return self._round(w, torch.clamp(amax, min=1e-12) / self.levels)


def quantized_reference(sd: dict, cfg: dict, calib, bits: int, module):
    """The reference of ``module`` (the configuration's reference module:
    its ``Reference`` and ``run_streams``) at ``bits`` bits, its scales the
    largest magnitudes that the float32 reference reaches on ``calib (N,
    P)`` (sanitized scans) in a bootstrap and a carried step."""
    rec = Recorder()
    calib = torch.as_tensor(calib, dtype=torch.float32)
    s = calib.shape[0]
    module.run_streams(module.Reference(sd, cfg, rec),
                       torch.stack([calib, calib]),
                       np.array([[True] * s, [False] * s]),
                       on_block=lambda *_: None)
    return module.Reference(sd, cfg, FakeQuant(rec.amax, bits))
