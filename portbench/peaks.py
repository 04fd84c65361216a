"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit), and the roofline bound.

A frozen copy of the constants and ``bound()`` of the repository's
``chip_smoke.py``. The card's power limit is printed beside every run
(``device.power_limit_w`` in the result line), since a card set below
700 W runs below these rates.
"""

from __future__ import annotations

PEAK = {
    "int8": 1979e12,   # dense int8 tensor-core operations/s
    "bf16": 989e12,    # dense bf16 tensor-core FLOP/s
    "tf32": 495e12,    # dense TF32 tensor-core FLOP/s
    "f32": 67e12,      # float32 outside the tensor cores
}
HBM_BYTES_PER_S = 3.35e12


def ideal_s(ops: dict) -> float:
    """Seconds for ``{precision: operations}`` at the peaks, one after the
    other."""
    return sum(n / PEAK[p] for p, n in ops.items())


def bound_s(ops: dict, nbytes: float) -> float:
    """The roofline bound: the larger of :func:`ideal_s` and ``nbytes`` at
    the HBM rate."""
    return max(ideal_s(ops), nbytes / HBM_BYTES_PER_S)
