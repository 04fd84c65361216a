"""The module cutout's training options against the JAX package's, on the
CPU: ``fixed=False`` (every scan windowed with the most recent scan's
ranges), ``stride>1`` and ``area_fast``, in both gather modes.

Scans of 64 beams, 3 scans a stack, B=2, made from a seed with numpy.
Bars: the cutouts within 1e-4 of JAX's (the module cutout's bar,
``tests/test_torch_kernels.py test_module_cutout_matches_jax``), against
JAX's eager call, whose divisions are true divisions as the port's are.
``area_fast`` follows XLA's order of the f32 prefix sum (its running sums
reach ~1,000 m at 64 beams and ~13,500 m at 450, where a difference of two
of them loses ~1e-3 to cancellation): the prefix sum is held to
``jnp.cumsum`` to the bit at both widths.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.ops.cutout import area_s_for
from planar_optical_flow_tpu.ops.cutout import scans_to_cutout as jax_cutout
from planar_optical_flow_tpu.ops.geometry import get_laser_phi
from planar_optical_flow_tpu.train import tasks as jax_tasks
from planar_optical_flow_tpu_torch.ops.cutout import scans_to_cutout
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import prefix_sum
from planar_optical_flow_tpu_torch.train import tasks

from tests.test_torch_common import CT_LEN, NUM_PTS, t2n

TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(centered=True, window_width=1.0, window_depth=0.5,
            num_cutout_pts=CT_LEN, padding_val=29.99,
            area_s=area_s_for(1.0, CT_LEN))
OPTIONS = {
    "moving": dict(fixed=False),
    "stride2": dict(fixed=True, stride=2),
    "area_fast": dict(fixed=True, area_mode=True, area_fast=True),
    "moving_stride2_area_fast": dict(fixed=False, stride=2, area_mode=True,
                                     area_fast=True),
}


def _scans(num_pts=NUM_PTS, seed=8):
    return np.random.default_rng(seed).uniform(
        0.3, 28.0, (2, 3, num_pts)).astype(np.float32)


@pytest.mark.parametrize("gather_mode", ["gather", "matmul"])
@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_cutout_options_match_jax(name, gather_mode):
    scans = _scans()
    phi = get_laser_phi(num_pts=NUM_PTS)
    kw = dict(BASE, gather_mode=gather_mode, **OPTIONS[name])
    ref = np.asarray(jax_cutout(jnp.asarray(scans), phi, **kw))
    got = t2n(scans_to_cutout(torch.from_numpy(scans), phi, **kw))
    stride = kw.get("stride", 1)
    assert got.shape == (2, -(-NUM_PTS // stride), 3, CT_LEN)
    np.testing.assert_allclose(got, ref, **TOL)


def test_moving_window_uses_the_last_scan():
    """``fixed=False``: each scan of the stack is windowed with the last
    scan's ranges, so a stack of one scan repeated is ``fixed=True``'s
    cutouts of that scan, and a stack whose last scan differs is not."""
    scans = _scans()
    phi = get_laser_phi(num_pts=NUM_PTS)
    last = np.repeat(scans[:, -1:], 3, axis=1)
    same = scans_to_cutout(torch.from_numpy(last), phi, fixed=False, **BASE)
    fixed = scans_to_cutout(torch.from_numpy(last), phi, fixed=True, **BASE)
    assert torch.equal(same, fixed)
    moving = scans_to_cutout(torch.from_numpy(scans), phi, fixed=False,
                             **BASE)
    own = scans_to_cutout(torch.from_numpy(scans), phi, fixed=True, **BASE)
    assert torch.equal(moving[:, :, -1], own[:, :, -1])
    assert not torch.equal(moving[:, :, 0], own[:, :, 0])


@pytest.mark.parametrize("num_pts", [NUM_PTS, 450])
def test_prefix_sum_follows_xla(num_pts):
    scans = _scans(num_pts)
    np.testing.assert_array_equal(
        t2n(prefix_sum(torch.from_numpy(scans))),
        np.asarray(jnp.cumsum(jnp.asarray(scans), axis=-1)))


def test_area_fast_has_no_effect_in_matmul_mode():
    """JAX's matmul branch takes area mode itself, so ``area_fast`` changes
    nothing there: the cutouts equal to the bit."""
    scans = torch.from_numpy(_scans())
    phi = get_laser_phi(num_pts=NUM_PTS)
    kw = dict(BASE, gather_mode="matmul", area_mode=True, fixed=False)
    assert torch.equal(scans_to_cutout(scans, phi, area_fast=True, **kw),
                       scans_to_cutout(scans, phi, **kw))


def test_detection_task_default_geometry_matches_jax():
    """A ``cutout_kwargs`` that leaves out ``fixed`` takes JAX's default,
    ``fixed=False``, which the cutout kernel does not cover: the task
    encodes on the module cutout (``encode_impl`` "auto") on the CPU as JAX
    does on XLA, within the bar; "pallas" raises."""
    scans = _scans()
    kw = dict(BASE, area_mode=True, area_fast=True)
    kw.pop("area_s")
    jtask = jax_tasks.DetectionTask(cutout_kwargs=kw, num_pts=NUM_PTS)
    task = tasks.DetectionTask(cutout_kwargs=kw, num_pts=NUM_PTS)
    ref = np.asarray(jtask._encode(jnp.asarray(scans)))
    got = t2n(task._encode(torch.from_numpy(scans)))
    np.testing.assert_allclose(got, ref, **TOL)
    with pytest.raises(ValueError, match="fixed=True"):
        tasks.DetectionTask(cutout_kwargs=dict(kw, encode_impl="pallas"),
                            num_pts=NUM_PTS)._encode(torch.from_numpy(scans))
