"""Vote NMS: the port's batched functions against the JAX ones (vmapped)
on identical inputs."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.ops.geometry import get_laser_phi
from planar_optical_flow_tpu.ops import nms as jnms
from planar_optical_flow_tpu_torch.ops import nms


def _inputs(seed, num_pts=64, b=3, ties=False):
    rng = np.random.default_rng(seed)
    scan = rng.uniform(0.5, 8.0, (b, num_pts)).astype(np.float32)
    if ties:  # few distinct confidences: many exact ties
        cls = rng.choice([0.2, 0.5, 0.9], (b, num_pts, 1)).astype(np.float32)
    else:
        cls = rng.permutation(num_pts * b).reshape(b, num_pts, 1)
        cls = (0.05 + 0.9 * cls / (num_pts * b)).astype(np.float32)
    reg = rng.normal(0.0, 0.3, (b, num_pts, 2)).astype(np.float32)
    phi = get_laser_phi(num_pts=num_pts).astype(np.float32)
    return scan, phi, cls, reg


def _compare(jax_fn, port_fn, scan, phi, cls, reg, **kw):
    ref = jax.vmap(lambda s, c, r: jax_fn(s, jnp.asarray(phi), c, r, **kw))(
        jnp.asarray(scan), jnp.asarray(cls), jnp.asarray(reg))
    got = port_fn(torch.from_numpy(scan), torch.from_numpy(phi),
                  torch.from_numpy(cls), torch.from_numpy(reg), **kw)
    xys, dcls, keep, inst = (t.numpy() for t in got)
    np.testing.assert_array_equal(keep, np.asarray(ref[2]))
    np.testing.assert_array_equal(inst, np.asarray(ref[3]))
    np.testing.assert_allclose(xys, np.asarray(ref[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(dcls, np.asarray(ref[1]))
    assert keep.any() and inst.max() > 0


@pytest.mark.parametrize("ties", [False, True])
def test_nms_topk_matches_jax(ties):
    """With ties, ``lax.top_k`` puts the lower index first; ``torch.topk``
    promises no order among ties, so the port takes a stable descending
    sort, which orders ties the same way as ``lax.top_k``: the keep sets
    and instance masks are then exactly equal."""
    _compare(jnms.nms_predicted_center_topk, nms.nms_predicted_center_topk,
             *_inputs(20, ties=ties), min_dist=0.5, top_k=32)


@pytest.mark.parametrize("ties", [False, True])
def test_nms_full_matches_jax(ties):
    """The JAX oracle sorts with ``jnp.argsort`` (stable: ties by index),
    as the port's stable sort does."""
    _compare(jnms.nms_predicted_center, nms.nms_predicted_center,
             *_inputs(21, ties=ties), min_dist=0.5)
