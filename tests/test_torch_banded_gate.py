"""The block-banded gate (``banded_chunk``) of the port against the JAX
package's, on the CPU, and against the port's dense gate.

The gate on random flat features (B=2, 64 cutouts, 48 features, window 5,
chunks of 16), and ``SpatialDrow`` / ``FlowDrow`` with ``banded_chunk`` at
64 beams, 16 cutout points, 3 scans, from flax ``init`` weights with
perturbed BatchNorm statistics. Bars: f32 within 1e-4 of the largest value
(JAX's own banded-against-dense bar, ``tests/test_models_shapes.py:162``),
in eval and in train mode with the running statistics; bf16 at JAX's bf16
bar. A chunk that does not divide the cutouts takes the dense form, equal
to the bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.models import get_model as jax_get_model
from planar_optical_flow_tpu.models.spatial_drow import (
    SpatialAttentionGate as JaxGate,
)
from planar_optical_flow_tpu.models.spatial_drow import (
    _chunk_plan as jax_chunk_plan,
)
from planar_optical_flow_tpu_torch.interop import variables_to_state_dict
from planar_optical_flow_tpu_torch.models import get_model
from planar_optical_flow_tpu_torch.models.spatial_drow import (
    SpatialAttentionGate,
    _chunk_plan,
)
from planar_optical_flow_tpu_torch.train.state import named_stats, set_stats

from tests.test_torch_common import one_thread  # noqa: F401
from tests.test_torch_common import (
    CT_LEN,
    NUM_PTS,
    WINDOW,
    perturb_batch_stats,
    t2n,
    to_jax,
)
from tests.test_torch_train import _cast_tree, bf16_bar, f32_bar

CHUNK, D_FEAT, S_SCANS = 16, 48, 3


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


def _gate_pair(chunk=CHUNK):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, NUM_PTS, D_FEAT)).astype(np.float32)
    t = rng.normal(size=(2, NUM_PTS, D_FEAT)).astype(np.float32)
    jm = JaxGate(window_size=WINDOW, banded_chunk=chunk)
    v_np = perturb_batch_stats(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                train=False), rng)
    port = SpatialAttentionGate(D_FEAT, 0.5, WINDOW, chunk,
                                generator=torch.Generator().manual_seed(0))
    port.load_state_dict(variables_to_state_dict(v_np, port), strict=True)
    return jm, v_np, port, x, t


def test_chunk_plan_matches_jax():
    for ct, window, chunk in ((64, 5, 16), (450, 11, 45), (48, 7, 48)):
        for got, ref in zip(_chunk_plan(ct, window, chunk),
                            jax_chunk_plan(ct, window, chunk)):
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("train", [False, True])
def test_banded_gate_matches_jax(train):
    jm, v_np, port, x, t = _gate_pair()
    args = (jnp.asarray(x), jnp.asarray(t))
    if train:
        ref, mut = jm.apply(to_jax(v_np), *args, train=True,
                            mutable=["batch_stats"])
        ref_stats = variables_to_state_dict(
            {"params": v_np["params"],
             "batch_stats": jax.device_get(mut["batch_stats"])}, port)
    else:
        ref = jm.apply(to_jax(v_np), *args, train=False)
    got = port(torch.from_numpy(x), torch.from_numpy(t), train)
    for g, r, what in zip(got, ref, ("new_template", "sim_band")):
        f32_bar(t2n(g), np.asarray(r), 1e-4, what)
    if train:
        for n, s in named_stats(port).items():
            f32_bar(t2n(s), t2n(ref_stats[n]), 1e-4, n)


def test_banded_gate_bf16_matches_jax():
    jm, v_np, port, x, t = _gate_pair()
    cast = {c: _cast_tree(to_jax(v_np[c]), jnp.bfloat16)
            for c in ("params", "batch_stats")}
    set_stats(port, {n: s.bfloat16() for n, s in named_stats(port).items()})
    ref = jm.apply(cast, jnp.asarray(x, jnp.bfloat16),
                   jnp.asarray(t, jnp.bfloat16), train=False)
    got = port(torch.from_numpy(x).bfloat16(), torch.from_numpy(t).bfloat16())
    for g, r, what in zip(got, ref, ("new_template", "sim_band")):
        assert g.dtype == torch.bfloat16
        bf16_bar(t2n(g), np.asarray(r, np.float32), what)


def test_banded_gate_equals_the_dense_gate():
    """At the flagship's 450 cutouts, window 11, chunks of 45 (``[fc]``'s
    working point): the banded form within 1e-4 of the port's dense form,
    and a chunk that does not divide the cutouts the dense form itself."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 450, 64)).astype(np.float32))
    t = torch.from_numpy(rng.normal(size=(2, 450, 64)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    dense = SpatialAttentionGate(64, 0.5, 11, generator=gen)
    for chunk, exact in ((45, False), (50, False), (40, True)):
        banded = SpatialAttentionGate(64, 0.5, 11, chunk, generator=gen)
        banded.load_state_dict(dense.state_dict())
        for g, r in zip(banded(x, t), dense(x, t)):
            if exact:
                assert torch.equal(g, r)
            else:
                f32_bar(t2n(g), t2n(r), 1e-4, f"chunk {chunk}")


@pytest.fixture(scope="module")
def flow_variables():
    """(inputs, numpy variables of JAX's banded FlowDrow with perturbed
    statistics): one init serves both models, the detector's variables
    being its ``dr_spaam`` subtree."""
    rng = np.random.default_rng(2)
    x = rng.normal(0.0, 0.5, (2, NUM_PTS, S_SCANS, CT_LEN)).astype(np.float32)
    cur = rng.uniform(0.5, 10.0, (2, NUM_PTS)).astype(np.float32)
    jm = jax_get_model(_model_cfg("flow_drow"))
    v_np = perturb_batch_stats(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(cur),
                train=False), rng)
    return (x, cur), v_np


def _model_cfg(mtype):
    return {"type": mtype, "window_size": WINDOW, "pedestrian_only": True,
            "banded_chunk": CHUNK, "freeze_detector": False}


@pytest.mark.parametrize("mtype", ["dr-spaam", "flow_drow"])
def test_banded_models_match_jax(mtype, flow_variables):
    """``SpatialDrow`` and ``FlowDrow`` built by the registry with
    ``banded_chunk`` against JAX's, eval and train mode (the detector's
    statistics advance in JAX's order: each gate step's embedding before
    the branch)."""
    (x, cur), v_np = flow_variables
    if mtype == "dr-spaam":
        args = (x,)
        v_np = {c: v_np[c]["dr_spaam"] for c in ("params", "batch_stats")}
    else:
        args = (x, cur)
    jm = jax_get_model(_model_cfg(mtype))
    jargs = tuple(jnp.asarray(a) for a in args)
    port = get_model(_model_cfg(mtype), num_cutout_pts=CT_LEN)
    det = port.dr_spaam if mtype == "flow_drow" else port
    assert det.gate.banded_chunk == CHUNK
    port.load_state_dict(variables_to_state_dict(v_np, port), strict=True)
    targs = tuple(torch.from_numpy(a) for a in args)
    for train in (False, True):
        if train:
            ref, mut = jm.apply(to_jax(v_np), *jargs, train=True,
                                mutable=["batch_stats"])
            ref_stats = variables_to_state_dict(
                {"params": v_np["params"],
                 "batch_stats": jax.device_get(mut["batch_stats"])}, port)
        else:
            ref = jm.apply(to_jax(v_np), *jargs, train=False)
        got = port(*targs, train=train)
        for i, (g, r) in enumerate(zip(got, ref)):
            f32_bar(t2n(g), np.asarray(r), 1e-4, f"output {i} train={train}")
        if train:
            for n, s in named_stats(port).items():
                f32_bar(t2n(s), t2n(ref_stats[n]), 1e-4, n)
