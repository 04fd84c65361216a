"""Weight bridge: each port submodule against its flax module, f32."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.models import blocks as jblocks
from planar_optical_flow_tpu.models.blocks import ConvBlock as JaxConvBlock
from planar_optical_flow_tpu.models.drow import DrowBackbone as JaxBackbone
from planar_optical_flow_tpu.models.drow import DrowHead as JaxHead
from planar_optical_flow_tpu.models.spatial_drow import (
    SpatialAttentionGate as JaxGate,
)
from planar_optical_flow_tpu_torch.interop import variables_to_state_dict
from planar_optical_flow_tpu_torch.models import ConvBlock, FlowDrow
from planar_optical_flow_tpu_torch.models import blocks
from tests.test_torch_common import (
    CT_LEN,
    NUM_PTS,
    WINDOW,
    flow_drow_pair,
    t2n,
    to_jax,
)

TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def pair():
    return flow_drow_pair(seed=0)


def _sub(v_np, *path):
    out = {}
    for coll in ("params", "batch_stats"):
        t = v_np[coll]
        for p in path:
            t = t[p]
        out[coll] = t
    return out


def test_conv_block_matches_flax(pair):
    _, v_np, port = pair
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 20, WINDOW + 1)).astype(np.float32)
    ref = JaxConvBlock(128, 3).apply(to_jax(_sub(v_np, "flow_conv1")),
                                     jnp.asarray(x), train=False)
    got = port.flow_conv1(torch.from_numpy(x))
    np.testing.assert_allclose(t2n(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("length", [14, 15])
def test_pools_match_flax(length):
    """Channels-last pools; an odd length drops its tail (VALID)."""
    x = np.random.default_rng(5).normal(size=(3, length, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(
        t2n(blocks.max_pool1d(torch.from_numpy(x))),
        np.asarray(jblocks.max_pool1d(jnp.asarray(x))))
    np.testing.assert_allclose(
        t2n(blocks.avg_pool_full(torch.from_numpy(x))),
        np.asarray(jblocks.avg_pool_full(jnp.asarray(x))), rtol=1e-6,
        atol=1e-6)


def test_backbone_and_head_match_flax(pair):
    _, v_np, port = pair
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, CT_LEN, 1)).astype(np.float32)
    ref = JaxBackbone().apply(to_jax(_sub(v_np, "dr_spaam", "backbone")),
                              jnp.asarray(x), train=False)
    got = port.dr_spaam.backbone(torch.from_numpy(x))
    np.testing.assert_allclose(t2n(got), np.asarray(ref), **TOL)

    f = rng.normal(size=(5, CT_LEN // 4, 256)).astype(np.float32)
    cls_ref, reg_ref = JaxHead(num_classes=1).apply(
        to_jax(_sub(v_np, "dr_spaam", "head")), jnp.asarray(f), train=False)
    cls, reg = port.dr_spaam.head(torch.from_numpy(f))
    np.testing.assert_allclose(t2n(cls), np.asarray(cls_ref), **TOL)
    np.testing.assert_allclose(t2n(reg), np.asarray(reg_ref), **TOL)


def test_gate_matches_flax(pair):
    _, v_np, port = pair
    rng = np.random.default_rng(3)
    d = (CT_LEN // 4) * 256
    x = rng.normal(size=(2, NUM_PTS, d)).astype(np.float32)
    t = rng.normal(size=(2, NUM_PTS, d)).astype(np.float32)
    t_ref, s_ref = JaxGate(window_size=WINDOW).apply(
        to_jax(_sub(v_np, "dr_spaam", "gate")), jnp.asarray(x),
        jnp.asarray(t), train=False)
    t_got, s_got = port.dr_spaam.gate(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(t2n(t_got), np.asarray(t_ref), **TOL)
    np.testing.assert_allclose(t2n(s_got), np.asarray(s_ref), **TOL)


def test_flow_head_matches_flax(pair):
    model, v_np, port = pair
    rng = np.random.default_rng(4)
    sim = rng.normal(size=(2, NUM_PTS, WINDOW)).astype(np.float32)
    scan = rng.uniform(0.5, 20.0, (2, NUM_PTS)).astype(np.float32)
    ref = model.apply(to_jax(v_np), jnp.asarray(sim), jnp.asarray(scan),
                      method=lambda m, s, c: m._flow_head(s, c, train=False))
    got = port.flow_head(torch.from_numpy(sim), torch.from_numpy(scan))
    np.testing.assert_allclose(t2n(got), np.asarray(ref), **TOL)


def test_bridge_layout_and_errors(pair):
    _, v_np, _ = pair
    sub = _sub(v_np, "flow_conv2")
    block = ConvBlock(128, 64, 3, generator=torch.Generator().manual_seed(0))
    sd = variables_to_state_dict(sub, block)
    kernel = sub["params"]["Conv_0"]["kernel"]  # (K, Cin, Cout)
    np.testing.assert_array_equal(sd["conv.weight"].numpy(),
                                  kernel.transpose(2, 1, 0))
    np.testing.assert_array_equal(sd["bn.running_var"].numpy(),
                                  sub["batch_stats"]["BatchNorm_0"]["var"])

    missing = {"params": dict(sub["params"]), "batch_stats": {}}
    with pytest.raises(KeyError, match="lack"):
        variables_to_state_dict(missing, block)
    extra = {"params": dict(sub["params"], Extra_0={"kernel": kernel}),
             "batch_stats": sub["batch_stats"]}
    with pytest.raises(KeyError, match="does not have"):
        variables_to_state_dict(extra, block)
    wrong = FlowDrow(window_size=WINDOW, pedestrian_only=True,
                     num_cutout_pts=2 * CT_LEN)
    with pytest.raises(ValueError, match="shape"):
        variables_to_state_dict(v_np, wrong)
