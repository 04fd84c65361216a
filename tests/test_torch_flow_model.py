"""The port's flow U-Net (``models/flow_unet.py``) against the JAX package's,
on the CPU.

Scan pairs of 64 (and 450) beams, B=2, made from a seed with numpy; the
weights come from flax ``init`` with perturbed BatchNorm statistics,
carried across by the flax bridge. Bars: the correlation volume and the
patches f32 1e-5 of the largest value; the models f32 1e-3 of the largest
output (STATUS.md parity), in eval and in train mode with the running
statistics; in bf16 JAX's bf16 bar (``tests/test_torch_train.py
bf16_bar``). The LeakyReLU at the U-Net's slope 0.01 is equal to flax's
to the bit in f32 and bf16.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.models import flow_unet as jax_flow
from planar_optical_flow_tpu.models import get_model as jax_get_model
from planar_optical_flow_tpu.models.blocks import ConvBlock as JaxConvBlock
from planar_optical_flow_tpu_torch.interop import variables_to_state_dict
from planar_optical_flow_tpu_torch.models import (
    FLOW_MODEL_TYPES,
    flow_unet,
    get_model,
)
from planar_optical_flow_tpu_torch.models.blocks import ConvBlock, leaky_relu
from planar_optical_flow_tpu_torch.train.state import named_stats, set_stats

from tests.test_torch_common import one_thread  # noqa: F401
from tests.test_torch_common import perturb_batch_stats, t2n, to_jax
from tests.test_torch_train import (
    _cast_tree,
    bf16_bar,
    bf16_ulp_of_max,
    f32_bar,
)

NUM_PTS, BATCH = 64, 2
TYPES = [("flow_unet", False), ("flow_unet", True), ("prototype_test", False)]


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


def _cfg(mtype, linear_head):
    return {"type": mtype, "linear_head": linear_head}


def flow_pair(mtype="flow_unet", linear_head=False, num_pts=NUM_PTS, seed=0):
    """(flax model, numpy variables with perturbed BN statistics, the
    port's model carrying the same weights)."""
    jm = jax_get_model(_cfg(mtype, linear_head))
    x = jnp.zeros((1, num_pts, 2))
    variables = jm.init(jax.random.PRNGKey(seed), x, x, train=False)
    v_np = perturb_batch_stats(variables, np.random.default_rng(seed + 100))
    port = get_model(_cfg(mtype, linear_head))
    port.load_state_dict(variables_to_state_dict(v_np, port), strict=True)
    return jm, v_np, port


def scan_pairs(num_pts=NUM_PTS, batch=BATCH, seed=1):
    """Two ``(B, P, 2)`` xy scans: a wall at 2-8 m and its shifted copy."""
    rng = np.random.default_rng(seed)
    phi = np.linspace(-1.96, 1.96, num_pts)
    r = rng.uniform(2.0, 8.0, (batch, 1)) + rng.normal(0, 0.3,
                                                      (batch, num_pts))
    xy = np.stack([r * np.cos(phi), r * np.sin(phi)], -1)
    shift = rng.normal(0, 0.1, (batch, 1, 2))
    return xy.astype(np.float32), (xy + shift).astype(np.float32)


# ------------------------------------------------------------ correlation


@pytest.mark.parametrize("num_pts", [15, 16])
@pytest.mark.parametrize("max_disp", [2, 5])
def test_correlation_matches_jax(num_pts, max_disp):
    """``_patch_features`` and ``correlation_cost_volume`` at odd and even
    P: f32 within 1e-5 of the largest value."""
    rng = np.random.default_rng(num_pts + max_disp)
    f1 = rng.normal(size=(BATCH, num_pts, 24)).astype(np.float32)
    f2 = rng.normal(size=(BATCH, num_pts, 24)).astype(np.float32)
    np.testing.assert_array_equal(
        t2n(flow_unet._patch_features(torch.from_numpy(f1))),
        np.asarray(jax_flow._patch_features(jnp.asarray(f1))))
    got = flow_unet.correlation_cost_volume(
        torch.from_numpy(f1), torch.from_numpy(f2), max_disp)
    ref = np.asarray(jax_flow.correlation_cost_volume(
        jnp.asarray(f1), jnp.asarray(f2), max_disp))
    assert got.shape == (BATCH, num_pts, 2 * max_disp + 1)
    f32_bar(t2n(got), ref, 1e-5, "cost volume")


# ------------------------------------------------------------------ blocks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaky_slope_and_conv_block_match_flax(dtype):
    """LeakyReLU at slope 0.01 equal to flax's to the bit (the slope rounded
    to the input's dtype); a ConvBlock at that slope against flax's in eval
    and train mode (f32 1e-5, bf16 one ulp of the max: the conv sums in
    another order)."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(3)
    y = rng.normal(0, 4, (4096,)).astype(np.float32)
    got = leaky_relu(torch.tensor(y).to(tdt), 0.01)
    ref = fnn.leaky_relu(jnp.asarray(y, jdt), negative_slope=0.01)
    np.testing.assert_array_equal(t2n(got), np.asarray(ref, np.float32))

    x = rng.normal(0.5, 2.0, (3, 20, 8)).astype(np.float32)
    jm = JaxConvBlock(16, 3, 2, 0.01)
    v = perturb_batch_stats(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                    train=False), rng)
    port = ConvBlock(8, 16, 3, 2, generator=torch.Generator().manual_seed(0),
                     negative_slope=0.01)
    port.load_state_dict(variables_to_state_dict(v, port))
    set_stats(port, {n: t.to(tdt) for n, t in named_stats(port).items()})
    check = (bf16_ulp_of_max if dtype == "bfloat16"
             else lambda g, r, w: f32_bar(g, r, 1e-5, w))
    cast = {"params": _cast_tree(v["params"], jdt),
            "batch_stats": _cast_tree(v["batch_stats"], jdt)}
    xin = jnp.asarray(x, jdt)
    check(t2n(port(torch.tensor(x).to(tdt))),
          np.asarray(jm.apply(cast, xin, train=False), np.float32), "eval")
    ref, _ = jm.apply(cast, xin, train=True, mutable=["batch_stats"])
    check(t2n(port(torch.tensor(x).to(tdt), train=True)),
          np.asarray(ref, np.float32), "train")


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("mtype,linear_head", TYPES)
def test_flow_models_match_jax(mtype, linear_head, train):
    """``FlowUNet`` (both heads) and ``FlowUNetAdditive`` in f32: the flow
    within 1e-3 of its largest value; in train mode also every running
    statistic after the forward (the encoders run twice a pair, so their
    statistics advance twice)."""
    jm, v_np, port = flow_pair(mtype, linear_head)
    a, b = scan_pairs()
    if train:
        ref, mut = jm.apply(to_jax(v_np), a, b, train=True,
                            mutable=["batch_stats"])
        ref_stats = variables_to_state_dict(
            {"params": v_np["params"],
             "batch_stats": jax.device_get(mut["batch_stats"])}, port)
    else:
        ref = jm.apply(to_jax(v_np), a, b, train=False)
    got = port(torch.from_numpy(a), torch.from_numpy(b), train=train)
    assert got.shape == (BATCH, NUM_PTS, 2)
    f32_bar(t2n(got), np.asarray(ref), 1e-3, "flow")
    if train:
        for n, t in named_stats(port).items():
            f32_bar(t2n(t), t2n(ref_stats[n]), 1e-3, n)


@pytest.mark.parametrize("mtype,linear_head", TYPES)
def test_flow_models_bf16_match_jax(mtype, linear_head):
    """bf16 parameters and statistics (the trainer's compute dtype) and
    bf16 scans, in eval and train mode: JAX's bf16 bar."""
    jm, v_np, port = flow_pair(mtype, linear_head)
    a, b = scan_pairs()
    cast = {"params": _cast_tree(to_jax(v_np["params"]), jnp.bfloat16),
            "batch_stats": _cast_tree(to_jax(v_np["batch_stats"]),
                                      jnp.bfloat16)}
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    ta = torch.from_numpy(a).bfloat16()
    tb = torch.from_numpy(b).bfloat16()
    master = dict(named_stats(port))
    for train in (False, True):
        set_stats(port, {n: t.bfloat16() for n, t in master.items()})
        if train:
            ref, _ = jm.apply(cast, ja, jb, train=True,
                              mutable=["batch_stats"])
        else:
            ref = jm.apply(cast, ja, jb, train=False)
        got = port(ta, tb, train=train)
        assert got.dtype == torch.bfloat16
        bf16_bar(t2n(got), np.asarray(ref, np.float32), f"train={train}")


def test_encode_decode_split_matches_jax():
    """``encode`` gives the decoder's inputs as JAX's does (450 beams: 225,
    113 and 57 points, the torch-style stride-2 padding), and ``decode``
    of them is the forward."""
    jm, v_np, port = flow_pair(num_pts=450)
    a, b = scan_pairs(num_pts=450)
    ref = jm.apply(to_jax(v_np), a, b, train=False,
                   method=jax_flow.FlowUNet.encode)
    got = port.encode(torch.from_numpy(a), torch.from_numpy(b))
    assert [tuple(t.shape) for t in got] == [r.shape for r in ref]
    assert tuple(got[0].shape) == (BATCH, 57, 11)
    assert tuple(got[1].shape) == (BATCH, 113, 128)
    assert tuple(got[2].shape) == (BATCH, 225, 64)
    for g, r, what in zip(got, ref, ("cost", "f1_1", "f1_0", "scan1")):
        f32_bar(t2n(g), np.asarray(r), 1e-3, what)
    out = port.decode(*got)
    f32_bar(t2n(out), t2n(port(torch.from_numpy(a), torch.from_numpy(b))),
            0.0, "decode(encode) is the forward")


# ------------------------------------------------------ registry and bridge


@pytest.mark.parametrize("mtype", FLOW_MODEL_TYPES)
def test_registry_flow_types_take_jax_weights(mtype):
    """Each flow type builds without ``num_cutout_pts``, as JAX's registry
    builds it, and takes its weights with no missing or unused key;
    ``max_displacement`` and ``in_channels`` size the layers."""
    cfg = {"type": mtype, "linear_head": mtype == "prototype",
           "max_displacement": 3, "in_channels": 3}
    jm = jax_get_model(cfg)
    x = jnp.zeros((1, NUM_PTS, 3))
    v_np = perturb_batch_stats(jm.init(jax.random.PRNGKey(0), x, x,
                                       train=False),
                               np.random.default_rng(1))
    port = get_model(cfg)
    assert type(port).__name__ == type(jm).__name__
    assert not port.training
    port.load_state_dict(variables_to_state_dict(v_np, port), strict=True)


def test_bridge_raises_on_flow_unet_mismatch():
    """A missing key, an unused key and a wrong shape each raise."""
    _, v_np, port = flow_pair()
    params = dict(v_np["params"])
    del params["decoder_0"]
    with pytest.raises(KeyError, match="lack"):
        variables_to_state_dict(dict(v_np, params=params), port)
    params = dict(v_np["params"], extra={"kernel": np.zeros((1, 2, 3))})
    with pytest.raises(KeyError, match="does not have"):
        variables_to_state_dict(dict(v_np, params=params), port)
    head = get_model({"type": "flow_unet", "linear_head": True})
    with pytest.raises(KeyError):
        variables_to_state_dict(v_np, head)  # flow_reg is not a Linear
    _, v_lin, _ = flow_pair(linear_head=True)
    bad = dict(v_lin["params"], flow_reg_linear={
        "kernel": np.zeros((131, 2), np.float32),
        "bias": np.zeros((2,), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        variables_to_state_dict(dict(v_lin, params=bad), head)
