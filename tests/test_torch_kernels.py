"""K1-K4 plain versions against the JAX Pallas kernels in interpret mode,
and the module-engine cutout against ``ops/cutout.py``."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.infer import fast_gate as jfg
from planar_optical_flow_tpu.ops.cutout import area_s_for
from planar_optical_flow_tpu.ops.cutout import scans_to_cutout as jax_cutout
from planar_optical_flow_tpu.ops.geometry import get_laser_phi
from planar_optical_flow_tpu.ops.pallas import conv_stack as jcs
from planar_optical_flow_tpu.ops.pallas.cutout_kernel import cutout_fused
from planar_optical_flow_tpu_torch.infer.fast_gate import gate
from planar_optical_flow_tpu_torch.ops.cutout import scans_to_cutout
from planar_optical_flow_tpu_torch.ops.kernels import fold
from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
    backbone_layer1,
    backbone_tail,
    head,
)
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout
from tests.test_torch_common import (
    CT_LEN,
    WINDOW,
    assert_close_to_max,
    flow_drow_pair,
    t2n,
    to_jax,
)

BF16_REL = 2e-2  # x max|ref|, bf16 against bf16 (tests/test_fast_gate.py)
CUT_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_cutout_kernel.py


@pytest.fixture(scope="module")
def pair():
    return flow_drow_pair(seed=1)


@pytest.mark.parametrize("area_mode", [False, True])
@pytest.mark.parametrize("num_pts,p_valid", [(64, None), (64, 60)])
def test_cutout_plain_matches_pallas_and_matmul(area_mode, num_pts, p_valid):
    rng = np.random.default_rng(7)
    scans = rng.uniform(0.3, 28.0, (3, num_pts)).astype(np.float32)
    kw = dict(num_cutout_pts=CT_LEN, window_width=1.0, window_depth=0.5,
              padding_val=29.99, centered=True, area_mode=area_mode)
    got = t2n(cutout(torch.from_numpy(scans), p_valid=p_valid, **kw))
    ref = np.asarray(cutout_fused(jnp.asarray(scans), p_valid=p_valid,
                                  interpret=True, **kw))
    np.testing.assert_allclose(got, ref, **CUT_TOL)

    pv = p_valid or num_pts  # the matmul path on the real beams only
    mkw = dict(fixed=True, centered=True, window_width=1.0, window_depth=0.5,
               num_cutout_pts=CT_LEN, padding_val=29.99, area_mode=area_mode,
               area_s=area_s_for(1.0, CT_LEN))
    ref_mm = np.asarray(jax_cutout(jnp.asarray(scans[:, None, :pv]),
                                   get_laser_phi(num_pts=pv),
                                   gather_mode="matmul", **mkw))[:, :, 0]
    got = got.reshape(3, num_pts, CT_LEN)[:, :pv]
    np.testing.assert_allclose(got, ref_mm, **CUT_TOL)


@pytest.mark.parametrize("gather_mode", ["gather", "matmul"])
@pytest.mark.parametrize("area_mode", [False, True])
def test_module_cutout_matches_jax(gather_mode, area_mode):
    rng = np.random.default_rng(8)
    scans = rng.uniform(0.3, 28.0, (2, 1, 64)).astype(np.float32)
    phi = get_laser_phi(num_pts=64)
    kw = dict(fixed=True, centered=True, window_width=1.0, window_depth=0.5,
              num_cutout_pts=CT_LEN, padding_val=29.99, area_mode=area_mode,
              area_s=area_s_for(1.0, CT_LEN), gather_mode=gather_mode)
    ref = np.asarray(jax_cutout(jnp.asarray(scans), phi, **kw))
    got = t2n(scans_to_cutout(torch.from_numpy(scans), phi, **kw))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def _jax_det_vars(v_np, name):
    return to_jax({c: v_np[c]["dr_spaam"][name]
                   for c in ("params", "batch_stats")})


def test_backbone_tail_plain_matches_pallas(pair):
    _, v_np, port = pair
    det = port.dr_spaam
    rng = np.random.default_rng(9)
    n = 24
    cut = rng.normal(0.0, 0.6, (n, CT_LEN)).astype(np.float32)

    layer1_j, tail_j = jcs.backbone_stack_weights(_jax_det_vars(v_np,
                                                                "backbone"))
    gp_j = jfg.fold_gate_params(_jax_det_vars(v_np, "gate"), alpha=0.5,
                                window_size=WINDOW, dtype=jnp.bfloat16)
    act1_j = jcs.backbone_layer1(jnp.asarray(cut), layer1_j)
    feats_j, zx_j = jcs.fused_backbone_v2(
        act1_j, tail_j, l=CT_LEN, tile=16, compute_dtype=jnp.bfloat16,
        conv_mode="3mm", embed_weights=(gp_j.w, gp_j.b), interpret=True)

    layer1, tail = fold.backbone_stack_weights(det.backbone)
    gp = fold.fold_gate_params(det.gate, dtype=torch.bfloat16)
    act1 = backbone_layer1(torch.from_numpy(cut), layer1)
    assert_close_to_max(t2n(act1), np.asarray(act1_j, np.float32), BF16_REL,
                        "act1")
    feats, zx = backbone_tail(act1, tail, (gp.w, gp.b), l=CT_LEN)
    assert feats.dtype == zx.dtype == torch.bfloat16
    assert_close_to_max(t2n(feats),
                        np.asarray(feats_j, np.float32).reshape(-1, 256),
                        BF16_REL, "feats")
    assert_close_to_max(t2n(zx), np.asarray(zx_j, np.float32), BF16_REL,
                        "zx")


def test_head_plain_matches_pallas(pair):
    _, v_np, port = pair
    rng = np.random.default_rng(10)
    n, l4 = 24, CT_LEN // 4
    feats = rng.normal(0.0, 0.5, (n * l4, 256)).astype(np.float32)
    feats_bf = torch.from_numpy(feats).to(torch.bfloat16)
    conv_j, head_j = jcs.head_stack_weights(_jax_det_vars(v_np, "head"))
    cls_j, reg_j = jcs.fused_head_v2(
        jnp.asarray(t2n(feats_bf), jnp.bfloat16), conv_j, head_j,
        num_classes=1, l4=l4, tile=16, conv_mode="3mm", interpret=True)
    conv_w, head_w = fold.head_stack_weights(port.dr_spaam.head)
    cls, reg = head(feats_bf, conv_w, head_w, num_classes=1, l4=l4)
    assert cls.dtype == reg.dtype == torch.float32
    assert_close_to_max(t2n(cls), np.asarray(cls_j), BF16_REL, "cls")
    assert_close_to_max(t2n(reg), np.asarray(reg_j), BF16_REL, "reg")


@pytest.mark.parametrize("boot", [True, False])
def test_gate_plain_matches_pallas(boot):
    """ct_valid < ct exercises the dead padding rows."""
    rng = np.random.default_rng(11 + boot)
    ct, ct_valid, b, d = 64, 60, 2, 1024
    n = b * ct

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)

    zx, zt = bf(rng.normal(size=(n, 128))), bf(rng.normal(size=(n, 128)))
    x, t = bf(rng.normal(size=(n, d))), bf(rng.normal(size=(n, d)))
    if boot:
        zt, t = zx, x
    ref = jfg.gate_fused_flat(*(jnp.asarray(t2n(a), jnp.bfloat16)
                                for a in (zx, zt, x, t)),
                              ct=ct, alpha=0.5, window_size=WINDOW,
                              ct_valid=ct_valid, interpret=True)
    got = gate(zx, zt, x, t, ct=ct, alpha=0.5, window_size=WINDOW,
               ct_valid=ct_valid)
    for name, g, r in zip(("new_t", "new_z", "sim"), got, ref):
        assert_close_to_max(t2n(g), np.asarray(r, np.float32), BF16_REL,
                            name)
    # the reference's edge-clamped duplicates: slots that read the same
    # clamped row hold the same value
    sim = t2n(got[2]).reshape(b, ct, WINDOW)
    hw = WINDOW // 2
    for i in list(range(hw)) + list(range(ct_valid - hw, ct)):
        rows = np.clip(i + np.arange(-hw, hw + 1), 0, ct_valid - 1)
        for r in np.unique(rows):
            vals = sim[:, i, rows == r]
            np.testing.assert_array_equal(vals, vals[:, :1].repeat(
                vals.shape[1], axis=1))
