"""The port's unfused int8 serving configurations against the JAX ones, on
the CPU: ``precision="int8"`` (int8 conv stacks, bf16 carry), int8c
``layout="flat"`` and ``"pm"``, and int8c ``p2_l1_mode="repack"``.

* ``backbone_layer1(out_scale=)`` against JAX's: int8 within 1 LSB with
  under 5e-3 of the elements off by one (``tests/test_fast_gate.py``'s
  bar): XLA's CPU backend divides by the constant scale through its
  reciprocal, the port divides;
* K10's plain version against ``fused_backbone_int8`` (int8 and bf16
  feats, ``conv_mode`` "cat" and "3mm"), K7's against ``fused_head_int8``,
  K6's against ``gate_fused_int8`` (K11), K9's against
  ``fused_backbone_int8_pm(layer1_weights=...)`` and
  ``fused_backbone_int8_p2(l1_mode="repack")``, in interpret mode: int8 as
  above, bf16 feats, cls and reg within 2e-2 x max|JAX|, zx and z at 2e-2,
  sim at 1e-5; K9's plain version equal to the bit to layer 1 + K10's;
* the row-shift check (K16) against ``check_byte_shift``'s expectation;
* the calibration scales of ``"flat"`` and ``"pm"`` against JAX's (1e-5
  relative), also at 50 beams, where ``"flat"`` pads to 56 beams and
  ``"pm"`` to 64 (``pm_tile=32``);
* each step against its JAX step over 3 steps on the JAX calibration: int8
  templates within 1 LSB (share < 5e-3), the bf16 template of ``"int8"``,
  z and the outputs at rtol/atol 5e-2 (``tests/test_int8_serving_gate.py``),
  the same NMS on identical inputs;
* the port's int8c ``"flat"`` and ``"pm"`` steps equal on the valid rows;
* each step against the port's module engine: correlation > 0.96
  (``"int8"``) and > 0.95 (int8c) on ``pred_cls`` and ``pred_flow``
  (``tests/test_fast_gate.py:217,258``).

Geometry as ``tests/test_torch_int8.py``: 64 beams, 16 points, window 5,
B=2, JAX at ``pm_tile=32`` and ``tile=16``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.infer import fast_gate as jfg
from planar_optical_flow_tpu.infer.calibration import (
    calibrate_serve_v3 as jax_calibrate,
)
from planar_optical_flow_tpu.infer.streaming import (
    make_serve_step_v3 as jax_v3,
)
from planar_optical_flow_tpu.ops.geometry import get_laser_phi
from planar_optical_flow_tpu.ops.pallas import conv_stack as jcs
from planar_optical_flow_tpu.ops.pallas.fused_drow import _block_params
from planar_optical_flow_tpu_torch.infer.calibration import (
    ServeCalibration,
    calibrate_serve_v3,
)
from planar_optical_flow_tpu_torch.infer.fast_gate import gate_int8
from planar_optical_flow_tpu_torch.infer.streaming import (
    make_serve_step_v3,
    make_stream_step,
)
from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs
from planar_optical_flow_tpu_torch.ops.kernels import fold, quant
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout
from planar_optical_flow_tpu_torch.ops.nms import nms_predicted_center_topk
from tests.test_torch_common import (
    CT_LEN,
    CUTOUT_KW,
    NUM_PTS,
    WINDOW,
    assert_close_to_max,
    flow_drow_pair,
    t2n,
    to_jax,
)
from tests.test_torch_int8 import (
    BF16_REL,
    FIELDS,
    STEP_TOL,
    TILE,
    _assert_same_scales,
    _det_vars,
    _scans,
    assert_int8_close,
    pm_to_port,
)

L4 = CT_LEN // 4
JAX_TILE = 16  # the JAX cutout-major kernels' block
CONFIGS = {
    "int8": dict(precision="int8", layout="flat"),
    "flat": dict(precision="int8c", layout="flat"),
    "pm": dict(precision="int8c", layout="pm"),
    "repack": dict(precision="int8c", layout="p2", p2_l1_mode="repack"),
}


@pytest.fixture(scope="module")
def setup():
    """The model pair and one JAX calibration (an int8c flat step's: at 64
    beams every configuration pads to 64, so they share it); the JAX
    steps are built on first use."""
    model, v_np, port = flow_drow_pair(seed=3)
    variables = to_jax(v_np)
    calib_scans = _scans(40, steps=1)[0]
    jc = jax_calibrate(model, variables, CUTOUT_KW, calib_scans,
                       num_pts=NUM_PTS, precision="int8c", layout="flat",
                       pm_tile=TILE, tile=JAX_TILE, interpret=True)
    return dict(model=model, v_np=v_np, variables=variables, port=port,
                calib=jc, steps={})


def _jax_step(setup, name):
    if name not in setup["steps"]:
        setup["steps"][name] = jax_v3(
            setup["model"], setup["variables"], CUTOUT_KW,
            calib=setup["calib"], num_pts=NUM_PTS, pm_tile=TILE,
            tile=JAX_TILE, interpret=True, **CONFIGS[name])
    return setup["steps"][name]


def _port_calib(setup):
    return ServeCalibration.from_dict(setup["calib"].to_dict())


def _cutouts(seed):
    scans = torch.from_numpy(_scans(seed, steps=1)[0])
    return cutout(scans, num_cutout_pts=CT_LEN, window_width=1.0,
                  window_depth=0.5, padding_val=29.99, centered=True,
                  area_mode=True)  # (2*64, 16) real cutouts


def _stack_weights(setup, int8_feats, concat_taps=True):
    """JAX and port weights of the backbone tail at the JAX calibration:
    (JAX flat list, port kernel layers, JAX embed, port embed, layer 1
    (JAX, port), in_scale)."""
    jc, v_np, det = setup["calib"], setup["v_np"], setup["port"].dr_spaam
    bb = _det_vars(v_np, "backbone")
    jblocks = _block_params(bb, "block1", 3) + _block_params(bb, "block2", 3)
    bb_q, in_scale, feat_scale = jcs.quantize_stack_int8(
        jblocks[1:], None, CT_LEN, pool_after={1, 4},
        in_scale=jc.bb_in_scale, act_scales=jc.bb_act_scales,
        dequant_last=not int8_feats, concat_taps=concat_taps)
    blocks = fold.backbone_blocks(det.backbone)
    q, _, _ = quant.quantize_stack_int8(
        blocks[1:], None, pool_after={1, 4}, in_scale=jc.bb_in_scale,
        act_scales=jc.bb_act_scales, dequant_last=not int8_feats)
    gp_j = jfg.fold_gate_params(_det_vars(v_np, "gate"), alpha=0.5,
                                window_size=WINDOW, dtype=jnp.bfloat16)
    gp = fold.fold_gate_params(det.gate, dtype=torch.bfloat16)
    we_j, we = gp_j.w, gp.w
    if int8_feats:
        we_j = gp_j.w * float(feat_scale)
        we = gp.w * torch.tensor(float(feat_scale), dtype=torch.bfloat16)
    return dict(
        jax=bb_q, port=quant.kernel_stack_weights(q, "cpu"),
        embed_j=(we_j, gp_j.b), embed=(we.t().contiguous(), gp.b),
        layer1_j=(jblocks[0][0][:, 0, :], jblocks[0][1].reshape(1, -1)),
        layer1=(blocks[0][0].reshape(3, -1), blocks[0][1]),
        in_scale=in_scale)


# ------------------------------------------------------------ the kernels


def test_backbone_layer1_out_scale_matches_jax(setup):
    w = _stack_weights(setup, True)
    cut = _cutouts(50)
    bb = _det_vars(setup["v_np"], "backbone")
    ref = jcs.backbone_layer1(jnp.asarray(t2n(cut)),
                              _block_params(bb, "block1", 3)[0],
                              out_scale=w["in_scale"])
    got = cs.backbone_layer1(cut, w["layer1"], out_scale=w["in_scale"])
    assert got.dtype == torch.int8 and got.shape == (cut.shape[0] * CT_LEN, 64)
    assert_int8_close(got.numpy(), np.asarray(ref), "act1")
    # the same activation in f32, divided, is what was rounded
    f32 = cs.backbone_layer1(cut, w["layer1"], compute_dtype=torch.float32)
    assert torch.equal(got, cs._requant(f32 / torch.tensor(w["in_scale"])))


@pytest.mark.parametrize("conv_mode", ["cat", "3mm"])
@pytest.mark.parametrize("int8_feats", [True, False])
def test_backbone_int8_tail_plain_matches_pallas(setup, int8_feats,
                                                 conv_mode):
    w = _stack_weights(setup, int8_feats, concat_taps=conv_mode == "cat")
    act1 = cs.backbone_layer1(_cutouts(51), w["layer1"],
                              out_scale=w["in_scale"])
    out_dtype = torch.int8 if int8_feats else torch.bfloat16
    feats_j, zx_j = jcs.fused_backbone_int8(
        jnp.asarray(act1.numpy()), w["jax"], l=CT_LEN, tile=JAX_TILE,
        out_dtype=jnp.int8 if int8_feats else jnp.bfloat16,
        embed_weights=w["embed_j"], conv_mode=conv_mode, interpret=True)
    feats, zx = cs.backbone_int8_tail(act1, w["port"], w["embed"], l=CT_LEN,
                                      out_dtype=out_dtype)
    assert feats.dtype == out_dtype and zx.dtype == torch.bfloat16
    if int8_feats:
        assert_int8_close(feats.numpy(), np.asarray(feats_j), "feats")
    else:
        assert_close_to_max(t2n(feats), np.asarray(feats_j, np.float32),
                            BF16_REL, "feats")
    np.testing.assert_allclose(t2n(zx), np.asarray(zx_j, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_backbone_int8_pm_plain_matches_pallas(setup):
    """K9 against both JAX forms (bit-identical to each other in JAX), and
    against layer 1 + K10 in the port, to the bit."""
    w = _stack_weights(setup, True)
    cut = _cutouts(52)
    cut_j = jnp.asarray(t2n(cut))
    kw = dict(l=CT_LEN, tile=TILE, out_dtype=jnp.int8,
              embed_weights=w["embed_j"], in_scale=w["in_scale"],
              interpret=True)
    pm_j = jcs.fused_backbone_int8_pm(cut_j, w["jax"],
                                      layer1_weights=w["layer1_j"], **kw)
    p2_j = jcs.fused_backbone_int8_p2(cut_j, jcs.pack2_backbone_weights(
        w["jax"]), w["layer1_j"], l1_mode="repack", **kw)
    for a, b in zip(pm_j, p2_j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    feats, zx = cs.backbone_int8_pm(cut, w["layer1"], w["port"], w["embed"],
                                    l=CT_LEN, in_scale=w["in_scale"])
    assert feats.dtype == torch.int8 and zx.dtype == torch.bfloat16
    assert_int8_close(feats.numpy().reshape(-1, L4 * 256), pm_to_port(pm_j[0]),
                      "feats")
    np.testing.assert_allclose(t2n(zx), np.asarray(pm_j[1], np.float32),
                               rtol=2e-2, atol=2e-2)
    act1 = cs.backbone_layer1(cut, w["layer1"], out_scale=w["in_scale"])
    feats10, zx10 = cs.backbone_int8_tail(act1, w["port"], w["embed"],
                                          l=CT_LEN)
    assert torch.equal(feats, feats10) and torch.equal(zx, zx10)


@pytest.mark.parametrize("conv_mode", ["cat", "3mm"])
def test_head_int8_plain_matches_fused_head_int8(setup, conv_mode):
    """K10's head is K7's function on the same cutout-major rows."""
    jc, v_np, det = setup["calib"], setup["v_np"], setup["port"].dr_spaam
    hd = _det_vars(v_np, "head")
    hd_q, _, _ = jcs.quantize_stack_int8(
        _block_params(hd, "block3", 3) + _block_params(hd, "block4", 2),
        None, L4, pool_after={2}, in_scale=jc.hd_in_scale,
        act_scales=jc.hd_act_scales, concat_taps=conv_mode == "cat")
    q, _, _ = quant.quantize_stack_int8(
        fold.head_conv_blocks(det.head), None, pool_after={2},
        in_scale=jc.hd_in_scale, act_scales=jc.hd_act_scales)
    rng = np.random.default_rng(53)
    tmpl = rng.integers(-127, 128, (40 * L4, 256)).astype(np.int8)
    cls_j, reg_j = jcs.fused_head_int8(
        jnp.asarray(tmpl), hd_q, jcs.head_stack_weights(hd)[1],
        num_classes=1, l4=L4, tile=JAX_TILE, conv_mode=conv_mode,
        interpret=True)
    cls, reg = cs.head_int8(torch.from_numpy(tmpl),
                            quant.kernel_stack_weights(q, "cpu"),
                            fold.head_linear_weights(det.head),
                            num_classes=1, l4=L4)
    assert_close_to_max(t2n(cls), np.asarray(cls_j), BF16_REL, "cls")
    assert_close_to_max(t2n(reg), np.asarray(reg_j), BF16_REL, "reg")


@pytest.mark.parametrize("boot", [True, False])
def test_gate_int8_plain_matches_gate_fused_int8(boot):
    """K11, the cutout-major gate, is K6's function; ct_valid < ct
    exercises the dead padding rows."""
    rng = np.random.default_rng(54 + boot)
    s, ct, ct_valid, d = 2, 64, 60, L4 * 256
    n = s * ct

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)

    zx, zt = bf(rng.normal(size=(n, 128))), bf(rng.normal(size=(n, 128)))
    x = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8))
    t = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8))
    kw = dict(alpha=0.5, window_size=WINDOW, s_x=0.11, s_t=0.17, s_out=0.13,
              ct_valid=ct_valid)
    if boot:
        zt, t, kw["s_t"] = zx, x, kw["s_x"]
    ref = jfg.gate_fused_int8(
        jnp.asarray(t2n(zx), jnp.bfloat16), jnp.asarray(t2n(zt), jnp.bfloat16),
        jnp.asarray(x.numpy()), jnp.asarray(t.numpy()), ct=ct,
        interpret=True, **kw)
    new_t, new_z, sim = gate_int8(zx, zt, x, t, ct=ct, **kw)
    assert_int8_close(new_t.numpy(), np.asarray(ref[0]), "new_t")
    np.testing.assert_allclose(t2n(new_z), np.asarray(ref[1], np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(t2n(sim), np.asarray(ref[2]), rtol=1e-5,
                               atol=1e-5)


def test_row_shift_check(monkeypatch):
    """K16's plain version gives ``check_byte_shift``'s expectation on its
    pattern (JAX's own check passes too); a wrong result raises, a right
    one is cached per device."""
    jcs.check_byte_shift(interpret=True)
    x, l, exp_left, exp_right = cs.row_shift_pattern()
    ref = ((np.arange(8 * 128).reshape(8, 128) * 37 + 11) % 251 - 125)
    np.testing.assert_array_equal(x, ref.astype(np.int8))
    pos = np.arange(8) % 4
    np.testing.assert_array_equal(
        exp_left, np.where((pos == 0)[:, None], 0, np.roll(x, 1, axis=0)))
    np.testing.assert_array_equal(
        exp_right, np.where((pos == 3)[:, None], 0, np.roll(x, -1, axis=0)))
    left, right = cs.row_shift(torch.from_numpy(x), l=l)
    np.testing.assert_array_equal(left.numpy(), exp_left)
    np.testing.assert_array_equal(right.numpy(), exp_right)

    monkeypatch.setattr(cs, "_ROW_SHIFT_OK", set())
    cs.check_row_shift("cpu")
    assert cs._ROW_SHIFT_OK == {"cpu"}
    monkeypatch.setattr(cs, "_ROW_SHIFT_OK", set())
    monkeypatch.setattr(cs, "row_shift",
                        lambda t, l: (t, torch.roll(t, -1, 0)))
    with pytest.raises(RuntimeError, match="row-shift self-check failed"):
        cs.check_row_shift("cpu")
    assert not cs._ROW_SHIFT_OK


@pytest.mark.parametrize("name", [*CONFIGS, "p2"])
def test_every_int8_step_runs_row_shift_check(setup, name, monkeypatch):
    """Every int8 conv reads its taps through the address K16 checks, so
    building any int8 configuration runs the check, whichever
    ``int8_conv_mode``; a failed check stops the build."""
    opts = CONFIGS.get(name, dict(precision="int8c", layout="p2"))
    kw = dict(calib=_port_calib(setup), num_pts=NUM_PTS, pm_tile=TILE,
              int8_conv_mode="3mm", device="cpu", **opts)
    real = cs.row_shift
    monkeypatch.setattr(cs, "_ROW_SHIFT_OK", set())
    monkeypatch.setattr(cs, "row_shift",
                        lambda t, l: (t, torch.roll(t, -1, 0)))
    with pytest.raises(RuntimeError, match="row-shift self-check failed"):
        make_serve_step_v3(setup["port"], CUTOUT_KW, **kw)
    monkeypatch.setattr(cs, "row_shift", real)
    make_serve_step_v3(setup["port"], CUTOUT_KW, **kw)
    assert cs._ROW_SHIFT_OK == {"cpu"}


# ------------------------------------------------------------- calibration


@pytest.mark.parametrize("num_pts", [NUM_PTS, 50])
@pytest.mark.parametrize("layout", ["flat", "pm"])
def test_calibration_scales_match_jax(setup, layout, num_pts):
    """At 50 beams ``"flat"`` calibrates on 56 beams and ``"pm"`` on 64
    (``pm_tile=32``), as in JAX."""
    scans = _scans(55, steps=1, num_pts=num_pts)[0]
    scans[1, 7] = np.nan  # both sanitize before calibrating
    kw = dict(num_pts=num_pts, pm_tile=TILE, precision="int8c",
              layout=layout)
    ref = jax_calibrate(setup["model"], setup["variables"], CUTOUT_KW, scans,
                        tile=JAX_TILE, interpret=True, **kw)
    got = calibrate_serve_v3(setup["port"], CUTOUT_KW, scans, device="cpu",
                             **kw)
    _assert_same_scales(got, ref)


# --------------------------------------------------------------- the steps


@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_matches_jax(setup, name):
    """3 steps of the port's step against JAX's, both on the JAX
    calibration."""
    ref_step = _jax_step(setup, name)
    step = make_serve_step_v3(setup["port"], CUTOUT_KW,
                              calib=_port_calib(setup), num_pts=NUM_PTS,
                              pm_tile=TILE, device="cpu", **CONFIGS[name])
    phi = torch.as_tensor(get_laser_phi(num_pts=NUM_PTS), dtype=torch.float32)
    carry_j, carry = None, None
    for i, scan in enumerate(_scans(56)):
        if i == 1:
            scan[1, 9] = np.nan  # the sanitize guard is on in both
        carry_j, ref = ref_step(carry_j, jnp.asarray(scan))
        carry, got = step(carry, torch.from_numpy(scan))
        assert set(got) == set(ref)
        tmpl_j = np.asarray(carry_j["template"])
        if name == "int8":
            assert carry["template"].dtype == torch.bfloat16
            np.testing.assert_allclose(t2n(carry["template"]),
                                       tmpl_j.astype(np.float32),
                                       err_msg=f"step {i} template",
                                       **STEP_TOL)
        else:
            assert carry["template"].dtype == torch.int8
            if name != "flat":
                tmpl_j = pm_to_port(tmpl_j)
            assert_int8_close(carry["template"].numpy(), tmpl_j,
                              f"step {i} template")
        np.testing.assert_allclose(t2n(carry["z"]),
                                   np.asarray(carry_j["z"], np.float32),
                                   err_msg=f"step {i} z", **STEP_TOL)
        for k in FIELDS:
            np.testing.assert_allclose(t2n(got[k]), np.asarray(ref[k]),
                                       err_msg=f"step {i} {k}", **STEP_TOL)
        # the same NMS on identical inputs: the JAX step's predictions
        clean = np.nan_to_num(scan, nan=CUTOUT_KW["padding_val"])
        res = nms_predicted_center_topk(
            torch.from_numpy(clean), phi,
            torch.tensor(np.asarray(ref["pred_cls"])),
            torch.tensor(np.asarray(ref["pred_reg"])), top_k=64)
        np.testing.assert_array_equal(t2n(res[2]).astype(bool),
                                      np.asarray(ref["det_keep"]))
        np.testing.assert_array_equal(t2n(res[3]),
                                      np.asarray(ref["instance_mask"]))


def test_flat_and_pm_steps_equal(setup):
    """int8c ``"flat"`` (layer 1 + K10, 56 rows a stream at 50 beams) and
    ``"pm"`` (K9, 64 rows) from one calibration: the same valid rows and
    outputs, to the bit."""
    num_pts, port = 50, setup["port"]
    scans = _scans(57, num_pts=num_pts)
    calib = calibrate_serve_v3(port, CUTOUT_KW, scans[0], num_pts=num_pts,
                               pm_tile=TILE, device="cpu")
    kw = dict(calib=calib, num_pts=num_pts, pm_tile=TILE, precision="int8c",
              nms_top_k=32, device="cpu")  # top-k needs k <= beams
    flat = make_serve_step_v3(port, CUTOUT_KW, layout="flat", **kw)
    pm = make_serve_step_v3(port, CUTOUT_KW, layout="pm", **kw)
    cf = cp = None
    for i, scan in enumerate(scans):
        cf, of = flat(cf, torch.from_numpy(scan))
        cp, op = pm(cp, torch.from_numpy(scan))
        assert cf["template"].shape[0] == 2 * 56
        assert cp["template"].shape[0] == 2 * 64
        for k in ("template", "z"):
            a = cf[k].reshape(2, 56, -1)[:, :num_pts]
            b = cp[k].reshape(2, 64, -1)[:, :num_pts]
            assert torch.equal(a, b), (i, k)
        for k in of:
            assert torch.equal(of[k], op[k]), (i, k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_against_module_engine(setup, name):
    """The JAX package's int8-vs-f32 bars, on the port alone."""
    port = setup["port"]
    bar = 0.96 if name == "int8" else 0.95
    scans = _scans(58, steps=4)
    step = make_serve_step_v3(port, CUTOUT_KW, calib_scans=scans[0],
                              num_pts=NUM_PTS, pm_tile=TILE, device="cpu",
                              with_nms=False, **CONFIGS[name])
    ref_step = make_stream_step(port, CUTOUT_KW, NUM_PTS, with_nms=False,
                                device="cpu")
    carry = tmpl = None
    for i, scan in enumerate(scans[1:]):
        carry, got = step(carry, torch.from_numpy(scan))
        tmpl, ref = ref_step(tmpl, torch.from_numpy(scan))
        for k in ("pred_cls", "pred_flow"):
            corr = np.corrcoef(t2n(got[k]).ravel(), t2n(ref[k]).ravel())[0, 1]
            assert corr > bar, (name, i, k, corr)
