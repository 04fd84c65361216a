"""The port's int8c engine against the JAX package's, on the CPU.

* ``ServeCalibration`` JSON both ways, the weights checksum, and the
  calibration scales (1e-5 relative), also at 50 beams where the JAX p2
  padding (64 at ``pm_tile=32``) and the port's (56) differ;
* the quantized stack weights against ``quantize_stack_int8``, and the
  step's layer-1 and embed weights to the bit;
* the plain versions' int8 sums exact past 2^24, and pooling before the
  epilogue equal to pooling after it;
* K5-K7's plain versions against ``fused_backbone_int8_p2(l1_mode="mm")``,
  ``gate_fused_int8_pm(per_stream=True)`` and ``fused_head_int8_pm`` in
  interpret mode: int8 within 1 LSB with under 5e-3 of the elements off by
  one (``tests/test_fast_gate.py``'s bar), z and zx at 2e-2, sim at 1e-5,
  cls/reg at 2e-2 x max;
* the int8c step against JAX's int8c p2 step over 3 steps, both built from
  the JAX step's calibration through JSON: template within 1 LSB (share <
  5e-3), z and ``pred_*`` at rtol/atol 5e-2
  (``tests/test_int8_serving_gate.py``), the same NMS on identical inputs;
* a step rebuilt from a saved ``calibration.json`` gives bit-identical
  carries, and a calibration saved by either package builds a step in the
  other.

JAX's pm rows are converted to the port's cutout-major layout as
``tests/test_fast_gate.py`` converts them. Geometry: 64 beams, 16 points,
window 5, B=2, JAX at ``pm_tile=32``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.infer import fast_gate as jfg
from planar_optical_flow_tpu.infer.calibration import (
    ServeCalibration as JaxCalibration,
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
    int8_weights,
    make_serve_step_v3,
    weights_checksum,
)
from planar_optical_flow_tpu_torch.ops.kernels import fold, quant
from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
    _conv_int8_acc,
    _run_int8_plain,
    backbone_int8,
    head_int8,
)
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

TILE = 32     # the JAX pm tile of these tests
L4 = CT_LEN // 4
BF16_REL = 2e-2
STEP_TOL = dict(rtol=5e-2, atol=5e-2)  # tests/test_int8_serving_gate.py
FIELDS = ("pred_cls", "pred_reg", "pred_flow")


def pm_to_port(a):
    """JAX pm rows ``(S*T*l4*tile, 256)`` in (stream, tile block, position,
    cutout) order -> the port's ``(S*ct, l4*256)`` cutout-major rows."""
    return (np.asarray(a).reshape(-1, L4, TILE, 256).transpose(0, 2, 1, 3)
            .reshape(-1, L4 * 256))


def port_to_pm(a):
    """The inverse of :func:`pm_to_port` (rows ``(N, l4*256)``)."""
    a = np.asarray(a)
    return (a.reshape(-1, TILE, L4, 256).transpose(0, 2, 1, 3)
            .reshape(-1, 256))


def assert_int8_close(got, ref, what=""):
    """Within 1 LSB, with under 5e-3 of the elements off by one."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert diff.max() <= 1, f"{what}: max int8 diff {diff.max()}"
    assert (diff > 0).mean() < 5e-3, f"{what}: share {(diff > 0).mean()}"


def _scans(seed, steps=3, b=2, num_pts=NUM_PTS):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 20.0, (steps, b, num_pts)).astype(np.float32)


def _relclose(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_array_less(np.abs(a - b), rel * np.abs(b) + 1e-30)


def _assert_same_scales(got, ref, rel=1e-5):
    _relclose([got.bb_in_scale], [ref.bb_in_scale], rel)
    _relclose(got.bb_act_scales, ref.bb_act_scales, rel)
    _relclose([got.hd_in_scale], [ref.hd_in_scale], rel)
    _relclose(got.hd_act_scales, ref.hd_act_scales, rel)
    assert (got.num_pts, got.num_cutout_pts) == (ref.num_pts,
                                                 ref.num_cutout_pts)


@pytest.fixture(scope="module")
def setup():
    """The model pair and the JAX int8c p2 step, calibrated once."""
    model, v_np, port = flow_drow_pair(seed=3)
    variables = to_jax(v_np)
    calib_scans = _scans(40, steps=1)[0]
    step = jax_v3(model, variables, CUTOUT_KW, calib_scans=calib_scans,
                  num_pts=NUM_PTS, precision="int8c", layout="p2",
                  pm_tile=TILE, interpret=True)
    return dict(model=model, v_np=v_np, variables=variables, port=port,
                calib_scans=calib_scans, step=step, calib=step.calibration)


def _det_vars(v_np, name):
    return to_jax({c: v_np[c]["dr_spaam"][name]
                   for c in ("params", "batch_stats")})


# ------------------------------------------------------------- calibration


def test_calibration_json_both_directions(setup, tmp_path):
    jc = setup["calib"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    path = jc.save(str(tmp_path / "jax"))
    got = ServeCalibration.load(path)
    assert got.to_dict() == jc.to_dict()
    assert ServeCalibration.find(str(tmp_path / "jax" / "ckpt")) == got
    assert ServeCalibration.find(str(tmp_path / "nowhere" / "ckpt")) is None
    back = JaxCalibration.load(got.save(tmp_path / "port"))
    assert back.to_dict() == jc.to_dict()
    assert back.to_dict()["format_version"] == 1


def test_weights_checksum_matches_jax(setup):
    wsum = weights_checksum(setup["port"].dr_spaam)
    ref = setup["calib"].weights_checksum
    assert abs(wsum - ref) <= 1e-3 * max(abs(ref), 1.0), (wsum, ref)
    assert abs(wsum - ref) <= 1e-6 * abs(ref), (wsum, ref)


@pytest.mark.parametrize("num_pts,percentile", [(NUM_PTS, None), (50, None),
                                                (NUM_PTS, 99.5)])
def test_calibration_scales_match_jax(setup, num_pts, percentile):
    """At 50 beams the JAX p2 path pads the calibration sample to 64 beams
    (``pm_tile=32``) and the port's step to 56: the port calibrates on the
    JAX padding, dead beams included, so the scales still agree."""
    scans = _scans(41, steps=1, num_pts=num_pts)[0]
    scans[0, 3] = np.nan  # both sanitize before calibrating
    kw = dict(num_pts=num_pts, pm_tile=TILE, calib_percentile=percentile)
    ref = jax_calibrate(setup["model"], setup["variables"], CUTOUT_KW, scans,
                        interpret=True, **kw)
    got = calibrate_serve_v3(setup["port"], CUTOUT_KW, scans, device="cpu",
                             **kw)
    _assert_same_scales(got, ref)
    assert np.isfinite(got.bb_in_scale)


def test_quantized_weights_match_jax(setup):
    jc, v_np, det = setup["calib"], setup["v_np"], setup["port"].dr_spaam
    bb = _det_vars(v_np, "backbone")
    hd = _det_vars(v_np, "head")
    cases = [
        (_block_params(bb, "block1", 3)[1:] + _block_params(bb, "block2", 3),
         fold.backbone_blocks(det.backbone)[1:], CT_LEN, {1, 4},
         jc.bb_in_scale, jc.bb_act_scales, False),
        (_block_params(hd, "block3", 3) + _block_params(hd, "block4", 2),
         fold.head_conv_blocks(det.head), L4, {2}, jc.hd_in_scale,
         jc.hd_act_scales, True),
    ]
    for jblocks, blocks, l0, pools, s_in, scales, deq in cases:
        ref, ref_in, ref_out = jcs.quantize_stack_int8(
            jblocks, None, l0, pool_after=pools, in_scale=s_in,
            act_scales=scales, dequant_last=deq, concat_taps=True)
        got, got_in, got_out = quant.quantize_stack_int8(
            blocks, None, pool_after=pools, in_scale=s_in,
            act_scales=scales, dequant_last=deq)
        assert (got_in, got_out) == (ref_in, ref_out)
        for i, (w, s, b) in enumerate(got):
            np.testing.assert_array_equal(w, np.asarray(ref[3 * i]))
            np.testing.assert_array_equal(s, np.asarray(ref[3 * i + 1]))
            np.testing.assert_array_equal(b, np.asarray(ref[3 * i + 2]))
        kernel = quant.kernel_stack_weights(got, "cpu")
        assert kernel[0][0].shape == (got[0][0].shape[1],
                                      got[0][0].shape[0])
    # the layer-1 fold of l1_mm_weights: w / in_scale, b / in_scale
    l1 = _block_params(bb, "block1", 3)[0]
    wsel, bsel = jcs.l1_mm_weights(l1[0][:, 0, :], l1[1], jc.bb_in_scale,
                                   CT_LEN)
    w1, b1 = quant.layer1_int8_weights(fold.backbone_blocks(det.backbone)[0],
                                       jc.bb_in_scale)
    np.testing.assert_array_equal(t2n(w1), np.asarray(wsel)[0:3, 64:128])
    np.testing.assert_array_equal(t2n(b1), np.asarray(bsel)[0, :64])
    q = quant.quantize_int8(torch.tensor([0.5, -1.5, 2.5, 1e3]), 1.0)
    np.testing.assert_array_equal(q.numpy(), [0, -2, 2, 127])


def test_step_weights_match_jax(setup):
    """The step's own weight preparation (``int8_weights``): the layer-1
    fold and the embed weight, bf16 W times the scale rounded to bf16
    (the JAX weakly typed ``embed_w[0] * feat_scale``), to the bit."""
    jc, v_np, det = setup["calib"], setup["v_np"], setup["port"].dr_spaam
    w = int8_weights(det, ServeCalibration.from_dict(jc.to_dict()), "cpu")
    bb = _det_vars(v_np, "backbone")
    _, _, feat_scale = jcs.quantize_stack_int8(
        (_block_params(bb, "block1", 3) + _block_params(bb, "block2", 3))[1:],
        None, CT_LEN, pool_after={1, 4}, in_scale=jc.bb_in_scale,
        act_scales=jc.bb_act_scales, dequant_last=False, concat_taps=True)
    assert (w.feat_scale, w.tmpl_scale) == (feat_scale, jc.hd_in_scale)
    gp_j = jfg.fold_gate_params(_det_vars(v_np, "gate"), alpha=0.5,
                                window_size=WINDOW, dtype=jnp.bfloat16)
    we_j = np.asarray(gp_j.w * feat_scale)
    assert we_j.dtype == jnp.bfloat16
    np.testing.assert_array_equal(t2n(w.embed[0].t()), we_j.astype(np.float32))
    np.testing.assert_array_equal(t2n(w.embed[1]),
                                  np.asarray(gp_j.b, np.float32))


def test_int8_sums_exact_and_pool_before_epilogue():
    """The plain versions' int8 sums are exact past 2^24 (the head's
    512-channel conv: 1536 * 127^2 = 2.5e7), and pooling the int32 sums
    before the monotone epilogue gives the bits of pooling after it."""
    x = torch.full((2, 4, 512), 127, dtype=torch.int8)
    x[1, 2, :300] = -127
    w = torch.full((8, 3 * 512), 127, dtype=torch.int8)
    w[3, ::7] = -127
    acc = _conv_int8_acc(x, w)
    xc = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1), x, \
        torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], 1)
    ref = torch.cat(xc, -1).long() @ w.long().t()
    assert ref.abs().max() > 2 ** 24
    assert torch.equal(acc.long(), ref)
    rng = np.random.default_rng(48)
    xq = torch.from_numpy(rng.integers(-127, 128, (3, 8, 64)).astype(np.int8))
    layer = (torch.from_numpy(rng.integers(-127, 128, (16, 192)).astype(
        np.int8)), torch.tensor(rng.uniform(1e-4, 1e-3, 16), dtype=torch.float32),
        torch.tensor(rng.normal(0, 1, 16), dtype=torch.float32))
    pooled_first = _run_int8_plain(xq, [layer], (0,), requant_last=False)
    y = _conv_int8_acc(xq, layer[0]).float() * layer[1] + layer[2]
    y = torch.where(y > 0, y, 0.1 * y)
    assert torch.equal(pooled_first, y.reshape(3, 4, 2, 16).amax(2))


# ------------------------------------------------------------ the kernels


def _kernel_weights(setup):
    """JAX and port weights of the int8 stacks at the JAX calibration."""
    jc, v_np, det = setup["calib"], setup["v_np"], setup["port"].dr_spaam
    bb = _det_vars(v_np, "backbone")
    jblocks = _block_params(bb, "block1", 3) + _block_params(bb, "block2", 3)
    bb_q, in_scale, feat_scale = jcs.quantize_stack_int8(
        jblocks[1:], None, CT_LEN, pool_after={1, 4},
        in_scale=jc.bb_in_scale, act_scales=jc.bb_act_scales,
        dequant_last=False, concat_taps=True)
    blocks = fold.backbone_blocks(det.backbone)
    q, _, _ = quant.quantize_stack_int8(
        blocks[1:], None, pool_after={1, 4},
        in_scale=jc.bb_in_scale, act_scales=jc.bb_act_scales,
        dequant_last=False)
    gp_j = jfg.fold_gate_params(_det_vars(v_np, "gate"), alpha=0.5,
                                window_size=WINDOW, dtype=jnp.bfloat16)
    gp = fold.fold_gate_params(det.gate, dtype=torch.bfloat16)
    we = gp.w * torch.tensor(float(feat_scale), dtype=torch.bfloat16)
    return dict(
        jax=(jcs.pack2_backbone_weights(bb_q),
             (jblocks[0][0][:, 0, :], jblocks[0][1].reshape(1, -1)),
             (gp_j.w * float(feat_scale), gp_j.b), in_scale),
        port=(quant.layer1_int8_weights(blocks[0], in_scale),
              quant.kernel_stack_weights(q, "cpu"),
              (we.t().contiguous(), gp.b)),
        feat_scale=float(feat_scale))


def test_backbone_int8_plain_matches_pallas(setup):
    w = _kernel_weights(setup)
    scans = _scans(42, steps=1)[0]
    cut = cutout(torch.from_numpy(scans), num_cutout_pts=CT_LEN,
                 window_width=1.0, window_depth=0.5, padding_val=29.99,
                 centered=True, area_mode=True)  # (2*64, 16) real cutouts
    wp, l1, embed_j, in_scale = w["jax"]
    feats_j, zx_j = jcs.fused_backbone_int8_p2(
        jnp.asarray(t2n(cut)), wp, l1, l=CT_LEN, tile=TILE,
        out_dtype=jnp.int8, l1_mode="mm", embed_weights=embed_j,
        in_scale=in_scale, interpret=True)
    feats, zx = backbone_int8(cut, *w["port"], l=CT_LEN)
    assert feats.dtype == torch.int8 and zx.dtype == torch.bfloat16
    assert_int8_close(feats.numpy().reshape(-1, L4 * 256),
                      pm_to_port(feats_j), "feats")
    np.testing.assert_allclose(t2n(zx), np.asarray(zx_j, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("boot", [True, False])
def test_gate_int8_plain_matches_pallas(boot):
    """ct_valid < ct exercises the dead padding rows."""
    rng = np.random.default_rng(43 + boot)
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
    ref = jfg.gate_fused_int8_pm(
        jnp.asarray(t2n(zx), jnp.bfloat16), jnp.asarray(t2n(zt), jnp.bfloat16),
        jnp.asarray(port_to_pm(x.numpy())), jnp.asarray(port_to_pm(t.numpy())),
        ct=ct, tile=TILE, l4=L4, per_stream=True, interpret=True, **kw)
    new_t, new_z, sim = gate_int8(zx, zt, x, t, ct=ct, **kw)
    assert new_t.dtype == torch.int8 and new_z.dtype == torch.bfloat16
    assert_int8_close(new_t.numpy(), pm_to_port(ref[0]), "new_t")
    np.testing.assert_allclose(t2n(new_z), np.asarray(ref[1], np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(t2n(sim), np.asarray(ref[2]), rtol=1e-5,
                               atol=1e-5)


def test_head_int8_plain_matches_pallas(setup):
    jc, v_np, det = setup["calib"], setup["v_np"], setup["port"].dr_spaam
    hd = _det_vars(v_np, "head")
    hd_q, _, _ = jcs.quantize_stack_int8(
        _block_params(hd, "block3", 3) + _block_params(hd, "block4", 2),
        None, L4, pool_after={2}, in_scale=jc.hd_in_scale,
        act_scales=jc.hd_act_scales, concat_taps=True)
    q, _, _ = quant.quantize_stack_int8(
        fold.head_conv_blocks(det.head), None, pool_after={2},
        in_scale=jc.hd_in_scale, act_scales=jc.hd_act_scales)
    rng = np.random.default_rng(45)
    tmpl = rng.integers(-127, 128, (64 * L4, 256)).astype(np.int8)
    cls_j, reg_j = jcs.fused_head_int8_pm(
        jnp.asarray(port_to_pm(tmpl.reshape(64, -1))), hd_q,
        jcs.head_stack_weights(hd)[1], num_classes=1, l4=L4, tile=TILE,
        interpret=True)
    cls, reg = head_int8(torch.from_numpy(tmpl),
                         quant.kernel_stack_weights(q, "cpu"),
                         fold.head_linear_weights(det.head), num_classes=1,
                         l4=L4)
    assert cls.dtype == reg.dtype == torch.float32
    assert_close_to_max(t2n(cls), np.asarray(cls_j), BF16_REL, "cls")
    assert_close_to_max(t2n(reg), np.asarray(reg_j), BF16_REL, "reg")


# -------------------------------------------------------------- the step


def test_int8c_step_matches_jax(setup, tmp_path):
    """3 steps of the port's int8c step against JAX's, both on the JAX
    calibration (the port's read back from its JSON)."""
    path = setup["calib"].save(str(tmp_path))
    step = make_serve_step_v3(setup["port"], CUTOUT_KW,
                              calib=ServeCalibration.load(path),
                              num_pts=NUM_PTS, precision="int8c",
                              device="cpu")
    ref_step = setup["step"]
    phi = torch.as_tensor(get_laser_phi(num_pts=NUM_PTS), dtype=torch.float32)
    carry_j, carry = None, None
    for i, scan in enumerate(_scans(46)):
        if i == 1:
            scan[0, 5] = np.nan  # the sanitize guard is on in both
        carry_j, ref = ref_step(carry_j, jnp.asarray(scan))
        carry, got = step(carry, torch.from_numpy(scan))
        assert set(got) == set(ref)
        assert carry["template"].dtype == torch.int8
        assert_int8_close(carry["template"].numpy(),
                          pm_to_port(carry_j["template"]),
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


def test_restored_calibration_is_bit_identical(setup, tmp_path):
    """The port's own scales and the same scales read back from its
    ``calibration.json`` give bit-identical carries; a calibration saved by
    the port builds a JAX int8c step (its checksum passes the JAX check)."""
    port = setup["port"]
    kw = dict(num_pts=NUM_PTS, precision="int8c", device="cpu")
    s1 = make_serve_step_v3(port, CUTOUT_KW,
                            calib_scans=setup["calib_scans"], pm_tile=TILE,
                            **kw)
    path = s1.calibration.save(str(tmp_path))
    s2 = make_serve_step_v3(port, CUTOUT_KW,
                            calib=ServeCalibration.load(path), **kw)
    c1 = c2 = None
    for scan in _scans(47, steps=2):
        c1, o1 = s1(c1, torch.from_numpy(scan))
        c2, o2 = s2(c2, torch.from_numpy(scan))
        for k in ("template", "z"):
            assert torch.equal(c1[k], c2[k]), k
        for k in o1:
            assert torch.equal(o1[k], o2[k]), k
    _assert_same_scales(s1.calibration, setup["calib"])
    jax_v3(setup["model"], setup["variables"], CUTOUT_KW,
           calib=JaxCalibration.load(path), num_pts=NUM_PTS,
           precision="int8c", pm_tile=TILE, interpret=True)
    stale = ServeCalibration.load(path)
    stale.weights_checksum *= 1.01
    with pytest.raises(ValueError, match="different weights"):
        make_serve_step_v3(port, CUTOUT_KW, calib=stale, **kw)
    stale = ServeCalibration.load(path)
    stale.num_pts = 450
    with pytest.raises(ValueError, match="geometry"):
        make_serve_step_v3(port, CUTOUT_KW, calib=stale, **kw)
    with pytest.raises(ValueError, match="calib_scans or calib"):
        make_serve_step_v3(port, CUTOUT_KW, **kw)
