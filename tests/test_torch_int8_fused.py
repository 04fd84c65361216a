"""The port's fused int8c serving programs against the JAX ones, on the CPU:
``layout="p2c"`` (K8), ``fuse_gate_head=True`` (K12) and ``layout="cell"``
(K13).

* K8's plain version against ``fused_backbone_int8_p2cut`` and K12's
  against ``gate_head_fused_int8_pm`` (bootstrap and carried), in
  interpret mode: int8 within 1 LSB with under 5e-3 of the elements off by
  one (``tests/test_fast_gate.py``'s bar), zx and z at 2e-2, sim at 1e-5,
  cls/reg at 2e-2 x max|JAX|; K13's against ``serve_cell_int8`` at JAX's
  own cell-vs-pm bars (``tests/test_int8_serving_gate.py:175-184``: the
  template within 1 LSB, z at 2e-2, cls/reg at 5e-2); each plain version
  equal to the bit to the port's unfused plain chain (K1 + K5, K6 + K7, K9
  + K6 + K7);
* the steps of ``make_serve_step_v3`` with each option against JAX's
  builder with the same option over 3 steps, at ``test_step_matches_jax``'s
  bars; on the port alone, p2c == p2, fused == unfused (p2, pm, p2c) and
  cell == pm on the valid rows, to the bit;
* the calibration scales of ``"cell"`` (and ``"p2c"``) against JAX's at 64
  beams, where cell pads the sample to 64 beams and pm to 160;
* the kernels' library name follows every ``csrc/*.cuh`` header.

Geometry as ``tests/test_torch_int8.py``: 64 beams, 16 points, window 5,
B=2, JAX at ``pm_tile=32``. Each JAX step is built once per module (an
interpret-mode step takes seconds).
"""

from __future__ import annotations

import shutil

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
from planar_optical_flow_tpu.ops.pallas import conv_stack as jcs
from planar_optical_flow_tpu.ops.pallas import serve_cell as jsc
from planar_optical_flow_tpu.ops.pallas.fused_drow import _block_params
from planar_optical_flow_tpu_torch.infer.calibration import (
    ServeCalibration,
    calibrate_serve_v3,
)
from planar_optical_flow_tpu_torch.infer.fast_gate import (
    gate_head_int8,
    gate_int8_plain,
)
from planar_optical_flow_tpu_torch.infer.streaming import make_serve_step_v3
from planar_optical_flow_tpu_torch.ops.kernels import _build, fold, quant
from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import (
    cutout_plain,
)
from planar_optical_flow_tpu_torch.ops.kernels.serve_cell import (
    serve_cell_int8,
)
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
    _kernel_weights,
    _scans,
    assert_int8_close,
    port_to_pm,
    pm_to_port,
)
from tests.test_torch_int8_layouts import JAX_TILE, _stack_weights

L4 = CT_LEN // 4
CONFIGS = {
    "p2c": dict(layout="p2c"),
    "fused": dict(layout="p2", fuse_gate_head=True),
    "cell": dict(layout="cell"),
}
CUT_KW = dict(num_cutout_pts=CT_LEN, window_width=1.0, window_depth=0.5,
              padding_val=29.99, centered=True, area_mode=True)


@pytest.fixture(scope="module")
def setup():
    """The model pair and one JAX calibration (at 64 beams every one of
    these configurations pads to 64); the JAX steps are built on first
    use."""
    model, v_np, port = flow_drow_pair(seed=3)
    variables = to_jax(v_np)
    jc = jax_calibrate(model, variables, CUTOUT_KW, _scans(40, steps=1)[0],
                       num_pts=NUM_PTS, precision="int8c", layout="flat",
                       pm_tile=TILE, tile=JAX_TILE, interpret=True)
    return dict(model=model, v_np=v_np, variables=variables, port=port,
                calib=jc, steps={})


def _port_calib(setup):
    return ServeCalibration.from_dict(setup["calib"].to_dict())


def _rows_to_port(a, tile):
    """JAX pm rows at ``tile`` cutouts a block -> the port's cutout-major
    ``(N, l4*256)`` rows (``pm_to_port`` at any tile)."""
    return (np.asarray(a).reshape(-1, L4, tile, 256).transpose(0, 2, 1, 3)
            .reshape(-1, L4 * 256))


def _port_to_rows(a, tile):
    """The inverse of :func:`_rows_to_port`."""
    return (np.asarray(a).reshape(-1, tile, L4, 256).transpose(0, 2, 1, 3)
            .reshape(-1, 256))


def _head_weights(setup):
    """JAX and port weights of the int8 head at the JAX calibration:
    (JAX convs, JAX cls/reg, port convs, port cls/reg)."""
    jc, v_np, det = setup["calib"], setup["v_np"], setup["port"].dr_spaam
    hd = _det_vars(v_np, "head")
    hd_q, _, _ = jcs.quantize_stack_int8(
        _block_params(hd, "block3", 3) + _block_params(hd, "block4", 2),
        None, L4, pool_after={2}, in_scale=jc.hd_in_scale,
        act_scales=jc.hd_act_scales, concat_taps=True)
    q, _, _ = quant.quantize_stack_int8(
        fold.head_conv_blocks(det.head), None, pool_after={2},
        in_scale=jc.hd_in_scale, act_scales=jc.hd_act_scales)
    return (hd_q, jcs.head_stack_weights(hd)[1],
            quant.kernel_stack_weights(q, "cpu"),
            fold.head_linear_weights(det.head))


def _bf(rng, shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16)


def _i8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


# ------------------------------------------------------------ the kernels


def test_backbone_int8_cut_plain_matches_pallas(setup):
    """K8 on 60 real beams padded to 64 (the padded beams are out of range
    for the taps, as in the step)."""
    w = _kernel_weights(setup)
    num_pts = 60
    scans = np.pad(_scans(70, steps=1, num_pts=num_pts)[0],
                   ((0, 0), (0, 64 - num_pts)))
    wp, l1, embed_j, in_scale = w["jax"]
    feats_j, zx_j = jcs.fused_backbone_int8_p2cut(
        jnp.asarray(scans), wp, l1, l=CT_LEN, tile=TILE, out_dtype=jnp.int8,
        embed_weights=embed_j, in_scale=in_scale, num_pts=num_pts,
        interpret=True, **{k: v for k, v in CUT_KW.items()
                           if k != "num_cutout_pts"})
    scans_t = torch.from_numpy(scans)
    feats, zx = cs.backbone_int8_cut(scans_t, *w["port"], p_valid=num_pts,
                                     **CUT_KW)
    assert feats.dtype == torch.int8 and zx.dtype == torch.bfloat16
    assert_int8_close(feats.numpy().reshape(-1, L4 * 256),
                      pm_to_port(feats_j), "feats")
    assert_close_to_max(t2n(zx), np.asarray(zx_j, np.float32), 2e-2, "zx")
    # the port's unfused plain chain: K1, then K5
    feats5, zx5 = cs.backbone_int8_plain(
        cutout_plain(scans_t, p_valid=num_pts, **CUT_KW), *w["port"],
        l=CT_LEN)
    assert torch.equal(feats, feats5) and torch.equal(zx, zx5)


@pytest.mark.parametrize("boot", [True, False])
def test_gate_head_int8_plain_matches_pallas(setup, boot):
    """K12 on random int8 rows; ct_valid < ct exercises the dead rows."""
    rng = np.random.default_rng(71 + boot)
    s, ct, ct_valid, d = 2, 64, 60, L4 * 256
    n = s * ct
    zx, zt = _bf(rng, (n, 128)), _bf(rng, (n, 128))
    x, t = _i8(rng, (n, d)), _i8(rng, (n, d))
    kw = dict(alpha=0.5, window_size=WINDOW, s_x=0.11, s_t=0.17,
              s_out=setup["calib"].hd_in_scale, ct_valid=ct_valid)
    if boot:
        zt, t, kw["s_t"] = zx, x, kw["s_x"]
    hd_j, head_j, hd_p, head_p = _head_weights(setup)
    ref = jfg.gate_head_fused_int8_pm(
        jnp.asarray(t2n(zx), jnp.bfloat16), jnp.asarray(t2n(zt), jnp.bfloat16),
        jnp.asarray(port_to_pm(x.numpy())), jnp.asarray(port_to_pm(t.numpy())),
        hd_j, head_j, ct=ct, tile=TILE, l4=L4, num_classes=1, interpret=True,
        **kw)
    got = gate_head_int8(zx, zt, x, t, hd_p, head_p, ct=ct, num_classes=1,
                         l4=L4, **kw)
    new_t, new_z, sim, cls, reg = got
    assert new_t.dtype == torch.int8 and cls.shape == (n, 1)
    assert_int8_close(new_t.numpy(), pm_to_port(ref[0]), "new_t")
    np.testing.assert_allclose(t2n(new_z), np.asarray(ref[1], np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(t2n(sim), np.asarray(ref[2]), rtol=1e-5,
                               atol=1e-5)
    assert_close_to_max(t2n(cls), np.asarray(ref[3]), BF16_REL, "cls")
    assert_close_to_max(t2n(reg), np.asarray(ref[4]), BF16_REL, "reg")
    # the port's unfused plain chain: K6, then K7
    chain = gate_int8_plain(zx, zt, x, t, ct=ct, **kw)
    chain += cs.head_int8_plain(chain[0].reshape(-1, 256), hd_p, head_p,
                                l4=L4)
    for a, b in zip(got, chain):
        assert torch.equal(a, b)


def test_serve_cell_int8_plain_matches_pallas(setup):
    """K13 on real cutouts and a random carry, ``tile == ct`` = 64 in JAX;
    ct_valid = 60 of each stream's 64 rows."""
    rng = np.random.default_rng(73)
    s, ct, ct_valid = 2, 64, 60
    n = s * ct
    w = _stack_weights(setup, True)
    hd_j, head_j, hd_p, head_p = _head_weights(setup)
    jc = setup["calib"]
    feat_scale = _kernel_weights(setup)["feat_scale"]
    scans = torch.from_numpy(_scans(74, steps=1)[0])
    cut = cutout_plain(scans, p_valid=ct_valid, **CUT_KW)  # (2*64, 16)
    zt, t = _bf(rng, (n, 128)), _i8(rng, (n, L4 * 256))
    kw = dict(l=CT_LEN, ct=ct, alpha=0.5, window_size=WINDOW,
              in_scale=w["in_scale"], s_x=feat_scale, s_t=jc.hd_in_scale,
              s_out=jc.hd_in_scale, ct_valid=ct_valid, num_classes=1)
    ref = jsc.serve_cell_int8(
        jnp.asarray(t2n(cut)), jnp.asarray(t2n(zt), jnp.bfloat16),
        jnp.asarray(_port_to_rows(t.numpy(), ct)), w["layer1_j"], w["jax"],
        w["embed_j"], hd_j, head_j, interpret=True, **kw)
    got = serve_cell_int8(cut, zt, t, w["layer1"], w["port"], w["embed"],
                          hd_p, head_p, **kw)
    new_t, new_z, sim, cls, reg = got
    assert new_t.dtype == torch.int8 and new_z.dtype == torch.bfloat16
    # within 1 LSB, JAX's own cell-vs-pm bar: the attention quantizes the
    # embedding of feats computed here, so a bf16 flip of zx moves a whole
    # row of the mix (~1% of the elements on this random carry)
    diff = np.abs(new_t.numpy().astype(np.int32)
                  - _rows_to_port(ref[0], ct).astype(np.int32))
    assert diff.max() <= 1, diff.max()
    for k, g, r, tol in (("z", new_z, ref[1], 2e-2), ("cls", cls, ref[3], 5e-2),
                         ("reg", reg, ref[4], 5e-2)):
        np.testing.assert_allclose(t2n(g), np.asarray(r, np.float32),
                                   rtol=tol, atol=tol, err_msg=k)
    # the port's unfused plain chain: K9, K6, K7
    feats, zx = cs.backbone_int8_pm_plain(cut, w["layer1"], w["port"],
                                          w["embed"], l=CT_LEN,
                                          in_scale=w["in_scale"])
    chain = gate_int8_plain(zx, zt, feats.reshape(n, -1), t, ct=ct,
                            alpha=0.5, window_size=WINDOW, s_x=feat_scale,
                            s_t=jc.hd_in_scale, s_out=jc.hd_in_scale,
                            ct_valid=ct_valid)
    chain += cs.head_int8_plain(chain[0].reshape(-1, 256), hd_p, head_p,
                                l4=L4)
    for a, b in zip(got, chain):
        assert torch.equal(a, b)


# ------------------------------------------------------------- calibration


@pytest.mark.parametrize("layout", ["cell", "p2c"])
def test_calibration_scales_match_jax(setup, layout):
    """At 64 beams and the default ``pm_tile=160``, ``"cell"`` calibrates
    on 64 beams and ``"p2c"`` (like ``"pm"``) on 160, as in JAX."""
    scans = _scans(75, steps=1)[0]
    scans[0, 11] = np.nan  # both sanitize before calibrating
    kw = dict(num_pts=NUM_PTS, precision="int8c", layout=layout)
    ref = jax_calibrate(setup["model"], setup["variables"], CUTOUT_KW, scans,
                        interpret=True, **kw)
    got = calibrate_serve_v3(setup["port"], CUTOUT_KW, scans, device="cpu",
                             **kw)
    _assert_same_scales(got, ref)


# --------------------------------------------------------------- the steps


def _jax_step(setup, name):
    if name not in setup["steps"]:
        setup["steps"][name] = jax_v3(
            setup["model"], setup["variables"], CUTOUT_KW,
            calib=setup["calib"], num_pts=NUM_PTS, pm_tile=TILE,
            precision="int8c", interpret=True, **CONFIGS[name])
    return setup["steps"][name]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_matches_jax(setup, name):
    """3 steps of the port's step against JAX's with the same option, both
    on the JAX calibration (every carry has 64 rows a stream)."""
    ref_step = _jax_step(setup, name)
    step = make_serve_step_v3(setup["port"], CUTOUT_KW,
                              calib=_port_calib(setup), num_pts=NUM_PTS,
                              pm_tile=TILE, precision="int8c", device="cpu",
                              **CONFIGS[name])
    tile = NUM_PTS if name == "cell" else TILE
    carry_j, carry = None, None
    for i, scan in enumerate(_scans(76)):
        if i == 1:
            scan[0, 13] = np.nan  # the sanitize guard is on in both
        carry_j, ref = ref_step(carry_j, jnp.asarray(scan))
        carry, got = step(carry, torch.from_numpy(scan))
        assert set(got) == set(ref)
        assert carry["template"].dtype == torch.int8
        assert_int8_close(carry["template"].numpy(),
                          _rows_to_port(carry_j["template"], tile),
                          f"step {i} template")
        np.testing.assert_allclose(t2n(carry["z"]),
                                   np.asarray(carry_j["z"], np.float32),
                                   err_msg=f"step {i} z", **STEP_TOL)
        for k in FIELDS:
            np.testing.assert_allclose(t2n(got[k]), np.asarray(ref[k]),
                                       err_msg=f"step {i} {k}", **STEP_TOL)


# (option under test, its reference; make_serve_step_v3 options; pm_tile)
PAIRS = {
    "p2c_is_p2": (dict(layout="p2c"), dict(layout="p2"), TILE),
    "p2_fused": (dict(layout="p2", fuse_gate_head=True), dict(layout="p2"),
                 TILE),
    "pm_fused": (dict(layout="pm", fuse_gate_head=True), dict(layout="pm"),
                 TILE),
    "p2c_fused": (dict(layout="p2c", fuse_gate_head=True), dict(layout="p2"),
                  TILE),
    # pm pads each stream to 160 rows, cell to 64
    "cell_is_pm": (dict(layout="cell"), dict(layout="pm"), 160),
}


@pytest.mark.parametrize("case", list(PAIRS))
def test_fused_steps_equal_unfused(setup, case):
    """On the port alone, each fused configuration gives its unfused
    reference's carries and outputs on the valid rows, to the bit, at 50
    beams (so that every carry has dead rows)."""
    opts, ref_opts, pm_tile = PAIRS[case]
    num_pts, port = 50, setup["port"]
    scans = _scans(77, num_pts=num_pts)
    calib = calibrate_serve_v3(port, CUTOUT_KW, scans[0], num_pts=num_pts,
                               pm_tile=pm_tile, device="cpu")
    kw = dict(calib=calib, num_pts=num_pts, pm_tile=pm_tile,
              precision="int8c", nms_top_k=32, device="cpu")
    step = make_serve_step_v3(port, CUTOUT_KW, **opts, **kw)
    ref = make_serve_step_v3(port, CUTOUT_KW, **ref_opts, **kw)
    c = cr = None
    for i, scan in enumerate(scans):
        c, o = step(c, torch.from_numpy(scan))
        cr, orf = ref(cr, torch.from_numpy(scan))
        for k in ("template", "z"):
            a = c[k].reshape(2, -1, c[k].shape[-1])[:, :num_pts]
            b = cr[k].reshape(2, -1, cr[k].shape[-1])[:, :num_pts]
            assert torch.equal(a, b), (case, i, k)
        assert set(o) == set(orf)
        for k in o:
            assert torch.equal(o[k], orf[k]), (case, i, k)


# ------------------------------------------------------------------ build


def test_library_name_follows_headers(tmp_path, monkeypatch):
    """A kernel library is named after its source and every header in
    ``csrc/``: editing a header that a source includes gives a new
    library path, so a stale build is never loaded."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    assert _build.library_path("gate") == before["gate"]
    header = src / "band_gate.cuh"
    assert '#include "band_gate.cuh"' in (src / "gate.cu").read_text()
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    assert after["gate"] != before["gate"]
    assert after["serve_cell"] != before["serve_cell"]
    assert {p.parent for p in after.values()} == {_build.BUILD_DIR}
