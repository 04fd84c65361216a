"""``make_serve_step_v3`` off the serving cutout (``fixed=False``), the port
against the JAX builder's fallback to its XLA cutout, on the CPU.

* each configuration (bf16 flat, ``"int8"`` flat, int8c p2, p2c, pm and
  cell) for a bootstrap and 2 carried steps against JAX's step with the
  same options, in interpret mode, both on the JAX calibration: bf16 at
  2e-2 x max|JAX| (``tests/test_torch_streaming.py``), int8 templates
  within 1 LSB with under 5e-3 of them off by one, the bf16 template, z and
  the outputs at rtol/atol 5e-2 (``tests/test_torch_int8.py``);
* the int8 calibration of each int8 configuration against JAX's at 1e-6
  relative: both encode the scans through the module cutout and pad the
  dead rows with zeros (with ``calib_percentile`` too, where the zeros and
  K1's dead rows give other scales: there the backbone's scales equal
  JAX's to the bit);
* ``stride=2``: JAX's builder fails at its first encode (a reshape of
  ``ceil(64 / 2)`` rows a stream), the port raises ``ValueError`` at the
  build;
* which cutout runs: at ``fixed=True`` K1 (and K8 on p2c), never the module
  cutout; at ``fixed=False`` the module cutout, never K1 or K8.

Geometry as ``tests/test_torch_int8.py``: 64 beams, 16 points, window 5,
B=2, JAX at ``pm_tile=32`` and ``tile=16``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.infer.calibration import (
    calibrate_serve_v3 as jax_calibrate,
)
from planar_optical_flow_tpu.infer.streaming import (
    make_serve_step_v3 as jax_v3,
)
from planar_optical_flow_tpu_torch.infer import streaming
from planar_optical_flow_tpu_torch.infer.calibration import (
    ServeCalibration,
    calibrate_serve_v3,
)
from planar_optical_flow_tpu_torch.infer.streaming import make_serve_step_v3
from tests.test_torch_common import one_thread  # noqa: F401
from tests.test_torch_common import (
    CUTOUT_KW,
    NUM_PTS,
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
    _scans,
    assert_int8_close,
)
from tests.test_torch_int8_fused import _rows_to_port

JAX_TILE = 16
FALLBACK_KW = dict(CUTOUT_KW, fixed=False)
CONFIGS = {
    "bf16": dict(precision="bf16", layout="flat"),
    "int8": dict(precision="int8", layout="flat"),
    "p2": dict(precision="int8c", layout="p2"),
    "p2c": dict(precision="int8c", layout="p2c"),
    "pm": dict(precision="int8c", layout="pm"),
    "cell": dict(precision="int8c", layout="cell"),
}
INT8_CONFIGS = [k for k in CONFIGS if k != "bf16"]
# JAX's p2c off the kernel's cutout is its p2 step (``p2cut`` is False:
# ``planar_optical_flow_tpu/infer/streaming.py:618-620``), so one compiled
# JAX step serves both
JAX_STEP_OF = {"p2c": "p2"}


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


@pytest.fixture(scope="module")
def setup():
    """The model pair, the calibration scans and one JAX calibration a
    configuration (built on first use)."""
    model, v_np, port = flow_drow_pair(seed=3)
    return dict(model=model, variables=to_jax(v_np), port=port,
                calib_scans=_scans(40, steps=1)[0], calibs={}, steps={})


def _jax_calib(setup, name):
    if name not in setup["calibs"]:
        setup["calibs"][name] = jax_calibrate(
            setup["model"], setup["variables"], FALLBACK_KW,
            setup["calib_scans"], num_pts=NUM_PTS, pm_tile=TILE,
            tile=JAX_TILE, interpret=True, **CONFIGS[name])
    return setup["calibs"][name]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fallback_step_matches_jax(setup, name):
    """A bootstrap and 2 carried steps of the port's fallback step against
    JAX's, both on the JAX calibration (p2c's against JAX's p2 step, which
    is JAX's p2c step off the kernel's cutout)."""
    kw = dict(num_pts=NUM_PTS, pm_tile=TILE, **CONFIGS[name])
    ref = JAX_STEP_OF.get(name, name)
    calib_j = None if name == "bf16" else _jax_calib(setup, ref)
    if ref not in setup["steps"]:
        setup["steps"][ref] = jax_v3(
            setup["model"], setup["variables"], FALLBACK_KW, calib=calib_j,
            tile=JAX_TILE, interpret=True, **dict(kw, **CONFIGS[ref]))
    ref_step = setup["steps"][ref]
    step = make_serve_step_v3(
        setup["port"], FALLBACK_KW, device="cpu",
        calib=None if calib_j is None
        else ServeCalibration.from_dict(calib_j.to_dict()), **kw)
    rows_tile = NUM_PTS if name == "cell" else TILE
    carry_j, carry = None, None
    for i, scan in enumerate(_scans(81)):
        if i == 1:
            scan[1, 9] = np.nan  # the sanitize guard is on in both
        carry_j, ref = ref_step(carry_j, jnp.asarray(scan))
        carry, got = step(carry, torch.from_numpy(scan))
        assert set(got) == set(ref)
        tmpl_j = np.asarray(carry_j["template"])
        if name == "bf16":
            for k in FIELDS:
                assert_close_to_max(t2n(got[k]), np.asarray(ref[k]),
                                    BF16_REL, f"step {i} {k}")
            for k in ("template", "z"):
                assert carry[k].dtype == torch.bfloat16
                assert_close_to_max(t2n(carry[k]),
                                    np.asarray(carry_j[k], np.float32),
                                    BF16_REL, f"step {i} carry {k}")
            continue
        if name == "int8":
            assert carry["template"].dtype == torch.bfloat16
            np.testing.assert_allclose(t2n(carry["template"]),
                                       tmpl_j.astype(np.float32),
                                       err_msg=f"step {i} template",
                                       **STEP_TOL)
        else:
            assert carry["template"].dtype == torch.int8
            assert_int8_close(carry["template"].numpy(),
                              _rows_to_port(tmpl_j, rows_tile),
                              f"step {i} template")
        np.testing.assert_allclose(t2n(carry["z"]),
                                   np.asarray(carry_j["z"], np.float32),
                                   err_msg=f"step {i} z", **STEP_TOL)
        for k in FIELDS:
            np.testing.assert_allclose(t2n(got[k]), np.asarray(ref[k]),
                                       err_msg=f"step {i} {k}", **STEP_TOL)


@pytest.mark.parametrize("name", INT8_CONFIGS)
def test_fallback_calibration_matches_jax(setup, name):
    """The port calibrates on the fallback's zero-padded rows, as JAX does
    (at 64 beams and ``pm_tile=32`` every layout pads to 64 beams)."""
    got = calibrate_serve_v3(setup["port"], FALLBACK_KW, setup["calib_scans"],
                             num_pts=NUM_PTS, pm_tile=TILE, device="cpu",
                             **CONFIGS[name])
    _assert_same_scales(got, _jax_calib(setup, name), rel=1e-6)


def test_fallback_calibration_zero_rows_match_jax(setup):
    """At the default ``pm_tile=160`` int8c p2 pads the calibration sample
    of 64 beams to 160 (96 dead rows a stream); with ``calib_percentile``
    the zero rows move the scales. The backbone's scales, which the
    fallback's rows give, equal JAX's to the bit; the head's, from the f32
    module steps, within 1e-6."""
    scans = _scans(82, steps=1)[0]
    scans[0, 3] = np.nan  # both sanitize before calibrating
    kw = dict(num_pts=NUM_PTS, precision="int8c", layout="p2",
              calib_percentile=99.5)
    ref = jax_calibrate(setup["model"], setup["variables"], FALLBACK_KW,
                        scans, tile=JAX_TILE, interpret=True, **kw)
    got = calibrate_serve_v3(setup["port"], FALLBACK_KW, scans, device="cpu",
                             **kw)
    assert ([got.bb_in_scale] + got.bb_act_scales
            == [ref.bb_in_scale] + ref.bb_act_scales)
    _assert_same_scales(got, ref, rel=1e-6)
    # K1's dead rows are not zeros: the kernel's calibration differs
    kernel = calibrate_serve_v3(setup["port"], CUTOUT_KW, scans,
                                device="cpu", **kw)
    assert kernel.bb_act_scales != got.bb_act_scales


@pytest.mark.parametrize("precision", ["bf16", "int8c"])
def test_stride_raises_in_both(setup, precision):
    """JAX's builder takes one cutout per beam: at ``stride=2`` its first
    encode (the bf16 step's; an int8 build's calibration encodes the same
    way first) cannot reshape the 32 cutouts of a stream to its 64 rows.
    The port refuses the configuration when it is built, before any
    calibration."""
    kw = dict(FALLBACK_KW, stride=2)
    scans = setup["calib_scans"]
    opts = dict(num_pts=NUM_PTS, precision=precision, pm_tile=TILE)
    if precision == "bf16":
        step = jax_v3(setup["model"], setup["variables"], kw, tile=JAX_TILE,
                      interpret=True, **opts)
        with pytest.raises(TypeError, match="cannot reshape"):
            step(None, jnp.asarray(scans))
    with pytest.raises(ValueError, match="stride=2: the v3 step takes one "
                                         "cutout per beam"):
        make_serve_step_v3(setup["port"], kw, calib_scans=scans,
                           device="cpu", **opts)
    with pytest.raises(ValueError, match="stride=2"):
        make_serve_step_v3(setup["port"], dict(CUTOUT_KW, stride=2),
                           calib_scans=scans, device="cpu", **opts)


@pytest.mark.parametrize("layout", ["p2", "p2c", "cell"])
def test_which_cutout_runs(setup, layout, monkeypatch):
    """``fixed=True``: K1 (K8 on p2c) and never the module cutout;
    ``fixed=False``: the module cutout, and neither K1 nor K8 (p2c takes
    p2's K5)."""
    calls = dict.fromkeys(("module", "cutout", "backbone_int8_cut",
                           "backbone_int8"), 0)

    def counting(name):
        real = getattr(streaming, "_encode_single" if name == "module"
                       else name)

        def run(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return run

    for name in calls:
        monkeypatch.setattr(streaming, "_encode_single" if name == "module"
                            else name, counting(name))
    calib = ServeCalibration.from_dict(_jax_calib(setup, "p2").to_dict())
    for kw, fixed in ((CUTOUT_KW, True), (FALLBACK_KW, False)):
        step = make_serve_step_v3(setup["port"], kw, calib=calib,
                                  num_pts=NUM_PTS, precision="int8c",
                                  layout=layout, pm_tile=TILE, device="cpu")
        for name in calls:
            calls[name] = 0
        carry = None
        for scan in _scans(83):
            carry, _ = step(carry, torch.from_numpy(scan))
        if fixed:
            assert calls["module"] == 0
            assert calls["cutout"] == (0 if layout == "p2c" else 3)
            assert calls["backbone_int8_cut"] == (3 if layout == "p2c" else 0)
        else:
            assert calls["module"] == 3
            assert calls["cutout"] == calls["backbone_int8_cut"] == 0
            assert calls["backbone_int8"] == (0 if layout == "cell" else 3)
