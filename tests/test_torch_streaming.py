"""The port's streaming engines against the JAX ones, over several steps.

* module engine vs JAX ``make_stream_step``: f32, 1e-3, the same kept
  detections, and identical NMS on identical inputs;
* v3 engine (plain kernel versions on the CPU) vs JAX
  ``make_serve_step_v3(precision="bf16", interpret=True)``: 2e-2 x max|ref|
  on every float output and on both carry leaves; the NMS is compared on
  identical inputs by feeding the JAX step's predictions to the port's NMS;
* ``StreamingRunner`` with a per-stream reset, all three engines (int8c
  calibrating lazily on its first batch in both packages, at rtol/atol 5e-2,
  ``tests/test_int8_serving_gate.py``);
* its restart step (the restarted rows bootstrapped alone, scattered into
  the carried pass) against the whole-batch bootstrap merged by
  ``merge_stream_carries``, to the bit, at B=8;
* the port's v3 engine vs its module engine at the JAX package's own
  bf16-vs-f32 tolerance (``tests/test_fast_gate.py``), the check the card
  run repeats at full size; its int8c engine vs its module engine at the
  JAX int8c-vs-f32 bar (corr > 0.95);
* the lazy int8c runner calibrating on a first batch that holds a NaN
  (``tests/test_input_sanitize.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.infer.streaming import (
    StreamingRunner as JaxRunner,
    make_serve_step_v3 as jax_v3,
    make_stream_step as jax_module_step,
)
from planar_optical_flow_tpu.ops.geometry import get_laser_phi
from planar_optical_flow_tpu_torch.infer.streaming import (
    StreamingRunner,
    make_serve_step_v3,
    make_stream_step,
    merge_stream_carries,
)
from planar_optical_flow_tpu_torch.ops.nms import (
    nms_predicted_center,
    nms_predicted_center_topk,
)
from tests.test_torch_common import (
    CUTOUT_KW,
    NUM_PTS,
    assert_close_to_max,
    flow_drow_pair,
    one_thread,  # noqa: F401 (a fixture)
    t2n,
    to_jax,
)

F32 = dict(rtol=1e-3, atol=1e-3)
INT8 = dict(rtol=5e-2, atol=5e-2)  # tests/test_int8_serving_gate.py
BF16_REL = 2e-2
FLOAT_FIELDS = ("pred_cls", "pred_reg", "pred_flow")
PHI = torch.as_tensor(get_laser_phi(num_pts=NUM_PTS), dtype=torch.float32)


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


@pytest.fixture(scope="module")
def pair():
    model, v_np, port = flow_drow_pair(seed=2)
    return model, to_jax(v_np), port


def _scans(seed, steps=3, b=2):
    rng = np.random.default_rng(seed)
    scans = rng.uniform(0.5, 20.0, (steps, b, NUM_PTS)).astype(np.float32)
    scans[1, 0, 5] = np.nan  # the sanitize guard is on in both
    return scans


def _assert_same_detections(got, ref):
    """The same kept detections. The slot-ordered keep masks are not
    compared directly: an untrained model gives confidences that tie to
    ~1e-7, so two f32 computations agreeing to 1e-5 may sort two tied votes
    into the other slot order."""
    for b in range(got["det_keep"].shape[0]):
        kept = [np.asarray(o["det_xys"][b])[np.asarray(o["det_keep"][b])]
                for o in ({k: v.numpy() for k, v in got.items()}, ref)]
        assert kept[0].shape == kept[1].shape, b
        order = [np.lexsort(k.T[::-1]) for k in kept]
        np.testing.assert_allclose(kept[0][order[0]], kept[1][order[1]],
                                   **F32)


def test_module_engine_matches_jax(pair):
    model, variables, port = pair
    ref_step = jax_module_step(model, CUTOUT_KW, num_pts=NUM_PTS,
                               donate_template=False)
    step = make_stream_step(port, CUTOUT_KW, num_pts=NUM_PTS, device="cpu")
    tmpl_j, tmpl = None, None
    for i, scan in enumerate(_scans(30)):
        tmpl_j, ref = ref_step(variables, tmpl_j, jnp.asarray(scan))
        tmpl, got = step(tmpl, torch.from_numpy(scan))
        assert set(got) == set(ref)
        for k in FLOAT_FIELDS:
            np.testing.assert_allclose(t2n(got[k]), np.asarray(ref[k]),
                                       err_msg=f"step {i} {k}", **F32)
        np.testing.assert_allclose(t2n(tmpl), np.asarray(tmpl_j), **F32)
        _assert_same_detections(got, ref)
        # and exactly the same NMS on identical inputs
        clean = np.nan_to_num(scan, nan=CUTOUT_KW["padding_val"])
        res = nms_predicted_center(
            torch.from_numpy(clean), PHI,
            torch.tensor(np.asarray(ref["pred_cls"])),
            torch.tensor(np.asarray(ref["pred_reg"])))
        np.testing.assert_array_equal(t2n(res[2]).astype(bool),
                                      np.asarray(ref["det_keep"]))
        np.testing.assert_array_equal(t2n(res[3]),
                                      np.asarray(ref["instance_mask"]))


def test_v3_engine_matches_jax(pair):
    model, variables, port = pair
    ref_step = jax_v3(model, variables, CUTOUT_KW, num_pts=NUM_PTS, tile=16,
                      precision="bf16", interpret=True)
    step = make_serve_step_v3(port, CUTOUT_KW, num_pts=NUM_PTS, device="cpu")
    carry_j, carry = None, None
    for i, scan in enumerate(_scans(31)):
        carry_j, ref = ref_step(carry_j, jnp.asarray(scan))
        carry, got = step(carry, torch.from_numpy(scan))
        assert set(got) == set(ref)
        for k in FLOAT_FIELDS:
            assert_close_to_max(t2n(got[k]), np.asarray(ref[k]), BF16_REL,
                                f"step {i} {k}")
        for k in ("template", "z"):
            assert carry[k].dtype == torch.bfloat16
            assert_close_to_max(t2n(carry[k]),
                                np.asarray(carry_j[k], np.float32),
                                BF16_REL, f"step {i} carry {k}")
        # NMS on identical inputs: the JAX step's own predictions
        clean = np.nan_to_num(scan, nan=CUTOUT_KW["padding_val"])
        res = nms_predicted_center_topk(
            torch.from_numpy(clean), PHI,
            torch.tensor(np.asarray(ref["pred_cls"])),
            torch.tensor(np.asarray(ref["pred_reg"])), top_k=64)
        np.testing.assert_array_equal(t2n(res[2]).astype(bool),
                                      np.asarray(ref["det_keep"]))
        np.testing.assert_array_equal(t2n(res[3]),
                                      np.asarray(ref["instance_mask"]))


@pytest.mark.parametrize("engine", ["module", "v3", "int8c"])
def test_runner_with_stream_reset_matches_jax(pair, engine):
    """int8c: both runners calibrate on their first batch, padded as the
    JAX p2 path pads it (``pm_tile=160``: 160 beams)."""
    model, variables, port = pair
    ref = JaxRunner(model, variables, CUTOUT_KW, num_pts=NUM_PTS,
                    engine=engine, output_fields=("pred_cls", "pred_flow"))
    run = StreamingRunner(port, CUTOUT_KW, num_pts=NUM_PTS, engine=engine,
                          output_fields=("pred_cls", "pred_flow"),
                          device="cpu")
    for i, scan in enumerate(_scans(32, steps=4)):
        if i == 2:
            ref.reset(streams=[1])
            run.reset(streams=[1])
        a, b = run(torch.from_numpy(scan)), ref(scan)
        assert set(a) == {"pred_cls", "pred_flow"}
        for k in a:
            if engine == "module":
                np.testing.assert_allclose(t2n(a[k]), np.asarray(b[k]),
                                           err_msg=f"step {i} {k}", **F32)
            elif engine == "int8c" and k == "pred_cls":
                np.testing.assert_allclose(t2n(a[k]), np.asarray(b[k]),
                                           err_msg=f"step {i} {k}", **INT8)
            else:
                # the flow head runs in bf16 on outputs of ~100 here: a
                # one-ulp change of its input moves a near-zero entry by
                # more than 5e-2, so flow is held at bf16's 2e-2 x max
                assert_close_to_max(t2n(a[k]), np.asarray(b[k]), BF16_REL,
                                    f"step {i} {k}")
    if engine == "int8c":
        got, want = run.calibration, ref.calibration
        np.testing.assert_allclose(got.bb_act_scales + got.hd_act_scales,
                                   want.bb_act_scales + want.hd_act_scales,
                                   rtol=1e-5)
        assert run._carry["template"].dtype == torch.int8
    run.reset()
    assert run._carry is None


# step -> the ``reset`` calls made before it
RESTARTS = {
    "two_streams": {1: [[1, 3]]},
    "two_calls": {1: [[3], [5, 1, 3]]},
    "consecutive_steps": {1: [[1, 3]], 2: [[6]]},
    "every_stream": {1: [list(range(8))]},
}


def _restart_before(step, carry, scan, streams):
    """The restart step as the runner made it before: the bootstrap of the
    whole batch, the carried pass, and the restarted streams' rows taken
    from the bootstrap by ``merge_stream_carries`` and a mask."""
    mask = np.zeros(scan.shape[0], dtype=bool)
    mask[streams] = True
    boot_carry, boot_out = step(None, scan)
    carry, out = step(carry, scan)
    m = torch.from_numpy(mask)
    return merge_stream_carries(carry, boot_carry, mask), {
        k: torch.where(m.reshape((-1,) + (1,) * (v.ndim - 1)), boot_out[k], v)
        for k, v in out.items()}


def _assert_bits(got, want, what, near=()):
    """Equal to the bit, but the keys ``near``: within 1e-5 x max|want|."""
    got, want = ((x if isinstance(x, dict) else {"template": x})
                 for x in (got, want))
    assert set(got) == set(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        if k in near:
            assert_close_to_max(t2n(got[k]), t2n(want[k]), 1e-5,
                                f"{what} {k}")
        else:
            assert torch.equal(got[k], want[k]), (what, k)


@pytest.fixture(scope="module")
def b8_runners(pair):
    """One runner an engine at B=8, shared by the restart cases (each
    starts with ``reset()``); int8c calibrated on the cases' first batch."""
    calib = torch.from_numpy(_scans(33, steps=4, b=8)[0])
    return {engine: StreamingRunner(
        pair[2], CUTOUT_KW, num_pts=NUM_PTS, engine=engine,
        calib_scans=calib if engine == "int8c" else None, device="cpu")
        for engine in ("module", "v3", "int8c")}


@pytest.mark.parametrize("case", sorted(RESTARTS))
@pytest.mark.parametrize("engine", ["module", "v3", "int8c"])
def test_restart_bootstraps_the_restarted_rows_alone(b8_runners, engine,
                                                     case):
    """A runner with restarts equals, to the bit (carry and every output),
    the whole-batch bootstrap merged into the carried pass, computed here
    from the runner's own step. The one exception: the module engine's f32
    flow head convolves a batch of one stream with another of oneDNN's
    kernels (another order of sums), so its ``pred_flow`` is held at 1e-5 x
    max, ~80 f32 ulps of the largest flow (it reads ~5e-7)."""
    scans = torch.from_numpy(_scans(33, steps=4, b=8))
    run = b8_runners[engine]
    run.reset()
    carry = None
    for i, scan in enumerate(scans):
        streams = set()
        for call in RESTARTS[case].get(i, ()):
            run.reset(call)
            streams.update(call)
        got = run(scan)
        if streams:
            carry, want = _restart_before(run._step, carry, scan,
                                          sorted(streams))
        else:
            carry, want = run._step(carry, scan)
        _assert_bits(got, want, f"step {i} outputs",
                     near=("pred_flow",) if engine == "module" else ())
        _assert_bits(run._carry, carry, f"step {i} carry")


def test_v3_against_module_engine(pair):
    """bf16 serving vs the f32 reference, both in the port: the tolerance
    of the JAX package's own test (corr > 0.99, max diff < 0.15 x
    max(|ref|, 1))."""
    _, _, port = pair
    v3 = make_serve_step_v3(port, CUTOUT_KW, num_pts=NUM_PTS, device="cpu")
    ref_step = make_stream_step(port, CUTOUT_KW, num_pts=NUM_PTS,
                                device="cpu")
    carry, tmpl = None, None
    for i, scan in enumerate(_scans(33)):
        carry, got = v3(carry, torch.from_numpy(scan))
        tmpl, ref = ref_step(tmpl, torch.from_numpy(scan))
        for k in FLOAT_FIELDS:
            a, b = t2n(got[k]).ravel(), t2n(ref[k]).ravel()
            assert np.corrcoef(a, b)[0, 1] > 0.99, (i, k)
            assert np.abs(a - b).max() < 0.15 * max(np.abs(b).max(), 1.0)


def test_int8c_against_module_engine(pair):
    """int8 serving vs the f32 reference, both in the port: the JAX int8c
    bar (``tests/test_fast_gate.py``: corr > 0.95 on cls and flow)."""
    _, _, port = pair
    scans = _scans(35, steps=4)
    step = make_serve_step_v3(port, CUTOUT_KW, calib_scans=scans[0],
                              num_pts=NUM_PTS, precision="int8c",
                              device="cpu")
    ref_step = make_stream_step(port, CUTOUT_KW, num_pts=NUM_PTS,
                                device="cpu")
    carry, tmpl = None, None
    for i, scan in enumerate(scans[1:]):
        carry, got = step(carry, torch.from_numpy(scan))
        tmpl, ref = ref_step(tmpl, torch.from_numpy(scan))
        for k in ("pred_cls", "pred_flow"):
            a, b = t2n(got[k]).ravel(), t2n(ref[k]).ravel()
            assert np.isfinite(a).all()
            assert np.corrcoef(a, b)[0, 1] > 0.95, (i, k)


def test_lazy_int8c_runner_calibrates_on_a_nan_batch(pair):
    """The lazily calibrating runner feeds its first live batch into
    calibration; a NaN beam there must not poison the scales."""
    _, _, port = pair
    run = StreamingRunner(port, CUTOUT_KW, num_pts=NUM_PTS, engine="int8c",
                          device="cpu")
    assert run.calibration is None
    scans = _scans(36, steps=2)
    scans[0, 0, :7] = np.nan
    scans[0, 1, 9] = np.inf
    for scan in scans:
        out = run(torch.from_numpy(scan))
        assert all(bool(torch.isfinite(v.float()).all()) for v in out.values())
    cal = run.calibration
    assert all(np.isfinite([cal.bb_in_scale, cal.hd_in_scale]
                           + cal.bb_act_scales + cal.hd_act_scales))


def test_v3_guards(pair):
    """Every option of the JAX builder builds: int8c with the default
    layout, ``"pm"``, ``"flat"``, ``"p2c"`` and ``"cell"``, with
    ``fuse_gate_head=True``, and ``precision="int8"``, each running a
    bootstrap and a carried step; the JAX builder's checks and unknown
    modes raise."""
    _, _, port = pair
    kw = dict(num_pts=NUM_PTS, device="cpu")
    with pytest.raises(ValueError, match="fuse_gate_head=True requires"):
        make_serve_step_v3(port, CUTOUT_KW, precision="int8c", layout="cell",
                           fuse_gate_head=True, **kw)
    with pytest.raises(ValueError, match="fuse_gate_head=True requires"):
        make_serve_step_v3(port, CUTOUT_KW, precision="int8c",
                           gate_per_stream=False, fuse_gate_head=True, **kw)
    with pytest.raises(ValueError, match="requires precision='int8c'"):
        make_serve_step_v3(port, CUTOUT_KW, layout="pm", **kw)
    with pytest.raises(ValueError, match="unknown precision"):
        make_serve_step_v3(port, CUTOUT_KW, precision="fp8", **kw)
    with pytest.raises(ValueError, match="unknown p2_l1_mode"):
        make_serve_step_v3(port, CUTOUT_KW, precision="int8c",
                           p2_l1_mode="pairs", calib_scans=_scans(34)[0],
                           **kw)
    with pytest.raises(ValueError, match="fuse_gate_head=True requires"):
        make_serve_step_v3(port, CUTOUT_KW, precision="int8c",
                           layout="flat", fuse_gate_head=True, **kw)
    step = make_serve_step_v3(port, CUTOUT_KW, calib_scans=_scans(34)[0],
                              precision="int8c", **kw)
    assert step.calibration is not None
    calib = step.calibration
    for extra in (dict(precision="int8"), dict(precision="int8", layout="flat"),
                  dict(precision="int8c", layout="pm"),
                  dict(precision="int8c", layout="flat"),
                  dict(precision="int8c", layout="p2c"),
                  dict(precision="int8c", layout="cell"),
                  dict(precision="int8c", fuse_gate_head=True),
                  dict(precision="int8c", layout="pm", fuse_gate_head=True),
                  dict(precision="int8c", layout="p2c",
                       fuse_gate_head=True)):
        step = make_serve_step_v3(port, CUTOUT_KW, calib=calib, **extra,
                                  **kw)
        carry = None
        for scan in _scans(34):
            carry, out = step(carry, torch.from_numpy(scan))
            assert out["pred_cls"].shape == (2, NUM_PTS, 1), extra
        assert carry["template"].dtype == (
            torch.bfloat16 if extra["precision"] == "int8" else torch.int8)
    with pytest.raises(ValueError, match="unknown engine"):
        StreamingRunner(port, CUTOUT_KW, num_pts=NUM_PTS, engine="int8",
                        device="cpu")
    with pytest.raises(ValueError, match="unknown output_fields"):
        make_serve_step_v3(port, CUTOUT_KW, num_pts=NUM_PTS,
                           output_fields=("nope",), device="cpu")
    step = make_serve_step_v3(port, CUTOUT_KW, num_pts=NUM_PTS,
                              output_fields=("pred_flow", "det_keep"),
                              device="cpu")
    assert step.calibration is None
    _, out = step(None, torch.from_numpy(_scans(34)[0]))
    assert set(out) == {"pred_flow", "det_keep"}
    assert out["pred_flow"].shape == (2, NUM_PTS, 2)
    assert out["det_keep"].shape == (2, 64)
