"""The remaining serving engines against their JAX counterparts over three
steps (64 beams, 16 cutout points, window 5, B=2):

* ``make_fused_stream_step`` (K14's plain versions; JAX in interpret mode):
  f32 at the port's f32 parity bar (1e-3); bf16 at the JAX package's bf16
  bar; the full vote NMS equal to JAX's on JAX's own predictions (an
  untrained model's confidences tie to ~1e-6, so two f32 computations may
  keep a different slot; ``tests/test_torch_streaming.py`` compares the
  NMS the same way);
* ``make_serve_step``, both ``gate_mix`` values: f32 at 2e-4
  (``tests/test_fast_gate.py:133-138``) on outputs and carries, bf16 at the
  bf16 bar;
* ``make_stream_step(compute_dtype=bf16)``: the bf16 bar;
* ``make_quantized_stream_step``: the JAX test's own bar, mean |port -
  JAX| < 0.05 on ``pred_cls`` (``tests/test_quantized.py:74-75``), and
  every float output within 0.15 x max(|JAX|, 1). Its carried bf16 template
  equals JAX's to the bit here after two steps, but the int8 head's outputs
  differ by up to ~1e-2 from the second step on (on the first step they are
  equal when fed JAX's scales), a difference in what XLA's carried-step
  program hands the head that this test does not pin down;
* ``make_serve_sequence_processor`` (bf16 v3) and ``make_sequence_processor``
  (f32 module): the stacked outputs against the JAX processors', and equal
  to the bit to the port's own per-step runs.

The bf16 bar is the JAX package's bf16-vs-f32 one (``tests/test_fast_gate.py
:179-180``): correlation > 0.99 and max|port - JAX| < 0.15 x max(|JAX|, 1).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.infer import streaming as js
from planar_optical_flow_tpu.ops.geometry import get_laser_phi
from planar_optical_flow_tpu_torch.infer import streaming as ps
from planar_optical_flow_tpu_torch.ops.nms import nms_predicted_center
from tests.test_torch_common import (
    CUTOUT_KW,
    NUM_PTS,
    assert_close_to_max,
    flow_drow_pair,
    t2n,
    to_jax,
)

FLOAT_FIELDS = ("pred_cls", "pred_reg", "pred_flow")
F32 = dict(rtol=1e-3, atol=1e-3)
SERVE_F32 = dict(rtol=2e-4, atol=2e-4)  # tests/test_fast_gate.py:133-138
PHI = torch.as_tensor(get_laser_phi(num_pts=NUM_PTS), dtype=torch.float32)


@pytest.fixture(scope="module")
def pair():
    model, v_np, port = flow_drow_pair(seed=8)
    return model, to_jax(v_np), port


def _scans(seed, steps=3, b=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 20.0, (steps, b, NUM_PTS)).astype(np.float32)


def _bf16_bar(got, ref, what):
    a, r = t2n(got).ravel(), np.asarray(ref, np.float32).ravel()
    corr = np.corrcoef(a, r)[0, 1]
    assert corr > 0.99, (what, corr)
    assert np.abs(a - r).max() < 0.15 * max(np.abs(r).max(), 1.0), what


def _run(jax_step, port_step, scans, check, carry_keys=None):
    """Both steps over ``scans``; ``check(got, ref, what)`` on every float
    output and on the ``carry_keys`` leaves of the carry (the template
    itself when None)."""
    cj = cp = None
    for i, scan in enumerate(scans):
        cj, ref = jax_step(cj, jnp.asarray(scan))
        cp, got = port_step(cp, torch.from_numpy(scan))
        assert set(got) == set(ref)
        for k in FLOAT_FIELDS:
            check(got[k], ref[k], f"step {i} {k}")
        leaves = ([(cp, cj)] if carry_keys is None
                  else [(cp[k], cj[k]) for k in carry_keys])
        for g, r in leaves:
            check(g, r, f"step {i} carry")
    return cp, cj


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_fused_stream_step_matches_jax(pair, mode):
    model, variables, port = pair
    dt, jdt = ((None, None) if mode == "f32"
               else (torch.bfloat16, jnp.bfloat16))
    jax_step = js.make_fused_stream_step(model, variables, CUTOUT_KW,
                                         num_pts=NUM_PTS, compute_dtype=jdt,
                                         tile=16, interpret=True)
    step = ps.make_fused_stream_step(port, CUTOUT_KW, num_pts=NUM_PTS,
                                     compute_dtype=dt, device="cpu")
    cj = cp = None
    for i, scan in enumerate(_scans(40)):
        cj, ref = jax_step(cj, jnp.asarray(scan))
        cp, got = step(cp, torch.from_numpy(scan))
        assert set(got) == set(ref)
        assert cp.dtype == (dt or torch.float32)
        for k in FLOAT_FIELDS + ("template",):
            g, r = (cp, cj) if k == "template" else (got[k], ref[k])
            if mode == "f32":
                np.testing.assert_allclose(t2n(g), np.asarray(r), **F32,
                                           err_msg=f"step {i} {k}")
            else:
                _bf16_bar(g, r, f"step {i} {k}")
        # the NMS on identical inputs: JAX's own predictions
        res = nms_predicted_center(
            torch.from_numpy(scan), PHI,
            torch.tensor(np.asarray(ref["pred_cls"])),
            torch.tensor(np.asarray(ref["pred_reg"])))
        for k, v in zip(("det_xys", "det_cls", "det_keep", "instance_mask"),
                        res):
            np.testing.assert_allclose(t2n(v), np.asarray(ref[k], np.float32),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("gate_mix", ["pallas", "xla"])
def test_serve_step_matches_jax(pair, gate_mix, mode):
    model, variables, port = pair
    dt, jdt = ((None, None) if mode == "f32"
               else (torch.bfloat16, jnp.bfloat16))
    jax_step = js.make_serve_step(model, variables, CUTOUT_KW,
                                  num_pts=NUM_PTS, with_nms=False,
                                  compute_dtype=jdt, gate_mix=gate_mix,
                                  interpret=True)
    step = ps.make_serve_step(port, CUTOUT_KW, num_pts=NUM_PTS,
                              with_nms=False, compute_dtype=dt,
                              gate_mix=gate_mix, device="cpu")

    def check(got, ref, what):
        if mode == "f32":
            np.testing.assert_allclose(t2n(got), np.asarray(ref),
                                       err_msg=what, **SERVE_F32)
        else:
            _bf16_bar(got, ref, what)

    carry, _ = _run(jax_step, step, _scans(41), check, ("template", "z"))
    assert carry["template"].dtype == (dt or torch.float32)
    assert carry["template"].shape == (2, NUM_PTS, 4 * 256)


def test_quantized_stream_step_matches_jax(pair):
    model, variables, port = pair
    scans = _scans(42)
    jax_step = js.make_quantized_stream_step(model, variables, CUTOUT_KW,
                                             scans[0], num_pts=NUM_PTS,
                                             with_nms=False)
    step = ps.make_quantized_stream_step(port, CUTOUT_KW, scans[0],
                                         num_pts=NUM_PTS, with_nms=False,
                                         device="cpu")

    def check(got, ref, what):
        got, ref = t2n(got), np.asarray(ref, np.float32)
        assert np.abs(got - ref).max() < 0.15 * max(np.abs(ref).max(), 1.0)
        if "pred_cls" in what:
            assert np.abs(got - ref).mean() < 0.05, what

    template, _ = _run(jax_step, step, scans, check)
    assert template.dtype == torch.bfloat16


def test_stream_step_bf16_matches_jax(pair):
    model, variables, port = pair
    jstep = js.make_stream_step(model, CUTOUT_KW, num_pts=NUM_PTS,
                                with_nms=False, donate_template=False,
                                compute_dtype=jnp.bfloat16)
    cast = js.cast_variables(variables, jnp.bfloat16)
    step = ps.make_stream_step(port, CUTOUT_KW, num_pts=NUM_PTS,
                               with_nms=False, compute_dtype=torch.bfloat16,
                               device="cpu")
    scans = _scans(43)
    scans[1, 0, 5] = np.nan  # the sanitize guard is on in both
    template, _ = _run(lambda t, s: jstep(cast, t, s), step, scans,
                       _bf16_bar)
    assert template.dtype == torch.bfloat16
    assert next(port.parameters()).dtype == torch.float32  # a cast copy


def test_serve_sequence_processor_matches_jax(pair):
    model, variables, port = pair
    scans = _scans(44, steps=4)
    kw = dict(num_pts=NUM_PTS, with_nms=False, precision="bf16")
    fields = ("pred_cls", "pred_flow")
    jproc = js.make_serve_sequence_processor(model, variables, CUTOUT_KW,
                                             output_fields=fields, tile=16,
                                             interpret=True, **kw)
    proc = ps.make_serve_sequence_processor(port, CUTOUT_KW,
                                            output_fields=fields,
                                            device="cpu", **kw)
    carry_j, outs_j = jproc(jnp.asarray(scans))
    carry, outs = proc(torch.from_numpy(scans))
    assert set(outs) == set(fields) and proc.calibration is None
    for k in fields:
        assert outs[k].shape[0] == scans.shape[0]
        assert_close_to_max(t2n(outs[k]), np.asarray(outs_j[k], np.float32),
                            2e-2, k)
    assert_close_to_max(t2n(carry["template"]),
                        np.asarray(carry_j["template"], np.float32), 2e-2,
                        "template")
    # the same kernels as the per-step run, and the carry goes on
    step = ps.make_serve_step_v3(port, CUTOUT_KW, device="cpu", **kw)
    c = None
    for t, scan in enumerate(torch.from_numpy(scans)):
        c, out = step(c, scan)
        for k in fields:
            assert torch.equal(out[k], outs[k][t])
    assert all(torch.equal(c[k], carry[k]) for k in c)
    more, _ = proc(torch.from_numpy(scans[:1]), carry)
    c, _ = step(c, torch.from_numpy(scans[0]))
    assert all(torch.equal(c[k], more[k]) for k in c)


def test_sequence_processor_matches_jax(pair):
    model, variables, port = pair
    scans = _scans(45)
    jproc = js.make_sequence_processor(model, CUTOUT_KW, num_pts=NUM_PTS,
                                       with_nms=False)
    proc = ps.make_sequence_processor(port, CUTOUT_KW, num_pts=NUM_PTS,
                                      with_nms=False, device="cpu")
    tmpl_j, outs_j = jproc(variables, jnp.asarray(scans))
    tmpl, outs = proc(torch.from_numpy(scans))
    assert set(outs) == set(outs_j)
    for k in FLOAT_FIELDS:
        np.testing.assert_allclose(t2n(outs[k]), np.asarray(outs_j[k]),
                                   err_msg=k, **F32)
    np.testing.assert_allclose(t2n(tmpl), np.asarray(tmpl_j), **F32)


def test_cast_model_copies(pair):
    _, _, port = pair
    cast = ps.cast_model(port, torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in cast.parameters())
    bn = cast.dr_spaam.gate.embed_bn
    assert bn.running_var.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert torch.equal(cast.flow_out.conv.weight.float(),
                       port.flow_out.conv.weight.to(torch.bfloat16).float())


def test_new_builders_default_to_the_card(pair, monkeypatch):
    _, _, port = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scans = np.zeros((1, NUM_PTS), np.float32)
    for build in (lambda: ps.make_fused_stream_step(port, CUTOUT_KW,
                                                    num_pts=NUM_PTS),
                  lambda: ps.make_serve_step(port, CUTOUT_KW,
                                             num_pts=NUM_PTS),
                  lambda: ps.make_quantized_stream_step(
                      port, CUTOUT_KW, scans, num_pts=NUM_PTS),
                  lambda: ps.make_sequence_processor(port, CUTOUT_KW,
                                                     num_pts=NUM_PTS),
                  lambda: ps.make_serve_sequence_processor(
                      port, CUTOUT_KW, num_pts=NUM_PTS)):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    with pytest.raises(ValueError, match="gate_mix"):
        ps.make_serve_step(port, CUTOUT_KW, num_pts=NUM_PTS, gate_mix="dense",
                           device="cpu")
