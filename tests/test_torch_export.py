"""The port's serving and model artifacts (``infer/export.py``, the export
CLIs and ``--artifact``), on the CPU, mirroring
``tests/test_serving_export.py``.

* every ``make_serve_step_v3`` configuration exported with the plain
  versions forbidden (so every kernel's work is an op node: K1-K13 as
  ``pof_torch::`` nodes, and the step's other ops), loaded, and equal to its
  live step to the bit over boot + 2 carried steps;
* the int8c p2 and bf16 engines with their NMS: loaded against live to the
  bit, and against the JAX package's CPU-exported engine at
  ``tests/test_torch_int8.py``'s bars (template within 1 LSB, under 5e-3 of
  it off by one; z and ``pred_*`` at 5e-2) and
  ``tests/test_torch_streaming.py``'s (2e-2 x max on the float outputs and
  the carry);
* multi-batch routing, stale-program pruning, an interrupted re-export that
  stays loadable, the schema, JAX-artifact and CUDA-artifact guards;
* ``StreamingRunner.from_artifact`` with a per-stream reset, equal to the
  live runner to the bit;
* ``export_model`` of the flow U-Net and the box regressor,
  ``BoxRegressor.from_artifact`` and its chunk routing;
* the CLIs: ``cli.export_serving`` -> ``cli.infer --artifact`` and
  ``cli.evaluate --artifact``, the int8c calibration guard,
  ``cli.export_model`` and its refusal of streaming types.

Geometry: 64 beams, 16 cutout points, window 5, B=2.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.infer import (
    export_serving_engine as jax_export,
    load_serving_engine as jax_load,
)
from planar_optical_flow_tpu.infer.streaming import (
    make_serve_step_v3 as jax_v3,
)
from planar_optical_flow_tpu_torch.cli import evaluate as evaluate_cli
from planar_optical_flow_tpu_torch.cli import export_model as export_model_cli
from planar_optical_flow_tpu_torch.cli import (
    export_serving as export_serving_cli,
)
from planar_optical_flow_tpu_torch.cli import infer as infer_cli
from planar_optical_flow_tpu_torch.infer import (
    BoxRegressor,
    ServeCalibration,
    StreamingRunner,
    export_model,
    export_serving_engine,
    load_model,
    load_serving_engine,
    make_serve_step_v3,
)
from planar_optical_flow_tpu_torch.infer.export import SCHEMA_VERSION
from planar_optical_flow_tpu_torch.models import FlowUNet, get_model
from planar_optical_flow_tpu_torch.data import write_synthetic_drow_split
from planar_optical_flow_tpu_torch.data.prepare import prepare_split
from tests.test_torch_common import (
    CUTOUT_KW,
    NUM_PTS,
    WINDOW,
    assert_close_to_max,
    flow_drow_pair,
    one_thread,  # noqa: F401 (a fixture)
    t2n,
    to_jax,
)

B = 2
TILE = 32         # the JAX pm tile of tests/test_torch_int8.py
L4 = CUTOUT_KW["num_cutout_pts"] // 4
INT8 = dict(rtol=5e-2, atol=5e-2)  # tests/test_int8_serving_gate.py
BF16_REL = 2e-2
FLOAT_FIELDS = ("pred_cls", "pred_reg", "pred_flow")
CONFIGS = {
    "bf16": (dict(precision="bf16"),
             ["cutout", "backbone_bf16", "gate", "head"]),
    "int8": (dict(precision="int8"),
             ["cutout", "backbone_int8_tail", "gate", "head_int8"]),
    "p2": (dict(precision="int8c"),
           ["cutout", "backbone_int8", "gate_int8", "head_int8"]),
    "pm": (dict(precision="int8c", layout="pm", pm_tile=TILE),
           ["cutout", "backbone_int8_pm", "gate_int8", "head_int8"]),
    "flat": (dict(precision="int8c", layout="flat"),
             ["cutout", "backbone_int8_tail", "gate_int8", "head_int8"]),
    "p2c": (dict(precision="int8c", layout="p2c"),
            ["backbone_int8_cut", "gate_int8", "head_int8"]),
    "cell": (dict(precision="int8c", layout="cell"),
             ["cutout", "serve_cell_int8"]),
    "fused": (dict(precision="int8c", fuse_gate_head=True),
              ["cutout", "backbone_int8", "gate_head_int8"]),
}
# the bootstraps run the unfused kernels
BOOT_OPS = {"cell": ["cutout", "backbone_int8_pm", "gate_int8", "head_int8"],
            "fused": ["cutout", "backbone_int8", "gate_int8", "head_int8"]}
# every plain version of a kernel (none may be traced into a program)
PLAIN = {
    "ops.kernels.cutout_kernel": ("cutout_plain",),
    "ops.kernels.conv_stack": (
        "backbone_tail_plain", "head_plain", "backbone_bf16_plain",
        "backbone_int8_plain", "backbone_int8_pm_plain",
        "backbone_int8_tail_plain", "head_int8_plain",
        "backbone_int8_cut_plain", "row_shift_plain"),
    "infer.fast_gate": ("gate_plain", "gate_int8_plain",
                        "gate_head_int8_plain"),
    "ops.kernels.serve_cell": ("serve_cell_int8_plain",),
}
FLAT_CFG = {
    "network": "cutout_spatial", "pedestrian_only": True, "num_scans": 2,
    "epochs": 1, "batch_size": 2,
    "similarity_kwargs": {"alpha": 0.5, "window_size": WINDOW},
    "cutout_kwargs": CUTOUT_KW,
}


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


@pytest.fixture(scope="module")
def setup():
    """The model pair and the JAX int8c p2 step's calibration, read by the
    port through its JSON."""
    model, v_np, port = flow_drow_pair(seed=3)
    port.requires_grad_(False)
    calib_scans = _scans(40, steps=1)[0]
    jstep = jax_v3(model, to_jax(v_np), CUTOUT_KW, calib_scans=calib_scans,
                   num_pts=NUM_PTS, precision="int8c", layout="p2",
                   pm_tile=TILE, interpret=True)
    calib = ServeCalibration.from_dict(jstep.calibration.to_dict())
    return dict(model=model, v_np=v_np, port=port, jstep=jstep, calib=calib)


def _scans(seed, steps=3, b=B, num_pts=NUM_PTS):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 20.0, (steps, b, num_pts)).astype(np.float32)


@contextlib.contextmanager
def _no_plain():
    """Every plain version of :data:`PLAIN` raises if called."""
    saved = []
    for mod, names in PLAIN.items():
        m = importlib.import_module(f"planar_optical_flow_tpu_torch.{mod}")
        for name in names:
            saved.append((m, name, getattr(m, name)))

            def forbidden(*args, _name=name, **kwargs):
                raise AssertionError(f"{_name} traced into a program")

            setattr(m, name, forbidden)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def _ops(path, name):
    program = torch.export.load(os.path.join(path, name))
    return [n.target._opname for n in program.graph.nodes
            if n.op == "call_function"
            and getattr(n.target, "namespace", "") == "pof_torch"]


def _assert_equal(got, ref, what):
    assert set(got) == set(ref), what
    for k in ref:
        assert got[k].dtype == ref[k].dtype, (what, k)
        assert torch.equal(got[k], ref[k]), (what, k)


def _run_both(live, engine, scans):
    """boot + carried steps of the live step and the engine, held to the
    bit; a NaN in the second scan."""
    carry_l = carry_e = None
    for i, scan in enumerate(scans):
        scan = torch.from_numpy(scan.copy())
        if i == 1:
            scan[1, 7] = float("nan")
        carry_l, out_l = live(carry_l, scan)
        carry_e, out_e = engine(carry_e, scan)
        _assert_equal(out_e, out_l, f"step {i} outputs")
        _assert_equal(carry_e, carry_l, f"step {i} carry")
    return carry_e


@pytest.mark.parametrize("name", CONFIGS)
def test_every_v3_configuration_round_trips(setup, name, tmp_path):
    """Exported with the plain versions forbidden: the kernels' work is in
    the op nodes only. (Without the NMS, which is the same glue in every
    configuration and which the next test exports.)"""
    opts, ops = CONFIGS[name]
    step = make_serve_step_v3(setup["port"], CUTOUT_KW, calib=setup["calib"],
                              num_pts=NUM_PTS, with_nms=False, device="cpu",
                              **opts)
    with _no_plain():
        export_serving_engine(str(tmp_path), step, (B, NUM_PTS))
    assert _ops(str(tmp_path), "step.pt2") == ops
    assert _ops(str(tmp_path), "boot.pt2") == BOOT_OPS.get(name, ops)
    engine = load_serving_engine(str(tmp_path))
    assert engine.meta["precision"] == opts["precision"]
    assert engine.meta["platforms"] == ["cpu"]
    _run_both(step, engine, _scans(60))


@pytest.fixture(scope="module")
def full_engines(setup, tmp_path_factory):
    """The int8c p2 and bf16 steps with their NMS, exported: {precision:
    (live step, artifact directory)}."""
    out = {}
    for precision in ("int8c", "bf16"):
        step = make_serve_step_v3(setup["port"], CUTOUT_KW,
                                  calib=setup["calib"], num_pts=NUM_PTS,
                                  precision=precision, device="cpu")
        path = str(tmp_path_factory.mktemp(precision))
        export_serving_engine(path, step, (B, NUM_PTS),
                              meta={"engine": precision})
        out[precision] = (step, path)
    return out


def _pm_to_port(a):
    return (np.asarray(a).reshape(-1, L4, TILE, 256).transpose(0, 2, 1, 3)
            .reshape(-1, L4 * 256))


@pytest.mark.parametrize("precision", ["int8c", "bf16"])
def test_loaded_engine_matches_live_and_jax_artifact(setup, full_engines,
                                                     precision, tmp_path):
    step, path = full_engines[precision]
    engine = load_serving_engine(path)
    assert engine.meta["engine"] == precision
    assert engine.meta["batch"] == B and engine.meta["batches"] == [B]
    assert "jax_version" not in engine.meta
    assert engine.meta["torch_version"] == torch.__version__
    jstep = (setup["jstep"] if precision == "int8c" else jax_v3(
        setup["model"], to_jax(setup["v_np"]), CUTOUT_KW, num_pts=NUM_PTS,
        precision="bf16", tile=16, interpret=True))
    jengine = jax_load(jax_export(str(tmp_path), jstep,
                                  jax.ShapeDtypeStruct((B, NUM_PTS),
                                                       np.float32)))
    carry_l = carry_e = carry_j = None
    for i, scan in enumerate(_scans(61)):
        carry_l, out_l = step(carry_l, torch.from_numpy(scan))
        carry_e, out_e = engine(carry_e, torch.from_numpy(scan))
        carry_j, out_j = jengine(carry_j, jax.numpy.asarray(scan))
        _assert_equal(out_e, out_l, f"step {i} outputs")
        _assert_equal(carry_e, carry_l, f"step {i} carry")
        assert set(out_e) == set(out_j)
        for k in FLOAT_FIELDS:
            if precision == "int8c":
                np.testing.assert_allclose(t2n(out_e[k]), np.asarray(out_j[k]),
                                           err_msg=f"step {i} {k}", **INT8)
            else:
                assert_close_to_max(t2n(out_e[k]), np.asarray(out_j[k]),
                                    BF16_REL, f"step {i} {k}")
        if precision == "int8c":
            diff = np.abs(carry_e["template"].numpy().astype(np.int32)
                          - _pm_to_port(carry_j["template"]).astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 5e-3
            np.testing.assert_allclose(t2n(carry_e["z"]),
                                       np.asarray(carry_j["z"], np.float32),
                                       err_msg=f"step {i} z", **INT8)
        else:
            for k in ("template", "z"):
                assert_close_to_max(t2n(carry_e[k]),
                                    np.asarray(carry_j[k], np.float32),
                                    BF16_REL, f"step {i} carry {k}")


def test_runner_from_artifact_with_stream_reset(setup, full_engines):
    """The artifact runner (its path, then its loaded engine) against the
    live int8c runner on the same calibration, a per-stream reset on the
    third batch: the same carries and outputs to the bit."""
    _, path = full_engines["int8c"]
    live = StreamingRunner(setup["port"], CUTOUT_KW, num_pts=NUM_PTS,
                           engine="int8c", calib=setup["calib"], device="cpu")
    runners = [StreamingRunner.from_artifact(path)]
    runners.append(StreamingRunner.from_artifact(runners[0]._step))
    assert runners[0].meta["num_pts"] == NUM_PTS
    for i, scan in enumerate(_scans(62, steps=4)):
        if i == 2:
            for r in (live, *runners):
                r.reset(streams=[1])
        want = live(torch.from_numpy(scan))
        for r in runners:
            _assert_equal(r(torch.from_numpy(scan)), want, f"step {i}")
            _assert_equal(r._carry, live._carry, f"step {i} carry")
    with pytest.raises(ValueError, match="out of range"):
        runners[0].reset(streams=[5])
        runners[0](torch.from_numpy(scan))


@pytest.fixture(scope="module")
def small_step(setup):
    """A bf16 step without the NMS (quick to export)."""
    return make_serve_step_v3(setup["port"], CUTOUT_KW, num_pts=NUM_PTS,
                              with_nms=False, device="cpu")


def test_multi_batch_routing_and_pruning(small_step, tmp_path):
    out = str(tmp_path / "engine")
    export_serving_engine(out, small_step, [(1, NUM_PTS), (4, NUM_PTS)],
                          meta={"batch": 999})
    engine = load_serving_engine(out)
    assert engine.meta["batches"] == [1, 4] and engine.meta["batch"] is None
    assert {"boot_b1.pt2", "step_b4.pt2"} <= set(os.listdir(out))
    rng = np.random.default_rng(63)
    for b in (1, 4):
        scan = torch.from_numpy(
            rng.uniform(0.5, 20.0, (b, NUM_PTS)).astype(np.float32))
        carry, want = small_step(None, scan)
        got_carry, got = engine(None, scan)
        _assert_equal(got, want, f"batch {b}")
        _, want = small_step(carry, scan)
        _, got = engine(got_carry, scan)
        _assert_equal(got, want, f"batch {b} carried")
    with pytest.raises(ValueError, match=r"batches \[1, 4\]"):
        engine(None, torch.zeros(2, NUM_PTS))
    with pytest.raises(ValueError, match="duplicate"):
        export_serving_engine(str(tmp_path / "dup"), small_step,
                              [(1, NUM_PTS), (1, NUM_PTS)])

    # a re-export with another batch list: new programs under the next
    # generation's names, the stale ones pruned
    export_serving_engine(out, small_step, (4, NUM_PTS))
    engine = load_serving_engine(out)
    assert engine.meta["generation"] == 1 and engine.meta["batch"] == 4
    names = set(os.listdir(out))
    assert not {"boot_b1.pt2", "step_b1.pt2"} & names
    referenced = {n for pair in engine.meta["files"].values() for n in pair}
    assert referenced == {n for n in names if n.endswith(".pt2")}
    engine(None, torch.zeros(4, NUM_PTS))


def test_next_generation_corrupt_meta_scans_programs(tmp_path):
    from planar_optical_flow_tpu_torch.infer.export import _next_generation

    d = str(tmp_path)
    assert _next_generation(d, "engine.json") == 0
    (tmp_path / "engine.json").write_text("{not json")
    assert _next_generation(d, "engine.json") == 1
    (tmp_path / "step_b4.g2.pt2").write_bytes(b"x")
    (tmp_path / "boot_b4.g1.pt2").write_bytes(b"x")
    assert _next_generation(d, "engine.json") == 3
    (tmp_path / "step_b4.g5.pt2.tmp").write_bytes(b"x")
    assert _next_generation(d, "engine.json") == 6
    (tmp_path / "engine.json").write_text('{"generation": 7}')
    assert _next_generation(d, "engine.json") == 8


def test_interrupted_reexport_stays_loadable(tmp_path, monkeypatch):
    """A re-export that dies at the meta's replace leaves the earlier
    artifact loadable and serving the earlier function; a completed one
    flips to the new function and prunes."""
    def sig(b):
        return (torch.zeros(b, 8),)

    out = str(tmp_path / "m")
    export_model(out, lambda a: a * 2.0, [sig(2), sig(5)])
    real_replace = os.replace

    def dying_replace(src, dst):
        if dst.endswith("model.json"):
            raise OSError("injected crash at meta replace")
        return real_replace(src, dst)

    for fn, batches in ((lambda a: a * 2.0, [4]), (lambda a: a * 3.0, [4])):
        monkeypatch.setattr(os, "replace", dying_replace)
        with pytest.raises(OSError, match="injected"):
            export_model(out, fn, [sig(b) for b in batches])
        monkeypatch.undo()
        engine = load_model(out)
        assert engine.meta["batches"] in ([2, 5], [4])
        b = engine.meta["batches"][0]
        assert torch.equal(engine(torch.ones(b, 8)),
                           torch.full((b, 8), 2.0))
        assert not [f for f in os.listdir(out) if f.endswith(".pt2.tmp")]
        export_model(out, lambda a: a * 2.0, [sig(4)])
    export_model(out, lambda a: a * 3.0, [sig(4)])
    engine = load_model(out)
    assert torch.equal(engine(torch.ones(4, 8)), torch.full((4, 8), 3.0))
    assert ({f for f in os.listdir(out) if f.endswith(".pt2")}
            == set(engine.meta["files"].values()))
    assert not [f for f in os.listdir(out) if ".tmp" in f]

    # a failed export leaves the directory as it was
    def boom(a):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        export_model(out, boom, [sig(7)])
    assert load_model(out).meta["batches"] == [4]


def test_load_guards(small_step, tmp_path, monkeypatch):
    out = str(tmp_path / "e")
    export_serving_engine(out, small_step, (B, NUM_PTS))
    meta_path = os.path.join(out, "engine.json")
    meta = json.loads(open(meta_path).read())
    assert meta["schema_version"] == SCHEMA_VERSION

    def write(m):
        with open(meta_path, "w") as f:
            json.dump(m, f)

    write(dict(meta, schema_version=SCHEMA_VERSION + 1))
    with pytest.raises(ValueError, match="schema version.*upgrade"):
        load_serving_engine(out)
    write(dict(meta, schema_version="two"))
    with pytest.raises(ValueError, match="unreadable schema_version"):
        load_serving_engine(out)
    write({k: v for k, v in meta.items() if k != "schema_version"})
    assert load_serving_engine(out) is not None  # unstamped: version 1
    # an artifact of the JAX package
    write(dict(meta, jax_version="0.4.30"))
    with pytest.raises(ValueError, match="written by the JAX package"):
        load_serving_engine(out)
    write(dict(meta, files={str(B): ["boot.bin", "step.bin"]}))
    with pytest.raises(ValueError, match="written by the JAX package"):
        load_serving_engine(out)
    # a CUDA artifact on a host without a card, never run on the CPU
    write(dict(meta, platforms=["cuda"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA card"):
        load_serving_engine(out)
    write(dict(meta, platforms=["tpu"]))
    with pytest.raises(ValueError, match="exported for platform"):
        load_serving_engine(out)
    model_dir = export_model(str(tmp_path / "m"), lambda a: a + 1.0,
                             (torch.zeros(2, 3),))
    model_meta = os.path.join(model_dir, "model.json")
    m = json.loads(open(model_meta).read())
    with open(model_meta, "w") as f:
        json.dump(dict(m, platforms=["cuda"]), f)
    with pytest.raises(ValueError, match="no CUDA card"):
        load_model(model_dir)


def test_export_model_flow_unet(tmp_path):
    gen = torch.Generator().manual_seed(4)
    model = FlowUNet(generator=gen).eval()
    model.requires_grad_(False)

    def sig(b):
        return (torch.zeros(b, 64, 2), torch.zeros(b, 64, 2))

    out = export_model(str(tmp_path / "m"), model, [sig(2), sig(5)],
                       meta={"model_type": "flow_unet"})
    engine = load_model(out)
    assert engine.meta["batches"] == [2, 5]
    assert engine.meta["model_type"] == "flow_unet"
    assert engine.meta["output_shapes"]["5"] == [
        {"shape": [5, 64, 2], "dtype": "float32"}]
    rng = np.random.default_rng(64)
    for b in (2, 5):
        a, c = (torch.from_numpy(rng.normal(size=(b, 64, 2)).astype(
            np.float32)) for _ in range(2))
        assert torch.equal(engine(a, c), model(a, c))
    with pytest.raises(ValueError, match="batch 3"):
        engine(torch.zeros(3, 64, 2), torch.zeros(3, 64, 2))
    with pytest.raises(ValueError, match="exported for"):
        engine(torch.zeros(2, 48, 2), torch.zeros(2, 48, 2))
    with pytest.raises(ValueError, match="takes 2 input"):
        engine(torch.zeros(2, 64, 2))
    with pytest.raises(ValueError, match="dtype"):
        engine(torch.zeros(2, 64, 2, dtype=torch.int32),
               torch.zeros(2, 64, 2))


BOX_CFG = {"is_3d": True, "input_size": 32, "radius_segment": 0.5,
           "input_with_angle": True, "min_segment_size": 1}


def test_box_regressor_artifact(tmp_path):
    """``cli.export_model`` on a box config; ``BoxRegressor.from_artifact``
    equal to the live regressor on the same weights, on frames that route
    to an exact program, a padded one and chunks."""
    cfg = {"dataset": {**BOX_CFG, "min_segment_size": 1},
           "model": {"type": "box_reg", "input_dim": 4, "target_dim": 5},
           "pipeline": {}}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    out = tmp_path / "boxreg"
    assert export_model_cli.main(["--cfg", str(cfg_path), "--out", str(out),
                                  "--batch", "3,5", "--cpu"]) == 0
    art = BoxRegressor.from_artifact(str(out), BOX_CFG)
    live = BoxRegressor(get_model(cfg["model"]).state_dict(), BOX_CFG,
                        device="cpu")
    rng = np.random.default_rng(65)
    points = rng.uniform(-3, 3, (400, 3)).astype(np.float32)
    for n_det in (3, 4, 12, 0):
        centers = rng.uniform(-2, 2, (n_det, 3)).astype(np.float32)
        boxes_a, ok_a = art(points, centers)
        boxes_l, ok_l = live(points, centers)
        np.testing.assert_array_equal(ok_a, ok_l)
        # a padded batch is another product shape, summed in another order
        # (tests/test_serving_export.py's bar)
        np.testing.assert_allclose(boxes_a, boxes_l, rtol=1e-5, atol=2e-5)
        assert boxes_a.shape == (n_det, 7)
    with pytest.raises(ValueError, match="expects segments"):
        BoxRegressor.from_artifact(str(out), dict(BOX_CFG, input_size=16))
    # a 2D+angle export (3 inputs, 3 outputs) under a 3D config without
    # the angle (also 3 inputs) is refused on its output width
    br2d = get_model({"type": "box_reg", "input_dim": 3, "target_dim": 3})
    br2d.requires_grad_(False)
    art2d = export_model(str(tmp_path / "br2d"), br2d,
                         (torch.zeros(2, 32, 3),),
                         meta={"model_type": "box_reg"})
    good = dict(BOX_CFG, is_3d=False)
    BoxRegressor.from_artifact(art2d, good)
    with pytest.raises(ValueError, match="predicts shape"):
        BoxRegressor.from_artifact(art2d, dict(good, is_3d=True,
                                               input_with_angle=False))
    flow = export_model(str(tmp_path / "flow"), lambda a: a * 1.0,
                        (torch.zeros(2, 32, 4),),
                        meta={"model_type": "flow_unet"})
    with pytest.raises(ValueError, match="not a box"):
        BoxRegressor.from_artifact(flow, BOX_CFG)
    with pytest.raises(SystemExit):
        export_model_cli.main(["--cfg", str(cfg_path), "--out",
                               str(tmp_path / "dup"), "--batch", "3,3",
                               "--cpu"])


def test_box_regressor_artifact_chunk_routing(monkeypatch):
    """Full chunks of the largest exported batch that fits, the rest
    padded to the program that costs the fewest rows."""
    from planar_optical_flow_tpu_torch.infer import export as export_mod

    calls = []

    class FakeEngine:
        device = torch.device("cpu")
        meta = {"model_type": "box_reg", "batches": [2, 16],
                "input_shapes": {
                    "2": [{"shape": [2, 8, 4], "dtype": "float32"}],
                    "16": [{"shape": [16, 8, 4], "dtype": "float32"}]}}

        def __call__(self, x):
            b = int(x.shape[0])
            assert b in (2, 16), f"un-exported batch {b} dispatched"
            calls.append(b)
            return x[:, 0, :2] * 0 + b

    monkeypatch.setattr(export_mod, "load_model", lambda path: FakeEngine())
    art = BoxRegressor.from_artifact("fake", dict(BOX_CFG, input_size=8))
    for rows, want in ((3, [2, 2]), (15, [16]), (17, [16, 2]), (0, [2])):
        calls.clear()
        out = art._forward(torch.zeros(rows, 8, 4))
        assert calls == want and out.shape[0] == rows


def test_export_model_cli_rejects_streaming(tmp_path):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"network": "cutout_spatial"}))
    with pytest.raises(SystemExit):
        export_model_cli.main(["--cfg", str(cfg_path), "--out",
                               str(tmp_path / "x"), "--cpu"])


def test_export_serving_cli_guards(tmp_path):
    """int8c needs a calibration, --calib needs int8c, a plain DROW has no
    gate to serve, and --batch is checked before any build."""
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(FLAT_CFG))
    out = str(tmp_path / "e")
    for argv in (["--engine", "int8c"],
                 ["--engine", "bf16", "--calib", "nope.json"],
                 ["--batch", "1,zap"], ["--batch", "2,2"]):
        with pytest.raises(SystemExit):
            export_serving_cli.main(["--cfg", str(cfg_path), "--out", out,
                                     "--cpu", *argv])
    cfg_path.write_text(json.dumps(dict(FLAT_CFG, network="cutout")))
    with pytest.raises(SystemExit):
        export_serving_cli.main(["--cfg", str(cfg_path), "--out", out,
                                 "--engine", "bf16", "--cpu"])
    assert not os.path.exists(out)


def test_cli_export_infer_evaluate(setup, tmp_path):
    """The deployment flow: ``cli.export_serving`` (int8c from the
    calibration saved beside the weights, batch 1), then ``cli.infer
    --artifact`` equal to ``cli.infer --engine int8c`` on the same weights
    to the bit, and ``cli.evaluate --artifact --ap --serve-flow``."""
    from planar_optical_flow_tpu_torch.interop.checkpoint import save_weights

    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(dict(FLAT_CFG,
                                        data_dir=str(tmp_path / "data"))))
    weights = save_weights(setup["port"], str(tmp_path / "w" / "weights.pt"))
    setup["calib"].save(os.path.dirname(weights))
    engine_dir = str(tmp_path / "engine")
    assert export_serving_cli.main(
        ["--cfg", str(cfg_path), "--ckpt", weights, "--out", engine_dir,
         "--batch", "1", "--num-pts", str(NUM_PTS), "--cpu"]) == 0
    meta = json.loads(open(os.path.join(engine_dir, "engine.json")).read())
    assert meta["model_type"] == "flow_drow" and meta["engine"] == "int8c"

    data = str(tmp_path / "data")
    stem = write_synthetic_drow_split(data, "val", num_sequences=1,
                                      num_frames=12, num_pts=NUM_PTS)[0]
    prepare_split(data, "val", verbose=False, device="cpu")
    rc, got, _ = infer_cli.infer(["--artifact", engine_dir, "--sequence",
                                  stem, "--cpu"])
    rc_l, want, _ = infer_cli.infer(["--cfg", str(cfg_path), "--ckpt",
                                     weights, "--engine", "int8c",
                                     "--sequence", stem, "--cpu"])
    assert rc == rc_l == 0 and len(got) == len(want) == 12
    for g, w in zip(got, want):
        for k in ("dets", "conf", "flow"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for extra in (["--cfg", str(cfg_path)], ["--engine", "int8c"]):
        with pytest.raises(SystemExit):
            infer_cli.main(["--artifact", engine_dir, "--sequence", stem,
                            "--cpu", *extra])

    scored = evaluate_cli.evaluate(["--cfg", str(cfg_path), "--artifact",
                                    engine_dir, "--ap", "--serve-flow",
                                    "--cpu"])
    assert scored["serve_engine"] == "artifact"
    assert 0.0 <= scored["ap"] <= 1.0 and scored["num_frames"] > 0
    assert np.isfinite(scored["serve_epe"])
    for argv in (["--engine", "v3", "--ap"], ["--ckpt", weights, "--ap"],
                 []):
        with pytest.raises(SystemExit):
            evaluate_cli.main(["--cfg", str(cfg_path), "--artifact",
                               engine_dir, "--cpu", *argv])


def test_artifact_eval_batch():
    import argparse

    parser = argparse.ArgumentParser()
    pick = evaluate_cli._artifact_eval_batch
    meta = {"num_pts": 64, "batches": [1, 4, 128], "batch": None}
    assert pick(meta, 10, 64, parser) == 4
    assert pick({"num_pts": 64, "batch": 2}, 10, 64, parser) == 2
    with pytest.raises(SystemExit):
        pick(meta, 10, 450, parser)
    with pytest.raises(SystemExit):
        pick({"num_pts": 64, "batches": [64]}, 10, 64, parser)
    meta2 = {"num_pts": 64, "batches": [2, 128], "batch": None}
    assert pick(meta2, 255, 64, parser, pick="coverage") == 2
    assert pick(meta2, 256, 64, parser, pick="coverage") == 128
    assert pick(meta2, 255, 64, parser) == 128


def test_new_modules_import_without_jax():
    """The export, import and op modules and their CLIs import nothing of
    JAX or the JAX package."""
    import subprocess
    import sys

    from tests.test_torch_common import REPO

    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['planar_optical_flow_tpu'] = None\n"
        "import planar_optical_flow_tpu_torch.ops.kernels.library\n"
        "import planar_optical_flow_tpu_torch.infer.export\n"
        "import planar_optical_flow_tpu_torch.interop.torch_ckpt\n"
        "import planar_optical_flow_tpu_torch.utils.cli\n"
        "import planar_optical_flow_tpu_torch.cli.export_serving\n"
        "import planar_optical_flow_tpu_torch.cli.export_model\n"
        "import planar_optical_flow_tpu_torch.cli.import_checkpoint\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'flax', "
        "'planar_optical_flow_tpu.')) and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
