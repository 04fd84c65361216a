"""The port's config loader, model registry, DROW readers, synthetic
writer, geometry helpers, targets and detection dataset against the JAX
package's, on the same files.

Data from ``write_synthetic_drow_split`` with pinned seeds at 64 beams;
readers, writer, dataset indices and integer targets exact, geometry within
1e-6 (relative, and absolute near 0), float targets within 1e-5.
"""

from __future__ import annotations

import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from planar_optical_flow_tpu.data import DrowDetectionDataset as JaxDataset
from planar_optical_flow_tpu.data import drow_io as jax_io
from planar_optical_flow_tpu.data import synthetic as jax_synth
from planar_optical_flow_tpu.models import get_model as jax_get_model
from planar_optical_flow_tpu.ops import geometry as jax_geo
from planar_optical_flow_tpu.ops import targets as jax_tgt
from planar_optical_flow_tpu.pipeline import normalize_config as jax_normalize
from planar_optical_flow_tpu.utils.config import load_config as jax_load
from planar_optical_flow_tpu_torch.data import DrowDetectionDataset
from planar_optical_flow_tpu_torch.data import drow_io, synthetic
from planar_optical_flow_tpu_torch.interop import variables_to_state_dict
from planar_optical_flow_tpu_torch.models import get_model
from planar_optical_flow_tpu_torch.models.registry import (
    NOT_PORTED,
    PORTED_MODEL_TYPES,
)
from planar_optical_flow_tpu_torch.ops import geometry as geo
from planar_optical_flow_tpu_torch.ops import targets as tgt
from planar_optical_flow_tpu_torch.pipeline import normalize_config
from planar_optical_flow_tpu_torch.utils.config import load_config

from tests.test_torch_common import one_thread  # noqa: F401
from tests.test_torch_common import REPO, perturb_batch_stats

NUM_PTS = 64
SPLIT_KW = dict(num_sequences=2, num_frames=20, num_people=8, seed=0,
                num_pts=NUM_PTS)
EXTS = (".csv", ".odom2", ".wc", ".wa", ".wp")
CONFIGS = sorted(p.name for p in (REPO / "configs").glob("*.yaml"))



@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("drow"))
    synthetic.write_synthetic_drow_split(root, "train", **SPLIT_KW)
    return root


# ------------------------------------------------------------------ config


@pytest.mark.parametrize("name", CONFIGS)
def test_load_and_normalize_config_match_jax(name):
    path = str(REPO / "configs" / name)
    assert load_config(path, tag="t") == jax_load(path, tag="t")
    assert normalize_config(load_config(path)) == jax_normalize(
        jax_load(path))


def test_json_config_matches_jax_yaml(tmp_path):
    """A .json copy of the flagship config reads as JAX reads the YAML."""
    src = REPO / "configs" / "dr_spaam.yaml"
    path = tmp_path / "dr_spaam.json"
    path.write_text(json.dumps(yaml.safe_load(src.read_text())))
    assert load_config(str(path)) == jax_load(str(src))
    assert normalize_config(load_config(str(path))) == jax_normalize(
        jax_load(str(src)))


def test_yaml_without_pyyaml_says_json(monkeypatch, tmp_path):
    import sys

    path = tmp_path / "c.yaml"
    path.write_text("a: 1\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="JSON"):
        load_config(str(path))


# ---------------------------------------------------------------- registry


@pytest.mark.parametrize("mtype", PORTED_MODEL_TYPES)
def test_registry_streaming_types_take_jax_weights(mtype):
    """The port's model of each ported type (the streaming ones and
    ``"drow"``) takes the JAX model's weights with no missing or unused key
    (the bridge raises on either)."""
    cfg = {"type": mtype, "window_size": 5, "pedestrian_only": True,
           "alpha": 0.5, "dropout": 0.1, "remat": True, "banded_chunk": 8,
           "freeze_detector": False}
    jm = jax_get_model(cfg)
    x = jnp.zeros((1, NUM_PTS, 1, 16))
    args = (x, jnp.zeros((1, NUM_PTS))) if mtype == "flow_drow" else (x,)
    variables = jm.init(jax.random.PRNGKey(0), *args, train=False)
    v_np = perturb_batch_stats(variables, np.random.default_rng(1))
    port = get_model(cfg, num_cutout_pts=16)
    assert type(port).__name__ == type(jm).__name__
    port.load_state_dict(variables_to_state_dict(v_np, port), strict=True)


@pytest.mark.parametrize("mtype", sorted(NOT_PORTED))
def test_registry_other_types_name_their_item(mtype):
    with pytest.raises(NotImplementedError,
                       match=f"item {NOT_PORTED[mtype]}"):
        get_model({"type": mtype})


# ------------------------------------------------------- readers and writer


def test_synthetic_split_is_byte_identical(tmp_path):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    stems_j = jax_synth.write_synthetic_drow_split(a, "val", **SPLIT_KW)
    stems_p = synthetic.write_synthetic_drow_split(b, "val", **SPLIT_KW)
    assert [os.path.basename(s) for s in stems_j] == [
        os.path.basename(s) for s in stems_p]
    for sj, sp in zip(stems_j, stems_p):
        for ext in EXTS:
            assert filecmp.cmp(sj + ext, sp + ext, shallow=False), sp + ext


def test_readers_equal_jax(split, tmp_path):
    assert drow_io.list_sequences(split, "train") == \
        jax_io.list_sequences(split, "train")
    stems = drow_io.list_sequences(split, "train")
    # a file of many-digit ranges: do the two parsers round alike?
    rng = np.random.default_rng(5)
    rows = np.column_stack([np.arange(50), np.arange(50) * 0.1,
                            rng.uniform(0.0, 30.0, (50, NUM_PTS))])
    digits = str(tmp_path / "digits")
    np.savetxt(digits + ".csv", rows, fmt="%.17g", delimiter=",")
    for stem in stems + [digits]:
        for got, ref in zip(drow_io.load_scan_file(stem),
                            jax_io.load_scan_file(stem)):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got.view(np.uint8),
                                          ref.view(np.uint8))
    for stem in stems:
        for got, ref in zip(drow_io.load_odometry_file(stem),
                            jax_io.load_odometry_file(stem)):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
        got, ref = (drow_io.load_detection_file(stem),
                    jax_io.load_detection_file(stem))
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1:] == ref[1:]


@pytest.mark.parametrize("ext,text", [
    (".csv", "1,2\n3,4\n"), (".csv", "1,2,3,4\n1,2\n"),
    (".csv", "1,abc,3\n"), (".odom2", "1,2,3,4\n"),
    (".wp", "0,[[1.0, 2.0]\n"), (".wp", "x,[]\n"), (".wp", "0\n"),
])
def test_malformed_lines_raise_like_jax(tmp_path, ext, text):
    stem = str(tmp_path / "bad")
    for e in EXTS:
        with open(stem + e, "w") as f:
            f.write("0,[]\n" if e in (".wc", ".wa", ".wp") else
                    "0,0," + ",".join(["1"] * 4) + "\n")
    with open(stem + ext, "w") as f:
        f.write(text)
    load = {".csv": "load_scan_file", ".odom2": "load_odometry_file",
            ".wp": "load_detection_file"}[ext]
    with pytest.raises(ValueError) as ref:
        getattr(jax_io, load)(stem)
    with pytest.raises(ValueError) as got:
        getattr(drow_io, load)(stem)
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------- geometry


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(2)
    x, y = rng.normal(0, 5, (2, 3, NUM_PTS)).astype(np.float32)
    r, phi = rng.uniform(0.1, 20, (3, NUM_PTS)), rng.uniform(-2, 2, NUM_PTS)
    dr, dphi = rng.uniform(0.1, 20, (3, NUM_PTS)), rng.uniform(-2, 2,
                                                                (3, NUM_PTS))
    flow = rng.normal(0, 1, (3, NUM_PTS, 2))
    pairs = [
        (geo.xy_to_rphi(_t(x), _t(y)), jax_geo.xy_to_rphi(x, y)),
        (geo.scan_to_xy(_t(r)), jax_geo.scan_to_xy(jnp.float32(r))),
        (geo.scan_to_xy(_t(r), _t(phi)),
         jax_geo.scan_to_xy(jnp.float32(r), jnp.float32(phi))),
        (geo.global_to_canonical(_t(r), _t(phi), _t(dr), _t(dphi)),
         jax_geo.global_to_canonical(*(jnp.float32(a)
                                       for a in (r, phi, dr, dphi)))),
        ((geo.global_to_canonical_flow(_t(flow), _t(phi)),),
         (jax_geo.global_to_canonical_flow(jnp.float32(flow),
                                           jnp.float32(phi)),)),
        ((geo.phi_rotation_matrix(_t(dphi)),),
         (jax_geo.phi_rotation_matrix(jnp.float32(dphi)),)),
        ((geo.phi_rotation_matrix(_t(dphi), is_3d=True),),
         (jax_geo.phi_rotation_matrix(jnp.float32(dphi), is_3d=True),)),
    ]
    for got, ref in pairs:
        for g, f in zip(got, ref):
            f = np.asarray(f)
            assert tuple(g.shape) == f.shape
            # 1e-6 of the value (ranges up to 20 m, where one f32 ulp is
            # 1.9e-6) and 1e-6 absolute
            np.testing.assert_allclose(g.numpy(), f, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- targets


def _target_inputs(seed=4, b=3, d=6):
    rng = np.random.default_rng(seed)
    phi = jax_geo.get_laser_phi(num_pts=NUM_PTS).astype(np.float32)
    scan = rng.uniform(0.5, 12.0, (b, NUM_PTS)).astype(np.float32)
    # detections on scan points so that radii capture some of them
    beams = rng.integers(0, NUM_PTS, (b, d))
    rphi = np.stack([np.take_along_axis(scan, beams, 1)
                     + rng.normal(0, 0.1, (b, d)), phi[beams]],
                    -1).astype(np.float32)
    radius = rng.choice([0.35, 0.4, 0.6, 2.0], (b, d)).astype(np.float32)
    label = rng.integers(1, 4, (b, d)).astype(np.int32)
    valid = rng.random((b, d)) < 0.8
    odom0 = rng.normal(0, 1, (b, 3)).astype(np.float32)
    odom1 = (odom0 + rng.normal(0, 0.2, (b, 3))).astype(np.float32)
    return scan, phi, rphi, radius, label, valid, odom0, odom1


def test_targets_match_jax():
    scan, phi, rphi, radius, label, valid, odom0, odom1 = _target_inputs()
    for i in range(len(scan)):
        jargs = [jnp.asarray(a) for a in (scan[i], phi, rphi[i], radius[i],
                                          label[i], valid[i])]
        cls, reg = tgt.regression_targets(
            _t(scan)[i], _t(phi), _t(rphi)[i], _t(radius)[i],
            torch.as_tensor(label)[i], torch.as_tensor(valid)[i])
        jcls, jreg = jax_tgt.regression_targets(*jargs)
        assert cls.dtype == torch.int32
        np.testing.assert_array_equal(cls.numpy(), np.asarray(jcls))
        np.testing.assert_allclose(reg.numpy(), np.asarray(jreg), atol=1e-5)
        idx = tgt.closest_detection(_t(scan)[i], _t(phi), _t(rphi)[i],
                                    _t(radius)[i], torch.as_tensor(valid)[i])
        np.testing.assert_array_equal(
            idx.numpy(), np.asarray(jax_tgt.closest_detection(
                *jargs[:4], jargs[5])))
    # batched over frames in one call, as the dataset calls them
    cls_b, reg_b = tgt.regression_targets(
        _t(scan), _t(phi), _t(rphi), _t(radius), torch.as_tensor(label),
        torch.as_tensor(valid))
    jcls, jreg = jax.vmap(jax_tgt.regression_targets,
                          in_axes=(0, None, 0, 0, 0, 0))(
        *(jnp.asarray(a) for a in (scan, phi, rphi, radius, label, valid)))
    np.testing.assert_array_equal(cls_b.numpy(), np.asarray(jcls))
    np.testing.assert_allclose(reg_b.numpy(), np.asarray(jreg), atol=1e-5)

    xy = np.stack([scan * np.cos(phi), scan * np.sin(phi)], -1)
    dets_xy = np.stack([rphi[..., 0] * np.cos(rphi[..., 1]),
                        rphi[..., 0] * np.sin(rphi[..., 1])], -1)
    for to_canonical in (False, True):
        np.testing.assert_allclose(
            tgt.flow_from_pose_pair(_t(scan), _t(phi), _t(odom0), _t(odom1),
                                    to_canonical).numpy(),
            np.asarray(jax_tgt.flow_from_pose_pair(
                jnp.asarray(scan), jnp.asarray(phi), jnp.asarray(odom0),
                jnp.asarray(odom1), to_canonical)), atol=1e-5)
    for fn in ("displacement_from_odometry", "velocity_from_odometry"):
        np.testing.assert_allclose(
            getattr(tgt, fn)(_t(xy), _t(odom0), _t(odom1)).numpy(),
            np.asarray(getattr(jax_tgt, fn)(
                jnp.asarray(xy, jnp.float32), jnp.asarray(odom0),
                jnp.asarray(odom1))), atol=1e-5)
    dyn = tgt.dynamic_mask(_t(xy), _t(dets_xy), _t(radius),
                           torch.as_tensor(valid))
    np.testing.assert_array_equal(
        dyn.numpy(), np.asarray(jax_tgt.dynamic_mask(
            jnp.asarray(xy, jnp.float32), jnp.asarray(dets_xy, jnp.float32),
            jnp.asarray(radius), jnp.asarray(valid))))
    assert 0 < dyn.sum() < dyn.numel()
    scan_nan = scan.copy()
    scan_nan[0, :3] = (np.nan, 20.0, 25.0)
    np.testing.assert_array_equal(
        tgt.valid_range_mask(_t(scan_nan)).numpy(),
        np.asarray(jax_tgt.valid_range_mask(jnp.asarray(scan_nan))))


# ----------------------------------------------------------------- dataset


def _boundary_report(ds, got_cls):
    """For each point whose class differs: its distance to the nearest
    detection's radius (a point on a radius may round either way)."""
    out = []
    phi = ds.phi_grid
    for n, p in zip(*np.nonzero(got_cls != ds.target_cls)):
        r = ds.scans_flat[ds.cur_idx[n], p]
        det = ds.dets_rphi[n][ds.dets_valid[n]]
        d = np.hypot(r * np.cos(phi[p]) - det[:, 0] * np.cos(det[:, 1]),
                     r * np.sin(phi[p]) - det[:, 0] * np.sin(det[:, 1]))
        out.append((int(n), int(p), float(np.abs(d - 0.35).min())))
    return out


@pytest.mark.parametrize("pedestrian_only", [True, False])
def test_dataset_matches_jax(split, pedestrian_only):
    kw = dict(num_scans=2, pedestrian_only=pedestrian_only)
    ref = JaxDataset(split, "train", **kw)
    ds = DrowDetectionDataset(split, "train", device="cpu", **kw)
    assert len(ds) == len(ref) > 0
    for k in ("scans_flat", "stack_idx", "cur_idx", "odom1", "dets_rphi",
              "dets_valid", "phi_grid"):
        a, b = getattr(ds, k), getattr(ref, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("target_cls", "exclude_mask"):
        a, b = getattr(ds, k), getattr(ref, k)
        assert a.dtype == b.dtype, k
        mism = int((a != b).sum())
        assert mism == 0, (k, mism, _boundary_report(ref, ds.target_cls))
    assert ds.target_cls.any() and (ds.exclude_mask == 0).any()
    for k in ("target_reg", "target_flow"):
        np.testing.assert_allclose(getattr(ds, k), getattr(ref, k),
                                   rtol=0, atol=1e-5, err_msg=k)
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds.gt_centers(i), ref.gt_centers(i))
    a, b = ds[1], ref[1]
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5, err_msg=k)
        if k not in ("target_reg", "target_flow"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dataset_batches_flip_like_jax(split):
    kw = dict(num_scans=2, pedestrian_only=True, use_augmentation=True,
              seed=7)
    ref = JaxDataset(split, "train", **kw)
    ds = DrowDetectionDataset(split, "train", device="cpu", **kw)
    idx = np.arange(min(len(ds), 12))
    flipped = False
    for _ in range(3):
        a, b = ds.batch(idx), ref.batch(idx)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5,
                                       err_msg=k)
            if k not in ("target_reg", "target_flow"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        flipped |= not np.array_equal(a["scans"],
                                      ds.scans_flat[ds.stack_idx[idx]])
    assert flipped
