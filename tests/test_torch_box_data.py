"""The port's box-regression data layer against the JAX package's, on the
CPU: the native library and the LZF decoders, the PCD and CSV readers, the
synthetic JRDB writer, ``JrdbHandle``, ``JrdbBoxRegressionDataset`` and the
batch loader's order over it. Files and samples are held equal to the bit.
"""

from __future__ import annotations

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

from planar_optical_flow_tpu.data import drow_io as jax_drow_io
from planar_optical_flow_tpu.data import jrdb as jax_jrdb
from planar_optical_flow_tpu.data import jrdb_transforms as jax_jt
from planar_optical_flow_tpu.data import pcd as jax_pcd
from planar_optical_flow_tpu.data.loader import BatchLoader as JaxLoader
from planar_optical_flow_tpu_torch.data import (
    BatchLoader,
    drow_io,
    jrdb,
    jrdb_transforms,
    native,
    pcd,
    write_synthetic_drow_split,
)

from tests.test_torch_common import REPO

CORRUPT = "corrupt LZF stream"
BOX_CFG = {"radius_segment": 0.4, "perturb": 0.1, "min_segment_size": 5,
           "input_size": 32, "max_neighbors": 4,
           "augmentation_kwargs": {"use_data_augmentation": True,
                                   "rot_max": 0.25, "dist_max": 0.3,
                                   "dim_max": 0.2, "random_drop": 0.25}}


def test_box_modules_import_without_jax():
    """The modules of the box workload import nothing of JAX or the JAX
    package."""
    mods = ("data.native", "data.pcd", "data.jrdb", "data.jrdb_transforms",
            "data.synthetic", "ops.rotated_iou", "models.pointnet",
            "eval.baseline", "infer.box_regressor", "train.tasks",
            "pipeline", "cli.evaluate", "cli.train")
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['planar_optical_flow_tpu'] = None\n"
            + "".join(f"import planar_optical_flow_tpu_torch.{m}\n"
                      for m in mods)
            + "bad = [m for m in sys.modules if m.startswith(('jax', "
            "'flax', 'planar_optical_flow_tpu.')) and sys.modules[m] is "
            "not None]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# ----------------------------------------------------------------- LZF


def _lzf_stream(rng, n_ops=60):
    """A valid LZF stream of random literal runs and back references (short,
    long, overlapping), and the bytes it decodes to."""
    stream, out = bytearray(), bytearray()
    for i in range(n_ops):
        if i % 2 == 0 or len(out) == 0:
            run = int(rng.integers(1, 33))
            lit = rng.integers(0, 256, run).astype(np.uint8).tobytes()
            stream.append(run - 1)
            stream.extend(lit)
            out.extend(lit)
            continue
        length = int(rng.integers(3, 265))  # bytes copied: at most 264
        off = int(rng.integers(0, min(len(out), 8192)))  # ref = o - off - 1
        code = length - 2
        if code < 7:
            stream.append((code << 5) | (off >> 8))
        else:
            stream.append((7 << 5) | (off >> 8))
            stream.append(code - 7)
        stream.append(off & 0xFF)
        ref = len(out) - off - 1
        for k in range(length):  # overlapping copies run forward
            out.append(out[ref + k])
    return bytes(stream), bytes(out)


def _decoders():
    assert native.status().startswith("native"), native.status()
    return {"port native": native.lzf_decompress,
            "port python": pcd._lzf_decompress_py,
            "port": pcd.lzf_decompress,
            "jax": jax_pcd.lzf_decompress,
            "jax python": jax_pcd._lzf_decompress_py}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lzf_decoders_equal_jax(seed):
    """Literal and back-reference streams decode to equal bytes in the
    port's native and Python decoders and in JAX's."""
    rng = np.random.default_rng(seed)
    stream, want = _lzf_stream(rng)
    literal = rng.integers(0, 256, 1000).astype(np.uint8).tobytes()
    assert pcd.lzf_compress(literal) == jax_pcd.lzf_compress(literal)
    for data, expect in ((stream, want),
                         (pcd.lzf_compress(literal), literal)):
        for name, fn in _decoders().items():
            assert fn(data, len(expect)) == expect, name
    # a larger output buffer than needed: the decoded length is returned
    assert native.lzf_decompress(stream, len(want) + 7) == want


@pytest.mark.parametrize("case", ["truncated literal", "reference before "
                                  "start", "overflow", "truncated reference",
                                  "truncated long reference"])
def test_lzf_corrupt_streams_raise_in_both_packages(case):
    stream, size = {
        "truncated literal": (b"\x05abc", 6),
        "reference before start": (b"\x00a\x20\x05", 8),
        "overflow": (b"\x03abcd", 3),
        "truncated reference": (b"\x00a\x20", 8),
        "truncated long reference": (b"\x00a\xe0", 30),
    }[case]
    messages = set()
    for name, fn in _decoders().items():
        with pytest.raises(ValueError, match=CORRUPT) as err:
            fn(stream, size)
        messages.add(str(err.value))
    assert len(messages) == 1, messages


# ----------------------------------------------------------- PCD and CSV


@pytest.mark.parametrize("mode", ["ascii", "binary", "binary_compressed"])
def test_pcd_modes_read_back_equal_in_both_packages(mode, tmp_path):
    xyz = np.random.default_rng(3).normal(0, 4, (257, 3)).astype(np.float32)
    ours, theirs = str(tmp_path / "p.pcd"), str(tmp_path / "j.pcd")
    pcd.write_pcd(ours, xyz, mode=mode)
    jax_pcd.write_pcd(theirs, xyz, mode=mode)
    assert filecmp.cmp(ours, theirs, shallow=False)
    for path in (ours, theirs):
        got, ref = pcd.read_pcd(path), jax_pcd.read_pcd(path)
        assert got.dtype == ref.dtype
        for name in ref.dtype.names:
            np.testing.assert_array_equal(got[name], ref[name])
        got_xyz = pcd.read_pcd_xyz(path)
        np.testing.assert_array_equal(got_xyz, jax_pcd.read_pcd_xyz(path))
    want = np.round(xyz, 6) if mode == "ascii" else xyz
    np.testing.assert_allclose(pcd.read_pcd_xyz(ours), want, atol=2e-6)


def test_pcd_header_errors_match_jax(tmp_path):
    bad = {"no_data.pcd": b"VERSION 0.7\nFIELDS x\n",
           "missing.pcd": b"FIELDS x\nSIZE 4\nDATA binary\n",
           "type.pcd": b"FIELDS x\nSIZE 3\nTYPE F\nPOINTS 1\nDATA binary\n",
           "mode.pcd": b"FIELDS x\nSIZE 4\nTYPE F\nPOINTS 1\nDATA zip\n",
           "short.pcd": b"FIELDS x\nSIZE 4\nTYPE F\nPOINTS 4\nDATA binary\n"
                        b"\0\0\0\0"}
    for name, body in bad.items():
        path = tmp_path / name
        path.write_bytes(body)
        with pytest.raises(ValueError) as ref:
            jax_pcd.read_pcd(str(path))
        with pytest.raises(ValueError) as got:
            pcd.read_pcd(str(path))
        assert str(got.value) == str(ref.value), name


def test_native_read_csv_equals_loadtxt(tmp_path):
    """On the synthetic DROW files the native reader gives ``np.loadtxt``'s
    float64 values exactly, and the port's DROW readers (native first)
    equal JAX's."""
    stems = write_synthetic_drow_split(str(tmp_path), "val", num_sequences=1,
                                       num_frames=12, num_pts=64)
    for ext in (".csv", ".odom2"):
        path = stems[0] + ext
        got = native.read_csv(path)
        ref = np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)
        assert got is not None and got.dtype == np.float64
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(drow_io.load_scan_file(stems[0]),
                        jax_drow_io.load_scan_file(stems[0])):
        np.testing.assert_array_equal(got, ref)
    bad = tmp_path / "bad.csv"
    bad.write_text("1,2\n3\n")
    assert native.read_csv(str(bad)) is None  # ragged: the caller falls back


# -------------------------------------------------------------- JRDB


def test_jrdb_transforms_and_box3d_equal_jax():
    pts = np.random.default_rng(0).normal(0, 3, (3, 20)).astype(np.float32)
    for name in ("transform_pts_upper_velodyne_to_base",
                 "transform_pts_lower_velodyne_to_base",
                 "transform_pts_laser_to_base",
                 "transform_pts_base_to_upper_velodyne",
                 "transform_pts_base_to_lower_velodyne",
                 "transform_pts_base_to_laser"):
        np.testing.assert_array_equal(getattr(jrdb_transforms, name)(pts),
                                      getattr(jax_jt, name)(pts))
    label = {"box": {"cx": 1.0, "cy": -2.0, "cz": 0.1, "l": 0.9, "w": 0.5,
                     "h": 1.7, "rot_z": 0.7}}
    got = jrdb_transforms.Box3d.from_jrdb(label).to_vertices()
    np.testing.assert_array_equal(got,
                                  jax_jt.Box3d.from_jrdb(label).to_vertices())


def test_synthetic_jrdb_tree_equals_jax(tmp_path):
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    kw = dict(num_frames=3, boxes_per_frame=4, seed=2)
    assert (jrdb.write_synthetic_jrdb(str(ours), **kw)
            == jax_jrdb.write_synthetic_jrdb(str(theirs), **kw))
    files = sorted(os.path.relpath(os.path.join(d, f), ours)
                   for d, _, fs in os.walk(ours) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), theirs)
                           for d, _, fs in os.walk(theirs) for f in fs)
    assert len(files) == 3 * (2 * 3 + 2)  # clouds, lasers, meta, labels
    for f in files:
        assert filecmp.cmp(ours / f, theirs / f, shallow=False), f


@pytest.fixture(scope="module")
def jrdb_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("jrdb")
    jax_jrdb.write_synthetic_jrdb(str(root), num_frames=3,
                                  boxes_per_frame=5, seed=1)
    return str(root)


def _same(got, ref, what):
    assert set(got) == set(ref), what
    for k, v in ref.items():
        if isinstance(v, np.ndarray) or np.isscalar(v):
            g = np.asarray(got[k])
            assert g.dtype == np.asarray(v).dtype, (what, k)
            np.testing.assert_array_equal(g, v, err_msg=f"{what} {k}")
        elif isinstance(v, list) and v and isinstance(v[0], np.ndarray):
            assert len(got[k]) == len(v), (what, k)
            for a, b in zip(got[k], v):
                np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
        else:
            assert got[k] == v, (what, k)


@pytest.mark.parametrize("is_3d", [True, False])
def test_jrdb_handle_equals_jax(jrdb_root, is_3d):
    cfg = {"data_dir": jrdb_root, "is_3d": is_3d, "seed": 4}
    got, ref = jrdb.JrdbHandle("train", cfg), jax_jrdb.JrdbHandle("train", cfg)
    assert got.sequence_names == ref.sequence_names
    assert len(got) == len(ref) == 6
    for i in range(len(ref)):  # in the same order: the perturbation draws
        _same(got[i], ref[i], f"frame {i}")
    val = jrdb.JrdbHandle("test", cfg)  # test reads val, as in JAX
    assert val.sequence_names == jax_jrdb.JrdbHandle("val", cfg
                                                     ).sequence_names
    assert jrdb.JRDB_TRAIN_SEQUENCES == jax_jrdb.JRDB_TRAIN_SEQUENCES
    assert jrdb.JRDB_VAL_SEQUENCES == jax_jrdb.JRDB_VAL_SEQUENCES


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("is_3d", [True, False])
def test_box_dataset_samples_equal_jax(jrdb_root, is_3d, split):
    """Fresh datasets with the same seed, read in the same order (sample
    by sample, then in batches), give every field equal to the bit, with
    augmentation on (``train``) and off (``val``)."""
    cfg = dict(BOX_CFG, data_dir=jrdb_root, is_3d=is_3d)
    if not is_3d:  # the synthetic lasers are random ranges: a wider crop
        cfg.update(radius_segment=3.0, min_segment_size=1)
    got = jrdb.JrdbBoxRegressionDataset(split, cfg, seed=3)
    ref = jax_jrdb.JrdbBoxRegressionDataset(split, cfg, seed=3)
    n = len(ref)
    assert len(got) == n > 0
    if split == "train":
        assert n % 2 == 0  # every segment and its augmented copy
    for attr in ("inputs", "targets", "dets_center", "targets_neighbor"):
        for a, b in zip(getattr(got, attr), getattr(ref, attr)):
            np.testing.assert_array_equal(a, b, err_msg=attr)
    for i in list(range(n)) + [0, n - 1]:
        _same(got[i], ref[i], f"sample {i}")
    idx = np.random.default_rng(0).permutation(n)[:6]
    _same(got.batch(idx), ref.batch(idx), "batch")
    width = 7 if is_3d else 5
    sample = got[0]
    assert sample["target_neighbor"].shape == (cfg["max_neighbors"], width)
    assert sample["input"].shape == (cfg["input_size"], 4 if is_3d else 3)


def test_box_loader_keeps_the_dataset_call_order(jrdb_root):
    """The port's prefetching ``BatchLoader`` over the port's dataset gives
    JAX's loader's batches over JAX's, epoch after epoch."""
    cfg = dict(BOX_CFG, data_dir=jrdb_root)
    got = BatchLoader(jrdb.JrdbBoxRegressionDataset("train", cfg), 8,
                      shuffle=True, seed=5)
    ref = JaxLoader(jax_jrdb.JrdbBoxRegressionDataset("train", cfg), 8,
                    shuffle=True, seed=5)
    for _ in range(2):
        batches = list(ref)
        assert len(batches) == len(got) > 0
        for g, r in zip(got, batches):
            _same(g, r, "loader batch")
