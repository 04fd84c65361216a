"""The port's scan-pair flow data (``data/drow_flow.py``, the ``.difodom``
and ``.flow`` readers) against the JAX package's, on the CPU.

A synthetic 128-beam DROW corpus (two train and one val sequence, with
their ``.difodom``/``.flow`` files from the port's ``prepare_split``);
both packages read the same files. The readers and every array of the
dataset, under each flag, are equal to JAX's to the bit.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from planar_optical_flow_tpu.data import FlowScanPairDataset as JaxFlowSet
from planar_optical_flow_tpu.data import drow_io as jax_io
from planar_optical_flow_tpu_torch.data import (
    FlowScanPairDataset,
    drow_io,
    write_synthetic_drow_split,
)
from planar_optical_flow_tpu_torch.data.prepare import prepare_split

from tests.test_torch_common import one_thread  # noqa: F401

NUM_PTS = 128
FLAGS = {
    "base": {},
    "keep_static": {"drop_static": False},
    "mask_dynamic": {"mask_dynamic": True},
    "train_with_val": {"train_with_val": True},
    "max_sequences": {"max_sequences": 1, "drop_static": False},
}


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


def write_flow_corpus(root, num_pts=NUM_PTS, train_frames=12, val_frames=8,
                      seed=0):
    """A prepared synthetic corpus: ``train`` (2 sequences) and ``val``
    (1), each with its ``.difodom`` and ``.flow`` files."""
    write_synthetic_drow_split(root, "train", num_sequences=2,
                               num_frames=train_frames, num_people=8,
                               seed=seed, num_pts=num_pts)
    write_synthetic_drow_split(root, "val", num_sequences=1,
                               num_frames=val_frames, num_people=8,
                               seed=seed + 9, num_pts=num_pts)
    for split in ("train", "val"):
        prepare_split(root, split, verbose=False, device="cpu")
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_flow_corpus(str(tmp_path_factory.mktemp("flow")))


def _same(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8),
                                  err_msg=what)


def test_flow_readers_equal_jax(corpus):
    for stem in drow_io.list_sequences(corpus, "train"):
        for got, ref in zip(drow_io.load_diff_odometry_file(stem),
                            jax_io.load_diff_odometry_file(stem)):
            _same(got, ref, stem + ".difodom")
        _same(drow_io.load_flow_file(stem, NUM_PTS),
              jax_io.load_flow_file(stem, NUM_PTS), stem + ".flow")


def test_malformed_flow_files_raise_like_jax(tmp_path):
    stem = str(tmp_path / "bad")
    with open(stem + ".flow", "w") as f:
        f.write(",".join(["0.5"] * (NUM_PTS * 2 - 1)) + "\n")
    with open(stem + ".difodom", "w") as f:
        f.write("0.1,0.2,0.3\n")
    for load, args in (("load_flow_file", (NUM_PTS,)),
                       ("load_diff_odometry_file", ())):
        with pytest.raises(ValueError) as ref:
            getattr(jax_io, load)(stem, *args)
        with pytest.raises(ValueError) as got:
            getattr(drow_io, load)(stem, *args)
        assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_flow_dataset_equals_jax(corpus, flag):
    """Every array, ``__getitem__`` and ``batch``, to the bit."""
    kw = FLAGS[flag]
    got = FlowScanPairDataset(corpus, "train", **kw)
    ref = JaxFlowSet(corpus, "train", **kw)
    assert len(got) == len(ref) > 0
    for name in ("scan_xy", "scan_xy_next", "flow_target", "odom",
                 "exclude_mask", "phi_grid"):
        _same(getattr(got, name), getattr(ref, name), name)
    if flag == "mask_dynamic":
        assert (got.exclude_mask == 0).any()  # people were masked out
    for i in (0, len(got) - 1):
        g, r = got[i], ref[i]
        assert g.keys() == r.keys()
        for k in g:
            _same(g[k], r[k], f"[{i}] {k}")
    idx = np.random.default_rng(0).permutation(len(got))[:4]
    g, r = got.batch(idx), ref.batch(idx)
    assert g.keys() == r.keys() and g["scan_pair"].shape == (
        4, 2, NUM_PTS, 2)
    for k in g:
        _same(g[k], r[k], f"batch {k}")


def test_flow_dataset_rejects_mixed_beams(corpus, tmp_path):
    """A split of mixed beam counts raises as JAX's does; an empty split
    raises FileNotFoundError."""
    root = str(tmp_path / "mixed")
    shutil.copytree(os.path.join(corpus, "train"),
                    os.path.join(root, "train"))
    extra = write_synthetic_drow_split(root, "other", num_sequences=1,
                                       num_frames=6, seed=3, num_pts=48)
    prepare_split(root, "other", verbose=False, device="cpu")
    for ext in (".csv", ".odom2", ".wc", ".wa", ".wp", ".difodom", ".flow"):
        shutil.move(extra[0] + ext,
                    os.path.join(root, "train", "zz_mixed" + ext))
    with pytest.raises(ValueError, match="mixed beam counts"):
        JaxFlowSet(root, "train")
    with pytest.raises(ValueError, match="mixed beam counts"):
        FlowScanPairDataset(root, "train")
    with pytest.raises(FileNotFoundError):
        FlowScanPairDataset(root, "test")
