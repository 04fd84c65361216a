"""The port's tool CLIs against the JAX package's ``bin/`` tools, on the
CPU: ``cli.sweep`` (``bin/sweep.py``), ``cli.prepare_data``
(``bin/prepare_data.py``), ``cli.validate_corpus``
(``bin/validate_corpus.py``) and ``cli.demo`` (``bin/demo.py``).

* sweep: ``set_nested``, ``parse_value`` and ``expand_grid`` give JAX's
  results; the two CLIs write the same file names, the same configs and
  the same launchers but the training command;
* prepare_data: ``.difodom`` equal and ``.flow`` within 2e-8 of JAX's
  ``prepare_split`` (``tests/test_torch_train_loop.py``'s bar);
* validate_corpus: a synthetic DROW and JRDB corpus pass with JAX's stage
  names, in JAX's order; the corruptions of ``tests/test_validate_corpus.
  py`` fail the same stages as in JAX (rc 1, the offending files named);
  the corpus is not written to; a port checkpoint, a reference ``.pth``
  and the refusal of an orbax directory under ``--checkpoint``;
* demo: ``--video`` without matplotlib stops before any work; the whole
  demo (1 + 1 epochs) runs in the slow tier, as JAX's does
  (``tests/test_workflows.py``).

JAX's validate_corpus runs on the clean corpora with its train step
stubbed (its stage names do not depend on it; it costs a compile of ~25 s):
its names are what the port is held to there.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from glob import glob

import numpy as np
import pytest
import torch
import yaml

import bin.sweep as jax_sweep
import bin.validate_corpus as jax_vc
from planar_optical_flow_tpu.data.prepare import (
    prepare_split as jax_prepare,
)
from planar_optical_flow_tpu_torch.cli import demo as demo_cli
from planar_optical_flow_tpu_torch.cli import prepare_data as prepare_cli
from planar_optical_flow_tpu_torch.cli import sweep
from planar_optical_flow_tpu_torch.cli import validate_corpus as vc
from planar_optical_flow_tpu_torch.data import (
    write_synthetic_drow_split,
    write_synthetic_jrdb,
)
from planar_optical_flow_tpu_torch.interop.checkpoint import save_weights
from planar_optical_flow_tpu_torch.models import get_model
from planar_optical_flow_tpu_torch.train import (
    create_train_state,
    make_optimizer,
)
from planar_optical_flow_tpu_torch.train import checkpoint as ckpt_lib
from tests.test_torch_ckpt_import import reference_state_dict
from tests.test_torch_common import REPO
from tests.test_torch_common import one_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


# ----------------------------------------------------------------- sweep


@pytest.mark.parametrize("spec", ["5", "1e-3", "True", "adam", "[1, 2]",
                                  "0.5", "null", "a: [", "3.0e-4"])
def test_sweep_parse_value_matches_bin(spec):
    assert sweep.parse_value(spec) == jax_sweep.parse_value(spec)
    assert type(sweep.parse_value(spec)) is type(jax_sweep.parse_value(spec))


def test_sweep_helpers_match_bin():
    for mod in (sweep, jax_sweep):
        cfg = {"a": {"x": 1}}
        mod.set_nested(cfg, "a.b.c", 5)
        mod.set_nested(cfg, "d", "x")
        assert cfg == {"a": {"x": 1, "b": {"c": 5}}, "d": "x"}
    specs = ["a=1,2", "b.c=x,1e-3", "d=True"]
    assert sweep.expand_grid(specs) == jax_sweep.expand_grid(specs)
    assert len(sweep.expand_grid(specs)) == 4


def test_sweep_cli_writes_what_bin_writes(tmp_path):
    base = tmp_path / "base.yaml"
    base.write_text("epochs: 1\nmodel:\n  dropout: 0.0\npipeline:\n"
                    "  Trainer: {epoch: 3}\n")
    argv = ["--base", str(base), "--grid", "model.dropout=0.1,0.3",
            "pipeline.Trainer.epoch=20,40", "--sbatch", "--partition", "gpu"]
    assert sweep.main(argv + ["--out", str(tmp_path / "port")]) == 0
    assert jax_sweep.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 8
    for name in names:
        got = (tmp_path / "port" / name).read_text()
        ref = (tmp_path / "jax" / name).read_text()
        if name.endswith(".yaml"):
            assert got == ref
            assert yaml.safe_load(got)["tag"] == name[:-5]
        else:
            ref = ref.replace(
                "python bin/train.py",
                "python -m planar_optical_flow_tpu_torch.cli.train")
            assert got == ref.replace(str(tmp_path / "jax"),
                                      str(tmp_path / "port"))
            assert "--signal=TERM@120" in got and "--cont" in got


# ----------------------------------------------------------- prepare_data


def test_prepare_data_cli_matches_jax(tmp_path, capsys):
    for which in ("port", "jax"):
        for split, seed in (("train", 0), ("val", 7)):
            write_synthetic_drow_split(str(tmp_path / which), split,
                                       num_sequences=1, num_frames=10,
                                       num_pts=48, seed=seed)
    rc = prepare_cli.main(["--data-dir", str(tmp_path / "port"), "--split",
                           "train", "val", "--cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "train: 1 sequences prepared" in out and "val: 1" in out
    for split in ("train", "val"):
        for stem in jax_prepare(str(tmp_path / "jax"), split, verbose=False):
            port = stem.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
            for ext, atol in ((".difodom", 0.0), (".flow", 2e-8)):
                got = np.loadtxt(port + ext, delimiter=",")
                want = np.loadtxt(stem + ext, delimiter=",")
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol,
                                           err_msg=ext)


# -------------------------------------------------------- validate_corpus


@pytest.fixture
def drow_root(tmp_path):
    root = str(tmp_path / "drow")
    write_synthetic_drow_split(root, "train", num_sequences=2,
                               num_frames=24, num_pts=48)
    write_synthetic_drow_split(root, "val", num_sequences=1,
                               num_frames=16, num_pts=48, seed=7)
    return root


def _manifest(main, argv, path):
    rc = main(argv + ["--out", str(path)])
    with open(path) as f:
        return rc, json.load(f)


def _jax_stages(root, path, monkeypatch):
    """JAX's manifest on ``root`` with its train step stubbed (it passes):
    (rc, [(stage, ok)])."""
    real = jax_vc.Manifest.run

    def run(self, name, fn, *args, **kwargs):
        if "train step" in name:
            fn = str
        return real(self, name, fn, *args, **kwargs)

    monkeypatch.setattr(jax_vc.Manifest, "run", run)
    rc, doc = _manifest(jax_vc.main, [root], path)
    monkeypatch.setattr(jax_vc.Manifest, "run", real)
    return rc, [(s["stage"], s["ok"]) for s in doc["stages"]]


def _jax_stage_names(root, tmp_path, monkeypatch):
    """JAX's stage names on a corpus it passes."""
    rc, stages = _jax_stages(root, tmp_path / "jax.json", monkeypatch)
    assert rc == 0
    return [name for name, _ in stages]


def test_validate_drow_corpus_passes(drow_root, tmp_path, monkeypatch):
    before = sorted(os.listdir(os.path.join(drow_root, "train")))
    rc, doc = _manifest(vc.main, [drow_root, "--cpu"], tmp_path / "m.json")
    assert rc == 0 and doc["layout"] == "drow" and doc["ok"]
    names = [s["stage"] for s in doc["stages"]]
    assert names == _jax_stage_names(drow_root, tmp_path, monkeypatch)
    steps = [s for s in doc["stages"] if "train step" in s["stage"]]
    assert "train step loss" in steps[0]["detail"]
    assert "native == python" in doc["stages"][0]["detail"]
    # corpus untouched: prepare ran on a temp copy
    assert sorted(os.listdir(os.path.join(drow_root, "train"))) == before


def test_validate_drow_corpus_localizes_corruption(drow_root, tmp_path):
    """The corruptions of ``tests/test_validate_corpus.py``: a ragged CSV
    line in one sequence, a torn ``.wc`` line in another."""
    seq0 = os.path.join(drow_root, "train", "synth_train_0")
    with open(seq0 + ".csv", "a") as f:
        f.write("7,0.5,1.0\n")  # 3 cols instead of 2+48 ranges
    seq1 = os.path.join(drow_root, "train", "synth_train_1")
    lines = open(seq1 + ".wc").read().splitlines()
    lines[0] = lines[0][: len(lines[0]) // 2]  # torn JSON tail
    open(seq1 + ".wc", "w").write("\n".join(lines))

    rc, doc = _manifest(vc.main, [drow_root, "--cpu"], tmp_path / "m.json")
    rc_j, doc_j = _manifest(jax_vc.main, [drow_root], tmp_path / "j.json")
    assert rc == rc_j == 1 and not doc["ok"]
    assert ([(s["stage"], s["ok"]) for s in doc["stages"]]
            == [(s["stage"], s["ok"]) for s in doc_j["stages"]])
    failed = {s["stage"]: s["detail"] for s in doc["stages"] if not s["ok"]}
    assert any("synth_train_0" in k for k in failed)
    assert any("synth_train_1" in k for k in failed)
    # failure details name the offending file
    assert any("synth_train_0.csv" in d for d in failed.values())
    assert any(".wc" in d for d in failed.values())
    # the clean val sequence still validated (no fail-fast)
    assert any("read val/" in s["stage"] for s in doc["stages"] if s["ok"])


def test_validate_jrdb_corpus_passes_and_flags_corrupt_pcd(tmp_path,
                                                           monkeypatch):
    root = str(tmp_path / "jrdb")
    write_synthetic_jrdb(root, num_frames=3, boxes_per_frame=4)
    rc, doc = _manifest(vc.main, [root, "--cpu"], tmp_path / "m.json")
    assert rc == 0 and doc["layout"] == "jrdb" and doc["ok"]
    assert ([s["stage"] for s in doc["stages"]]
            == _jax_stage_names(root, tmp_path, monkeypatch))

    # truncate one binary_compressed PCD: the LZF decoder must reject it
    pcd = sorted(glob(os.path.join(
        root, "train_dataset", "pointclouds", "*", "*", "*.pcd")))[0]
    blob = open(pcd, "rb").read()
    open(pcd, "wb").write(blob[: len(blob) - len(blob) // 3])
    rc, doc = _manifest(vc.main, [root, "--cpu"], tmp_path / "m2.json")
    rc_j, stages_j = _jax_stages(root, tmp_path / "j2.json", monkeypatch)
    assert rc == rc_j == 1
    # the same stages fail, but the train step (stubbed in JAX's run)
    assert ([(s["stage"], s["ok"]) for s in doc["stages"]
             if "train step" not in s["stage"]]
            == [(n, ok) for n, ok in stages_j if "train step" not in n])
    assert any("read frames" in s["stage"] or "PCD" in s["stage"]
               for s in doc["stages"] if not s["ok"])


def _detector():
    return get_model({"type": "dr-spaam", "window_size": 11, "alpha": 0.5,
                      "pedestrian_only": True}, 56)


def test_validate_drow_scores_checkpoints(tmp_path):
    """``--checkpoint``: a port training checkpoint scored with
    ``--score-ap`` on int8c, a reference ``.pth`` on the module engine; a
    weights file imported; an orbax-style directory refused with the
    reason. The corpus has 64 beams: the serving steps' top-64 NMS needs
    at least 64 (JAX's too)."""
    drow_root = str(tmp_path / "drow")
    write_synthetic_drow_split(drow_root, "train", num_sequences=1,
                               num_frames=12, num_pts=64)
    write_synthetic_drow_split(drow_root, "val", num_sequences=1,
                               num_frames=12, num_pts=64, seed=7)
    state = create_train_state(_detector(), make_optimizer(
        {"scheduler_kwargs": {}}, steps_per_epoch=1))
    ck = ckpt_lib.save_checkpoint(str(tmp_path / "ckpt"), state)
    weights = save_weights(_detector(), str(tmp_path / "w.pt"))
    pth = str(tmp_path / "dr_spaam.pth")
    torch.save({"epoch": 40, "model_state": reference_state_dict(
        _detector(), seed=4)}, pth)
    orbax = tmp_path / "orbax"
    (orbax / "default").mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")

    for i, (path, engine, detail) in enumerate((
            (ck, "int8c", "AP "), (pth, "module", "AP "),
            (weights, None, "checkpoint imported (port weights"),
            (str(orbax), None, "ValueError: "))):
        argv = [drow_root, "--checkpoint", path, "--cpu"]
        if engine:
            argv += ["--score-ap", "--engine", engine, "--max-frames", "8"]
        rc, doc = _manifest(vc.main, argv, tmp_path / f"m{i}.json")
        score = [s for s in doc["stages"] if s["stage"].startswith("score")]
        assert len(score) == 1 and score[0]["detail"].startswith(detail)
        assert rc == (1 if path == str(orbax) else 0), score
        if engine:
            assert "over 8 frames" in score[0]["detail"]
    assert "orbax checkpoint of the JAX package" in score[0]["detail"]


# ------------------------------------------------------------------- demo


def test_demo_video_needs_matplotlib(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit) as exit_:
        demo_cli.main(["--workdir", str(tmp_path / "demo"), "--cpu",
                       "--video"])
    assert exit_.value.code == 2
    assert "--video needs matplotlib" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "demo")


@pytest.mark.slow
def test_demo_cli_end_to_end(tmp_path, capsys):
    """The whole demo at 1 + 1 epochs on the CPU, as JAX's demo runs in
    ``tests/test_workflows.py``: every stage, the detector checkpoint and
    the video (PNG frames, one a val frame, without ffmpeg)."""
    work = tmp_path / "demo"
    rc = demo_cli.main(["--workdir", str(work), "--cpu", "--det-epochs",
                        "1", "--flow-epochs", "1", "--video"])
    assert rc == 0
    out = capsys.readouterr().out
    for stage in ("stage 1", "stage 2", "stage 3", "demo complete"):
        assert stage in out
    assert glob(str(work / "logs" / "*demo_det" / "ckpt" / "detector"))
    assert os.path.exists(work / "demo.mp4") or len(
        os.listdir(work / "demo")) == 14


def test_new_modules_import_without_jax_matplotlib_or_yaml():
    """The viz module and the tool CLIs import nothing of JAX or the JAX
    package, and import without matplotlib and PyYAML (each imports its
    own only when it runs)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'planar_optical_flow_tpu', 'matplotlib', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "import planar_optical_flow_tpu_torch.utils.viz\n"
        "import planar_optical_flow_tpu_torch.cli.infer\n"
        "import planar_optical_flow_tpu_torch.cli.demo\n"
        "import planar_optical_flow_tpu_torch.cli.prepare_data\n"
        "import planar_optical_flow_tpu_torch.cli.sweep\n"
        "import planar_optical_flow_tpu_torch.cli.validate_corpus\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'flax', "
        "'planar_optical_flow_tpu.', 'matplotlib', 'yaml')) "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
