"""The port's ``utils/viz.py`` and ``cli.infer --video`` against the JAX
package's ``utils/viz.py``, on the CPU.

* ``flow_to_hsv`` and the image ``color_wheel`` draws equal JAX's to 1e-12
  on seeded flows;
* ``render_detection_video``'s per-instance arrows get each instance's own
  beam angles (within +-pi, the beams of the instance's points), the same
  calls as JAX's PNG frames;
* a two-frame video without ffmpeg is a directory of two PNG frames, as in
  JAX; every plotting helper draws the same figure content as JAX's;
* ``cli.infer --video`` serves the ``instance_mask`` field and hands each
  frame's mask to the renderer.
"""

from __future__ import annotations

import json
import os

import matplotlib
import numpy as np
import pytest

from planar_optical_flow_tpu.utils import viz as jax_viz
from planar_optical_flow_tpu_torch.cli import infer as infer_cli
from planar_optical_flow_tpu_torch.data import write_synthetic_drow_split
from planar_optical_flow_tpu_torch.ops.geometry import get_laser_phi
from planar_optical_flow_tpu_torch.utils import viz
from tests.test_torch_common import NUM_PTS
from tests.test_torch_common import one_thread  # noqa: F401

matplotlib.use("Agg")


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


def _flows(seed, shape=(450,)):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=0.1, size=shape + (2,))


def test_flow_to_hsv_matches_jax():
    for saturate_at in (0.1, 0.05):
        flow = _flows(1, (3, 40))
        np.testing.assert_allclose(
            viz.flow_to_hsv(flow, saturate_at=saturate_at),
            jax_viz.flow_to_hsv(flow, saturate_at=saturate_at),
            rtol=0, atol=1e-12)


def test_color_wheel_image_matches_jax():
    import matplotlib.pyplot as plt

    images = []
    for mod in (viz, jax_viz):
        fig, ax = plt.subplots()
        mod.color_wheel(ax, resolution=24, radius=2.0)
        images.append(np.asarray(ax.images[0].get_array()))
        assert ax.get_xlabel() == "flow x" and ax.get_ylabel() == "flow y"
        plt.close(fig)
    assert images[0].shape == (24, 24, 4)
    np.testing.assert_allclose(images[0], images[1], rtol=0, atol=1e-12)


def _frames(n=2):
    rng = np.random.default_rng(3)
    scans = rng.uniform(1.0, 10.0, (n, 450))
    inst = np.zeros(450, np.int64)
    inst[100:120], inst[200:230] = 1, 2
    results = [{"dets": rng.uniform(-5, 5, (2, 2)), "conf": np.array([.9, .6]),
                "flow": _flows(4 + i), "instance_mask": inst}
               for i in range(n)]
    return scans, results


def _arrow_calls(mod, monkeypatch, tmp_path, name):
    """Each ``plot_flow_arrows`` call of ``mod.render_detection_video`` on
    two frames: (points, flow, beam angles, color)."""
    calls = []
    real = mod.plot_flow_arrows

    def capture(ax, scan, flow, phi=None, color="blue", scale=1.0):
        calls.append((np.asarray(scan), np.asarray(flow),
                      None if phi is None else np.asarray(phi), color))
        return real(ax, scan, flow, phi, color=color, scale=scale)

    monkeypatch.setattr(mod, "plot_flow_arrows", capture)
    scans, results = _frames()
    mod.render_detection_video(scans, results, str(tmp_path / f"{name}.mp4"))
    return calls


def test_instance_arrows_take_their_beam_angles(monkeypatch, tmp_path):
    from matplotlib import animation

    # no ffmpeg in either package's run: the PNG frames
    monkeypatch.setattr(animation.writers, "is_available", lambda n: False)
    got = _arrow_calls(viz, monkeypatch, tmp_path, "port")
    # JAX's failed ffmpeg attempt draws frames before its PNG pass
    ref = _arrow_calls(jax_viz, monkeypatch, tmp_path, "jax")[-len(got):]
    # three instances (background 0, 1, 2) a frame, on the two frames
    assert len(got) == 6
    phi = get_laser_phi(num_pts=450)
    _, results = _frames()
    inst = results[0]["instance_mask"]
    for (s, f, p, c), (rs, rf, rp, rc) in zip(got, ref):
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(f, rf)
        np.testing.assert_array_equal(p, rp)
        assert c == rc
        assert p is not None and np.all(np.abs(p) <= np.pi)
        k = [k for k in np.unique(inst) if (inst == k).sum() == len(p)][0]
        np.testing.assert_array_equal(p, phi[inst == k])


def test_video_without_ffmpeg_writes_png_frames(monkeypatch, tmp_path):
    from matplotlib import animation

    monkeypatch.setattr(animation.writers, "is_available", lambda n: False)
    scans, results = _frames()
    out = tmp_path / "video" / "two.mp4"
    viz.render_detection_video(scans, results, str(out))
    assert not out.exists()
    assert sorted(os.listdir(tmp_path / "video" / "two")) == [
        "frame_00000.png", "frame_00001.png"]
    # the flow video, as JAX renders it
    flows = np.stack([r["flow"] for r in results])
    viz.render_flow_video(scans, flows, flows, str(tmp_path / "flow.mp4"),
                          epe_list=[0.1, 0.2], aae_list=[1.0, 2.0])
    assert len(os.listdir(tmp_path / "flow")) == 2


def test_plot_helpers_match_jax():
    """Every figure helper draws the same points, arrows and titles as
    JAX's on the same inputs."""
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(5)
    scan = rng.uniform(1, 10, 450)
    flow, target = _flows(6), _flows(7)

    def content(fig):
        ax = fig.axes[0]
        return ([np.asarray(c.get_offsets()) for c in ax.collections],
                [np.asarray(getattr(c, "U", [])) for c in ax.collections],
                ax.get_title())

    for name, args in (("plot_gt_pred_flow", (scan, flow, target)),
                       ("plot_flow_hsv", (scan, flow)),
                       ("plot_histogram", (scan, "ranges"))):
        figs = [getattr(m, name)(*args) for m in (viz, jax_viz)]
        if name == "plot_histogram":
            got, ref = ([p.get_height() for p in f.axes[0].patches]
                        for f in figs)
            np.testing.assert_array_equal(got, ref)
        else:
            (got_off, got_u, got_t), (ref_off, ref_u, ref_t) = map(content,
                                                                   figs)
            assert got_t == ref_t
            for a, b in zip(got_off + got_u, ref_off + ref_u, strict=True):
                np.testing.assert_array_equal(a, b)
        for f in figs:
            plt.close(f)
    fig, ax = plt.subplots()
    viz.plot_scan(ax, scan)
    viz.plot_detections(ax, np.array([[1.0, 2.0]]), np.array([0.7]))
    assert len(ax.artists) + len(ax.patches) == 1 and ax.texts[0].get_text(
        ) == "0.70"
    plt.close(fig)


@pytest.fixture
def sequence(tmp_path):
    stem = write_synthetic_drow_split(str(tmp_path), "val", num_sequences=1,
                                      num_frames=4, num_people=4, seed=0,
                                      num_pts=NUM_PTS)[0]
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "network": "cutout_spatial", "pedestrian_only": True, "num_scans": 2,
        "similarity_kwargs": {"alpha": 0.5, "window_size": 5},
        "cutout_kwargs": dict(fixed=True, centered=True, window_width=1.0,
                              window_depth=0.5, num_cutout_pts=16,
                              padding_val=29.99, area_mode=True)}))
    return stem, str(cfg)


def test_infer_cli_video_passes_instance_masks(sequence, tmp_path,
                                               monkeypatch):
    stem, cfg = sequence
    seen = {}

    def render(scans, results, path, **kw):
        seen.update(scans=scans, results=results, path=path)

    monkeypatch.setattr(viz, "render_detection_video", render)
    # the model's seeded initial weights
    argv = ["--cfg", cfg, "--sequence", stem + ".csv", "--cpu"]
    rc, got, _ = infer_cli.infer(argv + ["--video", str(tmp_path / "v.mp4")])
    assert rc == 0 and seen["path"] == str(tmp_path / "v.mp4")
    assert seen["results"] is got and seen["scans"].shape == (4, NUM_PTS)
    for r in got:
        assert r["instance_mask"].shape == (NUM_PTS,)
        assert r["instance_mask"].dtype.kind in "iu"
    assert any(r["instance_mask"].max() > 0 for r in got)
    # without --video the field is not requested (its only reader is the
    # video's arrow colors)
    _, plain, _ = infer_cli.infer(argv)
    assert all(r["instance_mask"] is None for r in plain)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a["dets"], b["dets"])
