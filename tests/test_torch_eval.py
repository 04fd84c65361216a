"""The port's detection AP, batched matcher and serving evaluators against
the JAX package's, on the same frames and weights.

Frames from ``write_synthetic_drow_split`` (64 beams, pinned seed), weights
from the JAX ``init`` carried across by the flax bridge. AP against JAX
within 1e-3, the batched evaluator against its own runner loop within
1e-6 (JAX's bar, ``tests/test_infer_eval.py:197-198``), flow EPE/AAE within
1e-3 relative; the matcher exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.data import DrowDetectionDataset as JaxDataset
from planar_optical_flow_tpu.eval import detection_ap as jax_ap
from planar_optical_flow_tpu.eval import evaluator as jax_eval
from planar_optical_flow_tpu.infer import StreamingRunner as JaxRunner
from planar_optical_flow_tpu_torch.data import (
    DrowDetectionDataset,
    write_synthetic_drow_split,
)
from planar_optical_flow_tpu_torch.eval import detection_ap
from planar_optical_flow_tpu_torch.eval import evaluator
from planar_optical_flow_tpu_torch.infer import StreamingRunner

from tests.test_torch_common import one_thread  # noqa: F401
from tests.test_torch_common import CUTOUT_KW, NUM_PTS, flow_drow_pair, to_jax

CONF = 0.3
DS_KW = dict(num_scans=2, pedestrian_only=True)



@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("drow"))
    write_synthetic_drow_split(root, "train", num_sequences=1, num_frames=18,
                               num_people=8, seed=0, num_pts=NUM_PTS)
    return root


@pytest.fixture(scope="module")
def setup(split):
    model, v_np, port = flow_drow_pair(seed=0)
    ds = DrowDetectionDataset(split, "train", device="cpu", **DS_KW)
    return model, to_jax(v_np), port, ds


# ------------------------------------------------------------ detection_ap

GT = np.array([[0.0, 0.0], [3.0, 0.0]])
AP_CASES = [
    [(np.array([[0.1, 0.0], [5.2, 0.1], [10.0, 0.0]]),
      np.array([0.9, 0.8, 0.7]), np.array([[0.0, 0.0], [5.0, 0.0]]))],
    [(np.array([[0.1, 0.0], [0.0, 0.1]]), np.array([0.5, 0.9]),
      np.array([[0.0, 0.0]]))],
    [(GT + 0.01, np.array([0.9, 0.8]), GT)],
    [(np.array([[50.0, 50.0]]), np.array([0.9]), GT)],
    [(np.array([[0.05, 0.0], [9.0, 9.0]]), np.array([0.9, 0.8]), GT)],
    [(np.zeros((0, 2)), np.zeros(0), GT),
     (np.array([[3.1, 0.0], [3.0, 0.2]]), np.array([0.6, 0.6]), GT)],
]


@pytest.mark.parametrize("case", range(len(AP_CASES)))
def test_detection_ap_matches_jax(case):
    """The cases of ``tests/test_infer_eval.py:57-108`` (and an empty frame
    with a tie) on both packages: equal flags, curves and scores."""
    frames = AP_CASES[case]
    for det, conf, gt in frames:
        got, ref = (detection_ap.match_detections(det, conf, gt),
                    jax_ap.match_detections(det, conf, gt))
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2]
    got = detection_ap.precision_recall_curve(frames)
    ref = jax_ap.precision_recall_curve(frames)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    p, r, _ = got
    for fn in ("average_precision", "peak_f1", "eer"):
        assert getattr(detection_ap, fn)(p, r) == getattr(jax_ap, fn)(p, r)
    if case == 2:
        assert detection_ap.average_precision(p, r) == pytest.approx(1.0)
    if case == 3:
        assert detection_ap.average_precision(p, r) == pytest.approx(0.0)


# ----------------------------------------------------------------- matcher


def _matcher_inputs(seed=0, f=6, k=10, g=4):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-3, 3, (f, g, 2)).astype(np.float32)
    gt_valid = rng.random((f, g)) < 0.75
    # detections near GT (two per GT in places) and clutter
    near = gt[:, rng.integers(0, g, k)[None].repeat(f, 0)[0]]
    xy = np.where(rng.random((f, k, 1)) < 0.6,
                  near + rng.normal(0, 0.3, (f, k, 2)),
                  rng.uniform(-4, 4, (f, k, 2))).astype(np.float32)
    # confidences on a coarse grid: ties within a frame
    conf = (rng.integers(0, 6, (f, k)) / 5.0).astype(np.float32)
    keep = rng.random((f, k)) < 0.8
    frame_valid = np.ones(f, bool)
    frame_valid[-1] = False
    return xy, conf, keep, gt, gt_valid, frame_valid


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("conf_thresh", [0.0, 0.3])
def test_batched_matcher_matches_jax(seed, conf_thresh):
    xy, conf, keep, gt, gt_valid, frame_valid = _matcher_inputs(seed)
    assert any(len(set(c)) < len(c) for c in conf)  # ties
    tp, conf_s, valid_s = evaluator.match_batched(
        *(torch.from_numpy(a) for a in (xy, conf, keep, gt, gt_valid,
                                        frame_valid)),
        radius=0.5, conf_thresh=conf_thresh)
    ref = jax_eval._make_batched_matcher(0.5, conf_thresh)(
        xy, conf, keep, gt, gt_valid, frame_valid)
    for got, want in zip((tp, conf_s, valid_s), ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tp.any() and (~tp & valid_s).any()
    # frame by frame, the pools of detection_ap.match_detections
    want = evaluator.match_frames(xy, conf, keep, gt, gt_valid, frame_valid,
                                  radius=0.5, conf_thresh=conf_thresh)
    for got, ref in zip((tp, conf_s, valid_s), want):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert not valid_s[-1].any()


# -------------------------------------------------------------- evaluators


def test_evaluate_detection_ap_matches_jax(setup, split):
    model, variables, port, ds = setup
    ref = jax_eval.evaluate_detection_ap(
        JaxRunner(model, variables, CUTOUT_KW, num_pts=NUM_PTS),
        JaxDataset(split, "train", **DS_KW), conf_thresh=CONF)
    got = evaluator.evaluate_detection_ap(
        StreamingRunner(port, CUTOUT_KW, num_pts=NUM_PTS, device="cpu"), ds,
        conf_thresh=CONF)
    assert got["num_frames"] == ref["num_frames"] == len(ds)
    gap = abs(got["ap"] - ref["ap"])
    print(f"\nevaluate_detection_ap: port {got['ap']:.6f}, JAX "
          f"{ref['ap']:.6f}, |gap| {gap:.3g}")
    assert gap <= 1e-3, (got, ref)
    assert 0.0 < ref["ap"] < 1.0


def test_batched_module_equals_runner_loop(setup):
    _, _, port, ds = setup
    ref = evaluator.evaluate_detection_ap(
        StreamingRunner(port, CUTOUT_KW, num_pts=NUM_PTS, device="cpu"), ds,
        conf_thresh=CONF)
    frames = evaluator.DetectionEvalFrames.from_dataset(ds)
    got = evaluator.evaluate_detection_ap_batched(
        port, CUTOUT_KW, frames, batch_streams=1, conf_thresh=CONF,
        engine="module", device="cpu")
    assert got["num_frames"] == ref["num_frames"] == len(ds)
    np.testing.assert_allclose(got["ap"], ref["ap"], atol=1e-6)
    # a step built before is reused as it is
    step = evaluator.make_ap_step(port, CUTOUT_KW, "module", NUM_PTS,
                                  device="cpu")
    again = evaluator.evaluate_detection_ap_batched(
        None, None, frames, batch_streams=1, conf_thresh=CONF, step=step,
        device="cpu")
    assert again == got


@pytest.mark.parametrize("engine", ["module", "v3", "int8c"])
def test_batched_engines_score_every_frame(setup, engine):
    _, _, port, ds = setup
    got = evaluator.evaluate_detection_ap_batched(
        port, CUTOUT_KW, ds, batch_streams=4, conf_thresh=CONF,
        engine=engine, device="cpu")
    assert got["num_frames"] == len(ds)
    assert 0.0 <= got["ap"] <= 1.0
    for k in ("peak_f1", "eer"):
        assert 0.0 <= got[k] <= 1.0


def test_batched_warns_on_ignored_module_options(setup):
    _, _, port, ds = setup
    with pytest.warns(UserWarning, match="ignored"):
        evaluator.evaluate_detection_ap_batched(
            port, CUTOUT_KW, ds, batch_streams=8, engine="v3",
            gate_mix="xla", device="cpu")


def test_evaluate_flow_serving_matches_jax(setup, split):
    """Both evaluators on the same frames (the port's dataset, held to
    JAX's in ``test_torch_data.py``). Each package's own dataset would move
    AAE: targets of frames whose two poses coincide are ~1e-8 m long, and
    their direction follows the last bit of a cosine."""
    model, variables, port, ds = setup
    ds.use_augmentation = True
    ref = jax_eval.evaluate_flow_serving(model, variables, CUTOUT_KW, ds,
                                         num_pts=NUM_PTS, batch_streams=4)
    assert ds.use_augmentation is True  # restored
    got = evaluator.evaluate_flow_serving(port, CUTOUT_KW, ds,
                                          num_pts=NUM_PTS, batch_streams=4,
                                          device="cpu")
    assert ds.use_augmentation is True
    ds.use_augmentation = False
    own = jax_eval.evaluate_flow_serving(
        model, variables, CUTOUT_KW, JaxDataset(split, "train", **DS_KW),
        num_pts=NUM_PTS, batch_streams=4)
    print(f"\nevaluate_flow_serving: port {got}, JAX {ref}, JAX on its own "
          f"dataset {own}")
    for k in ("num_frames", "frames_dropped", "engine"):
        assert got[k] == ref[k], k
    assert got["frames_dropped"] == len(ds) % 4
    for k in ("epe", "aae"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3)
    np.testing.assert_allclose(got["epe"], own["epe"], rtol=1e-3)
    with pytest.raises(ValueError, match="batch_streams"):
        evaluator.evaluate_flow_serving(port, CUTOUT_KW, ds,
                                        num_pts=NUM_PTS,
                                        batch_streams=len(ds) + 1,
                                        device="cpu")


class _Moving:
    """A flow dataset whose exclude mask also drops the points of ``keep``
    that are False (``frames.batch`` otherwise as it is)."""

    def __init__(self, frames, keep):
        self.frames, self.keep = frames, keep
        self.use_augmentation = False

    def __len__(self):
        return len(self.frames)

    def batch(self, indices):
        b = dict(self.frames.batch(indices))
        b["exclude_mask"] = (np.asarray(b["exclude_mask"])
                             * self.keep[np.asarray(indices)])
        return b


MIN_FLOW = 1e-3  # m: AAE is taken where the target is at least this long


def test_evaluate_flow_serving_own_datasets(setup, split):
    """Each package end to end on its own dataset: EPE and AAE agree over
    every point, and on the points whose flow target is at least
    ``MIN_FLOW`` long. On the others (frames whose two poses coincide:
    ~1e-8 m targets in both packages, 54 of 930 points here) the target's
    direction follows the roundings of the f32 target pass, which the port
    takes in the order of JAX's jitted one; both AAEs are printed."""
    model, variables, port, ds = setup
    ref_ds = JaxDataset(split, "train", **DS_KW)
    kw = dict(num_pts=NUM_PTS, batch_streams=4)
    got = evaluator.evaluate_flow_serving(port, CUTOUT_KW, ds, device="cpu",
                                          **kw)
    ref = jax_eval.evaluate_flow_serving(model, variables, CUTOUT_KW,
                                         ref_ds, **kw)
    np.testing.assert_allclose(got["epe"], ref["epe"], rtol=1e-3)
    np.testing.assert_allclose(got["aae"], ref["aae"], rtol=1e-3)
    keep = (np.linalg.norm(np.asarray(ref_ds.target_flow), axis=-1)
            >= MIN_FLOW).astype(np.float32)
    short = int(((keep == 0) & (np.asarray(ref_ds.exclude_mask) > 0)).sum())
    assert 0 < short < keep.size  # both kinds of point are scored
    got_m = evaluator.evaluate_flow_serving(port, CUTOUT_KW, _Moving(ds, keep),
                                            device="cpu", **kw)
    ref_m = jax_eval.evaluate_flow_serving(model, variables, CUTOUT_KW,
                                           _Moving(ref_ds, keep), **kw)
    print(f"\nevaluate_flow_serving, each on its own dataset: port {got}, "
          f"JAX {ref}; targets >= {MIN_FLOW} m: port {got_m}, JAX {ref_m} "
          f"({short} shorter masked-in points left out)")
    for k in ("epe", "aae"):
        np.testing.assert_allclose(got_m[k], ref_m[k], rtol=1e-3)


def test_evaluate_flow_serving_int8c(setup):
    _, _, port, ds = setup
    got = evaluator.evaluate_flow_serving(port, CUTOUT_KW, ds,
                                          engine="int8c", num_pts=NUM_PTS,
                                          batch_streams=8, device="cpu")
    assert np.isfinite(got["epe"]) and np.isfinite(got["aae"])
    assert got["num_frames"] == len(ds) // 8 * 8
