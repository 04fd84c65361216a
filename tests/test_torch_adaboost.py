"""The AdaBoost baseline of the port (``models/adaboost_detector.py``)
against the JAX package's, on the CPU.

Both are host float64 numpy. On a synthetic DROW sequence (450 beams, 3
people) the segments, their 15 features, the fitted stumps (feature,
threshold, polarity), the alphas, the decision scores and the detections
after NMS are equal to JAX's; the recall on the fitted frames stays above
JAX's own bar, 0.5 (``tests/test_adaboost.py``).
"""

from __future__ import annotations

import numpy as np

from planar_optical_flow_tpu.models import adaboost_detector as jax_ada
from planar_optical_flow_tpu_torch.data.synthetic import (
    make_synthetic_drow_sequence,
)
from planar_optical_flow_tpu_torch.models import AdaBoostPersonDetector
from planar_optical_flow_tpu_torch.models import adaboost_detector as ada
from planar_optical_flow_tpu_torch.ops.geometry import get_laser_phi

FRAMES, FIT, ESTIMATORS = 24, 18, 8


def _sequence():
    return make_synthetic_drow_sequence(num_frames=FRAMES, num_people=3,
                                        seed=3)


def test_segments_and_features_equal_jax():
    seq = _sequence()
    phi = get_laser_phi()
    for t in range(1, 4):
        scan, prev = seq["scans"][t], seq["scans"][t - 1]
        segs = ada.segment_scan(scan, phi)
        ref = jax_ada.segment_scan(scan, phi)
        assert len(segs) == len(ref) > 0
        for s, r in zip(segs, ref):
            np.testing.assert_array_equal(s, r)
            np.testing.assert_array_equal(
                ada.segment_features(scan, phi, s, prev),
                jax_ada.segment_features(scan, phi, r, prev))


def test_fit_and_detect_equal_jax():
    seq = _sequence()
    det = AdaBoostPersonDetector(n_estimators=ESTIMATORS)
    det.fit(seq["scans"][:FIT], seq["wps"][:FIT])
    ref = jax_ada.AdaBoostPersonDetector(n_estimators=ESTIMATORS)
    ref.fit(seq["scans"][:FIT], seq["wps"][:FIT])
    assert len(det.clf.stumps) == len(ref.clf.stumps) > 0
    for s, r in zip(det.clf.stumps, ref.clf.stumps):
        assert (s.feature, s.threshold, s.polarity) == (
            r.feature, r.threshold, r.polarity)
    assert det.clf.alphas == ref.clf.alphas

    phi = get_laser_phi()
    hits = total = 0
    for t in range(1, FRAMES):
        scan, prev = seq["scans"][t], seq["scans"][t - 1]
        xy, scores = det.detect(scan, phi, prev_scan=prev)
        ref_xy, ref_scores = ref.detect(scan, phi, prev_scan=prev)
        np.testing.assert_array_equal(xy, ref_xy)
        np.testing.assert_array_equal(scores, ref_scores)
        if t < FIT:
            for r, a in seq["wps"][t]:
                g = np.array([r * np.cos(a), r * np.sin(a)])
                total += 1
                hits += bool(len(xy)) and bool(
                    np.linalg.norm(xy - g, axis=1).min() < 0.6)
    assert total > 0 and hits / total > 0.5, (hits, total)
