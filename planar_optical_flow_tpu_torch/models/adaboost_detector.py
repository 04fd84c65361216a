"""Classical person detector: scan segmentation + hand-crafted features +
AdaBoost of decision stumps.

Counterpart of ``planar_optical_flow_tpu/models/adaboost_detector.py``, the
baseline of the reference (``src/depracted/model/adaboost_person_det.py``):
scans are split into segments at range discontinuities ("jump distance"),
each segment yields a fixed-length geometric feature vector, and a
boosted-stump classifier (discrete SAMME, decision stumps, no sklearn)
labels segments as person / not-person; detections are the segment
centroids after a greedy distance NMS.

This stays on the host in float64 numpy, as in JAX, where it is a CPU
baseline and no device workload: the stump search compares weighted error
sums, and a summation order other than numpy's would flip its ties and
choose other stumps. No entry point here takes a device.
"""

from __future__ import annotations

import numpy as np

from planar_optical_flow_tpu_torch.ops.geometry import get_laser_phi

_NUM_FEATURES = 15


def segment_scan(scan: np.ndarray, phi: np.ndarray, jump_dist: float = 0.3,
                 min_points: int = 3, max_range: float = 25.0):
    """Split a scan into contiguous segments at range jumps.

    Returns a list of index arrays (reference ``adaboost_person_det.py:71-90``).
    """
    valid = scan < max_range
    jumps = np.abs(np.diff(scan)) > jump_dist
    boundaries = np.flatnonzero(jumps) + 1
    segments = []
    for part in np.split(np.arange(len(scan)), boundaries):
        part = part[valid[part]]
        if len(part) >= min_points:
            segments.append(part)
    return segments


def _fit_line_residual(xy):
    """RMS residual of the least-squares line through the points."""
    centered = xy - xy.mean(axis=0)
    if len(xy) < 2:
        return 0.0
    # smallest singular value = residual spread orthogonal to the line
    s = np.linalg.svd(centered, compute_uv=False)
    return float(s[-1] / np.sqrt(len(xy)))


def _fit_circle_residual(xy):
    """Kasa circle fit residual and radius."""
    if len(xy) < 3:
        return 0.0, 0.0
    a = np.column_stack([2 * xy, np.ones(len(xy))])
    b = (xy**2).sum(axis=1)
    try:
        sol, *_ = np.linalg.lstsq(a, b, rcond=None)
    except np.linalg.LinAlgError:
        return 0.0, 0.0
    center = sol[:2]
    radius = np.sqrt(max(sol[2] + center @ center, 0.0))
    res = np.abs(np.linalg.norm(xy - center, axis=1) - radius)
    return float(np.sqrt((res**2).mean())), float(radius)


def segment_features(scan, phi, seg_idx, prev_scan=None) -> np.ndarray:
    """15 geometric features of one segment (reference ``:102-211``):
    point count, std, mean-average-deviation from median, left/right jump
    distances, width, linearity, circularity, radius, boundary length,
    boundary regularity, mean curvature, mean angular difference, mean range,
    mean speed (vs previous scan)."""
    r = scan[seg_idx]
    p = phi[seg_idx]
    xy = np.stack((r * np.cos(p), r * np.sin(p)), axis=1)
    n = len(seg_idx)

    std = float(r.std())
    mad_med = float(np.mean(np.abs(r - np.median(r))))

    jl = float(abs(scan[seg_idx[0]] - scan[seg_idx[0] - 1])) \
        if seg_idx[0] > 0 else 0.0
    jr = float(abs(scan[min(seg_idx[-1] + 1, len(scan) - 1)]
                   - scan[seg_idx[-1]]))

    width = float(np.linalg.norm(xy[-1] - xy[0]))
    linearity = _fit_line_residual(xy)
    circularity, radius = _fit_circle_residual(xy)

    d = np.linalg.norm(np.diff(xy, axis=0), axis=1) if n > 1 else np.zeros(1)
    boundary_len = float(d.sum())
    boundary_reg = float(d.std())

    if n > 2:
        v1 = xy[1:-1] - xy[:-2]
        v2 = xy[2:] - xy[1:-1]
        cross = v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]
        dot = (v1 * v2).sum(axis=1)
        curvature = float(np.mean(np.abs(np.arctan2(cross, dot))))
    else:
        curvature = 0.0

    ang_diff = float(np.mean(np.abs(np.diff(p)))) if n > 1 else 0.0
    mean_range = float(r.mean())

    if prev_scan is not None:
        speed = float(np.mean(np.abs(r - prev_scan[seg_idx])))
    else:
        speed = 0.0

    return np.array(
        [n, std, mad_med, jl, jr, width, linearity, circularity, radius,
         boundary_len, boundary_reg, curvature, ang_diff, mean_range, speed],
        dtype=np.float64,
    )


class DecisionStump:
    __slots__ = ("feature", "threshold", "polarity")

    def __init__(self, feature=0, threshold=0.0, polarity=1):
        self.feature = feature
        self.threshold = threshold
        self.polarity = polarity

    def predict(self, X):
        return np.where(
            self.polarity * (X[:, self.feature] - self.threshold) > 0, 1, -1
        )


def _fit_stump(X, y, w, n_cuts: int = 32):
    """Best weighted stump over quantile-candidate thresholds."""
    best = (None, np.inf)
    for f in range(X.shape[1]):
        col = X[:, f]
        qs = np.quantile(col, np.linspace(0.02, 0.98, n_cuts))
        for t in np.unique(qs):
            for pol in (1, -1):
                pred = np.where(pol * (col - t) > 0, 1, -1)
                err = float(np.sum(w[pred != y]))
                if err < best[1]:
                    best = (DecisionStump(f, float(t), pol), err)
    return best


class BoostedSegmentClassifier:
    """AdaBoost (discrete SAMME, binary) over decision stumps."""

    def __init__(self, n_estimators: int = 50):
        self.n_estimators = n_estimators
        self.stumps: list[DecisionStump] = []
        self.alphas: list[float] = []

    def fit(self, X, y):
        """X ``(N, F)``, y in {0, 1}."""
        X = np.asarray(X, np.float64)
        y = np.where(np.asarray(y) > 0, 1, -1)
        w = np.full(len(y), 1.0 / len(y))
        self.stumps, self.alphas = [], []
        for _ in range(self.n_estimators):
            stump, err = _fit_stump(X, y, w)
            err = max(min(err, 1 - 1e-10), 1e-10)
            if stump is None or err >= 0.5:
                break
            alpha = 0.5 * np.log((1 - err) / err)
            pred = stump.predict(X)
            w = w * np.exp(-alpha * y * pred)
            w /= w.sum()
            self.stumps.append(stump)
            self.alphas.append(float(alpha))
        return self

    def decision_function(self, X):
        X = np.asarray(X, np.float64)
        score = np.zeros(len(X))
        for stump, alpha in zip(self.stumps, self.alphas):
            score += alpha * stump.predict(X)
        denom = sum(self.alphas) or 1.0
        return score / denom

    def predict(self, X):
        return (self.decision_function(X) > 0).astype(np.int32)


class AdaBoostPersonDetector:
    """End-to-end classical detector: segment -> features -> boost ->
    segment-centroid detections with distance NMS."""

    def __init__(self, n_estimators: int = 50, jump_dist: float = 0.3,
                 min_points: int = 3, nms_dist: float = 0.5):
        self.clf = BoostedSegmentClassifier(n_estimators)
        self.jump_dist = jump_dist
        self.min_points = min_points
        self.nms_dist = nms_dist

    def _collect(self, scans, annotations, phi, radius=0.5):
        feats, labels = [], []
        prev = None
        for scan, dets in zip(scans, annotations):
            det_xy = np.asarray(
                [[r * np.cos(a), r * np.sin(a)] for r, a in dets]
            ).reshape(-1, 2)
            for seg in segment_scan(scan, phi, self.jump_dist,
                                    self.min_points):
                f = segment_features(scan, phi, seg, prev)
                r, p = scan[seg], phi[seg]
                centroid = np.array(
                    [np.mean(r * np.cos(p)), np.mean(r * np.sin(p))]
                )
                pos = len(det_xy) > 0 and (
                    np.linalg.norm(det_xy - centroid, axis=1).min() <= radius
                )
                feats.append(f)
                labels.append(1 if pos else 0)
            prev = scan
        return np.asarray(feats), np.asarray(labels)

    def fit(self, scans, annotations, phi=None):
        phi = get_laser_phi(num_pts=scans.shape[-1]) if phi is None else phi
        X, y = self._collect(scans, annotations, phi)
        if y.sum() == 0 or y.sum() == len(y):
            raise ValueError("need both positive and negative segments")
        self.clf.fit(X, y)
        return self

    def detect(self, scan, phi=None, prev_scan=None, thresh: float = 0.0):
        """-> (det_xy (N, 2), scores (N,)) after NMS."""
        phi = get_laser_phi(num_pts=len(scan)) if phi is None else phi
        segs = segment_scan(scan, phi, self.jump_dist, self.min_points)
        if not segs:
            return np.zeros((0, 2)), np.zeros(0)
        X = np.stack([segment_features(scan, phi, s, prev_scan)
                      for s in segs])
        scores = self.clf.decision_function(X)
        cents = np.stack([
            [np.mean(scan[s] * np.cos(phi[s])),
             np.mean(scan[s] * np.sin(phi[s]))]
            for s in segs
        ])
        keep_idx = np.flatnonzero(scores > thresh)
        cents, scores = cents[keep_idx], scores[keep_idx]
        # greedy centroid NMS (reference ``:11-37``)
        order = np.argsort(-scores)
        kept = []
        for i in order:
            if all(np.linalg.norm(cents[i] - cents[j]) >= self.nms_dist
                   for j in kept):
                kept.append(i)
        return cents[kept], scores[kept]
