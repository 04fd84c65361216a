"""JRDB data layer: the sequence handle, the box-regression dataset and the
synthetic on-disk writer.

Counterpart of ``planar_optical_flow_tpu/data/jrdb.py``, host numpy as
there: the fixed 18-train / 9-val split (only sequences present on disk
are kept), labelled frames indexed flat, a pseudo-centre perturbed at
random about each box, the segment cropped within ``radius_segment`` of
it, canonicalized with an input-angle channel, SE(2) + scale augmentation
and resampling to ``input_size`` points. The neighbouring boxes of each
sample (for the IoU metric) are padded to ``(max_neighbors, 7 | 5)`` with a
validity mask. Every draw comes from ``np.random.default_rng`` in JAX's
order, so fresh datasets with the same seed, read in the same order, give
samples equal to JAX's to the bit.
"""

from __future__ import annotations

import json
import os

import numpy as np

from planar_optical_flow_tpu_torch.data import jrdb_transforms as jt
from planar_optical_flow_tpu_torch.data.pcd import read_pcd_xyz, write_pcd

JRDB_TRAIN_SEQUENCES = [
    "packard-poster-session-2019-03-20_2",
    "packard-poster-session-2019-03-20_1",
    "clark-center-intersection-2019-02-28_0",
    "huang-lane-2019-02-12_0",
    "jordan-hall-2019-04-22_0",
    "memorial-court-2019-03-16_0",
    "packard-poster-session-2019-03-20_0",
    "clark-center-2019-02-28_1",
    "stlc-111-2019-04-19_0",
    "clark-center-2019-02-28_0",
    "tressider-2019-03-16_0",
    "svl-meeting-gates-2-2019-04-08_1",
    "forbes-cafe-2019-01-22_0",
    "gates-159-group-meeting-2019-04-03_0",
    "huang-basement-2019-01-25_0",
    "svl-meeting-gates-2-2019-04-08_0",
    "tressider-2019-03-16_1",
    "nvidia-aud-2019-04-18_0",
]

JRDB_VAL_SEQUENCES = [
    "cubberly-auditorium-2019-04-22_0",
    "tressider-2019-04-26_2",
    "gates-to-clark-2019-02-28_1",
    "meyer-green-2019-03-16_0",
    "gates-basement-elevators-2019-01-17_1",
    "huang-2-2019-01-25_0",
    "bytes-cafe-2019-02-07_0",
    "hewlett-packard-intersection-2019-01-24_0",
    "gates-ai-lab-2019-02-08_0",
]


class JrdbHandle:
    """Frame-level access to JRDB sequences (lazy point-cloud loading)."""

    def __init__(self, split: str, cfg: dict, sequences=None):
        assert split in ("train", "val", "test"), split
        if split == "test":  # test labels unavailable upstream; use val
            split = "val"
        self.radius_segment = cfg.get("radius_segment", 0.4)
        self.perturb = cfg.get("perturb", 0.1)
        self.is_3d = cfg.get("is_3d", True)
        self._rng = np.random.default_rng(cfg.get("seed", 0))
        self.debug_one_sample = cfg.get("debug_one_sample", False)

        data_dir = os.path.abspath(os.path.expanduser(cfg["data_dir"]))
        self.data_dir = os.path.join(data_dir, "train_dataset")
        if sequences is None:
            sequences = (
                JRDB_TRAIN_SEQUENCES if split == "train"
                else JRDB_VAL_SEQUENCES
            )
            # only keep sequences that exist on disk (synthetic subsets)
            sequences = [
                s for s in sequences
                if os.path.isdir(os.path.join(self.data_dir, "timestamps", s))
            ]
        self.sequence_names = sequences
        if not self.sequence_names:
            raise FileNotFoundError(f"no JRDB sequences under {self.data_dir}")

        self._frames, self._labels = [], []
        self._flat = []
        for si, seq in enumerate(self.sequence_names):
            with open(os.path.join(self.data_dir, "timestamps", seq,
                                   "frames_pc_laser.json")) as f:
                frames = json.load(f)["data"]
            with open(os.path.join(self.data_dir, "labels", "labels_3d",
                                   f"{seq}.json")) as f:
                labels = json.load(f)["labels"]
            self._frames.append(frames)
            self._labels.append(labels)
            for fi, fr in enumerate(frames):
                name = os.path.basename(
                    fr["pointclouds"]["upper_velodyne"]["url"]
                )
                if name in labels:
                    self._flat.append((si, fi))

    def __len__(self):
        return len(self._flat)

    def __getitem__(self, idx):
        si, fi = self._flat[idx]
        frame = dict(self._frames[si][fi])
        if self.is_3d:
            pc = read_pcd_xyz(
                os.path.join(
                    self.data_dir,
                    frame["pointclouds"]["upper_velodyne"]["url"],
                )
            )
            points = jt.transform_pts_upper_velodyne_to_base(pc.T).T
        else:
            laser_r = np.loadtxt(
                os.path.join(self.data_dir, frame["laser"]["url"]),
                dtype=np.float32,
            )
            phi = np.linspace(-np.pi, np.pi, len(laser_r), dtype=np.float32)
            pts = np.stack(
                (laser_r * np.cos(phi), laser_r * np.sin(phi),
                 np.full(len(laser_r), -0.7, np.float32)),
            )
            points = jt.transform_pts_laser_to_base(pts).T

        name = os.path.basename(
            frame["pointclouds"]["upper_velodyne"]["url"]
        )
        anns = self._labels[si][name]
        segments, boxes, centers = self.annotations_to_segments(points, anns)
        frame.update(
            segments=segments, boxes=boxes, dets_center=centers,
            points=points,
        )
        return frame

    def annotations_to_segments(self, points, anns):
        """Radius-crop one segment per annotation around a randomly perturbed
        pseudo-center (JAX ``JrdbHandle.annotations_to_segments``)."""
        segments, boxes, centers = [], [], []
        for ann in anns:
            b = ann["box"]
            if self.is_3d:
                if self.debug_one_sample:
                    center = np.array([b["cx"], b["cy"], 0.176])
                else:
                    a = self._rng.uniform(0, 2 * np.pi)
                    r = self._rng.uniform(-self.perturb, self.perturb)
                    center = np.array(
                        [b["cx"] + r * np.cos(a), b["cy"] + r * np.sin(a),
                         0.176]
                    )
                near = (
                    np.linalg.norm(points[:, :2] - center[:2], axis=1)
                    <= self.radius_segment
                )
                segments.append(points[near])
                boxes.append(
                    [b["cx"], b["cy"], b["cz"], b["l"], b["w"], b["h"],
                     b["rot_z"]]
                )
            else:
                a = self._rng.uniform(0, 2 * np.pi)
                r = self._rng.uniform(-self.perturb, self.perturb)
                center = np.array(
                    [b["cx"] + r * np.cos(a), b["cy"] + r * np.sin(a)]
                )
                near = (
                    np.linalg.norm(points[:, :2] - center, axis=1)
                    <= self.radius_segment
                )
                segments.append(points[near, :2])
                boxes.append([b["cx"], b["cy"], b["l"], b["w"], b["rot_z"]])
            centers.append(center)
        return segments, np.asarray(boxes, np.float32), np.asarray(
            centers, np.float32
        )

    @staticmethod
    def box_is_on_ground(ann: dict) -> bool:
        b = ann["box"]
        return float(b["cz"]) - 0.5 * float(b["h"]) < -0.69


def _wrap_pi(a):
    while a > np.pi:
        a -= 2 * np.pi
    while a < -np.pi:
        a += 2 * np.pi
    return a


class JrdbBoxRegressionDataset:
    """Materialized (segment, target) samples for box-regression training
    (JAX ``JrdbBoxRegressionDataset``)."""

    def __init__(self, split: str, cfg: dict, sequences=None, seed: int = 0):
        self.handle = JrdbHandle(split, cfg, sequences=sequences)
        self.input_size = cfg.get("input_size", 256)
        self.is_3d = cfg.get("is_3d", True)
        self.mode = split
        self.input_with_angle = cfg.get("input_with_angle", True)
        self.max_neighbors = cfg.get("max_neighbors", 8)
        aug = cfg.get("augmentation_kwargs", {})
        self.aug = {
            "use_data_augmentation": aug.get("use_data_augmentation", False),
            "rot_max": aug.get("rot_max", 0.25),
            "dist_max": aug.get("dist_max", 0.3),
            "dim_max": aug.get("dim_max", 0.2),
            "random_drop": aug.get("random_drop", 0.25),
        }
        self._rng = np.random.default_rng(seed)
        min_size = cfg.get("min_segment_size", 5)

        self.inputs, self.targets = [], []
        self.dets_center, self.targets_neighbor = [], []
        for frame in self.handle:
            boxes = frame["boxes"]
            for seg, box, center in zip(
                frame["segments"], boxes, frame["dets_center"]
            ):
                if len(seg) <= min_size:
                    continue
                box = np.asarray(box, np.float64).copy()
                box[-1] = _wrap_pi(box[-1])
                self.inputs.append(np.asarray(seg))
                self.targets.append(box)
                self.targets_neighbor.append(
                    self.nearby_annotations(box, boxes)
                )
                self.dets_center.append(np.asarray(center))
                if (
                    self.aug["use_data_augmentation"] and split == "train"
                ):
                    s2, b2, c2 = self.augment(np.asarray(seg), box, center)
                    self.inputs.append(s2)
                    self.targets.append(b2)
                    self.targets_neighbor.append(
                        self.nearby_annotations(b2, boxes)
                    )
                    self.dets_center.append(c2)

    def __len__(self):
        return len(self.inputs)

    def nearby_annotations(self, target, anns, radius: float = 1.0):
        """GT boxes within ``radius`` of the target center, plus the target
        itself (for the max-IoU metric)."""
        anns = np.asarray(anns)
        k = 3 if self.is_3d else 2  # center coords only
        near = anns[
            np.linalg.norm(anns[:, :k] - target[:k], axis=1) <= radius
        ]
        return np.vstack([near, target[None]])

    def augment(self, seg, target, det_center):
        """Random SE(2) + dimension-scale augmentation
        (JAX ``JrdbBoxRegressionDataset.augment``)."""
        rot = self._rng.uniform(-self.aug["rot_max"] * np.pi,
                                self.aug["rot_max"] * np.pi)
        scale = 1.0 + self._rng.uniform(-self.aug["dim_max"],
                                        self.aug["dim_max"])
        trans = self._rng.uniform(-self.aug["dist_max"],
                                  self.aug["dist_max"], 2)
        c, s = np.cos(rot), np.sin(rot)
        R = np.array([[c, -s], [s, c]])
        bc = target[:2]

        seg2 = seg.copy()
        seg2[:, :2] = (seg[:, :2] - bc) @ R.T + bc + trans
        dc2 = det_center.copy()
        dc2[:2] = (det_center[:2] - bc) @ R.T + bc + trans
        if self.is_3d:
            t2 = np.concatenate(
                [bc + trans, [target[2]],
                 target[3:6] * scale, [target[6] - rot]]
            )
        else:
            t2 = np.concatenate(
                [bc + trans, target[2:4] * scale, [target[4] - rot]]
            )
        t2[-1] = _wrap_pi(t2[-1])
        return seg2, t2, dc2

    def __getitem__(self, idx):
        inp = self.inputs[idx].copy()
        det_center = self.dets_center[idx]
        target = self.targets[idx][2:].copy()  # cz/dims/ori (3D), dims/ori 2D
        box_center = self.targets[idx][:3 if self.is_3d else 2].copy()

        inp = inp - det_center
        if self.is_3d:
            # canonicalize cz against the pseudo-center height
            target[0] = target[0] - det_center[-1]

        out = {}
        if self.input_with_angle:
            rot_z = target[-1]
            out["rot_z"] = np.float32(rot_z)
            ang = rot_z + self._rng.uniform(
                -self.aug["rot_max"] * np.pi, self.aug["rot_max"] * np.pi
            )
            inp = np.hstack([inp, np.full((len(inp), 1), ang)])
            target[-1] = rot_z - ang

        if self.aug["use_data_augmentation"] and self.mode == "train":
            self._rng.shuffle(inp)
            inp = inp[int(len(inp) * self.aug["random_drop"]):]

        # fixed-size resample
        if len(inp) > self.input_size:
            self._rng.shuffle(inp)
            inp = inp[: self.input_size]
        else:
            repeat = self.input_size // len(inp)
            pad = self.input_size % len(inp)
            self._rng.shuffle(inp)
            inp = np.repeat(inp, repeat, axis=0)
            inp = np.vstack([inp, inp[:pad]])
            self._rng.shuffle(inp)

        nbr = self.targets_neighbor[idx]
        k = self.max_neighbors
        nbr_pad = np.zeros((k, nbr.shape[1]), np.float32)
        nbr_valid = np.zeros(k, bool)
        take = min(k, len(nbr))
        nbr_pad[:take] = nbr[-take:]  # keep the target itself (last row)
        nbr_valid[:take] = True

        out.update(
            input=inp.astype(np.float32),
            target=target.astype(np.float32),
            det_center=det_center.astype(np.float32),
            box_center=box_center.astype(np.float32),
            target_neighbor=nbr_pad,
            target_neighbor_valid=nbr_valid,
        )
        return out

    def batch(self, indices):
        samples = [self[int(i)] for i in indices]
        return {
            k: np.stack([s[k] for s in samples]) for k in samples[0]
        }


def write_synthetic_jrdb(data_dir: str, sequences=None, num_frames: int = 3,
                         boxes_per_frame: int = 4, seed: int = 0,
                         pcd_mode: str = "binary_compressed"):
    """Emit the JRDB on-disk layout with synthetic clouds/labels/lasers."""
    from planar_optical_flow_tpu_torch.data.synthetic import (
        make_synthetic_jrdb,
    )

    if sequences is None:
        sequences = JRDB_TRAIN_SEQUENCES[:2] + JRDB_VAL_SEQUENCES[:1]
    base = os.path.join(data_dir, "train_dataset")
    rng = np.random.default_rng(seed)
    for si, seq in enumerate(sequences):
        frames = make_synthetic_jrdb(
            num_frames=num_frames, boxes_per_frame=boxes_per_frame,
            seed=seed * 100 + si,
        )
        ts_dir = os.path.join(base, "timestamps", seq)
        pc_dir = os.path.join(base, "pointclouds", "upper_velodyne", seq)
        ls_dir = os.path.join(base, "lasers", seq)
        lb_dir = os.path.join(base, "labels", "labels_3d")
        for d in (ts_dir, pc_dir, ls_dir, lb_dir):
            os.makedirs(d, exist_ok=True)

        meta, labels = [], {}
        for fi, fr in enumerate(frames):
            name = f"{fi:06d}.pcd"
            # stored in upper-velodyne frame: undo the base transform
            pts_uv = jt.transform_pts_base_to_upper_velodyne(
                fr["points"].T
            ).T
            write_pcd(os.path.join(pc_dir, name), pts_uv, mode=pcd_mode)
            laser = rng.uniform(0.5, 20.0, size=360).astype(np.float32)
            np.savetxt(os.path.join(ls_dir, f"{fi:06d}.txt"), laser,
                       fmt="%.4f")
            meta.append(
                {
                    "timestamp": fi * 0.1,
                    "pointclouds": {
                        "upper_velodyne": {
                            "url": f"pointclouds/upper_velodyne/{seq}/{name}"
                        }
                    },
                    "laser": {"url": f"lasers/{seq}/{fi:06d}.txt"},
                }
            )
            labels[name] = [
                {
                    "box": {
                        "cx": float(b[0]), "cy": float(b[1]),
                        "cz": float(b[2]), "l": float(b[3]),
                        "w": float(b[4]), "h": float(b[5]),
                        "rot_z": float(b[6]),
                    },
                    "label_id": f"pedestrian:{j}",
                }
                for j, b in enumerate(fr["boxes"])
            ]
        with open(os.path.join(ts_dir, "frames_pc_laser.json"), "w") as f:
            json.dump({"data": meta}, f)
        with open(os.path.join(lb_dir, f"{seq}.json"), "w") as f:
            json.dump({"labels": labels}, f)
    return sequences
