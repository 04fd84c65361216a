"""DROW detection + per-point flow dataset (temporal scan stacks).

Counterpart of ``planar_optical_flow_tpu/data/drow_detection.py``
``DrowDetectionDataset``:

* frames where the odometry does not change are dropped;
* each annotated frame gives a sample of ``num_scans`` history scans ending
  ``flow_distance`` frames back, plus the current scan;
* per-point class/offset targets from the wc/wa/wp annotations (radii
  0.6/0.4/0.35 m; pedestrian-only mode matches wp alone);
* the ego-motion flow target between the oldest stacked scan's pose and the
  current pose, in per-beam canonical frames;
* an exclude mask (dynamic radii 2.5/2.0/2.0 m times range < 20 m).

The targets of all samples are computed at construction in one batched pass
of tensor ops (``ops/targets.py``) on ``device`` (default ``"cuda"``; it
raises without a card, ``device="cpu"`` runs on the host), where JAX jits a
vmapped f32 program on its default device. The classes, offsets and masks
run in float64 from the f32 data, so the card and the host give the same
classes and masks; the flow target runs in f32 in the order of JAX's jitted
pass on the CPU (:func:`_flow_target_f32`), so that the ~1e-8 m targets of
frames whose two poses coincide point where JAX's do (wherever the sine and
cosine of the two poses' angles agree to the bit with XLA's). The targets
are kept as numpy arrays (float32, int32). A point within
about one f32 ulp of a radius (2.4e-7 m at 2 m) can therefore take
another class or mask value than in JAX's f32 pass: in f32 the host's
last bits of a sine, cosine or root decide it, and the card's can differ
from the host's (``experiments/torch_target_precision.py`` lists such
points with their distances to the radius).
Batches carry raw ``(S+1, P)`` scan stacks; the network's input encoding
runs in the step.
"""

from __future__ import annotations

import numpy as np
import torch

from planar_optical_flow_tpu_torch import resolve_device
from planar_optical_flow_tpu_torch.data import drow_io
from planar_optical_flow_tpu_torch.ops import targets as tgt_ops
from planar_optical_flow_tpu_torch.ops.geometry import (
    get_laser_phi,
    global_to_canonical_flow,
)

_CLS_RADII = {"wc": 0.6, "wa": 0.4, "wp": 0.35}
_DYN_RADII = {"wc": 2.5, "wa": 2.0, "wp": 2.0}


def _pad_frame_dets(wcs, was, wps, pedestrian_only, pad_to):
    """One frame's annotations -> padded (rphi (D,2), cls_radius, dyn_radius,
    label, cls_valid, dyn_valid).

    The dynamic mask always sees wc+wa+wp (``dyn_valid``); only the cls/reg
    matching (``cls_valid``) is restricted to wp in pedestrian-only mode,
    where wp entries are packed first so that padding never cuts them.
    """
    if pedestrian_only:
        groups = [
            (wps, _CLS_RADII["wp"], _DYN_RADII["wp"], 1, True),
            (wcs, _CLS_RADII["wc"], _DYN_RADII["wc"], 0, False),
            (was, _CLS_RADII["wa"], _DYN_RADII["wa"], 0, False),
        ]
    else:
        groups = [
            (wcs, _CLS_RADII["wc"], _DYN_RADII["wc"], 1, True),
            (was, _CLS_RADII["wa"], _DYN_RADII["wa"], 2, True),
            (wps, _CLS_RADII["wp"], _DYN_RADII["wp"], 3, True),
        ]
    rphi = np.zeros((pad_to, 2), np.float32)
    cls_r = np.zeros(pad_to, np.float32)
    dyn_r = np.zeros(pad_to, np.float32)
    label = np.zeros(pad_to, np.int32)
    cls_valid = np.zeros(pad_to, bool)
    dyn_valid = np.zeros(pad_to, bool)
    i = 0
    for dets, cr, dr, lab, for_cls in groups:
        for r, phi in dets:
            if i >= pad_to:
                break
            rphi[i] = (r, phi)
            cls_r[i], dyn_r[i], label[i] = cr, dr, lab
            cls_valid[i], dyn_valid[i] = for_cls, True
            i += 1
    return rphi, cls_r, dyn_r, label, cls_valid, dyn_valid


def _fma(a, b, c):
    """``a * b + c`` rounded once to f32 (the f32 product is exact in
    float64)."""
    return (a.double() * b.double() + c.double()).float()


def _dot2(a0, b0, a1, b1):
    """A two-term f32 dot product as XLA's CPU dot accumulates it:
    ``fma(a1, b1, a0 * b0)``."""
    return _fma(a1, b1, a0 * b0)


def _flow_target_f32(scans, phi, odom0, odom1):
    """The ego-motion flow target ``(N, P, 2)`` in f32, operation by
    operation as JAX's jitted ``_targets_batched`` computes it on the CPU:
    ``xy @ (I - R0^T R1)^T - R0^T (t1 - t0)`` with each 2x2 product an XLA
    dot (:func:`_dot2`), then the canonical rotation with its multiply-adds
    fused as LLVM fuses them. Where the two poses coincide the target is the
    ~1e-8 m rounding residual of ``R0^T R1``, whose direction these roundings
    decide."""
    c, s = torch.cos(phi), torch.sin(phi)
    x, y = scans * c, scans * s
    c0, s0 = torch.cos(odom0[:, 2]), torch.sin(odom0[:, 2])
    c1, s1 = torch.cos(odom1[:, 2]), torch.sin(odom1[:, 2])
    r0 = ((c0, -s0), (s0, c0))
    r1 = ((c1, -s1), (s1, c1))
    rot = [[(1.0 if i == j else 0.0)
            - _dot2(r0[0][i], r1[0][j], r0[1][i], r1[1][j])
            for j in range(2)] for i in range(2)]
    t = odom1[:, :2] - odom0[:, :2]
    fx, fy = (_dot2(x, rot[i][0][:, None], y, rot[i][1][:, None])
              - _dot2(r0[0][i], t[:, 0], r0[1][i], t[:, 1])[:, None]
              for i in range(2))
    return torch.stack((_fma(c, fx, -(s * fy)), _fma(s, fx, c * fy)), dim=-1)


@torch.inference_mode()
def _targets_batched(scans, phi, dets_rphi, cls_radius, dyn_radius, labels,
                     cls_valid, dyn_valid, odom0, odom1):
    """Every sample's targets in one pass: scans ``(N, P)``, ``phi (P,)``,
    padded detections ``(N, D, ...)``, poses ``(N, 3)``, the float ones in
    float64 (the flow from their f32 values). Returns (cls (N, P) int32, reg (N, P, 2), flow (N, P, 2), mask
    (N, P)), the float ones in float32."""
    cls, reg = tgt_ops.regression_targets(scans, phi, dets_rphi, cls_radius,
                                          labels, cls_valid)
    xy = torch.stack((scans * torch.cos(phi), scans * torch.sin(phi)),
                     dim=-1)
    flow = _flow_target_f32(scans.float(), phi.float(), odom0.float(),
                            odom1.float())
    dets_xy = torch.stack((dets_rphi[..., 0] * torch.cos(dets_rphi[..., 1]),
                           dets_rphi[..., 0] * torch.sin(dets_rphi[..., 1])),
                          dim=-1)
    dyn = tgt_ops.dynamic_mask(xy, dets_xy, dyn_radius, dyn_valid)
    mask = dyn * tgt_ops.valid_range_mask(scans)
    return cls, reg.float(), flow.float(), mask.float()


class DrowDetectionDataset:
    def __init__(self, data_dir: str, split: str = "train", num_scans: int = 5,
                 scan_stride: int = 1, flow_distance: int = 5,
                 pedestrian_only: bool = False, train_with_val: bool = False,
                 use_augmentation: bool = False, max_dets: int = 16,
                 max_sequences: int | None = None, seed: int = 0,
                 device="cuda"):
        dev = resolve_device(device)
        self.num_scans = num_scans
        self.use_augmentation = use_augmentation and split == "train"
        self._rng = np.random.default_rng(seed)

        stems = drow_io.list_sequences(data_dir, split)
        if train_with_val and split == "train":
            stems += drow_io.list_sequences(data_dir, "val")
        if max_sequences:
            stems = stems[:max_sequences]
        if not stems:
            raise FileNotFoundError(f"no sequences under {data_dir}/{split}")

        phi = None  # beam geometry from the first sequence read

        all_scans, stack_idx, cur_idx = [], [], []
        dets = []
        odom0_l, odom1_l = [], []
        offset = 0

        for stem in stems:
            scan_ids, scan_t, scans = drow_io.load_scan_file(stem)
            if phi is None:
                # the fixed 0.5 deg a beam over however many beams the
                # corpus has (a narrower corpus gets a narrower field of
                # view, not a rescaled increment)
                phi = get_laser_phi(num_pts=scans.shape[-1])
                self.phi_grid = phi.astype(np.float32)
            elif scans.shape[-1] != len(phi):
                raise ValueError(
                    f"{stem}: {scans.shape[-1]} beams but the first "
                    f"sequence in this split has {len(phi)} — mixed beam "
                    "counts in one corpus are not supported"
                )
            _, odom_t, odom = drow_io.load_odometry_file(stem)
            ann_ids, wcs, was, wps = drow_io.load_detection_file(stem)

            # drop frames where the odometry does not change
            moving = np.concatenate(
                [np.any(odom[1:] != odom[:-1], axis=1), [False]]
            )
            if not moving.any():
                continue
            kept_odom_t = odom_t[moving]
            kept_odom = odom[moving]
            # scans are filtered with the same index (scan and odometry
            # rows are aligned 1:1 in DROW sequences)
            n = min(len(moving), len(scans))
            kept_scan_mask = moving[:n]
            scans = scans[:n][kept_scan_mask]
            scan_ids_k = scan_ids[:n][kept_scan_mask]
            scan_t_k = scan_t[:n][kept_scan_mask]
            if len(scans) == 0:
                continue

            id2row = {int(s): i for i, s in enumerate(scan_ids_k)}
            for a_i, sid in enumerate(ann_ids):
                row = id2row.get(int(sid))
                if row is None:
                    continue
                # temporal stack: the oldest num_scans ending flow_distance
                # back
                offs = (
                    np.arange(num_scans + flow_distance) * scan_stride
                )[::-1][:num_scans]
                hist = np.maximum(0, row - offs)
                stack_idx.append(offset + np.concatenate([hist, [row]]))
                cur_idx.append(offset + row)

                o1 = np.argmin(np.abs(kept_odom_t - scan_t_k[row]))
                o0 = np.argmin(np.abs(kept_odom_t - scan_t_k[hist[-1]]))
                odom0_l.append(kept_odom[o0])
                odom1_l.append(kept_odom[o1])
                dets.append(_pad_frame_dets(
                    wcs[a_i], was[a_i], wps[a_i], pedestrian_only, max_dets))

            all_scans.append(scans)
            offset += len(scans)

        if not stack_idx:
            raise FileNotFoundError(f"{split}: no valid samples")

        self.scans_flat = np.concatenate(all_scans).astype(np.float32)
        self.stack_idx = np.stack(stack_idx)
        self.cur_idx = np.asarray(cur_idx)
        self.odom1 = np.stack(odom1_l).astype(np.float32)
        det_rphi, det_cls_r, det_dyn_r, det_lab, det_cval, det_dval = (
            np.stack(col) for col in zip(*dets))

        def put(a):
            # the geometry in float64: the class and mask compare distances
            # with radii, and the f32 sines, cosines and roots of the card
            # and the host differ in their last bits
            a = np.ascontiguousarray(a)
            if a.dtype == np.float32:
                a = a.astype(np.float64)
            return torch.from_numpy(a).to(dev)

        cls, reg, flow, mask = _targets_batched(
            put(self.scans_flat[self.cur_idx]), put(phi.astype(np.float32)),
            put(det_rphi), put(det_cls_r), put(det_dyn_r),
            put(det_lab), put(det_cval), put(det_dval),
            put(np.stack(odom0_l).astype(np.float32)), put(self.odom1))
        self.target_cls = cls.cpu().numpy().astype(np.int32)
        self.target_reg = reg.cpu().numpy()
        self.target_flow = flow.cpu().numpy()
        self.exclude_mask = mask.cpu().numpy()
        # padded GT detections (sensor polar) for AP evaluation: only the
        # classes the head is trained on (wp in pedestrian-only mode)
        self.dets_rphi = det_rphi
        self.dets_valid = det_cval

    def gt_centers(self, idx) -> np.ndarray:
        """GT detection centers of one sample in sensor xy, ``(N, 2)``."""
        rphi = self.dets_rphi[idx][self.dets_valid[idx]]
        return np.stack(
            (rphi[:, 0] * np.cos(rphi[:, 1]), rphi[:, 0] * np.sin(rphi[:, 1])),
            axis=-1,
        ) if len(rphi) else np.zeros((0, 2), np.float32)

    def __len__(self):
        return len(self.stack_idx)

    def _gather(self, idx):
        return {
            "scans": self.scans_flat[self.stack_idx[idx]],
            "target_cls": self.target_cls[idx],
            "target_reg": self.target_reg[idx].copy(),
            "target_flow": self.target_flow[idx].copy(),
            "exclude_mask": self.exclude_mask[idx],
            "odom1": self.odom1[idx],
        }

    def __getitem__(self, idx):
        out = self._gather(idx)
        out["phi_grid"] = self.phi_grid
        return out

    def batch(self, indices):
        idx = np.asarray(indices)
        b = {
            "scans": self.scans_flat[self.stack_idx[idx]],
            "target_cls": self.target_cls[idx],
            "target_reg": self.target_reg[idx].copy(),
            "target_flow": self.target_flow[idx].copy(),
            "exclude_mask": self.exclude_mask[idx],
        }
        if self.use_augmentation:
            flip = self._rng.random(len(idx)) < 0.5
            if flip.any():
                f = np.where(flip)[0]
                b["scans"][f] = b["scans"][f][:, :, ::-1]
                for key in ("target_cls", "exclude_mask"):
                    b[key][f] = b[key][f][:, ::-1]
                for key in ("target_reg", "target_flow"):
                    b[key][f] = b[key][f][:, ::-1]
                    b[key][f, :, 0] *= -1.0
        return b
