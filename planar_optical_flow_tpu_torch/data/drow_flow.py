"""Scan-pair dataset of the planar-flow U-Net.

Counterpart of ``planar_optical_flow_tpu/data/drow_flow.py``, numpy on the
host as there, and equal to it to the bit. Flags:

* the base set: every scan paired with its successor (the last with
  itself), the successor warped into the current scan's frame by the
  odometry (the frame-to-frame heading delta and the translation through
  the absolute heading);
* ``drop_static``: frames whose flow targets are all (near) zero removed;
* ``mask_dynamic``: points near annotated people (radii 0.6/0.5/0.45 m for
  wheelchairs, walking aids, pedestrians) zeroed in both scans and the
  target, and marked 0 in ``exclude_mask``;
* ``train_with_val`` adds the ``val`` sequences to ``train``;
  ``max_sequences`` keeps the first sequences.

The beam geometry comes from the first sequence (0.5 deg a beam over
however many beams it has); a split of mixed beam counts raises. The
sequences need their ``.difodom`` and ``.flow`` files
(``data/prepare.py``). Everything is computed for the whole split at
construction; ``__getitem__`` and ``batch`` slice.
"""

from __future__ import annotations

import numpy as np

from planar_optical_flow_tpu_torch.data import drow_io
from planar_optical_flow_tpu_torch.ops.geometry import get_laser_phi

_MASK_RADII = {"wc": 0.6, "wa": 0.5, "wp": 0.45}


class FlowScanPairDataset:
    """``scan_pair (2, P, 2)`` xy of a scan and its warped successor,
    ``flow_target (P, 2)``, ``exclude_mask (P,)``, ``odom (4,)`` (dpose and
    heading) and the split's ``phi_grid``."""

    def __init__(self, data_dir: str, split: str = "train",
                 train_with_val: bool = False, drop_static: bool = True,
                 mask_dynamic: bool = False, max_sequences: int | None = None):
        stems = drow_io.list_sequences(data_dir, split)
        if train_with_val and split == "train":
            stems += drow_io.list_sequences(data_dir, "val")
        if max_sequences:
            stems = stems[:max_sequences]
        if not stems:
            raise FileNotFoundError(f"no sequences under {data_dir}/{split}")

        scans_list, next_list, flow_list, odom_list, mask_list = [], [], [], [], []
        phi = None  # beam geometry inferred from the first sequence read

        for stem in stems:
            _, scan_t, scans = drow_io.load_scan_file(stem)
            if phi is None:
                # fixed SICK 0.5 deg/beam increment over however many
                # beams the corpus has (450 -> 225 deg FOV for DROWv2;
                # synthetic/test corpora with fewer beams get a
                # proportionally narrower FOV, NOT a rescaled increment)
                phi = get_laser_phi(num_pts=scans.shape[-1])
                self.phi_grid = phi.astype(np.float32)
            elif scans.shape[-1] != len(phi):
                raise ValueError(
                    f"{stem}: {scans.shape[-1]} beams but the first "
                    f"sequence in this split has {len(phi)} — mixed beam "
                    "counts in one corpus are not supported"
                )
            dts, dposes = drow_io.load_diff_odometry_file(stem)
            flows = drow_io.load_flow_file(stem, scans.shape[-1])
            _, odom_t, odom_abs = drow_io.load_odometry_file(stem)

            scans_next = np.vstack([scans[1:], scans[-1:]])
            idx = np.argmin(np.abs(scan_t[:, None] - odom_t[None, :]), axis=1)
            dpose = dposes[idx]
            heading = odom_abs[idx, 2]

            keep = np.ones(len(scans), dtype=bool)
            if drop_static:
                keep = np.abs(flows).max(axis=(1, 2)) > 1e-9
            if not keep.any():
                continue

            scans_k = scans[keep]
            next_k = scans_next[keep]
            flow_k = flows[keep]
            dpose_k = dpose[keep]
            heading_k = heading[keep]

            xy = np.stack(
                (scans_k * np.cos(phi), scans_k * np.sin(phi)), axis=-1
            ).astype(np.float32)
            xy_next = np.stack(
                (next_k * np.cos(phi), next_k * np.sin(phi)), axis=-1
            ).astype(np.float32)

            # rotate scan_next by the frame-to-frame heading delta and shift
            # by the translation expressed via the absolute heading
            # (reference dataset.py:76-93)
            ca, sa = np.cos(dpose_k[:, 2]), np.sin(dpose_k[:, 2])
            rot = np.stack(
                [np.stack([ca, sa], -1), np.stack([-sa, ca], -1)], axis=-2
            )  # (T, 2, 2)
            ch, sh = np.cos(heading_k), np.sin(heading_k)
            rot_h = np.stack(
                [np.stack([ch, -sh], -1), np.stack([sh, ch], -1)], axis=-2
            )
            trans = np.einsum("tj,tij->ti", dpose_k[:, :2], rot_h)
            xy_next = np.einsum("tpj,tij->tpi", xy_next, rot) + trans[:, None, :]

            mask = np.ones(scans_k.shape, dtype=np.float32)
            if mask_dynamic:
                ids, wcs, was, wps = drow_io.load_detection_file(stem)
                scan_ids = drow_io.load_scan_file(stem)[0]
                id2dets = {
                    int(i): (c, a, p) for i, c, a, p in zip(ids, wcs, was, wps)
                }
                kept_ids = scan_ids[keep]
                for row, sid in enumerate(kept_ids):
                    dets = id2dets.get(int(sid))
                    if dets is None:
                        continue
                    for group, radius in zip(dets, _MASK_RADII.values()):
                        for r, a in group:
                            dx = xy[row, :, 0] - r * np.cos(a)
                            dy = xy[row, :, 1] - r * np.sin(a)
                            mask[row][np.hypot(dx, dy) <= radius] = 0.0
                xy = xy * mask[..., None]
                xy_next = xy_next * mask[..., None]
                flow_k = flow_k * mask[..., None]

            scans_list.append(xy)
            next_list.append(xy_next.astype(np.float32))
            flow_list.append(flow_k.astype(np.float32))
            odom_list.append(
                np.column_stack([dpose_k, heading_k]).astype(np.float32)
            )
            mask_list.append(mask)

        if not scans_list:
            raise FileNotFoundError(f"{split}: no non-static data")

        self.scan_xy = np.concatenate(scans_list)
        self.scan_xy_next = np.concatenate(next_list)
        self.flow_target = np.concatenate(flow_list)
        self.odom = np.concatenate(odom_list)  # (T, 4): dpose + heading
        self.exclude_mask = np.concatenate(mask_list)

    def __len__(self):
        return len(self.scan_xy)

    def __getitem__(self, idx):
        return {
            "scan_pair": np.stack(
                (self.scan_xy[idx], self.scan_xy_next[idx])
            ),
            "flow_target": self.flow_target[idx],
            "exclude_mask": self.exclude_mask[idx],
            "odom": self.odom[idx],
            "phi_grid": self.phi_grid,
        }

    def batch(self, indices):
        """Fixed-shape batch dict for a list/array of indices."""
        idx = np.asarray(indices)
        return {
            "scan_pair": np.stack(
                (self.scan_xy[idx], self.scan_xy_next[idx]), axis=1
            ),
            "flow_target": self.flow_target[idx],
            "exclude_mask": self.exclude_mask[idx],
        }
