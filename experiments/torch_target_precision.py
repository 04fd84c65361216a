"""The DROW dataset's classes and exclude masks computed in float32 on the
card and on the host, against the float64 pass the dataset runs.

Writes the synthetic split of ``chip_smoke.py``'s ``[files]`` phase (the
``val`` split of 4 sequences x 200 frames of 450 beams from ``--seed``) and
builds ``DrowDetectionDataset`` on it with the flagship settings (10 history
scans, pedestrian only), capturing the inputs of its one batched target
pass (``drow_detection._targets_batched``). The pass is then run again on
those inputs in float32 on the host and, where there is one, on the card,
and every run's classes and masks are held against the float64 ones. For
each point that differs, it prints the float64 distance that decides it:
for the exclude mask, the point's distance to the nearest edge of a
dynamic radius (|d - r| over the annotations); for the class, the same
over the class radii, and the gap between the point's two nearest
annotations (a tie decides the class too).

Run from the repo root: ``python3 experiments/torch_target_precision.py
[--seed 0] [--cpu]`` (``--cpu``: the host only). The last line is a JSON
object with the counts and distances.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from planar_optical_flow_tpu_torch.data import (  # noqa: E402
    drow_detection,
    write_synthetic_drow_split,
)

NUM_PTS = 450
SEQS, FRAMES = 4, 200
DS_KW = dict(num_scans=10, pedestrian_only=True)


def capture_inputs(root):
    """The float64 inputs and outputs of the dataset's target pass on the
    host."""
    seen = {}
    orig = drow_detection._targets_batched

    def spy(*args):
        out = orig(*args)
        seen["args"], seen["out"] = args, out
        return out

    drow_detection._targets_batched = spy
    try:
        drow_detection.DrowDetectionDataset(root, "val", device="cpu",
                                            **DS_KW)
    finally:
        drow_detection._targets_batched = orig
    return seen["args"], seen["out"]


def edge_distances(args):
    """Per point, in float64: the distance to the nearest edge of a valid
    dynamic radius, to the nearest edge of a valid class radius, and the
    gap between its two nearest class annotations (radius subtracted)."""
    (scans, phi, dets_rphi, cls_r, dyn_r, _labels, cls_valid,
     dyn_valid, _o0, _o1) = args
    px, py = scans * torch.cos(phi), scans * torch.sin(phi)
    dx = dets_rphi[..., 0] * torch.cos(dets_rphi[..., 1])
    dy = dets_rphi[..., 0] * torch.sin(dets_rphi[..., 1])
    d = torch.hypot(px[..., :, None] - dx[..., None, :],
                    py[..., :, None] - dy[..., None, :])
    inf = torch.full_like(d, float("inf"))
    dyn = torch.where(dyn_valid[..., None, :],
                      (d - dyn_r[..., None, :]).abs(), inf).amin(-1)
    rel = torch.where(cls_valid[..., None, :], d - cls_r[..., None, :], inf)
    cls = rel.abs().amin(-1)
    two = torch.topk(rel, 2, dim=-1, largest=False).values
    tie = (two[..., 1] - two[..., 0]).abs()
    return dyn, cls, tie


def flips(name, out, ref, dist):
    """Points where ``out``'s classes or masks differ from ``ref``'s, with
    their distances."""
    dyn, cls_edge, tie = dist
    rows = []
    for what, k in (("class", 0), ("exclude_mask", 3)):
        diff = (out[k].cpu() != ref[k]).nonzero().tolist()
        for n, p in diff:
            rows.append({
                "run": name, "target": what, "sample": n, "beam": p,
                "f32": float(out[k][n, p]), "f64": float(ref[k][n, p]),
                "dyn_edge_m": float(dyn[n, p]),
                "cls_edge_m": float(cls_edge[n, p]),
                "cls_tie_m": float(tie[n, p])})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="the host only (no card)")
    args = ap.parse_args(argv)
    root = os.path.join("build", "target_precision")
    shutil.rmtree(root, ignore_errors=True)
    write_synthetic_drow_split(root, "val", num_sequences=SEQS,
                               num_frames=FRAMES, seed=args.seed,
                               num_pts=NUM_PTS)
    inputs, ref = capture_inputs(root)
    dist = edge_distances(inputs)
    devices = ["cpu"] if args.cpu else ["cpu", "cuda"]
    if not args.cpu:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        print(f"card: {card}")
    rows, summary = [], {"points": int(ref[0].numel()), "runs": {}}
    for dev in devices:
        f32 = [a.to(dev).float() if a.is_floating_point() else a.to(dev)
               for a in inputs]
        out = drow_detection._targets_batched(*f32)
        found = flips(f"f32 {dev}", out, ref, dist)
        rows += found
        summary["runs"][f"f32 {dev}"] = {
            "class_flips": sum(r["target"] == "class" for r in found),
            "mask_flips": sum(r["target"] == "exclude_mask" for r in found),
            "max_abs_reg": float((out[1].cpu() - ref[1]).abs().max()),
            "max_abs_flow": float((out[2].cpu() - ref[2]).abs().max())}
    for r in rows:
        print(json.dumps(r))
    dyn, cls_edge, _ = dist
    mask_pts = ref[3] > 0
    summary["nearest_dyn_edge_m"] = float(dyn.min())
    summary["nearest_cls_edge_m"] = float(cls_edge.min())
    summary["masked_in_points"] = int(mask_pts.sum())
    summary["flips"] = rows
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
