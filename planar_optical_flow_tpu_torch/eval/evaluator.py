"""Evaluation of the serving engines (detection AP and flow EPE/AAE) and of
the module path.

Counterpart of ``planar_optical_flow_tpu/eval/evaluator.py``:
:func:`evaluate_flow` and :func:`evaluate_box_regression` (a training
task's metrics over a loader, the module path),
:func:`evaluate_detection_ap_batched` (``batch_streams`` frames a
step through a serving step, the greedy matcher on the step's device),
:func:`evaluate_detection_ap` (a ``StreamingRunner`` loop, batch 1) and
:func:`evaluate_flow_serving` (flow through a serving engine). The module
model holds its weights, so no ``variables`` argument; ``device`` (default
``"cuda"``, raising without a card) replaces JAX's ``interpret``:
``device="cpu"`` runs the kernels' plain versions.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from planar_optical_flow_tpu_torch import resolve_device
from planar_optical_flow_tpu_torch.eval import detection_ap
from planar_optical_flow_tpu_torch.infer.streaming import (
    StreamingRunner,
    make_serve_step,
    make_serve_step_v3,
)
from planar_optical_flow_tpu_torch.ops.geometry import (
    canonical_to_global_flow,
    get_laser_phi,
)

DET_FIELDS = ("det_xys", "det_cls", "det_keep")


@torch.no_grad()
def evaluate_flow(task, state, loader, collect_outputs: bool = False):
    """Each of ``task.metrics``' values averaged over the loader's batches
    (``FlowUNetTask``: EPE and AAE; ``FlowDrowTask``/``FlowDrowFusedTask``
    the same through the DROW model), on the device of the state's model.
    With ``collect_outputs``, also the outputs of every batch as numpy
    (each frame's ``pred_flow``): returns ``(metrics, [outputs, ...])``."""
    from planar_optical_flow_tpu_torch.train.trainer import to_device

    device = next(state.model.parameters()).device
    sums, n, outs = {}, 0, []
    for batch in loader:
        metrics, rtn = task.metrics(state.model, to_device(batch, device))
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
        if collect_outputs:
            outs.append({k: v.detach().cpu().numpy() for k, v in rtn.items()})
    result = {k: v / max(n, 1) for k, v in sums.items()}
    return (result, outs) if collect_outputs else result


def evaluate_box_regression(task, state, loader) -> dict:
    """``BoxRegressionTask.metrics``' mean IoU and z, dims and ori errors,
    each the mean of the per-batch means over the loader's batches, on the
    device of the state's model."""
    return evaluate_flow(task, state, loader)


def evaluate_flow_serving(model, cutout_kwargs, frames, engine: str = "module",
                          calib=None, calib_scans=None, num_pts: int = 450,
                          batch_streams: int = 8, device="cuda"):
    """Flow EPE/AAE through a serving engine (module / v3 / int8c).

    Each frame's scan stack is stepped through a ``StreamingRunner``
    (bootstrap on scan 0, the template carried into the rest) and the last
    step's global-frame ``pred_flow`` is held against the dataset's
    canonical targets rotated into the same frame. ``frames``: a dataset
    with ``len()`` and ``.batch(indices)`` giving ``scans (B, S, P)``,
    ``target_flow (B, P, 2)`` and ``exclude_mask (B, P)`` (e.g.
    ``DrowDetectionDataset``). The frame count is trimmed to a multiple of
    ``batch_streams`` (``frames_dropped`` says by how many). Flip
    augmentation is suspended for the call. int8c without ``calib`` or
    ``calib_scans`` calibrates on the last scans of the first batch.
    """
    dev = resolve_device(device)
    n_eval = (len(frames) // batch_streams) * batch_streams
    if n_eval == 0:
        raise ValueError(
            f"{len(frames)} frames < batch_streams={batch_streams}")
    was_aug = getattr(frames, "use_augmentation", False)
    frames.use_augmentation = False
    try:
        if calib_scans is None and engine == "int8c" and calib is None:
            calib_scans = np.asarray(
                frames.batch(np.arange(batch_streams))["scans"][:, -1])
        # the NMS outputs are never read here: pred_flow comes from the
        # epilogue, so the runner skips the vote NMS
        runner = StreamingRunner(model, cutout_kwargs, num_pts=num_pts,
                                 with_nms=False, engine=engine, calib=calib,
                                 calib_scans=calib_scans, device=dev)
        phi = torch.as_tensor(get_laser_phi(num_pts=num_pts),
                              dtype=torch.float32)
        epe_sum, ang_sum, n_pts = 0.0, 0.0, 0
        for i in range(0, n_eval, batch_streams):
            batch = frames.batch(np.arange(i, i + batch_streams))
            runner.reset()
            scans = torch.as_tensor(np.asarray(batch["scans"], np.float32),
                                    device=dev)
            for t in range(scans.shape[1]):
                out = runner(scans[:, t])
            if "pred_flow" not in out:
                raise ValueError(
                    "serving engine emits no pred_flow — flow EPE needs a "
                    "flow-headed model (flow_drow)")
            pred = out["pred_flow"].float().cpu().numpy()
            target = canonical_to_global_flow(
                torch.as_tensor(batch["target_flow"]), phi).numpy()
            mask = np.asarray(batch["exclude_mask"]).astype(bool)
            err = np.linalg.norm(pred - target, axis=-1)
            # wrapped angular error (degrees) with the branch-cut fix
            dang = (np.arctan2(pred[..., 0], pred[..., 1])
                    - np.arctan2(target[..., 0], target[..., 1]))
            dang = np.abs((dang + np.pi) % (2 * np.pi) - np.pi)
            epe_sum += float(err[mask].sum())
            ang_sum += float(np.degrees(dang[mask]).sum())
            n_pts += int(mask.sum())
    finally:
        frames.use_augmentation = was_aug
    return {"epe": epe_sum / max(n_pts, 1),
            "aae": ang_sum / max(n_pts, 1),
            "num_frames": n_eval,
            # trimming to whole stream batches is visible, not silent
            "frames_dropped": len(frames) - n_eval,
            "engine": engine}


class DetectionEvalFrames:
    """The input of detection-AP evaluation: an ordered frame sequence and
    the ground-truth person centers of each frame.

    Attributes:
      scans: ``(T, P)`` float32, consecutive frames (streaming order).
      gt: length-T list of ``(N_i, 2)`` GT centers in the sensor frame.
    """

    def __init__(self, scans: np.ndarray, gt: list):
        scans = np.asarray(scans, np.float32)
        if scans.ndim != 2 or len(gt) != len(scans):
            raise ValueError("scans must be (T, P) with len(gt) == T")
        self.scans = scans
        self.gt = list(gt)

    def __len__(self):
        return len(self.scans)

    @classmethod
    def from_dataset(cls, dataset):
        """From a ``DrowDetectionDataset``-like object (``scans_flat``,
        ``cur_idx``, ``gt_centers``)."""
        scans = dataset.scans_flat[dataset.cur_idx]
        gt = [dataset.gt_centers(i) for i in range(len(dataset))]
        return cls(scans, gt)


@torch.inference_mode()
def match_batched(xy, conf, keep, gt, gt_valid, frame_valid,
                  radius: float = 0.5, conf_thresh: float = 0.0):
    """The greedy detection-to-GT matcher of every frame at once, on the
    inputs' device: the protocol of :func:`detection_ap.match_detections`
    (confidence-ordered, each GT used once, within ``radius``) on padded
    inputs, a loop over the K detection slots.

    ``xy (F, K, 2)``, ``conf (F, K)``, ``keep (F, K)`` bool, ``gt (F, G,
    2)``, ``gt_valid (F, G)``, ``frame_valid (F,)``. Returns (tp (F, K),
    the confidences in matching order with -1 on invalid slots, valid (F,
    K)), all in matching order: a stable descending sort of
    ``where(valid, conf, -1)``, which is ``argsort(-key)`` on ties.
    """
    valid = keep & (conf >= conf_thresh) & frame_valid[:, None]
    key = torch.where(valid, conf, torch.full_like(conf, -1.0))
    key_s, order = torch.sort(key, dim=1, descending=True, stable=True)
    xy_s = torch.gather(xy, 1, order[..., None].expand(-1, -1, 2))
    valid_s = torch.gather(valid, 1, order)
    f, k = valid_s.shape
    tp = torch.zeros_like(valid_s)
    used = torch.zeros(gt_valid.shape, dtype=torch.bool, device=gt.device)
    rows = torch.arange(f, device=gt.device)
    blocked = ~gt_valid
    r2 = torch.tensor(radius * radius, dtype=xy.dtype, device=xy.device)
    for i in range(k):
        diff = gt - xy_s[:, i, None, :]
        d = (diff * diff).sum(dim=-1)
        d = torch.where(used | blocked, torch.full_like(d, float("inf")), d)
        j = torch.argmin(d, dim=1)
        ok = valid_s[:, i] & (d[rows, j] <= r2)
        tp[:, i] = ok
        used[rows, j] |= ok
    conf_s = torch.where(valid_s, key_s, torch.full_like(key_s, -1.0))
    return tp, conf_s, valid_s


def match_frames(xy, conf, keep, gt, gt_valid, frame_valid,
                 radius: float = 0.5, conf_thresh: float = 0.0):
    """:func:`match_batched`'s result computed on the host, frame by frame,
    with :func:`detection_ap.match_detections`: numpy ``(tp, conf, valid)``
    of the same shapes, to hold the device matcher to. Each frame's
    detections go to ``match_detections`` in the matcher's order, ranked,
    since numpy's default sort orders tied confidences as it pleases."""
    xy, conf, keep, gt, gt_valid, frame_valid = (
        a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        for a in (xy, conf, keep, gt, gt_valid, frame_valid))
    tp = np.zeros(conf.shape, bool)
    conf_s = np.full(conf.shape, -1.0, conf.dtype)
    valid_s = np.zeros(conf.shape, bool)
    for n in np.nonzero(frame_valid)[0]:
        sel = keep[n] & (conf[n] >= conf_thresh)
        order = np.argsort(-np.where(sel, conf[n], -1.0), kind="stable")
        order = order[: sel.sum()]
        flags, _, _ = detection_ap.match_detections(
            xy[n][order], -np.arange(len(order)), gt[n][gt_valid[n]],
            radius)
        tp[n, : len(order)] = flags
        conf_s[n, : len(order)] = conf[n][order]
        valid_s[n, : len(order)] = True
    return tp, conf_s, valid_s


def make_ap_step(model, cutout_kwargs, engine: str = "v3",
                 num_pts: int = 450, compute_dtype=None,
                 gate_mix: str | None = None, calib=None, calib_scans=None,
                 device="cuda"):
    """The serving step :func:`evaluate_detection_ap_batched` builds for
    ``engine`` (see there); ``calib_scans`` calibrates int8c where
    ``calib`` is None. Build it once to reuse it across calls as
    ``step=``."""
    if engine == "v3":
        return make_serve_step_v3(model, cutout_kwargs, num_pts=num_pts,
                                  precision="bf16", output_fields=DET_FIELDS,
                                  device=device)
    if engine == "int8c":
        return make_serve_step_v3(
            model, cutout_kwargs, num_pts=num_pts, precision="int8c",
            calib=calib,
            calib_scans=None if calib is not None else calib_scans,
            output_fields=DET_FIELDS, device=device)
    if engine == "module":
        # K3 takes partial row tiles, so it runs at any beam count (the
        # JAX package's kernel needs whole 8-row blocks and takes the
        # plain mix at 450 beams)
        return make_serve_step(model, cutout_kwargs, num_pts=num_pts,
                               compute_dtype=compute_dtype,
                               gate_mix=gate_mix or "pallas", device=device)
    raise ValueError(f"unknown engine {engine!r}")


def evaluate_detection_ap_batched(model, cutout_kwargs, frames,
                                  batch_streams: int = 16,
                                  radius: float = 0.5,
                                  conf_thresh: float = 0.0,
                                  num_pts: int | None = None,
                                  compute_dtype=None,
                                  gate_mix: str | None = None,
                                  engine: str = "v3",
                                  calib=None,
                                  step=None,
                                  device="cuda"):
    """Detection PR/AP over a frame sequence, ``batch_streams`` frames a
    step.

    The sequence is split into ``batch_streams`` contiguous chunks (the
    last padded with 29.99 m scans to whole chunks); each chunk streams
    through its own template state, so each step processes
    ``batch_streams`` independent scans through the batched serving step.
    The detections stay on the device, stacked over the steps, and the
    greedy matcher (:func:`match_batched`) runs there on all frames at
    once; the host pads the GT and integrates the PR curve.

    ``engine``: ``"v3"`` (the bf16 serving step), ``"int8c"`` (the int8
    serving step; scales from ``calib``, a ``ServeCalibration``, else
    calibrated on the first 8 scans) or ``"module"`` (``make_serve_step``
    in ``compute_dtype``, f32 by default, with ``gate_mix``: ``"pallas"``,
    K3, by default at any beam count; ``"xla"``, the plain mix, only when
    asked for). ``frames``: a :class:`DetectionEvalFrames` or a dataset
    its ``from_dataset`` takes. ``step``: a serving step built before by
    :func:`make_ap_step` (reused across calls, it skips the build and, for
    int8c, the calibration).
    """
    dev = resolve_device(device)
    if not isinstance(frames, DetectionEvalFrames):
        frames = DetectionEvalFrames.from_dataset(frames)
    t_total, p = frames.scans.shape
    num_pts = num_pts or p
    if engine != "module" and (compute_dtype is not None
                               or gate_mix is not None):
        # these only change the module engine; ignoring them silently
        # would shift the reported AP without a signal
        warnings.warn(
            f"compute_dtype/gate_mix are ignored by engine={engine!r}; "
            "pass engine='module' to use them", stacklevel=2)
    b = max(1, min(batch_streams, t_total))
    t_chunk = (t_total + b - 1) // b
    pad = b * t_chunk - t_total
    scans = np.concatenate(
        [frames.scans, np.full((pad, p), 29.99, np.float32)], axis=0
    ).reshape(b, t_chunk, p)
    scans = torch.from_numpy(scans).to(dev)

    if step is None:
        step = make_ap_step(model, cutout_kwargs, engine, num_pts,
                            compute_dtype=compute_dtype, gate_mix=gate_mix,
                            calib=calib, calib_scans=frames.scans[:8],
                            device=dev)
    outs = []
    carry = None
    for t in range(t_chunk):
        carry, out = step(carry, scans[:, t])
        outs.append(tuple(out[k] for k in DET_FIELDS))

    # (t_chunk, b, K, .) flattened to frame rows n = t*b + s on the device
    # (frame index s*t_chunk + t): no copy to the host per step
    xys = torch.stack([o[0] for o in outs]).float()
    confs = torch.stack([o[1] for o in outs])[..., 0].float()
    keeps = torch.stack([o[2] for o in outs])
    kslots = xys.shape[2]
    xys = xys.reshape(-1, kslots, 2)
    confs = confs.reshape(-1, kslots)
    keeps = keeps.reshape(-1, kslots)

    tt, ss = np.meshgrid(np.arange(t_chunk), np.arange(b), indexing="ij")
    frame_idx = (ss * t_chunk + tt).reshape(-1)
    frame_valid = frame_idx < t_total

    g_max = max([1] + [len(g) for g in frames.gt])
    gt_pad = np.zeros((len(frame_idx), g_max, 2), np.float32)
    gt_valid = np.zeros((len(frame_idx), g_max), bool)
    num_gt = 0
    for n, (i, fv) in enumerate(zip(frame_idx, frame_valid)):
        if not fv:
            continue
        g = np.asarray(frames.gt[i], np.float32).reshape(-1, 2)
        gt_pad[n, : len(g)] = g
        gt_valid[n, : len(g)] = True
        num_gt += len(g)

    tp, conf_sorted, valid_sorted = match_batched(
        xys, confs, keeps, torch.from_numpy(gt_pad).to(dev),
        torch.from_numpy(gt_valid).to(dev),
        torch.from_numpy(frame_valid).to(dev), radius, conf_thresh)
    sel = valid_sorted.cpu().numpy().reshape(-1)
    flags = tp.cpu().numpy().reshape(-1)[sel]
    pool_confs = conf_sorted.cpu().numpy().reshape(-1)[sel]

    precision, recall, _ = detection_ap.precision_recall_from_pool(
        flags, pool_confs, num_gt)
    return {
        "ap": detection_ap.average_precision(precision, recall),
        "peak_f1": detection_ap.peak_f1(precision, recall),
        "eer": detection_ap.eer(precision, recall),
        "num_frames": int(frame_valid.sum()),
    }


def evaluate_detection_ap(runner, dataset, radius: float = 0.5,
                          conf_thresh: float = 0.0,
                          reset_every: int | None = None):
    """Stream a detection dataset through a ``StreamingRunner`` one frame at
    a time and score PR/AP against its annotations. ``dataset`` exposes
    ``scans_flat``, ``cur_idx`` and ``gt_centers(i) -> (N, 2)`` (sensor
    frame)."""
    frames = []
    for i in range(len(dataset)):
        if reset_every and i % reset_every == 0:
            runner.reset()
        scan = dataset.scans_flat[dataset.cur_idx[i]][None]
        out = runner(scan)
        keep = out["det_keep"][0].cpu().numpy()
        xys = out["det_xys"][0].float().cpu().numpy()[keep]
        conf = out["det_cls"][0].float().cpu().numpy()[keep, 0]
        sel = conf >= conf_thresh
        frames.append((xys[sel], conf[sel], dataset.gt_centers(i)))

    precision, recall, _ = detection_ap.precision_recall_curve(frames, radius)
    return {
        "ap": detection_ap.average_precision(precision, recall),
        "peak_f1": detection_ap.peak_f1(precision, recall),
        "eer": detection_ap.eer(precision, recall),
        "num_frames": len(frames),
    }
