"""Stateful streaming inference: one step per incoming batch of scans.

Counterpart of ``planar_optical_flow_tpu/infer/streaming.py`` for two
engines:

* ``"module"`` (:func:`make_stream_step`): the f32 module path, the
  reference;
* ``"v3"`` (:func:`make_serve_step_v3`, ``precision="bf16"``): sanitize ->
  pad to ``p_pad = ceil(P/8)*8`` beams -> K1 cutout -> backbone layer 1
  (plain torch) -> K2 backbone tail + gate embed -> K3 gate -> K4 head ->
  bf16 flow head (plain torch convs) -> sigmoid, canonical->global flow and
  top-64 vote NMS. The carry is ``{"template": (B*p_pad, D) bf16, "z":
  (B*p_pad, 128) bf16}``.

Both return ``step(carry, scan) -> (carry', outputs)`` with ``carry=None``
for a stream's first scan; :class:`StreamingRunner` holds the carry and
resets streams. Inference only: every step runs under
``torch.inference_mode``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from planar_optical_flow_tpu_torch import resolve_device
from planar_optical_flow_tpu_torch.infer.fast_gate import gate
from planar_optical_flow_tpu_torch.models.flow_drow import FlowDrow
from planar_optical_flow_tpu_torch.models.spatial_drow import FEAT_CHANNELS
from planar_optical_flow_tpu_torch.ops.cutout import area_s_for, scans_to_cutout
from planar_optical_flow_tpu_torch.ops.geometry import (
    canonical_to_global_flow,
    get_laser_phi,
)
from planar_optical_flow_tpu_torch.ops.kernels import fold
from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
    backbone_layer1,
    backbone_tail,
    head,
)
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout
from planar_optical_flow_tpu_torch.ops.nms import (
    nms_predicted_center,
    nms_predicted_center_topk,
)

ENGINES = ("module", "v3")


def serve_output_fields(is_flow: bool, with_nms: bool) -> tuple:
    """The caller-facing output contract every step produces."""
    return (("pred_cls", "pred_reg")
            + (("pred_flow",) if is_flow else ())
            + (("det_xys", "det_cls", "det_keep", "instance_mask")
               if with_nms else ()))


def _check_output_fields(output_fields, is_flow, with_nms):
    if output_fields is None:
        return None
    known = serve_output_fields(is_flow, with_nms)
    bad = set(output_fields) - set(known)
    if bad:
        raise ValueError(
            f"unknown output_fields {sorted(bad)}; this step produces "
            f"{list(known)} (is_flow={is_flow}, with_nms={with_nms})")
    return tuple(output_fields)


def _sanitize_scan(scan, max_range: float):
    """Non-finite ranges -> ``max_range``; clip to ``[0, max_range]``."""
    scan = torch.where(torch.isfinite(scan), scan,
                       torch.full_like(scan, max_range))
    return torch.clamp(scan, 0.0, max_range)


def _detection_epilogue(scan, pred_cls, pred_reg, flow, phi, *, with_nms,
                        nms_min_dist, nms_top_k=None):
    """Shared tail: sigmoid -> canonical->global flow -> vote NMS."""
    probs = torch.sigmoid(pred_cls)
    out = {"pred_cls": probs, "pred_reg": pred_reg}
    if flow is not None:
        out["pred_flow"] = canonical_to_global_flow(flow, phi)
    if with_nms:
        conf = probs if probs.shape[-1] == 1 else probs[..., -1:]
        if nms_top_k:
            res = nms_predicted_center_topk(scan, phi, conf, pred_reg,
                                            min_dist=nms_min_dist,
                                            top_k=nms_top_k)
        else:
            res = nms_predicted_center(scan, phi, conf, pred_reg,
                                       min_dist=nms_min_dist)
        out.update(zip(("det_xys", "det_cls", "det_keep", "instance_mask"),
                       res))
    return out


def _tree_map(fn, a, b):
    if isinstance(a, dict):
        return {k: fn(a[k], b[k]) for k in a}
    return fn(a, b)


def merge_stream_carries(carry, boot_carry, reset_mask):
    """Per-stream carry merge: rows of streams where ``reset_mask (B,)`` is
    True come from ``boot_carry``, the others keep ``carry``. Every leaf
    leads with ``B * rows_per_stream`` stream-major rows."""
    mask = torch.as_tensor(np.asarray(reset_mask, dtype=bool))
    b = mask.shape[0]

    def merge(old, boot):
        if old.shape != boot.shape:
            raise ValueError(f"carry/boot leaf shape mismatch: "
                             f"{tuple(old.shape)} vs {tuple(boot.shape)}")
        rows = old.shape[0]
        if rows % b:
            raise ValueError(
                f"carry leaf leading dim {rows} is not a multiple of the "
                f"batch {b} — cannot attribute rows to streams")
        m = mask.to(old.device).repeat_interleave(rows // b)
        return torch.where(m.reshape((rows,) + (1,) * (old.ndim - 1)),
                           boot, old)

    return _tree_map(merge, carry, boot_carry)


def _merge_stream_outputs(out, boot_out, reset_mask):
    """Outputs counterpart of :func:`merge_stream_carries`."""
    mask = torch.as_tensor(np.asarray(reset_mask, dtype=bool))
    return {k: torch.where(mask.to(a.device).reshape(
        (mask.shape[0],) + (1,) * (a.ndim - 1)), boot_out[k], a)
        for k, a in out.items()}


def _encode_single(scan, phi, cutout_kwargs):
    """``(B, P)`` scans -> ``(B, P, C)`` module-engine cutouts."""
    kw = dict(cutout_kwargs)
    if kw.pop("area_mode", False):
        kw["area_mode"] = True
        kw.setdefault("area_s", area_s_for(kw.get("window_width", 1.66),
                                           kw.get("num_cutout_pts", 48)))
    return scans_to_cutout(scan[:, None, :], phi, **kw)[:, :, 0, :]


def _prepare(model, device, num_pts):
    dev = resolve_device(device)
    model = model.to(dev).eval()
    phi = get_laser_phi(num_pts=num_pts)
    return dev, model, phi, torch.as_tensor(phi, dtype=torch.float32,
                                            device=dev)


def make_stream_step(model, cutout_kwargs, num_pts: int = 450,
                     nms_min_dist: float = 0.5, with_nms: bool = True,
                     device="cuda"):
    """The f32 module step: ``step(template, scan) -> (new_template,
    outputs)``; ``scan (B, num_pts)``, ``template (B, P, D)`` f32 or None
    to bootstrap. Scans are sanitized (non-finite -> ``padding_val``, clip
    to ``[0, padding_val]``) as in the v3 step. Outputs: ``pred_cls``
    (sigmoided), ``pred_reg``, ``pred_flow`` (global frame; FlowDrow only)
    and, with ``with_nms``, ``det_xys, det_cls, det_keep, instance_mask``.
    """
    dev, model, phi, phi_t = _prepare(model, device, num_pts)
    is_flow = isinstance(model, FlowDrow)
    san_max = float(cutout_kwargs.get("padding_val", 29.99))

    @torch.inference_mode()
    def step(template, scan):
        scan = _sanitize_scan(
            torch.as_tensor(scan, dtype=torch.float32, device=dev), san_max)
        cutouts = _encode_single(scan, phi, cutout_kwargs)
        if is_flow:
            pred_cls, pred_reg, pred_flow, new_template = model.stream_step(
                cutouts, scan, template)
        else:
            pred_cls, pred_reg, new_template, _ = model.stream_step(
                cutouts, template)
            pred_flow = None
        return new_template, _detection_epilogue(
            scan, pred_cls, pred_reg, pred_flow, phi_t, with_nms=with_nms,
            nms_min_dist=nms_min_dist)

    return step


def make_serve_step_v3(model, cutout_kwargs, num_pts: int = 450,
                       nms_min_dist: float = 0.5, with_nms: bool = True,
                       nms_top_k: int | None = 64, precision: str = "bf16",
                       layout: str = "p2", output_fields=None,
                       sanitize_inputs: bool = True, device="cuda"):
    """The fused bf16 serving step on the K1-K4 kernels.

    ``precision="bf16"`` only, with the cutout-major kernels that the JAX
    builder runs for bf16 (its ``layout`` ``"p2"`` default and ``"flat"``).
    ``output_fields`` restricts the outputs dict to the named keys.
    Returns ``step(carry, scan) -> (carry', outputs)``.
    """
    if precision != "bf16":
        raise NotImplementedError(
            f"precision={precision!r}: the int8 serving engines are ROADMAP "
            "queue 1 item 8 (int8c, kernels K5-K7); this port runs bf16")
    if layout not in ("p2", "flat"):
        raise NotImplementedError(
            f"layout={layout!r}: the position-major layouts belong to the "
            "int8c engine (ROADMAP queue 1 item 8)")
    if not cutout_kwargs.get("fixed") or cutout_kwargs.get("stride", 1) != 1:
        raise NotImplementedError(
            "the v3 engine's cutout kernel covers fixed=True, stride=1 (the "
            "serving configuration)")
    dev, model, _, phi_t = _prepare(model, device, num_pts)
    is_flow = isinstance(model, FlowDrow)
    det = model.dr_spaam if is_flow else model
    output_fields = _check_output_fields(output_fields, is_flow, with_nms)
    san_max = float(cutout_kwargs.get("padding_val", 29.99))
    ct_len = cutout_kwargs.get("num_cutout_pts", 48)
    l4 = ct_len // 4
    p_pad = -(-num_pts // 8) * 8
    cut_kw = dict(num_cutout_pts=ct_len,
                  window_width=cutout_kwargs.get("window_width", 1.66),
                  window_depth=cutout_kwargs.get("window_depth", 1.0),
                  padding_val=cutout_kwargs.get("padding_val", 29.99),
                  centered=cutout_kwargs.get("centered", True),
                  area_mode=cutout_kwargs.get("area_mode", False),
                  p_valid=num_pts)
    layer1, tail_w = fold.backbone_stack_weights(det.backbone)
    hd_conv_w, hd_head_w = fold.head_stack_weights(det.head)
    num_classes = hd_head_w[0].shape[-1]
    gp = fold.fold_gate_params(det.gate, dtype=torch.bfloat16)
    gate_kw = dict(ct=p_pad, ct_valid=num_pts, alpha=gp.alpha,
                   window_size=gp.window_size)

    def finish(scan, b, template, z, sim, cls, reg):
        pred_cls = cls.reshape(b, p_pad, -1)[:, :num_pts].float()
        pred_reg = reg.reshape(b, p_pad, 2)[:, :num_pts].float()
        flow = None
        if is_flow:
            sim_b = sim.reshape(b, p_pad, -1)[:, :num_pts].to(torch.bfloat16)
            flow = model.flow_head(sim_b, scan.to(torch.bfloat16)).float()
        out = _detection_epilogue(scan, pred_cls, pred_reg, flow, phi_t,
                                  with_nms=with_nms,
                                  nms_min_dist=nms_min_dist,
                                  nms_top_k=nms_top_k)
        if output_fields is not None:
            out = {k: out[k] for k in output_fields}
        return {"template": template, "z": z}, out

    @torch.inference_mode()
    def step(carry, scan):
        scan = torch.as_tensor(scan, dtype=torch.float32, device=dev)
        if sanitize_inputs:
            scan = _sanitize_scan(scan, san_max)
        b = scan.shape[0]
        flat = cutout(F.pad(scan, (0, p_pad - num_pts)), **cut_kw)
        act1 = backbone_layer1(flat, layer1)            # (N*L, 64) bf16
        feats, zx = backbone_tail(act1, tail_w, (gp.w, gp.b), l=ct_len)
        feats = feats.reshape(b * p_pad, l4 * FEAT_CHANNELS)
        if carry is None:
            # bootstrap: the features become the template; the gate only
            # supplies the similarity band
            template, z = feats, zx
            _, _, sim = gate(zx, zx, feats, feats, **gate_kw)
        else:
            template, z, sim = gate(zx, carry["z"], feats, carry["template"],
                                    **gate_kw)
        cls, reg = head(template.reshape(-1, FEAT_CHANNELS), hd_conv_w,
                        hd_head_w, num_classes=num_classes, l4=l4)
        return finish(scan, b, template, z, sim, cls, reg)

    return step


class StreamingRunner:
    """Holds a model and the per-stream carry.

    ``engine``: ``"module"`` (the f32 reference path) or ``"v3"`` (the
    fused bf16 serving path on the CUDA kernels; on ``device="cpu"`` it
    runs their plain versions). ``"int8c"`` is ROADMAP queue 1 item 8.
    """

    def __init__(self, model, cutout_kwargs, num_pts: int = 450,
                 nms_min_dist: float = 0.5, with_nms: bool = True,
                 engine: str = "module", output_fields=None, device="cuda"):
        if engine == "int8c":
            raise NotImplementedError(
                "engine='int8c' is ROADMAP queue 1 item 8")
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}")
        self._engine = engine
        self._carry = None
        self._pending_reset = None
        is_flow = isinstance(model, FlowDrow)
        self._output_fields = _check_output_fields(output_fields, is_flow,
                                                   with_nms)
        if engine == "module":
            self._step = make_stream_step(model, cutout_kwargs, num_pts,
                                          nms_min_dist, with_nms,
                                          device=device)
        else:
            self._step = make_serve_step_v3(
                model, cutout_kwargs, num_pts=num_pts,
                nms_min_dist=nms_min_dist, with_nms=with_nms,
                output_fields=self._output_fields, device=device)

    def reset(self, streams=None):
        """``streams=None`` restarts every stream (the next call
        bootstraps); ``streams=[i, ...]`` restarts only those batch rows on
        the next call, which then runs both the bootstrap and the carried
        step and takes the named rows (carry and outputs) from the
        bootstrap. An empty list is a no-op."""
        if streams is None:
            self._carry = None
            self._pending_reset = None
            return
        idx = np.atleast_1d(np.asarray(streams, dtype=np.int64))
        if idx.size == 0:
            return
        if idx.min() < 0:
            raise ValueError(
                f"reset stream indices must be >= 0, got {idx.tolist()}")
        prev = self._pending_reset
        self._pending_reset = idx if prev is None else np.union1d(prev, idx)

    def _dispatch(self, carry, scan):
        carry, out = self._step(carry, scan)
        if self._engine == "module" and self._output_fields is not None:
            out = {k: out[k] for k in self._output_fields}
        return carry, out

    def __call__(self, scan) -> dict:
        """Process one ``(B, P)`` scan batch; returns a dict of tensors."""
        pending = self._pending_reset
        if pending is not None and self._carry is not None:
            b = scan.shape[0]
            if pending.max() >= b:
                self._pending_reset = pending[pending < b]
                raise ValueError(
                    f"reset stream indices {pending.tolist()} out of range "
                    f"for batch {b} (invalid indices discarded; in-range "
                    f"ones stay pending)")
            mask = np.zeros(b, dtype=bool)
            mask[pending] = True
            boot_carry, boot_out = self._dispatch(None, scan)
            carry, out = self._dispatch(self._carry, scan)
            self._carry = merge_stream_carries(carry, boot_carry, mask)
            self._pending_reset = None
            return _merge_stream_outputs(out, boot_out, mask)
        self._pending_reset = None
        self._carry, out = self._dispatch(self._carry, scan)
        return out
