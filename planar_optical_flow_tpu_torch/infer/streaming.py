"""Stateful streaming inference: one step per incoming batch of scans.

Counterpart of ``planar_optical_flow_tpu/infer/streaming.py``: every step
builder of the JAX module, and its three runner engines:

* ``"module"`` (:func:`make_stream_step`): the module path, the reference
  in f32 (``compute_dtype`` runs a cast copy of the model);
* ``"v3"`` (:func:`make_serve_step_v3`, ``precision="bf16"``): sanitize ->
  pad to ``p_pad = ceil(P/8)*8`` beams -> K1 cutout -> K2 backbone (layer 1
  included) + gate embed -> K3 gate -> K4 head ->
  bf16 flow head (plain torch convs) -> sigmoid, canonical->global flow and
  top-64 vote NMS. The carry is ``{"template": (B*p_pad, D) bf16, "z":
  (B*p_pad, 128) bf16}``.
* ``"int8c"`` (:func:`make_serve_step_v3`, ``precision="int8c"``, the JAX
  serving default): sanitize -> pad -> K1 cutout -> K5 layer 1 + int8
  backbone + gate embed -> K6 int8-carry gate -> K7 int8 head -> the same
  flow head and epilogue. The template carry is int8 at the head's input
  scale; the scales come from a ``ServeCalibration``
  (``infer/calibration.py``).

:func:`make_serve_step_v3` also runs every other configuration of the JAX
builder, which ``StreamingRunner`` does not offer (as in JAX):
``precision="int8"`` (int8 conv stacks, K10 and K7, bf16 carry through
K3); int8c ``layout="pm"`` (K9) or ``"flat"`` (layer 1 in plain torch,
K10); and the fused int8c programs: ``layout="p2c"`` (K8, cutout and
backbone in one kernel), ``fuse_gate_head=True`` (K12, gate and head in one
kernel on carried steps) and ``layout="cell"`` (K13, the whole carried
cell in one kernel).

The other builders of the JAX module, which ``StreamingRunner`` does not
offer (as in JAX):

* :func:`make_fused_stream_step`: the module cutout, K14's backbone and
  head (``ops/kernels/fused_drow.py``, f32 or bf16) around the module
  gate and flow head; it does not sanitize its scans, as in JAX;
* :func:`make_serve_step`: the module backbone and head (cast to
  ``compute_dtype``), the band gate carrying the embedding ``z``
  (``gate_mix="pallas"``: K3, bf16 or f32; ``"xla"``: plain torch);
* :func:`make_quantized_stream_step`: the int8 conv stacks of
  ``ops/quantized_drow.py`` in plain torch (XLA in JAX: no kernel),
  calibrated on two f32 module steps, gate and flow head in ``gate_dtype``;
* :func:`make_serve_sequence_processor` and :func:`make_sequence_processor`:
  a loop over time of :func:`make_serve_step_v3`'s and of the module step.

All return ``step(carry, scan) -> (carry', outputs)`` with ``carry=None``
for a stream's first scan; :class:`StreamingRunner` holds the carry and
resets streams. Inference only: every step runs under
``torch.inference_mode``.
"""

from __future__ import annotations

import contextlib
import copy
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from planar_optical_flow_tpu_torch import resolve_device
from planar_optical_flow_tpu_torch.infer.calibration import ServeCalibration
from planar_optical_flow_tpu_torch.infer.fast_gate import (
    gate,
    gate_bootstrap,
    gate_head_int8,
    gate_int8,
    gate_step,
)
from planar_optical_flow_tpu_torch.models.flow_drow import FlowDrow
from planar_optical_flow_tpu_torch.models.spatial_drow import FEAT_CHANNELS
from planar_optical_flow_tpu_torch.ops.cutout import area_s_for, scans_to_cutout
from planar_optical_flow_tpu_torch.ops.geometry import (
    canonical_to_global_flow,
    get_laser_phi,
)
from planar_optical_flow_tpu_torch.ops import quantized_drow as qd
from planar_optical_flow_tpu_torch.ops.kernels import fold, quant
from planar_optical_flow_tpu_torch.ops.kernels import fused_drow as fd
from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
    backbone_bf16,
    backbone_int8,
    backbone_int8_cut,
    backbone_int8_pm,
    backbone_int8_tail,
    backbone_layer1,
    backbone_weights_bf16,
    backbone_weights_int8,
    check_row_shift,
    head,
    head_int8,
    head_weights_bf16,
    head_weights_int8,
)
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout
from planar_optical_flow_tpu_torch.ops.kernels.serve_cell import (
    cell_embed,
    serve_cell_int8,
)
from planar_optical_flow_tpu_torch.ops.nms import (
    nms_predicted_center,
    nms_predicted_center_topk,
)
from planar_optical_flow_tpu_torch.utils import tracing

ENGINES = ("module", "v3", "int8c")


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


@torch.inference_mode()
def _scatter_streams(dst, src, idx, b: int, whole: bool):
    """Writes the rows of streams ``idx`` (a device index) from ``src``
    into ``dst`` in place and returns ``dst``. Every leaf of ``dst`` leads
    with ``b * rows`` stream-major rows (outputs: ``rows`` 1); ``src``
    holds those of the streams ``idx`` alone, or of the whole batch
    (``whole``). ``dst`` must be tensors no one else holds."""
    def scatter(d, s):
        s = s.unflatten(0, (-1, d.shape[0] // b))
        if whole:
            s = s.index_select(0, idx)
        d.unflatten(0, (b, -1)).index_copy_(0, idx, s)
        return d

    return _tree_map(scatter, dst, src)


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


def cast_model(model, dtype):
    """A copy of ``model`` with every float parameter and buffer (the
    BatchNorm statistics included) cast to ``dtype``: the counterpart of
    the JAX ``cast_variables``. The model itself is left as it is."""
    return copy.deepcopy(model).to(dtype)


def _parts(model):
    """(is FlowDrow, the detector: ``model.dr_spaam`` or the model)."""
    is_flow = isinstance(model, FlowDrow)
    return is_flow, model.dr_spaam if is_flow else model


def _module_gate(det, feats, template):
    """The model's own gate (dense, or block-banded with ``banded_chunk``):
    (new template, sim band); on a stream's first scan (``template=None``)
    the features are the template."""
    if template is None:
        return feats, det.gate(feats, feats)[1]
    return det.gate(feats, template)


def make_stream_step(model, cutout_kwargs, num_pts: int = 450,
                     nms_min_dist: float = 0.5, with_nms: bool = True,
                     compute_dtype=None, sanitize_inputs: bool = True,
                     device="cuda"):
    """The module step: ``step(template, scan) -> (new_template,
    outputs)``; ``scan (B, num_pts)``, ``template (B, P, D)`` or None to
    bootstrap. With ``sanitize_inputs`` the scans are sanitized (non-finite
    -> ``padding_val``, clip to ``[0, padding_val]``) as in the v3 step.
    ``compute_dtype`` (e.g. ``torch.bfloat16``) runs a copy of the model
    cast to it (:func:`cast_model`; the JAX caller passes
    ``cast_variables``) on cutouts and scans in that dtype; the cutout
    index math and the NMS stay f32 (on the rounded scan, as in JAX).
    Outputs: ``pred_cls`` (sigmoided), ``pred_reg``, ``pred_flow`` (global
    frame; FlowDrow only) and, with ``with_nms``, ``det_xys, det_cls,
    det_keep, instance_mask``.
    """
    dev, model, phi, phi_t = _prepare(model, device, num_pts)
    if compute_dtype is not None:
        model = cast_model(model, compute_dtype)
    is_flow = isinstance(model, FlowDrow)
    san_max = float(cutout_kwargs.get("padding_val", 29.99))

    @torch.inference_mode()
    def step(template, scan):
        scan = torch.as_tensor(scan, dtype=torch.float32, device=dev)
        if sanitize_inputs:
            scan = _sanitize_scan(scan, san_max)
        cutouts = _encode_single(scan, phi, cutout_kwargs)
        if compute_dtype is not None:
            cutouts, scan = cutouts.to(compute_dtype), scan.to(compute_dtype)
        if is_flow:
            pred_cls, pred_reg, pred_flow, new_template = model.stream_step(
                cutouts, scan, template)
        else:
            pred_cls, pred_reg, new_template, _ = model.stream_step(
                cutouts, template)
            pred_flow = None
        if compute_dtype is not None:
            pred_cls, pred_reg, scan = (pred_cls.float(), pred_reg.float(),
                                        scan.float())
            if pred_flow is not None:
                pred_flow = pred_flow.float()
        return new_template, _detection_epilogue(
            scan, pred_cls, pred_reg, pred_flow, phi_t, with_nms=with_nms,
            nms_min_dist=nms_min_dist)

    return step


def make_fused_stream_step(model, cutout_kwargs, num_pts: int = 450,
                           nms_min_dist: float = 0.5, with_nms: bool = True,
                           compute_dtype=None, tile: int = 64,
                           device="cuda"):
    """The module step with K14's fused backbone and head
    (``ops/kernels/fused_drow.py``): ``step(template, scan) ->
    (new_template, outputs)``, ``template=None`` to bootstrap.

    The module cutout, K14's backbone in ``compute_dtype`` (None: f32, the
    default; or ``torch.bfloat16``) from the BN-folded f32 weights (laid
    out once here: ``fused_drow.backbone_weights_f32`` and
    ``head_weights_f32`` in f32, ``backbone_weights_bf16`` and
    ``head_weights_bf16`` in bf16), the
    module gate (on a copy of the model cast to ``compute_dtype``,
    with the features in it), K14's head on the new template, the module
    flow head, sigmoid, canonical->global flow and the full vote NMS. The
    scans are not sanitized, as in JAX. ``tile`` is accepted for API parity
    only. The template is ``(B, num_pts, D)`` in ``compute_dtype``.
    """
    dev, model, phi, phi_t = _prepare(model, device, num_pts)
    is_flow, det = _parts(model)
    w_bb = fd.backbone_weights(det.backbone)
    w_hd = fd.head_weights(det.head)
    num_classes = w_hd[5][0].shape[-1]
    cdt = compute_dtype or torch.float32
    if cdt == torch.float32:
        w_bb, w_hd = fd.backbone_weights_f32(w_bb), fd.head_weights_f32(w_hd)
    else:
        w_bb, w_hd = fd.backbone_weights_bf16(w_bb), fd.head_weights_bf16(w_hd)
    cast = cast_model(model, compute_dtype) if compute_dtype else model
    _, cast_det = _parts(cast)

    @torch.inference_mode()
    def step(template, scan):
        scan = torch.as_tensor(scan, dtype=torch.float32, device=dev)
        b = scan.shape[0]
        cutouts = _encode_single(scan, phi, cutout_kwargs)  # (B, P, C)
        feats = fd.fused_backbone(cutouts.reshape(b * num_pts, -1), w_bb,
                                  tile=tile, compute_dtype=cdt)
        l4 = feats.shape[1]
        feats = feats.reshape(b, num_pts, l4 * FEAT_CHANNELS).to(cdt)
        new_template, sim = _module_gate(cast_det, feats, template)
        cls, reg = fd.fused_head(
            new_template.float().reshape(b * num_pts, l4, FEAT_CHANNELS),
            w_hd, num_classes=num_classes, tile=tile, compute_dtype=cdt)
        flow = (cast.flow_head(sim, scan.to(cdt)).float() if is_flow
                else None)
        return new_template, _detection_epilogue(
            scan, cls.reshape(b, num_pts, -1), reg.reshape(b, num_pts, 2),
            flow, phi_t, with_nms=with_nms, nms_min_dist=nms_min_dist)

    return step


def make_quantized_stream_step(model, cutout_kwargs, calib_scans,
                               num_pts: int = 450, nms_min_dist: float = 0.5,
                               with_nms: bool = True,
                               gate_dtype=torch.bfloat16,
                               sanitize_inputs: bool = True, device="cuda"):
    """The module step with int8 conv stacks (``ops/quantized_drow.py``,
    plain torch: XLA in JAX): ``step(template, scan) -> (new_template,
    outputs)``.

    BatchNorm folded, per-channel int8 weights, activation scales
    calibrated on ``calib_scans (B0, num_pts)`` (sanitized first when
    ``sanitize_inputs``): the backbone's on the first 4096 of their module
    cutouts, the head's on the first 4096 rows of the template after two
    f32 module steps. The int8 backbone's f32 feats go to the module
    gate and the template to the int8 head in ``gate_dtype``; the flow head
    runs in ``gate_dtype``, the NMS and the flow rotation in f32.
    """
    dev, model, phi, phi_t = _prepare(model, device, num_pts)
    is_flow, det = _parts(model)
    w_bb = fd.backbone_weights(det.backbone)
    w_hd = fd.head_weights(det.head)
    san_max = float(cutout_kwargs.get("padding_val", 29.99))
    with torch.inference_mode(), _full_f32():
        ref_step = make_stream_step(model, cutout_kwargs, num_pts,
                                    with_nms=False, device=dev)
        calib = torch.as_tensor(calib_scans, dtype=torch.float32, device=dev)
        if sanitize_inputs:
            calib = _sanitize_scan(calib, san_max)
        tmpl, _ = ref_step(None, calib)
        tmpl, _ = ref_step(tmpl, calib)
        cutouts_c = _encode_single(calib, phi, cutout_kwargs)
    q_bb = qd.build_quantized_backbone(
        w_bb, cutouts_c.reshape(-1, cutouts_c.shape[-1])[:_CALIB_ROWS],
        device=dev)
    q_hd, heads = qd.build_quantized_head_convs(
        w_hd, tmpl.reshape(-1, tmpl.shape[-1] // FEAT_CHANNELS,
                           FEAT_CHANNELS)[:_CALIB_ROWS], device=dev)
    cast = cast_model(model, gate_dtype)
    _, cast_det = _parts(cast)

    @torch.inference_mode()
    def step(template, scan):
        scan = torch.as_tensor(scan, dtype=torch.float32, device=dev)
        if sanitize_inputs:
            scan = _sanitize_scan(scan, san_max)
        b = scan.shape[0]
        cutouts = _encode_single(scan, phi, cutout_kwargs)
        feats = q_bb(q_bb.quantize_input(
            cutouts.reshape(b * num_pts, -1)[..., None]))  # (N, L4, 256) f32
        l4 = feats.shape[1]
        feats = feats.reshape(b, num_pts, l4 * FEAT_CHANNELS).to(gate_dtype)
        new_template, sim = _module_gate(cast_det, feats, template)
        cls, reg = qd.quantized_head_apply(q_hd, heads, q_hd.quantize_input(
            new_template.float().reshape(b * num_pts, l4, FEAT_CHANNELS)))
        flow = (cast.flow_head(sim, scan.to(gate_dtype)).float() if is_flow
                else None)
        return new_template, _detection_epilogue(
            scan, cls.reshape(b, num_pts, -1), reg.reshape(b, num_pts, 2),
            flow, phi_t, with_nms=with_nms, nms_min_dist=nms_min_dist)

    return step


def make_serve_step(model, cutout_kwargs, num_pts: int = 450,
                    nms_min_dist: float = 0.5, with_nms: bool = True,
                    nms_top_k: int | None = None,
                    compute_dtype=torch.bfloat16, gate_mix: str = "pallas",
                    sanitize_inputs: bool = True, device="cuda"):
    """The band-gate serving step on the module backbone and head:
    ``step(carry, scan) -> (carry', outputs)``, ``carry=None`` to bootstrap;
    the carry is ``{"template": (B, P, D), "z": (B, P, 128)}`` in
    ``compute_dtype``.

    Sanitize (``sanitize_inputs``), the module cutout, the module backbone
    and head on a copy of the model cast to ``compute_dtype`` (default
    bf16; None runs f32), and the band gate (``infer/fast_gate.py``)
    carrying the template's pre-activation embedding: ``gate_bootstrap``
    on the first scan, then ``gate_step`` with ``gate_mix="pallas"`` (K3,
    in the features' dtype) or ``"xla"`` (the same math in plain torch).
    Then the module flow head, sigmoid, canonical->global flow and the vote
    NMS (``nms_top_k``: the top-k form; None: the full one).
    """
    if gate_mix not in ("pallas", "xla"):
        raise ValueError(f"unknown gate_mix {gate_mix!r}; 'pallas' or 'xla'")
    dev, model, phi, phi_t = _prepare(model, device, num_pts)
    is_flow, det = _parts(model)
    cdt = compute_dtype or torch.float32
    gate_params = fold.fold_gate_params(det.gate, dtype=cdt)
    cast = cast_model(model, compute_dtype) if compute_dtype else model
    _, cast_det = _parts(cast)
    san_max = float(cutout_kwargs.get("padding_val", 29.99))

    @torch.inference_mode()
    def step(carry, scan):
        scan = torch.as_tensor(scan, dtype=torch.float32, device=dev)
        if sanitize_inputs:
            scan = _sanitize_scan(scan, san_max)
        cutouts = _encode_single(scan, phi, cutout_kwargs).to(cdt)
        b, p, c = cutouts.shape
        feats = cast_det.backbone(cutouts.reshape(b * p, c, 1)).reshape(
            b, p, -1)
        if carry is None:
            template, z, sim = gate_bootstrap(gate_params, feats)
        else:
            template, z, sim = gate_step(gate_params, feats,
                                         carry["template"], carry["z"],
                                         use_pallas=gate_mix == "pallas")
        cls, reg = cast_det.head(template.reshape(
            b * p, -1, FEAT_CHANNELS))
        flow = (cast.flow_head(sim, scan.to(cdt)).float() if is_flow
                else None)
        return {"template": template, "z": z}, _detection_epilogue(
            scan, cls.reshape(b, p, -1).float(),
            reg.reshape(b, p, 2).float(), flow, phi_t, with_nms=with_nms,
            nms_min_dist=nms_min_dist, nms_top_k=nms_top_k)

    return step


def make_sequence_processor(model, cutout_kwargs, num_pts: int = 450,
                            nms_min_dist: float = 0.5, with_nms: bool = True,
                            compute_dtype=None, output_fields=None,
                            device="cuda"):
    """Offline replay on the module step: ``process(scans (T, B, P),
    template=None) -> (final template, outputs stacked over T)``.
    ``output_fields`` names the outputs to stack (None: all)."""
    inner = make_stream_step(model, cutout_kwargs, num_pts, nms_min_dist,
                             with_nms, compute_dtype=compute_dtype,
                             device=device)
    return _sequence(inner, output_fields)


def make_serve_sequence_processor(model, cutout_kwargs,
                                  output_fields=("pred_cls", "pred_reg"),
                                  **serve_kwargs):
    """Offline replay on :func:`make_serve_step_v3` (``serve_kwargs`` go to
    it: precision, calib_scans, device, ...): ``process(scans (T, B, P),
    carry=None) -> (carry', outputs stacked over T)``, stacking only
    ``output_fields`` (None: all). ``process.calibration`` holds the int8
    scales in effect."""
    step = make_serve_step_v3(model, cutout_kwargs, **serve_kwargs)
    process = _sequence(step, output_fields)
    process.calibration = step.calibration
    return process


def _sequence(step, output_fields):
    """``process(scans, carry=None)``: ``step`` over the time axis of
    ``scans``, the selected outputs stacked."""
    fields = tuple(output_fields) if output_fields is not None else None

    def process(scans, carry=None):
        outs = []
        for scan in scans:
            carry, out = step(carry, scan)
            outs.append(out if fields is None else {k: out[k] for k in fields})
        return carry, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return process


def weights_checksum(detector) -> float:
    """Sum of squares of the detector's parameters (not its BatchNorm
    buffers): the JAX package's checksum of the detector's ``params``,
    which ties a ``calibration.json`` to the weights it was computed
    from."""
    with torch.no_grad():
        return float(sum(p.detach().double().square().sum().cpu()
                         for p in detector.parameters()))


@contextlib.contextmanager
def _full_f32():
    """f32 convolutions and matmuls on the card (PyTorch lets cuDNN
    convolutions run in TF32 by default), as the JAX calibration's f32
    reference steps are."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


_CALIB_ROWS = 4096  # cutouts of each calibration sample (the JAX cap)


@torch.inference_mode()
def _calibrate(model, det, cutout_kwargs, calib_scans, *, num_pts, encode,
               percentile, steps, sanitize, san_max,
               dev) -> ServeCalibration:
    """The JAX int8c calibration (``streaming.py:692-743``) on this
    package's encode path: the backbone scales from layer 1's f32 output on
    the first 4096 cutouts that ``encode`` makes of the sanitized scans
    (the step's own encode at the beam padding of the JAX layout, dead rows
    included: K1's, or the zeros of the module cutout's fallback); the head
    scales from the last two templates of ``steps`` f32 module steps,
    newest first."""
    ct_len = cutout_kwargs.get("num_cutout_pts", 48)
    l4 = ct_len // 4
    bb_blocks = fold.backbone_blocks(det.backbone)
    scans = torch.as_tensor(calib_scans, dtype=torch.float32, device=dev)
    if sanitize:
        scans = _sanitize_scan(scans, san_max)
    with _full_f32():
        cut = encode(scans)
        act1 = backbone_layer1(cut[:_CALIB_ROWS], bb_blocks[0],
                               compute_dtype=torch.float32)
        bb_in_scale, bb_act_scales = quant.stack_act_scales(
            bb_blocks[1:], act1.reshape(-1, ct_len, 64), pool_after={1, 4},
            percentile=percentile)
        ref_step = make_stream_step(model, cutout_kwargs, num_pts,
                                    with_nms=False, device=dev)
        tmpl, tmpls = None, []
        for _ in range(max(int(steps), 1)):
            tmpl, _ = ref_step(tmpl, scans)
            tmpls.append(tmpl)
    sample = np.concatenate([t.float().cpu().numpy().reshape(-1, l4, 256)
                             for t in reversed(tmpls[-2:])])
    hd_in_scale, hd_act_scales = quant.stack_act_scales(
        fold.head_conv_blocks(det.head), sample[:_CALIB_ROWS], pool_after={2},
        percentile=percentile)
    return ServeCalibration(
        bb_in_scale=float(bb_in_scale),
        bb_act_scales=[float(v) for v in bb_act_scales],
        hd_in_scale=float(hd_in_scale),
        hd_act_scales=[float(v) for v in hd_act_scales],
        num_pts=num_pts, num_cutout_pts=ct_len,
        weights_checksum=weights_checksum(det))


def _check_calibration(calib, det, num_pts, ct_len):
    """The JAX step's checks of a restored calibration: geometry, then the
    weights checksum to the JAX check's own 1e-3."""
    if calib.num_pts != num_pts or calib.num_cutout_pts != ct_len:
        raise ValueError(
            f"calibration geometry (num_pts={calib.num_pts}, "
            f"num_cutout_pts={calib.num_cutout_pts}) does not match the "
            f"serving config (num_pts={num_pts}, num_cutout_pts={ct_len}) "
            "— recalibrate for this configuration")
    if calib.weights_checksum is not None:
        wsum = weights_checksum(det)
        if not (abs(calib.weights_checksum - wsum)
                <= 1e-3 * max(abs(wsum), 1.0)):
            raise ValueError(
                "calibration was computed for different weights (checksum "
                f"{calib.weights_checksum:.6g} vs {wsum:.6g}) — the "
                "checkpoint was likely retrained; recalibrate and re-save "
                "calibration.json")


class Int8Weights(NamedTuple):
    """What the int8 kernels read, quantized at one calibration."""
    layer1: tuple      # K5 layer 1: (w (3, 64), b (64,)) f32 / in_scale
    layer1_div: tuple  # K9 and the plain layer 1: (w (3, 64), b (64,)) f32
    in_scale: float    # scale of the int8 layer-1 activation
    backbone: list     # convs 2-6: (w (Cout, 3*Cin) int8, s_eff, b_eff)
    embed: tuple       # gate embed: (W^T (128, D) bf16, b); W * feat_scale
    #                    for int8 feats
    head: list         # K7 convs, the last one dequantized
    feat_scale: float | None  # scale of the int8 feats (None: bf16 feats)
    tmpl_scale: float  # the head's input scale (the int8 template's)


def int8_weights(detector, calib: ServeCalibration, device,
                 precision: str = "int8c") -> Int8Weights:
    """Quantize ``detector``'s f32 folded weights at ``calib``'s scales, as
    the JAX int8 steps do (``streaming.py:744-769``). ``"int8c"``: the
    backbone's last layer requantizes too, so feats are int8 at
    ``feat_scale`` and the embed weight absorbs that scale. ``"int8"``: the
    last layer is dequantized (feats in f32 units, carried as bf16) and the
    embed weight is unscaled."""
    int8_feats = precision == "int8c"
    bb_blocks = fold.backbone_blocks(detector.backbone)
    bb_q, bb_in_scale, feat_scale = quant.quantize_stack_int8(
        bb_blocks[1:], None, pool_after={1, 4},
        in_scale=calib.bb_in_scale, act_scales=calib.bb_act_scales,
        dequant_last=not int8_feats)
    hd_q, tmpl_scale, _ = quant.quantize_stack_int8(
        fold.head_conv_blocks(detector.head), None, pool_after={2},
        in_scale=calib.hd_in_scale, act_scales=calib.hd_act_scales)
    gp = fold.fold_gate_params(detector.gate, dtype=torch.bfloat16)
    we = gp.w.to(device)
    if int8_feats:
        # bf16 W times the scale rounded to bf16, rounded to bf16 (the JAX
        # weakly typed product embed_w * feat_scale)
        we = we * torch.tensor(float(feat_scale), dtype=torch.bfloat16,
                               device=device)
    w1, b1 = bb_blocks[0]
    return Int8Weights(
        layer1=quant.layer1_int8_weights(bb_blocks[0], bb_in_scale, device),
        layer1_div=(w1.reshape(3, -1).contiguous().to(device),
                    b1.contiguous().to(device)),
        in_scale=float(bb_in_scale),
        backbone=quant.kernel_stack_weights(bb_q, device),
        embed=(we.t().contiguous(), gp.b.to(device)),
        head=quant.kernel_stack_weights(hd_q, device),
        feat_scale=None if feat_scale is None else float(feat_scale),
        tmpl_scale=float(tmpl_scale))


def _check_v3_options(precision, layout, fuse_gate_head, gate_per_stream,
                      pm_tile, conv_mode, int8_conv_mode, p2_l1_mode) -> bool:
    """The JAX builder's checks (``streaming.py:567-605``). Returns
    whether the layout is one of JAX's position-major family (its
    calibration pads to a ``pm_tile`` multiple, ``"cell"`` to a multiple
    of 32)."""
    if precision not in ("bf16", "int8", "int8c"):
        raise ValueError(f"unknown precision {precision!r}")
    if layout not in ("flat", "pm", "cell", "p2", "p2c"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout not in ("flat", "p2") and precision != "int8c":
        raise ValueError(
            f"layout={layout!r} requires precision='int8c' (got "
            f"{precision!r}); bf16/int8 use the cutout-major kernels (pass "
            "layout='flat' or the default, or switch precision)")
    pm = precision == "int8c" and layout != "flat"
    if fuse_gate_head and not (pm and gate_per_stream and layout != "cell"):
        raise ValueError(
            "fuse_gate_head=True requires precision='int8c', a pm-family "
            f"layout (not 'cell') and gate_per_stream=True (got "
            f"precision={precision!r}, layout={layout!r}, "
            f"gate_per_stream={gate_per_stream})")
    if pm and layout != "cell" and pm_tile % 32:
        raise ValueError("pm_tile must be a multiple of 32")
    for name, value, known in (("conv_mode", conv_mode, ("3mm", "concat")),
                               ("int8_conv_mode", int8_conv_mode,
                                ("3mm", "cat")),
                               ("p2_l1_mode", p2_l1_mode,
                                ("mm", "repack", "blend"))):
        if value not in known:
            raise ValueError(f"unknown {name} {value!r}; one of {known}")
    return pm


def make_serve_step_v3(model, cutout_kwargs, calib_scans=None,
                       num_pts: int = 450, nms_min_dist: float = 0.5,
                       with_nms: bool = True, nms_top_k: int | None = 64,
                       precision: str = "bf16", conv_mode: str = "3mm",
                       int8_conv_mode: str = "cat", layout: str = "p2",
                       pm_tile: int = 160, tile: int = 64, calib=None,
                       gate_per_stream: bool = True, p2_l1_mode: str = "mm",
                       fuse_gate_head: bool = False,
                       calib_percentile: float | None = None,
                       calib_steps: int = 2, output_fields=None,
                       sanitize_inputs: bool = True, device="cuda",
                       mesh=None):
    """The fused serving step on the CUDA kernels.

    * ``precision="bf16"``: K1 cutout, K2 backbone (layer 1 included) +
      gate embed, K3 gate, K4 head; the carry is
      ``{"template": (N, D) bf16, "z": (N, 128) bf16}``.
    * ``precision="int8"`` (the int8 conv stacks with a bf16 carry; layout
      ``"flat"`` or the default, both cutout-major as in JAX): K1, layer 1
      in plain torch to int8 at the backbone's input scale, K10 int8
      backbone with bf16 feats (the last layer dequantized) and the
      unscaled embed, K3 gate on the bf16 template, the template quantized
      to int8 at the head's input scale, K7 int8 head.
    * ``precision="int8c"`` (int8 feats and an int8 template carry at the
      head's input scale), by ``layout``:

      - ``"p2"`` (the JAX serving default): K1, K5 (layer 1 with
        ``1/in_scale`` folded into its weights) + int8 backbone + embed, K6
        int8-carry gate, K7 int8 head. With ``p2_l1_mode="repack"`` or
        ``"blend"`` the backbone is K9 instead, as for ``"pm"`` (JAX makes
        those modes bit-identical to pm).
      - ``"pm"``: K1, K9 (layer 1 rounded as ``rint(leaky(acc) /
        in_scale)``, then K5's tail and embed), K6, K7. Streams are padded
        to a multiple of ``pm_tile`` beams, as JAX pads them.
      - ``"flat"``: K1, that layer 1 in plain torch to int8, K10 int8
        backbone + embed, K6 (K11: the JAX cutout-major gate computes K6's
        function), K7 (K10's head). Its results equal ``"pm"``'s on the
        valid rows.
      - ``"p2c"``: K8 (K1's cutouts and K5 in one kernel, on the padded
        scans) on every step, then K6 and K7: bit-identical to ``"p2"``.
      - ``"cell"``: streams padded to ``ceil(num_pts / 32) * 32`` beams; the
        bootstrap runs ``"pm"``'s kernels (K1, K9, K6, K7), each carried
        step K1 and then K13 (K9's backbone, K6 and K7 in one kernel).
        Its valid rows equal ``"pm"``'s bit for bit.

      With ``fuse_gate_head=True`` (``"p2"``, ``"pm"``, ``"p2c"``) the
      carried steps run K12 (K6 and K7 in one kernel) in place of K6 and
      K7, with the same results; the bootstrap keeps K6 and K7, as its
      template is the rescaled features, not the gate's mix.

    The int8 scales come from ``calib`` (a ``ServeCalibration``, checked
    against the geometry and the weights checksum) or are calibrated here
    on ``calib_scans`` ``(B0, num_pts)`` (sanitized first when
    ``sanitize_inputs``; ``calib_steps`` f32 module steps feed the head;
    ``calib_percentile`` clips at that abs-percentile), on the cutouts of
    the scans padded as the JAX step pads them: ``ceil(num_pts / pm_tile)
    * pm_tile`` beams for int8c ``"p2"``/``"p2c"``/``"pm"``, ``ceil(num_pts
    / 32) * 32`` for ``"cell"``, ``ceil(num_pts / 8) * 8`` for ``"flat"``
    and ``"int8"``. Every int8 configuration first runs the known-answer
    check of the tap rows that all int8 convs read (K16), once per device
    and process. The steps themselves pad to a multiple of 8 beams, except
    ``"pm"`` and ``"cell"``.

    K1 (and K8) cover the serving cutout, ``fixed=True``. At any other
    ``cutout_kwargs`` (``fixed`` False or absent) every step and the
    calibration take JAX's fallback: the module cutout (``ops/cutout.py``,
    ``area_s`` defaulted as the module step defaults it), its dead rows
    zeros up to the padding, then the same kernels from the backbone on;
    ``"p2c"`` then runs ``"p2"``'s K5. A ``stride`` other than 1 raises
    ``ValueError``: the step takes one cutout per beam, and JAX's builder
    fails there at its first encode.

    ``conv_mode``, ``int8_conv_mode`` and ``tile`` are accepted for API
    parity with the JAX builder only: they choose between JAX kernel forms
    with the same results, and the CUDA kernels compute those results
    whichever is passed (unknown modes raise). ``gate_per_stream`` likewise
    changes nothing here beyond the JAX builder's checks.

    Every configuration then runs the bf16 flow head (plain torch),
    sigmoid, canonical->global flow and the top-64 vote NMS.
    ``output_fields`` restricts the outputs dict to the named keys. Returns
    ``step(carry, scan) -> (carry', outputs)``; ``step.calibration`` holds
    the int8 scales in effect (None for bf16), ``step.raw_step`` the same
    step outside ``torch.inference_mode`` (what ``infer.export.
    export_serving_engine`` traces).

    ``mesh`` (``parallel.Mesh``) shards the streams over its ``data`` axis
    (:func:`_sharded_serve_step`): the step then takes no ``device``.
    """
    if mesh is not None:
        kwargs = dict(locals())
        for k in ("mesh", "model", "cutout_kwargs", "device"):
            kwargs.pop(k)
        return _sharded_serve_step(mesh, model, cutout_kwargs, **kwargs)
    pm = _check_v3_options(precision, layout, fuse_gate_head, gate_per_stream,
                           pm_tile, conv_mode, int8_conv_mode, p2_l1_mode)
    if cutout_kwargs.get("stride", 1) != 1:
        # JAX's builder pads and reshapes one cutout a beam: at a stride its
        # first encode fails (a reshape of ceil(P / stride) rows)
        raise ValueError(
            f"stride={cutout_kwargs['stride']}: the v3 step takes one cutout "
            "per beam (stride 1)")
    # K1 covers the serving cutout (fixed geometry, stride 1); any other
    # falls back to the module cutout, as JAX's builder falls back to XLA's
    kernel_cutout = bool(cutout_kwargs.get("fixed"))
    del tile  # the CUDA kernels choose their own blocks
    dev, model, phi, phi_t = _prepare(model, device, num_pts)
    is_flow, det = _parts(model)
    output_fields = _check_output_fields(output_fields, is_flow, with_nms)
    san_max = float(cutout_kwargs.get("padding_val", 29.99))
    ct_len = cutout_kwargs.get("num_cutout_pts", 48)
    l4 = ct_len // 4
    int8c = precision == "int8c"
    # "p2c" off the kernel's cutout is the module cutout + p2's K5 (JAX's
    # fallback to its separate cutout + p2 backbone)
    p2c = int8c and layout == "p2c" and kernel_cutout
    cell = int8c and layout == "cell"
    pad8 = -(-num_pts // 8) * 8
    pad_pm = -(-num_pts // pm_tile) * pm_tile
    pad_cell = -(-num_pts // 32) * 32
    p_pad = (pad_cell if cell else pad_pm if int8c and layout == "pm"
             else pad8)
    cut_kw = dict(num_cutout_pts=ct_len,
                  window_width=cutout_kwargs.get("window_width", 1.66),
                  window_depth=cutout_kwargs.get("window_depth", 1.0),
                  padding_val=cutout_kwargs.get("padding_val", 29.99),
                  centered=cutout_kwargs.get("centered", True),
                  area_mode=cutout_kwargs.get("area_mode", False),
                  p_valid=num_pts)
    hd_head_w = fold.head_linear_weights(det.head)
    num_classes = hd_head_w[0].shape[-1]
    gp = fold.fold_gate_params(det.gate, dtype=torch.bfloat16)
    gate_kw = dict(ct=p_pad, ct_valid=num_pts, alpha=gp.alpha,
                   window_size=gp.window_size)

    def finish(scan, b, template, z, sim, cls, reg):
        pred_cls = cls.reshape(b, p_pad, -1)[:, :num_pts].float()
        pred_reg = reg.reshape(b, p_pad, 2)[:, :num_pts].float()
        flow = None
        if is_flow:
            with tracing.span("step.flow_head", device=True):
                sim_b = sim.reshape(b, p_pad, -1)[:, :num_pts].to(
                    torch.bfloat16)
                flow = model.flow_head(sim_b, scan.to(torch.bfloat16)).float()
        with tracing.span("step.epilogue", device=True):
            out = _detection_epilogue(scan, pred_cls, pred_reg, flow, phi_t,
                                      with_nms=with_nms,
                                      nms_min_dist=nms_min_dist,
                                      nms_top_k=nms_top_k)
        if output_fields is not None:
            out = {k: out[k] for k in output_fields}
        return {"template": template, "z": z}, out

    def prepare(scan):
        """-> the sanitized scan (B, num_pts)."""
        with tracing.span("step.prepare"):
            scan = torch.as_tensor(scan, dtype=torch.float32, device=dev)
            if sanitize_inputs:
                scan = _sanitize_scan(scan, san_max)
        return scan

    def cutouts(scan, pad=p_pad):
        """Sanitized ``(B, num_pts)`` scans -> ``(B*pad, C)`` cutouts: K1 on
        the scans padded to ``pad`` beams, or JAX's fallback, the module
        cutout with its dead rows zeros."""
        with tracing.span("step.cutout"):
            if kernel_cutout:
                return cutout(F.pad(scan, (0, pad - num_pts)), **cut_kw)
            cut = _encode_single(scan, phi, cutout_kwargs)
            return F.pad(cut, (0, 0, 0, pad - num_pts)).reshape(-1, ct_len)

    def encode(scan):
        scan = prepare(scan)
        return scan, cutouts(scan)

    if precision == "bf16":
        with tracing.span("serve.weights", always=True):
            layer1, tail_w = fold.backbone_stack_weights(det.backbone)
            # K2's and K4's conv weights laid out for their weight rings
            # once, for every step
            bb_w = backbone_weights_bf16(tail_w)
            hd_conv_w = head_weights_bf16(
                fold.prepare_stack_weights(fold.head_conv_blocks(det.head)))

        def step(carry, scan):
            scan, flat = encode(scan)
            b = scan.shape[0]
            with tracing.span("step.backbone"):
                feats, zx = backbone_bf16(flat, layer1, bb_w, (gp.w, gp.b),
                                          l=ct_len)
            feats = feats.reshape(b * p_pad, l4 * FEAT_CHANNELS)
            with tracing.span("step.gate"):
                if carry is None:
                    # bootstrap: the features become the template; the gate
                    # only supplies the similarity band
                    template, z = feats, zx
                    _, _, sim = gate(zx, zx, feats, feats, **gate_kw)
                else:
                    template, z, sim = gate(zx, carry["z"], feats,
                                            carry["template"], **gate_kw)
            with tracing.span("step.head"):
                cls, reg = head(template.reshape(-1, FEAT_CHANNELS),
                                hd_conv_w, hd_head_w,
                                num_classes=num_classes, l4=l4)
            return finish(scan, b, template, z, sim, cls, reg)

        return _serving(step, None, dev, precision)

    # ---- int8 / int8c: quantized from the f32 folded weights ----
    if calib is not None:
        _check_calibration(calib, det, num_pts, ct_len)
    elif calib_scans is None:
        raise ValueError("int8 precision requires calib_scans or calib")
    else:
        with tracing.span("serve.calibrate", always=True):
            calib = _calibrate(
                model, det, cutout_kwargs, calib_scans, num_pts=num_pts,
                encode=lambda s: cutouts(
                    s, pad_cell if cell else pad_pm if pm else pad8),
                percentile=calib_percentile, steps=calib_steps,
                sanitize=sanitize_inputs, san_max=san_max, dev=dev)
    with tracing.span("serve.row_check", always=True):
        check_row_shift(dev)
    with tracing.span("serve.weights", always=True):
        w = int8_weights(det, calib, dev, precision)
        # the int8 convs' weights (K5, K7-K10, K12, K13) laid out for their
        # weight rings once, for every step
        bb_laid, hd_laid = (backbone_weights_int8(w.backbone),
                            head_weights_int8(w.head))

    def head_of(template):
        """int8 ``(N*l4, 256)`` template -> (cls, reg): K7."""
        with tracing.span("step.head"):
            return head_int8(template, hd_laid, hd_head_w,
                             num_classes=num_classes, l4=l4)

    def backbone(flat):
        """-> (feats (N*l4, 256), zx (N, 128) bf16)."""
        with tracing.span("step.backbone"):
            if pm and (layout in ("pm", "cell") or p2_l1_mode != "mm"):
                return backbone_int8_pm(flat, w.layer1_div, bb_laid, w.embed,
                                        l=ct_len, in_scale=w.in_scale)
            if pm:
                return backbone_int8(flat, w.layer1, bb_laid, w.embed,
                                     l=ct_len)
            act1 = backbone_layer1(flat, w.layer1_div, out_scale=w.in_scale)
            return backbone_int8_tail(
                act1, bb_laid, w.embed, l=ct_len,
                out_dtype=(torch.int8 if precision == "int8c"
                           else torch.bfloat16))

    if precision == "int8":
        def step(carry, scan):
            scan, flat = encode(scan)
            b = scan.shape[0]
            feats, zx = backbone(flat)
            feats = feats.reshape(b * p_pad, l4 * FEAT_CHANNELS)  # bf16
            with tracing.span("step.gate"):
                if carry is None:
                    template, z = feats, zx
                    _, _, sim = gate(zx, zx, feats, feats, **gate_kw)
                else:
                    template, z, sim = gate(zx, carry["z"], feats,
                                            carry["template"], **gate_kw)
            # the bf16 template, quantized through f32 for the int8 head
            cls, reg = head_of(quant.quantize_int8(
                template.reshape(-1, FEAT_CHANNELS), w.tmpl_scale))
            return finish(scan, b, template, z, sim, cls, reg)

        return _serving(step, calib, dev, precision)

    feat_scale, tmpl_scale = w.feat_scale, w.tmpl_scale
    gate_kw.update(s_x=feat_scale, s_out=tmpl_scale)
    embed_cell = cell_embed(w.embed) if cell else None

    def features(scan):
        """Sanitized scans (B, num_pts) -> (feats (N, D) int8, zx (N, 128)
        bf16)."""
        if p2c:
            with tracing.span("step.backbone"):  # K8: K1's cutouts and K5
                feats, zx = backbone_int8_cut(
                    F.pad(scan, (0, p_pad - num_pts)), w.layer1, bb_laid,
                    w.embed, **cut_kw)
        else:
            feats, zx = backbone(cutouts(scan))
        return feats.reshape(zx.shape[0], l4 * FEAT_CHANNELS), zx

    def step(carry, scan):
        scan = prepare(scan)
        b = scan.shape[0]
        if carry is None:
            # bootstrap: the features, rescaled to the carry's scale
            feats, zx = features(scan)
            with tracing.span("step.rescale", device=True):
                template = torch.clamp(torch.round(
                    feats.float() * (feat_scale / tmpl_scale)), -127,
                    127).to(torch.int8)
            z = zx
            with tracing.span("step.gate"):
                _, _, sim = gate_int8(zx, zx, feats, feats, s_t=feat_scale,
                                      **gate_kw)
            cls, reg = head_of(template.reshape(-1, FEAT_CHANNELS))
        elif cell:
            flat = cutouts(scan)
            with tracing.span("step.backbone"):  # K13: the whole cell
                template, z, sim, cls, reg = serve_cell_int8(
                    flat, carry["z"], carry["template"],
                    w.layer1_div, bb_laid, embed_cell, hd_laid, hd_head_w,
                    l=ct_len, in_scale=w.in_scale, s_t=tmpl_scale,
                    num_classes=num_classes, **gate_kw)
        elif fuse_gate_head:
            feats, zx = features(scan)
            with tracing.span("step.gate"):  # K12: the gate and the head
                template, z, sim, cls, reg = gate_head_int8(
                    zx, carry["z"], feats, carry["template"], hd_laid,
                    hd_head_w, s_t=tmpl_scale, num_classes=num_classes,
                    l4=l4, **gate_kw)
        else:
            feats, zx = features(scan)
            with tracing.span("step.gate"):
                template, z, sim = gate_int8(zx, carry["z"], feats,
                                             carry["template"],
                                             s_t=tmpl_scale, **gate_kw)
            cls, reg = head_of(template.reshape(-1, FEAT_CHANNELS))
        return finish(scan, b, template, z, sim, cls, reg)

    return _serving(step, calib, dev, precision)


class ShardedCarry(list):
    """The carry of a sharded serving step: one carry a shard, each on its
    shard's device, its rows those of the shard's streams."""

    def gather(self, device=None) -> dict:
        """The whole carry (stream-major rows, shard after shard) on
        ``device`` (default: shard 0's)."""
        device = device or self[0]["template"].device
        return {k: torch.cat([c[k].to(device) for c in self])
                for k in self[0]}


def _sharded_serve_step(mesh, model, cutout_kwargs, *, calib=None,
                        calib_scans=None, **kwargs):
    """``make_serve_step_v3`` over ``mesh``'s ``data`` axis (JAX's
    ``shard_map`` of the step over ``P("data")``, ``streaming.py:1010-1030``).
    Streams are independent, so each shard runs the whole step on its
    block of the batch with no collective: every kernel (K1, K5, K6, K7 on
    int8c p2) launches once a shard, on whole streams since the carry rows
    are stream-major. The int8 calibration is computed once (on shard 0's
    device) and shared; a model is copied to each further device.

    In one process the step takes the whole batch, which must be a multiple
    of the ``data`` size, and returns a :class:`ShardedCarry` (a dict carry
    is split by rows) and the outputs concatenated on shard 0's device.
    Across processes each rank serves its block of the batch's rows
    (``parallel.batch_sharding``) on its device, and returns its rows."""
    from planar_optical_flow_tpu_torch.parallel.mesh import batch_sharding

    if "data" not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no data axis to shard the "
                         "streams over")
    n = mesh.shape["data"]
    if mesh.multi_process:
        step = make_serve_step_v3(model, cutout_kwargs, calib=calib,
                                  calib_scans=calib_scans,
                                  device=mesh.device, **kwargs)
        rows_of = batch_sharding(mesh)

        def dispatch_rank(carry, scan):
            b = scan.shape[0]
            if b % rows_of.count:
                raise ValueError(f"batch {b} must be a multiple of the mesh "
                                 f"data-axis size {rows_of.count}")
            return step(carry, scan[rows_of.rows(b)])

        dispatch_rank.calibration = step.calibration
        dispatch_rank.device, dispatch_rank.precision = (step.device,
                                                         step.precision)
        return dispatch_rank
    data = mesh.axis_names.index("data")
    devs = [torch.device(d) for d in np.moveaxis(mesh.devices, data, 0)
            .reshape(n, -1)[:, 0]]
    steps = {}
    for dev in devs:
        if dev in steps:
            continue
        steps[dev] = make_serve_step_v3(
            model if not steps else copy.deepcopy(model), cutout_kwargs,
            calib=calib, calib_scans=None if calib is not None
            else calib_scans, device=dev, **kwargs)
        calib = steps[dev].calibration if calib is None else calib

    @torch.inference_mode()
    def dispatch(carry, scan):
        b = scan.shape[0]
        if b % n:
            raise ValueError(f"batch {b} must be a multiple of the mesh "
                             f"data-axis size {n}")
        per = b // n
        if carry is None:
            carries = [None] * n
        elif isinstance(carry, ShardedCarry):
            carries = carry
        else:  # a whole carry: its stream-major rows split evenly
            carries = [{k: v.chunk(n)[i].to(devs[i]) for k, v in
                        carry.items()} for i in range(n)]
        new, outs = ShardedCarry(), []
        for i, dev in enumerate(devs):
            c, out = steps[dev](carries[i], scan[i * per:(i + 1) * per])
            new.append(c)
            outs.append(out)
        return new, {k: torch.cat([o[k].to(devs[0]) for o in outs])
                     for k in outs[0]}

    dispatch.calibration = calib
    dispatch.device, dispatch.precision = devs[0], steps[devs[0]].precision
    dispatch.shards = devs
    return dispatch


def _serving(raw, calibration, device, precision):
    """The live step: ``raw`` under ``torch.inference_mode``, with
    ``raw_step`` (``raw`` itself, the body ``infer.export`` traces under
    ``torch.no_grad``), ``calibration`` (the int8 scales, or None),
    ``device`` and ``precision`` on it."""
    step = torch.inference_mode()(raw)
    step.raw_step = raw
    step.calibration = calibration
    step.device = device
    step.precision = precision
    return step


class StreamingRunner:
    """Holds a model and the per-stream carry.

    ``engine``: ``"module"`` (the f32 reference path), ``"v3"`` (the fused
    bf16 serving path) or ``"int8c"`` (the int8 serving path, the JAX
    package's flagship). On ``device="cpu"`` the serving engines run their
    kernels' plain versions. int8c scales come from ``calib`` (a
    ``ServeCalibration`` or a path to a ``calibration.json`` or its
    directory) or from ``calib_scans``; with neither, the runner
    calibrates on the first batch it sees. ``runner.calibration`` holds the
    scales in effect. :meth:`from_artifact` runs a serving artifact
    instead of a model.

    A call after :meth:`reset` of some streams is a restart step: the
    carried pass on the whole batch, then the bootstrap pass on the
    restarted streams' rows alone (its launches overlap the carried
    kernels on the card), then the bootstrapped rows of the carry and the
    outputs scattered, on the device, into those the carried pass made.
    The step is batch-agnostic (fixed int8 scales; the gate band and the
    NMS are per stream), so those rows equal the same rows of a bootstrap
    of the whole batch. An artifact runner bootstraps the restarted rows
    alone only if its artifact holds a program for that batch; otherwise it
    bootstraps the whole batch and scatters the restarted rows out of it.
    """

    def __init__(self, model, cutout_kwargs, num_pts: int = 450,
                 nms_min_dist: float = 0.5, with_nms: bool = True,
                 engine: str = "module", calib=None, calib_scans=None,
                 output_fields=None, device="cuda"):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}")
        resolve_device(device)
        self._engine = engine
        self._carry = None
        self._pending_reset = None
        self.calibration = None
        is_flow = isinstance(model, FlowDrow)
        self._output_fields = _check_output_fields(output_fields, is_flow,
                                                   with_nms)
        if engine == "module":
            self._step = make_stream_step(model, cutout_kwargs, num_pts,
                                          nms_min_dist, with_nms,
                                          device=device)
            return
        if isinstance(calib, (str, os.PathLike)):
            calib = ServeCalibration.load(calib)
        self._build = lambda **kw: make_serve_step_v3(
            model, cutout_kwargs, num_pts=num_pts,
            nms_min_dist=nms_min_dist, with_nms=with_nms,
            precision="bf16" if engine == "v3" else "int8c",
            output_fields=self._output_fields, device=device, **kw)
        self._step = None
        if engine == "v3":
            self._step = self._build()
        elif calib is not None or calib_scans is not None:
            self._step = self._build(calib=calib, calib_scans=calib_scans)
            self.calibration = self._step.calibration
        # else: int8c calibrates on the first batch (built in __call__)

    @classmethod
    def from_artifact(cls, path) -> "StreamingRunner":
        """A runner on a serving artifact (``infer.export.
        export_serving_engine``, ``cli.export_serving``): the engine
        directory is the whole deployment unit, with no model, weights or
        calibration. The batch sizes and scan width are the artifact's
        (``runner.meta``), its outputs those it was exported with.
        ``path``: the directory, or a ``ServingEngine`` already loaded.
        Per-stream ``reset`` works as on a live runner."""
        from planar_optical_flow_tpu_torch.infer.export import (
            ServingEngine,
            load_serving_engine,
        )

        runner = cls.__new__(cls)
        runner._engine = "artifact"
        runner._carry = None
        runner._pending_reset = None
        runner._output_fields = None
        runner.calibration = None
        runner._step = (path if isinstance(path, ServingEngine)
                        else load_serving_engine(path))
        runner.meta = runner._step.meta
        return runner

    def reset(self, streams=None):
        """``streams=None`` restarts every stream (the next call
        bootstraps the whole batch); ``streams=[i, ...]`` restarts only
        those batch rows on the next call (calls add up), which then runs
        the carried step on the whole batch and the bootstrap on those rows
        alone (on an artifact without a program for that many rows: on the
        whole batch), and takes the named rows of the carry and the outputs
        from the bootstrap. An empty list is a no-op."""
        if streams is None:
            self._carry = None
            self._pending_reset = None
            return
        idx = np.unique(np.asarray(streams, dtype=np.int64))
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
        with tracing.span("runner.call"):
            return self._call(scan)

    def _call(self, scan) -> dict:
        if self._step is None:
            # lazy int8c: calibrate on this batch
            self._step = self._build(calib_scans=scan)
            self.calibration = self._step.calibration
        pending = self._pending_reset
        if pending is not None and self._carry is not None:
            b = scan.shape[0]
            if pending.max() >= b:
                self._pending_reset = pending[pending < b]
                raise ValueError(
                    f"reset stream indices {pending.tolist()} out of range "
                    f"for batch {b} (invalid indices discarded; in-range "
                    f"ones stay pending)")
            self._pending_reset = None
            return self._restart(scan, pending)
        self._pending_reset = None
        self._carry, out = self._dispatch(self._carry, scan)
        return out

    def _restart(self, scan, idx):
        """The restart step of the streams ``idx`` (sorted, unique)."""
        b, k = scan.shape[0], idx.size
        whole = self._engine == "artifact" and k not in self._step.batches
        carry = self._carry
        dev = next(iter(carry.values() if isinstance(carry, dict)
                        else (carry,))).device
        idx_h = torch.from_numpy(idx)
        # from pinned memory: the host waits for no pass to copy the index
        idx_d = (idx_h.pin_memory().to(dev, non_blocking=True)
                 if dev.type == "cuda" else idx_h.to(dev))
        tracing.count("runner.restarted_streams", k)
        tracing.count("runner.boot_streams", b if whole else k)
        with tracing.span("runner.restart", device=True):
            # both passes take the batch from the device: an upload inside
            # the bootstrap would wait for the carried pass, whose kernels
            # the bootstrap's launches are meant to overlap
            scan = torch.as_tensor(scan, dtype=torch.float32, device=dev)
            with tracing.span("runner.carried", device=True):
                carry, out = self._dispatch(carry, scan)
            with tracing.span("runner.bootstrap", device=True):
                boot_carry, boot_out = self._dispatch(
                    None, scan if whole else scan.index_select(0, idx_d))
            # in place into what the carried pass made in this call
            with tracing.span("runner.merge", device=True):
                self._carry = _scatter_streams(carry, boot_carry, idx_d, b,
                                               whole)
                return _scatter_streams(out, boot_out, idx_d, b, whole)
