"""What may stand in the runner's place to show that the check can fail.

* :class:`LowPrecisionReference`: the control of an int8 configuration, the
  reference itself computed in int4 (``reference/quant.py``), calibrated on
  the same scans as the program. It computes the compared streams only; the
  others' outputs are zeros, which nothing reads. With no bits it is the
  float32 reference itself, a program that must read correct.
* :func:`program_at` with another engine: the control of a bf16
  configuration is the program's own int8c path.
* :class:`Fault`: the program with one fault planted in its timed path:
  ``stale_state`` (each step hands back the carry it was given),
  ``half_batch`` (the second half of the streams gets the first half's
  outputs), ``altered_answer`` (each stream's most confident detection moved
  by 5 cm where the step produces it), ``constant_head`` (the head serves
  the step's mean class probability and vote on every beam, and the NMS
  runs on those: only the ``cls`` and ``reg`` numbers can see it).

Each is a callable ``(cell, sd, calib_scans, device, sample) -> runner`` for
``harness.run(program=...)``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import harness
from portbench.check import sanitize
from portbench.reference.model import full_f32
from portbench.reference.nms import vote_nms
from portbench.reference.quant import quantized_reference

FAULTS = ("stale_state", "half_batch", "altered_answer", "constant_head")


class LowPrecisionReference:
    """The reference (``module``, a configuration's reference module) at
    ``bits`` bits in the runner's place (4: one step below int8; None:
    float32) for ``streams`` streams of the configuration ``cfg``."""

    def __init__(self, cfg, streams, module, sd, calib_scans, device, sample,
                 bits):
        self.cfg, self.device = cfg, device
        self.sample = torch.as_tensor(sample)
        self.b = int(streams)
        if bits is None:
            self.ref = module.Reference(sd, cfg)
        else:
            calib = torch.as_tensor(calib_scans, dtype=torch.float32)
            calib = sanitize(calib, float(cfg["cutout"]["padding_val"]))
            self.ref = quantized_reference(sd, cfg, calib, bits, module)
        self.phi = torch.as_tensor(self.ref.phi, dtype=torch.float32,
                                   device=device)
        self.template = None
        self.boot = torch.ones(len(sample), dtype=torch.bool, device=device)

    def reset(self, streams=None):
        if streams is None:
            self.template = None
            self.boot[:] = True
            return
        hit = np.isin(self.sample.numpy(), np.asarray(streams))
        self.boot |= torch.as_tensor(hit, device=self.device)

    @torch.inference_mode()
    def __call__(self, batch):
        ref, dev = self.ref, self.device
        x = torch.as_tensor(batch)[self.sample].to(dev, torch.float32)
        x = sanitize(x, float(self.cfg["cutout"]["padding_val"]))
        with full_f32():
            feats = ref.features(x)
            self.template, sim = ref.gate(feats, self.template, self.boot)
            logit, reg = ref.heads(self.template)
            probs = torch.sigmoid(logit)
            got = {"pred_cls": probs[..., None], "pred_reg": reg}
            if ref.flow:
                got["pred_flow"] = ref.flow_head(sim, x)
            nms = self.cfg["nms"]
            xy, conf, keep = vote_nms(x, self.phi, probs, reg,
                                      nms["min_dist"], nms["top_k"])
        self.boot[:] = False
        got.update(det_xys=xy, det_cls=conf[..., None], det_keep=keep)
        out = {}
        for k, v in got.items():
            full = torch.zeros((self.b,) + tuple(v.shape[1:]), dtype=v.dtype,
                               device=dev)
            full[self.sample.to(dev)] = v
            out[k] = full
        return out


def low_precision_reference(bits):
    def make(cell, sd, calib_scans, device, sample):
        return LowPrecisionReference(cell.config, cell.streams,
                                     cell.reference(), sd, calib_scans,
                                     device, sample, bits)
    return make


def program_at(engine):
    def make(cell, sd, calib_scans, device, sample):
        return harness.make_runner(cell.config, sd, calib_scans, device,
                                   engine)
    return make


class Fault:
    """The port's runner with ``kind`` (one of :data:`FAULTS`) planted;
    ``phi``: the beam angles, the reference's."""

    def __init__(self, runner, kind, cfg, phi):
        if kind not in FAULTS:
            raise ValueError(f"unknown fault {kind!r}")
        self.runner, self.kind, self.cfg, self.phi = runner, kind, cfg, phi

    def reset(self, streams=None):
        self.runner.reset(streams)

    def __call__(self, batch):
        carry = self.runner._carry
        out = self.runner(batch)
        if self.kind == "stale_state" and carry is not None:
            self.runner._carry = carry
        elif self.kind == "half_batch":
            out = dict(out)
            for k, v in out.items():
                h = v.shape[0] // 2
                v = v.clone()
                v[h:] = v[:v.shape[0] - h].clone()
                out[k] = v
        elif self.kind == "altered_answer":
            out = dict(out)
            xy = out["det_xys"].clone()
            xy[:, 0] += 0.05
            out["det_xys"] = xy
        elif self.kind == "constant_head":
            out = self._constant_head(dict(out), batch)
        return out

    def _constant_head(self, out, batch):
        cls = out["pred_cls"]
        cls = cls.float().mean().expand(cls.shape).to(cls.dtype)
        reg = out["pred_reg"]
        reg = reg.float().mean(dim=(0, 1)).expand(reg.shape).to(reg.dtype)
        x = torch.as_tensor(batch).to(cls.device, torch.float32)
        x = sanitize(x, float(self.cfg["cutout"]["padding_val"]))
        phi = torch.as_tensor(self.phi, dtype=torch.float32,
                              device=x.device)
        nms = self.cfg["nms"]
        xy, conf, keep = vote_nms(x, phi, cls[..., 0].float(), reg.float(),
                                  nms["min_dist"], nms["top_k"])
        out.update(pred_cls=cls, pred_reg=reg, det_xys=xy,
                   det_cls=conf[..., None].to(out["det_cls"].dtype),
                   det_keep=keep.to(out["det_keep"].dtype))
        return out


def fault(kind):
    def make(cell, sd, calib_scans, device, sample):
        cfg = cell.config
        phi = cell.reference().Reference(sd, cfg).phi
        return Fault(harness.make_runner(cfg, sd, calib_scans, device), kind,
                     cfg, phi)
    return make


def control(cfg):
    """The configuration's control (``check.control``)."""
    name = cfg["check"]["control"]
    if name == "int4":
        return low_precision_reference(4)
    return program_at(name)
