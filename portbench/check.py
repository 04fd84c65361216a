"""The comparison that decides ``correct``.

After the window, the reference (``reference/<module>.py``, the module the
configuration names, ``reference/model.py`` by default) replays every step
of a sample of streams, drawn from the seed, from the step each stream
started on (the window's first step, or its last restart), and the
program's outputs on those streams are held against it:

* ``cls``, ``reg``, ``flow``: the root mean square of the program's error in
  the person logit (taken back from the probability it serves), the vote
  and the sensor-frame flow (FlowDROW only), over every beam of every
  compared step, divided by the standard deviation of the reference's
  values. These cover the cutout, backbone, gate with its carried template,
  head and flow head, and the restarted streams' bootstrap rows. The logit,
  not the probability: the sigmoid bounds the error of any wrong answer, so
  on the probability an int4 control reads under three times what a sound
  int8 run does;
* ``nms``: the NMS stage on its own: the reference's vote NMS run on the
  program's own probabilities and votes of each compared step must give the
  program's detections. The number is how many of the top-k detection slots
  differ (kept on one side only, or kept on both and more than 1e-4 apart in
  position or confidence). The stage cannot be held to the reference's
  probabilities instead: at the configuration's precision their ranks swap.

The reference computes in float32, or, where the configuration states an
integer precision (``check.reference_bits``), at that precision: every
tensor that the configuration holds as integers rounded at the scales that
the float32 reference reaches on the calibration scans the program was
given (``reference/quant.py``). Against float32 an int8 configuration's
rounding alone reads most of a number's room (``PERF.md`` §2), so a head
that served a constant would pass; against the int8 reference the two
roundings largely agree and such a head reads far out.

Each number has its limit in the configuration file (``check.limits``);
the run is correct when every number is within its limit.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.nms import vote_nms
from portbench.reference.quant import quantized_reference

NMS_TOL = 1e-4


class _Moments:
    """Running sums of the error and of the reference's values."""

    def __init__(self):
        self.err2 = self.ref = self.ref2 = 0.0
        self.n = 0

    def add(self, got, ref):
        got, ref = got.double(), ref.double()
        self.err2 += float(((got - ref) ** 2).sum())
        self.ref += float(ref.sum())
        self.ref2 += float((ref ** 2).sum())
        self.n += ref.numel()

    def value(self):
        return self.err_rms() / self.ref_std()

    def err_rms(self):
        return float(np.sqrt(self.err2 / self.n))

    def ref_std(self):
        mean = self.ref / self.n
        return float(np.sqrt(max(self.ref2 / self.n - mean * mean, 1e-30)))


def sanitize(scans, max_range):
    """Non-finite ranges read the sensor's maximum; all clipped to
    ``[0, max_range]``."""
    scans = torch.nan_to_num(scans, nan=max_range, posinf=max_range,
                             neginf=max_range)
    return torch.clamp(scans, 0.0, max_range)


def nms_mismatch(got, scans, phi, nms_cfg, device, rows=4096):
    """Detection slots where the program's NMS differs from the reference
    NMS on the program's own outputs. ``got``: host arrays ``pred_cls (N,
    P)``, ``pred_reg (N, P, 2)``, ``det_xys (N, K, 2)``, ``det_cls (N, K)``,
    ``det_keep (N, K)``; ``scans (N, P)``."""
    phi_t = torch.as_tensor(phi, dtype=torch.float32, device=device)
    bad = 0
    n = scans.shape[0]
    for i in range(0, n, rows):
        def dev(a):
            return torch.as_tensor(a[i:i + rows]).to(device)
        xy, conf, keep = vote_nms(dev(scans), phi_t, dev(got["pred_cls"]),
                                  dev(got["pred_reg"]),
                                  min_dist=nms_cfg["min_dist"],
                                  top_k=nms_cfg["top_k"])
        g_keep = dev(got["det_keep"]).bool()
        far = (((dev(got["det_xys"]) - xy).abs() > NMS_TOL).any(-1)
               | ((dev(got["det_cls"]) - conf).abs() > NMS_TOL))
        bad += int(((g_keep != keep) | (g_keep & keep & far)).sum())
    return bad


def reference_for(sd, cfg, calib, module):
    """The reference the program's outputs are held to (module docstring),
    from ``module``, the configuration's reference module; ``calib (N,
    P)``: the calibration scans, as the program got them."""
    bits = cfg["check"].get("reference_bits")
    if not bits:
        return module.Reference(sd, cfg)
    calib = sanitize(torch.as_tensor(calib, dtype=torch.float32),
                     float(cfg["cutout"]["padding_val"]))
    return quantized_reference(sd, cfg, calib, int(bits), module)


def compare(sd, cfg, scans, boot, got, device, calib, module, detail=None):
    """The numbers of the comparison (module docstring). ``scans (T, S,
    P)`` and ``boot (T, S)`` are what the sampled streams were fed; ``got``
    the program's outputs on them, host arrays with leading ``(T, S)``;
    ``calib`` the program's calibration scans; ``module`` the
    configuration's reference module. ``detail``, a dict, receives each
    field's error and spread."""
    ref = reference_for(sd, cfg, calib, module)
    max_range = float(cfg["cutout"]["padding_val"])
    scans = sanitize(torch.as_tensor(scans), max_range)
    fields = ("pred_cls", "cls_logit", "pred_reg") + (
        ("pred_flow",) if ref.flow else ())
    moments = {f: _Moments() for f in fields}

    def on_block(t0, out):
        for f in fields:
            n = out[f].shape[0]
            mine = torch.as_tensor(got[f if f != "cls_logit" else "pred_cls"]
                                   [t0:t0 + n]).to(device)
            if f == "cls_logit":
                mine = torch.logit(mine.double(), eps=1e-12)
            moments[f].add(mine, out[f])

    module.run_streams(ref, scans, boot, on_block=on_block)
    numbers = {"cls": moments["cls_logit"].value(),
               "reg": moments["pred_reg"].value()}
    if ref.flow:
        numbers["flow"] = moments["pred_flow"].value()
    if detail is not None:
        detail.update({f: {"err_rms": m.err_rms(), "ref_std": m.ref_std(),
                           "ref_mean": m.ref / m.n}
                       for f, m in moments.items()})
    flat = {k: np.asarray(got[k]).reshape(-1, *np.shape(got[k])[2:])
            for k in ("pred_cls", "pred_reg", "det_xys", "det_cls",
                      "det_keep")}
    with torch.inference_mode():
        numbers["nms"] = float(nms_mismatch(
            flat, scans.reshape(-1, scans.shape[-1]), ref.phi, cfg["nms"],
            device))
    return numbers


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, ``{name: {"value", "limit"}}``): correct when every number
    is within its limit; a number without a limit, or a limit without its
    number, is not."""
    table = {k: {"value": numbers.get(k), "limit": limits.get(k)}
             for k in list(limits) + [k for k in numbers if k not in limits]}
    ok = all(v["value"] is not None and v["limit"] is not None
             and np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table
