"""The plain reference: DR-SPAAM and FlowDROW streaming, in float32 PyTorch.

Written from the architecture (Jia, Hermans, Leibe, "DR-SPAAM", IROS 2020,
and its reference code), not from the port: it imports nothing of the
program and reads only the state dict the benchmark made, by key. Every
float32 product is float32 (TF32 is off while the reference runs).

* Cutout: for beam ``i`` at range ``r``, the window ``r`` +- ``width / 2``
  across the beam spans the angle ``2 * atan(width / 2 / r)``; ``C`` taps
  sample it evenly. A tap is the linear interpolation of the two beams
  around it, or, where the window spans more than ``C`` beams (area mode),
  the mean of the beams ``rint(ind -+ tap_w / 2)`` around it (the band mean
  of the configuration's ``gather_mode: matmul``), taken here from a float64
  prefix sum. Taps outside the scan read ``padding``; values are clipped to
  ``r +- depth`` and centred: ``(v - r) / depth``.
* Backbone: conv3 64, 64, 128, max-pool 2, conv3 128, 128, 256, max-pool 2;
  each conv is conv + bias, BatchNorm (eval), LeakyReLU 0.1. Features are
  position-major, ``(C // 4) * 256`` wide.
* Gate (spatial attention, window ``w``): embedding ``e = leaky(BN(W f +
  b))``; similarity of cutout ``i`` with template cutouts ``i + o``, ``|o|
  <= w // 2``; softmax over the neighbours inside the scan; new template
  ``alpha * f + (1 - alpha) * sum_o attn * template[i + o]``. The first scan
  of a stream is its own template, and its similarity band is the
  features' with themselves. The band (edge indices clamped) feeds the flow
  head.
* Head: conv3 256, 256, 512, max-pool 2, conv3 256, 128, mean over
  positions, linear to the class logit (sigmoid) and to the 2-D vote.
* Flow head (FlowDROW): the band and the range, ``w + 1`` channels along
  the beams, conv3 128, 64, 32 and a pointwise conv block to 2; the
  canonical flow of beam ``i`` turned into the sensor frame by ``R(-phi_i)``.

``quant`` (``reference/quant.py``) hooks every quantizable tensor: None for
float32, a recorder to calibrate, or a fake quantizer for the control.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.spec import angle_inc

SLOPE = 0.1
BN_EPS = 1e-5
FEAT = 256
EMBED = 128


@contextlib.contextmanager
def full_f32():
    """float32 products on the card: TF32 off for matmuls and convs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def laser_phi(num_pts: int, angle_inc: float = math.radians(0.5)):
    """DROW's beam angles: ``num_pts`` at ``angle_inc``, centred on 0."""
    fov = (num_pts - 1) * angle_inc
    return np.linspace(-0.5 * fov, 0.5 * fov, num_pts)


def cutout(scans, phi, *, num_cutout_pts, window_width, window_depth,
           padding_val, area_mode=True):
    """``(N, P)`` ranges -> ``(N * P, C)`` centred cutouts (module
    docstring)."""
    n, p = scans.shape
    c = num_cutout_pts
    x = scans.float()
    phi_t = torch.as_tensor(phi, dtype=torch.float32, device=x.device)
    inc = float(phi[1] - phi[0])
    half = torch.atan(0.5 * window_width / torch.clamp(x, min=1e-2))
    taps = torch.arange(c, dtype=torch.float32, device=x.device)
    ang = (phi_t - half)[..., None] + taps * (2.0 * half / (c - 1))[..., None]
    ind = (ang - float(phi[0])) / inc  # (N, P, C) fractional beam
    low = torch.clamp(torch.floor(ind), 0, p - 1).long()
    high = torch.clamp(low + 1, 0, p - 1)
    frac = torch.clamp(ind - low.float(), 0.0, 1.0)

    def take(table, idx):
        return torch.gather(table, 1, idx.reshape(n, -1)).reshape(idx.shape)

    lo_v = take(x, low)
    ct = lo_v + frac * (take(x, high) - lo_v)
    if area_mode:
        span = ind[..., -1:] - ind[..., :1]
        tap_w = span / (c - 1)
        a_lo = torch.round(torch.clamp(ind - 0.5 * tap_w, 0, p - 1)).long()
        a_hi = torch.maximum(
            torch.round(torch.clamp(ind + 0.5 * tap_w, 0, p - 1)).long(), a_lo)
        csum = F.pad(torch.cumsum(x.double(), dim=1), (1, 0))
        band = (take(csum, a_hi + 1) - take(csum, a_lo)) / (a_hi - a_lo + 1)
        ct = torch.where(span > c, band.float(), ct)
    ct = torch.where((ind < 0) | (ind > p - 1),
                     torch.full_like(ct, padding_val), ct)
    r = x[..., None]
    ct = torch.minimum(torch.maximum(ct, r - window_depth), r + window_depth)
    return ((ct - r) / window_depth).reshape(n * p, c)


def _q_act(quant, name, x):
    return x if quant is None else quant.act(name, x)


def _q_weight(quant, name, w):
    return w if quant is None else quant.weight(name, w)


def conv_block(sd, prefix, x, quant=None, name=None, fit=False):
    """conv (torch padding ``((k-1)//2, k//2)``) + bias, BatchNorm (eval),
    LeakyReLU 0.1 on ``(N, Cin, L)``; ``fit``: see :func:`batch_norm`."""
    w = sd[prefix + ".conv.weight"]
    k = w.shape[-1]
    if name is not None:
        x = _q_act(quant, name, x)
        w = _q_weight(quant, name, w)
    if k > 1:
        x = F.pad(x, ((k - 1) // 2, k // 2))
    y = F.conv1d(x, w) + sd[prefix + ".conv.bias"][:, None]
    y = batch_norm(sd, prefix + ".bn", y, 1, fit)
    return F.leaky_relu(y, SLOPE)


def batch_norm(sd, prefix, y, channel_dim, fit=False):
    """Eval-mode BatchNorm. With ``fit`` the running statistics are first
    set, in ``sd``, to the mean and variance of ``y`` itself."""
    shape = [1] * y.ndim
    shape[channel_dim] = -1
    if fit:
        dims = tuple(d for d in range(y.ndim) if d != channel_dim % y.ndim)
        sd[prefix + ".running_mean"].copy_(y.mean(dim=dims))
        sd[prefix + ".running_var"].copy_(torch.clamp(
            y.var(dim=dims, unbiased=False), min=1e-4))
    mean = sd[prefix + ".running_mean"].view(shape)
    var = sd[prefix + ".running_var"].view(shape)
    return ((y - mean) / torch.sqrt(var + BN_EPS)
            * sd[prefix + ".weight"].view(shape)
            + sd[prefix + ".bias"].view(shape))


class Reference:
    """The reference model on a state dict ``sd`` (keys of the port's
    ``FlowDrow`` or ``SpatialDrow``), float32."""

    def __init__(self, sd: dict, cfg: dict, quant=None):
        self.flow = cfg["model"] == "flow_drow"
        pre = "dr_spaam." if self.flow else ""
        self.sd = {k: v.float() for k, v in sd.items()
                   if v.is_floating_point()}
        self.det = pre
        self.alpha = float(cfg["alpha"])
        self.window = int(cfg["window_size"])
        self.cut_kw = {k: v for k, v in cfg["cutout"].items()
                       if k != "gather_mode"}
        self.num_pts = int(cfg["num_pts"])
        self.phi = laser_phi(self.num_pts, angle_inc(cfg))
        self.quant = quant
        self.fit = False  # see fit_batch_norm

    # ---- per cutout
    def backbone(self, cut):
        """``(N, C)`` cutouts -> ``(N, (C // 4) * 256)`` features."""
        sd, q, p = self.sd, self.quant, self.det + "backbone."
        y = conv_block(sd, p + "block1.blocks.0", cut[:, None, :],
                       fit=self.fit)
        for i in (1, 2):
            y = conv_block(sd, p + f"block1.blocks.{i}", y, q, f"bb{i}",
                           self.fit)
        y = F.max_pool1d(y, 2)
        for i in range(3):
            y = conv_block(sd, p + f"block2.blocks.{i}", y, q, f"bb{3 + i}",
                           self.fit)
        y = F.max_pool1d(y, 2)
        f = y.transpose(1, 2).reshape(y.shape[0], -1)
        return _q_act(q, "feats", f)

    def head(self, template):
        """``(N, D)`` templates -> (logit ``(N,)``, vote ``(N, 2)``)."""
        sd, q, p = self.sd, self.quant, self.det + "head."
        y = template.reshape(template.shape[0], -1, FEAT).transpose(1, 2)
        for i in range(3):
            y = conv_block(sd, p + f"block3.blocks.{i}", y, q, f"hd{i}",
                           self.fit)
        y = F.max_pool1d(y, 2)
        for i in range(2):
            y = conv_block(sd, p + f"block4.blocks.{i}", y, q, f"hd{3 + i}",
                           self.fit)
        y = y.mean(dim=-1)
        cls = y @ sd[p + "cls.weight"].t() + sd[p + "cls.bias"]
        reg = y @ sd[p + "reg.weight"].t() + sd[p + "reg.bias"]
        return cls[:, 0], reg

    def features(self, scans, rows=1 << 15):
        """``(N, P)`` scans -> ``(N, P, D)`` features, in blocks of
        ``rows`` cutouts."""
        cut = cutout(scans, self.phi, **self.cut_kw)
        feats = torch.cat([self.backbone(cut[i:i + rows])
                           for i in range(0, cut.shape[0], rows)])
        return feats.reshape(scans.shape[0], scans.shape[1], -1)

    def heads(self, templates, rows=1 << 15):
        """``(N, P, D)`` -> (class logits ``(N, P)``, votes ``(N, P, 2)``)."""
        flat = templates.reshape(-1, templates.shape[-1])
        outs = [self.head(flat[i:i + rows])
                for i in range(0, flat.shape[0], rows)]
        cls = torch.cat([o[0] for o in outs]).reshape(templates.shape[:2])
        reg = torch.cat([o[1] for o in outs]).reshape(
            *templates.shape[:2], 2)
        return cls, reg

    # ---- per scan
    def embedding(self, f):
        sd, g = self.sd, self.det + "gate."
        e = f @ sd[g + "embed.weight"].t() + sd[g + "embed.bias"]
        return F.leaky_relu(batch_norm(sd, g + "embed_bn", e, -1, self.fit),
                            SLOPE)

    def gate(self, x, template, boot):
        """One step of ``(S, P, D)`` features against the templates;
        streams where ``boot (S,)`` is True start from their features.
        Returns (new templates, similarity band ``(S, P, w)``)."""
        if template is None:
            template = x
        else:
            template = torch.where(boot[:, None, None], x, template)
        p, hw = x.shape[1], self.window // 2
        off = torch.arange(-hw, hw + 1, device=x.device)
        nb = torch.arange(p, device=x.device)[:, None] + off  # (P, w)
        inside = (nb >= 0) & (nb < p)
        nb = torch.clamp(nb, 0, p - 1)
        ex, et = self.embedding(x), self.embedding(template)
        sim = (ex[:, :, None, :] * et[:, nb]).sum(-1)  # (S, P, w)
        attn = torch.softmax(sim.masked_fill(~inside, -math.inf), dim=-1)
        mixed = torch.zeros_like(template)
        for k in range(self.window):
            mixed += attn[..., k:k + 1] * template[:, nb[:, k]]
        new = self.alpha * x + (1.0 - self.alpha) * mixed
        new = torch.where(boot[:, None, None], x, new)
        return _q_act(self.quant, "template", new), sim

    def flow_head(self, sim, scans):
        """Band ``(S, P, w)`` and ranges ``(S, P)`` -> sensor-frame flow
        ``(S, P, 2)``."""
        y = torch.cat([sim, scans[..., None]], dim=-1).transpose(1, 2)
        for name in ("flow_conv1", "flow_conv2", "flow_conv3", "flow_out"):
            y = conv_block(self.sd, name, y, fit=self.fit)
        fx, fy = y[:, 0], y[:, 1]
        phi = torch.as_tensor(self.phi, dtype=torch.float32, device=y.device)
        c, s = torch.cos(phi), torch.sin(phi)
        return torch.stack((c * fx + s * fy, -s * fx + c * fy), dim=-1)


def run_streams(ref: Reference, scans, boot, block=8, on_block=None):
    """Drive ``ref`` through ``T`` steps of ``S`` streams: ``scans (T, S,
    P)`` (a host or device tensor), ``boot (T, S)`` bool (step 0 must boot
    every stream). Calls ``on_block(t0, outputs)`` with each block of
    ``block`` steps: ``{"pred_cls" (n, S, P) probabilities, "cls_logit"
    (their logits), "pred_reg" (n, S, P, 2), "pred_flow" (FlowDROW)}``,
    float32 on the device."""
    dev = torch.device(ref.sd[next(iter(ref.sd))].device)
    boot = torch.as_tensor(np.asarray(boot), dtype=torch.bool)
    if not bool(boot[0].all()):
        raise ValueError("the first step must start every stream")
    template = None
    with torch.inference_mode(), full_f32():
        for t0 in range(0, scans.shape[0], block):
            sc = torch.as_tensor(scans[t0:t0 + block]).to(dev, torch.float32)
            n, s, p = sc.shape
            feats = ref.features(sc.reshape(n * s, p)).reshape(n, s, p, -1)
            temps, sims = [], []
            for i in range(n):
                template, sim = ref.gate(feats[i], template,
                                         boot[t0 + i].to(dev))
                temps.append(template)
                sims.append(sim)
            del feats
            cls, reg = ref.heads(torch.stack(temps).reshape(n * s, p, -1))
            out = {"pred_cls": torch.sigmoid(cls).reshape(n, s, p),
                   "cls_logit": cls.reshape(n, s, p),
                   "pred_reg": reg.reshape(n, s, p, 2)}
            if ref.flow:
                out["pred_flow"] = ref.flow_head(
                    torch.stack(sims).reshape(n * s, p, -1),
                    sc.reshape(n * s, p)).reshape(n, s, p, 2)
            del temps, sims
            on_block(t0, out)


def fit_batch_norm(sd, cfg, scans):
    """Set every BatchNorm's running statistics in ``sd`` (in place) to
    those of its own input when the model bootstraps on ``scans (N, P)``,
    layer after layer: the statistics a trained model holds for its data,
    so every layer's output is on the scale the next one expects whatever
    the seed. The reference and the program then load the same ``sd``."""
    ref = Reference(sd, cfg)
    ref.sd = sd  # the float32 leaves themselves, written in place
    ref.fit = True
    with torch.inference_mode(), full_f32():
        x = torch.as_tensor(scans, dtype=torch.float32).to(
            sd[next(iter(sd))].device)
        feats = ref.features(x)
        template, sim = ref.gate(feats, None, torch.ones(
            x.shape[0], dtype=torch.bool, device=x.device))
        ref.heads(template)
        if ref.flow:
            ref.flow_head(sim, x)
