"""K1: the fused per-beam cutout (``csrc/cutout.cu``).

Replaces ``planar_optical_flow_tpu/ops/pallas/cutout_kernel.py``
``cutout_fused`` (math ``cutout_block``, prep ``cutout_prep``): ``(B, P)``
scans -> ``(B*P, C)`` f32 cutouts for ``fixed=True, stride=1``.

Per beam: half-window angle ``atan(0.5*width/max(r, 0.01))``; C taps at
fractional beam indices ``p + (k*delta - half_alpha)/angle_inc`` (the beam
angles cancel on the symmetric grid); lerp between neighbouring beams; in
area mode, where the window spans more than C beams, the mean over the beam
band ``[rint(ind - tap_w/2), rint(ind + tap_w/2)]`` (``rint`` rounds half
to even); taps outside ``[0, p_valid-1]`` take ``padding_val``; clip to
``r +- window_depth``; center and normalise.

Bound on the H100: bytes. It reads 4 B and writes ``4*C`` B per beam (0.23
KB at C=56), a few microseconds of HBM time at B=384; the kernel is one
block per scan with the scan in shared memory, so every tap's gather is a
shared-memory read. The band sum adds up the at most ~8 beams of a band
directly (the JAX kernel differences an f32 prefix sum; the plain version
differences a float64 one; both equal the band sum within f32 rounding).
"""

from __future__ import annotations

import ctypes
import math

import torch

from planar_optical_flow_tpu_torch.ops.kernels import _build


def _div(a, b):
    """``a / b`` as one IEEE f32 division. PyTorch on CUDA turns a division
    by a Python scalar into a multiply by its reciprocal (and ``scalar /
    tensor`` into ``reciprocal * scalar``); dividing by a 0-dim tensor on
    the same device keeps the single rounding the kernel does, so the floor
    and rint decisions of both versions see the same indices."""
    dev = b.device if torch.is_tensor(b) else a.device
    if not torch.is_tensor(a):
        a = torch.tensor(a, dtype=torch.float32, device=dev)
    if not torch.is_tensor(b):
        b = torch.tensor(b, dtype=torch.float32, device=dev)
    return torch.div(a, b)


def _tap_indices(p: int, c: int, half_alpha, angle_inc: float):
    """``(B, P, C)`` fractional beam indices, in the JAX kernel's f32 order."""
    dev = half_alpha.device
    taps = torch.arange(c, dtype=torch.float32, device=dev)
    pidx = torch.arange(p, dtype=torch.float32, device=dev)[None, :, None]
    delta = _div(2.0 * half_alpha, float(c - 1))
    return pidx + _div(taps * delta[..., None] - half_alpha[..., None],
                       angle_inc)


def cutout_plain(scans, *, num_cutout_pts: int, window_width: float,
                 window_depth: float, padding_val: float, centered: bool,
                 area_mode: bool, angle_inc: float = math.radians(0.5),
                 p_valid: int | None = None):
    """Plain PyTorch version of :func:`cutout` (same arguments)."""
    b, p = scans.shape
    c = num_cutout_pts
    p_valid = p_valid or p
    scans = scans.float()
    dists = scans[..., None]
    half_alpha = torch.atan(_div(0.5 * window_width,
                                 torch.clamp(scans, min=1e-2)))
    inds = _tap_indices(p, c, half_alpha, angle_inc)
    outbound = (inds < 0) | (inds > p_valid - 1)
    low = torch.clamp(torch.floor(inds), 0, p_valid - 1).long()
    high = torch.clamp(low + 1, 0, p_valid - 1)
    frac = torch.clamp(inds - low.float(), 0.0, 1.0)

    def gather(table, idx):
        return torch.gather(table, 1, idx.reshape(b, -1)).reshape(idx.shape)

    ct_low = gather(scans, low)
    ct = ct_low + frac * (gather(scans, high) - ct_low)
    if area_mode:
        tap_w = _div(inds[..., c - 1:c] - inds[..., 0:1], float(c - 1))
        a_lo = torch.round(torch.clamp(inds - 0.5 * tap_w, 0, p_valid - 1)
                           ).long()
        a_hi = torch.round(torch.clamp(inds + 0.5 * tap_w, 0, p_valid - 1)
                           ).long()
        a_hi = torch.maximum(a_hi, a_lo)
        csum = torch.cumsum(scans.double(), dim=1)
        csum = torch.cat([torch.zeros_like(csum[:, :1]), csum], dim=1)
        band = (gather(csum, a_hi + 1) - gather(csum, a_lo)).float()
        ct_area = band / (a_hi - a_lo + 1).float()
        span = inds[..., c - 1:c] - inds[..., 0:1]
        ct = torch.where(span > c, ct_area, ct)
    ct = torch.where(outbound, torch.full_like(ct, padding_val), ct)
    ct = torch.minimum(torch.maximum(ct, dists - window_depth),
                       dists + window_depth)
    if centered:
        ct = _div(ct - dists, window_depth)
    return ct.reshape(b * p, c)


def cutout(scans, *, num_cutout_pts: int = 56, window_width: float = 1.0,
           window_depth: float = 0.5, padding_val: float = 29.99,
           centered: bool = True, area_mode: bool = True,
           angle_inc: float = math.radians(0.5), p_valid: int | None = None):
    """``(B, P)`` f32 scans -> ``(B*P, C)`` f32 cutouts.

    ``p_valid``: the real beam count when the scan is padded (beams from
    ``p_valid`` on are treated as out of range). A CUDA tensor launches the
    kernel; a CPU tensor runs :func:`cutout_plain`.
    """
    kw = dict(num_cutout_pts=num_cutout_pts, window_width=window_width,
              window_depth=window_depth, padding_val=padding_val,
              centered=centered, area_mode=area_mode, angle_inc=angle_inc,
              p_valid=p_valid)
    if scans.device.type == "cpu":
        return cutout_plain(scans, **kw)
    if scans.device.type != "cuda":
        raise ValueError(f"cutout: unsupported device {scans.device}")
    if scans.dtype != torch.float32 or scans.ndim != 2:
        raise ValueError(f"cutout: need (B, P) float32, got "
                         f"{tuple(scans.shape)} {scans.dtype}")
    if num_cutout_pts < 2:
        raise ValueError("cutout: num_cutout_pts must be >= 2")
    scans = scans.contiguous()
    b, p = scans.shape
    p_valid = p_valid or p
    if not 0 < p_valid <= p:
        raise ValueError(f"cutout: p_valid {p_valid} not in (0, {p}]")
    out = torch.empty(b * p, num_cutout_pts, dtype=torch.float32,
                      device=scans.device)
    lib = _build.load("cutout")
    fn = lib.cutout_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_float] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    _build.check(fn(scans.data_ptr(), out.data_ptr(), b, p, p_valid,
                    num_cutout_pts, window_width, window_depth, padding_val,
                    angle_inc, int(centered), int(area_mode),
                    _build.stream_ptr(scans.device)), "cutout")
    cutout.launches += 1
    return out


cutout.launches = 0
