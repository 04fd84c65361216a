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

Arithmetic: the f32 steps follow what the JAX kernel computes on XLA's CPU
backend, the reference of the tests: divisions by compile-time constants
(``c - 1``, ``angle_inc``, ``window_depth``) become multiplies by the f32
reciprocal, the index and lerp multiply-adds are fused (one rounding), and
the area-mode band sum differences XLA's f32 prefix sum (:func:`prefix_sum`).
The int8 engine amplifies a one-ulp change of a tap index near beam 450 (a
frac change of ~3e-5, times a range step of up to ~20 m) into int8 flips,
so the cutouts must agree to the bit, not to 1e-3.

Bound on the H100: bytes. It reads 4 B and writes ``4*C`` B per beam (0.23
KB at C=56), 11.7 us of HBM time at B=384 and 456 beams a stream. The
kernel gives a block :data:`CUTOUT_TILE` beams of one stream; it stages the
window of ranges its taps reach (:func:`cutout_geometry`) and, in area mode,
their prefix sums in XLA's order, computes each beam's geometry once, runs a
warp a beam over the taps and writes the tile's contiguous outputs with one
bulk copy.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from planar_optical_flow_tpu_torch.ops.kernels import _build


def div_f32(a, b):
    """``a / b`` as one IEEE f32 division, as the CUDA kernels divide
    (``__fdiv_rn``). PyTorch on CUDA turns a division by a Python scalar
    into a multiply by its reciprocal (and ``scalar / tensor`` into
    ``reciprocal * scalar``); dividing by a 0-dim tensor on the same device
    keeps the single rounding."""
    dev = b.device if torch.is_tensor(b) else a.device
    if not torch.is_tensor(a):
        a = torch.tensor(a, dtype=torch.float32, device=dev)
    if not torch.is_tensor(b):
        b = torch.tensor(b, dtype=torch.float32, device=dev)
    return torch.div(a, b)


def recip(x: float) -> float:
    """``1 / x`` rounded to f32: the constant XLA multiplies by where the JAX
    kernel divides by a compile-time constant."""
    return float(np.float32(1.0) / np.float32(x))


def _fma(a, b, c):
    """``a * b + c`` rounded once to f32 (XLA contracts the JAX kernel's
    multiply-adds): the f32 product is exact in float64."""
    if not torch.is_tensor(b):
        b = torch.tensor(b, dtype=torch.float32, device=a.device)
    return (a.double() * b.double() + c.double()).float()


SCAN_BASE = 16


def prefix_sum(x):
    """Inclusive f32 prefix sum over the last axis in the order XLA's CPU
    backend computes ``jnp.cumsum``: sequential within rows of 16, the row
    totals scanned the same way (recursively), then each row's offset
    added."""
    n = x.shape[-1]
    if n <= SCAN_BASE:
        out = torch.empty_like(x)
        acc = torch.zeros_like(x[..., 0])
        for i in range(n):
            acc = acc + x[..., i]
            out[..., i] = acc
        return out
    m = -(-n // SCAN_BASE) * SCAN_BASE
    rows = torch.nn.functional.pad(x, (0, m - n)).reshape(
        *x.shape[:-1], m // SCAN_BASE, SCAN_BASE)
    inner = prefix_sum(rows)
    offsets = prefix_sum(inner[..., -1])
    offsets = torch.cat([torch.zeros_like(offsets[..., :1]),
                         offsets[..., :-1]], dim=-1)
    return (inner + offsets[..., None]).reshape(*x.shape[:-1], m)[..., :n]


def _tap_indices(p: int, c: int, half_alpha, angle_inc: float):
    """``(B, P, C)`` fractional beam indices ``p + (k * delta - half_alpha)
    / angle_inc`` with ``delta = 2 * half_alpha / (c - 1)``, in XLA's
    arithmetic: constant divisors as reciprocal multiplies, the two
    multiply-adds fused."""
    dev = half_alpha.device
    taps = torch.arange(c, dtype=torch.float32, device=dev)
    pidx = torch.arange(p, dtype=torch.float32, device=dev)[None, :, None]
    delta = (2.0 * half_alpha) * recip(c - 1)
    off = _fma(taps, delta[..., None], -half_alpha[..., None])
    return _fma(off, recip(angle_inc), pidx)


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
    half_alpha = torch.atan(div_f32(0.5 * window_width,
                                 torch.clamp(scans, min=1e-2)))
    inds = _tap_indices(p, c, half_alpha, angle_inc)
    outbound = (inds < 0) | (inds > p_valid - 1)
    low = torch.clamp(torch.floor(inds), 0, p_valid - 1).long()
    high = torch.clamp(low + 1, 0, p_valid - 1)
    frac = torch.clamp(inds - low.float(), 0.0, 1.0)

    def gather(table, idx):
        return torch.gather(table, 1, idx.reshape(b, -1)).reshape(idx.shape)

    ct_low = gather(scans, low)
    ct = _fma(frac, gather(scans, high) - ct_low, ct_low)
    if area_mode:
        span = inds[..., c - 1:c] - inds[..., 0:1]
        tap_w = span * recip(c - 1)
        a_lo = torch.round(torch.clamp(inds - 0.5 * tap_w, 0, p_valid - 1)
                           ).long()
        a_hi = torch.round(torch.clamp(inds + 0.5 * tap_w, 0, p_valid - 1)
                           ).long()
        a_hi = torch.maximum(a_hi, a_lo)
        csum = prefix_sum(scans)
        csum = torch.cat([torch.zeros_like(csum[:, :1]), csum], dim=1)
        band = gather(csum, a_hi + 1) - gather(csum, a_lo)
        ct_area = band / (a_hi - a_lo + 1).float()
        ct = torch.where(span > c, ct_area, ct)
    ct = torch.where(outbound, torch.full_like(ct, padding_val), ct)
    ct = torch.minimum(torch.maximum(ct, dists - window_depth),
                       dists + window_depth)
    if centered:
        ct = (ct - dists) * recip(window_depth)
    return ct.reshape(b * p, c)


CUTOUT_TILE = 128  # beams a block (csrc/cutout.cu kCutoutTile)
SCAN_MAX_BEAMS = SCAN_BASE ** 4  # the prefix sum's levels (cutout.cuh)


def _round4(n: int) -> int:
    return (n + 3) & ~3


def cutout_reach(p: int, c: int, window_width: float = 1.0,
                 angle_inc: float = math.radians(0.5)) -> int:
    """Beams beyond beam i that a tap of beam i may read, either side,
    capped at ``p`` (``csrc/cutout.cu cutout_reach``): the widest half-window
    ``atan(half_width / 0.01)`` over the beam step, an area band's half width
    on top, and a margin for the f32 rounding of the index and the band's
    ``rint``."""
    half_width = float(np.float32(0.5) * np.float32(window_width))
    reach = (math.atan(abs(half_width) / float(np.float32(1e-2)))
             * abs(recip(angle_inc)))
    r = math.ceil(reach * (1.0 + 1.0 / (c - 1)) * (1.0 + 1e-5)) + 4.0
    return int(r) if r < p else p


def cutout_geometry(p: int, c: int, window_width: float = 1.0,
                    angle_inc: float = math.radians(0.5)):
    """K1's launch at ``p`` beams a stream and ``c`` taps, as
    ``csrc/cutout.cu cutout_geometry`` computes it: ``(beams a tile, tiles a
    stream, reach, dynamic shared memory in bytes)``. The shared memory holds
    the tile's outputs (shifted by up to 3 floats to their 16-byte
    alignment), each beam's geometry (8 floats), the window of ranges and
    prefix sums the tile reads (at most ``CUTOUT_TILE + 2 * reach + 16``
    beams, capped at ``p``) and the prefix sum's row totals with the levels
    above them."""
    reach = cutout_reach(p, c, window_width, angle_inc)
    window = _round4(min(p, CUTOUT_TILE + 2 * reach + 16))
    n1 = -(-p // SCAN_BASE)
    totals = n1 + (n1 + SCAN_BASE - 2) // (SCAN_BASE - 1) + 4
    floats = (_round4(CUTOUT_TILE * c + 3) + CUTOUT_TILE * 8 + 2 * window + 4
              + totals)
    return CUTOUT_TILE, -(-p // CUTOUT_TILE), reach, 4 * floats


@functools.cache
def _lib():
    """The K1 library, its entries' signatures set once."""
    lib = _build.load("cutout")
    lib.cutout_launch.restype = ctypes.c_int
    lib.cutout_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
        + [ctypes.c_float] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.cutout_half_alpha_launch.restype = ctypes.c_int
    lib.cutout_half_alpha_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_void_p]
    lib.cutout_geometry.restype = ctypes.c_int
    lib.cutout_geometry.argtypes = [ctypes.c_int] * 2 + [ctypes.c_float] * 2 \
        + [ctypes.c_void_p] * 4
    return lib


@functools.lru_cache(maxsize=64)
def _launch_consts(c, window_width, window_depth, padding_val, centered,
                   area_mode, angle_inc):
    """The launch's arguments after ``p_valid``: the options and the three
    f32 reciprocals, computed once a configuration."""
    return (c, window_width, window_depth, padding_val, recip(c - 1),
            recip(angle_inc), recip(window_depth), int(centered),
            int(area_mode))


def half_alpha_probe(scans, window_width: float = 1.0):
    """The half-window angle of every range of ``scans`` as K1 computes it
    (``atanf`` on the card), for checks that hold K1 against another
    implementation of ``atan``. A CPU tensor gets :func:`cutout_plain`'s."""
    if scans.device.type == "cpu":
        return torch.atan(div_f32(0.5 * window_width,
                                  torch.clamp(scans.float(), min=1e-2)))
    if scans.dtype != torch.float32:
        raise ValueError(f"half_alpha_probe: need float32, got {scans.dtype}")
    scans = scans.contiguous()
    out = torch.empty_like(scans)
    _build.check(_lib().cutout_half_alpha_launch(
        scans.data_ptr(), out.data_ptr(), scans.numel(), window_width,
        _build.stream_ptr(scans.device)), "cutout_half_alpha")
    return out


def cutout(scans, *, num_cutout_pts: int = 56, window_width: float = 1.0,
           window_depth: float = 0.5, padding_val: float = 29.99,
           centered: bool = True, area_mode: bool = True,
           angle_inc: float = math.radians(0.5), p_valid: int | None = None):
    """``(B, P)`` f32 scans -> ``(B*P, C)`` f32 cutouts.

    ``p_valid``: the real beam count when the scan is padded (beams from
    ``p_valid`` on are treated as out of range). A CUDA tensor launches the
    kernel (``P`` up to 16^4); a CPU tensor runs :func:`cutout_plain`.
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
    if p > SCAN_MAX_BEAMS:
        raise ValueError(f"cutout: {p} beams a stream, more than the "
                         f"{SCAN_MAX_BEAMS} the prefix sum takes")
    out = torch.empty(b * p, num_cutout_pts, dtype=torch.float32,
                      device=scans.device)
    consts = _launch_consts(num_cutout_pts, window_width, window_depth,
                            padding_val, centered, area_mode, angle_inc)
    _build.check(_lib().cutout_launch(
        scans.data_ptr(), out.data_ptr(), b, p, p_valid, *consts,
        _build.stream_ptr(scans.device)), "cutout")
    cutout.launches += 1
    return out


cutout.launches = 0
