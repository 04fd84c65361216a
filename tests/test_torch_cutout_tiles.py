"""K1 (``csrc/cutout.cu`` ``cutout_kernel``), its block emulated in torch
on the CPU in the kernel's order.

* A block takes ``cutout_geometry(p, c)[0]`` beams of one stream, ``i0 ..
  i0 + nv - 1`` (the last tile of a stream may be shorter). It stages the
  ranges of the window ``[ws, we)`` its taps read: ``lo = clamp(i0 -
  reach, 0, p_valid - 1)``, ``we = min(i0 + nv - 1 + reach, p_valid - 1) +
  1``, ``ws`` = ``max(lo - 1, 0)`` rounded down to a multiple of 16.
* Area mode: the prefix sum, each row of 16 summed in order (the
  window's rows keep their running sums, the rows before the window give
  only their totals), the row totals scanned in ``scan_xla``'s order; a
  tap's sum of the beams ``< j`` is the running sum of beam ``j - 1`` plus
  its row's offset, added as ``scan_xla`` adds it (row 0 none).
* Each beam's geometry once (``beam_geometry``), then its taps
  (``beam_tap``), every read inside the staged window (asserted); the lerp
  reads its upper beam at ``low + 1``, the window holding the last valid
  beam once more where it ends at ``p_valid`` (a NaN elsewhere, which a
  read would show).
* The tile's outputs are one contiguous span of the output, written as a
  head, 16-byte words and a tail at the span's alignment (every float once,
  asserted).

The emulation equals ``cutout_plain`` to the bit; both hold JAX's
``cutout_fused`` (interpret mode) at ``CUT_TOL``; the launch's shared
memory fits the card's up to the 16^4 beams the prefix sum takes.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.ops.pallas.cutout_kernel import cutout_fused
from planar_optical_flow_tpu_torch.ops.kernels import cutout_kernel as ck
from planar_optical_flow_tpu_torch.ops.kernels.int8_tiles import SMEM_MAX

CUT_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_cutout_kernel.py
BASE = ck.SCAN_BASE


def _scan_xla(v):
    """Inclusive f32 prefix sum of the 1-D ``v`` by ``scan_xla``'s loops
    (rows of 16 in order, the row totals the same way, each row's offset
    added)."""
    levels = [v.astype(np.float32).copy()]
    while levels[-1].size > BASE and len(levels) <= 4:
        cur = levels[-1]
        rows = -(-cur.size // BASE)
        tot = np.zeros(rows, np.float32)
        for r in range(rows):
            acc = np.float32(0.0)
            for i in range(r * BASE, min(r * BASE + BASE, cur.size)):
                acc = np.float32(acc + cur[i])
                cur[i] = acc
            tot[r] = acc
        levels.append(tot)
    acc = np.float32(0.0)
    for i in range(levels[-1].size):
        acc = np.float32(acc + levels[-1][i])
        levels[-1][i] = acc
    for k in reversed(range(len(levels) - 1)):
        cur, up = levels[k], levels[k + 1]
        for i in range(BASE, cur.size):
            cur[i] = np.float32(cur[i] + up[i // BASE - 1])
    return levels[0]


def _window_prefix(scan, ws, we):
    """(``cs_w``, ``tot``) as the block stages them: ``cs_w[1 + m]`` the
    running sum of beam ``ws + m`` in its row of 16 (``cs_w[0]`` the 0 at
    index -1), ``tot`` the row totals after ``scan_xla``'s levels."""
    n1 = -(-we // BASE)
    rows = np.zeros((n1, BASE), np.float32)
    rows.reshape(-1)[:we] = scan[:we].astype(np.float32)  # zeros after we
    inner = np.zeros_like(rows)
    acc = np.zeros(n1, np.float32)
    for u in range(BASE):
        acc = (acc + rows[:, u]).astype(np.float32)
        inner[:, u] = acc
    cs_w = np.concatenate([[np.float32(0.0)], inner.reshape(-1)[ws:we]])
    return cs_w.astype(np.float32), _scan_xla(acc)


def _prefix_at(cs_w, tot, ws, j):
    """The sums of beams ``< j`` (a tensor of indices) from the staged
    window, as ``window_prefix`` reads them."""
    q = j - 1
    assert int(q.min()) - ws >= (-1 if ws == 0 else 0), (int(q.min()), ws)
    assert int(q.max()) - ws < cs_w.numel() - 1
    v = cs_w[q - ws + 1]
    off = tot[torch.clamp(q // BASE - 1, min=0)]
    return torch.where(q >= BASE, v + off, v)


def _store_split(h, n):
    """The tile's store: (head, [qa, qe) 16-byte words, tail) of the span
    ``[h, h + n)`` of staged floats."""
    qa = min(-(-h // 4) * 4, h + n)
    qe = max((h + n) & ~3, qa)
    return range(h, qa), range(qa, qe), range(qe, h + n)


def emulate(scans, *, num_cutout_pts, window_width, window_depth,
            padding_val, centered, area_mode, angle_inc, p_valid=None):
    """K1's blocks on the CPU: ``(B, P)`` f32 scans -> ``(B*P, C)``."""
    b, p = scans.shape
    c = num_cutout_pts
    pv = p_valid or p
    tile, tiles, reach, _ = ck.cutout_geometry(p, c, window_width, angle_inc)
    scans = scans.float()
    inv_c1, inv_angle = ck.recip(c - 1), ck.recip(angle_inc)
    hi_idx = float(pv - 1)
    out = torch.full((b * p * c,), float("nan"))
    written = torch.zeros(b * p * c, dtype=torch.int32)
    for s_i in range(b):
        scan = scans[s_i]
        for t in range(tiles):
            i0 = t * tile
            nv = min(tile, p - i0)
            lo = max(0, min(i0 - reach, pv - 1))
            we = min(i0 + nv - 1 + reach, pv - 1) + 1
            ws = (max(lo - 1, 0) // BASE) * BASE
            # the window, and the last valid beam once more where it ends
            # the window (the lerp's upper beam reads low + 1)
            r_w = torch.cat([scan[ws:we], scan[we - 1:we] if we == pv
                             else torch.full((1,), float("nan"))])
            cs_w, tot = (torch.from_numpy(a) for a in
                         _window_prefix(scan.numpy(), ws, we))

            def read(table, idx):
                assert int(idx.min()) >= ws, (i0, int(idx.min()), ws)
                assert int(idx.max()) - ws < table.numel(), (i0, we)
                return table[idx - ws]

            # each beam's geometry once: (nv, 1) columns
            i = torch.arange(i0, i0 + nv)
            dist = scan[i0:i0 + nv]
            ha = ck.half_alpha_probe(dist, window_width)
            fi = i.float()
            delta = (2.0 * ha) * inv_c1

            def tap_at(k):
                return ck._fma(ck._fma(k, delta[:, None], -ha[:, None]),
                               inv_angle, fi[:, None])

            span = (tap_at(torch.tensor([float(c - 1)]))
                    - tap_at(torch.tensor([0.0])))
            area = (span > c) if area_mode else torch.zeros_like(span,
                                                                 dtype=bool)
            half_tap = 0.5 * (span * inv_c1)
            # the taps
            ind = tap_at(torch.arange(c, dtype=torch.float32))
            outbound = (ind < 0) | (ind > hi_idx)
            low = torch.clamp(torch.floor(ind), 0.0, hi_idx).long()
            frac = torch.clamp(ind - low.float(), 0.0, 1.0)
            lo_v = read(r_w, low)
            ct = ck._fma(frac, read(r_w, low + 1) - lo_v, lo_v)
            if bool(area.any()):
                a_lo = torch.round(torch.clamp(ind - half_tap, 0.0, hi_idx))
                a_hi = torch.round(torch.clamp(ind + half_tap, 0.0, hi_idx))
                a_lo, a_hi = a_lo.long(), torch.maximum(a_hi, a_lo).long()
                sel = area.expand_as(ind)
                band = (_prefix_at(cs_w, tot, ws, a_hi[sel] + 1)
                        - _prefix_at(cs_w, tot, ws, a_lo[sel]))
                ct[sel] = band / (a_hi[sel] - a_lo[sel] + 1).float()
            ct = torch.where(outbound, torch.full_like(ct, padding_val), ct)
            ct = torch.minimum(torch.maximum(ct, (dist - window_depth)[:, None]),
                               (dist + window_depth)[:, None])
            if centered:
                ct = (ct - dist[:, None]) * ck.recip(window_depth)
            # the store: out[s + q - h] for the staged q in [h, h + nv * c)
            s = (s_i * p + i0) * c
            h = s % 4
            staged = ct.reshape(-1)
            for part in _store_split(h, nv * c):
                for q in part:
                    out[s - h + q] = staged[q - h]
                    written[s - h + q] += 1
    assert bool((written == 1).all())
    return out.reshape(b * p, c)


def _scans(b, p, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.3, 28.0, (b, p))
    close = rng.random((b, p)) < 0.2  # beams close enough for area mode
    x[close] = rng.uniform(0.01, 1.5, int(close.sum()))
    return x.astype(np.float32)


# (B, P, p_valid, angle_inc in degrees, window_width): a partial last tile
# with padded beams; the flagship rows (windows cut on both sides) at B=1;
# a coarse beam step (a short reach, windows cut) with a wider window
SHAPES = [(2, 72, 66, 0.5, 1.0), (1, 456, 450, 0.5, 1.0),
          (2, 200, 197, 2.0, 1.6)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"b{s[0]}p{s[1]}")
@pytest.mark.parametrize("c", [7, 18, 56])
@pytest.mark.parametrize("area_mode", [False, True])
def test_tiles_equal_plain(shape, c, area_mode):
    b, p, pv, deg, ww = shape
    scans = torch.from_numpy(_scans(b, p, seed=c + p))
    kw = dict(num_cutout_pts=c, window_width=ww, window_depth=0.5,
              padding_val=29.99, centered=True, area_mode=area_mode,
              angle_inc=math.radians(deg), p_valid=pv)
    got = emulate(scans, **kw)
    ref = ck.cutout_plain(scans, **kw)
    assert torch.equal(got, ref)
    if area_mode and c < 20:  # area beams reached the band path
        assert float((got != ck.cutout_plain(
            scans, **dict(kw, area_mode=False))).float().mean()) > 0.01


@pytest.mark.parametrize("c", [7, 18, 56])
@pytest.mark.parametrize("area_mode", [False, True])
def test_tiles_match_pallas(c, area_mode):
    scans = _scans(2, 72, seed=c)
    kw = dict(num_cutout_pts=c, window_width=1.0, window_depth=0.5,
              padding_val=29.99, centered=True, area_mode=area_mode,
              p_valid=66)
    ref = np.asarray(cutout_fused(jnp.asarray(scans), interpret=True, **kw))
    got = emulate(torch.from_numpy(scans), angle_inc=math.radians(0.5), **kw)
    np.testing.assert_allclose(got.numpy(), ref, **CUT_TOL)
    np.testing.assert_allclose(ck.cutout_plain(torch.from_numpy(scans), **kw)
                               .numpy(), ref, **CUT_TOL)


@pytest.mark.parametrize("c", [2, 7, 18, 56])
@pytest.mark.parametrize("p", [1, 72, 456, 4096, ck.SCAN_MAX_BEAMS])
def test_geometry_fits(c, p):
    tile, tiles, reach, smem = ck.cutout_geometry(p, c)
    assert tile == ck.CUTOUT_TILE and tiles * tile >= p > (tiles - 1) * tile
    assert 4 <= reach <= p or reach == p
    assert smem <= SMEM_MAX
    if p >= 456:  # the window, not the scan, bounds the staged ranges
        assert smem < 64 * 1024


def _scan_xla_lanes(t, n):
    """``scan_xla_lanes`` lane by lane: lane l's sum over its row of 16
    (all 32 lanes one row up to 16 values), the second row plus the top
    level of the first row's total."""
    out = np.zeros(32, np.float32)
    for lane in range(32):
        r0 = lane & ~15 if n > 16 else 0
        acc = np.float32(0.0)
        for u in range(16):
            if r0 + u <= lane and r0 + u < n:
                acc = np.float32(acc + t[r0 + u])
        out[lane] = acc
    if n > 16:
        top0 = np.float32(np.float32(0.0) + out[15])
        out[16:] = (out[16:] + top0).astype(np.float32)
    return out[:n]


@pytest.mark.parametrize("n", [1, 5, 16, 17, 29, 32])
def test_lanes_scan_equals_scan_xla(n):
    """The row totals' levels in registers (up to 32 rows) equal
    ``scan_xla``'s, on values of mixed magnitude where the order shows."""
    rng = np.random.default_rng(n)
    t = (rng.uniform(0.0, 1.0, 32) * 10.0 ** rng.integers(-3, 4, 32)
         ).astype(np.float32)
    np.testing.assert_array_equal(_scan_xla_lanes(t, n), _scan_xla(t[:n]))
    ref = ck.prefix_sum(torch.from_numpy(t[:n])).numpy()
    np.testing.assert_array_equal(_scan_xla(t[:n]), ref)


@pytest.mark.parametrize("h", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [2, 3, 5, 7 * 16, 18 * 5, 56 * 16])
def test_store_split_covers_span(h, n):
    head, mid, tail = _store_split(h, n)
    assert list(head) + list(mid) + list(tail) == list(range(h, h + n))
    assert len(head) <= 3 and len(tail) <= 3
    assert not mid or (mid.start % 4 == 0 and mid.stop % 4 == 0)
