"""K8's and K12's blocks (``csrc/conv_stack_int8.cu``
``backbone_int8_cut_kernel``, ``csrc/serve_cell.cu``), emulated in torch on
the CPU.

* K8: blocks of ``WG_TILE`` = 16 beams of one stream (grid: stream x tile;
  two whole tiles and one of 8 at P = 40, four whole at P = 64), each from
  its own stream's scan alone: the area-mode prefix sum in XLA's order
  (``cutout_kernel.prefix_sum``, which ``cutout.cuh`` ``scan_xla`` computes
  on the card), the block's taps as ``cutout.cuh`` ``cutout_tap`` computes
  them beam by beam, layer 1 with ``1/in_scale`` folded in
  (``layer1_packed<kFold>``'s rounding), the five tail convs on the packed
  tile (``tests/test_torch_int8_tiles.py``'s ``_packed_stack``) and the
  feats rows out at row ``stream * P + beam``; zx is K5's embed on those
  rows. Two streams, ``p_valid < P``, random int8 weights from a numpy
  seed. Equal to ``backbone_int8_cut_plain`` to the bit, on the triples and
  on the weights laid out once.
* K12: blocks of ``CELL_ROWS`` = 16 rows of one stream (two whole tiles
  and one of 8 at ct = 40) from the rows' zx and int8 features: the band's
  attention, the mix of the block's 16 rows on one ``mma.m16n8k32`` tile
  over the staged template (``tests/test_torch_cell_tiles.py``'s
  ``_mix_block``) and the packed head on the new template. Windows 11 and
  21 (one and two k32 steps), ``ct_valid < ct``. Equal to
  ``gate_head_int8_plain`` to the bit, and the head laid out once gives the
  triples' bits.
* The launch geometry of K8 and K12 fits the 232,448 bytes of shared
  memory a block may use at the lengths the port runs.

The plain versions stand against JAX ``fused_backbone_int8_p2cut`` and
``gate_head_fused_int8_pm`` in interpret mode in
``tests/test_torch_int8_fused.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from planar_optical_flow_tpu_torch.infer import fast_gate as fg
from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs
from planar_optical_flow_tpu_torch.ops.kernels import int8_tiles as it
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import (
    _fma,
    div_f32,
    prefix_sum,
    recip,
)
from tests.test_torch_cell_tiles import (
    ALPHA,
    CT,
    CT_VALID,
    D,
    L,
    L4,
    STREAMS,
    _mix_block,
)
from tests.test_torch_int8_tiles import _int8, _packed_stack, _stack

CUT_KW = dict(num_cutout_pts=L, window_width=1.0, window_depth=0.5,
              padding_val=29.99, centered=True, area_mode=True)
ANGLE_INC = float(np.radians(0.5))


def _f32(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(
        np.float32))


def _bf16(rng, *shape, scale=1.0):
    return _f32(rng, *shape, scale=scale).to(torch.bfloat16)


# ------------------------------------------------------------------ K8


def _block_cutouts(r, cs_, i0, nv, p_valid):
    """The f32 cutouts ``(nv, L)`` of beams ``i0 .. i0 + nv - 1`` from their
    stream's ranges ``r (P,)`` and prefix sums ``cs_ (P + 1,)`` (``cs_[j]``
    the sum of beams below j), each tap as ``cutout_tap`` computes it: the
    fractional index with its two multiply-adds fused, the lerp, the band
    mean where the window spans more than L beams, the padding, the clip
    and the centring."""
    c, kw = L, CUT_KW
    hi_idx = float(p_valid - 1)
    i = torch.arange(i0, i0 + nv)
    dist = r[i][:, None]
    ha = torch.atan(div_f32(0.5 * kw["window_width"],
                            torch.clamp(r[i], min=1e-2)))[:, None]
    delta = (2.0 * ha) * recip(c - 1)

    def index(k):  # tap_index(i, k, ha, inv_c1, inv_angle)
        return _fma(_fma(k, delta, -ha), recip(ANGLE_INC),
                    i[:, None].float())

    ind = index(torch.arange(c, dtype=torch.float32)[None, :])
    outbound = (ind < 0) | (ind > hi_idx)
    low = torch.clamp(torch.floor(ind), 0.0, hi_idx).long()
    high = torch.clamp(low + 1, max=p_valid - 1)
    frac = torch.clamp(ind - low.float(), 0.0, 1.0)
    ct = _fma(frac, r[high] - r[low], r[low])
    span = index(torch.full((1, 1), c - 1.0)) - index(torch.zeros(1, 1))
    half_tap = 0.5 * (span * recip(c - 1))
    a_lo = torch.round(torch.clamp(ind - half_tap, 0.0, hi_idx)).long()
    a_hi = torch.maximum(
        torch.round(torch.clamp(ind + half_tap, 0.0, hi_idx)).long(), a_lo)
    band = div_f32(cs_[a_hi + 1] - cs_[a_lo], (a_hi - a_lo + 1).float())
    ct = torch.where(span > c, band, ct)
    ct = torch.where(outbound, torch.full_like(ct, kw["padding_val"]), ct)
    wd = kw["window_depth"]
    ct = torch.minimum(torch.maximum(ct, dist - wd), dist + wd)
    return (ct - dist) * recip(wd)


def emulate_cut(scans, layer1, backbone, embed, p_valid):
    """K8 block by block -> (feats ``(B*P*L/4, 256)`` int8, zx ``(B*P,
    128)`` bf16)."""
    b, p = scans.shape
    feats = torch.empty(b * p, L4 * 256, dtype=torch.int8)
    for s in range(b):
        r = scans[s]
        cs_ = torch.cat([torch.zeros(1), prefix_sum(r)])
        for i0 in range(0, p, it.WG_TILE):
            nv = min(it.WG_TILE, p - i0)
            cut = _block_cutouts(r, cs_, i0, nv, p_valid)
            act1 = cs.backbone_int8_layer1_plain(cut, layer1)
            f = _packed_stack(act1, backbone, (1, 4), True, it.WG_TILE)
            feats[s * p + i0:s * p + i0 + nv] = f.reshape(nv, -1)
    # zx: K5's embed kernel over every row (exact products, summed in
    # float64 as the MMA's f32 chain is in practice), one bias add, bf16
    we_t, be = embed
    zx = ((feats.double() @ we_t.double().t()).float() + be.float()).to(
        torch.bfloat16)
    return feats.reshape(-1, 256), zx


@pytest.mark.parametrize("p,p_valid", [(40, 37), (64, 60)])
def test_cut_block_equals_plain(p, p_valid):
    rng = np.random.default_rng(p)
    scans = torch.from_numpy(rng.uniform(0.5, 20.0, (STREAMS, p)).astype(
        np.float32))
    scans[:, 5] = 0.3  # close beams: windows over many beams (area mode)
    layer1 = (_f32(rng, 3, 64, scale=40.0), _f32(rng, 64, scale=4.0))
    backbone = _stack(rng, cs.BACKBONE_CHANNELS, 5)
    embed = (_bf16(rng, 128, D, scale=0.3 / np.sqrt(D)), _bf16(rng, 128))
    kw = dict(CUT_KW, p_valid=p_valid)
    got = emulate_cut(scans, layer1, backbone, embed, p_valid)
    ref = cs.backbone_int8_cut_plain(scans, layer1, backbone, embed, **kw)
    for g, r, what in zip(got, ref, ("feats", "zx")):
        assert g.dtype == r.dtype and torch.equal(g, r), what
    # the run went through the int8 range, and area mode took the band mean
    assert int(got[0].abs().max()) > 60
    ha = torch.atan(0.5 / scans.clamp(min=1e-2))
    assert bool((2 * ha / ANGLE_INC > L).any())
    laid = cs.backbone_int8_cut(scans, layer1,
                                cs.backbone_weights_int8(backbone), embed,
                                **kw)
    assert all(torch.equal(a, b) for a, b in zip(laid, ref))


# ------------------------------------------------------------------ K12


def emulate_gate_head(zx, zt, x, tmpl, head, head_w, kw):
    """K12 block by block -> (new_t, new_z, sim, cls, reg)."""
    wc, bc, wr, br = head_w
    window = kw["window_size"]
    n = STREAMS * CT
    # the band's attention: one row at a time in the kernel, the same
    # arithmetic over all rows here
    attn, _, _ = fg._attention(zx, zt, ct=CT, ct_valid=CT_VALID,
                               window_size=window)
    q = torch.clamp(torch.round(attn * 127.0), -127, 127).to(torch.int32)
    _, new_z, sim = fg.gate_int8_plain(zx, zt, x, tmpl, **kw)
    new_t = torch.empty(n, D, dtype=torch.int8)
    t3 = tmpl.reshape(STREAMS, CT, D)
    cls, reg = torch.empty(n, 1), torch.empty(n, 2)
    for s in range(STREAMS):
        for i0 in range(0, CT, it.CELL_ROWS):
            nv = min(it.CELL_ROWS, CT - i0)
            r0 = s * CT + i0
            q16 = torch.zeros(16, window, dtype=torch.int32)
            q16[:nv] = q[s, i0:i0 + nv]
            x16 = torch.zeros(16, D, dtype=torch.int8)
            x16[:nv] = x[r0:r0 + nv]
            t_new = _mix_block(q16, x16, t3[s], i0, nv, window, kw)
            new_t[r0:r0 + nv] = t_new
            y = _packed_stack(t_new.reshape(nv, L4, 256), head, (2,), False,
                              it.WG_TILE)  # (nv, L/8, 128) f32
            acc = y[:, 0]
            for pos in range(1, y.shape[1]):
                acc = acc + y[:, pos]
            mean = div_f32(acc, float(y.shape[1])).to(torch.bfloat16)
            cls[r0:r0 + nv] = (mean.double() @ wc.double()).float() + bc
            reg[r0:r0 + nv] = (mean.double() @ wr.double()).float() + br
    return new_t, new_z, sim, cls, reg


@pytest.mark.parametrize("window", [11, 21])
def test_gate_head_block_equals_plain(window):
    rng = np.random.default_rng(120 + window)
    n = STREAMS * CT
    zx, zt = _bf16(rng, n, 128, scale=0.5), _bf16(rng, n, 128, scale=0.5)
    x, tmpl = _int8(rng, n, D), _int8(rng, n, D)
    head = _stack(rng, cs.HEAD_CHANNELS, 5)
    w, s, b = head[-1]  # the last conv is dequantized: f32 units
    head[-1] = (w, s * 0.05, b * 0.05)
    head_w = (_bf16(rng, 128, 1, scale=0.1), _f32(rng, 1),
              _bf16(rng, 128, 2, scale=0.1), _f32(rng, 2))
    kw = dict(ct=CT, ct_valid=CT_VALID, alpha=ALPHA, window_size=window,
              s_x=0.11, s_t=0.17, s_out=0.13)
    got = emulate_gate_head(zx, zt, x, tmpl, head, head_w, kw)
    ref = fg.gate_head_int8_plain(zx, zt, x, tmpl, head, head_w,
                                  num_classes=1, l4=L4, **kw)
    for g, r, what in zip(got, ref, ("new_t", "new_z", "sim", "cls",
                                     "reg")):
        assert g.dtype == r.dtype and torch.equal(g, r), what
    # the band mixed neighbours into the template
    assert int((ref[0] != x).float().mean() * 100) > 10
    laid = fg.gate_head_int8(zx, zt, x, tmpl, cs.head_weights_int8(head),
                             head_w, num_classes=1, l4=L4, **kw)
    assert all(torch.equal(a, b) for a, b in zip(laid, ref))


# ------------------------------------------------------------ geometry


@pytest.mark.parametrize("l", [16, 56])
def test_fused_geometry(l):
    """K8 at P = 64, 456 and 480 beams a stream and K12 at l/4 positions:
    16 cutouts a block within the card's shared memory; the flagship
    blocks' bytes."""
    for p in (64, 456, 480):
        tile, rows, smem = it.cut_geometry(l, p)
        assert (tile, rows) == (16, l + 2) and smem <= it.SMEM_MAX
        assert smem > it.backbone_geometry(l, 0)[2]  # the scan's floats
    tile, rows, smem = it.gate_head_geometry(l // 4)
    assert (tile, rows) == (16, l // 4 + 2) and smem <= it.SMEM_MAX
    if l == 56:
        assert it.cut_geometry(56, 456)[2] == 208656
        assert it.gate_head_geometry(14)[2] == 217088
        # 456 rows a stream: 28 whole blocks and one of 8
        assert -(-456 // tile) == 29 and 456 - 28 * tile == 8


def test_gate_head_geometry_shrinks_the_block():
    """Every even l/4 the head takes (2-32) gets a K12 block that fits."""
    for l4 in range(2, 33, 2):
        tile, _, smem = it.gate_head_geometry(l4)
        assert smem <= it.SMEM_MAX and tile in (16, 8, 4)
