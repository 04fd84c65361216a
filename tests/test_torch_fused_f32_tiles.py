"""The host side and the arithmetic of K14 in f32 (``csrc/fused_f32.cu``,
split-bf16 wgmma on tight packed tiles), on the CPU.

* The weights' split and chunk layout (``int8_tiles.plan_weights_f32``) of
  every backbone and head conv inverts to bf16 hi and lo of ``fold``'s
  ``(3*Cin, Cout)`` weights, whose sum holds the f32 weight to 2^-16, each
  chunk (hi, then lo) within a ring stage.
* A plain emulation of the kernels' arithmetic: each conv over blocks of
  cutouts in a tight channel-block-major tile (the rows past the last
  channel block NaN, so that a kept row that read them would show), the A
  rows of 64-row tiles, every operand split into bf16 hi = bf16(x) and lo =
  bf16(x - hi), the three products hi * hi + hi * lo + lo * hi summed in
  float64 and rounded to f32, the max-pool on the sums, leaky(acc + b) in
  f32; layer 1 per position in f32; the head's mean as a running sum times
  the f32 reciprocal. Through the whole f32 backbone and head at full
  widths it holds to the JAX ``fused_backbone``/``fused_head`` in f32
  (interpret mode) and to the port's plain versions at the JAX test's bar,
  rtol 1e-3 / atol 1e-4 (``tests/test_pallas_fused.py``); one bf16 product
  a conv misses it.
* The launch geometry: 4 cutouts a block and at most 232,448 bytes of
  shared memory at the flagship lengths and the tests'.
* The dense module gate's band and mask are made once per (ct, window,
  device, dtype) and give the same gate outputs.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.ops.pallas import fused_drow as jfd
from planar_optical_flow_tpu_torch.models import spatial_drow as sd
from planar_optical_flow_tpu_torch.ops.kernels import fused_drow as fd
from planar_optical_flow_tpu_torch.ops.kernels import int8_tiles as it
from tests.test_torch_common import flow_drow_pair, t2n

F32 = dict(rtol=1e-3, atol=1e-4)  # tests/test_pallas_fused.py
PLANS = {"backbone": it.FUSED_BACKBONE_F32_PLAN,
         "head": it.FUSED_HEAD_F32_PLAN}


@pytest.fixture(scope="module")
def weights():
    """(port backbone pairs, port head pairs, JAX backbone weights, JAX
    head weights), from the same bridged variables."""
    _, v_np, port = flow_drow_pair(seed=4)
    det = {k: v_np[k]["dr_spaam"] for k in ("params", "batch_stats")}

    def sub(name):
        return {k: det[k][name] for k in ("params", "batch_stats")}

    return (fd.backbone_weights(port.dr_spaam.backbone),
            fd.head_weights(port.dr_spaam.head),
            jfd.backbone_weights(sub("backbone")),
            jfd.head_weights(sub("head")))


@pytest.mark.parametrize("stack", ["backbone", "head"])
def test_f32_weights_invert(stack):
    """``plan_weights_f32`` of ``(3*Cin, Cout)`` f32 weights inverts to
    their bf16 hi and lo; chunk c of pass q holds hi[KC c + 8 blk + e, NS q
    + 8 grp + r] at element 2 NS KC (q NKC + c) + (blk NS / 8 + grp) 64 + 8
    r + e, and lo NS KC further."""
    plan = PLANS[stack]
    rng = np.random.default_rng(60 if stack == "backbone" else 61)
    pairs = [(torch.from_numpy(rng.normal(size=(3 * cin, cout))
                               .astype(np.float32)), torch.zeros(cout))
             for cin, cout, *_ in plan]
    for (w, _), flat, (cin, cout, _, nj, wgn) in zip(
            pairs, it.plan_weights_f32(pairs, plan), plan):
        k, ns = 3 * cin, 64 * nj * wgn
        kc = it.chunk_k_x3(k, ns)
        assert cout % ns == 0 and k % kc == 0 and kc % 16 == 0
        assert 2 * ns * kc * 2 <= it.STAGE_BYTES  # hi and lo fit a stage
        assert flat.dtype == torch.bfloat16 and flat.shape == (2 * cout * k,)
        hi, lo = it.split_bf16(w)
        assert float(((hi.float() + lo.float()) - w).abs().max()) <= (
            2.0 ** -16 * float(w.abs().max()))
        p, g, r, c, blk, e = it._chunk_shape(cout, k, nj, wgn, 2, kc)
        halves = flat.reshape(-1, 2, ns * kc)
        for part, ref in zip(range(2), (hi, lo)):
            back = (halves[:, part].reshape(p, c, blk, g, r, e)
                    .permute(it._CHUNK_ORDER).reshape(cout, k))
            assert torch.equal(back, ref.t())
        for n, kk in zip(rng.integers(0, cout, 32), rng.integers(0, k, 32)):
            q, nn = divmod(int(n), ns)
            grp, row = divmod(nn, 8)
            ch, kr = divmod(int(kk), kc)
            bk, el = divmod(kr, 8)
            at = (2 * ns * kc * (q * (k // kc) + ch)
                  + (bk * (ns // 8) + grp) * 64 + row * 8 + el)
            assert flat[at] == hi[kk, n] and flat[at + ns * kc] == lo[kk, n]


def _split(x):
    """(hi, lo) of f32 ``x`` as the kernel splits it: hi = bf16(x), lo =
    bf16(x - hi), as f32."""
    hi, lo = it.split_bf16(torch.from_numpy(np.ascontiguousarray(
        x, np.float32)))
    return hi.float().numpy(), lo.float().numpy()


def _leaky(y):
    return np.where(y > 0, y, np.float32(0.1) * y).astype(np.float32)


def _tight_conv(x, w, b, tile, pool, split=True):
    """One conv as K14 f32 computes it: ``x (n, L, Cin)``, ``w (3*Cin,
    Cout)``, ``b (Cout,)`` f32 -> ``(n, L or L/2, Cout)`` f32. Without
    ``split``, one bf16 product (hi * hi) instead of three."""
    n, length, cin = x.shape
    s, rows = it.row_stride(length), it.tight_rows(length, tile)
    mt = it.m_tiles(length, tile)
    wh, wl = (a.astype(np.float64) for a in _split(w))
    ch = np.arange(cin)
    outs = []
    for c0 in range(0, n, tile):
        nv = min(tile, n - c0)
        # channel block ch // 8, row r, element ch % 8; the spill NaN
        flat = np.full(rows * cin + (mt * 64 + 2 - rows) * 8, np.nan,
                       np.float32)
        flat[:rows * cin] = 0.0
        for c in range(nv):
            r = c * s + 1 + np.arange(length)
            flat[((ch[None] // 8) * rows + r[:, None]) * 8
                 + ch[None] % 8] = x[c0 + c]
        m = np.arange(mt * 64)
        a = np.concatenate([flat[((ch[None] // 8) * rows + m[:, None] + t)
                                 * 8 + ch[None] % 8] for t in range(3)], 1)
        ah, al = (v.astype(np.float64) for v in _split(a))
        acc = ah @ wh + ((ah @ wl + al @ wh) if split else 0.0)
        acc = acc.astype(np.float32)
        keep = (np.arange(nv)[:, None] * s + np.arange(length)[None])
        if pool:
            acc = np.maximum(acc[keep[:, 0::2]], acc[keep[:, 0::2] + 1])
        else:
            acc = acc[keep]
        assert np.isfinite(acc).all()  # no kept row read the spill
        outs.append(_leaky(acc + b))
    return np.concatenate(outs)


def _np_pairs(pairs):
    return [(t2n(w).reshape(-1, w.shape[-1]), t2n(b)) for w, b in pairs]


def _emulated_backbone(cut, pairs, tile):
    """Layer 1 per position in f32, then the five wgmma convs."""
    (w1, b1), *convs = _np_pairs(pairs)
    x = cut.astype(np.float32)
    xl = np.pad(x, ((0, 0), (1, 0)))[:, :-1, None]
    xr = np.pad(x, ((0, 0), (0, 1)))[:, 1:, None]
    xm = x[..., None]
    acc = xl * w1[0]
    acc = (xm.astype(np.float64) * w1[1] + acc).astype(np.float32)
    acc = (xr.astype(np.float64) * w1[2] + acc).astype(np.float32)
    x = _leaky(acc + b1)
    for i, (w, b) in enumerate(convs):
        x = _tight_conv(x, w, b, tile, i in (1, 4))
    return x


def _emulated_head(feats, pairs, tile, split=True):
    """The five wgmma convs, the running-sum mean times the f32 reciprocal,
    the f32 linears."""
    convs, lin = _np_pairs(pairs[:5]), _np_pairs(pairs[5:])
    x = feats.astype(np.float32)
    for i, (w, b) in enumerate(convs):
        x = _tight_conv(x, w, b, tile, i == 2, split)
    s = x[:, 0]
    for p in range(1, x.shape[1]):
        s = s + x[:, p]
    mean = s * np.float32(1.0 / x.shape[1])
    return tuple((mean.astype(np.float64) @ w + b).astype(np.float32)
                 for w, b in lin)


@pytest.mark.parametrize("length,n", [(56, 6), (24, 5)])
def test_emulated_backbone_holds_the_f32_bar(weights, length, n):
    """A full block of 4 cutouts and a partial one, at the flagship length
    and the JAX test's."""
    bb, _, jbb, _ = weights
    tile = it.fused_backbone_f32_geometry(length)[0]
    assert tile == 4
    cut = np.random.default_rng(length).normal(
        0.0, 0.6, (n, length)).astype(np.float32)
    got = _emulated_backbone(cut, bb, tile)
    ref = np.asarray(jfd.fused_backbone(jnp.asarray(cut), jbb, tile=8,
                                        compute_dtype=jnp.float32,
                                        interpret=True))
    assert got.shape == ref.shape == (n, length // 4, 256)
    np.testing.assert_allclose(got, ref, **F32)
    plain = fd.fused_backbone_plain(torch.from_numpy(cut), bb,
                                    compute_dtype=torch.float32)
    np.testing.assert_allclose(got, t2n(plain), **F32)
    assert np.abs(ref).max() > 0.1  # the stack is not dead


@pytest.mark.parametrize("l4,n", [(14, 6), (6, 5)])
def test_emulated_head_holds_the_f32_bar(weights, l4, n):
    """And one bf16 product a conv (no split) misses the bar."""
    _, hd, _, jhd = weights
    tile = it.fused_head_f32_geometry(l4)[0]
    assert tile == 4
    feats = np.random.default_rng(100 + l4).normal(
        0.0, 0.5, (n, l4, 256)).astype(np.float32)
    got = _emulated_head(feats, hd, tile)
    ref = jfd.fused_head(jnp.asarray(feats), jhd, num_classes=1, tile=8,
                         compute_dtype=jnp.float32, interpret=True)
    plain = fd.fused_head_plain(torch.from_numpy(feats), hd,
                                compute_dtype=torch.float32)
    for g, r, p in zip(got, ref, plain):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, np.asarray(r), **F32)
        np.testing.assert_allclose(g, t2n(p), **F32)
    one = _emulated_head(feats, hd, tile, split=False)
    assert not all(np.allclose(g, np.asarray(r), **F32)
                   for g, r in zip(one, ref))


@pytest.mark.parametrize("l", [16, 56])
def test_f32_geometry(l):
    """4 cutouts a block, both kernels within 232,448 bytes beside the
    4-stage ring; at the flagship the head's 7-position tile pair is 34
    rows a channel block (66 would not fit)."""
    l4 = l // 4
    for geo, length in ((it.fused_backbone_f32_geometry(l), l),
                        (it.fused_head_f32_geometry(l4), l4)):
        tile, rows, smem = geo
        assert (tile, rows) == (4, it.row_stride(length))
        assert smem <= it.SMEM_MAX
    for length in (l, l // 2, l4, l4 // 2):
        # the kept rows' taps (up to row tile * S) inside the rows held
        assert it.tight_rows(length, 4) >= 4 * it.row_stride(length) + 1
        assert it.m_tiles(length, 4) * 64 + 2 >= it.tight_rows(length, 4)
    if l == 56:
        assert it.fused_backbone_f32_geometry(56)[2] == 195072
        assert it.fused_head_f32_geometry(14)[2] == 212992
        assert it.tight_rows(7, 4) == 34 and it.m_tiles(7, 4) == 1
        assert it.fused_head_f32_smem_bytes(14, 8) > it.SMEM_MAX
        untight = it.RING_BYTES + 2 * it.ptile_bytes(7, 2 * 512 * 2, 4)
        assert untight > it.SMEM_MAX


def test_gate_band_made_once():
    """The band and mask are cached per (ct, window, device, dtype), equal
    to the numpy ones, and the gate's outputs match the uncached form."""
    a = sd.band_tensors(12, 5, torch.device("cpu"), torch.float32)
    assert sd.band_tensors(12, 5, torch.device("cpu"), torch.float32) is a
    assert torch.equal(a[0], torch.as_tensor(sd.neighbor_band(12, 5)))
    assert torch.equal(a[1], torch.as_tensor(sd.band_mask(12, 5)))
    b16 = sd.band_tensors(12, 5, torch.device("cpu"), torch.bfloat16)[1]
    assert b16.dtype == torch.bfloat16 and torch.equal(b16.float(), a[1])
    gate = sd.SpatialAttentionGate(24, 0.5, 5,
                                   generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    x, t = (torch.from_numpy(rng.normal(size=(2, 12, 24)).astype(np.float32))
            for _ in range(2))
    with torch.inference_mode():
        new_t, sim_band = gate(x, t)
    sim = torch.einsum("bic,bjc->bij", gate.embedding(x), gate.embedding(t))
    band = torch.as_tensor(sd.neighbor_band(12, 5))
    assert torch.equal(sim_band, torch.gather(sim, 2,
                                              band[None].expand(2, -1, -1)))
    mask = torch.as_tensor(sd.band_mask(12, 5))
    masked = sim - 1e10 * (1.0 - mask)
    e = torch.exp(masked - masked.amax(dim=-1, keepdim=True))
    attn = e / e.sum(dim=-1, keepdim=True) * mask
    attn = attn / torch.clamp(attn.sum(dim=-1, keepdim=True), min=1e-20)
    ref = 0.5 * x + 0.5 * torch.einsum("bij,bjd->bid", attn, t)
    assert torch.equal(new_t, ref)
