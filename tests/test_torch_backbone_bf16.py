"""The bf16 backbone kernel (``csrc/backbone_bf16.cu``: K2 with its layer 1
and K14's bf16 backbone) emulated on the CPU, and its host side
(``int8_tiles.BACKBONE_BF16_PLAN``, ``backbone_bf16_geometry``).

* The block emulated as the kernel lays it out: ``T`` cutouts back to back
  in one packed tile (cutout c's position p in row c * S + 1 + p), layer 1
  written straight into it, each conv's A row m reading rows m, m + 1, m +
  2 over 64-row tiles that span cutouts (rows with p >= L computed and
  dropped), the max-pool pair an even row and the next one of the same
  cutout, each conv writing the real rows of a packed tile of its output
  length whose other rows only ``zero_pads`` fills (by its enumeration;
  every row a tile reads is one or the other), the last conv writing the
  feats rows, the embed over them.
  In each layer-1 form it holds to JAX within the bf16 bar (2e-2 x max):
  K2's (torch's ``backbone_layer1`` rounding) against JAX
  ``backbone_layer1`` + ``fused_backbone_v2(embed_weights=...)`` in
  interpret mode, feats and zx; K14's (taps rounded to bf16, fmaf sums)
  against JAX ``fused_drow.fused_backbone(compute_dtype=bf16)`` in
  interpret mode; both at L = 16 and 56 with a full block and a part.
* K2's layer 1 spelled as the kernel spells it, each f32 operation rounded
  once in the order ((xl * w0 + x * w1) + xr * w2) + b, equals
  ``backbone_layer1`` to the bit: why K2 from the cutouts equals K2 on
  ``backbone_layer1``'s act1.
* ``int8_tiles.wgmma_weights`` round-trips every conv of
  ``BACKBONE_BF16_PLAN``; ``backbone_bf16_geometry(56)`` takes 8 cutouts a
  block within 232,448 bytes.
* ``backbone_bf16`` and ``fused_backbone(bf16)`` on CPU tensors run their
  plain versions (no launch counted), on the pairs and on the laid-out
  weights alike.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.infer import fast_gate as jfg
from planar_optical_flow_tpu.ops.pallas import conv_stack as jcs
from planar_optical_flow_tpu.ops.pallas import fused_drow as jfd
from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs
from planar_optical_flow_tpu_torch.ops.kernels import fold
from planar_optical_flow_tpu_torch.ops.kernels import fused_drow as fd
from planar_optical_flow_tpu_torch.ops.kernels import int8_tiles as it
from tests.test_torch_common import (
    assert_close_to_max,
    flow_drow_pair,
    t2n,
    to_jax,
)

BF16_REL = 2e-2  # x max|ref| (tests/test_fast_gate.py)
POOL_AFTER = (1, 4)  # the convs 64 -> 128 and 128 -> 256 pool


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _leaky(y):
    return torch.where(y > 0, y, 0.1 * y)


def _layer1(cut, w, b, form):
    """Layer 1 of ``cut (n, L)`` f32 -> ``(n, L, 64)`` bf16 values (f32) as
    the kernel computes it: ``"xla"`` (K2) each operation rounded once in
    the order ((xl * w0 + x * w1) + xr * w2) + b; ``"conv3"`` (K14) on the
    taps rounded to bf16 with the weights' bf16 values, xl * w0 and two
    fused multiply-adds (each product exact; the sums here in float64,
    rounded to f32 once each), + b."""
    z = torch.zeros_like(cut[:, :1])
    xl = torch.cat([z, cut[:, :-1]], 1)[..., None]
    xr = torch.cat([cut[:, 1:], z], 1)[..., None]
    x = cut[..., None]
    if form == "xla":
        acc = ((xl * w[0] + x * w[1]) + xr * w[2]) + b
    else:
        xl, x, xr, w = _bf16(xl), _bf16(x), _bf16(xr), _bf16(w)
        s = (xl * w[0]).double() + (x * w[1]).double()
        acc = (s.float().double() + (xr * w[2]).double()).float() + b
    return _bf16(_leaky(acc))


def _pad_rows(length, tile, nv):
    """The rows of a packed tile that the kernel's ``zero_pads`` zeroes, by
    its enumeration: each real cutout's row before and rows after its
    positions, then every row past them up to the last one read."""
    s = it.row_stride(length)
    rows = it.m_tiles(length, tile) * 64 + 2
    p = s - length
    out = []
    for k in range(nv * p + rows - nv * s):
        j = k % p
        out.append((k // p) * s + (length + j if j else 0) if k < nv * p
                   else nv * s + k - nv * p)
    return torch.tensor(out)


def _tile(rows_of, length, chans, tile):
    """A packed tile as the kernel fills it: NaN where nothing is stored,
    the pads zero, cutout c's positions in rows c * S + 1 ...; every row a
    64-row tile reads must have been written."""
    nv, s = rows_of.shape[0], it.row_stride(length)
    x = torch.full((it.m_tiles(length, tile) * 64 + 2, chans), float("nan"))
    x[_pad_rows(length, tile, nv)] = 0.0
    for c in range(nv):
        x[c * s + 1:c * s + 1 + length] = rows_of[c]
    assert not bool(x.isnan().any())
    return x


def _block(act1, convs, l, tile):
    """The five convs of one block on its layer-1 rows ``act1 (nv, l, 64)``
    in packed tiles -> the feats rows ``(nv, l/4, 256)`` (bf16 values),
    which the last conv's epilogue writes to device memory."""
    nv, length = act1.shape[0], l
    x = _tile(act1, length, 64, tile)
    for i, (w, b) in enumerate(convs):
        s = it.row_stride(length)
        rows = it.m_tiles(length, tile) * 64
        a = torch.cat([x[t:t + rows] for t in range(3)], dim=1)
        acc = a @ w.float()  # every row of every 64-row tile
        m = (torch.arange(nv)[:, None] * s
             + torch.arange(length)[None, :])  # (nv, L): row of (c, p)
        if i in POOL_AFTER:
            even = m[:, 0::2]
            assert bool((even % 2 == 0).all())  # a lane quad's rows g, g+1
            acc = torch.maximum(acc[even], acc[even + 1])
            length //= 2
        else:
            acc = acc[m]
        y = _bf16(_leaky(acc + b.float()))
        if i == len(convs) - 1:
            return y
        x = _tile(y, length, w.shape[1], tile)


def _packed_backbone(cut, layer1, convs, l, form, embed=None):
    """The kernel on ``cut (n, l)``, block by block (its geometry's cutouts
    a block): feats ``(n, l/4, 256)`` bf16 values and, with ``embed`` ``(W,
    b)``, zx = bf16(feats_flat @ W + b)."""
    tile = it.backbone_bf16_geometry(l, 0 if form == "xla" else 1)[0]
    w1, b1 = layer1
    feats = torch.cat([
        _block(_layer1(cut[c0:c0 + tile], w1.reshape(3, 64), b1, form),
               convs, l, tile) for c0 in range(0, cut.shape[0], tile)])
    if embed is None:
        return feats
    we, be = embed
    zx = feats.reshape(feats.shape[0], -1) @ we.float() + be.float()
    return feats, _bf16(zx)


def _det_vars(v_np, name):
    return {c: v_np[c]["dr_spaam"][name] for c in ("params", "batch_stats")}


@pytest.mark.parametrize("l", [16, 56])
def test_packed_k2_against_pallas(l):
    """K2 from the cutouts at n = T + 3 (a full block and a part), bridged
    weights: within the bf16 bar of JAX ``backbone_layer1`` +
    ``fused_backbone_v2`` (feats and zx) and of the port's plain version,
    which the port's K2 entry runs on the CPU."""
    _, v_np, port = flow_drow_pair(seed=6, ct_len=l)
    det = port.dr_spaam
    tile = it.backbone_bf16_geometry(l, 0)[0]
    n = tile + 3
    cut = np.random.default_rng(70 + l).normal(0.0, 0.6, (n, l)).astype(
        np.float32)
    layer1, tail = fold.backbone_stack_weights(det.backbone)
    gp = fold.fold_gate_params(det.gate, dtype=torch.bfloat16)
    got = _packed_backbone(torch.from_numpy(cut), layer1, tail, l, "xla",
                           (gp.w, gp.b))

    l1_j, tail_j = jcs.backbone_stack_weights(to_jax(_det_vars(v_np,
                                                               "backbone")))
    gp_j = jfg.fold_gate_params(to_jax(_det_vars(v_np, "gate")), alpha=0.5,
                                window_size=5, dtype=jnp.bfloat16)
    ref = jcs.fused_backbone_v2(
        jcs.backbone_layer1(jnp.asarray(cut), l1_j), tail_j, l=l, tile=16,
        compute_dtype=jnp.bfloat16, conv_mode="3mm",
        embed_weights=(gp_j.w, gp_j.b), interpret=True)
    plain = cs.backbone_bf16(torch.from_numpy(cut), layer1,
                             cs.backbone_weights_bf16(tail), (gp.w, gp.b),
                             l=l)
    for g, r, p, what in zip(got, ref, plain, ("feats", "zx")):
        r = np.asarray(r, np.float32).reshape(t2n(g).shape)
        assert_close_to_max(t2n(g), r, BF16_REL, what)
        assert_close_to_max(t2n(g), t2n(p).reshape(r.shape), BF16_REL, what)
    assert float(got[0].abs().max()) > 0.1


@pytest.mark.parametrize("l", [16, 56])
def test_packed_k14_backbone_against_pallas(l):
    """K14's bf16 backbone at n = T + 3 on the bridged weights: within the
    bf16 bar of JAX ``fused_backbone(compute_dtype=bf16)`` in interpret mode
    and of ``fused_backbone_plain``."""
    _, v_np, port = flow_drow_pair(seed=7)
    w_bb = fd.backbone_weights(port.dr_spaam.backbone)
    jbb = jfd.backbone_weights(_det_vars(v_np, "backbone"))
    layer1 = (w_bb[0][0].reshape(3, 64), w_bb[0][1])
    convs = [(w.reshape(-1, w.shape[-1]).to(torch.bfloat16), b)
             for w, b in w_bb[1:]]
    tile = it.backbone_bf16_geometry(l, 1)[0]
    n = tile + 3
    cut = np.random.default_rng(80 + l).normal(0.0, 0.6, (n, l)).astype(
        np.float32)
    got = _packed_backbone(torch.from_numpy(cut), layer1, convs, l, "conv3")
    ref = np.asarray(jfd.fused_backbone(jnp.asarray(cut), jbb, tile=16,
                                        compute_dtype=jnp.bfloat16,
                                        interpret=True))
    plain = fd.fused_backbone_plain(torch.from_numpy(cut), w_bb,
                                    compute_dtype=torch.bfloat16)
    assert got.shape == plain.shape == ref.shape == (n, l // 4, 256)
    assert_close_to_max(t2n(got), ref, BF16_REL, "feats")
    assert_close_to_max(t2n(got), t2n(plain), BF16_REL, "feats")
    assert float(got.abs().max()) > 0.1


def test_k2_layer1_spelling_is_torchs():
    """K2's layer 1 spelled as the kernel spells it (numpy f32, each
    operation rounded once, no fused multiply-add) equals
    ``backbone_layer1`` to the bit, leaky and bf16 rounding included."""
    rng = np.random.default_rng(90)
    cut = rng.normal(0.0, 3.0, (37, 56)).astype(np.float32)
    w = rng.normal(0.0, 1.0, (3, 1, 64)).astype(np.float32)
    b = rng.normal(0.0, 1.0, 64).astype(np.float32)
    xl = np.concatenate([np.zeros_like(cut[:, :1]), cut[:, :-1]], 1)
    xr = np.concatenate([cut[:, 1:], np.zeros_like(cut[:, :1])], 1)
    wc = w[:, 0]
    acc = np.add(np.add(np.add(np.multiply(xl[..., None], wc[0]),
                               np.multiply(cut[..., None], wc[1])),
                        np.multiply(xr[..., None], wc[2])), b)
    act = np.where(acc > 0, acc, np.multiply(np.float32(0.1), acc))
    ref = torch.from_numpy(act.reshape(-1, 64)).to(torch.bfloat16)
    got = cs.backbone_layer1(torch.from_numpy(cut),
                             (torch.from_numpy(w), torch.from_numpy(b)))
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref)
    assert torch.equal(_layer1(torch.from_numpy(cut),
                               torch.from_numpy(wc), torch.from_numpy(b),
                               "xla").reshape(-1, 64), got.float())


@pytest.mark.parametrize("layer,plan",
                         list(enumerate(it.BACKBONE_BF16_PLAN)),
                         ids=[f"conv{i + 2}"
                              for i in range(len(it.BACKBONE_BF16_PLAN))])
def test_backbone_bf16_weights_invert(layer, plan):
    """``plan_weights_bf16`` of each conv of ``BACKBONE_BF16_PLAN`` inverts
    to its ``(3*Cin, Cout)`` weights; chunk c of pass q holds w[c * KC + 8 *
    blk + e, q * NS + 8 * grp + r] at element ((q * NKC + c) * NS * KC) +
    ((blk * NS / 8 + grp) * 8 + r) * 8 + e, every chunk one ring stage."""
    cin, cout, _, nj, wgn = plan
    k, ns = 3 * cin, 64 * nj * wgn
    kc = it.chunk_k(k, ns, 2)
    assert k % kc == 0 and kc % 16 == 0 and ns * kc * 2 <= it.STAGE_BYTES
    rng = np.random.default_rng(100 + layer)
    w = torch.from_numpy(rng.normal(size=(k, cout)).astype(
        np.float32)).to(torch.bfloat16)
    (flat,) = it.plan_weights_bf16([(w, torch.zeros(cout))], [plan])
    assert flat.dtype == torch.bfloat16 and flat.shape == (cout * k,)
    p, g, r, c, blk, e = it._chunk_shape(cout, k, nj, wgn, 2)
    back = (flat.reshape(p, c, blk, g, r, e).permute(it._CHUNK_ORDER)
            .reshape(cout, k))
    assert torch.equal(back, w.t())
    for n, kk in zip(rng.integers(0, cout, 64), rng.integers(0, k, 64)):
        q, nn = divmod(int(n), ns)
        grp, row = divmod(nn, 8)
        ch, kr = divmod(int(kk), kc)
        bk, el = divmod(kr, 8)
        at = ((q * (k // kc) + ch) * ns * kc
              + ((bk * (ns // 8) + grp) * 8 + row) * 8 + el)
        assert flat[at] == w[kk, n]


@pytest.mark.parametrize("l", [16, 56])
def test_backbone_bf16_geometry(l):
    """The block: the most cutouts (16, halved) whose 4-stage ring, two
    bf16 tile regions and f32 cutouts fit 232,448 bytes; 8 at L = 56,
    where each tile in shared memory is ~64 KB (8 and 4 row tiles; the
    last conv's 2 go to device memory); each plan's accumulators at most
    128 f32 a thread and its chunks one ring stage."""
    for mode in (0, 1, 2):
        tile, rows, smem = it.backbone_bf16_geometry(l, mode)
        assert rows == l + 2 and smem <= it.SMEM_MAX
        assert (it.backbone_bf16_smem_bytes(l, mode, 2 * tile) > it.SMEM_MAX
                or tile == it.WG_TILE)
    if l == 56:
        assert it.backbone_bf16_geometry(56, 0) == (8, 58, 203520)
        assert it.backbone_bf16_geometry(56, 2) == (8, 58, 201728)
        assert [it.m_tiles(n, 8) for n in (56, 28, 14)] == [8, 4, 2]
        for length, cb in ((56, 128), (28, 256)):
            assert 64 * 1024 <= it.ptile_bytes(length, cb, 8) <= 66048
    else:
        assert it.backbone_bf16_geometry(16, 0)[0] == 16
    for cin, cout, mt, nj, wgn in it.BACKBONE_BF16_PLAN:
        ns = 64 * nj * wgn
        assert cout % ns == 0 and mt * nj * 32 <= 128
        assert ns * it.chunk_k(3 * cin, ns, 2) * 2 <= it.STAGE_BYTES
    assert [p[:2] for p in it.BACKBONE_BF16_PLAN] == list(
        zip(cs.BACKBONE_CHANNELS[:-1], cs.BACKBONE_CHANNELS[1:]))


def test_cpu_entries_run_the_plain_versions():
    """On CPU tensors ``backbone_bf16``, ``backbone_tail`` and
    ``fused_backbone(bf16)`` run their plain versions and count no launch,
    on the pairs and on the weights laid out once (which hold the pairs
    and ``plan_weights_bf16``'s layout)."""
    port = flow_drow_pair(seed=8)[2]
    det = port.dr_spaam
    layer1, tail = fold.backbone_stack_weights(det.backbone)
    gp = fold.fold_gate_params(det.gate, dtype=torch.bfloat16)
    emb = (gp.w, gp.b)
    laid = cs.backbone_weights_bf16(tail)
    assert laid.convs == tuple(tail)
    for lw, ref in zip(laid.laid, it.plan_weights_bf16(
            tail, it.BACKBONE_BF16_PLAN)):
        assert torch.equal(lw, ref)
    cut = torch.from_numpy(np.random.default_rng(110).normal(
        0.0, 0.6, (21, 16)).astype(np.float32))
    n0 = (cs.backbone_bf16.launches, cs.backbone_tail.launches,
          fd.fused_backbone.launches)
    ref = cs.backbone_bf16_plain(cut, layer1, tail, emb, l=16)
    act1 = cs.backbone_layer1(cut, layer1)
    assert all(torch.equal(a, b) for a, b in zip(
        ref, cs.backbone_tail_plain(act1, tail, emb, l=16)))
    for w in (tail, laid):
        for got in (cs.backbone_bf16(cut, layer1, w, emb, l=16),
                    cs.backbone_tail(act1, w, emb, l=16)):
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
    w_bb = fd.backbone_weights(det.backbone)
    laid14 = fd.backbone_weights_bf16(w_bb)
    assert laid14.dtype == torch.bfloat16 and laid14.pairs == tuple(w_bb)
    w1 = laid14.tensors[0]
    assert w1.dtype == torch.float32 and torch.equal(w1, _bf16(w1))
    ref14 = fd.fused_backbone_plain(cut, w_bb, compute_dtype=torch.bfloat16)
    for w in (w_bb, laid14):
        assert torch.equal(fd.fused_backbone(cut, w), ref14)
    assert n0 == (cs.backbone_bf16.launches, cs.backbone_tail.launches,
                  fd.fused_backbone.launches)
