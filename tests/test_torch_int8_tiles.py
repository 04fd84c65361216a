"""The host side of the wgmma convs of K5/K9/K10 and K7 (int8) and of K4
(bf16) (``ops/kernels/int8_tiles.py``), on the CPU.

* The wgmma B layout of every backbone and head conv at the flagship widths
  inverts exactly to ``quant.kernel_stack_weights``' ``(Cout, 3*Cin)``, and
  its chunks are the descriptor's core matrices, back to back.
* A plain emulation of the packed tile (cutouts back to back with zero rows
  between them, the tap as a row offset, the max-pool pair as an even row
  and the next one, 64-row tiles over the block) gives the same int32 sums
  as ``conv_stack._conv_int8_acc``, at L = 16 and 56 and the head's L/4 and
  L/8, for n not a multiple of the block's cutouts; through whole stacks
  with the f32 epilogue it gives ``conv_stack._run_int8_plain``'s int8 and
  f32 activations to the bit.
* The launch geometry (cutouts a block, rows a cutout, shared memory) of
  every length the card tests use stays within the 232,448 bytes a block
  may use, and the kernels' chunks within a ring stage.
* K4: the bf16 layout of every head conv inverts to ``fold``'s ``(3*Cin,
  Cout)`` weights; the packed bf16 tile's head (bf16 operands, f32 sums,
  max-pool on the sums, 8 cutouts a block at L/4 = 14) is within the bf16
  bar of ``head_plain``, which is within it of JAX ``fused_head_v2`` in
  interpret mode; its geometry fits the 4-stage ring and two bf16 tiles.
* K14's bf16 head, on K4's kernel: the packed tile's head with f32 feats
  rounded to bf16 as they load and K14's mean (the last activations' bf16
  values summed in f32, times the reciprocal of the count) is within the
  bf16 bar of JAX ``fused_head(compute_dtype=bf16)`` in interpret mode and
  of ``fused_drow.fused_head_plain``, at a full block and a part.
* The int8 weights laid out once (``conv_stack.backbone_weights_int8``,
  ``head_weights_int8``) are ``plan_weights``' layouts and give the
  triples' results through ``backbone_int8_pm`` and ``head_int8``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs
from planar_optical_flow_tpu_torch.ops.kernels import int8_tiles as it
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import recip

PLANS = [("backbone", i, p) for i, p in enumerate(it.BACKBONE_PLAN)] + [
    ("head", i, p) for i, p in enumerate(it.HEAD_PLAN)]


def _inverse(flat, cout, k, nj):
    """``it.wgmma_weights`` undone: the chunk order back to ``(Cout, K)``."""
    p, g, r, c, b, e = it._chunk_shape(cout, k, nj)
    return (flat.reshape(p, c, b, g, r, e).permute(it._CHUNK_ORDER)
            .reshape(cout, k))


def _int8(rng, *shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


@pytest.mark.parametrize("stack,layer,plan", PLANS,
                         ids=[f"{s}{i}" for s, i, _ in PLANS])
def test_wgmma_weights_invert(stack, layer, plan):
    """Layout and inverse at the flagship widths; chunk c of pass q holds
    w[q * NS + 8 * grp + r, c * KC + 16 * blk + e] at byte
    ((q * NKC + c) * NS * KC) + ((blk * NS / 8 + grp) * 8 + r) * 16 + e."""
    cin, cout, _, nj = plan
    k, ns = 3 * cin, 64 * nj
    kc = it.chunk_k(k, ns)
    assert k % kc == 0 and kc % 32 == 0 and ns * kc <= it.STAGE_BYTES
    w = _int8(np.random.default_rng(layer), cout, k)
    flat = it.wgmma_weights(w, nj)
    assert flat.shape == (cout * k,) and flat.is_contiguous()
    assert torch.equal(_inverse(flat, cout, k, nj), w)
    rng = np.random.default_rng(10 + layer)
    for n, kk in zip(rng.integers(0, cout, 64), rng.integers(0, k, 64)):
        q, nn = divmod(int(n), ns)
        grp, r = divmod(nn, 8)
        c, kr = divmod(int(kk), kc)
        blk, e = divmod(kr, 16)
        at = ((q * (k // kc) + c) * ns * kc
              + ((blk * (ns // 8) + grp) * 8 + r) * 16 + e)
        assert flat[at] == w[n, kk]


def _packed_acc(xq, w, tile, pool):
    """int64 sums of a k=3 SAME conv of int8 ``xq (n, L, Cin)`` computed as
    the wgmma kernels lay it out: blocks of ``tile`` cutouts, each a packed
    tile with cutout c's position p in row c * S + 1 + p, A row m reading
    rows m, m + 1, m + 2 over 64-row tiles; max-pooled pairs as rows m
    (even) and m + 1. Returns ``(n, L or L/2, Cout)``."""
    n, length, cin = xq.shape
    s = it.row_stride(length)
    rows = it.m_tiles(length, tile) * 64
    wt = w.long().t()
    outs = []
    for c0 in range(0, n, tile):
        nv = min(tile, n - c0)
        packed = torch.zeros(rows + 2, cin, dtype=torch.long)
        for c in range(nv):
            packed[c * s + 1:c * s + 1 + length] = xq[c0 + c].long()
        a = torch.cat([packed[t:t + rows] for t in range(3)], dim=1)
        acc = a @ wt  # (rows, Cout): every row, kept or not
        m = (torch.arange(nv)[:, None] * s
             + torch.arange(length)[None, :])  # (nv, L): row of (c, p)
        if pool:
            even = m[:, 0::2]
            assert bool((even % 2 == 0).all())
            outs.append(torch.maximum(acc[even], acc[even + 1]))
        else:
            outs.append(acc[m])
    return torch.cat(outs)


def _plain_acc(xq, w, pool):
    acc = cs._conv_int8_acc(xq, w).long()
    if pool:
        n, length, c = acc.shape
        acc = acc.reshape(n, length // 2, 2, c).amax(2)
    return acc


# (cin, cout, L, pool): the backbone's convs at L = 16 and 56 (and L/2), the
# head's at L/4 = 14 and L/8 = 7 (and 4, 2 at L = 16)
CONVS = [(64, 64, 56, False), (64, 128, 56, True), (128, 256, 28, True),
         (64, 128, 16, True), (128, 128, 8, False),
         (256, 512, 14, True), (512, 256, 7, False), (256, 128, 7, False),
         (256, 256, 4, False), (512, 256, 2, False)]


@pytest.mark.parametrize("cin,cout,length,pool", CONVS,
                         ids=[f"{a}-{b}-L{c}{'-pool' if d else ''}"
                              for a, b, c, d in CONVS])
def test_packed_tile_sums(cin, cout, length, pool):
    """n = 19: one full block of 16 and one of 3 (also 2 cutouts alone)."""
    rng = np.random.default_rng(cin + cout + length)
    w = _int8(rng, cout, 3 * cin)
    for n in (19, 2):
        xq = _int8(rng, n, length, cin)
        assert torch.equal(_packed_acc(xq, w, it.WG_TILE, pool),
                           _plain_acc(xq, w, pool))


def _stack(rng, chans, n_layers):
    """Random int8 conv weights and epilogue constants that keep the
    activations spread over the int8 range."""
    out = []
    for cin, cout in zip(chans[:n_layers], chans[1:n_layers + 1]):
        w = _int8(rng, cout, 3 * cin)
        s = torch.tensor(rng.uniform(0.5, 1.5, cout)
                         / (np.sqrt(3 * cin) * 60.0), dtype=torch.float32)
        b = torch.tensor(rng.normal(0.0, 2.0, cout), dtype=torch.float32)
        out.append((w, s, b))
    return out


def _packed_stack(xq, weights, pool_after, requant_last, tile):
    """``_run_int8_plain`` with every conv's sums from the packed tile."""
    x = xq
    for i, (w, s, b) in enumerate(weights):
        acc = _packed_acc(x, w, tile, i in pool_after).double()
        y = acc.float() * s + b
        y = torch.where(y > 0, y, 0.1 * y)
        x = cs._requant(y) if (i < len(weights) - 1 or requant_last) else y
    return x


@pytest.mark.parametrize("stack", ["backbone", "head"])
def test_packed_tile_stacks(stack):
    """The backbone tail at L = 16 (int8 feats) and the head at L/4 = 4 (the
    last conv dequantized), n = 19, against ``_run_int8_plain``."""
    rng = np.random.default_rng(5)
    if stack == "backbone":
        weights = _stack(rng, cs.BACKBONE_CHANNELS[1:], 5)
        pool_after, requant_last, length, cin = (1, 4), True, 16, 64
    else:
        weights = _stack(rng, cs.HEAD_CHANNELS, 5)
        pool_after, requant_last, length, cin = (2,), False, 4, 256
    xq = _int8(rng, 19, length, cin)
    got = _packed_stack(xq, weights, pool_after, requant_last, it.WG_TILE)
    ref = cs._run_int8_plain(xq, weights, pool_after, requant_last)
    assert got.dtype == ref.dtype and torch.equal(got, ref)
    if requant_last:  # the stack really ran through the int8 range
        assert int(got.abs().max()) > 60


# the lengths the card tests and chip_smoke.py run: cutouts of 16 and 56
# points, the head at their quarters
@pytest.mark.parametrize("l", [16, 56])
def test_launch_geometry(l):
    for l1_mode in (0, 1, 2):
        tile, rows, smem = it.backbone_geometry(l, l1_mode)
        assert (tile, rows) == (16, l + 2) and smem <= it.SMEM_MAX
    tile, rows, smem = it.head_geometry(l // 4)
    assert (tile, rows) == (16, l // 4 + 2) and smem <= it.SMEM_MAX
    if l == 56:  # the flagship block: 15 and 8 row tiles, 4 of the head
        assert it.m_tiles(56, 16) == 15 and it.m_tiles(28, 16) == 8
        assert it.m_tiles(14, 16) == 4 and it.m_tiles(7, 16) == 2
        assert it.backbone_geometry(56, 0)[2] == 204800
        assert it.head_geometry(14)[2] == 210944
    # a zero row after every cutout, and pool pairs inside their cutout
    # (the row stride is even); the last row tile's taps inside the tile
    for length in (l, l // 2, l // 4, l // 8):
        if length:
            assert it.row_stride(length) % 2 == 0
            assert it.row_stride(length) >= length + 1
            rows = it.ptile_bytes(length, 1, 16)
            assert it.m_tiles(length, 16) * 64 + 1 < rows


def test_geometry_shrinks_the_block():
    """A long cutout takes fewer cutouts a block, never more memory."""
    for l4 in range(2, 33, 2):
        tile, _, smem = it.head_geometry(l4)
        assert smem <= it.SMEM_MAX or tile == 1
        assert tile in (16, 8, 4, 2, 1)
    assert it.head_geometry(32)[0] < it.WG_TILE


# ------------------------------------------------------------ K4 in bf16
# (csrc/head_bf16.cu on the same packed tile, int8_tiles.HEAD_BF16_PLAN)

BF16_REL = 2e-2  # x max|plain| (tests/test_fast_gate.py)
BF16_PLANS = list(enumerate(it.HEAD_BF16_PLAN))


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.normal(0.0, scale, shape).astype(
        np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("layer,plan", BF16_PLANS,
                         ids=[f"head{i}" for i, _ in BF16_PLANS])
def test_bf16_weights_invert(layer, plan):
    """``plan_weights_bf16`` of ``(3*Cin, Cout)`` weights inverts to them;
    chunk c of pass q holds w[c * KC + 8 * blk + e, q * NS + 8 * grp + r]
    at element ((q * NKC + c) * NS * KC) + ((blk * NS / 8 + grp) * 8 + r) *
    8 + e, every chunk one ring stage."""
    cin, cout, _, nj, wgn = plan
    k, ns = 3 * cin, 64 * nj * wgn
    kc = it.chunk_k(k, ns, 2)
    assert k % kc == 0 and kc % 16 == 0 and ns * kc * 2 <= it.STAGE_BYTES
    rng = np.random.default_rng(30 + layer)
    w = _bf16(rng, k, cout)
    b = torch.zeros(cout)
    (flat,) = it.plan_weights_bf16([(w, b)], [plan])
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


def _packed_conv_bf16(x, wcat, b, tile, pool):
    """A k=3 SAME bf16 conv of ``x (n, L, Cin)`` (bf16 values) as K4 lays it
    out: blocks of ``tile`` cutouts in a packed tile, A row m reading rows
    m, m + 1, m + 2 over 64-row tiles, f32 sums of bf16 products; max-pool
    on the sums of rows m (even) and m + 1; then leaky(acc + b) in f32."""
    n, length, cin = x.shape
    s = it.row_stride(length)
    rows = it.m_tiles(length, tile) * 64
    outs = []
    for c0 in range(0, n, tile):
        nv = min(tile, n - c0)
        packed = torch.zeros(rows + 2, cin)
        for c in range(nv):
            packed[c * s + 1:c * s + 1 + length] = x[c0 + c].float()
        a = torch.cat([packed[t:t + rows] for t in range(3)], dim=1)
        acc = a @ wcat.float()
        m = (torch.arange(nv)[:, None] * s + torch.arange(length)[None, :])
        if pool:
            even = m[:, 0::2]
            assert bool((even % 2 == 0).all())
            acc = torch.maximum(acc[even], acc[even + 1])
        else:
            acc = acc[m]
        y = acc + b
        outs.append(torch.where(y > 0, y, 0.1 * y))
    return torch.cat(outs)


def _packed_head_bf16(feats, conv_w, head_w, l4, tile, k14=False):
    """K4 on the packed tile: the five convs (activations stored as bf16,
    the last one f32), the f32 mean (a running sum, then one division), and
    cls/reg from its bf16 -> (cls, reg). With ``k14``, K14's bf16 head: f32
    feats rounded to bf16 as the tile loads, the last activations' bf16
    values summed in f32, times the f32 reciprocal of the count."""
    x = feats.reshape(-1, l4, 256)
    if k14:
        x = x.to(torch.bfloat16)
    for i, (w, b) in enumerate(conv_w):
        y = _packed_conv_bf16(x, w, b, tile, i == 2)
        x = y.to(torch.bfloat16) if i < len(conv_w) - 1 or k14 else y
    acc = x[:, 0].float()
    for i in range(1, x.shape[1]):
        acc = acc + x[:, i].float()
    mean = (acc * recip(x.shape[1]) if k14 else acc / x.shape[1]).to(
        torch.bfloat16).float()
    wc, bc, wr, br = head_w
    return mean @ wc.float() + bc, mean @ wr.float() + br


def _close(got, ref, what):
    lim = BF16_REL * float(ref.abs().max())
    err = float((got - ref).abs().max())
    assert err <= lim, f"{what}: {err} > {lim}"


@pytest.mark.parametrize("l4", [4, 14])
def test_packed_bf16_head(l4):
    """Random bf16 weights, n = T + 3 cutouts (a full block and a part):
    the packed tile's head within the bf16 bar of ``head_plain``."""
    rng = np.random.default_rng(40 + l4)
    tile = it.head_bf16_geometry(l4)[0]
    conv_w = [(_bf16(rng, 3 * cin, cout, scale=1.0 / np.sqrt(3 * cin)),
               torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32)))
              for cin, cout in zip(cs.HEAD_CHANNELS[:-1], cs.HEAD_CHANNELS[1:])]
    head_w = (_bf16(rng, 128, 1, scale=0.1), torch.zeros(1),
              _bf16(rng, 128, 2, scale=0.1), torch.zeros(2))
    n = tile + 3
    feats = _bf16(rng, n * l4, 256)
    got = _packed_head_bf16(feats, conv_w, head_w, l4, tile)
    laid = cs.head_weights_bf16(conv_w)
    ref = cs.head(feats, laid, head_w, num_classes=1, l4=l4)
    for g, r, what in zip(got, ref, ("cls", "reg")):
        assert g.shape == r.shape == (n, g.shape[1])
        _close(g, r, what)
    plain = cs.head_plain(feats, conv_w, head_w, l4=l4)
    assert all(torch.equal(a, b) for a, b in zip(ref, plain))


def test_bf16_head_against_pallas():
    """The model's head weights at L/4 = 4: the packed tile's head within
    the bf16 bar of ``head_plain``, and ``head_plain`` within it of JAX
    ``fused_head_v2`` in interpret mode."""
    import jax.numpy as jnp

    from planar_optical_flow_tpu.ops.pallas import conv_stack as jcs
    from planar_optical_flow_tpu_torch.ops.kernels import fold
    from tests.test_torch_common import flow_drow_pair, to_jax

    _, v_np, port = flow_drow_pair(seed=2)
    rng = np.random.default_rng(50)
    n, l4 = 19, 4
    feats = _bf16(rng, n * l4, 256, scale=0.5)
    conv_w, head_w = fold.head_stack_weights(port.dr_spaam.head)
    got = _packed_head_bf16(feats, conv_w, head_w, l4,
                            it.head_bf16_geometry(l4)[0])
    plain = cs.head_plain(feats, conv_w, head_w, l4=l4)
    jv = to_jax({c: v_np[c]["dr_spaam"]["head"]
                 for c in ("params", "batch_stats")})
    conv_j, head_j = jcs.head_stack_weights(jv)
    ref = jcs.fused_head_v2(
        jnp.asarray(feats.float().numpy(), jnp.bfloat16), conv_j, head_j,
        num_classes=1, l4=l4, tile=16, conv_mode="3mm", interpret=True)
    for g, p, r, what in zip(got, plain, ref, ("cls", "reg")):
        _close(g, p, what)
        _close(p, torch.from_numpy(np.asarray(r, np.float32)), what)


@pytest.mark.parametrize("l", [16, 56])
def test_head_bf16_geometry(l):
    """K4's block: the most cutouts (16, halved) whose 4-stage ring, two
    bf16 tile regions and means fit 232,448 bytes; 8 at the flagship."""
    l4 = l // 4
    tile, rows, smem = it.head_bf16_geometry(l4)
    assert rows == l4 + 2 and smem <= it.SMEM_MAX
    assert it.head_bf16_smem_bytes(l4, 2 * tile) > it.SMEM_MAX or tile == 16
    assert it.RING_BYTES == it.STAGES * it.STAGE_BYTES + 2 * 512 * 4
    assert it.STAGES == 4
    if l == 56:  # two 64-row tiles at 14 positions, one at 7 (WGN = 2)
        assert tile == 8 and smem == 208896
        assert it.m_tiles(14, 8) == 2 and it.m_tiles(7, 8) == 1
    for cin, cout, mt, nj, wgn in it.HEAD_BF16_PLAN:
        ns = 64 * nj * wgn
        assert cout % ns == 0
        assert ns * it.chunk_k(3 * cin, ns, 2) * 2 <= it.STAGE_BYTES


@pytest.mark.parametrize("l4", [4, 14])
def test_packed_k14_head_against_pallas(l4):
    """K14's bf16 head on the packed tile at n = T + 3 cutouts (a full
    block and a part), on the bridged weights: within the bf16 bar of JAX
    ``fused_head(compute_dtype=bf16)`` in interpret mode and of
    ``fused_head_plain``."""
    import jax.numpy as jnp

    from planar_optical_flow_tpu.ops.pallas import fused_drow as jfd
    from planar_optical_flow_tpu_torch.ops.kernels import fused_drow as fd
    from tests.test_torch_common import flow_drow_pair

    _, v_np, port = flow_drow_pair(seed=4)
    jhd = jfd.head_weights({k: v_np[k]["dr_spaam"]["head"]
                            for k in ("params", "batch_stats")})
    w_hd = fd.head_weights(port.dr_spaam.head)
    conv_w = [(w.reshape(-1, w.shape[-1]).to(torch.bfloat16), b.float())
              for w, b in w_hd[:5]]
    (wc, bc), (wr, br) = w_hd[5:]
    head_w = (wc.to(torch.bfloat16), bc.float(), wr.to(torch.bfloat16),
              br.float())
    tile = it.head_bf16_geometry(l4)[0]
    n = tile + 3
    feats = torch.from_numpy(np.random.default_rng(60 + l4).normal(
        0.0, 0.5, (n, l4, 256)).astype(np.float32))
    got = _packed_head_bf16(feats, conv_w, head_w, l4, tile, k14=True)
    ref = jfd.fused_head(jnp.asarray(feats.numpy()), jhd, num_classes=1,
                         tile=16, compute_dtype=jnp.bfloat16, interpret=True)
    plain = fd.fused_head_plain(feats, w_hd, compute_dtype=torch.bfloat16)
    for g, p, r, what in zip(got, plain, ref, ("cls", "reg")):
        assert g.shape == p.shape == (n, g.shape[1])
        _close(g, torch.from_numpy(np.asarray(r, np.float32)), what)
        _close(g, p, what)


def test_laid_int8_weights_equal_triples():
    """The backbone tail and head laid out once are ``plan_weights``'
    layouts (which invert to the triples), and give the triples' results
    through ``backbone_int8_pm`` and ``head_int8`` on the CPU."""
    rng = np.random.default_rng(61)
    backbone = _stack(rng, cs.BACKBONE_CHANNELS, 5)
    head = _stack(rng, cs.HEAD_CHANNELS, 5)
    bb, hd = cs.backbone_weights_int8(backbone), cs.head_weights_int8(head)
    for laid, raw, plan in ((bb, backbone, it.BACKBONE_PLAN),
                            (hd, head, it.HEAD_PLAN)):
        assert laid.convs == tuple(raw)
        for (lw, ls, lb), (w, s, b), (cin, cout, _, nj) in zip(
                laid.laid, raw, plan):
            assert torch.equal(_inverse(lw, cout, 3 * cin, nj), w)
            assert ls is s and lb is b
    cut = torch.from_numpy(rng.normal(0.0, 0.5, (19, 16)).astype(np.float32))
    layer1 = (torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32)),
              torch.zeros(64))
    embed = (_bf16(rng, 128, 4 * 256, scale=0.02), _bf16(rng, 128))
    got = cs.backbone_int8_pm(cut, layer1, bb, embed, l=16, in_scale=0.02)
    ref = cs.backbone_int8_pm(cut, layer1, backbone, embed, l=16,
                              in_scale=0.02)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert int(got[0].abs().max()) > 30
    head_w = (_bf16(rng, 128, 1, scale=0.1), torch.zeros(1),
              _bf16(rng, 128, 2, scale=0.1), torch.zeros(2))
    got = cs.head_int8(ref[0], hd, head_w, num_classes=1, l4=4)
    ref = cs.head_int8(ref[0], head, head_w, num_classes=1, l4=4)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
