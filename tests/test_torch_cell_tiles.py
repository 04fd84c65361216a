"""K13's block (``csrc/serve_cell_wg.cu``), emulated in torch on the CPU.

* Blocks of ``CELL_ROWS`` = 16 cutouts of one stream (two whole tiles and a
  partial one at ct = 40): the backbone's five tail convs on the packed
  tile (``tests/test_torch_int8_tiles.py``'s ``_packed_stack``), the int8
  feats as rows at ``cell_pitch``, zx from those rows and the embed
  weights as ``int8_tiles.embed_weights`` lays them out for the ring (each
  chunk read at the kernel's addresses), the mix of the block's 16 rows on
  one ``mma.m16n8k32`` tile over the template in 512-column chunks (256
  past a half window of 8), rows ``[i0 - H, i0 - H + 32 KT)`` staged with
  zeros outside the stream and byte-transposed as the kernel does
  (``tests/test_torch_gate_tiles.py``'s ``_stage``), blended over the feats
  rows, and the packed head on the new template. Window 11 and 21 (one and
  two k32 steps), ``ct_valid < ct``, two streams, random int8 weights made
  from a numpy seed.
* The emulation equals ``serve_cell_int8_plain`` to the bit, which in turn
  is held to JAX ``serve_cell_int8`` in interpret mode at JAX's own
  cell-vs-pm bars (``tests/test_torch_int8_fused.py``'s K13 test: the
  template within 1 LSB, z at 2e-2, cls/reg at 5e-2).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.ops.pallas import serve_cell as jsc
from planar_optical_flow_tpu_torch.infer import fast_gate as fg
from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs
from planar_optical_flow_tpu_torch.ops.kernels import int8_tiles as it
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import div_f32
from planar_optical_flow_tpu_torch.ops.kernels.serve_cell import (
    cell_embed,
    serve_cell_int8,
    serve_cell_int8_plain,
)
from tests.test_torch_gate_tiles import _b_operand, _stage
from tests.test_torch_int8_tiles import _int8, _packed_stack, _stack

L, STREAMS, CT, CT_VALID = 16, 2, 40, 37  # tiles of 16, 16 and 8 rows
L4 = L // 4
D = L4 * 256
ALPHA = 0.5


def _setup(seed, window):
    """Random cell inputs and weights: (cutouts, zt, template, kw, weights
    as serve_cell_int8 takes them)."""
    rng = np.random.default_rng(seed)
    n = STREAMS * CT

    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32))

    cut = f32(n, L, scale=0.5)
    layer1 = (f32(3, 64), f32(64, scale=0.1))
    backbone = _stack(rng, cs.BACKBONE_CHANNELS, 5)
    head = _stack(rng, cs.HEAD_CHANNELS, 5)
    # the head's last conv is dequantized: its activations in f32 units
    w, s, b = head[-1]
    head[-1] = (w, s * 0.05, b * 0.05)
    we_t = f32(128, D, scale=0.3 / np.sqrt(D)).to(torch.bfloat16)
    be = f32(128, scale=0.1).to(torch.bfloat16)
    head_w = (f32(128, 1, scale=0.1).to(torch.bfloat16), f32(1),
              f32(128, 2, scale=0.1).to(torch.bfloat16), f32(2))
    zt = f32(n, 128, scale=0.5).to(torch.bfloat16)
    tmpl = _int8(rng, n, D)
    kw = dict(l=L, ct=CT, ct_valid=CT_VALID, alpha=ALPHA, window_size=window,
              in_scale=0.02, s_x=0.11, s_t=0.17, s_out=0.13, num_classes=1)
    return cut, zt, tmpl, kw, (layer1, backbone, (we_t, be), head, head_w)


def _embed_rows(rows, laid, be):
    """zx of one block from its pitched feats rows ``(16, pitch)`` int8 and
    the ring's chunks of ``W^T``: chunk kc, k block kb, column n, element e
    is W^T[n, 64 kc + 8 kb + e] at ``laid[((kc * 8 + kb) * 128 + n) * 8 +
    e]``. The products are exact and so is their float64 sum, as the MMA's
    f32 chain is in practice; then one f32 add of the bias, rounded to
    bf16."""
    nk = D // it.EMBED_K
    w = laid.reshape(nk, 8, 128, 8).permute(2, 0, 1, 3).reshape(128, D)
    a = rows[:, :D].double()  # k = p * 256 + ch of the row
    return ((a @ w.double().t()).float() + be.float()).to(torch.bfloat16)


def _mix_block(q, x, t_stream, i0, nv, window, kw):
    """The block's mix: q ``(16, window)`` (rows past nv zero), x ``(16,
    D)`` int8 (the feats rows), the stream's carried template ``(CT, D)``
    -> new template rows ``(nv, D)``."""
    hw = window // 2
    kt = 2 if hw > 8 else 1
    halo, cc = 8 * kt, 512 // kt
    rr = torch.arange(16)[:, None]
    lane = torch.arange(32 * kt)[None, :] - halo - rr + hw
    on_band = (lane >= 0) & (lane < window)
    a = torch.where(on_band, torch.gather(
        q.long(), 1, lane.clamp(0, window - 1).expand(16, -1)), 0)
    out = torch.empty(nv, D, dtype=torch.int8)
    for col0 in range(0, D, cc):
        tile = torch.zeros(32 * kt, cc, dtype=torch.int8)
        for r in range(32 * kt):
            j = i0 - halo + r
            if 0 <= j < CT:
                tile[r] = t_stream[j, col0:col0 + cc]
        acc = a @ _b_operand(_stage(tile), 0, kt)  # (16, cc)
        xv = x[:nv, col0:col0 + cc].float()
        v = (ALPHA * (xv * kw["s_x"])
             + (1.0 - ALPHA) * (acc[:nv].float() * (kw["s_t"] / 127.0)))
        out[:, col0:col0 + cc] = torch.clamp(
            torch.round(div_f32(v, kw["s_out"])), -127, 127).to(torch.int8)
    return out


def emulate_cell(cut, zt, tmpl, kw, weights):
    """K13 block by block -> (new_t, new_z, sim, cls, reg)."""
    layer1, backbone, (we_t, be), head, (wc, bc, wr, br) = weights
    window = kw["window_size"]
    laid = it.embed_weights(we_t)
    pitch = it.cell_pitch(L4)
    n = STREAMS * CT
    feats = torch.empty(n, D, dtype=torch.int8)
    zx = torch.empty(n, 128, dtype=torch.bfloat16)
    blocks = [(s, i0, min(it.CELL_ROWS, CT - i0)) for s in range(STREAMS)
              for i0 in range(0, CT, it.CELL_ROWS)]
    for s, i0, nv in blocks:
        r0 = s * CT + i0
        act1 = cs.backbone_layer1(cut[r0:r0 + nv], layer1,
                                  out_scale=kw["in_scale"]).reshape(nv, L, 64)
        f = _packed_stack(act1, backbone, (1, 4), True, it.WG_TILE)
        rows = torch.zeros(it.CELL_ROWS, pitch, dtype=torch.int8)
        rows[:nv, :D] = f.reshape(nv, D)
        feats[r0:r0 + nv] = rows[:nv, :D]
        zx[r0:r0 + nv] = _embed_rows(rows, laid, be)[:nv]
    # the band's attention: one row at a time in the kernel, the same
    # arithmetic over all rows here
    attn, _, _ = fg._attention(zx, zt, ct=CT, ct_valid=CT_VALID,
                               window_size=window)
    q = torch.clamp(torch.round(attn * 127.0), -127, 127).to(torch.int32)
    _, new_z, sim = fg.gate_int8_plain(
        zx, zt, feats, tmpl, ct=CT, ct_valid=CT_VALID, alpha=ALPHA,
        window_size=window, s_x=kw["s_x"], s_t=kw["s_t"], s_out=kw["s_out"])
    new_t = torch.empty(n, D, dtype=torch.int8)
    t3 = tmpl.reshape(STREAMS, CT, D)
    cls, reg = torch.empty(n, 1), torch.empty(n, 2)
    for s, i0, nv in blocks:
        r0 = s * CT + i0
        q16 = torch.zeros(16, window, dtype=torch.int32)
        q16[:nv] = q[s, i0:i0 + nv]
        x16 = torch.zeros(16, D, dtype=torch.int8)
        x16[:nv] = feats[r0:r0 + nv]
        t_new = _mix_block(q16, x16, t3[s], i0, nv, window, kw)
        new_t[r0:r0 + nv] = t_new
        y = _packed_stack(t_new.reshape(nv, L4, 256), head, (2,), False,
                          it.WG_TILE)  # (nv, L/8, 128) f32
        acc = y[:, 0]
        for p in range(1, y.shape[1]):
            acc = acc + y[:, p]
        mean = div_f32(acc, float(y.shape[1])).to(torch.bfloat16).double()
        cls[r0:r0 + nv] = (mean @ wc.double()).float() + bc
        reg[r0:r0 + nv] = (mean @ wr.double()).float() + br
    return new_t, new_z, sim, cls, reg


@pytest.mark.parametrize("window", [11, 21])
def test_cell_block_equals_plain(window):
    cut, zt, tmpl, kw, weights = _setup(80 + window, window)
    got = emulate_cell(cut, zt, tmpl, kw, weights)
    ref = serve_cell_int8_plain(cut, zt, tmpl, *weights, **kw)
    for g, r, what in zip(got, ref, ("new_t", "new_z", "sim", "cls",
                                     "reg")):
        assert g.dtype == r.dtype and torch.equal(g, r), what
    # the run went through the int8 range and the band mixed neighbours
    assert int(got[0].abs().max()) > 60
    assert int((ref[0] != tmpl).float().mean() * 100) > 10
    # the laid-out weights, as the step builder holds them, give the same
    layer1, backbone, embed, head, head_w = weights
    laid = serve_cell_int8(cut, zt, tmpl, layer1,
                           cs.backbone_weights_int8(backbone),
                           cell_embed(embed), cs.head_weights_int8(head),
                           head_w, **kw)
    assert all(torch.equal(a, b) for a, b in zip(laid, ref))


def test_cell_plain_against_pallas():
    """The plain version on the same random weights against JAX
    ``serve_cell_int8`` in interpret mode, at JAX's cell-vs-pm bars."""
    window = 11
    cut, zt, tmpl, kw, weights = _setup(91, window)
    layer1, backbone, (we_t, be), head, head_w = weights

    def jflat(stack):
        return [jnp.asarray(a.numpy()) for w, s, b in stack
                for a in (w.t().contiguous(), s, b)]

    def jbf(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    rows = (tmpl.numpy().reshape(STREAMS, CT, L4, 256).transpose(0, 2, 1, 3)
            .reshape(-1, 256))
    ref = jsc.serve_cell_int8(
        jnp.asarray(cut.numpy()), jbf(zt), jnp.asarray(rows),
        (jnp.asarray(layer1[0].numpy()),
         jnp.asarray(layer1[1].numpy()).reshape(1, -1)),
        jflat(backbone), (jbf(we_t.t()), jbf(be)), jflat(head),
        tuple(jnp.asarray(t.float().numpy()) for t in head_w),
        interpret=True, **kw)
    got = serve_cell_int8_plain(cut, zt, tmpl, *weights, **kw)
    new_t = (np.asarray(ref[0]).reshape(STREAMS, L4, CT, 256)
             .transpose(0, 2, 1, 3).reshape(-1, D))
    diff = np.abs(got[0].numpy().astype(np.int32) - new_t.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    for k, g, r, tol in (("z", got[1], ref[1], 2e-2), ("cls", got[3], ref[3],
                                                      5e-2),
                         ("reg", got[4], ref[4], 5e-2)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32), rtol=tol,
                                   atol=tol, err_msg=k)
