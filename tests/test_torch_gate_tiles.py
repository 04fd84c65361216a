"""K6's row-tile decomposition (``csrc/gate.cu`` ``gate_int8_rows_kernel``),
emulated in torch on the CPU.

* Blocks of ``GATE_ROWS`` rows of one stream, the template walked in chunks
  of ``GATE_COLS`` columns; each chunk's template rows ``[i0 - H, i0 - H +
  ROWS)`` staged with zeros outside the stream, packed four rows to a
  32-bit word by the kernel's ``__byte_perm`` steps (emulated byte by byte
  here, selectors and all); each 16-row tile's exact int32 mix as the
  ``mma.m16n8k32`` product of the quantized band (A, zero off the band) and
  the bytes of the staged words (B); the blend and requant of
  ``blend_requant``. The emulation is equal to the bit to
  ``gate_int8_plain``, which is held against JAX ``gate_fused_int8_pm
  (per_stream=True)`` in interpret mode as ``tests/test_torch_int8.py``
  holds it.
* Cases: window 5, 11 and 21 (two k32 steps), ``ct_valid < ct``, a block
  of rows that does not divide ``ct``, a last column chunk narrower than
  ``GATE_COLS``, two streams.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.infer import fast_gate as jfg
from planar_optical_flow_tpu_torch.infer import fast_gate as fg
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import div_f32


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA ``__byte_perm(x, y, s)``: byte n of the result is byte
    ``(s >> 4n) & 7`` of the 8 bytes of ``y:x``."""
    src = (y << 32) | x
    return sum(((src >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n)
               for n in range(4))


def _transpose_words(r0, r1, r2, r3):
    """The kernel's 4 x 4 byte transpose of one word of each of four rows:
    word e of the result holds byte e of r0, r1, r2, r3 (low to high)."""
    lo01, hi01 = _byte_perm(r0, r1, 0x5140), _byte_perm(r0, r1, 0x7362)
    lo23, hi23 = _byte_perm(r2, r3, 0x5140), _byte_perm(r2, r3, 0x7362)
    return (_byte_perm(lo01, lo23, 0x5410), _byte_perm(lo01, lo23, 0x7632),
            _byte_perm(hi01, hi23, 0x5410), _byte_perm(hi01, hi23, 0x7632))


def _words_of(rows):
    """int8 ``(4, C)`` -> the 32-bit words of its columns, C // 4 a row."""
    u = rows.numpy().astype(np.uint8).view(np.uint32)  # little-endian words
    return [[int(w) for w in r] for r in u]


def _stage(tile):
    """int8 ``(ROWS, cw)`` staged rows -> ``(ROWS/4, cw)`` words, each from
    the kernel's transpose of four row words."""
    quads, cw = tile.shape[0] // 4, tile.shape[1]
    out = np.zeros((quads, cw), np.uint32)
    for qd in range(quads):
        w = _words_of(tile[4 * qd:4 * qd + 4])
        for k in range(cw // 4):
            out[qd, 4 * k:4 * k + 4] = _transpose_words(
                w[0][k], w[1][k], w[2][k], w[3][k])
    return out


def _b_operand(words, first_quad, kt):
    """The B operand (32 KT rows of K, cw columns) of a row tile: the signed
    bytes of the staged words, quad ``first_quad`` on."""
    w = words[first_quad:first_quad + 8 * kt]
    b = w.view(np.uint8).reshape(8 * kt, -1, 4).transpose(0, 2, 1)
    return torch.from_numpy(b.reshape(32 * kt, -1).view(np.int8).astype(
        np.int64))


def emulate_gate_int8_mix(q, x, template, *, ct, alpha, s_x, s_t, s_out):
    """K6's new template from the quantized attention ``q (B, ct, window)``
    by the kernel's walk -> ``(N, D)`` int8."""
    n, d = template.shape
    b, _, window = q.shape
    hw, halo = window // 2, fg.gate_halo(window)
    kt = halo // 8
    rows_staged = fg.GATE_ROWS - 16 + 32 * kt
    t = template.reshape(b, ct, d)
    xs = x.reshape(b, ct, d)
    out = torch.empty(b, ct, d, dtype=torch.int8)
    rr = torch.arange(16)[:, None]
    k = torch.arange(32 * kt)[None, :]
    lane = k - halo - rr + hw  # band lane of (row rr, K index k)
    on_band = (lane >= 0) & (lane < window)
    for s in range(b):
        for i0 in range(0, ct, fg.GATE_ROWS):
            nr = min(fg.GATE_ROWS, ct - i0)
            for col0 in range(0, d, fg.GATE_COLS):
                cw = min(fg.GATE_COLS, d - col0)
                tile = torch.zeros(rows_staged, cw, dtype=torch.int8)
                for r in range(rows_staged):
                    j = i0 - halo + r
                    if 0 <= j < ct:
                        tile[r] = t[s, j, col0:col0 + cw]
                words = _stage(tile)
                for rt in range(fg.GATE_ROWS // 16):
                    r0 = 16 * rt
                    if r0 >= nr:
                        break
                    qrows = torch.zeros(16, window, dtype=torch.int64)
                    m = min(16, nr - r0)
                    qrows[:m] = q[s, i0 + r0:i0 + r0 + m].long()
                    a = torch.where(on_band, torch.gather(
                        qrows, 1, lane.clamp(0, window - 1).expand(16, -1)),
                        0)
                    acc = a @ _b_operand(words, 4 * rt, kt)  # (16, cw)
                    xv = xs[s, i0 + r0:i0 + r0 + m, col0:col0 + cw].float()
                    v = (alpha * (xv * s_x)
                         + (1.0 - alpha) * (acc[:m].float() * (s_t / 127.0)))
                    out[s, i0 + r0:i0 + r0 + m, col0:col0 + cw] = torch.clamp(
                        torch.round(div_f32(v, s_out)), -127, 127).to(
                        torch.int8)
    return out.reshape(n, d)


def _inputs(seed, s, ct, d):
    rng = np.random.default_rng(seed)
    n = s * ct

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)

    # embeddings with a spread of similarities, so the band's weights vary
    zx = bf(rng.normal(size=(n, 128)) * 0.5)
    zt = bf(rng.normal(size=(n, 128)) * 0.5)
    x = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8))
    t = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8))
    return zx, zt, x, t


def _quantized_attention(zx, zt, *, ct, ct_valid, window):
    attn, _, _ = fg._attention(zx, zt, ct=ct, ct_valid=ct_valid,
                               window_size=window)
    return torch.clamp(torch.round(attn * 127.0), -127, 127).to(torch.int32)


# (streams, ct, ct_valid, D, window): 100 and 96 rows are a block of 64 and
# a partial one; D = 144 and 400 end in a 16-column chunk
CASES = [(2, 100, 93, 144, 5), (2, 100, 100, 400, 11), (1, 70, 61, 144, 21)]


@pytest.mark.parametrize("s,ct,ct_valid,d,window", CASES,
                         ids=[f"ct{c[1]}-v{c[2]}-d{c[3]}-w{c[4]}"
                              for c in CASES])
def test_row_tile_walk_equals_plain(s, ct, ct_valid, d, window):
    zx, zt, x, t = _inputs(7 + window, s, ct, d)
    kw = dict(alpha=0.5, s_x=0.11, s_t=0.17, s_out=0.13)
    q = _quantized_attention(zx, zt, ct=ct, ct_valid=ct_valid, window=window)
    assert int(q.max()) > 30 and int((q > 0).sum(-1).max()) > 2
    got = emulate_gate_int8_mix(q, x, t, ct=ct, **kw)
    ref = fg.gate_int8_plain(zx, zt, x, t, ct=ct, ct_valid=ct_valid,
                             window_size=window, **kw)[0]
    assert torch.equal(got, ref)
    assert torch.equal(
        ref, fg.int8_mix_plain(q, x, t, ct=ct, ct_valid=ct_valid, **kw))


def test_transpose_selectors():
    """The byte transpose of four row words, on a known pattern."""
    rows = [int.from_bytes(bytes([16 * r + c for c in range(4)]), "little")
            for r in range(4)]
    got = _transpose_words(*rows)
    want = tuple(int.from_bytes(bytes([16 * r + c for r in range(4)]),
                                "little") for c in range(4))
    assert got == want


def _pm(a, tile, l4):
    """Cutout-major rows ``(N, l4*256)`` -> the JAX pm layout."""
    return (np.asarray(a).reshape(-1, tile, l4, 256).transpose(0, 2, 1, 3)
            .reshape(-1, 256))


def _unpm(a, tile, l4):
    return (np.asarray(a).reshape(-1, l4, tile, 256).transpose(0, 2, 1, 3)
            .reshape(-1, l4 * 256))


@pytest.mark.parametrize("window", [5, 11])
def test_row_tile_walk_against_pallas(window):
    """96 rows a stream (a block of 64 and one of 32), 90 valid, D = 512:
    the emulation equals the plain version to the bit, and both are within
    1 LSB of JAX (under 0.5% of the bytes off by one)."""
    s, ct, ct_valid, tile, l4 = 2, 96, 90, 32, 2
    d = l4 * 256
    zx, zt, x, t = _inputs(20 + window, s, ct, d)
    kw = dict(alpha=0.5, s_x=0.11, s_t=0.17, s_out=0.13)
    q = _quantized_attention(zx, zt, ct=ct, ct_valid=ct_valid, window=window)
    got = emulate_gate_int8_mix(q, x, t, ct=ct, **kw)
    plain = fg.gate_int8_plain(zx, zt, x, t, ct=ct, ct_valid=ct_valid,
                               window_size=window, **kw)[0]
    assert torch.equal(got, plain)
    ref = jfg.gate_fused_int8_pm(
        jnp.asarray(zx.float().numpy(), jnp.bfloat16),
        jnp.asarray(zt.float().numpy(), jnp.bfloat16),
        jnp.asarray(_pm(x.numpy(), tile, l4)),
        jnp.asarray(_pm(t.numpy(), tile, l4)), ct=ct, tile=tile, l4=l4,
        window_size=window, ct_valid=ct_valid, per_stream=True,
        interpret=True, **kw)
    diff = np.abs(got.numpy().astype(np.int32)
                  - _unpm(ref[0], tile, l4).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 5e-3
