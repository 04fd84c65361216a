"""K3's bf16 mix and K15 (``csrc/band_mix.cuh`` ``band_mix_kernel``),
their blocks emulated in torch on the CPU in the kernel's order.

* A block takes ``band_mix_geometry(ct, window)[0]`` rows of one stream
  (the last tile may be shorter) and walks D in chunks of ``MIX_PITCH``
  bytes a row. A chunk stages the template rows ``[i0 - hw, i0 + rows +
  hw)``: K3's rows outside the stream as zeros, K15's wrapped ``j mod
  ct``; and the tile's x rows.
* A run of ``MIX_RUN`` rows from ``r0`` (its ``MIX_SLICES`` warps side by
  side on the chunk's columns, which the emulation takes at once): at
  offset k the run reads staged rows ``r0 + k .. r0 + k + MIX_RUN - 1``
  from a ring of ``MIX_RUN`` slots (row m in slot ``m % MIX_RUN``), one
  row loaded a step. K3 sums from 0.0 in k order; K15 starts from the
  ``o = 0`` term (its centre rows read once more) and skips it in the walk.
  Each product and sum is one f32 operation, then the blend ``alpha * x +
  beta * acc`` and one rounding to the output dtype.
* The emulations equal ``gate_plain`` / ``banded_mix_update_plain`` to the
  bit (K3 on the plain version's attention, which is what the kernel's mix
  takes on the same attention); the plain versions are held against the
  JAX ``gate_fused_flat`` / ``banded_mix_update`` in interpret mode at the
  JAX bar; the geometry fits the card's shared memory with two blocks an
  SM.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.infer import fast_gate as jfg
from planar_optical_flow_tpu_torch.infer import fast_gate as fg
from planar_optical_flow_tpu_torch.ops.kernels import int8_tiles
from tests.test_torch_common import assert_close_to_max, t2n

BF16_REL = 2e-2  # x max|ref| (tests/test_fast_gate.py)
RUNS = fg.MIX_ROWS // fg.MIX_RUN  # warps a block


def _staged(t, i0, nr, hw, circular):
    """A chunk's staged template rows ``(b, MIX_ROWS + 2 hw, cw)`` of
    streams ``t (b, ct, cw)``: the rows past ``nr + 2 hw`` (never read for
    a row of the tile) zero."""
    b, ct, cw = t.shape
    out = torch.zeros(b, fg.MIX_ROWS + 2 * hw, cw, dtype=torch.float32)
    for m in range(nr + 2 * hw):
        j = i0 - hw + m
        if circular:
            out[:, m] = t[:, j % ct]
        elif 0 <= j < ct:
            out[:, m] = t[:, j]
    return out


def _run_sums(staged, a, window, circular):
    """Every run's sums ``(b, RUNS, MIX_RUN, cw)`` by the kernel's sliding
    window; ``a (b, window, MIX_ROWS)`` k-major, as in shared memory."""
    hw, L = window // 2, fg.MIX_RUN
    r0 = torch.arange(RUNS) * L

    def row(m):  # staged row r0 + m of every run: (b, RUNS, cw)
        return staged[:, r0 + m]

    def w(k):  # weights of offset k of every run's rows: (b, RUNS, L, 1)
        return a[:, k].reshape(a.shape[0], RUNS, L, 1)

    if circular:
        acc = w(hw) * torch.stack([row(u + hw) for u in range(L)], 2)
    else:
        acc = torch.zeros(staged.shape[0], RUNS, L, staged.shape[2])
    win = [row(m) for m in range(L - 1)] + [None]
    for k0 in range(0, window, L):
        for j in range(L):
            k = k0 + j
            if k >= window:
                break
            win[(j + L - 1) % L] = row(k + L - 1)
            if circular and k == hw:
                continue
            wk = w(k)
            for u in range(L):
                acc[:, :, u] = acc[:, :, u] + wk[:, :, u] * win[(j + u) % L]
    return acc


def emulate(attn, x, t, *, alpha, window, circular):
    """The kernel's blocks: ``attn (b, ct, window)`` f32 (K3: bf16-rounded),
    ``x``/``t (b, ct, D)`` -> ``(b, ct, D)`` in x's dtype."""
    b, ct, d = t.shape
    hw = window // 2
    rows, tiles, _, _ = fg.band_mix_geometry(ct, window)
    cols = fg.MIX_PITCH // t.element_size()
    al = torch.tensor(alpha, dtype=torch.float32)
    be = torch.tensor(1.0 - alpha, dtype=torch.float32)
    out = torch.empty(b, ct, d, dtype=x.dtype)
    for tile in range(tiles):
        i0 = tile * rows
        nr = min(rows, ct - i0)
        a = torch.zeros(b, window, fg.MIX_ROWS)
        a[:, :, :nr] = attn[:, i0:i0 + nr].transpose(1, 2)
        for col0 in range(0, d, cols):
            c1 = min(col0 + cols, d)
            staged = _staged(t[..., col0:c1].float(), i0, nr, hw, circular)
            acc = _run_sums(staged, a, window, circular)
            acc = acc.reshape(b, fg.MIX_ROWS, -1)[:, :nr]
            xs = x[:, i0:i0 + nr, col0:c1].float()
            out[:, i0:i0 + nr, col0:c1] = (al * xs + be * acc).to(x.dtype)
    return out


def _bf(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(
        np.float32)).to(torch.bfloat16)


def _gate_inputs(seed, s, ct, d):
    rng = np.random.default_rng(seed)
    n = s * ct
    # embeddings with a spread of similarities, so the band's weights vary
    return (_bf(rng, n, 128, scale=0.5), _bf(rng, n, 128, scale=0.5),
            _bf(rng, n, d), _bf(rng, n, d))


# (ct, ct_valid): two short tiles, two whole ones with dead rows, and the
# serving rows (456 = 14 tiles of 31 and one of 22)
SHAPES = [(40, 40), (64, 60), (456, 450)]
WINDOWS = [5, 11, 21]
DS = [256, 1024]
CASES = [(ct, v, w, d) for ct, v in SHAPES for w in WINDOWS for d in DS]
IDS = [f"ct{c[0]}-v{c[1]}-w{c[2]}-d{c[3]}" for c in CASES]


@pytest.mark.parametrize("ct,ct_valid,window,d", CASES, ids=IDS)
def test_k3_block_walk_equals_plain(ct, ct_valid, window, d):
    s = 2
    zx, zt, x, t = _gate_inputs(3 + window + ct, s, ct, d)
    alpha = 0.5
    attn, _, _ = fg._attention(zx, zt, ct=ct, ct_valid=ct_valid,
                               window_size=window)
    a = attn.to(torch.bfloat16).float()
    assert int((a > 0.05).sum(-1).max()) > 2  # the band mixes several rows
    got = emulate(a, x.reshape(s, ct, d), t.reshape(s, ct, d), alpha=alpha,
                  window=window, circular=False)
    ref = fg.gate_plain(zx, zt, x, t, ct=ct, ct_valid=ct_valid, alpha=alpha,
                        window_size=window)[0]
    assert torch.equal(got.reshape(-1, d), ref)


def test_k3_bootstrap_and_partial_chunk():
    """The bootstrap form (zt = zx, t = x) and a D whose last chunk is
    partial (312 bf16 = 624 bytes: a chunk of 512 bytes and one of 112)."""
    ct, ct_valid, window, d, s = 64, 60, 11, 312, 2
    zx, _, x, _ = _gate_inputs(41, s, ct, d)
    attn, _, _ = fg._attention(zx, zx, ct=ct, ct_valid=ct_valid,
                               window_size=window)
    got = emulate(attn.to(torch.bfloat16).float(), x.reshape(s, ct, d),
                  x.reshape(s, ct, d), alpha=0.5, window=window,
                  circular=False)
    ref = fg.gate_plain(zx, zx, x, x, ct=ct, ct_valid=ct_valid, alpha=0.5,
                        window_size=window)[0]
    assert torch.equal(got.reshape(-1, d), ref)


K15_CASES = [(ct, w, d, dt) for ct, _ in SHAPES for w in WINDOWS for d in DS
             for dt in ("bf16", "f32")]


@pytest.mark.parametrize("ct,window,d,dtype", K15_CASES,
                         ids=[f"ct{c[0]}-w{c[1]}-d{c[2]}-{c[3]}"
                              for c in K15_CASES])
def test_k15_block_walk_equals_plain(ct, window, d, dtype):
    """Random attention, nonzero at every offset, so the wrapped rows at
    the stream's ends count."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    rng = np.random.default_rng(5 + window + ct)
    s = 2
    attn = torch.from_numpy(rng.uniform(0.0, 1.0, (s, ct, window)).astype(
        np.float32))
    x, t = (torch.from_numpy(rng.normal(size=(s, ct, d)).astype(
        np.float32)).to(dt) for _ in range(2))
    got = emulate(attn, x, t, alpha=0.3, window=window, circular=True)
    ref = fg.banded_mix_update_plain(attn, x, t, 0.3, window)
    assert got.dtype == ref.dtype == dt
    assert torch.equal(got, ref)


def test_plain_versions_against_jax():
    """At ct 64 with 60 valid, window 11, D 256: ``gate_plain`` within the
    JAX bf16 bar of ``gate_fused_flat``, ``banded_mix_update_plain`` within
    one bf16 ulp of ``banded_mix_update`` (interpret mode)."""
    ct, ct_valid, window, d, s = 64, 60, 11, 256, 2
    zx, zt, x, t = _gate_inputs(17, s, ct, d)
    got = fg.gate_plain(zx, zt, x, t, ct=ct, ct_valid=ct_valid, alpha=0.5,
                        window_size=window)
    ref = jfg.gate_fused_flat(*(jnp.asarray(t2n(a), jnp.bfloat16)
                                for a in (zx, zt, x, t)),
                              ct=ct, alpha=0.5, window_size=window,
                              ct_valid=ct_valid, interpret=True)
    for name, g, r in zip(("new_t", "new_z", "sim"), got, ref):
        assert_close_to_max(t2n(g), np.asarray(r, np.float32), BF16_REL,
                            name)

    rng = np.random.default_rng(18)
    attn = rng.uniform(0.0, 1.0, (s, ct, window)).astype(np.float32)
    xj, tj = (jnp.asarray(rng.normal(size=(s, ct, d)), jnp.bfloat16)
              for _ in range(2))
    ref = np.asarray(jfg.banded_mix_update(jnp.asarray(attn), xj, tj,
                                           alpha=0.5, window_size=window,
                                           interpret=True), np.float32)
    got = t2n(fg.banded_mix_update_plain(
        torch.from_numpy(attn),
        *(torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
          for v in (xj, tj)), 0.5, window))
    top = np.maximum(np.abs(got), np.abs(ref))
    ulp = np.float32(2.0) ** (np.floor(np.log2(np.maximum(
        top, np.float32(2.0 ** -126)))) - 7)
    assert np.all(np.abs(got - ref) <= np.maximum(
        ulp, 2.0 ** -17 * np.abs(ref).max()))


@pytest.mark.parametrize("window", [5, 11, 21, 31])
def test_geometry_fits(window):
    """Two blocks an SM, each within the 232,448 bytes a block may use;
    three ring stages at the serving window 11; tiles as even as they come,
    covering the stream."""
    for ct in (40, 60, 64, 65, 450, 456, 480):
        rows, tiles, stages, smem = fg.band_mix_geometry(ct, window)
        assert 0 < rows <= fg.MIX_ROWS and (tiles - 1) * rows < ct
        assert tiles * rows >= ct and tiles == -(-ct // fg.MIX_ROWS)
        assert rows - ct // tiles <= 1
        assert smem <= int8_tiles.SMEM_MAX and stages in (2, 3)
        assert 2 * (smem + fg.BLOCK_RESERVED) <= fg.SM_SMEM_BYTES
        if window == 11:
            assert stages == 3
