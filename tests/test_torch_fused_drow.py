"""K14, K15 and K3's f32 mode (plain versions) against the JAX Pallas
kernels in interpret mode, the band-gate API of ``make_serve_step`` and the
int8 ``QuantizedConvStack`` against the JAX package.

Tolerances: K14 f32 at rtol 1e-3 / atol 1e-4 (``tests/test_pallas_fused.py``),
bf16 at 2e-2 x max|JAX|; K15 f32 at 1e-5, bf16 within one bf16 ulp (or
2^-17 x max where the f32 sum cancels to near zero); K3 f32
template 2e-5 and sim 2e-4 (``tests/test_fast_gate.py``); the gate API the
same in f32, 2e-2 x max in bf16; int8 activations within 1 LSB on at most
5e-3 of the elements, scales to 1e-5 relative.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.infer import fast_gate as jfg
from planar_optical_flow_tpu.ops import quantized_drow as jqd
from planar_optical_flow_tpu.ops.pallas import fused_drow as jfd
from planar_optical_flow_tpu_torch.infer import fast_gate as fg
from planar_optical_flow_tpu_torch.ops import quantized_drow as qd
from planar_optical_flow_tpu_torch.ops.kernels import fold
from planar_optical_flow_tpu_torch.ops.kernels import fused_drow as fd
from tests.test_torch_common import (
    WINDOW,
    assert_close_to_max,
    flow_drow_pair,
    t2n,
)

F32 = dict(rtol=1e-3, atol=1e-4)  # tests/test_pallas_fused.py
BF16_REL = 2e-2
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def weights():
    """(port detector, JAX backbone weights, JAX head weights)."""
    _, v_np, port = flow_drow_pair(seed=4)
    det = {k: v_np[k]["dr_spaam"] for k in ("params", "batch_stats")}

    def sub(name):
        return {k: det[k][name] for k in ("params", "batch_stats")}

    return (port.dr_spaam, jfd.backbone_weights(sub("backbone")),
            jfd.head_weights(sub("head")))


def _within_bf16_ulp(got, ref):
    """One bf16 spacing at the larger of the two, or 2^-17 x max|ref| where
    the f32 sum cancels to near zero."""
    top = np.maximum(np.abs(got), np.abs(ref))
    ulp = np.float32(2.0) ** (np.floor(np.log2(np.maximum(
        top, np.float32(2.0 ** -126)))) - 7)
    return np.all(np.abs(got - ref) <= np.maximum(
        ulp, 2.0 ** -17 * np.abs(ref).max()))


def test_fused_weights_match_jax(weights):
    det, jbb, jhd = weights
    bb = fd.backbone_weights(det.backbone)
    hd = fd.head_weights(det.head)
    got = [t2n(t) for pair in bb + hd for t in pair]
    assert len(got) == len(jbb) + len(jhd)
    for g, r in zip(got, list(jbb) + list(jhd)):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_fused_backbone_plain_matches_jax(weights, mode):
    """70 cutouts (not a multiple of any tile) of 24 points, as the JAX
    test."""
    det, jbb, _ = weights
    dt, jdt = DTYPES[mode]
    x = np.random.default_rng(0).normal(size=(70, 24)).astype(np.float32)
    ref = np.asarray(jfd.fused_backbone(jnp.asarray(x), jbb, tile=32,
                                        compute_dtype=jdt, interpret=True))
    got = fd.fused_backbone(torch.from_numpy(x),
                            fd.backbone_weights(det.backbone),
                            compute_dtype=dt)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    if mode == "f32":
        np.testing.assert_allclose(t2n(got), ref, **F32)
    else:
        assert_close_to_max(t2n(got), ref, BF16_REL, "bf16 feats")
        # the feats hold bf16 values
        assert torch.equal(got, got.to(torch.bfloat16).float())


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_fused_head_plain_matches_jax(weights, mode):
    det, _, jhd = weights
    dt, jdt = DTYPES[mode]
    x = np.random.default_rng(1).normal(size=(45, 6, 256)).astype(np.float32)
    ref = jfd.fused_head(jnp.asarray(x), jhd, num_classes=1, tile=16,
                         compute_dtype=jdt, interpret=True)
    got = fd.fused_head(torch.from_numpy(x), fd.head_weights(det.head),
                        num_classes=1, compute_dtype=dt)
    for g, r, what in zip(got, ref, ("cls", "reg")):
        assert g.dtype == torch.float32
        if mode == "f32":
            np.testing.assert_allclose(t2n(g), np.asarray(r), **F32)
        else:
            assert_close_to_max(t2n(g), np.asarray(r), BF16_REL, what)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_banded_mix_update_plain_matches_jax(mode):
    """Random attention, nonzero at every offset, so that the circular roll
    at the stream's ends is exercised."""
    dt, jdt = DTYPES[mode]
    rng = np.random.default_rng(2)
    b, ct, d = 2, 48, 64
    attn = rng.uniform(0.0, 1.0, (b, ct, WINDOW)).astype(np.float32)
    x, t = (jnp.asarray(rng.normal(size=(b, ct, d)), jdt) for _ in range(2))
    ref = np.asarray(jfg.banded_mix_update(jnp.asarray(attn), x, t,
                                           alpha=0.5, window_size=WINDOW,
                                           interpret=True), np.float32)
    got = fg.banded_mix_update(torch.from_numpy(attn),
                               torch.from_numpy(np.asarray(x, np.float32)).to(dt),
                               torch.from_numpy(np.asarray(t, np.float32)).to(dt),
                               alpha=0.5, window_size=WINDOW)
    assert got.dtype == dt
    if mode == "f32":
        np.testing.assert_allclose(t2n(got), ref, rtol=1e-5, atol=1e-5)
    else:
        assert _within_bf16_ulp(t2n(got), ref)


def test_gate_f32_plain_matches_jax():
    """K3's f32 mode: ``gate_fused`` at an unpadded ct (48 rows a stream)."""
    rng = np.random.default_rng(3)
    b, ct, d = 2, 48, 64
    zx, zt = (rng.normal(size=(b, ct, 128)).astype(np.float32)
              for _ in range(2))
    x, t = (rng.normal(size=(b, ct, d)).astype(np.float32) for _ in range(2))
    ref = jfg.gate_fused(*(jnp.asarray(a) for a in (zx, zt, x, t)),
                         alpha=0.5, window_size=WINDOW, interpret=True)
    got = fg.gate_fused(*(torch.from_numpy(a) for a in (zx, zt, x, t)),
                        alpha=0.5, window_size=WINDOW)
    assert all(g.dtype == torch.float32 for g in got)
    np.testing.assert_allclose(t2n(got[0]), np.asarray(ref[0]), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(t2n(got[1]), np.asarray(ref[1]), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(t2n(got[2]), np.asarray(ref[2]), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_gate_api_matches_jax(weights, mode, use_pallas):
    """``embed``, ``gate_bootstrap`` and ``gate_step`` over three carried
    steps, from the same folded parameters (``tests/test_fast_gate.py``'s
    multistep check)."""
    det, _, _ = weights
    dt, jdt = DTYPES[mode]
    gp = fold.fold_gate_params(det.gate, dtype=dt)
    jgp = jfg.GateParams(w=jnp.asarray(t2n(gp.w), jdt),
                         b=jnp.asarray(t2n(gp.b), jdt), alpha=gp.alpha,
                         window_size=gp.window_size)
    d = gp.w.shape[0]
    rng = np.random.default_rng(5)
    xs = [rng.normal(size=(2, 40, d)).astype(np.float32) for _ in range(4)]

    def close(got, ref, what, f32_tol):
        if mode == "f32":
            np.testing.assert_allclose(t2n(got), np.asarray(ref, np.float32),
                                       rtol=f32_tol, atol=f32_tol,
                                       err_msg=what)
        else:
            assert str(got.dtype) == f"torch.{jnp.dtype(ref.dtype).name}", what
            assert_close_to_max(t2n(got), np.asarray(ref, np.float32),
                                BF16_REL, what)

    jx = [jnp.asarray(a, jdt) for a in xs]
    px = [torch.from_numpy(a).to(dt) for a in xs]
    close(fg.embed(gp, px[0]), jfg.embed(jgp, jx[0]), "embed", 2e-5)
    jt, jz, jsim = jfg.gate_bootstrap(jgp, jx[0])
    pt, pz, psim = fg.gate_bootstrap(gp, px[0])
    close(pz, jz, "bootstrap z", 2e-5)
    close(psim, jsim, "bootstrap sim", 2e-4)
    for i in range(1, 4):
        jt, jz, jsim = jfg.gate_step(jgp, jx[i], jt, jz,
                                     use_pallas=use_pallas, interpret=True)
        pt, pz, psim = fg.gate_step(gp, px[i], pt, pz, use_pallas=use_pallas)
        close(pt, jt, f"step {i} template", 2e-5)
        close(pz, jz, f"step {i} z", 2e-4)
        close(psim, jsim, f"step {i} sim", 2e-4)


def test_quantized_conv_stack_matches_jax(weights):
    """The int8 backbone and head convs from the same calibration sample:
    the same scales, int8 activations within 1 LSB, the f32 outputs and
    the head's cls/reg close."""
    det, jbb, jhd = weights
    rng = np.random.default_rng(6)
    cut = rng.normal(0.0, 0.5, (70, 16)).astype(np.float32)
    j_bb = jqd.build_quantized_backbone(jbb, cut[:48])
    p_bb = qd.build_quantized_backbone(fd.backbone_weights(det.backbone),
                                       cut[:48], device="cpu")
    for a, b in zip([j_bb.in_scale] + j_bb.act_scales,
                    [p_bb.in_scale] + p_bb.act_scales):
        assert abs(a - b) <= 1e-5 * abs(a)
    xq = np.asarray(j_bb.quantize_input(jnp.asarray(cut[..., None])))
    assert np.array_equal(xq, t2n(p_bb.quantize_input(
        torch.from_numpy(cut[..., None]))))
    layers = [(np.asarray(jbb[i]), np.asarray(jbb[i + 1]))
              for i in range(0, 12, 2)]
    args = ((2, 5), j_bb.in_scale, j_bb.act_scales)
    j8 = jax.jit(lambda a: jqd.QuantizedConvStack(
        layers, *args, dequant_last=False)(a))(jnp.asarray(xq))
    p8 = qd.QuantizedConvStack(layers, *args, dequant_last=False,
                               device="cpu")(
        torch.from_numpy(xq))
    diff = np.abs(t2n(p8) - np.asarray(j8, np.float32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 5e-3, diff.max()
    feats_j = np.asarray(jax.jit(lambda a: j_bb(a))(jnp.asarray(xq)))
    feats_p = t2n(p_bb(torch.from_numpy(xq)))
    assert_close_to_max(feats_p, feats_j, BF16_REL, "f32 feats")

    j_hd, j_heads = jqd.build_quantized_head_convs(jhd, feats_j[:48])
    p_hd, p_heads = qd.build_quantized_head_convs(fd.head_weights(det.head),
                                                  feats_j[:48], device="cpu")
    for a, b in zip([j_hd.in_scale] + j_hd.act_scales,
                    [p_hd.in_scale] + p_hd.act_scales):
        assert abs(a - b) <= 1e-5 * abs(a)
    tq = np.asarray(j_hd.quantize_input(jnp.asarray(feats_j)))
    ref = jax.jit(lambda a: jqd.quantized_head_apply(j_hd, j_heads, a))(
        jnp.asarray(tq))
    got = qd.quantized_head_apply(p_hd, p_heads, torch.from_numpy(tq))
    for g, r, what in zip(got, ref, ("cls", "reg")):
        np.testing.assert_allclose(t2n(g), np.asarray(r), rtol=1e-4,
                                   atol=1e-4, err_msg=what)


def test_kernel_wrappers_take_the_plain_version_on_the_cpu(weights):
    """On a CPU tensor each new wrapper returns its plain version's result
    and launches nothing."""
    det, _, _ = weights
    rng = np.random.default_rng(7)
    cut = torch.from_numpy(rng.normal(size=(9, 16)).astype(np.float32))
    bb = fd.backbone_weights(det.backbone)
    n0 = (fd.fused_backbone.launches, fd.fused_head.launches,
          fg.banded_mix_update.launches, fg.gate.launches)
    feats = fd.fused_backbone(cut, bb, compute_dtype=None)
    assert torch.equal(feats, fd.fused_backbone_plain(cut, bb, 64, None))
    hd = fd.head_weights(det.head)
    assert all(torch.equal(a, b) for a, b in zip(
        fd.fused_head(feats, hd), fd.fused_head_plain(feats, hd)))
    attn = torch.rand(1, 9, WINDOW)
    x = torch.randn(1, 9, 16)
    assert torch.equal(fg.banded_mix_update(attn, x, x, 0.5, WINDOW),
                       fg.banded_mix_update_plain(attn, x, x, 0.5, WINDOW))
    assert n0 == (fd.fused_backbone.launches, fd.fused_head.launches,
                  fg.banded_mix_update.launches, fg.gate.launches)
