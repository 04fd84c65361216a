"""The serving kernels as ``torch.library`` ops (``ops/kernels/library.py``),
on the CPU.

* every op of ``pof_torch`` (K1-K16) is registered, and
  ``torch.library.opcheck`` passes on each with the arguments its public
  wrapper gives it;
* each wrapper (now a call of its op, which runs the plain version on a CPU
  tensor) equals its plain version on the same arguments, to the bit, for
  the laid-out weights and for the plain triples or pairs;
* ``torch.export`` of each wrapper records one ``pof_torch::`` node and
  nothing of the plain version's body;
* K1's op against the JAX Pallas kernel in interpret mode, at
  ``tests/test_cutout_kernel.py``'s bar, and K6's op against
  ``gate_fused_int8_pm(per_stream=True)`` at ``tests/test_fast_gate.py``'s
  (as ``tests/test_torch_int8.py`` holds its plain version).

Weights: a FlowDrow of 64 beams, 16 cutout points, window 5, from the JAX
init through the flax bridge; int8 scales calibrated by the port on seeded
scans. Activations from a numpy seed.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from planar_optical_flow_tpu.infer import fast_gate as jfg
from planar_optical_flow_tpu.ops.pallas.cutout_kernel import cutout_fused
from planar_optical_flow_tpu_torch.infer import fast_gate as fg
from planar_optical_flow_tpu_torch.infer.calibration import (
    calibrate_serve_v3,
)
from planar_optical_flow_tpu_torch.infer.streaming import int8_weights
from planar_optical_flow_tpu_torch.ops.kernels import conv_stack as cs
from planar_optical_flow_tpu_torch.ops.kernels import fold, library
from planar_optical_flow_tpu_torch.ops.kernels import fused_drow as fd
from planar_optical_flow_tpu_torch.ops.kernels import serve_cell as sc
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import (
    cutout,
    cutout_plain,
)
from tests.test_torch_common import (
    CT_LEN,
    NUM_PTS,
    WINDOW,
    flow_drow_pair,
    one_thread,  # noqa: F401 (a fixture)
)

B = 2
N = B * NUM_PTS           # cutouts
L4 = CT_LEN // 4
D = L4 * 256
CUT_KW = dict(num_cutout_pts=CT_LEN, window_width=1.0, window_depth=0.5,
              padding_val=29.99, centered=True, area_mode=True)
CUT_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_cutout_kernel.py
ALPHA = 0.5
CT_VALID = NUM_PTS - 4


class _Calls(TorchDispatchMode):
    """Records the first call of each ``pof_torch`` op: (op, args)."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == library.NAMESPACE:
            self.calls.setdefault(func._opname, (func, args, kwargs or {}))
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


@pytest.fixture(scope="module")
def w():
    """The tiny model's kernel weights, laid out as the step holds them
    (none requires a gradient: the ops serve inference only)."""
    with torch.no_grad():
        return _weights()


def _weights():
    _, _, port = flow_drow_pair(seed=5)
    port.requires_grad_(False)
    det = port.dr_spaam
    rng = np.random.default_rng(50)
    calib = calibrate_serve_v3(
        port, dict(CUT_KW, fixed=True), torch.from_numpy(
            rng.uniform(0.5, 20.0, (4, NUM_PTS)).astype(np.float32)),
        num_pts=NUM_PTS, device="cpu")
    q = int8_weights(det, calib, "cpu")
    layer1_bf, tail_bf = fold.backbone_stack_weights(det.backbone)
    gp = fold.fold_gate_params(det.gate, dtype=torch.bfloat16)
    return dict(
        q=q, bb=cs.backbone_weights_int8(q.backbone),
        hd=cs.head_weights_int8(q.head), cell_embed=sc.cell_embed(q.embed),
        layer1_bf=layer1_bf, bb_bf=cs.backbone_weights_bf16(tail_bf),
        hd_bf=cs.head_weights_bf16(fold.prepare_stack_weights(
            fold.head_conv_blocks(det.head))),
        hw=fold.head_linear_weights(det.head), embed_bf=(gp.w, gp.b),
        fused_bb=fd.backbone_weights(det.backbone),
        fused_hd=fd.head_weights(det.head))


def _inputs(seed=51):
    rng = np.random.default_rng(seed)
    scans = torch.from_numpy(
        rng.uniform(0.5, 20.0, (B, NUM_PTS)).astype(np.float32))
    cut = cutout_plain(scans, **CUT_KW)

    def bf16(*shape):
        return torch.from_numpy(
            rng.normal(0, 1, shape).astype(np.float32)).to(torch.bfloat16)

    def int8(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))

    return dict(scans=scans, cut=cut, zx=bf16(N, 128), zt=bf16(N, 128),
                x=bf16(N, D), t=bf16(N, D), feats=bf16(N * L4, 256),
                x8=int8(N, D), t8=int8(N, D), rows8=int8(N * L4, 256),
                shift=torch.from_numpy(cs.row_shift_pattern()[0]),
                feats32=torch.from_numpy(
                    rng.normal(0, 1, (N, L4, 256)).astype(np.float32)),
                attn=torch.from_numpy(
                    rng.uniform(0, 0.3, (B, NUM_PTS, WINDOW)).astype(
                        np.float32)),
                xb=bf16(B, NUM_PTS, D), tb=bf16(B, NUM_PTS, D))


def _cases(w, laid=True):
    """(name -> (the names of the tensors the call takes, wrapper(*tensors),
    plain version(*tensors)), the tensors by name); with ``laid=False`` the
    wrappers get the plain triples and pairs, which they lay out in the
    call."""
    q = w["q"]
    bb, hd = (w["bb"], w["hd"]) if laid else (q.backbone, q.head)
    bb_bf = w["bb_bf"] if laid else w["bb_bf"].convs
    hd_bf = w["hd_bf"] if laid else w["hd_bf"].convs
    embed_c = w["cell_embed"] if laid else q.embed
    hw = w["hw"]
    gate_kw = dict(ct=NUM_PTS, alpha=ALPHA, window_size=WINDOW,
                   ct_valid=CT_VALID)
    int8_kw = dict(gate_kw, s_x=q.feat_scale, s_t=q.tmpl_scale,
                   s_out=q.tmpl_scale)
    head_kw = dict(num_classes=1, l4=L4)
    inputs = _inputs()
    inputs["act1_bf"] = cs.backbone_layer1(inputs["cut"], w["layer1_bf"])
    inputs["act1_8"] = cs.backbone_layer1(inputs["cut"], q.layer1_div,
                                          out_scale=q.in_scale)
    cell_kw = dict(l=CT_LEN, in_scale=q.in_scale, num_classes=1, **int8_kw)
    # K14 in bf16, laid out for it (or the pairs)
    fused_bb = (fd.backbone_weights_bf16(w["fused_bb"]) if laid
                else w["fused_bb"])
    fused_hd = fd.head_weights_bf16(w["fused_hd"]) if laid else w["fused_hd"]
    bf = dict(compute_dtype=torch.bfloat16)
    return {
        "cutout": (("scans",),
                   lambda s: cutout(s, p_valid=CT_VALID, **CUT_KW),
                   lambda s: cutout_plain(s, p_valid=CT_VALID, **CUT_KW)),
        "backbone_bf16": (
            ("cut",),
            lambda c: cs.backbone_bf16(c, w["layer1_bf"], bb_bf,
                                       w["embed_bf"], l=CT_LEN),
            lambda c: cs.backbone_bf16_plain(c, w["layer1_bf"],
                                             w["bb_bf"].convs, w["embed_bf"],
                                             l=CT_LEN)),
        "backbone_tail": (
            ("act1_bf",),
            lambda a: cs.backbone_tail(a, bb_bf, w["embed_bf"], l=CT_LEN),
            lambda a: cs.backbone_tail_plain(a, w["bb_bf"].convs,
                                             w["embed_bf"], l=CT_LEN)),
        "gate": (("zx", "zt", "x", "t"),
                 lambda *a: fg.gate(*a, **gate_kw),
                 lambda *a: fg.gate_plain(*a, **gate_kw)),
        "head": (("feats",),
                 lambda f: cs.head(f, hd_bf, hw, **head_kw),
                 lambda f: cs.head_plain(f, w["hd_bf"].convs, hw, l4=L4)),
        "backbone_int8": (
            ("cut",),
            lambda c: cs.backbone_int8(c, q.layer1, bb, q.embed, l=CT_LEN),
            lambda c: cs.backbone_int8_plain(c, q.layer1, q.backbone,
                                             q.embed, l=CT_LEN)),
        "backbone_int8_pm": (
            ("cut",),
            lambda c: cs.backbone_int8_pm(c, q.layer1_div, bb, q.embed,
                                          l=CT_LEN, in_scale=q.in_scale),
            lambda c: cs.backbone_int8_pm_plain(
                c, q.layer1_div, q.backbone, q.embed, l=CT_LEN,
                in_scale=q.in_scale)),
        "backbone_int8_cut": (
            ("scans",),
            lambda s: cs.backbone_int8_cut(s, q.layer1, bb, q.embed,
                                           p_valid=CT_VALID, **CUT_KW),
            lambda s: cs.backbone_int8_cut_plain(
                s, q.layer1, q.backbone, q.embed, p_valid=CT_VALID,
                **CUT_KW)),
        "backbone_int8_tail": (
            ("act1_8",),
            lambda a: cs.backbone_int8_tail(a, bb, q.embed, l=CT_LEN),
            lambda a: cs.backbone_int8_tail_plain(a, q.backbone, q.embed,
                                                  l=CT_LEN)),
        "gate_int8": (("zx", "zt", "x8", "t8"),
                      lambda *a: fg.gate_int8(*a, **int8_kw),
                      lambda *a: fg.gate_int8_plain(*a, **int8_kw)),
        "head_int8": (("rows8",),
                      lambda t: cs.head_int8(t, hd, hw, **head_kw),
                      lambda t: cs.head_int8_plain(t, q.head, hw, l4=L4)),
        "gate_head_int8": (
            ("zx", "zt", "x8", "t8"),
            lambda *a: fg.gate_head_int8(*a, hd, hw, **head_kw, **int8_kw),
            lambda *a: fg.gate_head_int8_plain(*a, q.head, hw, **head_kw,
                                               **int8_kw)),
        "serve_cell_int8": (
            ("cut", "zt", "t8"),
            lambda c, z, t: sc.serve_cell_int8(c, z, t, q.layer1_div, bb,
                                               embed_c, hd, hw, **cell_kw),
            lambda c, z, t: sc.serve_cell_int8_plain(
                c, z, t, q.layer1_div, q.backbone, q.embed, q.head, hw,
                **cell_kw)),
        "row_shift": (("shift",), lambda x: cs.row_shift(x, l=4),
                      lambda x: cs.row_shift_plain(x, l=4)),
        "fused_backbone": (
            ("cut",), lambda c: fd.fused_backbone(c, fused_bb, **bf),
            lambda c: fd.fused_backbone_plain(c, w["fused_bb"], **bf)),
        "fused_head": (
            ("feats32",), lambda f: fd.fused_head(f, fused_hd, **bf),
            lambda f: fd.fused_head_plain(f, w["fused_hd"], **bf)),
        "banded_mix_update": (
            ("attn", "xb", "tb"),
            lambda *a: fg.banded_mix_update(*a, ALPHA, WINDOW),
            lambda *a: fg.banded_mix_update_plain(*a, ALPHA, WINDOW)),
    }, inputs


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


def test_every_op_is_registered_and_reached(w):
    ops = {n for n in dir(torch.ops.pof_torch)
           if isinstance(getattr(torch.ops.pof_torch, n),
                         torch._ops.OpOverloadPacket)}
    assert ops == set(library.OPS)
    cases, inputs = _cases(w)
    assert set(cases) == set(library.OPS)
    for name, (keys, wrapper, _) in cases.items():
        with _Calls() as rec:
            wrapper(*(inputs[k] for k in keys))
        assert list(rec.calls) == [name], (name, list(rec.calls))


@pytest.mark.parametrize("name", library.OPS)
def test_opcheck(w, name):
    cases, inputs = _cases(w)
    keys, wrapper, _ = cases[name]
    with _Calls() as rec:
        wrapper(*(inputs[k] for k in keys))
    func, args, kwargs = rec.calls[name]
    torch.library.opcheck(func, args, kwargs)


@pytest.mark.parametrize("laid", [True, False], ids=["laid", "triples"])
@pytest.mark.parametrize("name", library.OPS)
def test_op_equals_plain(w, name, laid):
    cases, inputs = _cases(w, laid)
    keys, wrapper, plain = cases[name]
    args = [inputs[k] for k in keys]
    got, ref = _flat(wrapper(*args)), _flat(plain(*args))
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype and g.shape == r.shape, (name, i)
        assert torch.equal(g, r), (name, i)


# besides the op, an exported wrapper may only move tensor metadata
_META_OPS = {"getitem", "view", "reshape", "_assert_tensor_metadata",
             "contiguous", "alias", "_unsafe_view", "clone", "t",
             "transpose", "select", "slice", "squeeze", "unsqueeze"}


class _Wrapped(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *xs):
        return self.fn(*xs)


@pytest.mark.parametrize("name", library.OPS)
def test_export_records_the_op(w, name):
    cases, inputs = _cases(w)
    keys, wrapper, _ = cases[name]
    program = torch.export.export(_Wrapped(wrapper),
                                  tuple(inputs[k] for k in keys))
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    ops = [t for t in targets if getattr(t, "namespace", "") == "pof_torch"]
    assert [t._opname for t in ops] == [name]
    rest = {getattr(t, "_opname", getattr(t, "__name__", str(t)))
            for t in targets if t not in ops}
    assert rest <= _META_OPS, (name, rest - _META_OPS)
    # and the exported program computes what the wrapper does
    got = _flat(program.module()(*(inputs[k] for k in keys)))
    ref = _flat(wrapper(*(inputs[k] for k in keys)))
    for g, r in zip(got, ref):
        assert torch.equal(g, r), name


def test_cutout_op_matches_pallas():
    scans = _inputs(52)["scans"]
    got = torch.ops.pof_torch.cutout(
        scans, CT_LEN, 1.0, 0.5, 29.99, True, True, float(np.radians(0.5)),
        CT_VALID)
    ref = np.asarray(cutout_fused(jnp.asarray(scans.numpy()),
                                  p_valid=CT_VALID, interpret=True, **CUT_KW))
    np.testing.assert_allclose(got.numpy(), ref, **CUT_TOL)


def test_gate_int8_op_matches_pallas(w):
    """K6's op against the JAX per-stream pm gate (one tile a stream), the
    rows converted as ``tests/test_torch_int8.py`` converts them: int8
    within 1 LSB with under 5e-3 of the elements off by one, z at 2e-2,
    sim at 1e-5 (that file's bars)."""
    q = w["q"]
    inputs = _inputs(53)
    zx, zt, x, t = (inputs[k] for k in ("zx", "zt", "x8", "t8"))
    kw = dict(alpha=ALPHA, window_size=WINDOW, s_x=q.feat_scale,
              s_t=q.tmpl_scale, s_out=q.tmpl_scale, ct_valid=CT_VALID)
    new_t, new_z, sim = torch.ops.pof_torch.gate_int8(
        zx, zt, x, t, NUM_PTS, ALPHA, WINDOW, q.feat_scale, q.tmpl_scale,
        q.tmpl_scale, CT_VALID)

    def to_pm(a):  # (N, l4*256) cutout-major -> pm rows, tile = ct
        return jnp.asarray(a.numpy().reshape(-1, NUM_PTS, L4, 256).transpose(
            0, 2, 1, 3).reshape(-1, 256))

    ref = jfg.gate_fused_int8_pm(
        jnp.asarray(zx.float().numpy(), jnp.bfloat16),
        jnp.asarray(zt.float().numpy(), jnp.bfloat16), to_pm(x), to_pm(t),
        ct=NUM_PTS, tile=NUM_PTS, l4=L4, per_stream=True, interpret=True,
        **kw)
    ref_t = np.asarray(ref[0]).reshape(-1, L4, NUM_PTS, 256).transpose(
        0, 2, 1, 3).reshape(N, D)
    diff = np.abs(new_t.numpy().astype(np.int32) - ref_t.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 5e-3
    np.testing.assert_allclose(new_z.float().numpy(),
                               np.asarray(ref[1], np.float32), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(sim.numpy(), np.asarray(ref[2]), rtol=1e-5,
                               atol=1e-5)
