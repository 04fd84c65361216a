"""The CUDA kernels (K1-K16) against their plain PyTorch versions, on the
card, and the fused kernels (K8, K12, K13) to the bit against the unfused
kernels they fuse.

Marked ``gpu``: they skip without a card and run on one with
``python -m pytest -m gpu --noconftest tests/test_torch_gpu.py``. Shapes
are the test geometry (16 cutout points, window 5) and the flagship one
(56 points, window 11), at a few streams. bf16 outputs within 2e-2 x
max|plain|; int8 outputs within 1 LSB with under 5e-3 of them off by one;
K14's f32 outputs within 1e-3 x |plain| + 1e-4 x max|plain|, K3's f32 mode
at 2e-5 (template) and 2e-4 (z, sim); K3's bf16 template equal to the bit
to the plain mix on its own attention, K15 to its plain version. The
detection dataset's targets computed on the card equal the CPU's (class
and exclude mask exact, offsets and flow within 1e-5), and
``evaluate_detection_ap_batched`` (v3, int8c) on the card scores the same
frames as on the CPU, AP within 0.02.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

import torch.nn.functional as F

from planar_optical_flow_tpu_torch.infer.calibration import calibrate_serve_v3
from planar_optical_flow_tpu_torch.infer.fast_gate import (
    _attention,
    banded_mix_update,
    banded_mix_update_plain,
    gate,
    gate_attention_probe,
    gate_head_int8,
    gate_head_int8_plain,
    gate_int8,
    gate_int8_plain,
    gate_mix_plain,
    gate_plain,
)
from planar_optical_flow_tpu_torch.infer.streaming import int8_weights
from planar_optical_flow_tpu_torch.models import FlowDrow
from planar_optical_flow_tpu_torch.ops import quantized_drow as qd
from planar_optical_flow_tpu_torch.ops.kernels import (
    conv_stack,
    fold,
    int8_tiles,
    quant,
)
from planar_optical_flow_tpu_torch.ops.kernels import fused_drow as fd
from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
    backbone_bf16,
    backbone_bf16_plain,
    backbone_int8,
    backbone_int8_plain,
    backbone_int8_pm,
    backbone_int8_pm_plain,
    backbone_int8_tail,
    backbone_int8_tail_plain,
    backbone_layer1,
    backbone_tail,
    backbone_tail_plain,
    head,
    head_int8,
    head_int8_plain,
    head_plain,
)
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import (
    cutout,
    cutout_plain,
)
from planar_optical_flow_tpu_torch.ops.kernels.serve_cell import (
    cell_embed,
    serve_cell_int8,
    serve_cell_int8_plain,
)

pytestmark = pytest.mark.gpu
BF16_REL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _int8_close(got, ref):
    """Within 1 LSB, with under 5e-3 of the elements off by one."""
    diff = (got.int() - ref.int()).abs()
    assert diff.max().item() <= 1, diff.max().item()
    assert (diff > 0).float().mean().item() < 5e-3


def _close(got, ref, rel):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    assert err <= rel * max(ref.abs().max().item(), 1e-6), err


def _model(ct_len, window, device):
    gen = torch.Generator().manual_seed(0)
    model = FlowDrow(window_size=window, pedestrian_only=True,
                     num_cutout_pts=ct_len, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return model.to(device).eval()


@pytest.mark.parametrize("area_mode", [False, True])
@pytest.mark.parametrize("b,p,p_valid,c", [
    (5, 64, 60, 16), (5, 456, 450, 56),
    # C % 4 != 0 (scalar head and tail stores), partial last tiles of 16;
    # a long scan, whose windows start past rows read from device memory
    (3, 69, 66, 7), (2, 200, 197, 18), (1, 456, 450, 56),
    (2, 4100, 4090, 18)])
def test_cutout_kernel(cuda, area_mode, b, p, p_valid, c):
    rng = np.random.default_rng(0)
    scans = torch.tensor(rng.uniform(0.3, 28.0, (b, p)), dtype=torch.float32,
                         device=cuda)
    kw = dict(num_cutout_pts=c, window_width=1.0, window_depth=0.5,
              padding_val=29.99, centered=True, area_mode=area_mode,
              p_valid=p_valid)
    n0 = cutout.launches
    got = cutout(scans, **kw)
    torch.cuda.synchronize()
    assert cutout.launches == n0 + 1
    ref = cutout_plain(scans, **kw)
    assert (got - ref).abs().max().item() <= 2e-3


@pytest.mark.parametrize("p,c,window_width,angle_deg", [
    (64, 16, 1.0, 0.5), (456, 56, 1.0, 0.5), (69, 7, 2.0, 1.0),
    (65536, 18, 1.0, 0.5)])
def test_cutout_geometry(cuda, p, c, window_width, angle_deg):
    """K1's launch geometry as the library computes it equals
    ``cutout_geometry``'s mirror."""
    import math

    from planar_optical_flow_tpu_torch.ops.kernels import cutout_kernel as ck

    got = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int(),
           ctypes.c_longlong()]
    rc = ck._lib().cutout_geometry(
        p, c, window_width, ck.recip(math.radians(angle_deg)),
        *(ctypes.byref(v) for v in got))
    assert rc == 0
    assert tuple(v.value for v in got) == ck.cutout_geometry(
        p, c, window_width, math.radians(angle_deg))


@pytest.mark.parametrize("ct_len,window", [(16, 5), (56, 11)])
def test_conv_stack_kernels(cuda, ct_len, window):
    det = _model(ct_len, window, cuda).dr_spaam
    rng = np.random.default_rng(1)
    n = 37  # not a multiple of either kernel's tile
    cut = torch.tensor(rng.normal(0.0, 0.6, (n, ct_len)), dtype=torch.float32,
                       device=cuda)
    layer1, tail = fold.backbone_stack_weights(det.backbone)
    gp = fold.fold_gate_params(det.gate, dtype=torch.bfloat16)
    act1 = backbone_layer1(cut, layer1)
    feats, zx = backbone_tail(act1, tail, (gp.w, gp.b), l=ct_len)
    torch.cuda.synchronize()
    feats_p, zx_p = backbone_tail_plain(act1, tail, (gp.w, gp.b), l=ct_len)
    _close(feats, feats_p, BF16_REL)
    _close(zx, zx_p, BF16_REL)

    conv_w, head_w = fold.head_stack_weights(det.head)
    cls, reg = head(feats, conv_w, head_w, num_classes=1, l4=ct_len // 4)
    torch.cuda.synchronize()
    cls_p, reg_p = head_plain(feats, conv_w, head_w, l4=ct_len // 4)
    _close(cls, cls_p, BF16_REL)
    _close(reg, reg_p, BF16_REL)


@pytest.mark.parametrize("ct_len,window", [(16, 5), (56, 11)])
@pytest.mark.parametrize("mode", ["xla", "read", "conv3"])
def test_backbone_bf16_kernel_modes(cuda, ct_len, window, mode):
    """The bf16 backbone kernel in each layer-1 mode at 1, T - 1 and T + 3
    cutouts (T its cutouts a block; the last block partial), on weights
    laid out once and on the pairs (equal to the bit), within the bf16 bar
    of its plain version: K2 from the cutouts ("xla", and equal to the bit
    to backbone_layer1 -> K2 on act1), K2 on act1 ("read") and K14's bf16
    backbone ("conv3")."""
    det = _model(ct_len, window, cuda).dr_spaam
    layer1, tail = fold.backbone_stack_weights(det.backbone)
    laid = conv_stack.backbone_weights_bf16(tail)
    w_bb = fd.backbone_weights(det.backbone)
    laid14 = fd.backbone_weights_bf16(w_bb)
    gp = fold.fold_gate_params(det.gate, dtype=torch.bfloat16)
    emb = (gp.w, gp.b)
    tile = int8_tiles.backbone_bf16_geometry(ct_len, 2 if mode == "read"
                                             else 0)[0]
    rng = np.random.default_rng(13)
    for n in (1, tile - 1, tile + 3):
        cut = torch.tensor(rng.normal(0.0, 0.6, (n, ct_len)),
                           dtype=torch.float32, device=cuda)
        if mode == "conv3":
            n0 = fd.fused_backbone.launches
            got = (fd.fused_backbone(cut, laid14,
                                     compute_dtype=torch.bfloat16),)
            torch.cuda.synchronize()
            assert fd.fused_backbone.launches == n0 + 1
            pairs = (fd.fused_backbone(cut, w_bb,
                                       compute_dtype=torch.bfloat16),)
            ref = (fd.fused_backbone_plain(cut, w_bb,
                                           compute_dtype=torch.bfloat16),)
        elif mode == "read":
            act1 = backbone_layer1(cut, layer1)
            n0 = backbone_tail.launches
            got = backbone_tail(act1, laid, emb, l=ct_len)
            torch.cuda.synchronize()
            assert backbone_tail.launches == n0 + 1
            pairs = backbone_tail(act1, tail, emb, l=ct_len)
            ref = backbone_tail_plain(act1, tail, emb, l=ct_len)
        else:
            n0 = backbone_bf16.launches
            got = backbone_bf16(cut, layer1, laid, emb, l=ct_len)
            torch.cuda.synchronize()
            assert backbone_bf16.launches == n0 + 1
            pairs = backbone_bf16(cut, layer1, tail, emb, l=ct_len)
            ref = backbone_bf16_plain(cut, layer1, tail, emb, l=ct_len)
            read = backbone_tail(backbone_layer1(cut, layer1), laid, emb,
                                 l=ct_len)
            assert all(torch.equal(g, r) for g, r in zip(got, read))
        assert got[0].shape == ref[0].shape
        for g, p, r in zip(got, pairs, ref):
            assert torch.equal(g, p)
            _close(g, r, BF16_REL)


@pytest.mark.parametrize("ct,ct_valid,window,d", [(64, 60, 5, 1024),
                                                  (456, 450, 11, 3584),
                                                  (456, 450, 21, 1000)])
def test_gate_kernel(cuda, ct, ct_valid, window, d):
    """K3 in bf16: new_z and sim within the bf16 bar of gate_plain; new_t
    equal to the bit to gate_plain's mix on K3's own attention (read back
    through a probe template), and so to gate_plain itself on every row
    whose bf16 attention the two compute alike."""
    rng = np.random.default_rng(2)
    n = 3 * ct

    def bf(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.bfloat16,
                            device=cuda)

    args = (bf(n, 128), bf(n, 128), bf(n, d), bf(n, d))
    kw = dict(ct=ct, ct_valid=ct_valid, alpha=0.5, window_size=window)
    n0 = gate.launches
    got = gate(*args, **kw)
    torch.cuda.synchronize()
    assert gate.launches == n0 + 1
    ref = gate_plain(*args, **kw)
    for g, r in zip(got, ref):
        _close(g, r, BF16_REL)
    zx, zt, x, t = args
    a = gate_attention_probe(zx, zt, ct=ct, ct_valid=ct_valid,
                             window_size=window)
    assert torch.equal(got[0], gate_mix_plain(a, x, t, ct=ct,
                                              ct_valid=ct_valid, alpha=0.5))
    a_plain = _attention(zx, zt, ct=ct, ct_valid=ct_valid,
                         window_size=window)[0].to(torch.bfloat16).float()
    alike = (a_plain == a).all(-1).reshape(-1)
    assert alike.float().mean().item() > 0.99
    assert torch.equal(got[0][alike], ref[0][alike])


@pytest.mark.parametrize("n", [1, int8_tiles.WG_TILE - 1,
                               int8_tiles.WG_TILE + 1, 37])
@pytest.mark.parametrize("ct_len,window", [(16, 5), (56, 11)])
def test_int8_stack_kernels(cuda, ct_len, window, n):
    """K5, its K9 and K10 (int8 and bf16 feats) modes and K7 against their
    plain versions, with scales calibrated on the same cutouts, for n
    cutouts around the kernels' block of int8_tiles.WG_TILE; the launch
    geometry and conv plans as int8_tiles computes them."""
    det = _model(ct_len, window, cuda).dr_spaam
    rng = np.random.default_rng(3)
    l4 = ct_len // 4
    cut = torch.tensor(rng.uniform(-1.0, 1.0, (n, ct_len)),
                       dtype=torch.float32, device=cuda)
    blocks = fold.backbone_blocks(det.backbone)
    act1 = backbone_layer1(cut, blocks[0], compute_dtype=torch.float32)
    in_scale, scales = quant.stack_act_scales(
        blocks[1:], act1.reshape(n, ct_len, 64), {1, 4})
    q, in_scale, feat_scale = quant.quantize_stack_int8(
        blocks[1:], None, {1, 4}, in_scale=in_scale,
        act_scales=scales, dequant_last=False)
    gp = fold.fold_gate_params(det.gate, dtype=torch.bfloat16)
    we = gp.w * torch.tensor(feat_scale, dtype=torch.bfloat16, device=cuda)
    tail = quant.kernel_stack_weights(q, cuda)
    args = (cut, quant.layer1_int8_weights(blocks[0], in_scale, cuda),
            tail, (we.t().contiguous(), gp.b))
    n0 = backbone_int8.launches
    feats, zx = backbone_int8(*args, l=ct_len)
    torch.cuda.synchronize()
    assert backbone_int8.launches == n0 + 1
    feats_p, zx_p = backbone_int8_plain(*args, l=ct_len)
    _int8_close(feats, feats_p)
    _close(zx, zx_p, BF16_REL)

    # K9 and K10 (int8 feats) on the same template of the kernel
    layer1 = (blocks[0][0].reshape(3, -1).contiguous(), blocks[0][1])
    embed = (we.t().contiguous(), gp.b)
    got = backbone_int8_pm(cut, layer1, tail, embed, l=ct_len,
                           in_scale=in_scale)
    ref = backbone_int8_pm_plain(cut, layer1, tail, embed, l=ct_len,
                                 in_scale=in_scale)
    _int8_close(got[0], ref[0])
    _close(got[1], ref[1], BF16_REL)
    act1_q = backbone_layer1(cut, layer1, out_scale=in_scale)
    got = backbone_int8_tail(act1_q, tail, embed, l=ct_len)
    ref = backbone_int8_tail_plain(act1_q, tail, embed, l=ct_len)
    _int8_close(got[0], ref[0])
    _close(got[1], ref[1], BF16_REL)
    # K10 with bf16 feats: the last layer dequantized, the unscaled embed
    q8, _, _ = quant.quantize_stack_int8(
        blocks[1:], None, {1, 4}, in_scale=in_scale, act_scales=scales,
        dequant_last=True)
    args8 = (act1_q, quant.kernel_stack_weights(q8, cuda),
             (gp.w.t().contiguous(), gp.b))
    got = backbone_int8_tail(*args8, l=ct_len, out_dtype=torch.bfloat16)
    ref = backbone_int8_tail_plain(*args8, l=ct_len,
                                   out_dtype=torch.bfloat16)
    assert got[0].dtype == torch.bfloat16
    _close(got[0], ref[0], BF16_REL)
    _close(got[1], ref[1], BF16_REL)

    hd_blocks = fold.head_conv_blocks(det.head)
    sample = (feats.float() * feat_scale).reshape(n, l4, 256)
    h_in, h_scales = quant.stack_act_scales(hd_blocks, sample, {2})
    hq, _, _ = quant.quantize_stack_int8(hd_blocks, None, {2},
                                         in_scale=h_in, act_scales=h_scales)
    tmpl = quant.quantize_int8(sample.reshape(-1, 256), h_in)
    hargs = (tmpl, quant.kernel_stack_weights(hq, cuda),
             fold.head_linear_weights(det.head))
    cls, reg = head_int8(*hargs, num_classes=1, l4=l4)
    torch.cuda.synchronize()
    cls_p, reg_p = head_int8_plain(*hargs, l4=l4)
    _close(cls, cls_p, BF16_REL)
    _close(reg, reg_p, BF16_REL)

    # the geometry and plans the host lays the weights out for
    lib = conv_stack._build.load("conv_stack_int8")
    fn = lib.int8_wg_geometry
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    for which, l, modes in ((0, ct_len, (0, 1, 2)), (1, l4, (0,))):
        for mode in modes:
            tile, rows = ctypes.c_int(), ctypes.c_int()
            smem = ctypes.c_longlong()
            assert fn(which, l, mode, ctypes.byref(tile), ctypes.byref(rows),
                      ctypes.byref(smem)) == 0
            want = (int8_tiles.backbone_geometry(l, mode) if which == 0
                    else int8_tiles.head_geometry(l))
            assert (tile.value, rows.value, smem.value) == want


@pytest.mark.parametrize("ct,ct_valid,window,d", [(64, 60, 5, 1024),
                                                  (456, 450, 11, 3584)])
def test_gate_int8_kernel(cuda, ct, ct_valid, window, d):
    rng = np.random.default_rng(4)
    n = 3 * ct
    zx, zt = (torch.tensor(rng.normal(size=(n, 128)), dtype=torch.bfloat16,
                           device=cuda) for _ in range(2))
    x, t = (torch.tensor(rng.integers(-127, 128, (n, d)), dtype=torch.int8,
                         device=cuda) for _ in range(2))
    kw = dict(ct=ct, ct_valid=ct_valid, alpha=0.5, window_size=window,
              s_x=0.11, s_t=0.17, s_out=0.13)
    got = gate_int8(zx, zt, x, t, **kw)
    torch.cuda.synchronize()
    ref = gate_int8_plain(zx, zt, x, t, **kw)
    _int8_close(got[0], ref[0])
    _close(got[1], ref[1], BF16_REL)
    _close(got[2], ref[2], 1e-5)


def _probe_q(zx, zt, ct, ct_valid, window, d):
    """K6's own quantized attention q (N, window), read back through K6: a
    template whose column c holds 1 at the rows j = c (mod 32), x = 0,
    alpha = 0, s_t = 127 and s_out = 1 make new_t[i, c] = q[i, o] for the
    band offset o = c - i (mod 32) (window <= 32, d >= 32)."""
    n, hw = zx.shape[0], window // 2
    j = torch.arange(n, device=zx.device) % ct
    c = torch.arange(d, device=zx.device) % 32
    probe = ((j[:, None] % 32) == c[None, :]).to(torch.int8).contiguous()
    new_t = gate_int8(zx, zt, torch.zeros_like(probe), probe, ct=ct,
                      ct_valid=ct_valid, alpha=0.0, window_size=window,
                      s_x=1.0, s_t=127.0, s_out=1.0)[0]
    o = torch.arange(-hw, hw + 1, device=zx.device)
    cols = (j[:, None] + o[None, :]) % 32
    return torch.gather(new_t[:, :32].int(), 1, cols)


# K6 at the rows of a block and a partial one (100, 70 rows), ct_valid < ct,
# a last column chunk of 16, window 21 (two k32 steps), and the flagship
@pytest.mark.parametrize("ct,ct_valid,window,d", [(100, 93, 5, 400),
                                                  (70, 61, 21, 144),
                                                  (456, 450, 11, 3584)])
def test_gate_int8_row_tiles(cuda, ct, ct_valid, window, d):
    """new_t within 1 LSB of the plain version (the attention sums in
    another order), and equal to the bit to the plain mix on the kernel's
    own quantized attention; z and sim at the existing bars."""
    from planar_optical_flow_tpu_torch.infer import fast_gate
    from planar_optical_flow_tpu_torch.infer.fast_gate import int8_mix_plain

    rng = np.random.default_rng(5)
    n = 3 * ct
    zx, zt = (torch.tensor(rng.normal(size=(n, 128)) * 0.5,
                           dtype=torch.bfloat16, device=cuda)
              for _ in range(2))
    x, t = (torch.tensor(rng.integers(-127, 128, (n, d)), dtype=torch.int8,
                         device=cuda) for _ in range(2))
    kw = dict(ct=ct, ct_valid=ct_valid, alpha=0.5, window_size=window,
              s_x=0.11, s_t=0.17, s_out=0.13)
    got = gate_int8(zx, zt, x, t, **kw)
    torch.cuda.synchronize()
    ref = gate_int8_plain(zx, zt, x, t, **kw)
    _int8_close(got[0], ref[0])
    _close(got[1], ref[1], BF16_REL)
    _close(got[2], ref[2], 1e-5)
    q = _probe_q(zx, zt, ct, ct_valid, window, d)
    attn, _, _ = fast_gate._attention(zx, zt, ct=ct, ct_valid=ct_valid,
                                      window_size=window)
    q_plain = torch.round(attn * 127.0).int().reshape(n, window)
    assert int((q - q_plain).abs().max()) <= 1 and int(q.max()) > 20
    mix = int8_mix_plain(q.reshape(3, ct, window), x, t, ct=ct,
                         ct_valid=ct_valid, alpha=0.5, s_x=0.11, s_t=0.17,
                         s_out=0.13)
    assert torch.equal(got[0], mix)


@pytest.mark.parametrize("l4", [4, 14])
def test_head_bf16_kernel_blocks(cuda, l4):
    """K4 at 1, T - 1 and T + 1 cutouts (T its cutouts a block), on weights
    laid out once, within the bf16 bar of head_plain."""
    det = _model(4 * l4, 11, cuda).dr_spaam
    conv_w, head_w = fold.head_stack_weights(det.head)
    laid = conv_stack.head_weights_bf16(conv_w)
    tile = int8_tiles.head_bf16_geometry(l4)[0]
    rng = np.random.default_rng(6)
    for n in (1, tile - 1, tile + 1):
        feats = torch.tensor(rng.normal(0.0, 0.5, (n * l4, 256)),
                             dtype=torch.bfloat16, device=cuda)
        n0 = head.launches
        cls, reg = head(feats, laid, head_w, num_classes=1, l4=l4)
        torch.cuda.synchronize()
        assert head.launches == n0 + 1
        cls_p, reg_p = head_plain(feats, conv_w, head_w, l4=l4)
        _close(cls, cls_p, BF16_REL)
        _close(reg, reg_p, BF16_REL)


@pytest.mark.parametrize("ct_len,window", [(16, 5), (56, 11)])
def test_int8_backbone_layer1_forms(cuda, ct_len, window):
    """K9 and K10 (int8 and bf16 feats) against their plain versions; K9
    equal to the bit to plain layer 1 + K10 (the same f32 order)."""
    det = _model(ct_len, window, cuda).dr_spaam
    rng = np.random.default_rng(5)
    n = 37  # not a multiple of the kernels' tile
    cut = torch.tensor(rng.uniform(-1.0, 1.0, (n, ct_len)),
                       dtype=torch.float32, device=cuda)
    blocks = fold.backbone_blocks(det.backbone)
    act1 = backbone_layer1(cut, blocks[0], compute_dtype=torch.float32)
    in_scale, scales = quant.stack_act_scales(
        blocks[1:], act1.reshape(n, ct_len, 64), {1, 4})
    layer1 = (blocks[0][0].reshape(3, -1).contiguous(), blocks[0][1])
    gp = fold.fold_gate_params(det.gate, dtype=torch.bfloat16)
    act1_q = backbone_layer1(cut, layer1, out_scale=in_scale)
    for dequant_last in (False, True):
        q, _, feat_scale = quant.quantize_stack_int8(
            blocks[1:], None, {1, 4}, in_scale=in_scale, act_scales=scales,
            dequant_last=dequant_last)
        we = gp.w if dequant_last else gp.w * torch.tensor(
            feat_scale, dtype=torch.bfloat16, device=cuda)
        args = (quant.kernel_stack_weights(q, cuda), (we.t().contiguous(),
                                                      gp.b))
        out_dtype = torch.bfloat16 if dequant_last else torch.int8
        n0 = backbone_int8_tail.launches
        feats, zx = backbone_int8_tail(act1_q, *args, l=ct_len,
                                       out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert backbone_int8_tail.launches == n0 + 1
        assert feats.dtype == out_dtype
        feats_p, zx_p = backbone_int8_tail_plain(act1_q, *args, l=ct_len,
                                                 out_dtype=out_dtype)
        if dequant_last:
            _close(feats, feats_p, BF16_REL)
        else:
            _int8_close(feats, feats_p)
        _close(zx, zx_p, BF16_REL)
        if dequant_last:
            continue
        n0 = backbone_int8_pm.launches
        feats9, zx9 = backbone_int8_pm(cut, layer1, *args, l=ct_len,
                                       in_scale=in_scale)
        torch.cuda.synchronize()
        assert backbone_int8_pm.launches == n0 + 1
        feats9_p, zx9_p = backbone_int8_pm_plain(cut, layer1, *args,
                                                 l=ct_len, in_scale=in_scale)
        _int8_close(feats9, feats9_p)
        _close(zx9, zx9_p, BF16_REL)
        assert torch.equal(feats9, feats) and torch.equal(zx9, zx)


def test_row_shift_kernel(cuda, monkeypatch):
    """K16 on the JAX pattern and on a longer random input against the
    plain tap construction; the check passes on the card."""
    x, l, exp_left, exp_right = conv_stack.row_shift_pattern()
    n0 = conv_stack.row_shift.launches
    left, right = conv_stack.row_shift(torch.from_numpy(x).to(cuda), l=l)
    torch.cuda.synchronize()
    assert conv_stack.row_shift.launches == n0 + 1
    assert np.array_equal(left.cpu().numpy(), exp_left)
    assert np.array_equal(right.cpu().numpy(), exp_right)
    rng = np.random.default_rng(6)
    big = torch.tensor(rng.integers(-127, 128, (37 * 56, 128)),
                       dtype=torch.int8)
    got = conv_stack.row_shift(big.to(cuda), l=56)
    ref = conv_stack.row_shift(big, l=56)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    monkeypatch.setattr(conv_stack, "_ROW_SHIFT_OK", set())
    conv_stack.check_row_shift(cuda)
    assert str(cuda) in conv_stack._ROW_SHIFT_OK


# the fused int8c kernels, at the tests' geometry (64 beams of which 60 are
# real, 16 points, window 5) and the flagship one (450 beams, 56, 11)
FUSED_GEOMETRY = [(60, 16, 5), (450, 56, 11)]


def _fused_setup(cuda, num_pts, ct_len, window):
    """(weights and scales of the int8c step, head cls/reg weights, gate
    params, cutout arguments, 3 streams x 2 scans), calibrated on the
    scans."""
    model = _model(ct_len, window, cuda)
    cut_kw = dict(num_cutout_pts=ct_len, window_width=1.0, window_depth=0.5,
                  padding_val=29.99, centered=True, area_mode=True)
    rng = np.random.default_rng(7)
    scans = torch.tensor(rng.uniform(0.5, 20.0, (2, 3, num_pts)),
                         dtype=torch.float32, device=cuda)
    calib = calibrate_serve_v3(model, dict(cut_kw, fixed=True), scans[0],
                               num_pts=num_pts, device=cuda)
    det = model.dr_spaam
    return (int8_weights(det, calib, cuda), fold.head_linear_weights(det.head),
            fold.fold_gate_params(det.gate), dict(cut_kw, p_valid=num_pts),
            scans)


def _pad(scan, p):
    return F.pad(scan, (0, p - scan.shape[-1]))


def _gate_kw(w, gp, ct, num_pts):
    return dict(ct=ct, ct_valid=num_pts, alpha=gp.alpha,
                window_size=gp.window_size, s_x=w.feat_scale,
                s_t=w.tmpl_scale, s_out=w.tmpl_scale)


@pytest.mark.parametrize("num_pts,ct_len,window", FUSED_GEOMETRY)
def test_backbone_int8_cut_kernel(cuda, num_pts, ct_len, window):
    """K8 against its plain version, and equal to K1 then K5."""
    w, _, _, cut_kw, scans = _fused_setup(cuda, num_pts, ct_len, window)
    padded = _pad(scans[0], -(-num_pts // 8) * 8)
    args = (padded, w.layer1, w.backbone, w.embed)
    n0 = conv_stack.backbone_int8_cut.launches
    feats, zx = conv_stack.backbone_int8_cut(*args, **cut_kw)
    torch.cuda.synchronize()
    assert conv_stack.backbone_int8_cut.launches == n0 + 1
    feats_p, zx_p = conv_stack.backbone_int8_cut_plain(*args, **cut_kw)
    _int8_close(feats, feats_p)
    _close(zx, zx_p, BF16_REL)
    feats5, zx5 = backbone_int8(cutout(padded, **cut_kw), w.layer1,
                                w.backbone, w.embed, l=ct_len)
    assert torch.equal(feats, feats5) and torch.equal(zx, zx5)


@pytest.mark.parametrize("num_pts,ct_len,window", FUSED_GEOMETRY)
def test_gate_head_int8_kernel(cuda, num_pts, ct_len, window):
    """K12 on a carried step against its plain version, and equal to K6
    then K7."""
    w, head_w, gp, cut_kw, scans = _fused_setup(cuda, num_pts, ct_len,
                                                 window)
    ct, l4 = -(-num_pts // 8) * 8, ct_len // 4
    (f0, z0), (f1, z1) = (backbone_int8(cutout(_pad(s, ct), **cut_kw),
                                        w.layer1, w.backbone, w.embed,
                                        l=ct_len) for s in scans)
    x = f0.reshape(z0.shape[0], -1)
    tmpl = quant.quantize_int8(f1.float().reshape(x.shape) * w.feat_scale,
                               w.tmpl_scale)
    args = (z0, z1, x, tmpl, w.head, head_w)
    kw = dict(_gate_kw(w, gp, ct, num_pts), num_classes=1, l4=l4)
    n0 = gate_head_int8.launches
    got = gate_head_int8(*args, **kw)
    torch.cuda.synchronize()
    assert gate_head_int8.launches == n0 + 1
    ref = gate_head_int8_plain(*args, **kw)
    _int8_close(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        _close(g, r, BF16_REL)
    chain = gate_int8(z0, z1, x, tmpl, **_gate_kw(w, gp, ct, num_pts))
    chain += head_int8(chain[0].reshape(-1, 256), w.head, head_w,
                       num_classes=1, l4=l4)
    for g, c in zip(got, chain):
        assert torch.equal(g, c)


@pytest.mark.parametrize("num_pts,p,ct_len,window",
                         [(37, 40, 16, 5), (37, 40, 56, 11),
                          (450, 456, 56, 11)])
def test_backbone_int8_cut_partial_tile(cuda, num_pts, p, ct_len, window):
    """K8 at 40 and 456 beams a stream (blocks of 16 beams of one stream,
    the last of 8): on the weights laid out once and on the triples, equal
    to K1 then K5 to the bit, and within the bars of its plain version."""
    w, _, _, cut_kw, scans = _fused_setup(cuda, num_pts, ct_len, window)
    assert p % int8_tiles.cut_geometry(ct_len, p)[0]
    padded = _pad(scans[0], p)
    bb = conv_stack.backbone_weights_int8(w.backbone)
    n0 = conv_stack.backbone_int8_cut.launches
    got = conv_stack.backbone_int8_cut(padded, w.layer1, bb, w.embed,
                                       **cut_kw)
    torch.cuda.synchronize()
    assert conv_stack.backbone_int8_cut.launches == n0 + 1
    raw = conv_stack.backbone_int8_cut(padded, w.layer1, w.backbone, w.embed,
                                       **cut_kw)
    chain = backbone_int8(cutout(padded, **cut_kw), w.layer1, bb, w.embed,
                          l=ct_len)
    for g, r, c in zip(got, raw, chain):
        assert torch.equal(g, r) and torch.equal(g, c)
    ref = conv_stack.backbone_int8_cut_plain(padded, w.layer1, w.backbone,
                                             w.embed, **cut_kw)
    _int8_close(got[0], ref[0])
    _close(got[1], ref[1], BF16_REL)


@pytest.mark.parametrize("num_pts,ct,ct_len,window",
                         [(37, 40, 16, 5), (37, 40, 56, 11),
                          (37, 40, 16, 21), (450, 456, 56, 11)])
def test_gate_head_int8_partial_tile(cuda, num_pts, ct, ct_len, window):
    """K12 at 40 and 456 rows a stream (blocks of 16 rows of one stream, the
    last of 8), window 5, 11 and 21 (two k32 steps of the band): on the
    head laid out once and on the triples, equal to K6 then K7 to the bit,
    and within the bars of its plain version."""
    w, head_w, gp, cut_kw, scans = _fused_setup(cuda, num_pts, ct_len,
                                                 window)
    l4 = ct_len // 4
    assert ct % int8_tiles.gate_head_geometry(l4)[0]
    bb = conv_stack.backbone_weights_int8(w.backbone)
    hd = conv_stack.head_weights_int8(w.head)
    (f0, z0), (f1, z1) = (backbone_int8(cutout(_pad(s, ct), **cut_kw),
                                        w.layer1, bb, w.embed, l=ct_len)
                          for s in scans)
    x = f0.reshape(z0.shape[0], -1)
    tmpl = quant.quantize_int8(f1.float().reshape(x.shape) * w.feat_scale,
                               w.tmpl_scale)
    gkw = _gate_kw(w, gp, ct, num_pts)
    kw = dict(gkw, num_classes=1, l4=l4)
    n0 = gate_head_int8.launches
    got = gate_head_int8(z0, z1, x, tmpl, hd, head_w, **kw)
    torch.cuda.synchronize()
    assert gate_head_int8.launches == n0 + 1
    raw = gate_head_int8(z0, z1, x, tmpl, w.head, head_w, **kw)
    chain = gate_int8(z0, z1, x, tmpl, **gkw)
    chain += head_int8(chain[0].reshape(-1, 256), hd, head_w, num_classes=1,
                       l4=l4)
    for g, r, c in zip(got, raw, chain):
        assert torch.equal(g, r) and torch.equal(g, c)
    ref = gate_head_int8_plain(z0, z1, x, tmpl, w.head, head_w, **kw)
    _int8_close(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        _close(g, r, BF16_REL)


@pytest.mark.parametrize("num_pts,ct_len,window", FUSED_GEOMETRY)
def test_serve_cell_int8_kernel(cuda, num_pts, ct_len, window):
    """K13 on a carried step against its plain version, and equal to K9,
    K6 then K7."""
    w, head_w, gp, cut_kw, scans = _fused_setup(cuda, num_pts, ct_len,
                                                 window)
    ct, l4 = -(-num_pts // 32) * 32, ct_len // 4
    cuts = [cutout(_pad(s, ct), **cut_kw) for s in scans]
    feats, zt = backbone_int8_pm(cuts[0], w.layer1_div, w.backbone, w.embed,
                                 l=ct_len, in_scale=w.in_scale)
    tmpl = quant.quantize_int8(feats.float().reshape(zt.shape[0], -1)
                               * w.feat_scale, w.tmpl_scale)
    args = (cuts[1], zt, tmpl, w.layer1_div, w.backbone, w.embed, w.head,
            head_w)
    gkw = _gate_kw(w, gp, ct, num_pts)
    kw = dict(gkw, l=ct_len, in_scale=w.in_scale, num_classes=1)
    n0 = serve_cell_int8.launches
    got = serve_cell_int8(*args, **kw)
    torch.cuda.synchronize()
    assert serve_cell_int8.launches == n0 + 1
    ref = serve_cell_int8_plain(*args, **kw)
    _int8_close(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        _close(g, r, BF16_REL)
    x, zx = backbone_int8_pm(cuts[1], w.layer1_div, w.backbone, w.embed,
                             l=ct_len, in_scale=w.in_scale)
    chain = gate_int8(zx, zt, x.reshape(zx.shape[0], -1), tmpl, **gkw)
    chain += head_int8(chain[0].reshape(-1, 256), w.head, head_w,
                       num_classes=1, l4=l4)
    for g, c in zip(got, chain):
        assert torch.equal(g, c)


@pytest.mark.parametrize("num_pts,ct_len,window",
                         [(37, 16, 5), (37, 56, 11), (37, 16, 21)])
def test_serve_cell_int8_partial_tile(cuda, num_pts, ct_len, window):
    """K13 at 40 rows a stream (blocks of 16, 16 and 8 rows), 37 of them
    valid, window 5, 11 and 21 (two k32 steps of the band): on the weights
    laid out once and on the triples, equal to K9, K6 then K7 to the bit,
    and within the bars of its plain version."""
    w, head_w, gp, cut_kw, scans = _fused_setup(cuda, num_pts, ct_len,
                                                 window)
    ct, l4 = 40, ct_len // 4
    assert ct % int8_tiles.cell_geometry(ct_len)[0]
    cuts = [cutout(_pad(s, ct), **cut_kw) for s in scans]
    bb = conv_stack.backbone_weights_int8(w.backbone)
    hd = conv_stack.head_weights_int8(w.head)
    feats, zt = backbone_int8_pm(cuts[0], w.layer1_div, bb, w.embed,
                                 l=ct_len, in_scale=w.in_scale)
    tmpl = quant.quantize_int8(feats.float().reshape(zt.shape[0], -1)
                               * w.feat_scale, w.tmpl_scale)
    gkw = _gate_kw(w, gp, ct, num_pts)
    kw = dict(gkw, l=ct_len, in_scale=w.in_scale, num_classes=1)
    n0 = serve_cell_int8.launches
    got = serve_cell_int8(cuts[1], zt, tmpl, w.layer1_div, bb,
                          cell_embed(w.embed), hd, head_w, **kw)
    torch.cuda.synchronize()
    assert serve_cell_int8.launches == n0 + 1
    raw = serve_cell_int8(cuts[1], zt, tmpl, w.layer1_div, w.backbone,
                          w.embed, w.head, head_w, **kw)
    x, zx = backbone_int8_pm(cuts[1], w.layer1_div, bb, w.embed, l=ct_len,
                             in_scale=w.in_scale)
    chain = gate_int8(zx, zt, x.reshape(zx.shape[0], -1), tmpl, **gkw)
    chain += head_int8(chain[0].reshape(-1, 256), hd, head_w, num_classes=1,
                       l4=l4)
    for g, r, c in zip(got, raw, chain):
        assert torch.equal(g, r) and torch.equal(g, c)
    ref = serve_cell_int8_plain(cuts[1], zt, tmpl, w.layer1_div, w.backbone,
                                w.embed, w.head, head_w, **kw)
    _int8_close(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        _close(g, r, BF16_REL)


@pytest.mark.parametrize("l4", [4, 14])
def test_fused_head_bf16_blocks(cuda, l4):
    """K14's bf16 head (K4's kernel on f32 feats) at 1, T - 1 and T + 3
    cutouts (T its cutouts a block), on weights laid out once and on the
    pairs (equal to the bit), within the bf16 bar of fused_head_plain."""
    det = _model(4 * l4, 11, cuda).dr_spaam
    w_hd = fd.head_weights(det.head)
    laid = fd.head_weights_bf16(w_hd)
    tile = int8_tiles.head_bf16_geometry(l4)[0]
    rng = np.random.default_rng(12)
    for n in (1, tile - 1, tile + 3):
        feats = torch.tensor(rng.normal(0.0, 0.5, (n, l4, 256)),
                             dtype=torch.float32, device=cuda)
        n0 = fd.fused_head.launches
        got = fd.fused_head(feats, laid, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert fd.fused_head.launches == n0 + 1
        pairs = fd.fused_head(feats, w_hd, compute_dtype=torch.bfloat16)
        ref = fd.fused_head_plain(feats, w_hd, compute_dtype=torch.bfloat16)
        for g, p, r in zip(got, pairs, ref):
            assert torch.equal(g, p)
            _close(g, r, BF16_REL)


@pytest.mark.parametrize("ct_len,window", [(16, 5), (56, 11)])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_fused_drow_kernels(cuda, ct_len, window, mode):
    """K14's backbone and head against their plain versions, at a row count
    that is a multiple of neither tile."""
    det = _model(ct_len, window, cuda).dr_spaam
    dt = torch.float32 if mode == "f32" else torch.bfloat16
    rng = np.random.default_rng(8)
    cut = torch.tensor(rng.normal(0.0, 0.6, (37, ct_len)),
                       dtype=torch.float32, device=cuda)
    w_bb, w_hd = fd.backbone_weights(det.backbone), fd.head_weights(det.head)
    n0 = (fd.fused_backbone.launches, fd.fused_head.launches)
    feats = fd.fused_backbone(cut, w_bb, compute_dtype=dt)
    cls, reg = fd.fused_head(feats, w_hd, compute_dtype=dt)
    torch.cuda.synchronize()
    assert (fd.fused_backbone.launches, fd.fused_head.launches) == (
        n0[0] + 1, n0[1] + 1)
    pairs = [(feats, fd.fused_backbone_plain(cut, w_bb, compute_dtype=dt))]
    pairs += list(zip((cls, reg), fd.fused_head_plain(feats, w_hd,
                                                      compute_dtype=dt)))
    for got, ref in pairs:
        if mode == "f32":
            lim = 1e-3 * ref.abs() + 1e-4 * ref.abs().max()
            assert bool(((got - ref).abs() <= lim).all())
        else:
            _close(got, ref, BF16_REL)


def test_gate_f32_kernel(cuda):
    """K3's f32 mode at an unpadded ct (450 rows a stream, and 64)."""
    rng = np.random.default_rng(9)
    for ct, window, d in ((64, 5, 1024), (450, 11, 3584)):
        n = 2 * ct
        args = [torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                             device=cuda)
                for shape in ((n, 128), (n, 128), (n, d), (n, d))]
        kw = dict(ct=ct, alpha=0.5, window_size=window)
        got = gate(*args, **kw)
        torch.cuda.synchronize()
        ref = gate_plain(*args, **kw)
        for g, r, tol in zip(got, ref, (2e-5, 2e-4, 2e-4)):
            assert g.dtype == torch.float32
            assert torch.allclose(g, r, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_banded_mix_kernel(cuda, dtype):
    """K15 equal to its plain version to the bit, at 450 rows a stream and
    at 40 with window 21 (every tile's halo wraps) and D = 1000 (a partial
    last chunk)."""
    rng = np.random.default_rng(10)
    for b, ct, window, d in ((3, 450, 11, 3584), (2, 40, 21, 1000)):
        attn = torch.tensor(rng.uniform(0.0, 1.0, (b, ct, window)),
                            dtype=torch.float32, device=cuda)
        x, t = (torch.tensor(rng.normal(size=(b, ct, d)), dtype=dtype,
                             device=cuda) for _ in range(2))
        n0 = banded_mix_update.launches
        got = banded_mix_update(attn, x, t, 0.5, window)
        torch.cuda.synchronize()
        assert banded_mix_update.launches == n0 + 1 and got.dtype == dtype
        ref = banded_mix_update_plain(attn, x, t, 0.5, window)
        assert torch.equal(got, ref)


def test_quantized_stack_on_the_card(cuda):
    """The int8 stacks' torch._int_mm sums on the card equal the float64
    sums of the CPU, so the card and the CPU give the same activations."""
    det = _model(16, 5, cuda).dr_spaam
    rng = np.random.default_rng(11)
    cut = rng.normal(0.0, 0.5, (40, 16)).astype(np.float32)
    w_bb = [(w.cpu(), b.cpu()) for w, b in fd.backbone_weights(det.backbone)]
    cpu = qd.build_quantized_backbone(w_bb, cut, device="cpu")
    card = qd.build_quantized_backbone(w_bb, cut, device=cuda)
    x = torch.from_numpy(cut[..., None])
    q = cpu.quantize_input(x)
    assert torch.equal(card.quantize_input(x.to(cuda)).cpu(), q)
    assert torch.equal(card(q.to(cuda)).cpu(), cpu(q))


def _drow_split(path, num_pts):
    from planar_optical_flow_tpu_torch.data import write_synthetic_drow_split

    write_synthetic_drow_split(str(path), "val", num_sequences=2,
                               num_frames=30, num_people=8, seed=0,
                               num_pts=num_pts)
    return str(path)


@pytest.mark.parametrize("num_pts", [64, 450])
def test_dataset_targets_on_the_card(cuda, tmp_path, num_pts):
    """The dataset's targets computed on the card equal the CPU's: class
    and exclude mask exact, offsets and flow within 1e-5."""
    from planar_optical_flow_tpu_torch.data import DrowDetectionDataset

    root = _drow_split(tmp_path, num_pts)
    kw = dict(num_scans=2, pedestrian_only=True)
    card = DrowDetectionDataset(root, "val", device=cuda, **kw)
    cpu = DrowDetectionDataset(root, "val", device="cpu", **kw)
    for k in ("target_cls", "exclude_mask"):
        assert getattr(card, k).dtype == getattr(cpu, k).dtype
        np.testing.assert_array_equal(getattr(card, k), getattr(cpu, k))
    for k in ("target_reg", "target_flow"):
        np.testing.assert_allclose(getattr(card, k), getattr(cpu, k),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("engine", ["v3", "int8c"])
def test_detection_ap_on_the_card(cuda, tmp_path, engine):
    """evaluate_detection_ap_batched on the card against the same call on
    the CPU (the kernels' plain versions): the same frames, AP within
    0.02."""
    from planar_optical_flow_tpu_torch.data import DrowDetectionDataset
    from planar_optical_flow_tpu_torch.eval import (
        evaluate_detection_ap_batched,
    )

    root = _drow_split(tmp_path, 64)
    ds = DrowDetectionDataset(root, "val", num_scans=2, pedestrian_only=True,
                              device="cpu")
    kw = dict(fixed=True, centered=True, window_width=1.0, window_depth=0.5,
              num_cutout_pts=16, padding_val=29.99, area_mode=True)
    got = {dev: evaluate_detection_ap_batched(
        _model(16, 5, dev), kw, ds, batch_streams=8, conf_thresh=0.3,
        engine=engine, device=dev) for dev in (cuda, "cpu")}
    assert got[cuda]["num_frames"] == got["cpu"]["num_frames"] == len(ds)
    assert abs(got[cuda]["ap"] - got["cpu"]["ap"]) <= 0.02, got
