"""The CUDA kernels (K1-K7, K9, K10, K16) against their plain PyTorch
versions, on the card.

Marked ``gpu``: they skip without a card and run on one with
``python -m pytest -m gpu --noconftest tests/test_torch_gpu.py``. Shapes
are the test geometry (16 cutout points, window 5) and the flagship one
(56 points, window 11), at a few streams. bf16 outputs within 2e-2 x
max|plain|; int8 outputs within 1 LSB with under 5e-3 of them off by one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from planar_optical_flow_tpu_torch.infer.fast_gate import (
    gate,
    gate_int8,
    gate_int8_plain,
    gate_plain,
)
from planar_optical_flow_tpu_torch.models import FlowDrow
from planar_optical_flow_tpu_torch.ops.kernels import conv_stack, fold, quant
from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
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
@pytest.mark.parametrize("p,p_valid,c", [(64, 60, 16), (456, 450, 56)])
def test_cutout_kernel(cuda, area_mode, p, p_valid, c):
    rng = np.random.default_rng(0)
    scans = torch.tensor(rng.uniform(0.3, 28.0, (5, p)), dtype=torch.float32,
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


@pytest.mark.parametrize("ct,ct_valid,window,d", [(64, 60, 5, 1024),
                                                  (456, 450, 11, 3584)])
def test_gate_kernel(cuda, ct, ct_valid, window, d):
    rng = np.random.default_rng(2)
    n = 3 * ct

    def bf(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.bfloat16,
                            device=cuda)

    args = (bf(n, 128), bf(n, 128), bf(n, d), bf(n, d))
    kw = dict(ct=ct, ct_valid=ct_valid, alpha=0.5, window_size=window)
    got = gate(*args, **kw)
    torch.cuda.synchronize()
    ref = gate_plain(*args, **kw)
    for g, r in zip(got, ref):
        _close(g, r, BF16_REL)


@pytest.mark.parametrize("ct_len,window", [(16, 5), (56, 11)])
def test_int8_stack_kernels(cuda, ct_len, window):
    """K5 and K7 against their plain versions, with scales calibrated on
    the same cutouts."""
    det = _model(ct_len, window, cuda).dr_spaam
    rng = np.random.default_rng(3)
    n, l4 = 37, ct_len // 4  # n is not a multiple of the kernels' tile
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
    args = (cut, quant.layer1_int8_weights(blocks[0], in_scale, cuda),
            quant.kernel_stack_weights(q, cuda), (we.t().contiguous(), gp.b))
    n0 = backbone_int8.launches
    feats, zx = backbone_int8(*args, l=ct_len)
    torch.cuda.synchronize()
    assert backbone_int8.launches == n0 + 1
    feats_p, zx_p = backbone_int8_plain(*args, l=ct_len)
    _int8_close(feats, feats_p)
    _close(zx, zx_p, BF16_REL)

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
