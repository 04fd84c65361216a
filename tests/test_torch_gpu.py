"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip without a card and run on one with
``python -m pytest -m gpu tests/test_torch_gpu.py``. Shapes are the test
geometry (16 cutout points, window 5) and the flagship one (56 points,
window 11), at a few streams.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from planar_optical_flow_tpu_torch.infer.fast_gate import gate, gate_plain
from planar_optical_flow_tpu_torch.models import FlowDrow
from planar_optical_flow_tpu_torch.ops.kernels import fold
from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
    backbone_layer1,
    backbone_tail,
    backbone_tail_plain,
    head,
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
