"""The operation counts against a count of the reference's own products
(``torch.utils.flop_counter``) at a small shape."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, peaks, weights
from portbench.harness import template_state_dict
from portbench.reference.model import Reference
from portbench.tests.tiny import REAL


def _cfg(name):
    return json.loads((REAL / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("c", [8, 56])
def test_backbone_and_head_counts(c):
    cfg = _cfg("flowdrow-int8c")
    cfg["cutout"]["num_cutout_pts"] = c
    sd = weights.make_state_dict(template_state_dict(cfg), 1, "cpu")
    ref = Reference(sd, cfg)
    n = 5
    with FlopCounterMode(display=False) as fc:
        feats = ref.backbone(torch.rand(n, c))
    bb = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        ref.head(feats)
    hd = fc.get_total_flops()
    assert bb == n * (counts.layer1_ops(c) + counts.backbone_tail_ops(c))
    assert hd == n * (counts.head_conv_ops(c) + counts.head_linear_ops())
    assert feats.shape[1] == counts.feat_dim(c)


def test_hand_count_at_56_taps():
    # conv 64->64 at 56 positions, 3 taps: 2 * 56 * 3 * 64 * 64
    assert counts._conv(56, 64, 64) == 1376256
    assert counts.backbone_tail_ops(56) == 2 * (56 * 3 * (64 * 64 + 64 * 128)
                                                + 28 * 3 * (2 * 128 * 128
                                                            + 128 * 256))
    assert counts.embed_ops(56) == 2 * 3584 * 128


def test_step_ops_split_by_precision():
    cfg = _cfg("flowdrow-int8c")
    ops = counts.step_ops(cfg)
    c, w = 56, 11
    assert ops["int8"] == (counts.backbone_tail_ops(c)
                           + counts.head_conv_ops(c)
                           + counts.gate_mix_ops(c, w))
    assert ops["f32"] == counts.layer1_ops(c) + counts.head_linear_ops()
    ideal_ms = peaks.ideal_s({k: v * 384 * 450 for k, v in ops.items()}) * 1e3
    assert 3.5 < ideal_ms < 4.5
    bf = counts.step_ops(_cfg("drspaam-bf16"))
    assert "int8" not in bf and "flow" not in json.dumps(bf)
    assert peaks.bound_s({"bf16": 989e12}, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s({}, 3.35e12) == pytest.approx(1.0)
