"""The port's training pieces against the JAX package's, on the CPU.

Geometry of ``tests/test_fused_frozen.py``: 64 beams, 16 cutout points,
window 5, S=3 scans, B=2. Weights come from flax ``init`` with perturbed
BatchNorm statistics, carried across by the flax bridge; inputs are made
from a seed with numpy. Bars: f32 1e-5 relative (BatchNorm), 1e-6
(optimizer, losses), 1e-3 (train steps, the ROADMAP f32 bar); bf16 one bf16
ulp of the max (BatchNorm) or JAX's bf16 bar (corr > 0.99, max |d| < 0.05
max(|ref|, 1); ``tests/test_fused_frozen.py:55-57``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from planar_optical_flow_tpu import ops as jax_ops
from planar_optical_flow_tpu.models.blocks import ConvBlock as JaxConvBlock
from planar_optical_flow_tpu.models.spatial_drow import (
    SpatialAttentionGate as JaxGate,
)
from planar_optical_flow_tpu.train import exp_decay_schedule as jax_schedule
from planar_optical_flow_tpu.train import make_optimizer as jax_optimizer
from planar_optical_flow_tpu.train.fused_frozen import (
    frozen_detector_forward as jax_frozen_forward,
)
from planar_optical_flow_tpu_torch.interop import variables_to_state_dict
from planar_optical_flow_tpu_torch.models.blocks import ConvBlock
from planar_optical_flow_tpu_torch.models.spatial_drow import (
    SpatialAttentionGate,
)
from planar_optical_flow_tpu_torch.ops import losses
from planar_optical_flow_tpu_torch.train import (
    exp_decay_schedule,
    make_optimizer,
)
from planar_optical_flow_tpu_torch.train.fused_frozen import (
    frozen_detector_forward,
)
from planar_optical_flow_tpu_torch.train.state import named_stats, set_stats

from tests.test_torch_common import one_thread  # noqa: F401
from tests.test_torch_common import (
    CT_LEN,
    NUM_PTS,
    WINDOW,
    flow_drow_pair,
    perturb_batch_stats,
    t2n,
    to_jax,
)

S_SCANS, BATCH = 3, 2


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


def bf16_bar(got, ref, what=""):
    """JAX's bf16 bar: corr > 0.99 (where the reference varies) and max
    |got - ref| < 0.05 * max(|ref|, 1)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if ref.size > 1 and ref.std() > 0:
        corr = np.corrcoef(got.ravel(), ref.ravel())[0, 1]
        assert corr > 0.99, f"{what}: corr {corr}"
    err = np.abs(got - ref).max()
    assert err < 0.05 * max(np.abs(ref).max(), 1.0), f"{what}: {err}"


def f32_bar(got, ref, rel, what=""):
    """max |got - ref| <= rel * max(max |ref|, 1)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    lim = rel * max(np.abs(ref).max(), 1.0)
    assert err <= lim, f"{what}: max abs err {err:.3g} > {lim:.3g}"


def bf16_ulp_of_max(got, ref, what=""):
    """Within one bf16 ulp of max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    err = np.abs(got - ref).max()
    assert err <= ulp, f"{what}: {err} > one bf16 ulp {ulp}"


def _cast_tree(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


# ------------------------------------------------------------ BatchNorm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_block_train_mode_matches_flax(dtype):
    """A ConvBlock on batch statistics, two calls in a row: outputs and
    running statistics against flax's ``nn.BatchNorm(momentum=0.9)`` (the
    bf16 case hands in bf16-cast parameters and statistics, as the
    trainer does)."""
    rng = np.random.default_rng(0)
    jm = JaxConvBlock(32)
    x = rng.normal(0.5, 2.0, (4, 24, 8)).astype(np.float32)
    v = perturb_batch_stats(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                    train=False), rng)
    port = ConvBlock(8, 32, generator=torch.Generator().manual_seed(0))
    port.load_state_dict(variables_to_state_dict(v, port))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    params, stats = _cast_tree(v["params"], jdt), _cast_tree(
        v["batch_stats"], jdt)
    set_stats(port, {n: t.to(tdt) for n, t in named_stats(port).items()})
    for call in range(2):
        xi = x * (1.0 + call)
        ref, mut = jm.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(xi, jdt), train=True,
                            mutable=["batch_stats"])
        stats = mut["batch_stats"]
        got = port(torch.tensor(xi).to(tdt), train=True)
        assert got.dtype == tdt
        check = (bf16_ulp_of_max if dtype == "bfloat16"
                 else lambda g, r, w: f32_bar(g, r, 1e-5, w))
        check(t2n(got), np.asarray(ref, np.float32), f"out {call}")
        for key, name in (("mean", "running_mean"), ("var", "running_var")):
            check(t2n(getattr(port.bn, name)),
                  np.asarray(stats["BatchNorm_0"][key], np.float32),
                  f"{key} {call}")
            assert getattr(port.bn, name).dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_block_train_mode_matches_flax(dtype):
    """``DenseBlock`` (Dense + BatchNorm + LeakyReLU) on batch statistics
    against flax's, outputs and running statistics; ``upsample_nearest``
    against JAX's."""
    from planar_optical_flow_tpu.models.blocks import (
        DenseBlock as JaxDenseBlock,
        upsample_nearest as jax_upsample,
    )
    from planar_optical_flow_tpu_torch.models.blocks import (
        DenseBlock,
        upsample_nearest,
    )

    rng = np.random.default_rng(5)
    x = rng.normal(0.3, 1.5, (6, 5, 12)).astype(np.float32)
    jm = JaxDenseBlock(20)
    v = perturb_batch_stats(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                    train=False), rng)
    port = DenseBlock(12, 20, generator=torch.Generator().manual_seed(0))
    port.load_state_dict(variables_to_state_dict(v, port))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    set_stats(port, {n: t.to(tdt) for n, t in named_stats(port).items()})
    ref, mut = jm.apply({"params": _cast_tree(v["params"], jdt),
                         "batch_stats": _cast_tree(v["batch_stats"], jdt)},
                        jnp.asarray(x, jdt), train=True,
                        mutable=["batch_stats"])
    got = port(torch.tensor(x).to(tdt), train=True)
    pairs = [(t2n(got), np.asarray(ref, np.float32), "out")] + [
        (t2n(getattr(port.bn, name)),
         np.asarray(mut["batch_stats"]["BatchNorm_0"][key], np.float32), key)
        for key, name in (("mean", "running_mean"), ("var", "running_var"))]
    for g, r, what in pairs:
        if dtype == "float32":
            f32_bar(g, r, 1e-5, what)
        else:
            bf16_ulp_of_max(g, r, what)
    for n in (7, 10, 23):
        np.testing.assert_array_equal(
            t2n(upsample_nearest(torch.tensor(x), n)),
            np.asarray(jax_upsample(jnp.asarray(x), n)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gate_embed_bn_runs_twice_a_step(dtype):
    """The gate in train mode calls ``embed_bn`` on x and then on the
    template: two running updates a gate step, in that order."""
    rng = np.random.default_rng(1)
    d = (CT_LEN // 4) * 256
    jm = JaxGate(window_size=WINDOW)
    x = rng.normal(0, 1, (BATCH, NUM_PTS, d)).astype(np.float32)
    t = rng.normal(0, 1, (BATCH, NUM_PTS, d)).astype(np.float32)
    v = perturb_batch_stats(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                    jnp.asarray(t), train=False), rng)
    port = SpatialAttentionGate(d, 0.5, WINDOW,
                                generator=torch.Generator().manual_seed(0))
    port.load_state_dict(variables_to_state_dict(v, port))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    (ref_t, ref_sim), mut = jm.apply(
        {"params": _cast_tree(v["params"], jdt),
         "batch_stats": _cast_tree(v["batch_stats"], jdt)},
        jnp.asarray(x, jdt), jnp.asarray(t, jdt), train=True,
        mutable=["batch_stats"])
    set_stats(port, {n: t_.to(tdt) for n, t_ in named_stats(port).items()})
    got_t, got_sim = port(torch.tensor(x).to(tdt), torch.tensor(t).to(tdt),
                          train=True)
    # the expected two updates, by hand from flax's BatchNorm on x and t
    ra = {k: np.asarray(v["batch_stats"]["embed_bn"][k], np.float32)
          for k in ("mean", "var")}
    for key, name in (("mean", "running_mean"), ("var", "running_var")):
        want = np.asarray(mut["batch_stats"]["embed_bn"][key], np.float32)
        assert not np.allclose(want, ra[key])
        got = t2n(getattr(port.embed_bn, name))
        if dtype == "float32":
            f32_bar(got, want, 1e-5, key)
        else:
            bf16_ulp_of_max(got, want, key)
    if dtype == "float32":
        f32_bar(t2n(got_t), np.asarray(ref_t), 1e-5, "template")
        f32_bar(t2n(got_sim), np.asarray(ref_sim), 1e-4, "sim")
    else:
        bf16_bar(t2n(got_t), np.asarray(ref_t, np.float32), "template")
        bf16_bar(t2n(got_sim), np.asarray(ref_sim, np.float32), "sim")


def test_dropout_statistics():
    """Dropout keeps ``1 - rate`` of the elements, scaled by its inverse;
    eval mode and rate 0 are the identity."""
    from planar_optical_flow_tpu_torch.models.blocks import dropout

    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(0)
    y = dropout(x, 0.3, True, g)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.7) < 5e-3
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.7))
    assert abs(y.mean().item() - 1.0) < 1e-2
    assert dropout(x, 0.3, False, g) is x
    assert dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="rng"):
        dropout(x, 0.3, True, None)


# ------------------------------------------------------------ optimizer


def _falling_grads(rng, shapes, n=6):
    """Gradients that fall step by step (the second moment falls too)."""
    return [{k: (rng.normal(0, 1, s) * 10.0 ** -i).astype(np.float32)
             for k, s in shapes.items()} for i in range(n)]


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_amsgrad_matches_optax(clip):
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = _falling_grads(rng, shapes)
    cfg = {"scheduler_kwargs": {"epoch0": 0, "lr0": 1e-2, "epoch1": 3,
                                "lr1": 1e-4}, "grad_norm_clip": clip}
    jtx = jax_optimizer(cfg, steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    tx = make_optimizer(cfg, steps_per_epoch=2)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    state = tx.init(tp)
    for g in grads:
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        state = tx.apply(tp, {k: torch.tensor(v) for k, v in g.items()},
                         state)
        for k in shapes:
            np.testing.assert_allclose(t2n(tp[k]), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    amsgrad_state = jstate[-1][0]  # chain: [clip,] amsgrad, schedule
    np.testing.assert_allclose(t2n(state["nu_max"]["a"]),
                               np.asarray(amsgrad_state.nu_max["a"]),
                               rtol=1e-6)
    assert state["count"] == len(grads)


def test_torch_adam_amsgrad_differs_from_optax():
    """torch's AMSGrad keeps the maximum of the raw second moment: once the
    gradients fall, its steps differ from optax's (and the port's)."""
    rng = np.random.default_rng(3)
    grads = _falling_grads(rng, {"a": (8,)})
    p0 = rng.normal(0, 1, 8).astype(np.float32)
    cfg = {"scheduler_kwargs": {"lr0": 1e-2, "lr1": 1e-2}}
    tx = make_optimizer(cfg, steps_per_epoch=1)
    tp = {"a": torch.tensor(p0)}
    state = tx.init(tp)
    w = torch.nn.Parameter(torch.tensor(p0))
    adam = torch.optim.Adam([w], lr=1e-2, amsgrad=True)
    jtx = optax.amsgrad(1e-2)
    jp = jnp.asarray(p0)
    jstate = jtx.init(jp)
    for g in grads:
        state = tx.apply(tp, {"a": torch.tensor(g["a"])}, state)
        w.grad = torch.tensor(g["a"])
        adam.step()
        upd, jstate = jtx.update(jnp.asarray(g["a"]), jstate, jp)
        jp = optax.apply_updates(jp, upd)
    np.testing.assert_allclose(t2n(tp["a"]), np.asarray(jp), rtol=1e-6)
    assert np.abs(t2n(w) - np.asarray(jp)).max() > 1e-3


def test_schedule_and_frozen_mask():
    for kw in (dict(epoch0=0, lr0=1e-3, epoch1=100, lr1=1e-6,
                    steps_per_epoch=10),
               dict(epoch0=2, lr0=1e-3, epoch1=5, lr1=1e-5,
                    steps_per_epoch=7)):
        ours, ref = exp_decay_schedule(**kw), jax_schedule(**kw)
        for step in (0, 1, 13, 20, 35, 500, 1000, 20000):
            np.testing.assert_allclose(ours(step), float(ref(step)),
                                       rtol=1e-6)
    # a frozen parameter keeps its value and has no state
    tx = make_optimizer({}, 1, frozen_mask={"a": True, "b": False})
    p = {"a": torch.ones(3), "b": torch.ones(3)}
    state = tx.init(p)
    assert set(state["mu"]) == {"a"}
    state = tx.apply(p, {"a": torch.ones(3), "b": torch.ones(3)}, state)
    assert torch.equal(p["b"], torch.ones(3)) and not torch.equal(
        p["a"], torch.ones(3))


# --------------------------------------------------------------- losses


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    pred = rng.normal(0, 1, (3, 40, 2)).astype(np.float32)
    target = rng.normal(0, 1, (3, 40, 2)).astype(np.float32)
    mask = (rng.random((3, 40)) > 0.3).astype(np.float32)
    logits = rng.normal(0, 2, (50, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 50).astype(np.int32)
    probs = rng.uniform(0.01, 0.99, 50).astype(np.float32)
    tgt01 = rng.integers(0, 2, 50).astype(np.float32)
    box5, box5t = (rng.normal(0, 1, (30, 5)).astype(np.float32)
                   for _ in range(2))
    reg, reg_t = (rng.normal(0, 1, (5, 10, 2)).astype(np.float32)
                  for _ in range(2))
    cases = [
        ("epe", lambda m, a: m.epe_loss(*a), (pred, target)),
        ("epe masked", lambda m, a: m.epe_loss(*a), (pred, target, mask)),
        ("epe_aae", lambda m, a: m.epe_aae(*a), (pred, target)),
        ("epe_aae wrapped", lambda m, a: m.epe_aae(*a, wrap_angles=True),
         (pred, target)),
        ("focal", lambda m, a: m.focal_loss(*a, gamma=2.0), (logits, labels)),
        ("focal alpha", lambda m, a: m.focal_loss(
            *a, gamma=1.0, alpha=[0.1, 0.2, 0.3, 0.4], reduction="sum"),
         (logits, labels)),
        ("ce", lambda m, a: m.focal_loss(*a, reduction="none"),
         (logits, labels)),
        ("binary focal", lambda m, a: m.binary_focal_loss(*a, gamma=2.0,
                                                          alpha=0.25),
         (probs, tgt01)),
        ("bce", lambda m, a: m.binary_focal_loss(*a, gamma=0.0),
         (probs, tgt01)),
        ("box 5", lambda m, a: m.box_regression_loss(*a), (box5, box5t)),
        ("box 3", lambda m, a: m.box_regression_loss(*a, alpha=0.3),
         (box5[:, :3], box5t[:, :3])),
        ("detection binary", lambda m, a: m.detection_loss(
            *a, pedestrian_only=True),
         (logits[:, :1].reshape(5, 10, 1), reg, (labels > 1).astype(
             np.int32).reshape(5, 10), reg_t)),
        ("detection multi", lambda m, a: m.detection_loss(
            *a, focal_gamma=1.0),
         (logits.reshape(5, 10, 4), reg, labels.reshape(5, 10), reg_t)),
    ]
    for what, fn, args in cases:
        ref = fn(jax_ops, tuple(jnp.asarray(a) for a in args))
        got = fn(losses, tuple(torch.tensor(a) for a in args))
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = got if isinstance(got, tuple) else (got,)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(t2n(g), np.asarray(r), rtol=1e-6,
                                       atol=1e-6, err_msg=what)


# ---------------------------------------------- the frozen forward, K1-K4


def _scans(seed=3, b=BATCH, s=S_SCANS):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 20.0, (b, s, NUM_PTS)).astype(np.float32)


@pytest.mark.parametrize("s_scans", [S_SCANS, 1])
def test_frozen_detector_forward_matches_jax(s_scans):
    """K1 -> K2 -> K3 -> K4 on their plain versions against JAX's Pallas
    kernels in interpret mode, at JAX's bf16 bar; a single scan takes the
    self-attention bootstrap."""
    jm, v_np, port = flow_drow_pair()
    scans = _scans(s=s_scans)
    det_vars = {"params": to_jax(v_np["params"]["dr_spaam"]),
                "batch_stats": to_jax(v_np["batch_stats"]["dr_spaam"])}
    kw = dict(num_pts=NUM_PTS, window_width=1.0, window_depth=0.5,
              area_mode=True)
    ref = jax_frozen_forward(det_vars, jnp.asarray(scans), alpha=0.5,
                             window_size=WINDOW, num_classes=1,
                             ct_len=CT_LEN, tile=16, interpret=True, **kw)
    kw.update(alpha=0.5, window_size=WINDOW)
    got = frozen_detector_forward(port.dr_spaam, torch.tensor(scans),
                                  ct_len=CT_LEN, **kw)
    for what, g, r in zip(("cls", "reg", "sim"), got, ref):
        bf16_bar(t2n(g), np.asarray(r, np.float32), what)
    assert not any(t.requires_grad for t in got)
    # the train step's call: no head, the same band
    none_cls, none_reg, sim = frozen_detector_forward(
        port.dr_spaam, torch.tensor(scans), ct_len=CT_LEN, with_head=False,
        **kw)
    assert none_cls is None and none_reg is None
    assert torch.equal(sim, got[2])
