"""First-step gradients of the port's tasks against the JAX package's, and
``remat``, on the CPU.

The set-up of ``tests/test_torch_train_steps.py`` (64 beams, 16 cutout
points, window 5, S=3, B=2, flax ``init`` weights with perturbed BatchNorm
statistics carried across by the bridge, synthetic scans). The gradients
agree to 1e-3 of each tensor's largest in f32 (JAX's bf16 bar for the
fused task, whose frozen forward is bf16), against JAX's gradient taken op
by op.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu_torch.interop import variables_to_state_dict
from planar_optical_flow_tpu_torch.train.state import named_stats
from planar_optical_flow_tpu_torch.train.trainer import to_device

from tests.test_torch_common import one_thread  # noqa: F401
from tests.test_torch_common import t2n, to_jax
from tests.test_torch_train import bf16_bar
from tests.test_torch_train_steps import (
    KINDS,
    ZERO_GRAD,
    _batches,
    _pair,
    _port_model,
    _tasks,
)


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


@pytest.mark.parametrize("kind", KINDS)
def test_first_step_gradients_match_jax(kind):
    """One f32 forward and backward from the same weights and batch: each
    parameter's gradient within 1e-3 of its tensor's largest (JAX's bf16
    bar for the fused task); the biases whose exact gradient is 0 below
    1e-4 of the largest gradient in both packages; and both FlowDROW tasks
    give the detector no gradient (JAX's is exactly 0)."""
    jm, v_np, port = _pair(kind)
    jtask, task = _tasks(kind, jm, port)
    batch = _batches(1)[0]

    def jax_loss(params):
        loss, _, _, stats = jtask.loss(
            jm.apply, {"params": params,
                       "batch_stats": to_jax(v_np["batch_stats"])},
            {k: jnp.asarray(v) for k, v in batch.items()}, True)
        return loss, stats

    # op by op: XLA's fusions of the jitted gradient move block 1's
    # gradients by up to 3e-3 of their largest against JAX's own eager ones
    (ref_loss, ref_stats), ref_g = jax.value_and_grad(
        jax_loss, has_aux=True)(to_jax(v_np["params"]))
    loss, _, _, new_stats = task.loss(port, to_device(batch, "cpu"), True)
    loss.backward()
    ref = variables_to_state_dict({"params": jax.device_get(ref_g),
                                   "batch_stats": v_np["batch_stats"]}, port)
    top = max(float(np.abs(t2n(ref[n])).max())
              for n, _ in port.named_parameters())
    for n, p in port.named_parameters():
        r = t2n(ref[n])
        g = np.zeros_like(r) if p.grad is None else t2n(p.grad)
        if n.startswith("dr_spaam.") and kind.startswith("flow_drow"):
            assert p.grad is None or not p.grad.any(), n
            assert not r.any(), n
        elif n.endswith(ZERO_GRAD):
            assert max(np.abs(g).max(), np.abs(r).max()) <= 1e-4 * top, n
        elif kind == "flow_drow_fused":
            bf16_bar(g, r, n)
        else:
            err = np.abs(g - r).max()
            assert err <= 1e-3 * np.abs(r).max(), f"{n}: {err}"
    # the step returns the whole statistics collection, as flax's mutable
    # collection is
    assert set(new_stats) == set(named_stats(port))
    assert set(jax.device_get(ref_stats)) == set(v_np["batch_stats"])


@pytest.mark.parametrize("kind", ["drow", "dr-spaam", "flow_drow"])
def test_remat_matches_plain_backward(kind):
    """``remat=True``: the same loss, gradients and running statistics as
    ``remat=False``; the recompute leaves the statistics alone."""
    _, v_np, _ = _pair(kind)
    batch = to_device(_batches(1)[0], "cpu")
    out = []
    for remat in (False, True):
        port = _port_model(kind)
        port.load_state_dict(variables_to_state_dict(v_np, port))
        if kind == "flow_drow":
            port.freeze_detector = False  # the detector trains, remat on
            port.dr_spaam.remat = remat
        else:
            port.remat = remat
        task = _tasks(kind, None, port)[1]
        loss, _, _, stats = task.loss(port, batch, True)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in
                                    port.named_parameters()},
                    {n: t.clone() for n, t in stats.items()}))
    (l0, g0, s0), (l1, g1, s1) = out
    assert torch.equal(l0, l1)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-6, atol=1e-9)
    for n in s0:
        assert torch.equal(s1[n], s0[n]), n
