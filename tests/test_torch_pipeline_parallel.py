"""The port's GPipe ``pipeline_apply`` against the JAX package's, on the CPU.

One spawn of two Gloo ranks (``tests/_torch_dist_worker.py``) on ``{pipe:
2}`` runs every multi-rank case; JAX runs the same function on the
conftest's devices (a ``{pipe: 2}`` mesh of 2) with the same seed-made
inputs and bridged weights:

* dense stages of different widths with 4 and 8 microbatches: the output
  within 1e-5 of JAX's, the gradients of a mean square within 1e-4;
* stages exchanging tuple and dict activations, equal to JAX's;
* stage states threaded through the microbatches in order, equal to JAX's
  chain within 1e-5 (the integer counters exactly);
* ``DetectionTask.loss_pipelined`` on DROW (4 microbatches, ghost-batch
  BatchNorm) against JAX's on ``{pipe: 2}``: loss 1e-5, predictions 1e-4,
  running statistics 1e-5; its gradients within 1e-5 of each tensor's
  largest of the port's sequential ghost-batch loop, and (slow) within
  1e-2 relative L2 of JAX's op-by-op gradients;
* the flow U-Net staged encoder | decoder (a pytree of skips across the
  boundary) against the port's unstaged forward;
* the trainer on ``{pipe: 2}``: its first loss is ``loss_pipelined``'s.

JAX's configuration errors are checked in one process.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.parallel import (
    make_mesh_from_config as jax_mesh,
    pipeline_apply as jax_pipeline_apply,
)
from planar_optical_flow_tpu.train import tasks as jax_tasks
from planar_optical_flow_tpu_torch import parallel
from planar_optical_flow_tpu_torch.interop import variables_to_state_dict
from tests._torch_dist_worker import Ranks
from tests.test_torch_common import one_thread  # noqa: F401
from tests.test_torch_common import CT_LEN, CUTOUT_KW, NUM_PTS, to_jax
from tests.test_torch_flow_model import scan_pairs
from tests.test_torch_parallel import FLOW_PTS, model_pair

PIPE = {"pipe": 2}
WIDTHS = (6, 16, 4)
DET_TASK = dict(cutout_kwargs=CUTOUT_KW, pedestrian_only=True,
                num_pts=NUM_PTS)


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


def _mlp_params(rng):
    return [{"w": rng.normal(0, 0.5, (a, b)).astype(np.float32),
             "b": rng.normal(0, 0.1, (b,)).astype(np.float32)}
            for a, b in zip(WIDTHS[:-1], WIDTHS[1:])]


def _jax_mlp_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _det_batch(rng, batch=8):
    from planar_optical_flow_tpu_torch.data.synthetic import (
        make_synthetic_drow_sequence,
    )

    seqs = [make_synthetic_drow_sequence(num_frames=5, num_pts=NUM_PTS,
                                         seed=30 + j) for j in range(batch)]
    return {"scans": np.stack([s["scans"][2:] for s in seqs])
            .astype(np.float32),
            "target_cls": rng.integers(0, 2, (batch, NUM_PTS))
            .astype(np.int32),
            "target_reg": rng.normal(0, 0.3, (batch, NUM_PTS, 2))
            .astype(np.float32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's inputs, the two ranks' results and the Drow pair."""
    rng = np.random.default_rng(0)
    params = _mlp_params(rng)
    x = rng.normal(0, 1, (8, 6)).astype(np.float32)
    t = rng.normal(0, 1, (8, 4)).astype(np.float32)
    w = rng.normal(0, 0.5, (5, 3)).astype(np.float32)
    xp = rng.normal(0, 1, (4, 5)).astype(np.float32)
    xs = rng.normal(0, 1, (8, 3)).astype(np.float32)
    jm, v_np, port = model_pair("drow")
    det_spec = ("Drow", dict(pedestrian_only=True), port.state_dict())
    batch = _det_batch(rng)
    fj, fv, fport = model_pair("flow_unet")
    a, b = scan_pairs(num_pts=FLOW_PTS, batch=4, seed=3)
    inputs = dict(params=params, x=x, t=t, w=w, xp=xp, xs=xs, v_np=v_np,
                  jm=jm, port=port, batch=batch, pair=(a, b), fport=fport)
    task = ("DetectionTask", DET_TASK)
    jobs = [{"key": f"mlp{m}", "kind": "mlp",
             "args": dict(params=params, x=x, t=t, n_micro=m, mesh=PIPE)}
            for m in (4, 8)]
    jobs += [
        {"key": "pytree", "kind": "pytree",
         "args": dict(w=w, x=xp, mesh=PIPE)},
        {"key": "state", "kind": "state_chain",
         "args": dict(x=xs, mesh=PIPE, n_micro=4)},
        {"key": "loss_pp", "kind": "loss_pipelined",
         "args": dict(model=det_spec, task=task, batch=batch, mesh=PIPE,
                      n_micro=4)},
        {"key": "flow", "kind": "flow_stages",
         "args": dict(model=("registry", {"type": "flow_unet"},
                             fport.state_dict()), pair=(a, b), mesh=PIPE,
                      n_micro=2)},
        {"key": "train", "kind": "train",
         "args": dict(model=det_spec, task=task, batches=[batch] * 2,
                      mesh=PIPE, trainer_cfg={"pp_microbatches": 4},
                      opt_cfg={"scheduler_kwargs": {}})},
    ]
    spawned = Ranks(jobs, 2, tmp_path_factory.mktemp("pipe"))
    return dict(ranks=spawned, **inputs)


@pytest.fixture(scope="module")
def results(ranks):
    return ranks["ranks"].results()


@pytest.mark.parametrize("n_micro", [4, 8])
def test_pipeline_matches_jax(ranks, results, n_micro):
    """Output and gradients of ``mean((y - t)^2)`` against JAX's
    ``pipeline_apply`` on ``{pipe: 2}``."""
    params = [to_jax(p) for p in ranks["params"]]
    x, t = jnp.asarray(ranks["x"]), jnp.asarray(ranks["t"])
    mesh = jax_mesh(PIPE)

    def loss(ps):
        y = jax_pipeline_apply([_jax_mlp_stage] * 2, ps, x, mesh,
                               n_microbatches=n_micro)
        return jnp.mean((y - t) ** 2), y

    (ref_l, ref_y), ref_g = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    for res in results:
        got = res[f"mlp{n_micro}"]
        np.testing.assert_allclose(got["y"], np.asarray(ref_y), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["loss"], float(ref_l), rtol=1e-5)
        for g, r in zip(got["grads"], ref_g):
            for k in ("w", "b"):
                np.testing.assert_allclose(g[k], np.asarray(r[k]),
                                           rtol=1e-4, atol=1e-6)


def test_pipeline_pytree_activations(ranks, results):
    def s0(p, x):
        return (x @ p, x[:, :2])

    def s1(p, xs):
        a, b = xs
        return {"y": a * p, "z": b}

    ref = jax_pipeline_apply([s0, s1], [jnp.asarray(ranks["w"]),
                                        jnp.asarray(2.0)],
                             jnp.asarray(ranks["xp"]), jax_mesh(PIPE))
    for res in results:
        for k in ("y", "z"):
            np.testing.assert_allclose(res["pytree"][k], np.asarray(ref[k]),
                                       rtol=1e-6, atol=1e-7)


def test_pipeline_stage_state_threads_in_microbatch_order(ranks, results):
    def s0(p, s, x):
        cnt, acc = s
        return x * p, (cnt + 1, 0.5 * acc + jnp.sum(x))

    def s1(p, s, x):
        cnt, acc = s
        return x + p, (cnt + 1, 0.5 * acc + jnp.sum(x))

    zero = (jnp.asarray(0), jnp.asarray(0.0))
    ref_y, ref_s = jax_pipeline_apply(
        [s0, s1], [jnp.asarray(2.0), jnp.asarray(1.0)],
        jnp.asarray(ranks["xs"]), jax_mesh(PIPE), n_microbatches=4,
        stage_state=[zero, zero])
    for res in results:
        got = res["state"]
        np.testing.assert_allclose(got["y"], np.asarray(ref_y), rtol=1e-6)
        for (cnt, acc, dtype), (rc, ra) in zip(got["states"], ref_s):
            assert cnt == int(rc) == 4 and "int" in dtype
            np.testing.assert_allclose(acc, float(ra), rtol=1e-5)


def _jax_loss_pipelined(ranks, jit: bool):
    """JAX's ``loss_pipelined`` on ``{pipe: 2}`` (4 microbatches) and its
    gradient, the statistics and gradients as port state dicts."""
    jm, v_np, port = ranks["jm"], ranks["v_np"], ranks["port"]
    variables = to_jax(v_np)
    jtask = jax_tasks.DetectionTask(**DET_TASK)
    batch = {k: jnp.asarray(v) for k, v in ranks["batch"].items()}

    def loss(params):
        lo, tb, out, stats = jtask.loss_pipelined(
            jm.apply, {"params": params,
                       "batch_stats": variables["batch_stats"]},
            batch, True, None, mesh=jax_mesh(PIPE), n_microbatches=4)
        return lo, (tb, out, stats)

    fn = jax.value_and_grad(loss, has_aux=True)
    (ref_l, (ref_tb, ref_out, ref_stats)), ref_g = (
        jax.jit(fn) if jit else fn)(variables["params"])
    stats = variables_to_state_dict(
        {"params": v_np["params"], "batch_stats": jax.device_get(ref_stats)},
        port)
    grads = variables_to_state_dict(
        {"params": jax.device_get(ref_g), "batch_stats": v_np["batch_stats"]},
        port)
    return ref_l, ref_tb, ref_out, stats, grads


def _port_sequential(ranks):
    """The port's ghost-batch loop: the model on each microbatch in turn
    (its statistics advancing), the loss on the whole batch's predictions:
    (loss, statistics, gradients)."""
    from planar_optical_flow_tpu_torch.models import Drow
    from planar_optical_flow_tpu_torch.train import tasks
    from planar_optical_flow_tpu_torch.train.state import named_stats
    from planar_optical_flow_tpu_torch.train.trainer import to_device

    port = Drow(pedestrian_only=True, generator=torch.Generator())
    port.load_state_dict(ranks["port"].state_dict())
    task = tasks.DetectionTask(**DET_TASK)
    batch = to_device(ranks["batch"], "cpu")
    enc = task._encode(batch["scans"])
    outs = [port(enc[i:i + 2], train=True) for i in range(0, 8, 2)]
    cls = torch.cat([o[0] for o in outs])
    reg = torch.cat([o[1] for o in outs])
    c, r, _ = task._losses(cls, reg, batch)
    (c + r).backward()
    return (float((c + r).detach()),
            {n: t.numpy() for n, t in named_stats(port).items()},
            {n: p.grad.numpy() for n, p in port.named_parameters()})


def test_loss_pipelined_matches_jax(ranks, results):
    """Ghost-batch BatchNorm through the wavefront: the loss, its parts, the
    predictions and the running statistics against JAX's
    ``loss_pipelined`` on ``{pipe: 2}`` with 4 microbatches; the gradients
    against the port's sequential ghost-batch loop (JAX's own jitted and
    op-by-op gradients of this loss differ by up to 3e-2 of a tensor's
    largest; the op-by-op comparison is the slow test below)."""
    ref_l, ref_tb, ref_out, ref_stats, _ = _jax_loss_pipelined(ranks, True)
    seq_l, seq_stats, seq_g = _port_sequential(ranks)
    for res in results:
        got = res["loss_pp"]
        np.testing.assert_allclose(got["loss"], float(ref_l), rtol=1e-5)
        np.testing.assert_allclose(got["loss"], seq_l, rtol=1e-6)
        for k, v in ref_tb.items():
            np.testing.assert_allclose(got["tb"][k], float(v), rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(got["pred_cls"],
                                   np.asarray(ref_out["pred_cls"]),
                                   rtol=1e-4, atol=1e-5)
        for n, v in got["stats"].items():
            np.testing.assert_allclose(v, ref_stats[n].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=n)
            np.testing.assert_allclose(v, seq_stats[n], rtol=1e-6,
                                       atol=1e-7, err_msg=n)
        for n, g in got["grads"].items():
            ref = seq_g[n]
            assert np.abs(g - ref).max() <= 1e-5 * max(
                np.abs(ref).max(), 1e-6), n
    # the trainer on {pipe: 2}: its first step is this loss
    for res in results:
        np.testing.assert_allclose(res["train"]["losses"][0],
                                   res["loss_pp"]["loss"], rtol=1e-6)


@pytest.mark.slow
def test_loss_pipelined_gradients_match_jax(ranks, results):
    """The gradients against JAX's op-by-op gradient of its
    ``loss_pipelined``: over all of them within 1e-2 relative L2, each
    within 3e-2 of its tensor's largest (the level at which JAX's own
    jitted and op-by-op gradients of this loss differ: microbatches of 2
    scans make the fast variance's cancellation move them in f32), and the
    biases that feed a BatchNorm (exactly 0) below 1e-4 of the largest
    gradient."""
    from tests.test_torch_train_steps import ZERO_GRAD

    *_, ref_g = _jax_loss_pipelined(ranks, False)
    top = max(float(np.abs(t.numpy()).max()) for t in ref_g.values())
    for res in results:
        got, ref = [], []
        for n, g in res["loss_pp"]["grads"].items():
            r = ref_g[n].numpy()
            if n.endswith(ZERO_GRAD):
                assert max(np.abs(g).max(), np.abs(r).max()) <= 1e-4 * top
                continue
            assert np.abs(g - r).max() <= 3e-2 * np.abs(r).max(), n
            got.append(g.ravel())
            ref.append(r.ravel())
        got, ref = np.concatenate(got), np.concatenate(ref)
        assert np.linalg.norm(got - ref) <= 1e-2 * np.linalg.norm(ref)


def test_flow_unet_stages_match_the_unstaged_forward(ranks, results):
    """The staged U-Net in train mode (each microbatch on its own
    statistics) against the port's forward microbatch by microbatch."""
    from planar_optical_flow_tpu_torch.models.blocks import (
        frozen_running_stats,
    )

    fport = ranks["fport"]
    a, b = (torch.from_numpy(v) for v in ranks["pair"])
    with frozen_running_stats():
        want = torch.cat([fport(a[i:i + 2], b[i:i + 2], train=True)
                          for i in (0, 2)])
    ((want ** 2).mean()).backward()
    for res in results:
        np.testing.assert_allclose(res["flow"]["y"], want.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        for n, p in fport.named_parameters():
            ref = p.grad.numpy()
            assert np.abs(res["flow"]["grads"][n] - ref).max() <= 1e-4 * max(
                np.abs(ref).max(), 1e-6), n


def test_pipeline_validates_configuration():
    """JAX's configuration errors, raised before any message is sent."""
    from tests._torch_dist_worker import _mlp_stage

    mesh = parallel.make_mesh(("pipe",), devices=[torch.device("cpu")] * 2)
    ps = [{k: torch.tensor(v) for k, v in p.items()}
          for p in _mlp_params(np.random.default_rng(0))]
    x = torch.zeros(8, 6)
    fns = [_mlp_stage] * 2
    with pytest.raises(ValueError, match="stages but mesh"):
        parallel.pipeline_apply(fns[:1], ps[:1], x, mesh)
    with pytest.raises(ValueError, match="param trees"):
        parallel.pipeline_apply(fns, ps[:1], x, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.pipeline_apply(fns, ps, x, mesh, n_microbatches=3)
    with pytest.raises(ValueError, match="state trees"):
        parallel.pipeline_apply(fns, ps, x, mesh, stage_state=[{}])
    with pytest.raises(ValueError, match="single dtype"):
        parallel.pipeline_apply(fns, ps, (x, x.long()), mesh)
    dp = parallel.make_mesh(("data", "pipe"), (2, 2),
                            devices=[torch.device("cpu")] * 4)
    with pytest.raises(ValueError, match="not divisible by the data"):
        parallel.pipeline_apply(fns, ps, torch.zeros(6, 6), dp,
                                n_microbatches=6)
    with pytest.raises(ValueError, match="one process a device"):
        parallel.pipeline_apply(fns, ps, x, mesh)


def test_pipeline_of_one_stage_runs_in_process():
    """A mesh of one position runs the chain here, gradients included."""
    from tests._torch_dist_worker import _mlp_stage

    mesh = parallel.make_mesh(("pipe",), devices=[torch.device("cpu")])
    p = {k: torch.tensor(v, requires_grad=True) for k, v in
         _mlp_params(np.random.default_rng(1))[0].items()}
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    y = parallel.pipeline_apply([_mlp_stage], [p], x, mesh,
                                n_microbatches=2)
    y.sum().backward()
    g = {k: v.grad.clone() for k, v in p.items()}
    for v in p.values():
        v.grad = None
    _mlp_stage(p, x).sum().backward()
    torch.testing.assert_close(y, _mlp_stage(p, x), rtol=1e-6, atol=1e-6)
    for k, v in p.items():
        torch.testing.assert_close(g[k], v.grad, rtol=1e-5, atol=1e-6)


def test_loss_pipelined_guards():
    """Only the plain DROW detector stages; out of training it is the
    plain loss; a dropout model needs a generator."""
    from planar_optical_flow_tpu_torch.models import Drow, SpatialDrow
    from planar_optical_flow_tpu_torch.train import tasks

    task = tasks.DetectionTask(**DET_TASK)
    mesh = parallel.make_mesh(("pipe",), devices=[torch.device("cpu")] * 2)
    g = torch.Generator().manual_seed(0)
    sd = SpatialDrow(window_size=5, pedestrian_only=True,
                     num_cutout_pts=CT_LEN, generator=g)
    batch = {k: torch.from_numpy(v) for k, v in
             _det_batch(np.random.default_rng(0), 2).items()}
    with pytest.raises(ValueError, match="plain DROW"):
        task.loss_pipelined(sd, batch, True, mesh=mesh)
    drow = Drow(pedestrian_only=True, generator=g)
    want = task.loss(drow, batch, False)[0]
    got = task.loss_pipelined(drow, batch, False, mesh=mesh)[0]
    assert torch.equal(got, want)
    assert task.pp_num_stages == 2
    with pytest.raises(ValueError, match="dropout_rng"):
        parallel.drow_pipeline_train_stages(
            Drow(dropout=0.5, pedestrian_only=True, generator=g))
    with pytest.raises(ValueError, match="dropout_rng"):
        parallel.drow_pipeline_stages(
            Drow(dropout=0.5, pedestrian_only=True, generator=g), train=True)


def test_drow_stages_chain_to_the_model(ranks):
    """``drow_pipeline_stages`` chained by hand is the model's forward."""
    port = ranks["port"]
    fns, params = parallel.drow_pipeline_stages(port)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (2, NUM_PTS, 3, CT_LEN)).astype(np.float32))
    with torch.no_grad():
        got = fns[1](params[1], fns[0](params[0], x))
        want = port(x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

