"""The port's ``parallel`` package against the JAX package's, on the CPU.

* Mesh rules in one process: shapes (``mesh_shape``) and layouts equal to
  JAX's ``make_mesh_from_config`` on the conftest's 8 devices, its errors,
  the hybrid partial layout, and the partition rule splitting the leaves
  JAX's splits (the counterparts of ``tests/test_hybrid_mesh.py``).
* ``Pipeline``'s ``pipeline.mesh`` rules (``tests/test_mesh_config.py``),
  on 8 positions of one process.
* Two Gloo ranks (``tests/_torch_dist_worker.py``, one spawn): three
  trainer steps of ``DetectionTask`` (DR-SPAAM) and ``FlowUNetTask`` on
  ``{data: 2}`` against JAX's trainer on its 2-device ``data`` mesh and
  against the port's single-device steps; ``{data: 1, model: 2}`` on
  SpatialDROW against JAX's with ``state_shardings``; the context-parallel
  gate against JAX's and the dense gate.
* ``make_serve_step_v3(mesh=)`` over two CPU shards of one process: bf16
  against the unsharded port step, int8c against it and JAX's sharded
  step.

Bars. Training: per-step losses within 1e-5 relative, parameters and
running statistics within 1e-3 relative L2. The steps run at lr 1e-5: at
lr 1e-3 JAX against itself (one device against its ``{data: 2}`` mesh)
already moves the second and third losses by ~1e-4, since AMSGrad's first
steps turn the f32 rounding of near-zero gradients into +-lr updates; at
1e-5 it agrees to ~3e-7. Context gate: rtol = atol = 1e-5 (JAX's bar).
Serving: bf16 within 2e-2 of the unsharded step with ``det_keep``
matching on more than 95% (``tests/test_parallel.py``); int8c carries to
the bit of the unsharded step and within 1 LSB of JAX's sharded step
(``tests/test_torch_int8.py``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.infer.streaming import (
    make_serve_step_v3 as jax_v3,
)
from planar_optical_flow_tpu.parallel import (
    default_partition_rule as jax_rule,
    make_hybrid_mesh as jax_hybrid,
    make_mesh_from_config as jax_mesh,
    state_shardings as jax_state_shardings,
)
from planar_optical_flow_tpu.train import Trainer as JaxTrainer
from planar_optical_flow_tpu.train import create_train_state as jax_state
from planar_optical_flow_tpu.train import make_optimizer as jax_optimizer
from planar_optical_flow_tpu.train import tasks as jax_tasks
from planar_optical_flow_tpu.utils.logger import RunLogger as JaxLogger
from planar_optical_flow_tpu_torch import parallel
from planar_optical_flow_tpu_torch.infer.calibration import ServeCalibration
from planar_optical_flow_tpu_torch.infer.streaming import (
    ShardedCarry,
    make_serve_step_v3,
)
from planar_optical_flow_tpu_torch.interop import variables_to_state_dict
from planar_optical_flow_tpu_torch.interop.flax_bridge import flax_path
from tests._torch_dist_worker import Ranks
from tests.test_torch_common import one_thread  # noqa: F401
from tests.test_torch_common import (
    CT_LEN,
    CUTOUT_KW,
    NUM_PTS,
    WINDOW,
    perturb_batch_stats,
    t2n,
    to_jax,
)
from tests.test_torch_flow_model import scan_pairs
from tests.test_torch_int8 import TILE, assert_int8_close, pm_to_port
from tests.test_torch_train_steps import (
    _example,
    _jax_model,
    _port_model,
    _rel_l2,
)

BATCH, STEPS = 4, 3
OPT_CFG = {"scheduler_kwargs": dict(epoch0=0, lr0=1e-5, epoch1=2, lr1=1e-6),
           "grad_norm_clip": 1.0}
DET_TASK = dict(cutout_kwargs=CUTOUT_KW, pedestrian_only=True,
                num_pts=NUM_PTS)
FLOW_PTS = 128
STATS = ("running_mean", "running_var")


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


# ------------------------------------------------------------ mesh rules

CONFIGS = [None, {"data": 4, "model": 2}, {"data": -1, "model": 2},
           {"dcn": 2, "data": 4}, {"data": 2, "dcn": 2, "model": 2},
           {"dcn": 2, "data": -1}, {"dcn": 8}, {"pipe": 2},
           {"data": 2, "pipe": "auto"}, {"data": 2, "dcn": 2}]


@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
def test_mesh_shape_and_layout_match_jax(cfg):
    """The same axes, sizes and position of every device as JAX's mesh on
    8 devices (the port's positions are the device ids)."""
    ref = jax_mesh(cfg)
    assert parallel.mesh_shape(cfg, 8) == dict(ref.shape)
    got = parallel.make_mesh_from_config(cfg, devices=list(range(8)))
    assert got.axis_names == tuple(ref.axis_names)
    assert got.shape == dict(ref.shape)
    np.testing.assert_array_equal(
        got.devices.astype(int),
        np.vectorize(lambda d: d.id)(ref.devices))
    assert not got.multi_process


def test_mesh_shape_errors_match_jax():
    for cfg, match in (({"data": 16}, "needs"), ({"data": 3, "model": 3},
                                                 "needs"),
                       ({"data": -1, "model": "auto"}, "only one")):
        with pytest.raises(ValueError, match=match):
            jax_mesh(cfg)
        with pytest.raises(ValueError, match=match):
            parallel.mesh_shape(cfg, 8)
    with pytest.raises(ValueError, match="needs"):
        jax_hybrid(4, {"data": 4})
    with pytest.raises(ValueError, match="needs"):
        parallel.make_hybrid_mesh(4, {"data": 4}, devices=list(range(8)))


def test_hybrid_partial_mesh_takes_devices_per_group():
    """A hybrid mesh smaller than the positions takes each dcn group's from
    its own block, as JAX's."""
    got = parallel.make_mesh_from_config({"dcn": 2, "data": 2},
                                         devices=list(range(8)))
    assert list(got.devices.ravel()) == [0, 1, 4, 5]
    assert got.data_axes == ("dcn", "data") and got.data_extent == 4


def test_in_process_mesh_shards_and_replicates_a_batch():
    mesh = parallel.make_mesh(devices=[torch.device("cpu")] * 2)
    batch = {"x": np.arange(12, dtype=np.float32).reshape(4, 3)}
    shards = parallel.shard_batch(batch, mesh)
    assert [s["x"][:, 0].tolist() for s in shards] == [[0, 3], [6, 9]]
    reps = parallel.replicate_batch(batch, mesh)
    assert all(torch.equal(r["x"], torch.from_numpy(batch["x"]))
               for r in reps)
    sh = parallel.batch_sharding(mesh)
    assert (sh.axes, sh.count) == (("data",), 2)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.shard_batch({"x": np.zeros((3, 1))}, mesh)


def _jax_split(model, variables, mesh):
    """flax path -> PartitionSpec of the leaves JAX's rule splits."""
    rule = jax_rule(mesh)
    out = {}

    def visit(path, leaf):
        spec = tuple(rule(path, leaf).spec)
        if any(a is not None for a in spec):
            out[tuple(str(getattr(p, "key", "")) for p in path)] = spec

    jax.tree_util.tree_map_with_path(visit, variables)
    return out


def jit_pair(jm, port, example, seed=0):
    """(flax model, numpy variables with perturbed BatchNorm statistics, the
    port's model with those weights), the variables from a jitted ``init``
    (the eager one takes ~10 s on the CPU)."""
    variables = jax.device_get(jax.jit(
        lambda k, *x: jm.init(k, *x, train=False))(
            jax.random.PRNGKey(seed), *example))
    v_np = perturb_batch_stats(variables, np.random.default_rng(seed + 100))
    port.load_state_dict(variables_to_state_dict(v_np, port))
    return jm, v_np, port


def model_pair(kind, seed=0):
    """:func:`jit_pair` of ``"drow"``, ``"dr-spaam"``, ``"flow_drow"`` (the
    serving geometry) or ``"flow_unet"`` (at ``FLOW_PTS`` beams)."""
    from planar_optical_flow_tpu.models import FlowDrow as JaxFlowDrow
    from planar_optical_flow_tpu.models import get_model as jax_get_model
    from planar_optical_flow_tpu_torch.models import FlowDrow, get_model

    if kind == "flow_unet":
        x = jnp.zeros((1, FLOW_PTS, 2))
        return jit_pair(jax_get_model({"type": "flow_unet"}),
                        get_model({"type": "flow_unet"}), (x, x), seed)
    if kind == "flow_drow":
        return jit_pair(
            JaxFlowDrow(window_size=WINDOW, pedestrian_only=True),
            FlowDrow(window_size=WINDOW, pedestrian_only=True,
                     num_cutout_pts=CT_LEN),
            (jnp.zeros((1, NUM_PTS, 1, CT_LEN)), jnp.zeros((1, NUM_PTS))),
            seed)
    return jit_pair(_jax_model(kind), _port_model(kind), _example(kind),
                    seed)


@pytest.fixture(scope="module")
def det_pair():
    """(flax SpatialDrow, numpy variables, the port's model)."""
    return model_pair("dr-spaam")


@pytest.fixture(scope="module")
def serve_pair():
    model, v_np, port = model_pair("flow_drow", seed=3)
    return model, to_jax(v_np), port.eval()


@pytest.mark.parametrize("kind", ["dr-spaam", "flow_drow", "drow"])
def test_partition_rule_splits_the_leaves_jax_splits(kind, det_pair,
                                                     serve_pair):
    """The port's rule, on the port's names mapped through the flax
    bridge's naming, splits the leaves JAX's rule splits, each on the
    dimension that is flax's transposed."""
    if kind == "flow_drow":
        jm, v_np, port = serve_pair
    elif kind == "dr-spaam":
        jm, v_np, port = det_pair
    else:
        jm, v_np, port = model_pair(kind)
    mesh = jax_mesh({"data": 4, "model": 2})
    want = {}
    for path, spec in _jax_split(jm, v_np, mesh).items():
        coll, names = path[0], path[1:]
        leaf = {"kernel": "kernel", "scale": "kernel", "bias": "bias",
                "mean": "mean", "var": "var"}[names[-1]]
        want[(coll == "batch_stats",) + names[:-1] + (leaf,)] = spec
    pmesh = parallel.make_mesh_from_config({"data": 4, "model": 2},
                                           devices=list(range(8)))
    state = type("S", (), {"model": port})()
    specs = parallel.state_shardings(pmesh, state)
    got = {}
    for n, spec in specs.items():
        if spec:
            got[(n.endswith(STATS),) + flax_path(n)] = tuple(
                reversed(spec)) if len(spec) > 1 else spec
    assert got == want
    assert got, "the rule splits nothing"
    flat = parallel.state_shardings(
        parallel.make_mesh_from_config({"data": 8}, devices=list(range(8))),
        state)
    assert not any(flat.values())


# ---------------------------------------------------- pipeline.mesh rules


@pytest.fixture(scope="module")
def drow_dir(tmp_path_factory):
    from planar_optical_flow_tpu_torch.data import write_synthetic_drow_split

    d = str(tmp_path_factory.mktemp("meshcfg_drow"))
    write_synthetic_drow_split(d, "train", num_sequences=1, num_frames=16,
                               num_pts=64)
    return d


@pytest.fixture
def eight(monkeypatch):
    """Eight positions in this process (the conftest's 8 devices)."""
    monkeypatch.setattr(parallel.mesh, "default_devices",
                        lambda: list(range(8)))


@pytest.fixture
def warnings_log(monkeypatch):
    from planar_optical_flow_tpu_torch.utils.logger import RunLogger

    msgs = []
    orig = RunLogger.warning
    monkeypatch.setattr(RunLogger, "warning",
                        lambda self, m: (msgs.append(str(m)),
                                         orig(self, m)) and None)
    return msgs


def _pipeline(drow_dir, tmp_path, mesh, batch_size=8, model_type="drow"):
    from planar_optical_flow_tpu_torch.pipeline import (
        Pipeline,
        normalize_config,
    )

    cfg = {"batch_size": batch_size, "epochs": 1, "num_scans": 2,
           "pedestrian_only": True, "data_dir": drow_dir,
           "log_dir": str(tmp_path / "logs"), "model_type": model_type,
           "mesh": mesh,
           "cutout_kwargs": dict(fixed=True, centered=True, window_width=1.0,
                                 window_depth=0.5, num_cutout_pts=8,
                                 padding_val=29.99, area_mode=False),
           "scheduler_kwargs": {"epoch0": 0, "lr0": 1e-3, "epoch1": 2,
                                "lr1": 1e-3}}
    cfg = normalize_config(cfg)
    cfg["pipeline"]["Logger"].update(console=False, tensorboard=False)
    return Pipeline(cfg, install_signal_handlers=False, device="cpu")


def test_pipeline_mesh_config_errors(drow_dir, tmp_path, eight):
    with pytest.raises(ValueError, match="unknown mesh axis.*dataa"):
        _pipeline(drow_dir, tmp_path, {"dataa": 8})
    with pytest.raises(TypeError, match="pipeline.mesh must be a mapping"):
        _pipeline(drow_dir, tmp_path, [8])
    with pytest.raises(ValueError, match="strict"):
        _pipeline(drow_dir, tmp_path, {"data": 3, "strict": True})
    with pytest.raises(ValueError, match="dcn axis cannot combine"):
        _pipeline(drow_dir, tmp_path, {"dcn": 2, "pipe": 2})


def test_pipeline_mesh_fallbacks_warn(drow_dir, tmp_path, eight,
                                      warnings_log):
    # batch 8 over data=3: no mesh, loudly
    pipe = _pipeline(drow_dir, tmp_path, {"data": 3})
    assert pipe.trainer._mesh is None
    assert any("falling back" in m and "not divisible" in m
               for m in warnings_log)
    # 16 positions asked of 8
    pipe = _pipeline(drow_dir, tmp_path, {"data": 16})
    assert pipe.trainer._mesh is None
    assert any("mesh construction failed" in m for m in warnings_log)
    # pipe: batch 8 into data=3 x 2 microbatches
    n = len(warnings_log)
    pipe = _pipeline(drow_dir, tmp_path, {"data": 3, "pipe": 2})
    assert pipe.trainer._mesh is None
    assert any("microbatches" in m for m in warnings_log[n:])


def test_pipeline_mesh_kept(drow_dir, tmp_path, eight, warnings_log):
    pipe = _pipeline(drow_dir, tmp_path, {"data": 8})
    assert pipe.trainer._mesh.shape == {"data": 8}
    # a model-only mesh keeps the batch whole: no batch rule, split state
    pipe = _pipeline(drow_dir, tmp_path, {"model": 8}, model_type="dr-spaam")
    assert pipe.trainer._mesh.shape == {"model": 8}
    assert pipe.trainer._state_sharding_fn is parallel.state_shardings
    assert not warnings_log
    # DROW stages into 2: a pipe of 4 fails as a configuration error
    pipe = _pipeline(drow_dir, tmp_path, {"pipe": 4})
    with pytest.raises(ValueError, match="2 pipeline stages"):
        pipe.train()
    # without a config and without torch.distributed: no mesh
    assert _pipeline(drow_dir, tmp_path, None).trainer._mesh is None


# ------------------------------------------------- two ranks: DP, TP, CP


def _det_batches():
    from planar_optical_flow_tpu_torch.data.synthetic import (
        make_synthetic_drow_sequence,
    )

    rng = np.random.default_rng(7)
    out = []
    for i in range(STEPS):
        seqs = [make_synthetic_drow_sequence(num_frames=5, num_pts=NUM_PTS,
                                             seed=10 * i + j)
                for j in range(BATCH)]
        out.append({
            "scans": np.stack([s["scans"][2:] for s in seqs])
            .astype(np.float32),
            "target_cls": rng.integers(0, 2, (BATCH, NUM_PTS))
            .astype(np.int32),
            "target_reg": rng.normal(0, 0.3, (BATCH, NUM_PTS, 2))
            .astype(np.float32)})
    return out


def _flow_batches():
    out = []
    rng = np.random.default_rng(5)
    for i in range(STEPS):
        a, b = scan_pairs(num_pts=FLOW_PTS, batch=BATCH, seed=20 + i)
        out.append({"scan_pair": np.stack([a, b], 1),
                    "flow_target": rng.normal(0, 0.1, (BATCH, FLOW_PTS, 2))
                    .astype(np.float32)})
    return out


def _jax_train(jm, v_np, example, jtask, batches, mesh_cfg, sharded=False,
               tmp_path=None, trainer_cfg=None):
    """STEPS of the JAX Trainer's step on ``mesh_cfg``: (losses, numpy
    variables)."""
    tx = jax_optimizer(OPT_CFG, steps_per_epoch=STEPS)
    state = jax_state(jm, example, tx, init_kwargs={"train": False})
    params = to_jax(v_np["params"])
    state = state.replace(params=params,
                          batch_stats=to_jax(v_np["batch_stats"]),
                          opt_state=tx.init(params))
    logger = JaxLogger({"log_dir": str(tmp_path), "tag": "jax",
                        "console": False, "tensorboard": False})
    trainer = JaxTrainer(logger, {"log_norms": False, **(trainer_cfg or {})},
                         jtask,
                         mesh=jax_mesh(mesh_cfg),
                         state_sharding_fn=(jax_state_shardings if sharded
                                            else None),
                         install_signal_handlers=False)
    trainer._build_steps(state)
    state = trainer._place_state(state)
    losses = []
    for b in batches:
        state, tb = trainer._train_step(state, trainer._place(b),
                                        jax.random.PRNGKey(0))
        losses.append(float(tb["loss"]))
    return losses, jax.device_get({"params": state.params,
                                   "batch_stats": state.batch_stats})


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, det_pair, serve_pair):
    """One spawn of two Gloo ranks running every multi-rank job of this
    file, and the JAX references."""
    tmp = tmp_path_factory.mktemp("ranks")
    det_j, det_v, det_port = det_pair
    det_spec = ("SpatialDrow", dict(window_size=WINDOW, pedestrian_only=True,
                                    num_cutout_pts=CT_LEN),
                det_port.state_dict())
    flow_cfg = {"type": "flow_unet"}
    flow_j, flow_v, flow_port = model_pair("flow_unet")
    flow_spec = ("registry", flow_cfg, flow_port.state_dict())
    det_task = ("DetectionTask", DET_TASK)
    flow_task = ("FlowUNetTask", {})
    det_b, flow_b = _det_batches(), _flow_batches()
    cfg = {"log_norms": True}

    def job(key, **args):
        return {"key": key, "kind": "train",
                "args": dict(opt_cfg=OPT_CFG, trainer_cfg=cfg, **args)}

    rng = np.random.default_rng(11)
    gate = dict(w=rng.normal(0, 0.1, (32, 16)).astype(np.float32),
                b=rng.normal(0, 0.1, 16).astype(np.float32), alpha=0.4,
                window=11,
                x=rng.normal(0, 1, (1, 32, 32)).astype(np.float32),
                template=rng.normal(0, 1, (1, 32, 32)).astype(np.float32))
    jobs = [job("det_dp", model=det_spec, task=det_task, batches=det_b,
                mesh={"data": 2}),
            job("det_1", model=det_spec, task=det_task, batches=det_b,
                mesh=None, rank_tag="s"),
            job("flow_dp", model=flow_spec, task=flow_task, batches=flow_b,
                mesh={"data": 2}),
            job("flow_1", model=flow_spec, task=flow_task, batches=flow_b,
                mesh=None, rank_tag="s"),
            job("det_tp", model=det_spec, task=det_task, batches=det_b,
                mesh={"data": 1, "model": 2}, sharded=True),
            {"key": "cp", "kind": "cp_gate",
             "args": dict(mesh={"data": 2}, **gate)},
            {"key": "serve", "kind": "serve_rank",
             "args": dict(model=("FlowDrow", dict(
                 window_size=WINDOW, pedestrian_only=True,
                 num_cutout_pts=CT_LEN), serve_pair[2].state_dict()),
                 cutout_kwargs=CUTOUT_KW, num_pts=NUM_PTS,
                 scans=list(_scans(46, steps=2, b=4)),
                 calib_scans=_scans(40, steps=1)[0], mesh={"data": 2},
                 kwargs=dict(precision="int8c"))}]
    spawned = Ranks(jobs, 2, tmp)  # the JAX references run meanwhile
    det_x = (jnp.zeros((1, NUM_PTS, 3, CT_LEN)),)
    flow_x = (jnp.zeros((1, FLOW_PTS, 2)),) * 2
    calls = {
        "det_dp": (det_j, det_v, det_x, jax_tasks.DetectionTask(**DET_TASK),
                   det_b, {"data": 2}, False),
        "flow_dp": (flow_j, flow_v, flow_x, jax_tasks.FlowUNetTask(), flow_b,
                    {"data": 2}, False),
        "det_tp": (det_j, det_v, det_x, jax_tasks.DetectionTask(**DET_TASK),
                   det_b, {"data": 1, "model": 2}, True),
    }
    # XLA compiles the three steps on threads of its own meanwhile
    with ThreadPoolExecutor(3) as pool:
        futures = {k: pool.submit(_jax_train, *args, tmp_path=tmp / k)
                   for k, args in calls.items()}
        refs = {k: f.result() for k, f in futures.items()}
    return dict(ranks=spawned.results(), refs=refs, gate=gate,
                ports={"det": det_port, "flow": flow_port}, jobs=jobs)


def _assert_train_close(got, ref_losses, ref_state, what):
    np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-5,
                               err_msg=what)
    for which in ("params", "stats"):
        names = [n for n in got["state"]
                 if n.endswith(STATS) == (which == "stats")]
        err = _rel_l2([got["state"][n] for n in names],
                      [np.asarray(ref_state[n], np.float32) for n in names])
        assert err <= 1e-3, f"{what} {which}: relative L2 {err:.3g}"


@pytest.mark.parametrize("kind", ["det", "flow"])
def test_data_parallel_steps_match_jax_data_mesh(two_ranks, kind):
    """``{data: 2}`` over two ranks against JAX's trainer on its 2-device
    data mesh: the global batch's BatchNorm moments and masked means."""
    losses, v = two_ranks["refs"][f"{kind}_dp"]
    ref = {n: t.numpy() for n, t in variables_to_state_dict(
        v, two_ranks["ports"][kind]).items()}
    for r, res in enumerate(two_ranks["ranks"]):
        _assert_train_close(res[f"{kind}_dp"], losses, ref,
                            f"{kind} rank {r}")


@pytest.mark.parametrize("kind", ["det", "flow"])
def test_data_parallel_steps_match_single_device(two_ranks, kind):
    """The same steps against the port's own run on the whole batch, and
    both ranks ending with the same state."""
    r0, r1 = two_ranks["ranks"]
    single = r0[f"{kind}_1"]
    for res in (r0, r1):
        _assert_train_close(res[f"{kind}_dp"], single["losses"],
                            single["state"], kind)
    for n, t in r0[f"{kind}_dp"]["state"].items():
        np.testing.assert_array_equal(t, r1[f"{kind}_dp"]["state"][n], n)
    # the logged gradient norm and the evaluation are the global batch's
    # (the norm sums squares of gradients whose f32 summation order
    # differs: 1e-4)
    for k in ("grad_norm", "cls_loss", "reg_loss", "fg_ratio"):
        if k in single["tb"][0]:
            np.testing.assert_allclose(r0[f"{kind}_dp"]["tb"][0][k],
                                       single["tb"][0][k], rtol=1e-4,
                                       err_msg=k)
    for k, v in single["metrics"].items():
        np.testing.assert_allclose(r0[f"{kind}_dp"]["metrics"][k], v,
                                   rtol=1e-4, atol=1e-7, err_msg=k)


def test_model_parallel_steps_match_jax(two_ranks):
    """``{data: 1, model: 2}`` on SpatialDROW against JAX's trainer with
    ``state_shardings``; each rank held the rule's leaves as halves."""
    losses, v = two_ranks["refs"]["det_tp"]
    ref = {n: t.numpy() for n, t in variables_to_state_dict(
        v, two_ranks["ports"]["det"]).items()}
    for res in two_ranks["ranks"]:
        got = res["det_tp"]
        _assert_train_close(got, losses, ref, "det_tp")
        assert got["split"] == sorted(
            n for n in got["shard_shapes"])
        assert {"gate.embed.weight", "head.block3.blocks.2.conv.weight",
                "head.block3.blocks.2.bn.running_var",
                "head.block4.blocks.0.conv.weight"} <= set(got["split"])
        for n, shape in got["shard_shapes"].items():
            full = got["state"][n].shape
            d = 1 if n == "head.block4.blocks.0.conv.weight" else 0
            assert shape[d] * 2 == full[d], n
    np.testing.assert_allclose(two_ranks["ranks"][0]["det_tp"]["losses"],
                               two_ranks["ranks"][0]["det_1"]["losses"],
                               rtol=1e-5)


def _gate_refs(g, context_parallel: bool):
    """JAX's dense gate on the gate inputs of :func:`two_ranks`, and its
    ``gate_step_context_parallel`` on two devices when asked (its
    ``shard_map`` takes ~17 s to compile on the CPU)."""
    from planar_optical_flow_tpu.infer import fast_gate as jfg
    from planar_optical_flow_tpu.parallel import (
        gate_step_context_parallel as jax_cp,
    )

    params = jfg.GateParams(w=jnp.asarray(g["w"]), b=jnp.asarray(g["b"]),
                            alpha=g["alpha"], window_size=g["window"])
    x, t = jnp.asarray(g["x"]), jnp.asarray(g["template"])
    z_t = jfg.embed(params, t)
    refs = [jax.jit(lambda a, b, c: jfg.gate_step(
        params, a, b, c, use_pallas=False))(x, t, z_t)]
    if context_parallel:
        refs.append(jax_cp(params, x, t, z_t, jax_mesh({"data": 2}),
                           axis="data"))
    return refs


def _assert_gate_close(ranks, refs):
    for r, res in enumerate(ranks):
        rows = slice(16 * r, 16 * (r + 1))
        for ref in refs:
            for got, want in zip(res["cp"], ref):
                np.testing.assert_allclose(got, np.asarray(want)[:, rows],
                                           rtol=1e-5, atol=1e-5)


def test_context_parallel_gate_matches_dense(two_ranks):
    """The gate with its 32 cutouts over two ranks (window 11: a halo of 5
    of each shard's 16 rows) against JAX's dense gate."""
    _assert_gate_close(two_ranks["ranks"],
                       _gate_refs(two_ranks["gate"], False))


@pytest.mark.slow
def test_context_parallel_gate_matches_jax(two_ranks):
    """The same against JAX's ``gate_step_context_parallel`` on two
    devices."""
    _assert_gate_close(two_ranks["ranks"],
                       _gate_refs(two_ranks["gate"], True)[1:])


def test_context_parallel_guards():
    from planar_optical_flow_tpu_torch.infer.fast_gate import GateParams

    mesh = parallel.make_mesh(devices=[torch.device("cpu")])
    p = GateParams(w=torch.zeros(8, 4), b=torch.zeros(4), alpha=0.5,
                   window_size=19)
    x = torch.zeros(1, 8, 8)
    with pytest.raises(ValueError, match="halo"):
        parallel.gate_step_context_parallel(p, x, x, torch.zeros(1, 8, 4),
                                            mesh)
    two = parallel.make_mesh(devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.gate_step_context_parallel(p, torch.zeros(1, 9, 8),
                                            torch.zeros(1, 9, 8),
                                            torch.zeros(1, 9, 4), two)


# ---------------------------------------------------------- sharded serving


def _scans(seed, steps=2, b=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 20.0, (steps, b, NUM_PTS)).astype(np.float32)


def test_sharded_serve_step_bf16(serve_pair):
    """bf16 over two shards of one process against the unsharded port step
    (JAX's bar for its own sharded step; the unsharded step is held against
    JAX's in ``tests/test_torch_streaming.py``)."""
    _, _, port = serve_pair
    mesh = parallel.make_mesh(devices=[torch.device("cpu")] * 2)
    single = make_serve_step_v3(port, CUTOUT_KW, num_pts=NUM_PTS,
                                device="cpu")
    sharded = make_serve_step_v3(port, CUTOUT_KW, num_pts=NUM_PTS, mesh=mesh)
    c_s = c_m = None
    for i, scan in enumerate(_scans(5, b=4)):
        c_s, out_s = single(c_s, torch.from_numpy(scan))
        c_m, out_m = sharded(c_m, scan)
        assert isinstance(c_m, ShardedCarry) and len(c_m) == 2
        for k in ("pred_cls", "pred_flow"):
            np.testing.assert_allclose(t2n(out_m[k]), t2n(out_s[k]),
                                       rtol=2e-2, atol=2e-2,
                                       err_msg=f"step {i} {k}")
        keep = (t2n(out_m["det_keep"]) == t2n(out_s["det_keep"])).mean()
        assert keep > 0.95, keep
    np.testing.assert_allclose(t2n(c_m.gather()["template"]),
                               t2n(c_s["template"]), rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        sharded(None, _scans(6, b=3)[0])


def test_sharded_serve_step_int8c(serve_pair, tmp_path):
    """int8c p2 over two shards: calibrated once, the template carries
    equal to the bit to the unsharded step's (a whole carry passed back in
    splits by streams), and within 1 LSB of JAX's sharded step on the same
    calibration."""
    model, variables, port = serve_pair
    mesh = parallel.make_mesh(devices=[torch.device("cpu")] * 2)
    calib_scans = _scans(40, steps=1)[0]
    ref_step = jax_v3(model, variables, CUTOUT_KW, calib_scans=calib_scans,
                      num_pts=NUM_PTS, precision="int8c", pm_tile=TILE,
                      interpret=True, mesh=jax_mesh({"data": 2}))
    calib = ServeCalibration.load(ref_step.calibration.save(str(tmp_path)))
    kw = dict(num_pts=NUM_PTS, precision="int8c", calib=calib)
    single = make_serve_step_v3(port, CUTOUT_KW, device="cpu", **kw)
    sharded = make_serve_step_v3(port, CUTOUT_KW, mesh=mesh, **kw)
    assert sharded.calibration is calib
    c_s = c_m = c_j = None
    for i, scan in enumerate(_scans(46, steps=2)):
        c_s, out_s = single(c_s, torch.from_numpy(scan))
        c_m, out_m = sharded(c_m if i != 1 else c_m.gather(), scan)
        c_j, _ = ref_step(c_j, jnp.asarray(scan))
        whole = c_m.gather()
        for k in ("template", "z"):
            assert torch.equal(whole[k], c_s[k]), (i, k)
        for k in out_s:
            assert torch.equal(out_m[k], out_s[k]), (i, k)
        assert_int8_close(whole["template"].numpy(),
                          pm_to_port(c_j["template"]), f"step {i}")
    # calibrated on the spot: once, shared by both shards
    fresh = make_serve_step_v3(port, CUTOUT_KW, num_pts=NUM_PTS,
                               precision="int8c", calib_scans=calib_scans,
                               mesh=mesh)
    assert fresh.calibration is not None and fresh.shards == [
        torch.device("cpu")] * 2


def test_serve_step_needs_a_data_axis(serve_pair):
    mesh = parallel.make_mesh(("model",), devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="no data axis"):
        make_serve_step_v3(serve_pair[2], CUTOUT_KW, num_pts=NUM_PTS,
                           mesh=mesh)


def test_sharded_serve_step_across_processes(two_ranks, serve_pair):
    """On a multi-process ``{data: 2}`` mesh each rank serves its block of
    the batch's streams (calibrated alike on each rank): its int8c carries
    and outputs equal the unsharded step's rows to the bit."""
    args = two_ranks["jobs"][-1]["args"]
    step = make_serve_step_v3(serve_pair[2], CUTOUT_KW, num_pts=NUM_PTS,
                              precision="int8c",
                              calib_scans=args["calib_scans"], device="cpu")
    carry = None
    for scan in args["scans"]:
        carry, out = step(carry, torch.from_numpy(scan))
    rows = carry["template"].shape[0] // 2
    for r, res in enumerate(two_ranks["ranks"]):
        got = res["serve"]
        np.testing.assert_array_equal(
            got["template"], carry["template"][r * rows:(r + 1) * rows])
        for k, v in got["outs"][-1].items():
            np.testing.assert_array_equal(v, out[k][2 * r:2 * (r + 1)], k)
