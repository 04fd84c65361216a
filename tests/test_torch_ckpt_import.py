"""Reference PyTorch checkpoints into the port (``interop/torch_ckpt.py``,
``cli/import_checkpoint.py``), against the JAX package's importer.

The reference repository is not needed: the tests make reference-keyed
``state_dict``s themselves (the reference's module names, with the
weights in the reference's layouts: conv ``(out, in, k)``, pointwise convs
``(out, in, 1)``, the gate embedding's full-width conv ``(128, 256, L)``)
from a numpy seed.

* for each of the nine model types, the JAX importer's variables carried
  across by the flax bridge equal the port importer's ``state_dict`` to the
  bit, and the imported models' f32 forwards agree within 1e-3;
* the checkpoint envelope (epoch, step, ``it``), the ``module.`` prefix,
  the ``flow_drow`` graft of a plain detector and the skipped flow head
  with its warning, and the readable errors;
* ``cli.import_checkpoint`` then ``cli.infer`` on the result.
"""

from __future__ import annotations

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planar_optical_flow_tpu.interop import (
    import_state_dict as jax_import,
    load_reference_checkpoint as jax_load_reference,
)
from planar_optical_flow_tpu.models import get_model as jax_get_model
from planar_optical_flow_tpu_torch.cli import (
    import_checkpoint as import_cli,
)
from planar_optical_flow_tpu_torch.cli import infer as infer_cli
from planar_optical_flow_tpu_torch.data import (
    drow_io,
    write_synthetic_drow_split,
)
from planar_optical_flow_tpu_torch.infer import StreamingRunner
from planar_optical_flow_tpu_torch.interop import (
    import_state_dict,
    import_torch_checkpoint,
    load_reference_checkpoint,
    variables_to_state_dict,
)
from planar_optical_flow_tpu_torch.models import get_model
from planar_optical_flow_tpu_torch.pipeline import normalize_config
from tests.test_torch_common import (
    CT_LEN,
    CUTOUT_KW,
    NUM_PTS,
    WINDOW,
    one_thread,  # noqa: F401 (a fixture)
    t2n,
)

TOL = dict(rtol=1e-3, atol=1e-3)
DETECTOR = {"pedestrian_only": True, "window_size": WINDOW}
# importer type -> the registry config of its model (both packages)
TYPES = {
    "flow_unet": {"type": "flow_unet"},
    "prototype": {"type": "prototype"},
    "prototype_test": {"type": "prototype_test"},
    "flow_unet_additive": {"type": "prototype_test"},
    "drow": {"type": "drow", "pedestrian_only": True},
    "dr-spaam": {"type": "dr-spaam", **DETECTOR},
    "spatial_drow": {"type": "spatial_drow", **DETECTOR},
    "flow_drow": {"type": "flow_drow", **DETECTOR},
    "box_reg": {"type": "box_reg", "dropout": 0.0},
}


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """See ``test_torch_common.one_thread``."""


def _inputs(cfg, rng):
    """The model's forward inputs, f32 numpy."""
    mtype = cfg["type"]
    if mtype in ("flow_unet", "prototype", "prototype_test"):
        return tuple(rng.normal(0, 3, (2, NUM_PTS, 2)).astype(np.float32)
                     for _ in range(2))
    if mtype == "box_reg":
        return (rng.normal(0, 1, (3, 32, 4)).astype(np.float32),)
    x = rng.normal(0, 0.3, (2, NUM_PTS, 2, CT_LEN)).astype(np.float32)
    if mtype == "flow_drow":
        return x, rng.uniform(0.5, 10, (2, NUM_PTS)).astype(np.float32)
    return (x,)


def _models(mtype, seed=0):
    """(flax model, its numpy init variables, the port model carrying
    them)."""
    cfg = TYPES[mtype]
    jm = jax_get_model(cfg)
    zeros = [jnp.zeros(x.shape) for x in _inputs(cfg,
                                                 np.random.default_rng(0))]
    variables = jm.init(jax.random.PRNGKey(seed), *zeros, train=False)
    v_np = jax.tree_util.tree_map(np.asarray, dict(variables))
    port = get_model(cfg, CT_LEN)
    port.load_state_dict(variables_to_state_dict(v_np, port))
    return jm, v_np, port.eval()


# the reference's names of the port's modules
_DROW_BLOCKS = {"backbone.block1": "conv_block_1",
                "backbone.block2": "conv_block_2",
                "head.block3": "conv_block_3", "head.block4": "conv_block_4"}


def _reference_key(key):
    """A port key -> (the reference key, whether its weight is a dense
    stored as the reference's conv)."""
    prefix = "dr_spaam." if key.startswith("dr_spaam.") else ""
    k = key[len(prefix):]
    m = re.fullmatch(r"(backbone\.block\d|head\.block\d)\.blocks\.(\d+)\."
                     r"(conv|bn)\.(\w+)", k)
    if m:
        idx = "0" if m.group(3) == "conv" else "1"
        return (f"{prefix}{_DROW_BLOCKS[m.group(1)]}.{m.group(2)}.{idx}."
                f"{m.group(4)}", False)
    m = re.fullmatch(r"head\.(cls|reg)\.(weight|bias)", k)
    if m:
        return f"{prefix}conv_{m.group(1)}.{m.group(2)}", True
    m = re.fullmatch(r"gate\.(embed|embed_bn)\.(\w+)", k)
    if m:
        idx = "0" if m.group(1) == "embed" else "1"
        return f"{prefix}gate.conv.{idx}.{m.group(2)}", m.group(1) == "embed"
    m = re.fullmatch(r"backbone\.DenseBlock_(\d)\.(dense|bn)\.(\w+)", k)
    if m:  # the PointNet's pointwise convs
        idx = "0" if m.group(2) == "dense" else "1"
        return (f"backbone.conv{int(m.group(1)) + 1}.{idx}.{m.group(3)}",
                m.group(2) == "dense")
    m = re.fullmatch(r"(fc1|fc2)\.(dense|bn)\.(\w+)", k)
    if m:  # Linear + BatchNorm sequentials
        idx = "0" if m.group(2) == "dense" else "1"
        return f"{m.group(1)}.{idx}.{m.group(3)}", False
    m = re.fullmatch(r"fc3\.dense\.(\w+)", k)
    if m:  # a bare Linear
        return f"fc3.{m.group(1)}", False
    m = re.fullmatch(r"(\w+)\.(conv|bn)\.(\w+)", k)
    if m:  # the flow U-Nets' named conv blocks
        idx = "0" if m.group(2) == "conv" else "1"
        return f"{m.group(1)}.{idx}.{m.group(3)}", False
    raise KeyError(key)


def reference_state_dict(port, seed, skip=()):
    """A reference-keyed ``state_dict`` for ``port``'s architecture with
    weights from a numpy seed (BatchNorm statistics in range); the port's
    ``skip`` modules left out."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, value in port.state_dict().items():
        if key.endswith("num_batches_tracked") or key.startswith(skip):
            continue
        ref, conv = _reference_key(key)
        shape = tuple(value.shape)
        leaf = ref.rsplit(".", 1)[1]
        if leaf == "running_var":
            a = rng.uniform(0.5, 2.0, shape)
        elif leaf == "weight" and ".1." in ref and value.ndim == 1:
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.normal(0, 0.1, shape)
        a = torch.from_numpy(a.astype(np.float32))
        if conv and leaf == "weight":
            if key.endswith("gate.embed.weight"):  # (128, L*256) -> (128,
                # 256, L): the dense's columns run over (l, c)
                a = a.reshape(a.shape[0], -1, 256).permute(0, 2, 1)
            else:
                a = a[:, :, None]
            a = a.contiguous()
        sd[ref] = a
        if leaf == "running_var":
            sd[ref.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(7)
    return sd


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("mtype", TYPES)
def test_import_matches_jax_importer(mtype):
    jm, v_np, port = _models(mtype)
    # FlowDROW_pretrained's own flow head is tested below
    sd = reference_state_dict(port, seed=len(mtype), skip=(
        ("flow_conv", "flow_out") if mtype == "flow_drow" else ()))
    jax_vars = jax_import(v_np, sd, mtype)
    want = variables_to_state_dict(jax_vars, port)
    got = import_state_dict(port, sd, mtype)
    _assert_state_equal(got, want)
    # the model itself is left as it was
    _assert_state_equal(port.state_dict(), variables_to_state_dict(v_np,
                                                                   port))

    port.load_state_dict(got)
    inputs = _inputs(TYPES[mtype], np.random.default_rng(2))
    ref = jm.apply(jax.tree_util.tree_map(jnp.asarray, jax_vars),
                   *(jnp.asarray(x) for x in inputs), train=False)
    with torch.no_grad():
        out = port(*(torch.from_numpy(x) for x in inputs))
    ref, out = jax.tree_util.tree_leaves(ref), (
        list(out) if isinstance(out, tuple) else [out])
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(t2n(o), np.asarray(r), **TOL)


def test_flow_drow_graft_and_skipped_head():
    """A plain SpatialDROW checkpoint is grafted into ``dr_spaam``; a
    ``FlowDROW_pretrained`` one imports its detector and skips the
    reference flow head with JAX's warning; both equal the JAX importer."""
    _, v_np, port = _models("flow_drow")
    det = reference_state_dict(port.dr_spaam, seed=3)
    _assert_state_equal(
        import_state_dict(port, det, "flow_drow"),
        variables_to_state_dict(jax_import(v_np, det, "flow_drow"), port))

    full = {f"dr_spaam.{k}": v for k, v in det.items()}
    full["flow_conv1.0.weight"] = torch.zeros(128, CT_LEN, 3)  # reference's
    with pytest.warns(UserWarning, match="flow-head weights"):
        got = import_state_dict(port, full, "flow_drow")
    with pytest.warns(UserWarning, match="flow-head weights"):
        want = variables_to_state_dict(jax_import(v_np, full, "flow_drow"),
                                       port)
    _assert_state_equal(got, want)
    # the port's flow head kept its weights
    assert torch.equal(got["flow_out.conv.weight"],
                       port.state_dict()["flow_out.conv.weight"])


def test_envelope_and_module_prefix(tmp_path):
    _, _, port = _models("dr-spaam")
    sd = reference_state_dict(port, seed=4)
    path = str(tmp_path / "ckpt.pth")
    torch.save({"epoch": 40, "it": 1234.7,
                "model_state": {f"module.{k}": v for k, v in sd.items()},
                "optimizer_state": {"state": {}, "param_groups": []}}, path)
    got_sd, meta = load_reference_checkpoint(path)
    want_sd, want_meta = jax_load_reference(path)
    assert meta == want_meta == {"epoch": 40, "step": 1234}
    assert set(got_sd) == set(want_sd) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(got_sd[k].numpy(), want_sd[k])
    imported, meta2 = import_torch_checkpoint(path, port, "dr-spaam")
    assert meta2 == meta
    _assert_state_equal(imported, import_state_dict(port, sd, "dr-spaam"))
    # a bare state_dict with "step", and a file that is neither
    torch.save(sd, path)
    assert load_reference_checkpoint(path)[1] == {"epoch": 0, "step": 0}
    torch.save({"epoch": 2, "step": 9, "model_state": sd}, path)
    assert load_reference_checkpoint(path)[1] == {"epoch": 2, "step": 9}
    torch.save([1, 2], path)
    with pytest.raises(ValueError, match="expected a state_dict"):
        load_reference_checkpoint(path)


def test_import_errors():
    _, _, spatial = _models("dr-spaam")
    sd = reference_state_dict(spatial, seed=5)
    with pytest.raises(ValueError, match="unsupported model type"):
        import_state_dict(spatial, sd, "fc1d")
    # four classes into a pedestrian-only model
    four = get_model({"type": "dr-spaam", "window_size": WINDOW}, CT_LEN)
    with pytest.raises(ValueError, match="shape mismatch"):
        import_state_dict(spatial, reference_state_dict(four, seed=5),
                          "dr-spaam")
    # a gated checkpoint into a plain DROW, and the reverse
    plain = get_model({"type": "drow", "pedestrian_only": True}, CT_LEN)
    with pytest.raises(ValueError, match="attention gate"):
        import_state_dict(plain, sd, "drow")
    with pytest.raises(ValueError, match="attention gate"):
        import_state_dict(spatial, reference_state_dict(plain, seed=5),
                          "dr-spaam")
    missing = {k: v for k, v in sd.items() if not k.startswith("conv_cls")}
    with pytest.raises(KeyError, match="conv_cls"):
        import_state_dict(spatial, missing, "dr-spaam")
    with pytest.raises(KeyError, match="no conv blocks"):
        import_state_dict(spatial, {}, "dr-spaam")
    linear = get_model({"type": "flow_unet", "linear_head": True})
    with pytest.raises(ValueError, match="linear_head"):
        import_state_dict(linear, {}, "flow_unet")


def test_cli_import_then_infer(tmp_path):
    """``cli.import_checkpoint`` of a ``FlowDROW_pretrained`` envelope
    writes a training checkpoint with its epoch and step; ``cli.infer``
    from it equals a runner on the imported weights."""
    _, _, port = _models("flow_drow")
    sd = reference_state_dict(port.dr_spaam, seed=6)
    pth = str(tmp_path / "flow_drow.pth")
    torch.save({"epoch": 12, "step": 345,
                "model_state": {f"dr_spaam.{k}": v for k, v in sd.items()}},
               pth)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "network": "cutout_spatial", "pedestrian_only": True,
        "num_scans": 2, "cutout_kwargs": CUTOUT_KW,
        "similarity_kwargs": {"alpha": 0.5, "window_size": WINDOW}}))
    out = str(tmp_path / "imported")
    assert import_cli.main(["--pth", pth, "--cfg", str(cfg), "--out", out,
                            "--cpu"]) == 0
    state = torch.load(os.path.join(out, "train_state.pt"),
                       weights_only=True)
    assert (state["epoch"], state["step"]) == (12, 345)

    stem = write_synthetic_drow_split(str(tmp_path / "data"), "val",
                                      num_sequences=1, num_frames=5,
                                      num_pts=NUM_PTS)[0]
    rc, got, _ = infer_cli.infer(["--cfg", str(cfg), "--ckpt", out,
                                  "--sequence", stem, "--cpu"])
    assert rc == 0 and len(got) == 5
    # the model the config describes, with the imported weights
    model = get_model(normalize_config(json.loads(cfg.read_text()))["model"],
                      CT_LEN)
    model.load_state_dict(import_state_dict(
        model, {f"dr_spaam.{k}": v for k, v in sd.items()}, "flow_drow"))
    runner = StreamingRunner(model, CUTOUT_KW, num_pts=NUM_PTS,
                             output_fields=("det_xys", "det_cls", "det_keep",
                                            "pred_flow"), device="cpu")
    want = infer_cli.serve_sequence(
        runner, torch.from_numpy(drow_io.load_scan_file(stem)[2]), log=None)
    for g, w in zip(got, want):
        for k in ("dets", "conf", "flow"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
