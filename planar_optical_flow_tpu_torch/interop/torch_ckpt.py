"""Import the reference's PyTorch checkpoints (``.pth``) into the port.

Counterpart of ``planar_optical_flow_tpu/interop/torch_ckpt.py``. Users of
the reference hold trained ``.pth`` files, such as the
``dr_spaam_e40.pth`` detector that its ``FlowDROW_pretrained`` loads. The
envelope of both reference generations is ``{"epoch", "it"|"step",
"model_state", "optimizer_state"}`` with ``model_state`` a ``state_dict``;
the optimizer state is not imported, the epoch and step are.

The port's modules are PyTorch, named after the flax modules (the flax
bridge's mapping), so a reference ``state_dict`` maps straight onto the
port model's ``state_dict``, with the JAX importer's layout rules:

* a reference ``nn.Sequential(Conv1d, BatchNorm1d, LeakyReLU)`` (conv at
  ``.0``, BatchNorm at ``.1``) -> the port's ``ConvBlock`` ``conv`` and
  ``bn`` (the conv weight ``(out, in, k)`` as it is);
* a pointwise conv ``(out, in, 1)``, a ``Linear`` ``(out, in)`` and the
  DR-SPAAM gate embedding's full-width conv ``(out, in, L)`` -> a dense
  ``weight (out, L*in)`` whose columns run over ``(l, c)``, as the JAX
  importer's Dense over the flat feature (``w.permute(0, 2, 1)``);
* ``BatchNorm1d`` -> ``weight``, ``bias``, ``running_mean``,
  ``running_var``; every ``num_batches_tracked`` is set to 0, as the flax
  bridge sets it (eval mode does not read it).

The result equals the JAX importer's variables carried across by
``interop.variables_to_state_dict``, to the bit. The nine model types of
the JAX importer: ``flow_unet``/``prototype``, ``prototype_test``/
``flow_unet_additive``, ``drow``, ``dr-spaam``/``spatial_drow``,
``flow_drow`` and ``box_reg``. ``flow_drow`` imports the detector: a full
``FlowDROW_pretrained`` ``state_dict`` (its ``dr_spaam.`` entries; the
reference flow head is shape-incompatible by construction, its weights are
skipped with a warning and the model's own flow head stays as it is) or a
plain pre-trained SpatialDROW one, grafted into ``dr_spaam``.
"""

from __future__ import annotations

import warnings

import torch

__all__ = ["import_state_dict", "import_torch_checkpoint",
           "load_reference_checkpoint"]

_BN = ("weight", "bias", "running_mean", "running_var")


def load_reference_checkpoint(path: str):
    """Load a reference ``.pth`` file -> ``(state_dict, meta)``.

    Takes the checkpoint envelope (a ``model_state`` key) or a bare
    ``state_dict``, read with ``weights_only=True`` (tensors and plain
    containers, no pickled code), on the CPU. A ``module.`` prefix
    (``torch.nn.DataParallel``) is stripped. ``meta`` carries ``epoch`` and
    ``step`` (0 when absent; the older stack's fractional ``it`` is
    floored). Values come back as f32 tensors.
    """
    payload = torch.load(path, map_location="cpu", weights_only=True)
    meta = {"epoch": 0, "step": 0}
    if isinstance(payload, dict) and "model_state" in payload:
        meta["epoch"] = int(payload.get("epoch") or 0)
        meta["step"] = int(payload.get("step", payload.get("it", 0)) or 0)
        payload = payload["model_state"]
    if not isinstance(payload, dict):
        raise ValueError(
            f"{path}: expected a state_dict or a reference checkpoint "
            f"envelope, got {type(payload).__name__}")
    sd = {}
    for key, value in payload.items():
        if key.startswith("module."):
            key = key[len("module."):]
        sd[key] = torch.as_tensor(value).detach().to("cpu", torch.float32)
    return sd, meta


class _Importer:
    """Fills ``out`` (a copy of the model's ``state_dict``) from ``sd``,
    checking every key, shape and module structure on the way."""

    def __init__(self, sd: dict, target: dict):
        self.sd = sd
        self.target = target
        self.out = {k: v.clone() for k, v in target.items()}

    def ref(self, key):
        if key not in self.sd:
            raise KeyError(f"checkpoint has no {key!r}")
        return self.sd[key]

    def put(self, dst: str, leaves: dict):
        """Set the model's module ``dst`` to ``leaves`` (name -> tensor):
        its parameters and statistics must be exactly these, of the same
        shapes."""
        have = sorted(k[len(dst) + 1:] for k in self.target
                      if k.startswith(dst + ".")
                      and not k.endswith("num_batches_tracked"))
        if not have:
            raise KeyError(f"model has no module {dst!r}")
        if have != sorted(leaves):
            raise ValueError(
                f"structure mismatch at {dst!r}: model has {have}, "
                f"checkpoint maps {sorted(leaves)}")
        for name, value in leaves.items():
            key = f"{dst}.{name}"
            if tuple(self.target[key].shape) != tuple(value.shape):
                raise ValueError(
                    f"shape mismatch at {key!r}: model "
                    f"{tuple(self.target[key].shape)} vs checkpoint "
                    f"{tuple(value.shape)} — wrong model config for this "
                    "checkpoint?")
            self.out[key] = value.clone()

    def bn(self, src, prefix=""):
        return {prefix + n: self.ref(f"{src}.{n}") for n in _BN}

    def dense(self, src):
        """A Linear, a pointwise conv or the full-width gate conv as a
        dense ``(weight (out, k*in), bias)``, columns over ``(k, in)``."""
        w = self.ref(f"{src}.weight")
        if w.ndim == 3:
            w = w.permute(0, 2, 1).reshape(w.shape[0], -1)
        return {"weight": w, "bias": self.ref(f"{src}.bias")}

    def conv_block(self, src, dst):
        """A reference conv block (``src.0`` conv, ``src.1`` BatchNorm) ->
        the port's ``ConvBlock`` at ``dst``."""
        self.put(dst, {"conv.weight": self.ref(f"{src}.0.weight"),
                       "conv.bias": self.ref(f"{src}.0.bias"),
                       **self.bn(f"{src}.1", "bn.")})

    def conv_stack(self, src, dst):
        n = 0
        while f"{src}.{n}.0.weight" in self.sd:
            self.conv_block(f"{src}.{n}", f"{dst}.blocks.{n}")
            n += 1
        if n == 0:
            raise KeyError(f"no conv blocks under {src!r} in checkpoint")

    def dense_block(self, src, dst):
        """A reference ``_fc``/``_conv1x1`` sequential (or, for the bare
        ``fc3``, the Linear itself) -> the port's ``DenseBlock``."""
        first = f"{src}.0" if f"{src}.0.weight" in self.sd else src
        leaves = {f"dense.{k}": v for k, v in self.dense(first).items()}
        if f"{src}.1.running_mean" in self.sd:
            leaves.update(self.bn(f"{src}.1", "bn."))
        self.put(dst, leaves)


def _flow_unet(imp: _Importer, prefix=""):
    if any(k.startswith("flow_reg_linear.") for k in imp.target):
        raise ValueError(
            "FlowUNet(linear_head=True) has no reference counterpart; "
            "import into FlowUNet(linear_head=False)")
    for name in ("encoder_0", "encoder_1", "encoder_2", "decoder_1",
                 "decoder_0", "flow_reg"):
        imp.conv_block(name, name)


def _flow_unet_additive(imp: _Importer, prefix=""):
    for name in ("conv1", "conv2", "conv3", "conv4", "flow_reg"):
        imp.conv_block(name, name)


def _drow(imp: _Importer, prefix=""):
    """Reference ``DROW``/``SpatialDROW`` -> ``Drow``/``SpatialDrow`` (under
    ``prefix``)."""
    for src, dst in (("conv_block_1", "backbone.block1"),
                     ("conv_block_2", "backbone.block2"),
                     ("conv_block_3", "head.block3"),
                     ("conv_block_4", "head.block4")):
        imp.conv_stack(src, prefix + dst)
    imp.put(prefix + "head.cls", imp.dense("conv_cls"))
    imp.put(prefix + "head.reg", imp.dense("conv_reg"))
    has_gate = "gate.conv.0.weight" in imp.sd
    model_gate = any(k.startswith(prefix + "gate.") for k in imp.target)
    if model_gate != has_gate:
        raise ValueError(
            "model/checkpoint mismatch: "
            + ("model has an attention gate but the checkpoint is a plain "
               "DROW" if model_gate else
               "checkpoint has an attention gate (SpatialDROW) but the "
               "model is a plain Drow"))
    if has_gate:
        # the full-width conv (128, 256, L): a dense over the flat (l, c)
        # feature
        imp.put(prefix + "gate.embed", imp.dense("gate.conv.0"))
        imp.put(prefix + "gate.embed_bn", imp.bn("gate.conv.1"))


def _box_reg(imp: _Importer, prefix=""):
    for i in range(4):
        imp.dense_block(f"backbone.conv{i + 1}", f"backbone.DenseBlock_{i}")
    for name in ("fc1", "fc2", "fc3"):
        imp.dense_block(name, name)


def _flow_drow(imp: _Importer, prefix=""):
    """Reference ``FlowDROW_pretrained`` (its ``dr_spaam.`` entries) or a
    plain pre-trained SpatialDROW -> ``FlowDrow.dr_spaam``."""
    sd = imp.sd
    if any(key.startswith("dr_spaam.") for key in sd):
        skipped = sorted({key.split(".")[0] for key in sd
                          if not key.startswith("dr_spaam.")})
        if skipped:
            warnings.warn(
                "flow_drow import: reference flow-head weights "
                f"({', '.join(skipped)}) skipped — the reference head is "
                "shape-incompatible by construction (its forward is broken, "
                "dr_spaam.py:308-322); the flow head keeps its fresh "
                "initialization and must be (re)trained", stacklevel=4)
        imp.sd = {key[len("dr_spaam."):]: value for key, value in sd.items()
                  if key.startswith("dr_spaam.")}
    _drow(imp, "dr_spaam.")


_IMPORTERS = {
    "flow_unet": _flow_unet,
    "prototype": _flow_unet,
    "prototype_test": _flow_unet_additive,
    "flow_unet_additive": _flow_unet_additive,
    "drow": _drow,
    "dr-spaam": _drow,
    "spatial_drow": _drow,
    "flow_drow": _flow_drow,
    "box_reg": _box_reg,
}


def import_state_dict(model: torch.nn.Module, state_dict: dict,
                      model_type: str) -> dict:
    """A reference ``state_dict`` -> a ``state_dict`` for ``model`` (the
    port module of ``model_type``, built at the checkpoint's widths): its
    own entries, with the reference's weights in place of those the
    checkpoint covers. ``model`` is not changed; load the result with
    ``model.load_state_dict``. Raises ``KeyError``/``ValueError`` with a
    readable message where the checkpoint does not fit the model's
    structure or shapes."""
    if model_type not in _IMPORTERS:
        raise ValueError(
            f"unsupported model type {model_type!r}; supported: "
            f"{sorted(_IMPORTERS)}")
    sd = {k: torch.as_tensor(v).detach().to("cpu", torch.float32)
          for k, v in state_dict.items()}
    target = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    imp = _Importer(sd, target)
    _IMPORTERS[model_type](imp)
    for key, value in imp.out.items():
        if key.endswith("num_batches_tracked"):
            imp.out[key] = torch.zeros_like(value)
    return imp.out


def import_torch_checkpoint(path: str, model: torch.nn.Module,
                            model_type: str):
    """One call: read ``path`` (:func:`load_reference_checkpoint`) and map
    it onto ``model`` (:func:`import_state_dict`). Returns ``(state_dict,
    meta)`` with ``meta = {epoch, step}``."""
    sd, meta = load_reference_checkpoint(path)
    return import_state_dict(model, sd, model_type), meta
