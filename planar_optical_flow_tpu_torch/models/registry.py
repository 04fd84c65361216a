"""Model registry: config dict -> port module.

Counterpart of ``planar_optical_flow_tpu/models/registry.py`` for the DROW
family: the streaming types the serving engines run, ``"flow_drow"`` ->
:class:`FlowDrow` and ``"dr-spaam"``/``"spatial_drow"`` ->
:class:`SpatialDrow`, and ``"drow"`` -> :class:`Drow`. The training keys
``dropout``, ``remat`` and ``freeze_detector`` are passed on;
``banded_chunk`` is accepted and computes the dense gate, which is the
same function (ROADMAP item 11b ports the banded form).

The flax modules infer the gate's feature width from their first input;
the port's are built with it, from ``num_cutout_pts`` (the config's
``dataset.cutout_kwargs.num_cutout_pts``, default 48, as ``bin/infer.py``
reads it: :func:`num_cutout_pts_of`).

Every other type of the JAX registry raises ``NotImplementedError`` naming
the ``ROADMAP.md`` item that ports it.
"""

from __future__ import annotations

import torch

from planar_optical_flow_tpu_torch.models.drow import Drow
from planar_optical_flow_tpu_torch.models.flow_drow import FlowDrow
from planar_optical_flow_tpu_torch.models.spatial_drow import SpatialDrow

# model types whose forward carries template state across scans: these
# serve through the streaming engines
STREAMING_MODEL_TYPES = ("flow_drow", "dr-spaam", "spatial_drow")
PORTED_MODEL_TYPES = (*STREAMING_MODEL_TYPES, "drow")

# the JAX registry's other types -> the ROADMAP.md item that ports them
NOT_PORTED = {
    "flow_unet": "15",
    "prototype": "15",
    "prototype_test": "15",
    "box_reg": "16",
    "fc1d": "17",
    "fc1d_fea": "17",
    "fc2d": "17",
}


def num_cutout_pts_of(cfg: dict) -> int:
    """Cutout points of a nested pipeline config (default 48)."""
    return cfg.get("dataset", {}).get("cutout_kwargs", {}).get(
        "num_cutout_pts", 48)


def get_model(cfg: dict, num_cutout_pts: int = 48,
              generator: torch.Generator | None = None):
    """Build the module of ``cfg["type"]`` (the ``model`` section of a
    nested config), in eval mode (its forward trains only when called with
    ``train=True``). ``generator`` seeds the initial weights (default: seed
    0); load trained ones with ``load_state_dict``."""
    mtype = cfg["type"]
    if mtype in NOT_PORTED:
        raise NotImplementedError(
            f"model type {mtype!r} is not ported yet (ROADMAP.md queue 1 "
            f"item {NOT_PORTED[mtype]}); the port builds "
            f"{list(PORTED_MODEL_TYPES)}")
    if mtype not in PORTED_MODEL_TYPES:
        raise NotImplementedError(
            f"unknown model type {mtype!r}; known: "
            f"{sorted((*PORTED_MODEL_TYPES, *NOT_PORTED))}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    common = dict(dropout=cfg.get("dropout", 0.0),
                  pedestrian_only=cfg.get("pedestrian_only", False),
                  remat=cfg.get("remat", False), generator=generator)
    if mtype == "drow":
        return Drow(**common).eval()
    kw = dict(common, alpha=cfg.get("alpha", 0.5),
              window_size=cfg.get("window_size", 7),
              num_cutout_pts=num_cutout_pts)
    if mtype == "flow_drow":
        model = FlowDrow(freeze_detector=cfg.get("freeze_detector", True),
                         **kw)
    else:
        model = SpatialDrow(**kw)
    return model.eval()
