"""Model registry: config dict -> port module (eval mode).

Counterpart of ``planar_optical_flow_tpu/models/registry.py`` for the
streaming types, the ones the serving engines run: ``"flow_drow"`` ->
:class:`FlowDrow`, ``"dr-spaam"`` and ``"spatial_drow"`` ->
:class:`SpatialDrow`. The keys that change only training (``dropout``,
``remat``, ``banded_chunk``, ``freeze_detector``) are accepted and do not
change the module, which computes the eval-mode function.

The flax modules infer the gate's feature width from their first input;
the port's are built with it, from ``num_cutout_pts`` (the config's
``dataset.cutout_kwargs.num_cutout_pts``, default 48, as ``bin/infer.py``
reads it: :func:`num_cutout_pts_of`).

Every other type of the JAX registry raises ``NotImplementedError`` naming
the ``ROADMAP.md`` item that ports it.
"""

from __future__ import annotations

import torch

from planar_optical_flow_tpu_torch.models.flow_drow import FlowDrow
from planar_optical_flow_tpu_torch.models.spatial_drow import SpatialDrow

# model types whose forward carries template state across scans: these
# serve through the streaming engines
STREAMING_MODEL_TYPES = ("flow_drow", "dr-spaam", "spatial_drow")

# the JAX registry's other types -> the ROADMAP.md item that ports them
NOT_PORTED = {
    "drow": "11b",
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
    """Build the eval-mode module of ``cfg["type"]`` (the ``model`` section
    of a nested config). ``generator`` seeds the initial weights (default:
    seed 0); load trained ones with ``load_state_dict``."""
    mtype = cfg["type"]
    if mtype in NOT_PORTED:
        raise NotImplementedError(
            f"model type {mtype!r} is not ported yet (ROADMAP.md queue 1 "
            f"item {NOT_PORTED[mtype]}); the port serves "
            f"{list(STREAMING_MODEL_TYPES)}")
    if mtype not in STREAMING_MODEL_TYPES:
        raise NotImplementedError(
            f"unknown model type {mtype!r}; known: "
            f"{sorted((*STREAMING_MODEL_TYPES, *NOT_PORTED))}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    kw = dict(alpha=cfg.get("alpha", 0.5),
              window_size=cfg.get("window_size", 7),
              pedestrian_only=cfg.get("pedestrian_only", False),
              num_cutout_pts=num_cutout_pts, generator=generator)
    model = FlowDrow(**kw) if mtype == "flow_drow" else SpatialDrow(**kw)
    return model.eval()
