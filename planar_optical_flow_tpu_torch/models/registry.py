"""Model registry: config dict -> port module.

Counterpart of ``planar_optical_flow_tpu/models/registry.py``; it builds
every type of the JAX registry: the streaming types the serving engines
run, ``"flow_drow"`` -> :class:`FlowDrow` and ``"dr-spaam"``/
``"spatial_drow"`` -> :class:`SpatialDrow`, ``"drow"`` -> :class:`Drow`,
the fc detectors ``"fc1d"``/``"fc1d_fea"``/``"fc2d"`` ->
:class:`PolarGridDetector` (``hidden``, ``dropout``), the flow types
``"flow_unet"``/``"prototype"`` -> :class:`FlowUNet` (``in_channels``,
``max_displacement``, ``linear_head``) and ``"prototype_test"`` ->
:class:`FlowUNetAdditive`, and ``"box_reg"`` ->
:class:`BoundingBoxRegressor` (``input_dim``, ``target_dim``,
``dropout``). The DROW training keys ``dropout``, ``remat``,
``freeze_detector`` and ``banded_chunk`` (the block-banded gate) are
passed on.

The flax modules infer their input widths from their first input; the
port's are built with them: the gate's from ``num_cutout_pts`` (the
config's ``dataset.cutout_kwargs.num_cutout_pts``, default 48, as
``bin/infer.py`` reads it: :func:`num_cutout_pts_of`), and the fc
detectors' embedding from ``in_features`` (``(num_scans + 1) * R``, as
JAX's ``pipeline._example_inputs`` shapes the input:
:func:`fc_in_features_of`).
"""

from __future__ import annotations

import torch

from planar_optical_flow_tpu_torch.models.drow import Drow
from planar_optical_flow_tpu_torch.models.flow_drow import FlowDrow
from planar_optical_flow_tpu_torch.models.flow_unet import (
    FlowUNet,
    FlowUNetAdditive,
)
from planar_optical_flow_tpu_torch.models.pointnet import BoundingBoxRegressor
from planar_optical_flow_tpu_torch.models.polar_grid_net import (
    PolarGridDetector,
)
from planar_optical_flow_tpu_torch.models.spatial_drow import SpatialDrow
from planar_optical_flow_tpu_torch.ops.polar_grid import num_range_bins

# model types whose forward carries template state across scans: these
# serve through the streaming engines
STREAMING_MODEL_TYPES = ("flow_drow", "dr-spaam", "spatial_drow")
DROW_MODEL_TYPES = (*STREAMING_MODEL_TYPES, "drow")
# the scan-pair flow nets: stateless, trained on FlowScanPairDataset
FLOW_MODEL_TYPES = ("flow_unet", "prototype", "prototype_test")
# the fc detectors (PolarGridDetector) and their DetectionTask encodings
FC_MODEL_TYPES = ("fc1d", "fc1d_fea", "fc2d")
PORTED_MODEL_TYPES = (*DROW_MODEL_TYPES, *FC_MODEL_TYPES, *FLOW_MODEL_TYPES,
                      "box_reg")


def num_cutout_pts_of(cfg: dict) -> int:
    """Cutout points of a nested pipeline config (default 48)."""
    return cfg.get("dataset", {}).get("cutout_kwargs", {}).get(
        "num_cutout_pts", 48)


def fc_in_features_of(cfg: dict) -> int | None:
    """The fc detector's embedding width ``(num_scans + 1) * R`` of a nested
    pipeline config: ``R`` = 1 for ``fc1d``, the cutout points for
    ``fc1d_fea``, the polar grid's range bins for ``fc2d``. None for the
    other types."""
    mtype = cfg["model"]["type"]
    if mtype not in FC_MODEL_TYPES:
        return None
    ds = cfg.get("dataset", {})
    if mtype == "fc1d":
        r = 1
    elif mtype == "fc1d_fea":
        r = num_cutout_pts_of(cfg)
    else:
        pg = ds.get("polar_grid_kwargs", {})
        r = num_range_bins(pg.get("min_range", 0.0),
                           pg.get("max_range", 30.0),
                           pg.get("range_bin_size", 1.0))
    return (ds.get("num_scans", 5) + 1) * r


def get_model(cfg: dict, num_cutout_pts: int = 48,
              generator: torch.Generator | None = None,
              in_features: int | None = None):
    """Build the module of ``cfg["type"]`` (the ``model`` section of a
    nested config), in eval mode (its forward trains only when called with
    ``train=True``). ``generator`` seeds the initial weights (default: seed
    0); load trained ones with ``load_state_dict``. Only the cutout DROW
    types read ``num_cutout_pts``; the fc types need ``in_features``
    (:func:`fc_in_features_of`)."""
    mtype = cfg["type"]
    if mtype not in PORTED_MODEL_TYPES:
        raise NotImplementedError(
            f"unknown model type {mtype!r}; known: "
            f"{sorted(PORTED_MODEL_TYPES)}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if mtype in FC_MODEL_TYPES:
        if in_features is None:
            raise ValueError(
                f"model type {mtype!r} needs in_features, the width of its "
                "per-beam columns: fc_in_features_of(nested_cfg)")
        return PolarGridDetector(
            in_features,
            num_classes=1 if cfg.get("pedestrian_only", False) else 4,
            hidden=cfg.get("hidden", 256), dropout=cfg.get("dropout", 0.0),
            generator=generator).eval()
    if mtype == "box_reg":
        return BoundingBoxRegressor(input_dim=cfg.get("input_dim", 4),
                                    target_dim=cfg.get("target_dim", 5),
                                    dropout=cfg.get("dropout", 0.3),
                                    generator=generator).eval()
    if mtype == "prototype_test":
        return FlowUNetAdditive(in_channels=cfg.get("in_channels", 2),
                                generator=generator).eval()
    if mtype in FLOW_MODEL_TYPES:
        return FlowUNet(in_channels=cfg.get("in_channels", 2),
                        max_displacement=cfg.get("max_displacement", 5),
                        linear_head=cfg.get("linear_head", False),
                        generator=generator).eval()
    common = dict(dropout=cfg.get("dropout", 0.0),
                  pedestrian_only=cfg.get("pedestrian_only", False),
                  remat=cfg.get("remat", False), generator=generator)
    if mtype == "drow":
        return Drow(**common).eval()
    kw = dict(common, alpha=cfg.get("alpha", 0.5),
              window_size=cfg.get("window_size", 7),
              num_cutout_pts=num_cutout_pts,
              banded_chunk=cfg.get("banded_chunk", 0))
    if mtype == "flow_drow":
        model = FlowDrow(freeze_detector=cfg.get("freeze_detector", True),
                         **kw)
    else:
        model = SpatialDrow(**kw)
    return model.eval()
