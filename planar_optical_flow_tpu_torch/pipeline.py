"""Pipeline facade: config tree -> (model, task, datasets, trainer).

Counterpart of ``planar_optical_flow_tpu/pipeline.py``:
:func:`normalize_config` turns a flat DROW-style config (``dr_spaam.yaml``:
``epochs / batch_size / num_scans / network / cutout_kwargs /
similarity_kwargs / ...``) into the nested pipeline config (``dataset /
dataloader / model / pipeline.{Trainer,Optim,Logger}``); a nested one is
returned as it is. :class:`Pipeline` builds the model, the datasets
(``FlowScanPairDataset`` for the flow U-Net types, ``DrowDetectionDataset``
for the DROW family, ``JrdbBoxRegressionDataset`` for ``box_reg``), the
task, the optimizer and the trainer from it, on
``device`` (default ``"cuda"``; it raises without a card, ``device="cpu"``
runs the plain versions of the kernels), and trains, evaluates and
checkpoints.

The fc types (``network: fc1d``, ``fc1d_fea``, ``fc2d``) train a
:class:`PolarGridDetector` on ``DetectionTask``'s encoding of that name
(the polar grid from ``polar_grid_kwargs``), its embedding as wide as the
dataset's stack makes it (``models.fc_in_features_of``).
``pipeline.mesh`` (``{dcn, data, model, pipe}`` sizes, ``-1``/``"auto"``
on one of them, ``strict``) builds the trainer's mesh as JAX's
``pipeline.py:264-366`` does; without it the mesh is ``data`` over the
world of a ``torch.distributed.run`` launch, and none for one process. A
mesh that cannot be built, or whose data extent (``data`` x microbatches
on a ``pipe`` mesh) does not divide the batch, falls back to no mesh with a
warning (an error under ``strict``); an unknown axis, a mesh that is not a
mapping, and ``dcn`` with ``pipe`` raise. With a ``model`` axis the state
is split by ``parallel.state_shardings``. The loaders of a data mesh
without ``pipe`` read each rank's rows only; rank 0 logs and writes
checkpoints into the run directory of its stamp, which every rank shares.
"""

from __future__ import annotations

import os


def normalize_config(cfg: dict) -> dict:
    """Flat DROW-style config -> nested pipeline config."""
    if "pipeline" in cfg:
        return cfg
    model_type = cfg.get("model_type")
    if model_type is None:
        net = cfg.get("network", "cutout_spatial")
        model_type = {
            "cutout": "drow",
            "cutout_gating": "dr-spaam",
            "cutout_spatial": "flow_drow" if cfg.get("with_flow", True)
            else "dr-spaam",
            "fc1d": "fc1d",
            "fc1d_fea": "fc1d_fea",
            "fc2d": "fc2d",
        }.get(net, "dr-spaam")
    sim = cfg.get("similarity_kwargs", {})
    return {
        "name": cfg.get("name", "run"),
        "workload": cfg.get("workload", "detection"),
        "dataset": {
            "data_dir": cfg.get("data_dir", "./data/DROWv2-data"),
            "num_scans": cfg.get("num_scans", 5),
            "pedestrian_only": cfg.get("pedestrian_only", False),
            "train_with_val": cfg.get("train_with_val", False),
            "use_augmentation": cfg.get("use_data_augumentation", False),
            "cutout_kwargs": cfg.get("cutout_kwargs", {}),
            "polar_grid_kwargs": cfg.get("polar_grid_kwargs", {}),
        },
        "dataloader": {
            "batch_size": cfg.get("batch_size", 8),
            "num_workers": cfg.get("num_workers", 0),
        },
        "model": {
            "type": model_type,
            "dropout": cfg.get("dropout", 0.0),
            "alpha": sim.get("alpha", 0.5),
            "window_size": sim.get("window_size", 7),
            "pedestrian_only": cfg.get("pedestrian_only", False),
            "focal_loss_gamma": cfg.get("focal_loss_gamma", 0.0),
            "fused_frozen_detector": cfg.get("fused_frozen_detector",
                                             False),
        },
        "pipeline": {
            "Trainer": {
                "grad_norm_clip": cfg.get("grad_norm_clip", 0.0),
                "ckpt_interval": cfg.get("ckpt_interval", 5),
                "eval_interval": cfg.get("eval_interval", 5),
                "epoch": cfg.get("epochs", 1),
                "compute_dtype": cfg.get("compute_dtype"),
                "conv_impl": cfg.get("conv_impl"),
                "pp_microbatches": cfg.get("pp_microbatches"),
            },
            "mesh": cfg.get("mesh"),
            "Optim": {
                "scheduler_kwargs": cfg.get(
                    "scheduler_kwargs",
                    {"epoch0": 0, "lr0": 1e-3,
                     "epoch1": cfg.get("epochs", 1), "lr1": 1e-6},
                ),
            },
            "Logger": {
                "log_dir": cfg.get("log_dir", "./logs"),
                "tag": cfg.get("name", cfg.get("tag", "run")) or "run",
                "log_fname": "log.txt",
                "backup_list": [],
            },
        },
    }


def _build_task(cfg: dict, model=None, num_pts: int | None = None):
    """The task of ``cfg["model"]["type"]``; ``num_pts`` is the beam count
    of the corpus loaded (the detection tasks' beam geometry)."""
    from planar_optical_flow_tpu_torch.models import (
        FC_MODEL_TYPES,
        FLOW_MODEL_TYPES,
    )
    from planar_optical_flow_tpu_torch.train import tasks

    mtype = cfg["model"]["type"]
    ds = cfg["dataset"]
    if mtype in FLOW_MODEL_TYPES:
        return tasks.FlowUNetTask()
    if mtype == "box_reg":
        return tasks.BoxRegressionTask(is_3d=ds.get("is_3d", True))
    common = dict(
        cutout_kwargs=ds.get("cutout_kwargs", {}),
        focal_loss_gamma=cfg["model"].get("focal_loss_gamma", 0.0),
        pedestrian_only=cfg["model"].get("pedestrian_only", False),
    )
    if num_pts is not None:
        common["num_pts"] = int(num_pts)
    if mtype in FC_MODEL_TYPES:
        return tasks.DetectionTask(
            **common, encoding=mtype,
            polar_grid_kwargs=ds.get("polar_grid_kwargs", {}))
    if mtype == "flow_drow":
        if cfg["model"].get("fused_frozen_detector"):
            # the frozen detector on the serving kernels in the step
            return tasks.FlowDrowFusedTask.for_model(model, **common)
        return tasks.FlowDrowTask(**common)
    return tasks.DetectionTask(**common)


def _build_datasets(cfg: dict, synthetic_dir: str | None = None,
                    device="cuda"):
    """(train, val or None): scan-pair flow datasets for the flow U-Net
    types, JRDB box-regression datasets for ``box_reg`` (the config's
    ``dataset`` section is their config), else DROW detection datasets,
    whose targets are computed on ``device``."""
    from planar_optical_flow_tpu_torch.data import (
        DrowDetectionDataset,
        FlowScanPairDataset,
    )
    from planar_optical_flow_tpu_torch.data.jrdb import (
        JrdbBoxRegressionDataset,
    )
    from planar_optical_flow_tpu_torch.models import FLOW_MODEL_TYPES

    ds = cfg["dataset"]
    data_dir = synthetic_dir or ds["data_dir"]
    if cfg["model"]["type"] in FLOW_MODEL_TYPES:
        train = FlowScanPairDataset(
            data_dir, "train", train_with_val=ds.get("train_with_val", False))
        try:
            val = FlowScanPairDataset(data_dir, "val")
        except FileNotFoundError:
            val = None
        return train, val
    if cfg["model"]["type"] == "box_reg":
        jrdb_cfg = {**ds, "data_dir": data_dir}
        train = JrdbBoxRegressionDataset("train", jrdb_cfg)
        try:
            val = JrdbBoxRegressionDataset("val", jrdb_cfg)
        except FileNotFoundError:
            val = None
        return train, val
    kwargs = dict(num_scans=ds.get("num_scans", 5),
                  pedestrian_only=ds.get("pedestrian_only", False),
                  use_augmentation=ds.get("use_augmentation", False),
                  device=device)
    train = DrowDetectionDataset(
        data_dir, "train", train_with_val=ds.get("train_with_val", False),
        **kwargs)
    try:
        val = DrowDetectionDataset(data_dir, "val", **kwargs)
    except FileNotFoundError:
        val = None
    return train, val


def _rank_logger_cfg(logger_cfg: dict) -> dict:
    """The logger config of this rank: under ``torch.distributed`` every
    rank takes rank 0's stamp, so they share one run directory, and the
    other ranks write only their own log file there."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return logger_cfg
    import time

    stamp = [time.strftime("%Y%m%d_%H%M%S", time.gmtime())]
    dist.broadcast_object_list(stamp, src=0)
    cfg = dict(logger_cfg, stamp=stamp[0])
    rank = dist.get_rank()
    if rank:
        cfg.update(console=False, tensorboard=False, wandb=False,
                   log_fname=f"log_rank{rank}.txt")
    return cfg


class Pipeline:
    def __init__(self, cfg: dict, synthetic_dir: str | None = None,
                 use_mesh: bool = True, install_signal_handlers: bool = True,
                 device="cuda"):
        from planar_optical_flow_tpu_torch import resolve_device
        from planar_optical_flow_tpu_torch.data.loader import BatchLoader
        from planar_optical_flow_tpu_torch.models import (
            fc_in_features_of,
            get_model,
            num_cutout_pts_of,
        )
        from planar_optical_flow_tpu_torch.train import (
            Trainer,
            create_train_state,
            exp_decay_schedule,
            make_optimizer,
        )
        from planar_optical_flow_tpu_torch.utils.logger import RunLogger

        cfg = normalize_config(cfg)
        self.cfg = cfg
        pcfg = cfg["pipeline"]
        mesh_cfg = pcfg.get("mesh")
        if mesh_cfg is not None and not isinstance(mesh_cfg, dict):
            raise TypeError(
                f"pipeline.mesh must be a mapping of axis sizes, got "
                f"{type(mesh_cfg).__name__}: {mesh_cfg!r}")
        self.device = resolve_device(device)
        self.logger = RunLogger(_rank_logger_cfg(pcfg["Logger"]))
        self.model = get_model(
            cfg["model"], num_cutout_pts_of(cfg),
            in_features=fc_in_features_of(cfg)).to(self.device)
        self.train_set, self.val_set = _build_datasets(cfg, synthetic_dir,
                                                       self.device)
        # the beam count comes from the corpus (the scan datasets')
        phi_grid = getattr(self.train_set, "phi_grid", None)
        num_pts = None if phi_grid is None else len(phi_grid)
        self.task = _build_task(cfg, self.model, num_pts=num_pts)

        bsz = cfg["dataloader"]["batch_size"]
        mesh, sharding_fn = (self._build_mesh(pcfg, bsz) if use_mesh
                             else (None, None))
        self.mesh = mesh
        # a data mesh without pipe: each rank reads its rows only
        split = (mesh is not None and mesh.multi_process
                 and mesh.axis_size("pipe") == 1 and mesh.data_extent > 1)
        part = (dict(process_index=mesh.data_index,
                     process_count=mesh.data_extent) if split else {})
        self.train_loader = BatchLoader(self.train_set, bsz, shuffle=True,
                                        **part)
        self.val_loader = (
            BatchLoader(self.val_set, bsz, shuffle=False, **part)
            if self.val_set is not None and len(self.val_set) >= bsz
            else None)

        steps_per_epoch = max(len(self.train_loader), 1)
        optim_cfg = dict(pcfg["Optim"])
        optim_cfg.setdefault("grad_norm_clip",
                             pcfg["Trainer"].get("grad_norm_clip", 0.0))
        self.tx = make_optimizer(optim_cfg, steps_per_epoch)
        sk = optim_cfg.get("scheduler_kwargs", {})
        schedule = exp_decay_schedule(
            sk.get("epoch0", 0), sk.get("lr0", 1e-3), sk.get("epoch1", 100),
            sk.get("lr1", 1e-6), steps_per_epoch)
        self.state = create_train_state(self.model, self.tx)

        # FlowDROW: graft a detection run's checkpoint into the frozen
        # dr_spaam submodule
        pretrained = cfg["model"].get("pretrained_detector")
        if pretrained and cfg["model"]["type"] == "flow_drow":
            self.load_pretrained_detector(pretrained)
        self.trainer = Trainer(
            self.logger, pcfg["Trainer"], self.task, lr_schedule=schedule,
            mesh=mesh, state_sharding_fn=sharding_fn,
            install_signal_handlers=install_signal_handlers,
            device=self.device)

    def _build_mesh(self, pcfg: dict, bsz: int):
        """(mesh or None, state sharding fn or None) of ``pipeline.mesh``,
        with JAX's rules: a request is never dropped silently."""
        import torch.distributed as dist

        from planar_optical_flow_tpu_torch.parallel import (
            make_mesh_from_config,
            state_shardings,
        )
        from planar_optical_flow_tpu_torch.parallel.mesh import AXES

        mesh_cfg = pcfg.get("mesh")
        strict = False
        if mesh_cfg:
            mesh_cfg = dict(mesh_cfg)
            strict = bool(mesh_cfg.pop("strict", False))
            unknown = set(mesh_cfg) - set(AXES)
            if unknown:
                raise ValueError(
                    f"unknown mesh axis {sorted(unknown)} in pipeline.mesh "
                    "— valid axes: dcn, data, model, pipe (plus strict: "
                    "true/false)")
        elif not (dist.is_available() and dist.is_initialized()):
            return None, None  # one process: no mesh

        def fallback(reason):
            if strict:
                raise ValueError(
                    f"pipeline.mesh {mesh_cfg} unusable: {reason} (strict: "
                    "true — remove it to allow the single-device fallback)")
            if mesh_cfg:
                self.logger.warning(
                    f"pipeline.mesh {mesh_cfg} dropped — {reason}; falling "
                    "back to single-device training")
            return None

        try:
            mesh = make_mesh_from_config(mesh_cfg)
        except ValueError as e:
            mesh = fallback(f"mesh construction failed: {e}")
        sharding_fn = None
        if mesh is not None:
            shape = mesh.shape
            if shape.get("pipe", 1) > 1 and shape.get("dcn", 1) > 1:
                raise ValueError(
                    f"pipeline.mesh {mesh_cfg}: a dcn axis cannot combine "
                    "with a pipe axis (the pipeline wavefront does not span "
                    "DCN; each dcn group would redundantly compute the same "
                    "schedule) — use {dcn, data[, model]} or {data, pipe}")
            if shape.get("pipe", 1) > 1:
                micro = int(pcfg["Trainer"].get("pp_microbatches")
                            or shape["pipe"])
                rows = shape.get("data", 1) * max(micro, 1)
                if bsz % max(rows, 1) != 0:
                    mesh = fallback(
                        f"batch_size {bsz} does not divide into data="
                        f"{shape.get('data', 1)} x {micro} microbatches")
            else:
                # a model-only mesh keeps the whole batch on every rank
                data_size = mesh.data_extent
                if bsz % max(data_size, 1) != 0:
                    mesh = fallback(
                        f"batch_size {bsz} not divisible by the "
                        f"data-parallel extent {data_size}")
                if mesh is not None and shape.get("model", 1) > 1:
                    sharding_fn = state_shardings
        return mesh, sharding_fn

    # ------------------------------------------------------------- control

    def train(self) -> int:
        self.state, rc = self.trainer.train(self.state, self.train_loader,
                                            self.val_loader)
        return rc

    def evaluate(self, loader=None, tb_prefix="TEST") -> dict:
        loader = loader or self.val_loader or self.train_loader
        return self.trainer.evaluate(self.state, loader, tb_prefix=tb_prefix)

    def load_ckpt(self, path: str):
        from planar_optical_flow_tpu_torch.train import checkpoint

        self.state = checkpoint.restore_checkpoint(path, self.state)

    def save_ckpt(self, name: str = "ckpt_final") -> str:
        from planar_optical_flow_tpu_torch.train import checkpoint

        return checkpoint.save_checkpoint(
            os.path.join(self.logger.ckpt_dir, name), self.state)

    def load_pretrained_detector(self, ckpt_path: str):
        """Graft a SpatialDrow checkpoint (a detection run's) into this
        FlowDrow state's frozen ``dr_spaam`` submodule."""
        from planar_optical_flow_tpu_torch.train import checkpoint
        from planar_optical_flow_tpu_torch.train.state import (
            load_pretrained_subtree,
        )

        tree = checkpoint.load_checkpoint_tree(ckpt_path)
        self.state = load_pretrained_subtree(
            self.state, "dr_spaam", tree["params"], tree["batch_stats"])
        self.logger.info(f"grafted pre-trained detector from {ckpt_path}")

    def sigterm_ckpt_exists(self) -> bool:
        return os.path.isdir(self.logger.sigterm_ckpt)

    def load_sigterm_ckpt(self):
        self.load_ckpt(self.logger.sigterm_ckpt)
