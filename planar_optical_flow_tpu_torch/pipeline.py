"""Pipeline facade: config tree -> (model, task, datasets, trainer).

Counterpart of ``planar_optical_flow_tpu/pipeline.py``:
:func:`normalize_config` turns a flat DROW-style config (``dr_spaam.yaml``:
``epochs / batch_size / num_scans / network / cutout_kwargs /
similarity_kwargs / ...``) into the nested pipeline config (``dataset /
dataloader / model / pipeline.{Trainer,Optim,Logger}``); a nested one is
returned as it is. :class:`Pipeline` builds the model, the DROW datasets,
the task, the optimizer and the trainer from it, on ``device`` (default
``"cuda"``; it raises without a card, ``device="cpu"`` runs the plain
versions of the kernels), and trains, evaluates and checkpoints.

The DROW family only: the other model types raise in the registry, naming
their ROADMAP item. ``pipeline.mesh`` raises, naming item 20.
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
    from planar_optical_flow_tpu_torch.train import tasks

    mtype = cfg["model"]["type"]
    ds = cfg["dataset"]
    common = dict(
        cutout_kwargs=ds.get("cutout_kwargs", {}),
        focal_loss_gamma=cfg["model"].get("focal_loss_gamma", 0.0),
        pedestrian_only=cfg["model"].get("pedestrian_only", False),
    )
    if num_pts is not None:
        common["num_pts"] = int(num_pts)
    if mtype == "flow_drow":
        if cfg["model"].get("fused_frozen_detector"):
            # the frozen detector on the serving kernels in the step
            return tasks.FlowDrowFusedTask.for_model(model, **common)
        return tasks.FlowDrowTask(**common)
    return tasks.DetectionTask(**common)


def _build_datasets(cfg: dict, synthetic_dir: str | None = None,
                    device="cuda"):
    """(train, val or None) DROW detection datasets (the registry builds
    only DROW types); their targets are computed on ``device``."""
    from planar_optical_flow_tpu_torch.data import DrowDetectionDataset

    ds = cfg["dataset"]
    data_dir = synthetic_dir or ds["data_dir"]
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


class Pipeline:
    def __init__(self, cfg: dict, synthetic_dir: str | None = None,
                 use_mesh: bool = True, install_signal_handlers: bool = True,
                 device="cuda"):
        from planar_optical_flow_tpu_torch import resolve_device
        from planar_optical_flow_tpu_torch.data.loader import BatchLoader
        from planar_optical_flow_tpu_torch.models import (
            get_model,
            num_cutout_pts_of,
        )
        from planar_optical_flow_tpu_torch.train import (
            Trainer,
            create_train_state,
            exp_decay_schedule,
            make_optimizer,
        )
        from planar_optical_flow_tpu_torch.train.trainer import no_mesh
        from planar_optical_flow_tpu_torch.utils.logger import RunLogger

        cfg = normalize_config(cfg)
        self.cfg = cfg
        pcfg = cfg["pipeline"]
        mesh_cfg = pcfg.get("mesh")
        if mesh_cfg is not None and not isinstance(mesh_cfg, dict):
            raise TypeError(
                f"pipeline.mesh must be a mapping of axis sizes, got "
                f"{type(mesh_cfg).__name__}: {mesh_cfg!r}")
        if use_mesh and mesh_cfg:
            raise no_mesh(f"pipeline.mesh {mesh_cfg}")
        self.device = resolve_device(device)
        self.logger = RunLogger(pcfg["Logger"])
        self.model = get_model(cfg["model"], num_cutout_pts_of(cfg)).to(
            self.device)
        self.train_set, self.val_set = _build_datasets(cfg, synthetic_dir,
                                                       self.device)
        # the beam count comes from the corpus
        num_pts = len(self.train_set.phi_grid)
        self.task = _build_task(cfg, self.model, num_pts=num_pts)

        bsz = cfg["dataloader"]["batch_size"]
        self.train_loader = BatchLoader(self.train_set, bsz, shuffle=True)
        self.val_loader = (
            BatchLoader(self.val_set, bsz, shuffle=False)
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
            install_signal_handlers=install_signal_handlers,
            device=self.device)

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
