"""Config normalisation of the pipeline facade.

Counterpart of ``planar_optical_flow_tpu/pipeline.py:35 normalize_config``:
a flat DROW-style config (``dr_spaam.yaml``: ``epochs / batch_size /
num_scans / network / cutout_kwargs / similarity_kwargs / ...``) becomes the
nested pipeline config (``dataset / dataloader / model /
pipeline.{Trainer,Optim,Logger}``); a nested one is returned as it is. The
facade itself (``Pipeline``) needs the port's training and is not here yet.
"""

from __future__ import annotations


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
