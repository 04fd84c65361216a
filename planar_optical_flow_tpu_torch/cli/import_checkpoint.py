"""Import a reference PyTorch checkpoint (``.pth``) into the port, the
counterpart of ``bin/import_checkpoint.py``:

    python -m planar_optical_flow_tpu_torch.cli.import_checkpoint \\
        --pth dr_spaam_e40.pth --cfg configs/dr_spaam.yaml --out ckpt_imported

Reads the reference envelope (``{"epoch", "it"|"step", "model_state",
...}``) or a bare ``state_dict``, maps it onto the port model the config
describes (``interop.torch_ckpt``) and writes a port training checkpoint
(``train.checkpoint.save_checkpoint``: ``weights.pt`` and
``train_state.pt``) that carries the envelope's epoch and step, with a
fresh optimizer state. ``cli.infer --ckpt``, ``cli.evaluate --ckpt``,
``cli.export_serving --ckpt`` and ``cli.train`` read it. For ``flow_drow``
the checkpoint may be a whole ``FlowDROW_pretrained`` (the detector
imported, the reference flow head skipped) or a pre-trained SpatialDROW
detector (grafted into ``dr_spaam``). Runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m planar_optical_flow_tpu_torch.cli.import_checkpoint")
    parser.add_argument("--pth", required=True,
                        help="reference .pth checkpoint (envelope or bare "
                             "state_dict)")
    parser.add_argument("--cfg", required=True,
                        help="config of the target model (its widths must "
                             "match the checkpoint's)")
    parser.add_argument("--out", required=True,
                        help="the port training checkpoint directory")
    parser.add_argument("--cpu", action="store_true",
                        help="accepted for parity with the other CLIs (the "
                             "import runs on the CPU)")
    args = parser.parse_args(argv)

    from planar_optical_flow_tpu_torch.interop.torch_ckpt import (
        import_torch_checkpoint,
    )
    from planar_optical_flow_tpu_torch.models import (
        get_model,
        num_cutout_pts_of,
    )
    from planar_optical_flow_tpu_torch.pipeline import normalize_config
    from planar_optical_flow_tpu_torch.train import (
        create_train_state,
        make_optimizer,
    )
    from planar_optical_flow_tpu_torch.train.checkpoint import (
        save_checkpoint,
    )
    from planar_optical_flow_tpu_torch.utils.config import load_config

    cfg = normalize_config(load_config(args.cfg))
    model_type = cfg["model"]["type"]
    model = get_model(cfg["model"], num_cutout_pts_of(cfg))
    state_dict, meta = import_torch_checkpoint(args.pth, model, model_type)
    model.load_state_dict(state_dict, strict=True)
    state = create_train_state(model, make_optimizer(
        dict(cfg["pipeline"].get("Optim", {})), steps_per_epoch=1))
    state.epoch, state.step = meta["epoch"], meta["step"]
    path = save_checkpoint(args.out, state)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"imported {args.pth} (model {model_type!r}, epoch {meta['epoch']}"
          f", step {meta['step']}, {n_params:,} params) -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
