"""Run logger: timestamped run directories, python logging, scalar streams,
result dumps.

Counterpart of ``planar_optical_flow_tpu/utils/logger.py`` ``RunLogger``,
with its layout: a ``{log_dir}/{timestamp}_{tag}/`` run directory with
``backup/ output/ image/ ckpt/ tb/``, the config backup, info logging to a
file and the console, json + pickle result dicts, and the preemption
checkpoint path ``{log_dir}/sigterm_ckpt_{tag}`` outside the run directory,
where a relaunched process finds it.

Scalars always go to an append-only ``tb/scalars.jsonl``; a TensorBoard
event stream is written too where ``torch.utils.tensorboard`` imports, and
wandb behind the same guard when the config asks for it.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import time

import numpy as np
from shutil import copyfile


class RunLogger:
    def __init__(self, cfg: dict):
        log_dir = os.path.abspath(os.path.expanduser(cfg["log_dir"]))
        tag = cfg.get("tag", "run")
        stamp = cfg.get("stamp") or time.strftime("%Y%m%d_%H%M%S",
                                                  time.gmtime())
        self.run_dir = os.path.join(log_dir, f"{stamp}_{tag}")

        self.backup_dir = os.path.join(self.run_dir, "backup")
        self.output_dir = os.path.join(self.run_dir, "output")
        self.image_dir = os.path.join(self.run_dir, "image")
        self.ckpt_dir = os.path.join(self.run_dir, "ckpt")
        self.tb_dir = os.path.join(self.run_dir, "tb")
        for d in (self.run_dir, self.backup_dir, self.output_dir,
                  self.image_dir, self.ckpt_dir, self.tb_dir):
            os.makedirs(d, exist_ok=True)

        # the preemption checkpoint lives OUTSIDE the timestamped run dir so
        # a relaunched process can find it (logger.py:66-68 semantics)
        self.sigterm_ckpt = os.path.join(log_dir, f"sigterm_ckpt_{tag}")

        self._log = logging.getLogger(f"pof.{tag}.{stamp}")
        self._log.setLevel(logging.DEBUG)
        self._log.propagate = False
        fmt = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
        fh = logging.FileHandler(
            os.path.join(self.run_dir, cfg.get("log_fname", "log.txt"))
        )
        fh.setFormatter(fmt)
        self._log.addHandler(fh)
        if cfg.get("console", True):
            ch = logging.StreamHandler()
            ch.setFormatter(fmt)
            self._log.addHandler(ch)

        for f in cfg.get("backup_list", []):
            try:
                copyfile(os.path.abspath(f),
                         os.path.join(self.backup_dir, os.path.basename(f)))
                self.debug(f"backed up {f}")
            except OSError as e:
                self.warning(f"backup of {f} failed: {e}")

        self._scalars = open(os.path.join(self.tb_dir, "scalars.jsonl"), "a")
        self._tb = None
        if cfg.get("tensorboard", True):
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=self.tb_dir)
            except Exception:
                self._tb = None
        if cfg.get("wandb", False):
            try:
                import wandb

                wandb.init(project=cfg.get("wandb_project", "pof_tpu"),
                           name=tag, sync_tensorboard=True)
            except Exception as e:
                self.warning(f"wandb unavailable: {e}")

        self.info(f"run dir: {self.run_dir}")

    # ----------------------------------------------------------- text log

    def info(self, msg):
        self._log.info(msg)

    def warning(self, msg):
        self._log.warning(msg)

    def debug(self, msg):
        self._log.debug(msg)

    # ------------------------------------------------------------ scalars

    def add_scalar(self, key: str, value, step: int):
        self._scalars.write(
            json.dumps({"key": key, "value": float(value), "step": int(step)})
            + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(key, float(value), int(step))

    def flush(self):
        self._scalars.flush()
        if self._tb is not None:
            self._tb.flush()

    # ------------------------------------------------------------ results

    def save_dict(self, name: str, d: dict):
        """json for scalar items + pickle for everything
        (logger.py:129-146 semantics)."""
        scalars = {
            k: str(v)
            for k, v in d.items()
            if not isinstance(v, (list, tuple, dict)) and not hasattr(v, "shape")
        }
        with open(os.path.join(self.output_dir, f"{name}.json"), "w") as f:
            json.dump(scalars, f, sort_keys=True, indent=4)
        with open(os.path.join(self.output_dir, f"{name}.pkl"), "wb") as f:
            pickle.dump(d, f, protocol=pickle.HIGHEST_PROTOCOL)

    def save_fig(self, fig, fname: str, close: bool = False):
        import matplotlib.pyplot as plt

        fig.savefig(os.path.join(self.image_dir, fname))
        if close:
            plt.close(fig)

    # ------------------------------------------------------------- images

    def add_fig(self, key: str, fig, step: int, close_fig: bool = False):
        """Render a matplotlib figure into the TB event stream (reference
        ``Logger.add_fig``, ``src/pipeline/logger.py:107-117``). Also saved
        as a PNG next to the run (TB is optional here)."""
        import matplotlib.pyplot as plt

        fig.canvas.draw()
        im = np.asarray(fig.canvas.buffer_rgba())[..., :3]  # (H, W, 3)
        im = im.transpose(2, 0, 1).astype(np.float32) / 255.0  # (3, H, W)
        self.add_im(key, im, step)
        fig.savefig(os.path.join(
            self.image_dir, f"{key.replace('/', '_')}_{step}.png"
        ))
        if close_fig:
            plt.close(fig)

    def add_im(self, key: str, im, step: int):
        """Add a (3, H, W) float image to TensorBoard (reference
        ``Logger.add_im``, ``src/pipeline/logger.py:119-123``); no-op
        without a TB writer."""
        if self._tb is not None:
            self._tb.add_image(key, np.asarray(im), int(step))

    def close(self):
        self.flush()
        self._scalars.close()
        if self._tb is not None:
            self._tb.close()
        for h in list(self._log.handlers):
            h.close()
            self._log.removeHandler(h)
