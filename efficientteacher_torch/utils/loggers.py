"""Experiment loggers: CSV + TensorBoard + (gated) Weights & Biases
(counterpart of `efficientteacher_tpu/utils/loggers.py`).

Parity with reference utils/loggers/__init__.py:34-158: a Loggers object
whose hook methods are registered onto the Callbacks bus by name
(reference trainer.py:281-289). CSV keeps JAX's fixed 13-key results
schema; TensorBoard goes through `torch.utils.tensorboard` (JAX's goes
through tf.summary) and wandb through its package, each disabled with an
info log when its import fails (the reference's try-import,
loggers/__init__.py:16-24). The trainers register it with TensorBoard
alone, on rank 0, and keep writing their own results.csv, as JAX's do.
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import Dict, Optional

LOGGER = logging.getLogger(__name__)


class Loggers:
    def __init__(self, save_dir: Path, cfg=None, include=("csv", "tb")):
        self.save_dir = Path(save_dir)
        self.write_csv = "csv" in include
        self.csv_path = self.save_dir / "results.csv"
        self.keys = [
            "train/box_loss", "train/obj_loss", "train/cls_loss",
            "metrics/precision", "metrics/recall", "metrics/mAP_0.5",
            "metrics/mAP_0.5:0.95", "val/box_loss", "val/obj_loss",
            "val/cls_loss", "x/lr0", "x/lr1", "x/lr2",
        ]
        self.tb = None
        if "tb" in include:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                LOGGER.info("tensorboard disabled: %s", e)
            else:
                self.tb = SummaryWriter(str(self.save_dir / "tb"))
        self.wandb = None
        self.wandb_artifacts = None
        if "wandb" in include:
            try:
                import wandb

                self.wandb = wandb.init(
                    project=str(self.save_dir.parent.name),
                    dir=str(self.save_dir),
                    config=cfg.to_dict() if cfg is not None else None,
                )
                from .wandb_artifacts import WandbArtifacts

                self.wandb_artifacts = WandbArtifacts(self.wandb)
                # dataset upload behind the reference's upload_dataset knob
                # (wandb_utils.py:196-213 check_and_upload_dataset)
                if cfg is not None and bool(
                        getattr(cfg, "upload_dataset", False)):
                    self.wandb_artifacts.log_dataset_artifact(
                        cfg.Dataset.train, names=list(cfg.Dataset.names))
            except Exception as e:  # pragma: no cover
                LOGGER.info("wandb disabled: %s", e)

    # -- hook methods (registered on Callbacks by name) ---------------------
    def on_fit_epoch_end(self, metrics: Dict[str, float], epoch: int):
        if self.write_csv:
            row = {"epoch": epoch, **metrics}
            new = not self.csv_path.exists()
            with open(self.csv_path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=["epoch"] + self.keys,
                                   extrasaction="ignore")
                if new:
                    w.writeheader()
                w.writerow(row)
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, float(v), epoch)
            self.tb.flush()
        if self.wandb is not None:
            self.wandb.log(metrics, step=epoch)

    def on_train_batch_end(self, metrics: Optional[Dict[str, float]] = None,
                           step: int = 0):
        if self.tb is not None and metrics:
            for k, v in metrics.items():
                self.tb.add_scalar(f"batch/{k}", float(v), step)

    def on_model_save(self, path=None, epoch: int = 0, fitness: float = 0.0,
                      name: str = ""):
        """Checkpoint artifact upload (reference wandb_utils.py:302-325
        log_model; best.ckpt saves also carry the 'best' alias)."""
        if self.wandb_artifacts is not None and path is not None:
            try:
                self.wandb_artifacts.log_model(
                    path, epoch, fitness, best=(name == "best.ckpt"))
            except Exception as e:  # pragma: no cover
                LOGGER.debug("wandb model artifact skipped: %s", e)

    def on_train_end(self):
        if self.tb is not None:
            self.tb.close()
        if self.wandb_artifacts is not None:
            # async ckpt writer is joined by now — final guaranteed upload
            try:
                last = self.save_dir / "weights" / "last.ckpt"
                if last.exists():
                    self.wandb_artifacts.log_model(last, -1, 0.0,
                                                   wait_s=0.0)
            except Exception as e:  # pragma: no cover
                LOGGER.debug("wandb final artifact skipped: %s", e)
        if self.wandb is not None:
            self.wandb.finish()

    def register(self, callbacks):
        """Attach hook methods to a Callbacks bus (reference trainer.py:281)."""
        for hook in ("on_fit_epoch_end", "on_train_batch_end",
                     "on_model_save", "on_train_end"):
            callbacks.register_action(hook, name=f"loggers/{hook}",
                                      callback=getattr(self, hook))
