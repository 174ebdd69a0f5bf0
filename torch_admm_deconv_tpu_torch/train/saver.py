"""Checkpoint saver with save-each / save-best-so-far semantics.

Counterpart of torch_admm_deconv_tpu/train/saver.py (:29-118): checkpoints
land at ``<save_dir>/<model>/<timestamp>/<model>_epoch{E:02d}_vloss{V:.4f}.tar``
and hold ``{epoch, model_state_dict, optimizer_state_dict, loss}`` written by
``torch.save``, the original reference's own format. ``Best`` mode saves
only when the loss is strictly lower than every previous loss; a non-finite
loss is never best and never recorded. The per-epoch metric log goes to
``logged_metrics.csv`` next to the checkpoints.
"""

from __future__ import annotations

import csv
import enum
import math
import time
from pathlib import Path
from typing import Dict, Optional

import torch


def get_time_formated() -> str:
    return time.ctime().replace(":", "_").replace(" ", "-")


def get_saving_model_path(save_path, model_name: str, save_time: Optional[str] = None) -> Path:
    if save_time is not None:
        save_dir = Path(save_path) / model_name / save_time
    else:
        save_dir = Path(save_path) / model_name
    save_dir.mkdir(parents=True, exist_ok=True)
    return save_dir / (model_name + "_epoch{epoch:02d}_vloss{val_loss:.4f}")


class SaveMode(enum.Enum):
    Each = 0
    Best = 1


class NNSaver:
    def __init__(self, save_dir: str, model_name: str, save_mode: SaveMode = SaveMode.Best,
                 use_time_date: bool = True):
        self.save_dir = save_dir
        self.model_name = model_name
        self.save_mode = save_mode
        save_time = get_time_formated() if use_time_date else None
        self.model_saving_path = get_saving_model_path(save_dir, model_name, save_time)
        self._losses = []

    def save_on_epoch_end(self, epoch, params, opt_state, vloss, log_metrics: Dict = None):
        """``params`` and ``opt_state`` are the model's and the optimizer's
        state dicts."""
        if self.save_mode == SaveMode.Each:
            self.save_model(epoch, params, opt_state, vloss)
        elif self.save_mode == SaveMode.Best:
            self.save_if_best(epoch, params, opt_state, vloss)
        else:
            raise NotImplementedError

        if log_metrics:
            csv_path = self.model_saving_path.parent / "logged_metrics.csv"
            cols = list(log_metrics.keys())
            rows = max((len(v) for v in log_metrics.values()), default=0)
            with open(csv_path, "w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow([""] + cols)
                for i in range(rows):
                    writer.writerow(
                        [i] + [log_metrics[c][i] if i < len(log_metrics[c]) else "" for c in cols]
                    )

    def save_if_best(self, epoch, params, opt_state, vloss):
        # a non-finite loss is never best and is not recorded, so a NaN epoch
        # can neither save a garbage checkpoint nor disable best-saving for
        # good (nan > x is False for every later finite x)
        if not math.isfinite(vloss):
            print(f"WARNING: epoch {epoch} loss is non-finite ({vloss}); "
                  "not saving and not recording as a best-loss candidate.", flush=True)
            return
        if all(prev > vloss for prev in self._losses):
            self.save_model(epoch, params, opt_state, vloss)
        self._losses.append(vloss)

    def save_model(self, epoch, params, opt_state, vloss) -> Path:
        model_path = Path(
            str(self.model_saving_path).format(epoch=epoch, val_loss=float(vloss)) + ".tar")
        torch.save({"epoch": int(epoch), "model_state_dict": params,
                    "optimizer_state_dict": opt_state, "loss": float(vloss)}, model_path)
        return model_path


def load_checkpoint(path, map_location="cpu") -> dict:
    """Read a checkpoint written by ``NNSaver`` (tensors and plain Python
    values only: ``weights_only`` unpickles nothing else)."""
    return torch.load(path, map_location=map_location, weights_only=True)
