"""Metric logging: stdout + JSONL + optional wandb (a copy of the JAX
package's ``utils/logging.py``; ``wandb`` is imported only when its mode is
not "disabled").

Keeps the reference's three observability channels (SURVEY §5.5): wandb when
available/enabled, richly formatted stdout epoch summaries, and a persisted
history (JSONL here; the checkpoint also embeds loss_history). Metric names
match the reference so its dashboards/plotters keep working.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional


class MetricLogger:
    def __init__(self, jsonl_path: Optional[str] = None,
                 wandb_mode: str = "disabled",
                 wandb_project: str = "Protein-VAE",
                 wandb_run_name: Optional[str] = None,
                 config: Optional[dict] = None,
                 stream=None):
        self.stream = stream or sys.stdout
        self.jsonl_path = jsonl_path
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._jsonl = open(jsonl_path, "a")
        else:
            self._jsonl = None
        self._wandb = None
        if wandb_mode != "disabled":
            try:
                import wandb
                wandb.init(project=wandb_project, name=wandb_run_name,
                           mode=wandb_mode, config=config or {})
                self._wandb = wandb
            except Exception as e:  # wandb optional; never fail training
                self.info(f"wandb unavailable ({e}); continuing without it")

    def info(self, msg: str) -> None:
        print(msg, file=self.stream, flush=True)

    def log_epoch(self, epoch: int, train: dict, val: dict, *,
                  klw_g: float, klw_l: float, lr: float,
                  seconds: float) -> None:
        rmsd = (max(val.get("rec_ca", val["rec"]), 0.0)) ** 0.5
        self.info(
            f"[epoch {epoch:4d}] "
            f"train loss {train['loss']:.4f} rec {train['rec']:.4f} | "
            f"val loss {val['loss']:.4f} rec {val['rec']:.4f} "
            f"rmsd {rmsd:.3f}A seq_acc {val['seq_acc']:.3f} | "
            f"klw {klw_g:.3f}/{klw_l:.3f} lr {lr:.2e} | {seconds:.1f}s")
        record = {
            "epoch": epoch, "time": time.time(), "lr": lr,
            "klw_g": klw_g, "klw_l": klw_l, "seconds": seconds,
            **{f"train/{k}": v for k, v in train.items()},
            **{f"val/{k}": v for k, v in val.items()},
            "val/rmsd": rmsd,
        }
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        if self._wandb:
            self._wandb.log(record, step=epoch)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._wandb:
            self._wandb.finish()
