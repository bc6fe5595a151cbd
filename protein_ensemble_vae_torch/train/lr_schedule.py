"""Host-side ReduceLROnPlateau with torch semantics (a plain-Python copy of
the JAX package's ``train/lr_schedule.py``).

The reference steps ``torch.optim.lr_scheduler.ReduceLROnPlateau(factor=0.5,
patience=10, min_lr=1e-6)`` on validation reconstruction. Here the LR is a
host scalar that the train step multiplies into the Adam update, so the
port's optimizer needs no scheduler object.
"""

from __future__ import annotations


class ReduceLROnPlateau:
    """mode='min', threshold_mode='rel', cooldown=0 (torch defaults)."""

    def __init__(self, lr: float, factor: float = 0.5, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 1e-6):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr

    def get_state(self) -> dict:
        return {"lr": self.lr, "best": self.best,
                "num_bad_epochs": self.num_bad_epochs}

    def load_state(self, state: dict) -> None:
        self.lr = state.get("lr", self.lr)
        self.best = state.get("best", float("inf"))
        self.num_bad_epochs = state.get("num_bad_epochs", 0)
