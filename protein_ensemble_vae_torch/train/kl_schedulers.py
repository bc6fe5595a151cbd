"""KL-annealing schedules (host-side, pure functions of epoch).

A plain-Python copy of the JAX package's ``train/kl_schedulers.py``,
``plot_schedules`` included (matplotlib imported inside it). Same math as reference ``models/kl_schedulers.py`` (cyclical sawtooth per Fu
et al. 2019 at :91-116, monotonic warmup :148-161, adaptive on val RMSD
:197-221, exponential :249-260). Two reference bugs fixed deliberately:

- ``train_model`` hardcoded CyclicalKLScheduler regardless of the
  ``--kl_schedule`` flag (training.py:231-236); our factory is actually used.
- ``get_state``/``load_state`` existed but were never called
  (kl_schedulers.py:48-60); here they are wired into checkpoint/resume.
"""

from __future__ import annotations

import math
from typing import Dict, Optional


class BaseKLScheduler:
    def __init__(self, max_weight: float = 1.0):
        self.max_weight = max_weight
        self.current_weight = 0.0
        self.history: list[float] = []

    def step(self, epoch: int, total_epochs: int, **metrics) -> float:
        raise NotImplementedError

    def get_state(self) -> Dict:
        return {
            "max_weight": self.max_weight,
            "current_weight": self.current_weight,
            "history": list(self.history),
        }

    def load_state(self, state: Dict) -> None:
        self.max_weight = state.get("max_weight", self.max_weight)
        self.current_weight = state.get("current_weight", 0.0)
        self.history = list(state.get("history", []))


class CyclicalKLScheduler(BaseKLScheduler):
    """Sawtooth over ``n_cycles``: linear up for ``ratio`` of each cycle,
    then linear down (or hold at max if ratio == 1.0)."""

    def __init__(self, n_cycles: int = 4, ratio: float = 0.5,
                 max_weight: float = 1.0, start_weight: float = 0.0):
        super().__init__(max_weight)
        self.n_cycles = n_cycles
        self.ratio = ratio
        self.start_weight = start_weight
        self.current_weight = start_weight

    def step(self, epoch: int, total_epochs: int, **metrics) -> float:
        cycle_length = total_epochs / self.n_cycles
        cycle_position = ((epoch - 1) % cycle_length) / cycle_length
        span = self.max_weight - self.start_weight
        if cycle_position < self.ratio:
            progress = cycle_position / self.ratio
            self.current_weight = self.start_weight + span * progress
        elif self.ratio < 1.0:
            progress = (cycle_position - self.ratio) / (1.0 - self.ratio)
            self.current_weight = self.max_weight - span * progress
        else:
            self.current_weight = self.max_weight
        self.history.append(self.current_weight)
        return self.current_weight


class MonotonicKLScheduler(BaseKLScheduler):
    """Classic beta-VAE linear warmup, optional intermediate hold."""

    def __init__(self, warmup_epochs: int = 50, max_weight: float = 1.0,
                 hold_epochs: Optional[int] = None):
        super().__init__(max_weight)
        self.warmup_epochs = warmup_epochs
        self.hold_epochs = hold_epochs
        self.intermediate_weight = max_weight * 0.5 if hold_epochs else max_weight

    def step(self, epoch: int, total_epochs: int, **metrics) -> float:
        if epoch <= self.warmup_epochs:
            self.current_weight = self.max_weight * (epoch / self.warmup_epochs)
        elif self.hold_epochs and epoch <= self.warmup_epochs + self.hold_epochs:
            self.current_weight = self.intermediate_weight
        else:
            self.current_weight = self.max_weight
        self.history.append(self.current_weight)
        return self.current_weight


class AdaptiveKLScheduler(BaseKLScheduler):
    """Multiplicative adaptation on validation RMSD vs a target."""

    def __init__(self, target_rmsd: float = 1.5, min_weight: float = 0.1,
                 max_weight: float = 10.0, adapt_rate: float = 0.05,
                 warmup_epochs: int = 20):
        super().__init__(max_weight)
        self.target_rmsd = target_rmsd
        self.min_weight = min_weight
        self.adapt_rate = adapt_rate
        self.warmup_epochs = warmup_epochs
        self.current_weight = min_weight

    def step(self, epoch: int, total_epochs: int,
             val_rmsd: Optional[float] = None, **metrics) -> float:
        if epoch <= self.warmup_epochs:
            self.current_weight = (self.min_weight
                                   + (self.max_weight - self.min_weight)
                                   * (epoch / self.warmup_epochs) * 0.5)
        elif val_rmsd is not None:
            if val_rmsd < self.target_rmsd:
                self.current_weight *= (1 + self.adapt_rate)
            else:
                self.current_weight *= (1 - self.adapt_rate)
            self.current_weight = min(max(self.current_weight, self.min_weight),
                                      self.max_weight)
        self.history.append(self.current_weight)
        return self.current_weight


class ExponentialKLScheduler(BaseKLScheduler):
    """Exponential-curve warmup with a steepness knob."""

    def __init__(self, warmup_epochs: int = 50, max_weight: float = 1.0,
                 steepness: float = 2.0):
        super().__init__(max_weight)
        self.warmup_epochs = warmup_epochs
        self.steepness = steepness

    def step(self, epoch: int, total_epochs: int, **metrics) -> float:
        if epoch <= self.warmup_epochs:
            progress = epoch / self.warmup_epochs
            expp = ((math.exp(self.steepness * progress) - 1)
                    / (math.exp(self.steepness) - 1))
            self.current_weight = self.max_weight * expp
        else:
            self.current_weight = self.max_weight
        self.history.append(self.current_weight)
        return self.current_weight


def create_kl_scheduler(schedule_type: str, max_weight: float = 1.0,
                        warmup_epochs: int = 50, n_cycles: int = 4,
                        **kwargs) -> BaseKLScheduler:
    schedule_type = schedule_type.lower()
    if schedule_type == "cyclical":
        return CyclicalKLScheduler(n_cycles=n_cycles,
                                   ratio=kwargs.get("ratio", 0.5),
                                   max_weight=max_weight)
    if schedule_type == "monotonic":
        return MonotonicKLScheduler(warmup_epochs=warmup_epochs,
                                    max_weight=max_weight)
    if schedule_type == "adaptive":
        return AdaptiveKLScheduler(
            target_rmsd=kwargs.get("target_rmsd", 1.5),
            min_weight=kwargs.get("min_weight", 0.1),
            max_weight=max_weight,
            adapt_rate=kwargs.get("adapt_rate", 0.05),
            warmup_epochs=warmup_epochs)
    if schedule_type == "exponential":
        return ExponentialKLScheduler(warmup_epochs=warmup_epochs,
                                      max_weight=max_weight,
                                      steepness=kwargs.get("steepness", 2.0))
    raise ValueError(
        f"Unknown schedule type: {schedule_type}. "
        "Choose from ['cyclical', 'monotonic', 'adaptive', 'exponential']")


def plot_schedules(total_epochs: int = 200,
                   output_path: str = "kl_schedules_comparison.png"):
    """Schedule-comparison plot (reference kl_schedulers.py:400-439); None
    when matplotlib is missing."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("[kl] matplotlib unavailable")
        return None

    schedulers = {
        "Cyclical (4 cycles)": CyclicalKLScheduler(4, 0.5, 2.0),
        "Monotonic": MonotonicKLScheduler(40, 2.0),
        "Exponential": ExponentialKLScheduler(40, 2.0, 3.0),
        "Cyclical (8 cycles, fast)": CyclicalKLScheduler(8, 0.3, 2.0),
    }
    fig, ax = plt.subplots(figsize=(12, 6))
    epochs = range(1, total_epochs + 1)
    for name, sch in schedulers.items():
        ax.plot(epochs, [sch.step(e, total_epochs) for e in epochs],
                label=name, lw=2, alpha=0.8)
    ax.set_xlabel("epoch")
    ax.set_ylabel("KL weight")
    ax.set_title("KL annealing schedules")
    ax.legend()
    ax.grid(alpha=0.3, ls="--")
    fig.tight_layout()
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    print(f"[kl] saved {output_path}")
    return output_path


if __name__ == "__main__":
    plot_schedules()
