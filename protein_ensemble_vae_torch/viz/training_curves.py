"""Training-curve plotting from checkpoint loss history (a host-only copy
of the JAX package's ``viz/training_curves.py``; a port checkpoint writes
the same ``history.json``, and no device is used).

Reference ``plot_training_curves.py`` equivalent: 6-panel figure (monitored
metric, total loss, pair distance, KL global/local with posterior-collapse
warning at < 0.01, physics losses), best/stop epoch markers. Reads the
``history.json`` written next to every checkpoint (or a raw history dict).
Matplotlib is imported lazily and absence degrades to a text summary, as the
reference pipeline script guards do.
"""

from __future__ import annotations

import json
import os
from typing import Optional

POSTERIOR_COLLAPSE_THRESHOLD = 0.01


def load_history_any(path: str) -> dict:
    """Accept a checkpoint dir (history.json inside) or a json file."""
    if os.path.isdir(path):
        path = os.path.join(path, "history.json")
    with open(path) as f:
        return json.load(f)


def text_summary(history: dict) -> str:
    tr, va = history["train"], history["val"]
    n = len(tr["loss"])
    es = history.get("early_stopping", {})
    lines = [f"epochs trained: {n}"]
    if es:
        lines.append(f"best epoch: {es.get('best_epoch')} "
                     f"({es.get('metric_name')}={es.get('best_val_metric')})")
    if n:
        lines.append(f"final train/val loss: {tr['loss'][-1]:.4f} / "
                     f"{va['loss'][-1]:.4f}")
        lines.append(f"final val rec (MSE): {va['rec'][-1]:.4f} "
                     f"(~RMSD {max(va['rec'][-1], 0) ** 0.5:.2f} A)")
        if va["klg"][-1] < POSTERIOR_COLLAPSE_THRESHOLD:
            lines.append("WARNING: global KL < 0.01 — posterior collapse risk")
        if va["kll"][-1] < POSTERIOR_COLLAPSE_THRESHOLD:
            lines.append("WARNING: local KL < 0.01 — posterior collapse risk")
    return "\n".join(lines)


def plot_training_curves(history_path: str, output_path: Optional[str] = None
                         ) -> Optional[str]:
    history = load_history_any(history_path)
    print(text_summary(history))
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("[plot] matplotlib unavailable; text summary only")
        return None

    tr, va = history["train"], history["val"]
    epochs = range(1, len(tr["loss"]) + 1)
    es = history.get("early_stopping", {})
    best_epoch = es.get("best_epoch", 0)

    fig, axes = plt.subplots(2, 3, figsize=(18, 10))

    panels = [
        ("Monitored metric (rec)", ["rec"]),
        ("Total loss", ["loss"]),
        ("Pair distance", ["pair"]),
        ("KL divergences", ["klg", "kll"]),
        ("Physics losses", ["bond", "angle", "rama", "dihedral", "clash"]),
        ("Sequence", ["seq", "seq_acc"]),
    ]
    for ax, (title, keys) in zip(axes.flat, panels):
        for k in keys:
            if k in tr:
                ax.plot(epochs, tr[k], label=f"train {k}", alpha=0.8)
                ax.plot(epochs, va[k], label=f"val {k}", alpha=0.8, ls="--")
        if best_epoch:
            ax.axvline(best_epoch, color="green", alpha=0.4, ls=":",
                       label="best epoch")
        ax.set_title(title)
        ax.set_xlabel("epoch")
        ax.legend(fontsize=7)
        ax.grid(alpha=0.3)
        if title == "KL divergences":
            ax.axhline(POSTERIOR_COLLAPSE_THRESHOLD, color="red", alpha=0.4,
                       label="collapse threshold")

    fig.tight_layout()
    output_path = output_path or "training_curves.png"
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    print(f"[plot] saved {output_path}")
    return output_path


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Plot training curves from a "
                                 "checkpoint's loss history")
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint dir or history.json")
    ap.add_argument("--output", default="training_curves.png")
    args = ap.parse_args(argv)
    plot_training_curves(args.checkpoint, args.output)


if __name__ == "__main__":
    main()
