"""Checkpoint parameter inspection and visualization (counterpart of the
JAX package's ``viz/parameters.py``, host numpy and matplotlib).

Reference ``visualize_parameters.py`` equivalent, at full depth
(visualize_parameters.py:57-391): weight-distribution histograms, bias
histograms, 2D weight heatmaps, per-module layer statistics, a four-panel
magnitude comparison across every tensor, and a detailed text summary.

Differences from the JAX package's module are the port's layouts:
- the parameters come as a port ``state_dict`` (name -> tensor), an
  ``nn.Module`` (its parameters) or a nested dict of arrays (joined with
  "."); names are the port's dotted ones (``encoder.seq_proj.weight``,
  JAX's ``encoder/seq_proj/kernel``, as ``models/bridge.py`` maps them);
- the ``weight`` leaf plays the role of JAX's ``kernel`` / ``scale`` /
  ``embedding`` leaves; heatmaps show a 2-D weight transposed back from
  torch's ``[out, in]`` to JAX's ``[in, out]``;
- ``main`` reads a port checkpoint (``state.pt``) and takes ``--device``,
  the GPU unless ``cpu`` is given, as every port CLI does;
- matplotlib is imported inside the plots, which return None without it.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Mapping, Optional

import numpy as np

_WEIGHT_LEAVES = ("weight",)


def _flatten(tree, prefix: str, out: list) -> None:
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            _flatten(v, name, out)
        else:
            if hasattr(v, "detach"):
                v = v.detach().float().cpu().numpy()
            out.append((name, np.asarray(v)))


def _flat_params(params) -> list[tuple[str, np.ndarray]]:
    """(dotted name, array) pairs sorted by name, of a ``state_dict``, an
    ``nn.Module``'s parameters or a nested dict of arrays."""
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())
    out: list = []
    _flatten(params, "", out)
    return sorted(out, key=lambda kv: kv[0])


def parameter_stats(params) -> list[dict]:
    """Flat list of per-leaf statistics (no raw data — cheap to serialize)."""
    rows = []
    for name, a in _flat_params(params):
        rows.append(dict(
            name=name,
            shape=tuple(a.shape),
            count=int(a.size),
            mean=float(a.mean()),
            std=float(a.std()),
            min=float(a.min()),
            max=float(a.max()),
            abs_mean=float(np.abs(a).mean()),
            frac_zero=float((a == 0).mean()),
        ))
    return rows


def _module_of(name: str) -> str:
    return name.split(".")[0]


def _is_weight(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in _WEIGHT_LEAVES


def _is_bias(name: str) -> bool:
    return name.rsplit(".", 1)[-1] == "bias"


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError:
        return None


def _hist_grid(named_arrays, output_path: str, title: str,
               color: Optional[str] = None, max_plots: int = 20
               ) -> Optional[str]:
    """4x5 histogram grid with mu/sigma annotations
    (visualize_parameters.py:57-152 layout)."""
    plt = _plt()
    if plt is None or not named_arrays:
        return None
    ranked = sorted(named_arrays, key=lambda kv: kv[1].size, reverse=True)
    ranked = ranked[:max_plots]
    fig, axes = plt.subplots(4, 5, figsize=(20, 16))
    axes = axes.flatten()
    for ax, (name, a) in zip(axes, ranked):
        data = a.ravel()
        ax.hist(data, bins=50, alpha=0.7, edgecolor="black", color=color)
        ax.axvline(x=0, color="red", linestyle="--", alpha=0.5, linewidth=1)
        ax.set_title(f"{name}\n({a.size:,} params)", fontsize=8)
        ax.set_xlabel("Value", fontsize=7)
        ax.set_ylabel("Count", fontsize=7)
        ax.tick_params(labelsize=6)
        ax.grid(True, alpha=0.3)
        ax.text(0.98, 0.98, f"μ={data.mean():.3f}\nσ={data.std():.3f}",
                transform=ax.transAxes, fontsize=6, va="top", ha="right",
                bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.5))
    for ax in axes[len(ranked):]:
        ax.axis("off")
    fig.suptitle(title, fontsize=14, y=0.995)
    fig.tight_layout()
    fig.savefig(output_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return output_path


def plot_weight_distributions(params, output_path: str,
                              max_plots: int = 20) -> Optional[str]:
    weights = [(n, a) for n, a in _flat_params(params) if _is_weight(n)]
    return _hist_grid(
        weights, output_path,
        f"Weight Distributions (Top {max_plots} Layers by Parameter Count)",
        max_plots=max_plots)


def plot_bias_distributions(params, output_path: str,
                            max_plots: int = 20) -> Optional[str]:
    biases = [(n, a) for n, a in _flat_params(params) if _is_bias(n)]
    return _hist_grid(
        biases, output_path,
        f"Bias Distributions (Top {max_plots} Layers)",
        color="orange", max_plots=max_plots)


def plot_weight_heatmaps(params, output_path: str,
                         max_plots: int = 6) -> Optional[str]:
    """Symmetric RdBu heatmaps of the largest 2D weights, shown ``[in,
    out]`` as JAX's kernels (visualize_parameters.py:155-208); >500-wide
    axes are strided down."""
    plt = _plt()
    if plt is None:
        return None
    mats = [(n, a.T) for n, a in _flat_params(params)
            if _is_weight(n) and a.ndim == 2]
    if not mats:
        return None
    mats = sorted(mats, key=lambda kv: kv[1].size, reverse=True)[:max_plots]
    fig, axes = plt.subplots(2, 3, figsize=(18, 12))
    axes = axes.flatten()
    for ax, (name, a) in zip(axes, mats):
        data = a
        if data.shape[0] > 500 or data.shape[1] > 500:
            data = data[::max(1, data.shape[0] // 500),
                        ::max(1, data.shape[1] // 500)]
        lim = max(abs(float(data.min())), abs(float(data.max()))) or 1.0
        im = ax.imshow(data, aspect="auto", cmap="RdBu_r",
                       vmin=-lim, vmax=lim)
        fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
        ax.set_title(f"{name}\nShape: {a.shape}", fontsize=9)
        ax.set_xlabel("Output dim", fontsize=8)   # torch [out, in], transposed
        ax.set_ylabel("Input dim", fontsize=8)
        ax.tick_params(labelsize=7)
    for ax in axes[len(mats):]:
        ax.axis("off")
    fig.suptitle(f"Weight Matrix Heatmaps (Top {len(mats)} Largest)",
                 fontsize=14)
    fig.tight_layout()
    fig.savefig(output_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return output_path


def plot_layer_statistics(params, output_path: str) -> Optional[str]:
    """Per-module parameter count / avg |mean| / avg std bar charts
    (visualize_parameters.py:211-271)."""
    plt = _plt()
    if plt is None:
        return None
    modules = defaultdict(lambda: {"params": 0, "mean_abs": [], "std": []})
    for r in parameter_stats(params):
        m = modules[_module_of(r["name"])]
        m["params"] += r["count"]
        m["mean_abs"].append(abs(r["mean"]))
        m["std"].append(r["std"])
    names = sorted(modules)
    counts = [modules[m]["params"] for m in names]
    mean_abs = [float(np.mean(modules[m]["mean_abs"])) for m in names]
    stds = [float(np.mean(modules[m]["std"])) for m in names]

    fig, axes = plt.subplots(1, 3, figsize=(18, 5))
    panels = [
        (counts, "steelblue", "Number of Parameters", "Parameters per Module"),
        (mean_abs, "coral", "Average |Mean|", "Average Absolute Mean per Module"),
        (stds, "mediumseagreen", "Average Std Dev",
         "Average Standard Deviation per Module"),
    ]
    for ax, (vals, color, ylabel, title) in zip(axes, panels):
        bars = ax.bar(range(len(names)), vals, color=color, edgecolor="black")
        ax.set_xticks(range(len(names)))
        ax.set_xticklabels(names, rotation=45, ha="right")
        ax.set_ylabel(ylabel, fontsize=10)
        ax.set_title(title, fontsize=12)
        ax.grid(True, alpha=0.3, axis="y")
        if ylabel.startswith("Number"):
            for bar, val in zip(bars, vals):
                ax.text(bar.get_x() + bar.get_width() / 2, bar.get_height(),
                        f"{val:,}", ha="center", va="bottom", fontsize=8)
    fig.tight_layout()
    fig.savefig(output_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return output_path


def plot_parameter_magnitudes(params, output_path: str) -> Optional[str]:
    """Four-panel horizontal comparison across every tensor: |mean|, std,
    range, log-scale counts (visualize_parameters.py:274-339)."""
    plt = _plt()
    if plt is None:
        return None
    rows = parameter_stats(params)
    short = [r["name"].rsplit(".", 1)[-1] + " : " +
             r["name"].rsplit(".", 2)[-2] if "." in r["name"] else r["name"]
             for r in rows]
    y = np.arange(len(rows))
    panels = [
        ([abs(r["mean"]) for r in rows], "steelblue", "|Mean|",
         "Absolute Mean Values", False),
        ([r["std"] for r in rows], "coral", "Std Dev",
         "Standard Deviations", False),
        ([r["max"] - r["min"] for r in rows], "mediumseagreen",
         "Range (Max - Min)", "Value Ranges", False),
        ([r["count"] for r in rows], "mediumpurple",
         "Number of Parameters", "Parameter Counts (log scale)", True),
    ]
    fig, axes = plt.subplots(2, 2, figsize=(16, max(12, 0.14 * len(rows))))
    for ax, (vals, color, xlabel, title, logx) in zip(axes.flat, panels):
        ax.barh(y, vals, color=color, edgecolor="black", linewidth=0.5)
        ax.set_yticks(y)
        ax.set_yticklabels(short, fontsize=5)
        ax.set_xlabel(xlabel, fontsize=10)
        ax.set_title(title, fontsize=12)
        if logx:
            ax.set_xscale("log")
        ax.grid(True, alpha=0.3, axis="x")
    fig.suptitle("Parameter Statistics Across All Layers", fontsize=14,
                 y=0.995)
    fig.tight_layout()
    fig.savefig(output_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return output_path


def write_parameter_summary(params, output_path: str,
                            epoch: Optional[int] = None) -> str:
    """Detailed text summary: totals, per-module breakdown, per-tensor stats
    sorted by size (visualize_parameters.py:342-391)."""
    rows = parameter_stats(params)
    total = sum(r["count"] for r in rows)
    modules = defaultdict(lambda: {"params": 0, "layers": 0})
    for r in rows:
        m = modules[_module_of(r["name"])]
        m["params"] += r["count"]
        m["layers"] += 1
    with open(output_path, "w") as f:
        f.write("=" * 80 + "\nMODEL PARAMETER SUMMARY\n" + "=" * 80 + "\n\n")
        if epoch is not None:
            f.write(f"Checkpoint epoch: {epoch}\n\n")
        f.write(f"Total parameters: {total:,}\n")
        f.write(f"Trainable parameters: {total:,}\n\n")
        f.write("Parameters by module:\n" + "-" * 80 + "\n")
        for module, info in sorted(modules.items()):
            f.write(f"  {module:20s}: {info['params']:12,} params "
                    f"({info['layers']:3d} tensors)\n")
        f.write("\n" + "=" * 80 + "\nDETAILED LAYER STATISTICS\n"
                + "=" * 80 + "\n\n")
        for r in sorted(rows, key=lambda r: r["count"], reverse=True):
            f.write(f"{r['name']}\n")
            f.write(f"  Shape:      {r['shape']}\n")
            f.write(f"  Parameters: {r['count']:,}\n")
            f.write(f"  Mean:       {r['mean']:+.6f}\n")
            f.write(f"  Std:        {r['std']:.6f}\n")
            f.write(f"  Min:        {r['min']:+.6f}\n")
            f.write(f"  Max:        {r['max']:+.6f}\n")
            f.write(f"  Range:      {r['max'] - r['min']:.6f}\n\n")
    return output_path


def visualize_parameters(params, output_dir: str,
                         epoch: Optional[int] = None) -> dict:
    """Run the full battery; returns {artifact: path-or-None}."""
    os.makedirs(output_dir, exist_ok=True)
    j = lambda fn: os.path.join(output_dir, fn)  # noqa: E731
    return {
        "weight_distributions": plot_weight_distributions(
            params, j("weight_distributions.png")),
        "bias_distributions": plot_bias_distributions(
            params, j("bias_distributions.png")),
        "weight_heatmaps": plot_weight_heatmaps(
            params, j("weight_heatmaps.png")),
        "layer_statistics": plot_layer_statistics(
            params, j("layer_statistics.png")),
        "parameter_magnitudes": plot_parameter_magnitudes(
            params, j("parameter_magnitudes.png")),
        "parameter_summary": write_parameter_summary(
            params, j("parameter_summary.txt"), epoch=epoch),
    }


def main(argv=None):
    import argparse

    from protein_ensemble_vae_torch.models import HierCVAE
    from protein_ensemble_vae_torch.ops.routing import resolve_device
    from protein_ensemble_vae_torch.train.checkpoint import (load_checkpoint,
                                                             load_meta,
                                                             load_run_config)

    ap = argparse.ArgumentParser(
        description="Visualize VAE model parameters (weights and biases) of a "
                    "port checkpoint")
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint directory (with state.pt + meta.json)")
    ap.add_argument("--output_dir", default="parameter_analysis")
    ap.add_argument("--device", default="cuda",
                    help="torch device to load the model on (default cuda; "
                         "pass cpu to run on the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_run_config(args.checkpoint)
    model = load_checkpoint(args.checkpoint, HierCVAE(cfg.model).to(device))
    epoch = load_meta(args.checkpoint).get("epoch")

    artifacts = visualize_parameters(model, args.output_dir, epoch=epoch)
    for kind, path in artifacts.items():
        status = path if path else "(matplotlib unavailable — skipped)"
        print(f"[params] {kind}: {status}")


if __name__ == "__main__":
    main()
