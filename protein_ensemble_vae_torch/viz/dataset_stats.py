"""Training-data statistics: per-chain conformer count / length / missing
fraction / RMSF summary CSV + optional histograms (the JAX package's
``viz/dataset_stats.py``; RMSF from the port's ``eval.metrics`` on
``--device``, which is the GPU unless ``cpu`` is given; the H5 files are
read by ``data.h5file``; matplotlib is imported inside the functions that
need it).

Reference ``scripts/viz_train.py`` equivalent, driven off manifests.
"""

from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np


def dataset_stats(manifest_csv: str, device: str = "cuda") -> list[dict]:
    """One row per readable chain of the manifest (a file that fails to
    read is reported and skipped); the RMSF's Kabsch runs on ``device``,
    which raises up front when it is a GPU that is missing."""
    from protein_ensemble_vae_torch.data import h5file
    from protein_ensemble_vae_torch.eval.metrics import compute_rmsf
    from protein_ensemble_vae_torch.ops.routing import resolve_device

    resolve_device(device)

    rows = []
    with open(manifest_csv) as f:
        for row in csv.DictReader(f):
            h5_path = row["h5_path"].strip()
            if not os.path.exists(h5_path):
                continue
            try:
                with h5file.File(h5_path, "r") as fh:
                    ca = fh["coords_ca"][:]
                    mask = fh["mask_ca"][:]
                K, L, _ = ca.shape
                valid_frac = float(mask.mean())
                valid = mask[0] > 0.5
                rmsf = (compute_rmsf(ca[:, valid], device=device) if valid.sum() > 3
                        else np.zeros(1))
                rows.append(dict(
                    h5_path=h5_path,
                    chain=os.path.basename(h5_path).replace(".h5", ""),
                    n_conformers=K, n_residues=L,
                    missing_frac=round(1.0 - valid_frac, 4),
                    rmsf_mean=round(float(rmsf.mean()), 3),
                    rmsf_max=round(float(rmsf.max()), 3)))
            except Exception as e:  # skip-and-continue like the reference
                print(f"[viz] skipping {h5_path}: {e}")
    return rows


def write_stats_csv(rows: list[dict], output_path: str) -> str:
    if not rows:
        raise ValueError("no rows to write")
    with open(output_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    return output_path


def plot_stats(rows: list[dict], output_path: str) -> Optional[str]:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    axes[0, 0].hist([r["n_conformers"] for r in rows], bins=20)
    axes[0, 0].set_title("conformers per chain")
    axes[0, 1].hist([r["n_residues"] for r in rows], bins=20)
    axes[0, 1].set_title("chain length")
    axes[1, 0].hist([r["missing_frac"] for r in rows], bins=20)
    axes[1, 0].set_title("missing fraction")
    axes[1, 1].scatter([r["n_residues"] for r in rows],
                       [r["rmsf_mean"] for r in rows], s=8, alpha=0.6)
    axes[1, 1].set_title("RMSF vs length")
    fig.tight_layout()
    fig.savefig(output_path, dpi=130)
    plt.close(fig)
    return output_path


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Summarize training data")
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--output_dir", default="data_stats")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the RMSF alignment (default cuda; "
                         "pass cpu to run on the CPU)")
    args = ap.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    rows = dataset_stats(args.manifest, args.device)
    csv_path = write_stats_csv(rows, os.path.join(args.output_dir,
                                                  "chain_stats.csv"))
    print(f"[viz] {len(rows)} chains -> {csv_path}")
    png = plot_stats(rows, os.path.join(args.output_dir, "chain_stats.png"))
    if png:
        print(f"[viz] plots: {png}")


if __name__ == "__main__":
    main()
