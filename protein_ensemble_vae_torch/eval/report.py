"""Validation report: the full metric battery over predicted vs true
structures or an ensemble, with the reference's printed interpretation bands
(``scripts/validation_metrics.py:428-655``). A copy of the JAX package's
``eval/report.py``; the ensemble battery runs on ``device`` (default the
GPU)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from protein_ensemble_vae_torch.eval.metrics import (
    compute_contact_map,
    compute_ensemble_diversity,
    compute_gdt,
    compute_lddt,
    compute_radius_of_gyration,
    compute_rmsf,
    compute_tm_score,
    contact_map_overlap,
    expected_rg,
    kabsch_align_np,
)
from protein_ensemble_vae_torch.infer.pdb_io import read_pdb_backbone


def _interp(value: float, bands: list[tuple[float, str]], higher_better=True) -> str:
    for thresh, label in bands:
        if (value > thresh) if higher_better else (value < thresh):
            return label
    return bands[-1][1]


def validate_prediction(pred_ca: np.ndarray, true_ca: np.ndarray,
                        mask: Optional[np.ndarray] = None) -> dict:
    """Pairwise structure-quality metrics for one prediction."""
    if mask is None:
        mask = np.ones(len(true_ca), bool)
    mask = mask.astype(bool)
    p, t = pred_ca[mask], true_ca[mask]

    aligned = kabsch_align_np(p, t)
    rmsd = float(np.sqrt(((aligned - t) ** 2).mean()))
    tm = compute_tm_score(p, t)
    lddt_g, _ = compute_lddt(p, t)
    gdt_ts, gdt_ha = compute_gdt(p, t)
    prec, rec, f1 = contact_map_overlap(compute_contact_map(p),
                                        compute_contact_map(t))
    rg_pred = compute_radius_of_gyration(p)
    rg_true = compute_radius_of_gyration(t)
    return dict(
        rmsd=rmsd, tm_score=tm, lddt=lddt_g, gdt_ts=gdt_ts, gdt_ha=gdt_ha,
        contact_precision=prec, contact_recall=rec, contact_f1=f1,
        rg_pred=rg_pred, rg_true=rg_true,
        rg_expected=expected_rg(int(mask.sum())),
        tm_interpretation=_interp(tm, [(0.9, "excellent model"),
                                       (0.7, "good model"),
                                       (0.5, "same fold"),
                                       (-1.0, "different fold")]),
        lddt_interpretation=_interp(lddt_g, [(0.9, "excellent"),
                                             (0.7, "good"),
                                             (-1.0, "poor")]),
    )


def validate_ensemble(ensemble_ca: np.ndarray,
                      mask: Optional[np.ndarray] = None, device="cuda") -> dict:
    """Ensemble-level metrics: diversity + RMSF profile."""
    if mask is not None:
        ensemble_ca = ensemble_ca[:, mask.astype(bool)]
    diversity, matrix = compute_ensemble_diversity(ensemble_ca, device=device)
    rmsf = compute_rmsf(ensemble_ca, device=device)
    return dict(
        n_models=len(ensemble_ca),
        diversity=diversity,
        diversity_ok=diversity > 0.05,  # floor (validation_metrics.py:559-562)
        rmsf_mean=float(rmsf.mean()),
        rmsf_max=float(rmsf.max()) if len(rmsf) else 0.0,
        rmsd_matrix=matrix,
    )


def write_report(path: str, pred_metrics: Optional[dict] = None,
                 ens_metrics: Optional[dict] = None) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("STRUCTURE VALIDATION REPORT\n" + "=" * 70 + "\n\n")
        if pred_metrics:
            m = pred_metrics
            f.write("PREDICTION vs TRUE\n" + "-" * 40 + "\n")
            f.write(f"RMSD (Kabsch):       {m['rmsd']:8.3f} A\n")
            f.write(f"TM-score:            {m['tm_score']:8.3f}  "
                    f"[{m['tm_interpretation']}]\n")
            f.write(f"lDDT:                {m['lddt']:8.3f}  "
                    f"[{m['lddt_interpretation']}]\n")
            f.write(f"GDT-TS / GDT-HA:     {m['gdt_ts']:6.1f} / {m['gdt_ha']:6.1f}\n")
            f.write(f"Contacts P/R/F1:     {m['contact_precision']:.3f} / "
                    f"{m['contact_recall']:.3f} / {m['contact_f1']:.3f}\n")
            f.write(f"Rg pred/true/expect: {m['rg_pred']:.2f} / "
                    f"{m['rg_true']:.2f} / {m['rg_expected']:.2f} A\n\n")
        if ens_metrics:
            e = ens_metrics
            f.write("ENSEMBLE\n" + "-" * 40 + "\n")
            f.write(f"models:              {e['n_models']}\n")
            f.write(f"diversity:           {e['diversity']:8.3f} A "
                    f"[{'OK' if e['diversity_ok'] else 'LOW (<0.05 A)'}]\n")
            f.write(f"RMSF mean/max:       {e['rmsf_mean']:.3f} / "
                    f"{e['rmsf_max']:.3f} A\n")
    return path


def validate_files(pred_pdb: Optional[str] = None,
                   true_pdb: Optional[str] = None,
                   ensemble_pdb: Optional[str] = None,
                   output: Optional[str] = None, device="cuda") -> dict:
    """CLI-facing entry: ``--pred/--true`` or ``--ensemble`` modes
    (reference validation_metrics.py:662-698)."""
    pred_metrics = ens_metrics = None
    if pred_pdb and true_pdb:
        pred = read_pdb_backbone(pred_pdb)
        true = read_pdb_backbone(true_pdb)
        mask = (pred["mask"] > 0.5) & (true["mask"] > 0.5)
        pred_metrics = validate_prediction(pred["ca"][0], true["ca"][0], mask)
    if ensemble_pdb:
        ens = read_pdb_backbone(ensemble_pdb)
        ens_metrics = validate_ensemble(ens["ca"], ens["mask"] > 0.5,
                                        device=device)
    if output:
        write_report(output, pred_metrics, ens_metrics)
    return dict(prediction=pred_metrics, ensemble=ens_metrics)
