"""Structure-validation metrics: TM-score, lDDT, GDT, RMSF, Rg, contacts.

Vectorized re-implementations of reference
``scripts/validation_metrics.py:23-349`` — same formulas and thresholds
(TM d0 = 1.24·∛(L−15) − 1.8; lDDT 4-threshold 0.5/1/2/4 Å at 15 Å cutoff;
GDT-TS 1/2/4/8 Å; GDT-HA 0.5/1/2/4 Å; Rg expectation 2.2·L^0.38; contacts at
8 Å excluding |i−j| ≤ 1) with the O(L²)/O(K²) Python loops replaced by
matrix ops and a batched Kabsch battery.

A copy of the JAX package's ``eval/metrics.py``: host numpy, except the
batched Kabsch of ``compute_rmsf`` and ``compute_ensemble_diversity``,
which run on ``device`` (default the GPU) through the port's
``ops/geometry.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from protein_ensemble_vae_torch.ops.geometry import (kabsch_align,
                                                     pairwise_kabsch_rmsd)


def _cdist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)


def kabsch_align_np(mobile: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Optimal superposition of mobile onto target (numpy, reflection-safe)."""
    mc = mobile - mobile.mean(axis=0)
    tc = target - target.mean(axis=0)
    H = mc.T @ tc
    U, _, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        Vt = Vt.copy()
        Vt[-1, :] *= -1
        R = Vt.T @ U.T
    return mc @ R.T + target.mean(axis=0)


def compute_tm_score(coords_pred: np.ndarray, coords_true: np.ndarray) -> float:
    """TM-score approximation after one global Kabsch superposition."""
    L = len(coords_true)
    d0 = 1.24 * np.cbrt(max(L - 15, 1e-9)) - 1.8
    d0 = max(d0, 0.5)
    aligned = kabsch_align_np(coords_pred, coords_true)
    d = np.linalg.norm(aligned - coords_true, axis=1)
    return float(np.mean(1.0 / (1.0 + (d / d0) ** 2)))


def compute_lddt(coords_pred: np.ndarray, coords_true: np.ndarray,
                 mask: Optional[np.ndarray] = None, cutoff: float = 15.0
                 ) -> tuple[float, np.ndarray]:
    """lDDT, superposition-free. Returns (global, per-residue [L])."""
    L = len(coords_true)
    if mask is None:
        mask = np.ones(L, dtype=bool)
    mask = mask.astype(bool)

    dist_true = _cdist(coords_true, coords_true)
    dist_pred = _cdist(coords_pred, coords_pred)

    neighbors = (dist_true < cutoff) & (dist_true > 0) & mask[None, :]
    neighbors &= mask[:, None]
    diff = np.abs(dist_true - dist_pred)

    preserved = sum((diff < t).astype(np.float32) * neighbors
                    for t in (0.5, 1.0, 2.0, 4.0))
    n_nbr = neighbors.sum(axis=1)
    per_res = np.zeros(L, np.float32)
    has = n_nbr > 0
    per_res[has] = preserved.sum(axis=1)[has] / (4.0 * n_nbr[has])
    glob = float(per_res[mask].mean()) if mask.sum() > 0 else 0.0
    return glob, per_res


def compute_gdt(coords_pred: np.ndarray, coords_true: np.ndarray,
                mask: Optional[np.ndarray] = None) -> tuple[float, float]:
    """(GDT-TS, GDT-HA) in [0, 100] after global superposition."""
    if mask is None:
        mask = np.ones(len(coords_true), dtype=bool)
    mask = mask.astype(bool)
    aligned = kabsch_align_np(coords_pred, coords_true)
    d = np.linalg.norm(aligned - coords_true, axis=1)[mask]
    if len(d) == 0:
        return 0.0, 0.0
    p = {t: (d < t).mean() * 100 for t in (0.5, 1.0, 2.0, 4.0, 8.0)}
    gdt_ts = (p[1.0] + p[2.0] + p[4.0] + p[8.0]) / 4
    gdt_ha = (p[0.5] + p[1.0] + p[2.0] + p[4.0]) / 4
    return float(gdt_ts), float(gdt_ha)


def compute_rmsf(ensemble_coords: np.ndarray,
                 mask: Optional[np.ndarray] = None,
                 device="cuda") -> np.ndarray:
    """Per-residue RMSF of an aligned ensemble [K, L, 3] -> [L].

    The K alignments onto frame 0 run as ONE batched Kabsch
    (``ops.geometry.kabsch_align``, on ``device``) instead of a Python SVD
    loop (reference ``validation_metrics.py:206-241``)."""
    K, L, _ = ensemble_coords.shape
    if K == 1:
        return np.zeros(L, np.float32)
    X = torch.as_tensor(np.asarray(ensemble_coords, np.float32), device=device)
    aligned = kabsch_align(X, X[0].expand_as(X)).cpu().numpy()
    mean = aligned.mean(axis=0)
    dev = aligned - mean
    return np.sqrt((dev ** 2).sum(axis=-1).mean(axis=0)).astype(np.float32)


def compute_radius_of_gyration(coords: np.ndarray,
                               mask: Optional[np.ndarray] = None) -> float:
    if mask is not None:
        coords = coords[mask.astype(bool)]
    if len(coords) == 0:
        return 0.0
    center = coords.mean(axis=0)
    return float(np.sqrt(((coords - center) ** 2).sum() / len(coords)))


def expected_rg(length: int) -> float:
    """Empirical globular-protein expectation 2.2 * L^0.38 Å."""
    return 2.2 * (length ** 0.38)


def compute_contact_map(coords: np.ndarray, cutoff: float = 8.0) -> np.ndarray:
    """CA contact map at ``cutoff``, excluding self and |i−j| ≤ 1."""
    L = len(coords)
    d = _cdist(coords, coords)
    sep = np.abs(np.arange(L)[:, None] - np.arange(L)[None, :])
    d[sep <= 1] = np.inf
    return d < cutoff


def contact_map_overlap(contact_pred: np.ndarray, contact_true: np.ndarray
                        ) -> tuple[float, float, float]:
    """(precision, recall, F1) over off-diagonal entries."""
    off = ~np.eye(len(contact_true), dtype=bool)
    p, t = contact_pred[off], contact_true[off]
    tp = float((p & t).sum())
    fp = float((p & ~t).sum())
    fn = float((~p & t).sum())
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) > 0 else 0.0)
    return precision, recall, f1


def compute_ensemble_diversity(ensemble_coords: np.ndarray, device="cuda"
                               ) -> tuple[float, np.ndarray]:
    """Mean pairwise Kabsch RMSD + full [K, K] matrix.

    One batched battery (``ops.geometry.pairwise_kabsch_rmsd``, on
    ``device``) — the
    O(K²) sequential-SVD loop of reference
    ``validation_metrics.py:324-349`` (19,900 SVDs at K=200) is what it
    replaces.

    NOTE the reference's convention (validation_metrics.py:341:
    ``sqrt(((ci - cj_aligned)**2).mean())``): the mean runs over all 3L
    scalar components, i.e. per-COMPONENT RMSD = standard per-atom RMSD
    divided by sqrt(3). Diversity thresholds downstream (analyze CLI) are
    calibrated to that convention, so we match it here."""
    K = len(ensemble_coords)
    if K <= 1:
        return 0.0, np.zeros((K, K), np.float32)
    M = pairwise_kabsch_rmsd(torch.as_tensor(
        np.asarray(ensemble_coords, np.float32), device=device)).cpu().numpy()
    M /= np.float32(np.sqrt(3.0))   # per-atom -> reference per-component
    # exact zeros on the diagonal / symmetric by construction of the metric;
    # enforce them so downstream triu statistics are clean
    M = 0.5 * (M + M.T)
    np.fill_diagonal(M, 0.0)
    mean = float(M[np.triu_indices(K, k=1)].mean())
    return mean, M
