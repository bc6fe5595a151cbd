"""Ensemble alignment utilities for dataset preparation.

A numpy copy of the JAX package's ``dataprep/align.py`` (no JAX there, but
the port keeps its own copy).

- ``medoid_index``: medoid conformer by pairwise Kabsch RMSD
  (prepare_data.py:25-59)
- ``core_fit_align``: medoid -> per-residue-variance core detection ->
  realign all conformers on the core (prepare_data.py:62-133,896-922)
- ``compute_rmsf_ensemble``: per-residue RMSF after alignment
- ``needleman_wunsch``: global alignment with BLOSUM62 for cross-PDB
  conformer mapping (prepare_data.py:557-824 uses pairwise2.global*)
"""

from __future__ import annotations

import numpy as np

# BLOSUM62 over the canonical 20 AAs (public substitution matrix).
_AA = "ARNDCQEGHILKMFPSTWYV"
_B62 = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4
"""
BLOSUM62 = {(_AA[i], _AA[j]): int(v)
            for i, row in enumerate(_B62.strip().split("\n"))
            for j, v in enumerate(row.split())}


def _kabsch_rt(P: np.ndarray, Q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rotation R and translation t such that P @ R.T + t ~= Q."""
    pc, qc = P.mean(0), Q.mean(0)
    H = (P - pc).T @ (Q - qc)
    U, _, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        Vt = Vt.copy()
        Vt[-1] *= -1
        R = Vt.T @ U.T
    return R, qc - pc @ R.T


def _kabsch_rmsd_np(P: np.ndarray, Q: np.ndarray) -> float:
    R, t = _kabsch_rt(P, Q)
    return float(np.sqrt(((P @ R.T + t - Q) ** 2).sum(-1).mean()))


def pairwise_rmsd_matrix(coords: np.ndarray, mask: np.ndarray,
                         min_common: int = 8) -> np.ndarray:
    """K×K Kabsch-RMSD matrix over per-pair common valid residues; NaN for
    pairs sharing fewer than ``min_common`` residues, 0 diagonal (reference
    prepare_data.py:25-45, incl. the min_common=8 default)."""
    K = coords.shape[0]
    valid = mask > 0.5
    D = np.full((K, K), np.nan, np.float64)
    for i in range(K):
        for j in range(i + 1, K):
            common = valid[i] & valid[j]
            if common.sum() >= min_common:
                D[i, j] = D[j, i] = _kabsch_rmsd_np(coords[i, common],
                                                    coords[j, common])
    np.fill_diagonal(D, 0.0)
    return D


def medoid_index(coords: np.ndarray, mask: np.ndarray,
                 min_common: int = 8) -> int:
    """Medoid conformer = argmin over rows of the nan-mean pairwise RMSD
    (reference choose_medoid, prepare_data.py:48-59). coords [K, L, 3]."""
    if coords.shape[0] == 1:
        return 0
    D = pairwise_rmsd_matrix(coords, mask, min_common=min_common)
    with np.errstate(invalid="ignore"):
        means = np.nanmean(D, axis=1)
    if np.all(np.isnan(means)):
        return 0
    return int(np.nanargmin(means))


def _medoid_fits(ca: np.ndarray, mask: np.ndarray, med: int,
                 use_mask: np.ndarray | None = None
                 ) -> list[tuple[np.ndarray, np.ndarray] | None]:
    """Per-model rigid fit (R, t) of CA[k] onto CA[med] over the common valid
    residues (∩ use_mask); None (identity) when < 3 common residues — the
    reference's align_to_reference fit rule (prepare_data.py:62-81)."""
    valid = mask > 0.5
    fit_ref = valid[med] if use_mask is None else (valid[med] & use_mask)
    fits: list[tuple[np.ndarray, np.ndarray] | None] = []
    for k in range(ca.shape[0]):
        common = fit_ref & valid[k]
        if common.sum() >= 3:
            fits.append(_kabsch_rt(ca[k, common], ca[med, common]))
        else:
            fits.append(None)
    return fits


def detect_core(coords_aligned: np.ndarray, mask: np.ndarray,
                core_frac: float = 0.7, min_core_len: int = 30) -> np.ndarray:
    """Core residues = lowest per-residue nan-variance across aligned models,
    among residues present in a majority of models; core size =
    max(min_core_len, ceil(core_frac · n_eligible)) (reference
    detect_core_mask, prepare_data.py:84-113, incl. the 0.7/30 defaults)."""
    K, L, _ = coords_aligned.shape
    valid = mask > 0.5
    present = valid.sum(axis=0)
    eligible = present >= (K // 2 + 1)
    if not eligible.any():
        return present > 0

    arr = coords_aligned.astype(np.float64).copy()
    arr[~valid] = np.nan
    with np.errstate(invalid="ignore"):
        var_score = np.nansum(np.nanvar(arr, axis=0), axis=1)    # [L]

    idx_eligible = np.where(eligible)[0]
    n_core = max(min_core_len, int(np.ceil(core_frac * idx_eligible.size)))
    order = idx_eligible[np.argsort(var_score[idx_eligible])]
    core = np.zeros(L, bool)
    core[order[:n_core]] = True
    return core


def core_fit_align(coords_n: np.ndarray, coords_ca: np.ndarray,
                   coords_c: np.ndarray, mask: np.ndarray,
                   core_frac: float = 0.7, min_core_len: int = 30,
                   min_common: int = 8
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, np.ndarray]:
    """Medoid -> provisional all-common CA alignment -> low-variance core
    detection -> final core fit of the *original* coords, applied rigidly to
    N/CA/C (reference align_core_fit + align_backbone_to_reference,
    prepare_data.py:116-133,897-922). Returns (n, ca, c, medoid_idx, core)."""
    med = medoid_index(coords_ca, mask, min_common=min_common)

    # Pass 1 (CA only): provisional alignment on all common residues, used
    # solely to measure per-residue variance for core detection.
    ca0 = coords_ca.copy()
    for k, fit in enumerate(_medoid_fits(coords_ca, mask, med)):
        if fit is not None:
            ca0[k] = coords_ca[k] @ fit[0].T + fit[1]
    core = detect_core(ca0, mask, core_frac=core_frac,
                       min_core_len=min_core_len)

    # Pass 2: fit the ORIGINAL CA on the core; carry N and C through the same
    # rigid transform (the reference recomputes from originals, not from the
    # provisional alignment).
    n, ca, c = coords_n.copy(), coords_ca.copy(), coords_c.copy()
    for k, fit in enumerate(_medoid_fits(coords_ca, mask, med, core)):
        if fit is not None:
            R, t = fit
            n[k] = coords_n[k] @ R.T + t
            ca[k] = coords_ca[k] @ R.T + t
            c[k] = coords_c[k] @ R.T + t
    return n, ca, c, med, core


def compute_rmsf_ensemble(coords_ca: np.ndarray, mask: np.ndarray,
                          use_mask: np.ndarray | None = None) -> np.ndarray:
    """Per-residue RMSF across (already aligned) models, nan-aware over
    missing residues; optionally restricted to ``use_mask`` (reference
    compute_rmsf_core, prepare_data.py:136-155)."""
    arr = coords_ca.astype(np.float64).copy()
    valid = mask > 0.5
    if use_mask is not None:
        valid = valid & use_mask[None, :]
    arr[~valid] = np.nan
    with np.errstate(invalid="ignore"):
        mean = np.nanmean(arr, axis=0)                           # [L, 3]
        sq = np.nansum((arr - mean) ** 2, axis=2)                # [K, L]
        rmsf = np.sqrt(np.nanmean(sq, axis=0))                   # [L]
    return np.nan_to_num(rmsf).astype(np.float32)


def needleman_wunsch(a: str, b: str, gap_open: float = -10.0,
                     gap_extend: float = -0.5
                     ) -> tuple[float, list[tuple[int, int]]]:
    """Global alignment with BLOSUM62 + affine-ish gaps (simplified to
    linear with open cost on first gap column). Returns (score, list of
    aligned index pairs (i, j))."""
    n, m = len(a), len(b)
    NEG = -1e9
    score = np.full((n + 1, m + 1), 0.0)
    ptr = np.zeros((n + 1, m + 1), np.int8)  # 0 diag, 1 up(a gap in b), 2 left
    for i in range(1, n + 1):
        score[i, 0] = gap_open + gap_extend * (i - 1)
        ptr[i, 0] = 1
    for j in range(1, m + 1):
        score[0, j] = gap_open + gap_extend * (j - 1)
        ptr[0, j] = 2
    for i in range(1, n + 1):
        ai = a[i - 1]
        for j in range(1, m + 1):
            s = BLOSUM62.get((ai, b[j - 1]), -4)
            diag = score[i - 1, j - 1] + s
            up = score[i - 1, j] + (gap_extend if ptr[i - 1, j] == 1 else gap_open)
            left = score[i, j - 1] + (gap_extend if ptr[i, j - 1] == 2 else gap_open)
            best = max(diag, up, left)
            score[i, j] = best
            ptr[i, j] = 0 if best == diag else (1 if best == up else 2)
    pairs = []
    i, j = n, m
    while i > 0 or j > 0:
        p = ptr[i, j]
        if i > 0 and j > 0 and p == 0:
            pairs.append((i - 1, j - 1))
            i -= 1
            j -= 1
        elif i > 0 and (p == 1 or j == 0):
            i -= 1
        else:
            j -= 1
    pairs.reverse()
    return float(score[n, m]), pairs


def alignment_identity_coverage(a: str, b: str,
                                pairs: list[tuple[int, int]]
                                ) -> tuple[float, float]:
    """(identity over aligned pairs, coverage of sequence a)."""
    if not pairs:
        return 0.0, 0.0
    ident = sum(1 for i, j in pairs if a[i] == b[j]) / len(pairs)
    cov = len(pairs) / max(len(a), 1)
    return ident, cov
