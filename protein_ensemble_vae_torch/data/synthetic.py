"""Synthetic H5 fixtures with the reference schema.

Replaces the RCSB download pipeline for tests and smoke training
(SURVEY §7.2 minimum slice): K noisy conformers of a helix-like backbone,
torsions computed with the same geometry code, optional fake ESM embeddings,
plus train/val manifest CSVs.
"""

from __future__ import annotations

import csv
import os
from typing import Optional, Sequence

import numpy as np

from protein_ensemble_vae_torch.config import AA_ORDER
from protein_ensemble_vae_torch.data.dataset import ESM_GROUP


def helix_backbone(L: int, rise: float = 1.5, radius: float = 2.3,
                   turn_deg: float = 100.0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Idealized helix-like N/CA/C backbone, each [L, 3] (float32)."""
    t = np.arange(L) * turn_deg * np.pi / 180.0
    ca = np.stack([radius * np.cos(t), radius * np.sin(t), rise * np.arange(L)], -1)
    tang = np.gradient(ca, axis=0)
    tang /= np.linalg.norm(tang, axis=-1, keepdims=True) + 1e-9
    up = np.array([0.0, 0.0, 1.0])
    side = np.cross(tang, up)
    side /= np.linalg.norm(side, axis=-1, keepdims=True) + 1e-9
    n = ca - 1.46 * (0.8 * tang + 0.6 * side)
    c = ca + 1.52 * (0.8 * tang - 0.6 * side)
    return (n.astype(np.float32), ca.astype(np.float32), c.astype(np.float32))


def compact_backbone(L: int, seed: int = 0
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compact globular-like backbone: a helix wound around a slow random
    walk so Rg ~ 2.2 L^0.38 instead of an extended rod. More realistic
    reconstruction difficulty for convergence tests."""
    rng = np.random.default_rng(seed)
    # smooth random-walk axis with bounded extent
    steps = rng.normal(0, 1, (L, 3))
    for _ in range(3):
        steps[1:] = 0.7 * steps[1:] + 0.3 * steps[:-1]  # smooth
    axis = np.cumsum(steps, axis=0)
    axis -= axis.mean(axis=0)
    target_rg = 2.2 * (L ** 0.38)
    rg = np.sqrt((axis ** 2).sum(-1).mean())
    axis *= 0.8 * target_rg / max(rg, 1e-6)
    # local helical decoration at CA-CA ~ 3.8 A spacing along the path
    t = np.arange(L) * 100.0 * np.pi / 180.0
    ca = axis + np.stack([2.3 * np.cos(t), 2.3 * np.sin(t),
                          np.zeros(L)], -1)
    # renormalize consecutive CA spacing toward 3.8 A
    for it in range(9):
        d = np.diff(ca, axis=0)
        norm = np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
        # damped passes smooth the path; the final pass is exact so the
        # ground truth sits well inside the generation gate's 6.0 A max
        # CA-CA threshold (infer/gate.py) instead of marginally at ~5.6 A.
        scale = 3.8 / norm if it == 8 else (0.5 + 0.5 * 3.8 / norm)
        d = d * scale
        ca = np.concatenate([ca[:1], ca[:1] + np.cumsum(d, axis=0)], axis=0)
    tang = np.gradient(ca, axis=0)
    tang /= np.linalg.norm(tang, axis=-1, keepdims=True) + 1e-9
    ref = np.array([0.12, 0.85, 0.51])
    side = np.cross(tang, ref)
    side /= np.linalg.norm(side, axis=-1, keepdims=True) + 1e-9
    n = ca - 1.46 * (0.8 * tang + 0.6 * side)
    c = ca + 1.52 * (0.8 * tang - 0.6 * side)
    return (n.astype(np.float32), ca.astype(np.float32), c.astype(np.float32))


def _nerf_place(a: np.ndarray, b: np.ndarray, c: np.ndarray, bond: float,
                angle_deg: float, torsion_rad: float) -> np.ndarray:
    """Place atom D from internal coordinates: |CD| = bond, angle(B,C,D) =
    angle_deg, dihedral(A,B,C,D) = torsion_rad (natural-extension reference
    frame; sign convention validated against ops.geometry.dihedrals_from_coords
    in tests/test_synthetic_nerf.py)."""
    ang = np.radians(angle_deg)
    bc = c - b
    bc = bc / (np.linalg.norm(bc) + 1e-12)
    nrm = np.cross(b - a, bc)
    nrm = nrm / (np.linalg.norm(nrm) + 1e-12)
    m = np.cross(nrm, bc)
    d_local = np.array([-bond * np.cos(ang),
                        bond * np.sin(ang) * np.cos(torsion_rad),
                        bond * np.sin(ang) * np.sin(torsion_rad)])
    return c + d_local[0] * bc + d_local[1] * m + d_local[2] * nrm


def torsion_backbone(phi: np.ndarray, psi: np.ndarray,
                     omega: Optional[np.ndarray] = None
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build an ideal-covalent-geometry N/CA/C backbone from torsions.

    Uses the exact bond lengths / angles the loss battery targets
    (config.BOND_* / ANGLE_*; reference losses.py:318-408), trans peptide
    omega = pi unless given, so the built chain scores ~zero on every
    covalent-geometry metric by construction. phi[0] is unused (undefined
    at the N-terminus), psi[L-1] only orients the final C.
    """
    from protein_ensemble_vae_torch.config import (ANGLE_C_N_CA_DEG,
                                                 ANGLE_CA_C_N_DEG,
                                                 ANGLE_N_CA_C_DEG, BOND_C_N,
                                                 BOND_CA_C, BOND_N_CA)
    L = len(phi)
    if omega is None:
        omega = np.full(L, np.pi)
    n = np.zeros((L, 3))
    ca = np.zeros((L, 3))
    c = np.zeros((L, 3))
    n[0] = (0.0, 0.0, 0.0)
    ca[0] = (BOND_N_CA, 0.0, 0.0)
    ang0 = np.radians(ANGLE_N_CA_C_DEG)
    c[0] = ca[0] + BOND_CA_C * np.array([-np.cos(ang0), np.sin(ang0), 0.0])
    for i in range(L - 1):
        n[i + 1] = _nerf_place(n[i], ca[i], c[i], BOND_C_N,
                               ANGLE_CA_C_N_DEG, psi[i])
        ca[i + 1] = _nerf_place(ca[i], c[i], n[i + 1], BOND_N_CA,
                                ANGLE_C_N_CA_DEG, omega[i])
        c[i + 1] = _nerf_place(c[i], n[i + 1], ca[i + 1], BOND_CA_C,
                               ANGLE_N_CA_C_DEG, phi[i + 1])
    return (n.astype(np.float32), ca.astype(np.float32), c.astype(np.float32))


# Favored-basin centers (deg) inside the reference's rectangular regions
# (eval/ramachandran.py boxes <- analyze_ensemble.py:176-190): alpha helix
# and the beta strand used for connecting loops.
_ALPHA = (-63.0, -43.0)
_BETA = (-120.0, 140.0)


def _sample_fold_torsions(L: int, rng: np.random.Generator
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Helix/loop segment layout with per-residue jitter; returns
    (phi, psi) in radians plus the per-residue loop flag (for noising)."""
    phi = np.empty(L)
    psi = np.empty(L)
    is_loop = np.zeros(L, bool)
    i, helix = 0, True
    while i < L:
        seg = int(rng.integers(10, 18)) if helix else int(rng.integers(3, 6))
        seg = min(seg, L - i)
        (ph0, ps0), jit = (_ALPHA, 3.0) if helix else (_BETA, 8.0)
        phi[i:i + seg] = ph0 + rng.normal(0, jit, seg)
        psi[i:i + seg] = ps0 + rng.normal(0, jit, seg)
        is_loop[i:i + seg] = not helix
        i += seg
        helix = not helix
    return np.radians(phi), np.radians(psi), is_loop


def _min_nonlocal_dist(n: np.ndarray, ca: np.ndarray, c: np.ndarray,
                       min_sep: int = 2) -> float:
    """Minimum distance between backbone atoms >= min_sep residues apart."""
    L = ca.shape[0]
    atoms = np.stack([n, ca, c], axis=1).reshape(-1, 3)
    res = np.repeat(np.arange(L), 3)
    d = np.linalg.norm(atoms[:, None] - atoms[None, :], axis=-1)
    far = np.abs(res[:, None] - res[None, :]) >= min_sep
    return float(d[far].min()) if far.any() else np.inf


def nerf_ensemble(L: int, K: int, seed: int = 0, scale: float = 1.0,
                  clash_floor: float = 3.05, max_tries: int = 64
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """K torsion-built conformers of one physically valid fold, each [L,3]x3.

    The base fold is rejection-sampled to be free of steric overlap
    (every backbone atom pair >= 2 residues apart further than
    ``clash_floor`` = 3.05 A — above the worst-case MolProbity clash
    threshold for backbone atoms, 1.70 + 1.70 - 0.4); conformers add
    favored-basin torsion noise (helix sd 1.5 deg, loop sd 5 deg, x scale)
    and are re-sampled under the same no-clash rule, then Kabsch-aligned
    onto the base. Ground truth built this way passes every BASELINE.md
    post-fix target (exact bonds/angles, trans omega, ~100 % favored,
    ~0 MolProbity-style clashscore), unlike the ``compact`` decorated
    random walk — so generation-quality metrics trained/evaluated on it
    measure the model, not the fixture.
    """
    rng = np.random.default_rng(seed)
    base = None
    best_rg = np.inf
    for _ in range(max_tries):
        phi, psi, is_loop = _sample_fold_torsions(L, rng)
        n0, ca0, c0 = torsion_backbone(phi, psi)
        if _min_nonlocal_dist(n0, ca0, c0) <= clash_floor:
            continue
        rg = float(np.sqrt(((ca0 - ca0.mean(0)) ** 2).sum(-1).mean()))
        if rg < best_rg:
            base = (phi, psi, is_loop, n0, ca0, c0)
            best_rg = rg
    if base is None:
        raise RuntimeError(f"no clash-free fold found in {max_tries} tries "
                           f"(L={L}, seed={seed})")
    phi, psi, is_loop, n0, ca0, c0 = base
    sd = np.where(is_loop, 5.0, 1.5) * scale * np.pi / 180.0

    coords = []
    for k in range(K):
        if k == 0:
            coords.append((n0, ca0, c0))
            continue
        for _ in range(max_tries):
            dphi = rng.normal(0, sd)
            dpsi = rng.normal(0, sd)
            nk, cak, ck = torsion_backbone(phi + dphi, psi + dpsi)
            if _min_nonlocal_dist(nk, cak, ck) > clash_floor:
                break
        else:
            raise RuntimeError("no clash-free conformer; lower `scale`")
        # one rigid CA-fit Kabsch transform applied to all three atom sets
        mu_m, mu_t = cak.mean(0), ca0.mean(0)
        H = (cak - mu_m).T @ (ca0 - mu_t)
        U, _, Vt = np.linalg.svd(H)
        if np.linalg.det(Vt.T @ U.T) < 0:
            Vt = Vt.copy()
            Vt[-1, :] *= -1
        R = Vt.T @ U.T
        coords.append(tuple((x - mu_m) @ R.T + mu_t for x in (nk, cak, ck)))
    n = np.stack([x[0] for x in coords]).astype(np.float32)
    ca = np.stack([x[1] for x in coords]).astype(np.float32)
    c = np.stack([x[2] for x in coords]).astype(np.float32)
    return n, ca, c


def _torsions_np(n, ca, c, mask):
    """Host-side torsion computation (ops.geometry on CPU tensors)."""
    import torch

    from protein_ensemble_vae_torch.ops.geometry import dihedrals_from_coords

    d = dihedrals_from_coords(*(torch.from_numpy(np.asarray(v, np.float32)[None])
                                for v in (n, ca, c, mask)))
    return d[0].numpy()


def write_synthetic_h5(path: str, K: int = 5, L: int = 64, seed: int = 0,
                       noise: float = 0.3, seqemb_dim: Optional[int] = None,
                       mask_holes: Sequence[int] = (),
                       fold: str = "helix") -> str:
    """Write one synthetic protein ensemble H5 with the reference schema.
    fold: "helix" (extended rod), "compact" (globular-like Rg, heuristic
    N/C placement) or "nerf" (torsion-built, physically valid covalent
    geometry — the fold that makes BASELINE.md's post-fix generation
    targets honestly scoreable; `noise` rescales the torsion jitter)."""
    from protein_ensemble_vae_torch.data import h5file

    rng = np.random.default_rng(seed)
    mask = np.ones(L, np.float32)
    for h in mask_holes:
        mask[h] = 0.0

    coords_n = np.zeros((K, L, 3), np.float32)
    coords_ca = np.zeros((K, L, 3), np.float32)
    coords_c = np.zeros((K, L, 3), np.float32)
    phi = np.zeros((K, L, 2), np.float32)
    psi = np.zeros((K, L, 2), np.float32)
    omega = np.zeros((K, L, 2), np.float32)
    if fold == "nerf":
        coords_n, coords_ca, coords_c = nerf_ensemble(
            L, K, seed=seed, scale=noise / 0.3)
    else:
        if fold == "compact":
            n0, ca0, c0 = compact_backbone(L, seed=seed)
        else:
            n0, ca0, c0 = helix_backbone(L)
        for k in range(K):
            d = rng.normal(0, noise, (L, 3)).astype(np.float32)
            coords_n[k] = n0 + d
            coords_ca[k] = ca0 + d
            coords_c[k] = c0 + d
    for k in range(K):
        dih = _torsions_np(coords_n[k], coords_ca[k], coords_c[k], mask)
        phi[k] = dih[:, 0:2]
        psi[k] = dih[:, 2:4]
        omega[k] = dih[:, 4:6]

    sequence = "".join(rng.choice(list(AA_ORDER), L))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5file.File(path, "w") as fh:
        fh.create_dataset("coords_N", data=coords_n)
        fh.create_dataset("coords_ca", data=coords_ca)
        fh.create_dataset("coords_C", data=coords_c)
        fh.create_dataset("mask_ca", data=np.tile(mask, (K, 1)))
        fh.create_dataset("torsion_phi_sincos", data=phi)
        fh.create_dataset("torsion_psi_sincos", data=psi)
        fh.create_dataset("torsion_omega_sincos", data=omega)
        fh.create_dataset("sequence", data=sequence)
        if seqemb_dim:
            emb = rng.normal(0, 1, (L, seqemb_dim)).astype(np.float32)
            fh.create_dataset(ESM_GROUP, data=emb, compression="gzip")
    return path


def make_synthetic_dataset(root: str, n_proteins: int = 2, K: int = 4,
                           lengths: Sequence[int] = (48, 64),
                           seqemb_dim: Optional[int] = 32,
                           seed: int = 0, fold: str = "helix",
                           noise: float = 0.3) -> tuple[str, str]:
    """Write n_proteins H5 files + train/val manifests; returns their paths."""
    os.makedirs(root, exist_ok=True)
    h5_paths = []
    for i in range(n_proteins):
        L = lengths[i % len(lengths)]
        p = os.path.join(root, f"syn{i:03d}_nmr.h5")
        write_synthetic_h5(p, K=K, L=L, seed=seed + i, seqemb_dim=seqemb_dim,
                           fold=fold, noise=noise)
        h5_paths.append(p)

    train_csv = os.path.join(root, "manifest_train.csv")
    val_csv = os.path.join(root, "manifest_val.csv")
    for csv_path, paths in ((train_csv, h5_paths), (val_csv, h5_paths[:1])):
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["h5_path"])
            for p in paths:
                w.writerow([p])
    return train_csv, val_csv
