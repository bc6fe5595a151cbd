"""Ramachandran angle extraction and region classification.

``phi_psi_from_backbone`` computes true backbone phi/psi from N/CA/C
(reference ``analyze_ensemble.py:105-147`` uses its own dihedral code; we
reuse the shared geometry core, on ``device``). A copy of the JAX
package's ``eval/ramachandran.py``.

``classify_ramachandran`` reproduces the reference's classification
*exactly*: despite the "Lovell et al. 2003" attribution in its docstring, the
reference classifies with hand-set rectangular regions — MDAnalysis is used
only to extract the angles (analyze_ensemble.py:150-200; the boxes are at
:176-190). Same boxes here, vectorized, so favored/allowed/outlier fractions
are directly comparable with BASELINE.md's quality numbers.

``classify_ramachandran_elliptical`` keeps the round-1 elliptical basins that
mirror the training-time Ramachandran loss (losses.py:72-131) — useful when
train/eval agreement on "good" matters more than reference parity.
"""

from __future__ import annotations

import numpy as np
import torch

from protein_ensemble_vae_torch.ops.geometry import dihedrals_from_coords

# (phi0, psi0, favored radius scale, allowed radius scale) in radians.
_BASINS = (
    (-1.05, -0.79, 0.6, 1.2),   # alpha helix
    (-2.09, 2.09, 0.9, 1.6),    # beta sheet
    (1.05, 0.79, 0.45, 0.9),    # left-handed alpha
    (-1.31, 2.53, 0.5, 1.0),    # polyproline II
)


def phi_psi_from_backbone(n: np.ndarray, ca: np.ndarray, c: np.ndarray,
                          mask: np.ndarray, device="cuda"
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (phi, psi, valid) each [L]; angles in radians; valid where
    both dihedrals are defined. The dihedrals run on ``device``."""
    d = dihedrals_from_coords(*(
        torch.as_tensor(np.asarray(a, np.float32)[None], device=device)
        for a in (n, ca, c, mask)))[0].cpu().numpy()
    phi = np.arctan2(d[:, 0], d[:, 1])
    psi = np.arctan2(d[:, 2], d[:, 3])
    valid = mask.astype(bool).copy()
    # phi undefined at first valid residue, psi at last: mark via zero sin/cos
    sin_cos_mag = (d[:, 0] ** 2 + d[:, 1] ** 2) * (d[:, 2] ** 2 + d[:, 3] ** 2)
    valid &= sin_cos_mag > 1e-6
    return phi, psi, valid


def classify_ramachandran(phi: np.ndarray, psi: np.ndarray,
                          valid: np.ndarray) -> dict:
    """Fraction of residues favored / allowed / outlier — the reference's
    rectangular regions (analyze_ensemble.py:176-190), evaluated in degrees:

    favored:  alpha  (-90 ≤ φ ≤ -30, -77 ≤ ψ ≤ -17)
              beta   (-180 ≤ φ ≤ -90, 90 ≤ ψ ≤ 180)
              L-alpha (30 ≤ φ ≤ 90, 0 ≤ ψ ≤ 90)
    allowed:  otherwise, any ψ with φ ≤ -30 or φ ≥ 30
    outlier:  the rest (the |φ| < 30 strip)
    """
    phi_d = np.degrees(phi[valid])
    psi_d = np.degrees(psi[valid])
    n = len(phi_d)
    if n == 0:
        return dict(favored=0.0, allowed=0.0, outlier=0.0, n=0)

    favored = (
        ((-90 <= phi_d) & (phi_d <= -30) & (-77 <= psi_d) & (psi_d <= -17))
        | ((-180 <= phi_d) & (phi_d <= -90) & (90 <= psi_d) & (psi_d <= 180))
        | ((30 <= phi_d) & (phi_d <= 90) & (0 <= psi_d) & (psi_d <= 90))
    )
    allowed_only = ~favored & (
        ((-180 <= phi_d) & (phi_d <= -30)) | ((30 <= phi_d) & (phi_d <= 180))
    )
    outlier = ~favored & ~allowed_only

    return dict(
        favored=float(favored.mean()),
        allowed=float(allowed_only.mean()),
        outlier=float(outlier.mean()),
        n=n,
    )


def _wrap_diff(a: np.ndarray, b: float) -> np.ndarray:
    d = a - b
    return np.arctan2(np.sin(d), np.cos(d))


def classify_ramachandran_elliptical(phi: np.ndarray, psi: np.ndarray,
                                     valid: np.ndarray) -> dict:
    """Elliptical-basin classification consistent with the training loss's
    Gaussian basins (alpha, beta, left-alpha, PPII)."""
    phi = phi[valid]
    psi = psi[valid]
    n = len(phi)
    if n == 0:
        return dict(favored=0.0, allowed=0.0, outlier=0.0, n=0)

    favored = np.zeros(n, bool)
    allowed = np.zeros(n, bool)
    for phi0, psi0, r_fav, r_alw in _BASINS:
        d2 = (_wrap_diff(phi, phi0) ** 2 + _wrap_diff(psi, psi0) ** 2)
        favored |= d2 < r_fav ** 2
        allowed |= d2 < r_alw ** 2
    allowed_only = allowed & ~favored
    outlier = ~allowed

    return dict(
        favored=float(favored.mean()),
        allowed=float(allowed_only.mean()),
        outlier=float(outlier.mean()),
        n=n,
    )
