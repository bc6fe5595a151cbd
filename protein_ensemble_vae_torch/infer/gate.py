"""Geometry gating for generated samples (vectorized).

Same acceptance rules as reference ``generate_ensemble_pdbs.py:290-340``:
consecutive-CA distance max < 6.0 Å, average in [2.5, 5.0] Å, and average
CA-CA-CA angle in [60°, 180°] — computed over valid residues only.
"""

from __future__ import annotations

import numpy as np


def validate_protein_geometry(coords_ca: np.ndarray, mask: np.ndarray
                              ) -> tuple[bool, str]:
    valid = mask > 0.5
    if not valid.any():
        return False, "No valid residues"
    pts = coords_ca[valid]

    if len(pts) > 1:
        d = np.linalg.norm(np.diff(pts, axis=0), axis=-1)
        max_d, avg_d = float(d.max()), float(d.mean())
        if max_d > 6.0:
            return False, f"Extreme CA-CA distance {max_d:.3f}A"
        if avg_d < 2.5 or avg_d > 5.0:
            return False, f"Abnormal average CA-CA distance {avg_d:.3f}A"

        if len(pts) > 2:
            v1 = pts[:-2] - pts[1:-1]
            v2 = pts[2:] - pts[1:-1]
            cos = (np.sum(v1 * v2, -1)
                   / (np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1)
                      + 1e-8))
            ang = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
            avg_a = float(ang.mean())
            if avg_a < 60 or avg_a > 180:
                return False, f"Abnormal average CA-CA-CA angle {avg_a:.1f}deg"

    return True, "Valid geometry"
