"""trRosetta-style pair features on the medoid conformer.

A numpy copy of the JAX package's ``dataprep/pair_features.py`` (no JAX there, but
the port keeps its own copy).

Vectorized re-implementation of reference ``prepare_data.py:329-412`` (a
Python O(L²) double loop): for residue pairs (i, j) —
  d      : CB-CB distance (virtual CB from backbone N/CA/C)
  omega  : dihedral CA(i)-CB(i)-CB(j)-CA(j)
  theta  : dihedral N(i)-CA(i)-CB(i)-CB(j)  (asymmetric)
  phi    : angle CA(i)-CB(i)-CB(j)
Invalid residues produce zeros with a pair mask.
"""

from __future__ import annotations

import numpy as np


def virtual_cb(n: np.ndarray, ca: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Idealized CB position from backbone frame (standard trRosetta recipe):
    CB = -0.58273431*a + 0.56802827*b - 0.54067466*c + CA, with
    b = CA-N, c = C-CA, a = b x c."""
    b = ca - n
    cc = c - ca
    a = np.cross(b, cc)
    return (-0.58273431 * a + 0.56802827 * b - 0.54067466 * cc + ca
            ).astype(np.float32)


def _dihedral_np(p0, p1, p2, p3, eps=1e-8):
    b1, b2, b3 = p1 - p0, p2 - p1, p3 - p2
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    n1 /= (np.linalg.norm(n1, axis=-1, keepdims=True) + eps)
    n2 /= (np.linalg.norm(n2, axis=-1, keepdims=True) + eps)
    b2u = b2 / (np.linalg.norm(b2, axis=-1, keepdims=True) + eps)
    cos = np.clip((n1 * n2).sum(-1), -1.0, 1.0)
    sin = (np.cross(n1, n2) * b2u).sum(-1)
    return np.arctan2(sin, cos)


def _angle_np(a, b, c, eps=1e-8):
    ba = a - b
    bc = c - b
    ba /= (np.linalg.norm(ba, axis=-1, keepdims=True) + eps)
    bc /= (np.linalg.norm(bc, axis=-1, keepdims=True) + eps)
    return np.arccos(np.clip((ba * bc).sum(-1), -1.0, 1.0))


def compute_pair_features(n: np.ndarray, ca: np.ndarray, c: np.ndarray,
                          mask: np.ndarray) -> dict:
    """All-pairs features, fully vectorized. Returns dict of [L, L] arrays
    (d, omega, theta, phi) + pair_mask."""
    L = len(mask)
    cb = virtual_cb(n, ca, c)
    pm = (mask > 0.5)
    pair_mask = (pm[:, None] & pm[None, :]).astype(np.float32)
    np.fill_diagonal(pair_mask, 0.0)

    d = np.linalg.norm(cb[:, None] - cb[None, :], axis=-1).astype(np.float32)

    # broadcast endpoints to [L, L, 3]
    ca_i = np.broadcast_to(ca[:, None], (L, L, 3))
    ca_j = np.broadcast_to(ca[None, :], (L, L, 3))
    cb_i = np.broadcast_to(cb[:, None], (L, L, 3))
    cb_j = np.broadcast_to(cb[None, :], (L, L, 3))
    n_i = np.broadcast_to(n[:, None], (L, L, 3))

    omega = _dihedral_np(ca_i, cb_i, cb_j, ca_j).astype(np.float32)
    theta = _dihedral_np(n_i, ca_i, cb_i, cb_j).astype(np.float32)
    phi = _angle_np(ca_i, cb_i, cb_j).astype(np.float32)

    for arr in (d, omega, theta, phi):
        arr *= pair_mask
    return dict(d=d, omega=omega, theta=theta, phi=phi, pair_mask=pair_mask)
