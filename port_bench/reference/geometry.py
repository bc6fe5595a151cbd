"""Geometry for the reference, plain PyTorch: a frozen copy of the port's
``ops/geometry.py`` (NaN-safe norms, masked means, pairwise distances,
angles, backbone dihedrals, Kabsch superposition and the valid-first mask
compaction), so a later change to the port cannot move the yardstick.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

_EPS = 1e-8
_TINY = 1e-20

# Degeneracy floor for normalization denominators inside torsion math
# (bounded backward for near-collinear predicted coordinates; far below any
# real plane-normal norm of ~1-3 A^2).
_DEGEN = 1e-4


def safe_norm(x: Tensor, dim: int = -1, keepdim: bool = False) -> Tensor:
    """L2 norm with a NaN-free gradient at 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + _TINY)


def safe_normalize(x: Tensor, dim: int = -1, eps: float = 1e-4) -> Tensor:
    """``x / max(||x||, eps)``; eps 1e-4 bounds the backward at 1e4."""
    n = safe_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)


def pairwise_distances(a: Tensor, b: Tensor) -> Tensor:
    """Euclidean distances a [..., M, 3], b [..., N, 3] -> [..., M, N]:
    the direct difference, with 1e-12 under the sqrt for a finite gradient
    at d = 0."""
    diff = a[..., :, None, :] - b[..., None, :, :]
    return torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)


def angle_cos(a: Tensor, b: Tensor, c: Tensor, eps: float = _EPS) -> Tensor:
    """cos of the angle A-B-C at vertex B, clipped to [-1, 1];
    denominators floored at ``_DEGEN``."""
    ba = a - b
    bc = c - b
    ba = ba / torch.clamp(safe_norm(ba, keepdim=True) + eps, min=_DEGEN)
    bc = bc / torch.clamp(safe_norm(bc, keepdim=True) + eps, min=_DEGEN)
    return torch.clamp(torch.sum(ba * bc, dim=-1), -1.0, 1.0)


def wrap_angle(x: Tensor) -> Tensor:
    """Wrap to (-pi, pi]."""
    return torch.atan2(torch.sin(x), torch.cos(x))


def safe_atan2(y: Tensor, x: Tensor) -> Tensor:
    """atan2 with a finite gradient at (0, 0): there x = 1 and y = 0 are
    substituted (same value 0, zero gradient). Undefined torsions are
    stored as (sin, cos) = (0, 0)."""
    both_zero = (torch.abs(x) + torch.abs(y)) < 1e-12
    x_safe = torch.where(both_zero, torch.ones_like(x), x)
    y_safe = torch.where(both_zero, torch.zeros_like(y), y)
    return torch.atan2(y_safe, x_safe)


# ---------------------------------------------------------------------------
# Dihedrals
# ---------------------------------------------------------------------------

def dihedral_from_four(p0: Tensor, p1: Tensor, p2: Tensor, p3: Tensor,
                       eps: float = _EPS) -> tuple[Tensor, Tensor]:
    """Torsion angle defined by four points -> (sin, cos), each [...].

    Plane normals from cross products; degenerate (collinear) cases return
    (0, 1). Denominators are floored at ``_DEGEN``, and (sin, cos) are the
    two components of one rotation, self-normalised as a pair.
    """
    b1 = p1 - p0
    b2 = p2 - p1
    b3 = p3 - p2

    n1 = torch.cross(b1, b2, dim=-1)
    n2 = torch.cross(b2, b3, dim=-1)

    n1_norm = safe_norm(n1, keepdim=True)
    n2_norm = safe_norm(n2, keepdim=True)
    valid = (n1_norm[..., 0] > eps) & (n2_norm[..., 0] > eps)
    v = valid[..., None]

    zero = torch.zeros((), dtype=p0.dtype, device=p0.device)
    n1_u = torch.where(v, n1 / torch.clamp(n1_norm + eps, min=_DEGEN), zero)
    n2_u = torch.where(v, n2 / torch.clamp(n2_norm + eps, min=_DEGEN), zero)
    b2_norm = safe_norm(b2, keepdim=True)
    b2_u = torch.where(v, b2 / torch.clamp(b2_norm + eps, min=_DEGEN), zero)

    c_raw = torch.sum(n1_u * n2_u, dim=-1)
    s_raw = torch.sum(torch.cross(n1_u, n2_u, dim=-1) * b2_u, dim=-1)
    r = torch.sqrt(s_raw * s_raw + c_raw * c_raw + eps)
    sin_a = s_raw / torch.clamp(r, min=eps)
    cos_a = c_raw / torch.clamp(r, min=eps)

    sin_out = torch.where(valid, sin_a, zero)
    cos_out = torch.where(valid, cos_a, torch.ones_like(cos_a))
    return sin_out, cos_out


def dihedrals_from_coords(n: Tensor, ca: Tensor, c: Tensor,
                          mask: Tensor) -> Tensor:
    """Backbone phi/psi/omega from N/CA/C -> [B, L, 6] sin/cos.

      [:, i, 0:2] = phi(i)   from C(i-1), N(i), CA(i), C(i)     (i >= 1)
      [:, i, 2:4] = psi(i)   from N(i), CA(i), C(i), N(i+1)     (i <= L-2)
      [:, i, 4:6] = omega(i) from CA(i-1), C(i-1), N(i), CA(i)  (i >= 1)
    Undefined or pair-invalid positions are (0, 0).
    """
    B, L, _ = ca.shape
    out = torch.zeros((B, L, 6), dtype=ca.dtype, device=ca.device)
    if L < 2:
        return out

    m = mask.bool()
    pair = m[:, :-1] & m[:, 1:]
    zero = torch.zeros((), dtype=ca.dtype, device=ca.device)

    phi_sin, phi_cos = dihedral_from_four(c[:, :-1], n[:, 1:], ca[:, 1:], c[:, 1:])
    out[:, 1:, 0] = torch.where(pair, phi_sin, zero)
    out[:, 1:, 1] = torch.where(pair, phi_cos, zero)

    psi_sin, psi_cos = dihedral_from_four(n[:, :-1], ca[:, :-1], c[:, :-1], n[:, 1:])
    out[:, :-1, 2] = torch.where(pair, psi_sin, zero)
    out[:, :-1, 3] = torch.where(pair, psi_cos, zero)

    om_sin, om_cos = dihedral_from_four(ca[:, :-1], c[:, :-1], n[:, 1:], ca[:, 1:])
    out[:, 1:, 4] = torch.where(pair, om_sin, zero)
    out[:, 1:, 5] = torch.where(pair, om_cos, zero)
    return out


# ---------------------------------------------------------------------------
# Kabsch superposition
# ---------------------------------------------------------------------------

def kabsch_align(P: Tensor, Q: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Optimally rotate+translate P onto Q ([..., L, 3] each, batched over
    leading dims); returns aligned P. ``mask`` [..., L] restricts the fit to
    valid residues while transforming all points. SVD with reflection fix."""
    if mask is None:
        w = torch.ones(P.shape[:-1], dtype=P.dtype, device=P.device)
    else:
        w = mask.to(P.dtype).expand(P.shape[:-1])
    wsum = torch.clamp(w.sum(-1), min=1.0)[..., None, None]
    p_cent = (P * w[..., None]).sum(-2, keepdim=True) / wsum
    q_cent = (Q * w[..., None]).sum(-2, keepdim=True) / wsum
    Pc = (P - p_cent) * w[..., None]
    Qc = (Q - q_cent) * w[..., None]

    H = Pc.transpose(-1, -2) @ Qc
    U, _, Vt = torch.linalg.svd(H, full_matrices=False)
    V = Vt.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    D = torch.diag_embed(torch.stack(
        [torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = V @ D @ Ut
    return (P - p_cent) @ R.transpose(-1, -2) + q_cent


def kabsch_rmsd(P: Tensor, Q: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """RMSD after optimal superposition; masked residues excluded."""
    P_aln = kabsch_align(P, Q, mask)
    sq = torch.sum((P_aln - Q) ** 2, dim=-1)
    if mask is None:
        return torch.sqrt(sq.mean(-1))
    w = mask.to(P.dtype).expand(sq.shape)
    return torch.sqrt((sq * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0))


def pairwise_kabsch_rmsd(X: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """[K, L, 3] ensemble -> [K, K] RMSD matrix, one batched Kabsch."""
    K = X.shape[0]
    ii, jj = torch.meshgrid(torch.arange(K, device=X.device),
                            torch.arange(K, device=X.device), indexing="ij")
    flat = kabsch_rmsd(X[ii.reshape(-1)], X[jj.reshape(-1)], mask)
    return flat.reshape(K, K)


# ---------------------------------------------------------------------------
# Mask compaction (valid-first permutation for the banded decoder)
# ---------------------------------------------------------------------------

def compact_valid(mask: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Stable valid-first permutation per batch row.

    mask [B, L] (0/1) -> (pos, inv_pos, cmask):
      pos  [B, L] original index of the r-th valid residue (invalid at tail)
      inv_pos [B, L] inverse permutation (for scattering back)
      cmask [B, L] compacted validity = 1 for r < n_valid
    """
    valid = mask > 0.5
    pos = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    inv_pos = torch.argsort(pos, dim=-1, stable=True)
    cmask = torch.gather(mask.to(torch.float32), -1, pos)
    return pos, inv_pos, cmask


def scatter_compact(x: Tensor, inv_pos: Tensor, mask: Tensor) -> Tensor:
    """Undo ``compact_valid``: gather with the inverse permutation and zero
    padded positions. x [B, L, ...], inv_pos [B, L], mask [B, L]."""
    idx = inv_pos.reshape(inv_pos.shape + (1,) * (x.ndim - 2))
    idx = idx.expand(inv_pos.shape + x.shape[2:])
    out = torch.gather(x, 1, idx)
    m = mask.reshape(mask.shape + (1,) * (x.ndim - 2))
    return out * m.to(x.dtype)
