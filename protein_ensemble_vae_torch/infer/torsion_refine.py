"""Torsion-space (NeRF-manifold) refinement of sampled backbones
(counterpart of the JAX package's ``infer/torsion_refine.py``).

The sample is projected onto the ideal-covalent-geometry manifold (torsions
extracted with the differentiable ``dihedrals_from_coords``, the chain
rebuilt by natural extension of reference frames with the exact
``config.BOND_*`` / ``ANGLE_*`` constants the losses target), and Adam
then optimizes the TORSIONS. Bond lengths and angles are ideal by
construction at every iterate, so the only energy terms are the vdW clash
surrogate, the Ramachandran / trans-omega basins and a soft anchor on the
CAs.

The rebuild is a prefix product of rigid transforms (pNeRF: AlQuraishi,
"Parallelized Natural Extension Reference Frame", J. Comput. Chem. 2019),
not a loop over residues. Placing atom D from (A, B, C) is ``C + R v``,
where R = [bc, nrm x bc, nrm] is the frame of (A, B, C) and v depends only
on (bond, angle, torsion); the frame of (B, C, D) is then ``R R_local``
with R_local a rotation of (angle, torsion) alone. So every frame is the
seed's frame times a cumulative product of the 3(L - 1) local rotations,
which takes ceil(log2 3L) rounds of batched 3x3 products, and the atoms
are the seed's C plus a cumulative sum of the placed bond vectors. The
frames are composed and the positions summed in float64, so the ~11
rounds and the long sum add no drift of their own beyond the final
rounding to the input dtype; the 3x3 products are elementwise
multiply-adds, not a GEMM library's (``scripts/nerf_rebuild_ab.py``
measures both, and float32 composition). A degenerate seed (residue 0 masked at the
origin) gives a zero frame, and a zero frame stays zero, so the chain
collapses there as the sequential build's does.

``nerf_rebuild_reference`` keeps the sequential build (three ``_place``
calls per residue) as the plain version the tests hold the scan against.
"""

from __future__ import annotations

import functools
import math

import torch

from protein_ensemble_vae_torch import losses as L
from protein_ensemble_vae_torch.config import (ANGLE_C_N_CA_DEG,
                                               ANGLE_CA_C_N_DEG,
                                               ANGLE_N_CA_C_DEG, BOND_C_N,
                                               BOND_CA_C, BOND_N_CA)
from protein_ensemble_vae_torch.infer.refine import adam_descent
from protein_ensemble_vae_torch.ops.geometry import (_DEGEN,
                                                     dihedrals_from_coords,
                                                     safe_atan2, safe_norm)

Tensor = torch.Tensor

# The three placements that extend the chain by one residue, in order:
# (bond, angle at the middle atom) for N(i+1), CA(i+1), C(i+1).
_STEPS = ((BOND_C_N, ANGLE_CA_C_N_DEG), (BOND_N_CA, ANGLE_C_N_CA_DEG),
          (BOND_CA_C, ANGLE_N_CA_C_DEG))


def _unit(v: Tensor) -> Tensor:
    return v / torch.clamp(safe_norm(v, keepdim=True), min=_DEGEN)


def _place(a: Tensor, b: Tensor, c: Tensor, bond: float, angle_deg: float,
           torsion: Tensor) -> Tensor:
    """Place atom D from internal coordinates (batched over leading dims):
    |CD| = bond, angle(B,C,D) = angle_deg, dihedral(A,B,C,D) = torsion;
    denominators floored for bounded gradients on degenerate geometry."""
    ang = math.radians(angle_deg)
    bc = _unit(c - b)
    nrm = _unit(torch.cross(b - a, bc, dim=-1))
    m = torch.cross(nrm, bc, dim=-1)
    d0 = -bond * math.cos(ang)
    d1 = bond * math.sin(ang) * torch.cos(torsion)[..., None]
    d2 = bond * math.sin(ang) * torch.sin(torsion)[..., None]
    return c + d0 * bc + d1 * m + d2 * nrm


def ideal_seed_frame(n0: Tensor, ca0: Tensor, c0: Tensor
                     ) -> tuple[Tensor, Tensor, Tensor]:
    """Idealize the first residue in place: keep CA, keep the N direction,
    re-plant N at BOND_N_CA and C in the (N, CA, C) plane at BOND_CA_C /
    ANGLE_N_CA_C."""
    u = _unit(n0 - ca0)
    v = c0 - ca0
    w = _unit(v - torch.sum(v * u, -1, keepdim=True) * u)
    ang = math.radians(ANGLE_N_CA_C_DEG)
    n = ca0 + BOND_N_CA * u
    c = ca0 + BOND_CA_C * (math.cos(ang) * u + math.sin(ang) * w)
    return n, ca0, c


def _chain_torsions(phi: Tensor, psi: Tensor, omega: Tensor) -> Tensor:
    """[B, L] x 3 -> [B, L - 1, 3]: step i (building residue i + 1)
    consumes psi[i], omega[i + 1], phi[i + 1]."""
    return torch.stack([psi[:, :-1], omega[:, 1:], phi[:, 1:]], dim=-1)


def _local_frames(tors: Tensor) -> tuple[Tensor, Tensor]:
    """Local rotations R_local [B, N, 3, 3] and bond vectors v [B, N, 3] of
    the N = 3(L - 1) placements, from their torsions [B, L - 1, 3]. In the
    frame of (A, B, C), D - C = v = bond (-cos a, sin a cos t, sin a sin t)
    and the frame of (B, C, D) has the columns v / bond,
    unit(e1 x v) x v / bond = (-sin a, -cos a cos t, -cos a sin t) and
    unit(e1 x v) = (0, -sin t, cos t)."""
    B, S = tors.shape[:2]
    rots, vecs = [], []
    for k, (bond, angle_deg) in enumerate(_STEPS):
        cos_a, sin_a = math.cos(math.radians(angle_deg)), math.sin(math.radians(angle_deg))
        ct, st = torch.cos(tors[..., k]), torch.sin(tors[..., k])
        rot = torch.stack([
            torch.stack([torch.full_like(ct, -cos_a), torch.full_like(ct, -sin_a),
                         torch.zeros_like(ct)], -1),
            torch.stack([sin_a * ct, -cos_a * ct, -st], -1),
            torch.stack([sin_a * st, -cos_a * st, ct], -1)], -2)
        rots.append(rot)
        vecs.append(bond * rot[..., 0])
    return (torch.stack(rots, dim=2).reshape(B, 3 * S, 3, 3),
            torch.stack(vecs, dim=2).reshape(B, 3 * S, 3))


def _mat3(a: Tensor, b: Tensor) -> Tensor:
    """a @ b for [..., 3, 3] @ [..., 3, k] as elementwise multiply-adds: a
    batched GEMM of 3x3 float64 matrices costs far more
    (``scripts/nerf_rebuild_ab.py``)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _prefix_products(rot: Tensor) -> Tensor:
    """Inclusive prefix products along dim 1, R_0 R_1 ... R_k, in
    ceil(log2 N) rounds (Hillis-Steele scan)."""
    N, d = rot.shape[1], 1
    while d < N:
        rot = torch.cat([rot[:, :d], _mat3(rot[:, :-d], rot[:, d:])], dim=1)
        d *= 2
    return rot


def nerf_rebuild(phi: Tensor, psi: Tensor, omega: Tensor, n0: Tensor,
                 ca0: Tensor, c0: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Differentiable NeRF chain build: ``[B, L]`` torsions (layout of
    ``dihedrals_from_coords``: phi[i] defined for i >= 1, psi[i] for
    i <= L-2, omega[i] for i >= 1) + a seed residue ``[B, 3]`` x 3 ->
    ideal-geometry ``[B, L, 3]`` N/CA/C, by the prefix product of rigid
    transforms (module docstring), in float64, returned in phi's dtype."""
    B, Ln = phi.shape
    dtype = phi.dtype
    n0, ca0, c0 = (t.to(torch.float64) for t in (n0, ca0, c0))
    if Ln > 1:
        rot, vec = _local_frames(_chain_torsions(phi, psi, omega).to(torch.float64))
        # placement k uses the seed frame times R_local_0 ... R_local_{k-1}
        prefix = _prefix_products(rot)
        local = torch.cat([vec[:, :1], _mat3(prefix[:, :-1], vec[:, 1:, :, None])[..., 0]], 1)
        bc = _unit(c0 - ca0)
        nrm = _unit(torch.cross(ca0 - n0, bc, dim=-1))
        seed = torch.stack([bc, torch.cross(nrm, bc, dim=-1), nrm], dim=-1)
        bonds = _mat3(seed[:, None], local[..., None])[..., 0]
        rest = c0[:, None] + torch.cumsum(bonds, dim=1)
        atoms = torch.cat([torch.stack([n0, ca0, c0], 1), rest], dim=1)
    else:
        atoms = torch.stack([n0, ca0, c0], 1)
    n, ca, c = atoms.reshape(B, Ln, 3, 3).to(dtype).unbind(2)
    return n, ca, c


def nerf_rebuild_reference(phi: Tensor, psi: Tensor, omega: Tensor,
                           n0: Tensor, ca0: Tensor, c0: Tensor
                           ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain version of ``nerf_rebuild``: the sequential build, three
    ``_place`` calls per residue in the input dtype, as the JAX package's
    ``lax.scan`` does it."""
    ns, cas, cs = [n0], [ca0], [c0]
    for i in range(phi.shape[1] - 1):
        pn, pca, pc = ns[-1], cas[-1], cs[-1]
        nn = _place(pn, pca, pc, BOND_C_N, ANGLE_CA_C_N_DEG, psi[:, i])
        nca = _place(pca, pc, nn, BOND_N_CA, ANGLE_C_N_CA_DEG, omega[:, i + 1])
        nc = _place(pc, nn, nca, BOND_CA_C, ANGLE_N_CA_C_DEG, phi[:, i + 1])
        ns.append(nn)
        cas.append(nca)
        cs.append(nc)
    return torch.stack(ns, 1), torch.stack(cas, 1), torch.stack(cs, 1)


def torsions_from_coords(n: Tensor, ca: Tensor, c: Tensor, mask: Tensor
                         ) -> tuple[Tensor, Tensor, Tensor]:
    """Extract (phi, psi, omega) angle arrays ``[B, L]`` in the rebuild's
    layout. Undefined positions (chain ends, masked pairs, stored as (0, 0)
    sin/cos) fall to phi/psi = 0 and omega = pi (trans), so the rebuilt
    padding stays extended rather than self-colliding."""
    dih = dihedrals_from_coords(n, ca, c, mask)
    phi = safe_atan2(dih[..., 0], dih[..., 1])
    psi = safe_atan2(dih[..., 2], dih[..., 3])
    om_defined = (torch.abs(dih[..., 4]) + torch.abs(dih[..., 5])) > 1e-6
    omega = torch.where(om_defined, safe_atan2(dih[..., 4], dih[..., 5]),
                        torch.full_like(phi, math.pi))
    return phi, psi, omega


WEIGHTS = ("anchor_weight", "w_rama", "w_omega", "w_clash_vdw")


def _energy(x: Tensor, consts: dict, *, include_o: bool) -> Tensor:
    """Energy of the torsions x = (phi, psi, omega) [3, B, L]: Ramachandran
    + trans-omega + the vdW event on the BUILT coordinates (the objective
    is what eval.analyze measures), plus the CA anchor over max(sum mask, 1)."""
    w = dict(zip(WEIGHTS, consts["w"].unbind(0)))
    mask = consts["mask"]
    bn, bca, bc = nerf_rebuild(*x.unbind(0), *consts["seed"].unbind(0))
    dih = dihedrals_from_coords(bn, bca, bc, mask)
    e = (w["w_rama"] * L.ramachandran_loss(dih, mask)
         + w["w_omega"] * L.omega_trans_loss(dih, mask)
         + w["w_clash_vdw"] * L.vdw_clash_loss(
             bn, bca, bc, mask, include_o=include_o,
             tables=(consts["vdw_pairs"], consts["vdw_thresh"])))
    msum = torch.clamp(torch.sum(mask), min=1.0)
    anchor = torch.sum(torch.square(bca - consts["ref"][1]) * mask[..., None]) / msum
    return e + w["anchor_weight"] * anchor


def refine_torsions(n: Tensor, ca: Tensor, c: Tensor, mask: Tensor, *,
                    steps: int = 300, lr: float = 0.02,
                    anchor_weight: float = 0.03, w_rama: float = 1.0,
                    w_omega: float = 1.0, w_clash_vdw: float = 25.0,
                    lr_decay: bool = True, vdw_include_o: bool = False
                    ) -> tuple[Tensor, Tensor, Tensor]:
    """Project sampled backbones onto the ideal-geometry manifold and relax
    their torsions.

    Args:
      n, ca, c: ``[B, L, 3]`` backbone coordinates (any float dtype).
      mask: ``[B, L]`` residue validity.
      steps: Adam iteration count (static; 0 = pure projection).
      anchor_weight: pull of the rebuilt CAs back to the input CAs.
      w_clash_vdw: weight of ``losses.vdw_clash_loss``.
      lr_decay: cosine-anneal lr to zero.
      vdw_include_o: extend the vdW event to the carbonyl O, with Probe's
        H-bond allowance on N...O pairs.

    Returns:
      ``(n, ca, c)`` ideal-covalent-geometry coordinates, the input's
      shapes and dtype; padded rows equal the input.
    """
    dtype = ca.dtype
    ref = torch.stack([n, ca, c]).to(torch.float32)
    maskf = mask.to(torch.float32)
    x0 = torch.stack(torsions_from_coords(ref[0], ref[1], ref[2], maskf))
    seed = torch.stack(ideal_seed_frame(ref[0][:, 0], ref[1][:, 0], ref[2][:, 0]))
    x = x0
    if steps > 0:
        pairs, thresh = L.vdw_pair_tables(ref.shape[2], bool(vdw_include_o),
                                          device=ref.device)
        consts = dict(ref=ref, seed=seed, mask=maskf, vdw_pairs=pairs, vdw_thresh=thresh,
                      w=torch.tensor([anchor_weight, w_rama, w_omega, w_clash_vdw],
                                     dtype=torch.float32, device=ref.device))
        x = adam_descent(functools.partial(_energy, include_o=bool(vdw_include_o)),
                         x0, consts, lr, steps=int(steps), lr_decay=bool(lr_decay),
                         key=("torsion", bool(vdw_include_o)))
    built = torch.stack(nerf_rebuild(*x.unbind(0), *seed.unbind(0)))
    m3 = maskf[..., None]
    out = built * m3 + ref * (1.0 - m3)
    return tuple(t.to(dtype) for t in out.unbind(0))
