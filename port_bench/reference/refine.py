"""The polish refinement, plain PyTorch: a frozen copy of the port's
``infer/refine.py`` (the Cartesian stage) and ``infer/torsion_refine.py``
(the torsion stage) on their plain paths: an eager Adam loop in place of
the port's CUDA graphs, the dense clash term in place of kernels 3-4.

``adam`` is optax's ``adam`` as the port's ``adam_descent`` runs it (b1
0.9, b2 0.999, eps 1e-8 outside the square root, with ``lr_decay`` the
cosine schedule read at the step count before its increment, the scalars
in float32 on the device). ``cartesian`` relaxes stacked N/CA/C [3, B, L,
3] under ``energy._energy``; ``torsion`` projects them onto ideal covalent
geometry by their torsions and relaxes the torsions, the chain rebuilt by
the prefix product of rigid transforms (pNeRF) in ``nerf_dtype``: float64
as the port states it, float32 in the control.
"""

from __future__ import annotations

import math

import torch

from port_bench.nerf import (ANGLE_C_N_CA, ANGLE_CA_C_N, ANGLE_N_CA_C, BOND_C_N, BOND_CA_C,
                             BOND_N_CA)
from port_bench.reference import losses as L
from port_bench.reference.energy import ATOMS, _energy
from port_bench.reference.geometry import _DEGEN, dihedrals_from_coords, safe_atan2, safe_norm

Tensor = torch.Tensor

B1, B2, EPS = 0.9, 0.999, 1e-8
# refine_backbone's defaults, under the weights a stage is given
CARTESIAN_DEFAULTS = dict(anchor_weight=0.05, w_bond=1.0, bond_delta_scale=50.0, w_spacing=1.0,
                          spacing_delta=3.0, w_angle=0.5, w_clash=5.0, w_rama=0.5, w_omega=0.5,
                          w_clash_vdw=0.0)


def adam(energy, x0: Tensor, lr: float, steps: int, lr_decay: bool) -> Tensor:
    """``steps`` Adam steps on ``energy(x)`` from ``x0``; the last iterate."""
    x = x0.detach().clone()
    m, v = torch.zeros_like(x), torch.zeros_like(x)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    lr0 = torch.tensor(lr, dtype=torch.float32, device=x.device)
    for _ in range(steps):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(energy(xg), xg)
        with torch.no_grad():
            lr_t = lr0
            if lr_decay:
                t = torch.clamp(count, max=float(steps))
                lr_t = lr0 * (0.5 * (1.0 + torch.cos(math.pi * t / steps)))
            count = count + 1.0
            m = (1.0 - B1) * g + B1 * m
            v = (1.0 - B2) * (g * g) + B2 * v
            m_hat = m / (1.0 - B1 ** count)
            v_hat = v / (1.0 - B2 ** count)
            x = x - lr_t * (m_hat / (torch.sqrt(v_hat) + EPS))
    return x


def cartesian(x0: Tensor, mask: Tensor, w: dict) -> Tensor:
    """The Cartesian stage from ``x0`` [3, B, L, 3] under ``mask`` [B, L]
    with the refiner's keyword arguments ``w`` (``steps``, ``lr``,
    ``lr_decay`` and weights); padded rows stay at ``x0``."""
    full = dict(CARTESIAN_DEFAULTS)
    full.update({k: v for k, v in w.items() if k in full})
    x0, maskf = x0.float(), mask.float()
    dev = x0.device
    vdw_on = full["w_clash_vdw"] != 0.0
    static = dict(rama_on=(full["w_rama"] != 0.0 or full["w_omega"] != 0.0), vdw_on=vdw_on,
                  vdw_tables=L.vdw_pair_tables(x0.shape[2], device=dev) if vdw_on else None)
    wt = {k: torch.tensor(float(v), dtype=torch.float32, device=dev) for k, v in full.items()}
    ref = dict(zip(ATOMS, x0.unbind(0)))

    def energy(x):
        return _energy(dict(zip(ATOMS, x.unbind(0))), ref, maskf, wt, **static)

    x = adam(energy, x0, float(w["lr"]), int(w["steps"]), bool(w["lr_decay"]))
    m3 = maskf[..., None]
    return x * m3 + x0 * (1.0 - m3)


# ---------------------------------------------------------------------------
# The torsion stage
# ---------------------------------------------------------------------------

# (bond, angle at the middle atom) placing N(i+1), CA(i+1), C(i+1)
_STEPS = ((BOND_C_N, ANGLE_CA_C_N), (BOND_N_CA, ANGLE_C_N_CA), (BOND_CA_C, ANGLE_N_CA_C))


def _unit(v: Tensor) -> Tensor:
    return v / torch.clamp(safe_norm(v, keepdim=True), min=_DEGEN)


def _mat3(a: Tensor, b: Tensor) -> Tensor:
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def nerf_rebuild(phi: Tensor, psi: Tensor, omega: Tensor, n0: Tensor, ca0: Tensor, c0: Tensor,
                 dtype: torch.dtype = torch.float64) -> tuple:
    """[B, L] torsions and a seed residue [B, 3] x 3 -> ideal-geometry
    [B, L, 3] N/CA/C, composed and summed in ``dtype``, returned in phi's."""
    B, Ln = phi.shape
    n0, ca0, c0 = (t.to(dtype) for t in (n0, ca0, c0))
    atoms = torch.stack([n0, ca0, c0], 1)
    if Ln > 1:
        tors = torch.stack([psi[:, :-1], omega[:, 1:], phi[:, 1:]], dim=-1).to(dtype)
        rots, vecs = [], []
        for k, (bond, angle) in enumerate(_STEPS):
            cos_a, sin_a = math.cos(math.radians(angle)), math.sin(math.radians(angle))
            ct, st = torch.cos(tors[..., k]), torch.sin(tors[..., k])
            rot = torch.stack([
                torch.stack([torch.full_like(ct, -cos_a), torch.full_like(ct, -sin_a),
                             torch.zeros_like(ct)], -1),
                torch.stack([sin_a * ct, -cos_a * ct, -st], -1),
                torch.stack([sin_a * st, -cos_a * st, ct], -1)], -2)
            rots.append(rot)
            vecs.append(bond * rot[..., 0])
        S = tors.shape[1]
        rot = torch.stack(rots, dim=2).reshape(B, 3 * S, 3, 3)
        vec = torch.stack(vecs, dim=2).reshape(B, 3 * S, 3)
        d = 1
        while d < rot.shape[1]:          # inclusive prefix products
            rot = torch.cat([rot[:, :d], _mat3(rot[:, :-d], rot[:, d:])], dim=1)
            d *= 2
        local = torch.cat([vec[:, :1], _mat3(rot[:, :-1], vec[:, 1:, :, None])[..., 0]], 1)
        bc = _unit(c0 - ca0)
        nrm = _unit(torch.cross(ca0 - n0, bc, dim=-1))
        seed = torch.stack([bc, torch.cross(nrm, bc, dim=-1), nrm], dim=-1)
        bonds = _mat3(seed[:, None], local[..., None])[..., 0]
        atoms = torch.cat([atoms, c0[:, None] + torch.cumsum(bonds, dim=1)], dim=1)
    return atoms.reshape(B, Ln, 3, 3).to(phi.dtype).unbind(2)


def torsions_from_coords(n: Tensor, ca: Tensor, c: Tensor, mask: Tensor) -> tuple:
    """(phi, psi, omega) [B, L]; undefined ones 0, 0 and pi (trans)."""
    dih = dihedrals_from_coords(n, ca, c, mask)
    phi = safe_atan2(dih[..., 0], dih[..., 1])
    psi = safe_atan2(dih[..., 2], dih[..., 3])
    defined = (torch.abs(dih[..., 4]) + torch.abs(dih[..., 5])) > 1e-6
    omega = torch.where(defined, safe_atan2(dih[..., 4], dih[..., 5]),
                        torch.full_like(phi, math.pi))
    return phi, psi, omega


def ideal_seed_frame(n0: Tensor, ca0: Tensor, c0: Tensor) -> tuple:
    """The first residue at ideal geometry: CA and the N direction kept."""
    u = _unit(n0 - ca0)
    v = c0 - ca0
    w = _unit(v - torch.sum(v * u, -1, keepdim=True) * u)
    ang = math.radians(ANGLE_N_CA_C)
    return (ca0 + BOND_N_CA * u, ca0,
            ca0 + BOND_CA_C * (math.cos(ang) * u + math.sin(ang) * w))


def torsion(x: Tensor, mask: Tensor, *, steps: int, lr: float, anchor_weight: float,
            w_rama: float, w_omega: float, w_clash_vdw: float, lr_decay: bool,
            include_o: bool, nerf_dtype: torch.dtype = torch.float64) -> Tensor:
    """The torsion stage from ``x`` [3, B, L, 3] under ``mask`` [B, L]:
    Ramachandran, trans-omega and the vdW event on the rebuilt chain plus a
    CA anchor to ``x``; padded rows stay at ``x``."""
    ref, maskf = x.float(), mask.float()
    dev = ref.device
    t0 = torch.stack(torsions_from_coords(ref[0], ref[1], ref[2], maskf))
    seed = ideal_seed_frame(ref[0][:, 0], ref[1][:, 0], ref[2][:, 0])
    tables = L.vdw_pair_tables(ref.shape[2], include_o, device=dev)
    w = {k: torch.tensor(float(v), dtype=torch.float32, device=dev) for k, v in
         dict(anchor_weight=anchor_weight, w_rama=w_rama, w_omega=w_omega,
              w_clash_vdw=w_clash_vdw).items()}

    def energy(t):
        bn, bca, bc = nerf_rebuild(*t.unbind(0), *seed, dtype=nerf_dtype)
        dih = dihedrals_from_coords(bn, bca, bc, maskf)
        e = (w["w_rama"] * L.ramachandran_loss(dih, maskf)
             + w["w_omega"] * L.omega_trans_loss(dih, maskf)
             + w["w_clash_vdw"] * L.vdw_clash_loss(bn, bca, bc, maskf, include_o=include_o,
                                                   tables=tables))
        anchor = (torch.sum(torch.square(bca - ref[1]) * maskf[..., None])
                  / torch.clamp(torch.sum(maskf), min=1.0))
        return e + w["anchor_weight"] * anchor

    t = adam(energy, t0, lr, int(steps), bool(lr_decay)) if steps > 0 else t0
    built = torch.stack(nerf_rebuild(*t.unbind(0), *seed, dtype=nerf_dtype))
    m3 = maskf[..., None]
    return built * m3 + ref * (1.0 - m3)
