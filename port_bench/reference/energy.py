"""The polish refinement's Cartesian energy, plain PyTorch: a frozen copy
of the port's ``infer/refine.py:_energy`` (bond lengths, virtual CA-CA
spacing, bond angles, the steric clash on its dense formulation, the vdW
overlap surrogate, Ramachandran and trans-omega basins, and the soft
anchor to the stage's start), which ``refine.py``'s Cartesian stage
minimises.
"""

from __future__ import annotations

from typing import Optional

import torch

from port_bench.reference import losses as L
from port_bench.reference.geometry import dihedrals_from_coords

Tensor = torch.Tensor

ATOMS = ("n", "ca", "c")


def _energy(coords: dict, ref: dict, mask: Tensor, w: dict, *, rama_on: bool,
            vdw_on: bool,
            vdw_tables: Optional[tuple[Tensor, Tensor]] = None) -> Tensor:
    """Local-geometry energy + soft anchor, as the JAX package's
    ``_energy``. Every term reuses the (masked, bounded-gradient) training
    losses with the deltas raised into their quadratic region. ``w`` holds
    the weights as 0-dim tensors; only ``rama_on`` and ``vdw_on`` are
    static. The clash term is the dense ``losses.clash_loss``.
    ``vdw_tables`` is ``losses.vdw_pair_tables`` at this length."""
    n, ca, c = coords["n"], coords["ca"], coords["c"]
    clash = L.clash_loss(n, ca, c, mask)
    e = (w["w_bond"] * L.bond_length_loss(n, ca, c, mask,
                                          delta_scale=w["bond_delta_scale"])
         + w["w_spacing"] * L.ca_spacing_loss(ca, mask, delta=w["spacing_delta"])
         + w["w_angle"] * L.bond_angle_loss(n, ca, c, mask)
         + w["w_clash"] * clash)
    if vdw_on:
        # surrogate of the MolProbity counting event (vdW overlap >= 0.4 A,
        # 1-2/1-3/1-4 excluded), which the flat 3.2 A term above misses
        e = e + w["w_clash_vdw"] * L.vdw_clash_loss(n, ca, c, mask, tables=vdw_tables)
    if rama_on:
        dih = dihedrals_from_coords(n, ca, c, mask)
        e = (e + w["w_rama"] * L.ramachandran_loss(dih, mask)
             + w["w_omega"] * L.omega_trans_loss(dih, mask))
    msum = 3.0 * torch.clamp(torch.sum(mask), min=1.0)
    anchor = sum(torch.sum(torch.square(coords[k] - ref[k]) * mask[..., None])
                 for k in ATOMS) / msum
    return e + w["anchor_weight"] * anchor

