"""The physics-loss battery in PyTorch (counterpart of the JAX package's
``losses.py``).

Same formulas, the same 16-key dict from ``compute_total_loss``, and the
same masked-mean denominators, which differ from term to term on purpose:
``max(sum(mask), 1)`` for most terms, ``+ 1e-8`` for the sequence
cross-entropy and the clash terms. Every sqrt / acos / atan2 that is
degenerate at coincident or collinear atoms is epsilon-guarded as on the
JAX side, so gradients stay finite there.

The clash term routes by ``ops/routing.py:pallas_policy``, the knob of the
band kernel: kernels 3 and 4 (``ops/kernels/clash.py``) for CUDA tensors
under "auto" or True, the dense ``clash_loss`` otherwise.

Data parallelism: every term normalises over the whole batch. A dp rank
passes the global denominators (``batch_denominators`` summed over the dp
group; they depend only on the masks and carry no gradient) as ``den`` /
``rows``; its terms are then its share of the global loss, and the shares
sum to it. Without them each term normalises over the rows it is given.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from protein_ensemble_vae_torch.config import BOND_C_O, LossWeights
from protein_ensemble_vae_torch.ops.geometry import (angle_cos,
                                                     dihedrals_from_coords,
                                                     pairwise_distances,
                                                     safe_atan2, safe_norm,
                                                     wrap_angle)
from protein_ensemble_vae_torch.ops.kernels.clash import (backbone_atoms,
                                                          clash_loss_kernel,
                                                          clash_pair_terms)
from protein_ensemble_vae_torch.ops.routing import pallas_policy

Tensor = torch.Tensor


def _floor1(x: Tensor) -> Tensor:
    return torch.clamp(x, min=1.0)


# ---------------------------------------------------------------------------
# Reconstruction
# ---------------------------------------------------------------------------

def _batch_mean(per_sample: Tensor, rows: Optional[Tensor]) -> Tensor:
    """The mean over the batch, or the sum over these rows / ``rows``."""
    return torch.mean(per_sample) if rows is None else torch.sum(per_sample) / rows


def _den(local: Tensor, den: Optional[Tensor]) -> Tensor:
    return _floor1(local if den is None else den)


def rmsd_loss(pred: Tensor, target: Tensor, mask: Tensor,
              rows: Optional[Tensor] = None) -> Tensor:
    """Masked per-residue coordinate MSE in A^2 (MSE, not RMSD, despite
    the name; no alignment)."""
    diff = torch.sum((pred - target) ** 2, dim=-1)
    per_sample = torch.sum(diff * mask, dim=1) / _floor1(torch.sum(mask, dim=1))
    return _batch_mean(per_sample, rows)


def _strided_pairs(mask: Tensor, stride: int) -> Tensor:
    m = mask[:, ::stride]
    return m[:, :, None] * m[:, None, :]


def pair_distance_loss(pred: Tensor, target: Tensor, mask: Tensor,
                       stride: int = 4, den: Optional[Tensor] = None) -> Tensor:
    """Strided pairwise-distance consistency."""
    P, T = pred[:, ::stride], target[:, ::stride]
    M = _strided_pairs(mask, stride)
    dP = pairwise_distances(P, P)
    dT = pairwise_distances(T, T)
    return torch.sum(torch.abs(dP - dT) * M) / _den(torch.sum(M), den)


# ---------------------------------------------------------------------------
# KL divergences
# ---------------------------------------------------------------------------

def _kl_unit_gauss(mu: Tensor, lv: Tensor) -> Tensor:
    return 0.5 * (torch.exp(lv) + mu * mu - 1.0 - lv)


def kl_global(mu: Tensor, lv: Tensor, rows: Optional[Tensor] = None) -> Tensor:
    """Mean over the batch of the per-sample summed KL. In the dtype of
    ``mu`` / ``lv`` (bf16 from a bf16 encoder, as in JAX; the sums
    accumulate in fp32 and round once); the weighted total is fp32."""
    per_sample = torch.sum(_kl_unit_gauss(mu, lv), dim=1)
    if rows is None:
        return torch.mean(per_sample)
    return (torch.sum(per_sample) / rows).to(per_sample.dtype)


def kl_local(mu: Tensor, lv: Tensor, mask: Tensor,
             den: Optional[Tensor] = None) -> Tensor:
    """Masked mean over residues of the per-residue summed KL; the fp32
    mask promotes a bf16 KL to fp32, as in JAX."""
    kl = torch.sum(_kl_unit_gauss(mu, lv), dim=-1)
    return torch.sum(kl * mask) / _den(torch.sum(mask), den)


def free_bits_kl(mu: Tensor, lv: Tensor, mask: Optional[Tensor] = None,
                 free_bits: float = 2.0, min_kl: float = 0.0,
                 reduce: str = "mean") -> Tensor:
    """KL with a per-dimension floor (free bits), mask-aware."""
    kl = _kl_unit_gauss(mu, lv)
    if free_bits > 0:
        kl = torch.clamp(kl, min=free_bits)
    if min_kl > 0:
        kl = torch.clamp(kl, min=min_kl)
    kl = torch.sum(kl, dim=-1)
    if mask is not None:
        kl = kl * mask
        if reduce == "mean":
            return torch.sum(kl) / _floor1(torch.sum(mask))
    elif reduce == "mean":
        return torch.mean(kl)
    if reduce == "sum":
        return torch.sum(kl)
    return kl


# ---------------------------------------------------------------------------
# Torsion-space terms
# ---------------------------------------------------------------------------

def _valid_channels(pred_dih: Tensor, target_dih: Tensor, mask: Tensor) -> Tensor:
    return (mask[..., None].bool() & torch.isfinite(pred_dih)
            & torch.isfinite(target_dih))


def dihedral_consistency_loss(pred_dih: Tensor, target_dih: Tensor,
                              mask: Tensor, den: Optional[Tensor] = None) -> Tensor:
    """Finite-guarded MSE over all sin/cos channels; the denominator is
    the count of valid elements (B * L * 6 scale)."""
    valid = _valid_channels(pred_dih, target_dih, mask)
    diff = torch.where(valid, pred_dih - target_dih, torch.zeros_like(pred_dih))
    return torch.sum(diff * diff) / _den(torch.sum(valid.to(pred_dih.dtype)), den)


def ramachandran_loss(dihedrals: Tensor, mask: Tensor,
                      den: Optional[Tensor] = None) -> Tensor:
    """Four Gaussian allowed basins + forbidden-quadrant penalty."""
    phi = safe_atan2(dihedrals[..., 0], dihedrals[..., 1])
    psi = safe_atan2(dihedrals[..., 2], dihedrals[..., 3])

    alpha = torch.exp(-((phi + 1.05) ** 2 / 0.6 + (psi + 0.79) ** 2 / 0.6))
    beta = torch.exp(-((phi + 2.09) ** 2 / 0.9 + (psi - 2.09) ** 2 / 0.9))
    left_alpha = torch.exp(-((phi - 1.05) ** 2 / 0.6 + (psi - 0.79) ** 2 / 0.6))
    ppii = torch.exp(-((phi + 1.31) ** 2 / 0.5 + (psi - 2.53) ** 2 / 0.5))

    in_allowed = torch.maximum(torch.maximum(alpha, beta),
                               torch.maximum(left_alpha, ppii))
    penalty = 1.0 - in_allowed
    forbidden = ((phi > 0) & (psi < 0)).to(phi.dtype)
    total = penalty + 5.0 * forbidden
    return torch.sum(total * mask) / _den(torch.sum(mask), den)


def omega_trans_loss(dihedrals: Tensor, mask: Tensor,
                     den: Optional[Tensor] = None) -> Tensor:
    """Trans-peptide preference: 2 (1 - cos(omega - pi)) + 3 [|wrap(omega)| < 0.5]."""
    omega = safe_atan2(dihedrals[..., 4], dihedrals[..., 5])
    trans_pen = 1.0 - torch.cos(omega - math.pi)
    cis = (torch.abs(wrap_angle(omega)) < 0.5).to(omega.dtype)
    total = 2.0 * trans_pen + 3.0 * cis
    return torch.sum(total * mask) / _den(torch.sum(mask), den)


# ---------------------------------------------------------------------------
# Covalent-geometry terms
# ---------------------------------------------------------------------------

def huber(x: Tensor, delta: float = 0.2) -> Tensor:
    ax = torch.abs(x)
    return torch.where(ax < delta, 0.5 * x * x, delta * (ax - 0.5 * delta))


def _pair_mask(mask: Tensor) -> Tensor:
    """Consecutive residue pairs, both valid."""
    return mask[:, :-1] * mask[:, 1:]


def bond_length_loss(pred_n: Tensor, pred_ca: Tensor, pred_c: Tensor,
                     mask: Tensor, delta_scale: float = 1.0,
                     den: Optional[tuple[Tensor, Tensor]] = None) -> Tensor:
    """Huber penalties on N-CA (1.46, delta 0.02), CA-C (1.52, 0.02) and 2x
    the inter-residue C-N peptide bond (1.33, 0.01); ``delta_scale``
    multiplies the deltas (1.0 = the reference). ``den`` = (residues,
    consecutive pairs) of the global batch."""
    msum = _den(torch.sum(mask), None if den is None else den[0])
    ds = delta_scale
    n_ca = safe_norm(pred_ca - pred_n) - 1.46
    p_n_ca = torch.sum(huber(n_ca, 0.02 * ds) * mask) / msum
    ca_c = safe_norm(pred_c - pred_ca) - 1.52
    p_ca_c = torch.sum(huber(ca_c, 0.02 * ds) * mask) / msum
    if pred_n.shape[1] > 1:
        c_n = safe_norm(pred_n[:, 1:] - pred_c[:, :-1]) - 1.33
        pair_mask = _pair_mask(mask)
        p_c_n = (torch.sum(huber(c_n, 0.01 * ds) * pair_mask)
                 / _den(torch.sum(pair_mask), None if den is None else den[1]))
    else:
        p_c_n = torch.zeros((), dtype=pred_n.dtype, device=pred_n.device)
    return p_n_ca + p_ca_c + 2.0 * p_c_n


CA_CA_VIRTUAL = 3.81


def ca_spacing_loss(pred_ca: Tensor, mask: Tensor, delta: float = 0.5,
                    den: Optional[Tensor] = None) -> Tensor:
    """Virtual CA(i)-CA(i+1) bond at 3.81 A (off by default,
    ``LossWeights.w_ca_spacing``)."""
    if pred_ca.shape[1] < 2:
        return torch.zeros((), dtype=pred_ca.dtype, device=pred_ca.device)
    d = safe_norm(pred_ca[:, 1:] - pred_ca[:, :-1]) - CA_CA_VIRTUAL
    pair_mask = _pair_mask(mask)
    return torch.sum(huber(d, delta) * pair_mask) / _den(torch.sum(pair_mask), den)


_TARGET_NCAC = 110.0 * math.pi / 180.0
_TARGET_CNCA = 121.0 * math.pi / 180.0
_TARGET_CACN = 116.0 * math.pi / 180.0
_ACOS_EPS = 1e-7


def _safe_acos(c: Tensor) -> Tensor:
    return torch.acos(torch.clamp(c, -1.0 + _ACOS_EPS, 1.0 - _ACOS_EPS))


def bond_angle_loss(pred_n: Tensor, pred_ca: Tensor, pred_c: Tensor,
                    mask: Tensor, den: Optional[tuple[Tensor, Tensor]] = None
                    ) -> Tensor:
    """Huber in angle space on N-CA-C / C-N-CA / CA-C-N, inter-residue
    terms x2. ``den`` = (residues, consecutive pairs) of the global batch."""
    mask = mask.to(pred_ca.dtype)
    msum = _den(torch.sum(mask), None if den is None else den[0])
    a_ncac = _safe_acos(angle_cos(pred_n, pred_ca, pred_c))
    l_ncac = torch.sum(huber(a_ncac - _TARGET_NCAC, 0.1) * mask) / msum
    if pred_n.shape[1] > 1:
        pair = _pair_mask(mask)
        psum = _den(torch.sum(pair), None if den is None else den[1])
        a_cnca = _safe_acos(angle_cos(pred_c[:, :-1], pred_n[:, 1:], pred_ca[:, 1:]))
        l_cnca = torch.sum(huber(a_cnca - _TARGET_CNCA, 0.1) * pair) / psum
        a_cacn = _safe_acos(angle_cos(pred_ca[:, :-1], pred_c[:, :-1], pred_n[:, 1:]))
        l_cacn = torch.sum(huber(a_cacn - _TARGET_CACN, 0.1) * pair) / psum
    else:
        l_cnca = l_cacn = torch.zeros((), dtype=pred_n.dtype, device=pred_n.device)
    return l_ncac + 2.0 * (l_cnca + l_cacn)


# ---------------------------------------------------------------------------
# Sequence
# ---------------------------------------------------------------------------

def sequence_classification_loss(pred_logits: Tensor, target_labels: Tensor,
                                 mask: Tensor, den: Optional[Tensor] = None) -> Tensor:
    """Masked 20-way cross-entropy (denominator + 1e-8)."""
    logp = F.log_softmax(pred_logits, dim=-1)
    nll = -torch.gather(logp, -1, target_labels[..., None].long())[..., 0]
    return torch.sum(nll * mask) / ((torch.sum(mask) if den is None else den) + 1e-8)


def sequence_accuracy(pred_logits: Tensor, target_labels: Tensor,
                      mask: Tensor, den: Optional[Tensor] = None) -> Tensor:
    """Masked argmax accuracy."""
    correct = (torch.argmax(pred_logits, dim=-1) == target_labels) & mask.bool()
    return torch.sum(correct.to(torch.float32)) / _den(torch.sum(mask), den)


# ---------------------------------------------------------------------------
# Clash
# ---------------------------------------------------------------------------

def clash_loss(pred_n: Tensor, pred_ca: Tensor, pred_c: Tensor, mask: Tensor,
               clash_dist: float = 3.2, soft_margin: float = 0.5,
               rows: Optional[Tensor] = None) -> Tensor:
    """Steric-clash penalty over the full [B, 3L, 3L] distance matrix: pairs
    at least 2 residues apart, quadratic penalty on relu(clash_dist - d),
    per-sample normalisation by pair count + 1e-8. The plain version of
    kernels 3 and 4."""
    atoms, amask = backbone_atoms(pred_n, pred_ca, pred_c, mask.to(pred_ca.dtype))
    total, num_pairs = clash_pair_terms(atoms, amask, clash_dist, soft_margin)
    return _batch_mean(total / (num_pairs + 1e-8), rows)


# Probe/MolProbity van der Waals radii (Word et al. 1999): amide N 1.55,
# aliphatic CA 1.70, carbonyl C 1.65, carbonyl O 1.40 A.
_VDW_N_CA_C = (1.55, 1.70, 1.65)
_VDW_O = 1.40
# bond-graph steps from each atom type (N, CA, C, O) to its residue's C,
# and from N to each atom type
_STEPS_TO_C = (2, 1, 0, 1)
_STEPS_FROM_N = (0, 1, 2, 3)


def carbonyl_oxygen(pred_n: Tensor, pred_ca: Tensor, pred_c: Tensor,
                    mask: Tensor) -> Tensor:
    """Differentiable sp2-plane carbonyl O: O(i) = C(i) - 1.23 A *
    unit(unit(CA(i) - C(i)) + unit(N(i+1) - C(i))); the last or
    next-invalid residue uses its own N. Denominators floored."""
    def _unit(v):
        return v / torch.clamp(safe_norm(v, keepdim=True), min=1e-4)

    v1 = _unit(pred_ca - pred_c)
    nxt = torch.cat([pred_n[:, 1:], pred_n[:, -1:]], dim=1)
    next_ok = torch.cat([mask[:, 1:] > 0.5,
                         torch.zeros_like(mask[:, :1], dtype=torch.bool)], dim=1)
    v2 = _unit(torch.where(next_ok[..., None], nxt, pred_n) - pred_c)
    bis = _unit(v1 + v2)
    return (pred_c - bis * BOND_C_O) * mask[..., None]


def vdw_pair_tables(L: int, include_o: bool = False, count_overlap: float = 0.4,
                    buffer: float = 0.1, device: Optional[torch.device] = None,
                    dtype: torch.dtype = torch.float32) -> tuple[Tensor, Tensor]:
    """The part of ``vdw_clash_loss`` that depends on the length alone:
    the counted upper-triangle atom pairs and each pair's distance
    threshold, both [LP, LP]. A caller that evaluates the loss many times
    at one length (refinement's Adam loop, whose step is captured in a
    CUDA graph that must not copy from the host) builds them once and
    passes them as ``tables``."""
    P, dev, dt = (4 if include_o else 3), device, dtype
    radii_t = _VDW_N_CA_C + ((_VDW_O,) if include_o else ())
    idx = torch.arange(L * P, device=dev)
    res_idx, atom_t = idx // P, idx % P
    sep = torch.abs(res_idx[:, None] - res_idx[None, :])
    earlier = res_idx[:, None] <= res_idx[None, :]
    earlier_t = torch.where(earlier, atom_t[:, None], atom_t[None, :])
    later_t = torch.where(earlier, atom_t[None, :], atom_t[:, None])
    s_to_c = torch.tensor(_STEPS_TO_C[:P], device=dev)
    s_from_n = torch.tensor(_STEPS_FROM_N[:P], device=dev)
    adj_bonds = s_to_c[earlier_t] + 1 + s_from_n[later_t]
    counted = ((sep >= 2) | ((sep == 1) & (adj_bonds >= 4))).to(dt)
    triu = torch.triu(torch.ones((L * P, L * P), dtype=dt, device=dev), diagonal=1)

    radii = torch.tensor(radii_t, dtype=dt, device=dev).repeat(L)
    co = torch.full((L * P, L * P), count_overlap, dtype=dt, device=dev)
    if include_o:
        is_n, is_o = atom_t == 0, atom_t == 3
        hb = (is_n[:, None] & is_o[None, :]) | (is_o[:, None] & is_n[None, :])
        co = torch.where(hb, torch.full_like(co, max(0.8, count_overlap)), co)
    thresh = radii[:, None] + radii[None, :] - co + buffer
    return counted * triu, thresh


def vdw_clash_loss(pred_n: Tensor, pred_ca: Tensor, pred_c: Tensor,
                   mask: Tensor, count_overlap: float = 0.4,
                   buffer: float = 0.1, include_o: bool = False,
                   tables: Optional[tuple[Tensor, Tensor]] = None,
                   rows: Optional[Tensor] = None) -> Tensor:
    """Differentiable surrogate of the MolProbity backbone clashscore (off
    by default, ``LossWeights.w_clash_vdw``): relu(r_i + r_j - overlap +
    buffer - d_ij)^2 over the pairs more than 3 covalent bonds apart,
    normalised like ``clash_loss``. ``include_o`` adds the carbonyl O with
    Probe's H-bond allowance for N...O pairs. ``tables`` is
    ``vdw_pair_tables`` of the same length and settings, built here when
    not given."""
    B, L = pred_ca.shape[:2]
    P = 4 if include_o else 3
    parts = [pred_n, pred_ca, pred_c]
    if include_o:
        parts.append(carbonyl_oxygen(pred_n, pred_ca, pred_c, mask))
    atoms = torch.stack(parts, dim=2).reshape(B, L * P, 3)
    # mask repeated per atom by a broadcast: no output size to read back
    atom_mask = mask[:, :, None].expand(B, L, P).reshape(B, L * P)
    dists = pairwise_distances(atoms, atoms)
    if tables is None:
        tables = vdw_pair_tables(L, include_o, count_overlap, buffer,
                                 pred_ca.device, pred_ca.dtype)
    pairs, thresh = tables
    pair_mask = atom_mask[:, :, None] * atom_mask[:, None, :] * pairs[None]
    violation = torch.relu(thresh - dists)
    total = torch.sum(violation * violation * pair_mask, dim=(1, 2))
    num_pairs = torch.sum(pair_mask, dim=(1, 2))
    return _batch_mean(total / (num_pairs + 1e-8), rows)


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------

@torch.no_grad()
def batch_denominators(mask: Tensor, pred_n: Tensor, pred_ca: Tensor,
                       pred_c: Tensor, target_dih: Tensor, pair_stride: int
                       ) -> Tensor:
    """This batch's sums that the terms normalise by, stacked in fp32:
    rows, valid residues, consecutive valid pairs, strided residue pairs
    (``pair_distance_loss``) and finite dihedral channels
    (``dihedral_consistency_loss``). Summed over the dp group they are
    ``compute_total_loss``'s ``den``."""
    pred_dih = dihedrals_from_coords(pred_n, pred_ca, pred_c, mask)
    parts = (torch.full_like(mask[0, 0], mask.shape[0]), torch.sum(mask),
             torch.sum(_pair_mask(mask)),
             torch.sum(_strided_pairs(mask, pair_stride)),
             torch.sum(_valid_channels(pred_dih, target_dih, mask)))
    return torch.stack([p.to(torch.float32) for p in parts])


def compute_total_loss(pred_n: Tensor, pred_ca: Tensor, pred_c: Tensor,
                       pred_seq: Tensor,
                       target_n: Tensor, target_ca: Tensor, target_c: Tensor,
                       target_seq_labels: Tensor,
                       mask: Tensor,
                       mu_g: Tensor, lv_g: Tensor, mu_l: Tensor, lv_l: Tensor,
                       target_dihedrals: Tensor,
                       klw_g, klw_l,
                       weights: LossWeights,
                       use_pallas: object = "auto",
                       den: Optional[Tensor] = None) -> dict[str, Tensor]:
    """Weighted sum of all terms, with the JAX package's 16 keys (plus
    ``ca_spacing`` / ``clash_vdw`` when their weights are non-zero).
    ``klw_g`` / ``klw_l`` are the scheduled KL weights (floats or device
    scalars). ``use_pallas`` is ``ModelConfig.use_pallas_egnn``: it routes
    the clash term between kernels 3-4 and the dense version. ``den``, the
    global batch's ``batch_denominators``, makes every term this batch's
    share of the global batch's term."""
    rows, res, pairs, strided, dih = (None,) * 5 if den is None else den.unbind()
    loss_rec_ca = rmsd_loss(pred_ca, target_ca, mask, rows)
    loss_rec_n = rmsd_loss(pred_n, target_n, mask, rows)
    loss_rec_c = rmsd_loss(pred_c, target_c, mask, rows)
    loss_rec = loss_rec_ca + 0.5 * (loss_rec_n + loss_rec_c)

    loss_pair = pair_distance_loss(pred_ca, target_ca, mask,
                                   stride=weights.pair_stride, den=strided)
    loss_kg = kl_global(mu_g, lv_g, rows)
    loss_kl = kl_local(mu_l, lv_l, mask, res)

    pred_dih = dihedrals_from_coords(pred_n, pred_ca, pred_c, mask)
    loss_dih_cons = dihedral_consistency_loss(pred_dih, target_dihedrals, mask, dih)
    loss_rama = ramachandran_loss(pred_dih, mask, res)
    loss_omega = omega_trans_loss(pred_dih, mask, res)
    loss_dihedral = loss_dih_cons + loss_omega

    both = None if den is None else (res, pairs)
    loss_bond = bond_length_loss(pred_n, pred_ca, pred_c, mask,
                                 delta_scale=weights.bond_delta, den=both)
    loss_angle = bond_angle_loss(pred_n, pred_ca, pred_c, mask, both)
    loss_seq = sequence_classification_loss(pred_seq, target_seq_labels, mask, res)

    if pallas_policy(mask, use_pallas):
        loss_clash = clash_loss_kernel(pred_n, pred_ca, pred_c, mask)
        if rows is not None:        # the kernel gives the mean over these rows
            loss_clash = loss_clash * (mask.shape[0] / rows)
    else:
        loss_clash = clash_loss(pred_n, pred_ca, pred_c, mask, rows=rows)

    total = (weights.w_rec * loss_rec
             + weights.w_pair * loss_pair
             + klw_g * loss_kg
             + klw_l * loss_kl
             + weights.w_dihedral * loss_dihedral
             + weights.w_rama * loss_rama
             + weights.w_bond * loss_bond
             + weights.w_angle * loss_angle
             + weights.w_seq * loss_seq
             + weights.w_clash * loss_clash)

    extra = {}
    if weights.w_ca_spacing:
        loss_ca_spacing = ca_spacing_loss(pred_ca, mask, den=pairs)
        total = total + weights.w_ca_spacing * loss_ca_spacing
        extra["ca_spacing"] = loss_ca_spacing
    if weights.w_clash_vdw:
        loss_clash_vdw = vdw_clash_loss(pred_n, pred_ca, pred_c, mask, rows=rows)
        total = total + weights.w_clash_vdw * loss_clash_vdw
        extra["clash_vdw"] = loss_clash_vdw

    return {
        **extra,
        "total": total,
        "reconstruction": loss_rec,
        "reconstruction_ca": loss_rec_ca,
        "reconstruction_n": loss_rec_n,
        "reconstruction_c": loss_rec_c,
        "pair_distance": loss_pair,
        "kl_global": loss_kg,
        "kl_local": loss_kl,
        "dihedral_consistency": loss_dih_cons,
        "omega_trans": loss_omega,
        "ramachandran": loss_rama,
        "dihedral_total": loss_dihedral,
        "bond_length": loss_bond,
        "bond_angle": loss_angle,
        "sequence": loss_seq,
        "clash": loss_clash,
    }
