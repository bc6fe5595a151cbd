"""Ensemble analysis over generated PDB directories.

Re-implements the reference ``analyze_ensemble.py`` battery: per structure —
reconstruction RMSD vs ground truth, full ensemble RMSD matrix,
Ramachandran favored/allowed/outlier fractions, clash score, secondary
structure content, bond-length violation stats, ensemble-to-GT RMSD — plus
aggregate summary and a detailed text report. Plot generation is optional
(matplotlib-guarded, as the reference's pipeline script does).

A copy of the JAX package's ``eval/analyze.py``: host numpy, except the
torsions and the diversity battery, which run on ``device`` (default the
GPU).
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from protein_ensemble_vae_torch.config import BOND_CA_C, BOND_C_N, BOND_N_CA
from protein_ensemble_vae_torch.eval.metrics import (
    compute_ensemble_diversity,
    kabsch_align_np,
)
from protein_ensemble_vae_torch.eval.ramachandran import (
    classify_ramachandran,
    phi_psi_from_backbone,
)
from protein_ensemble_vae_torch.infer.pdb_io import read_pdb_backbone


def clash_score(n: np.ndarray, ca: np.ndarray, c: np.ndarray,
                mask: np.ndarray, clash_dist: float = 3.2) -> float:
    """Clashes per 1000 atoms among backbone atoms >= 2 residues apart
    (reference analyze_ensemble.py:203-226)."""
    valid = mask > 0.5
    atoms = np.stack([n, ca, c], axis=1)[valid].reshape(-1, 3)
    res_idx = np.repeat(np.arange(valid.sum()), 3)
    d = np.linalg.norm(atoms[:, None] - atoms[None, :], axis=-1)
    sep = np.abs(res_idx[:, None] - res_idx[None, :])
    pairs = (sep >= 2) & (np.triu(np.ones_like(d, dtype=bool), 1))
    n_clash = int(((d < clash_dist) & pairs).sum())
    n_atoms = len(atoms)
    return 1000.0 * n_clash / max(n_atoms, 1)


# Probe/MolProbity van der Waals radii for the backbone atoms we decode
# (Word et al. 1999, as used by MolProbity's clashscore): amide N 1.55,
# aliphatic CA 1.70, carbonyl C 1.65, carbonyl O 1.40 A.
_VDW_RADII = np.array([1.55, 1.70, 1.65, 1.40])   # N, CA, C, O
_CLASH_OVERLAP = 0.4                               # "serious overlap", A
# Probe scores donor–acceptor contacts as hydrogen bonds, not clashes:
# overlap up to ~0.8 A between an N-H donor and a carbonyl O is favorable
# (Word et al. 1999 "small-probe contact dots"). Without this allowance
# every backbone helix H-bond (O(i)···N(i+4) ~2.6-3.0 A vs r_N+r_O =
# 2.95) counts as a clash: ideal-geometry ground-truth chains scored
# mp~20 from their own H-bond network (measured round 5).
_HBOND_OVERLAP = 0.8


def _backbone_bond_exclusions(L: int, max_bonds: int = 3) -> set:
    """Pairs of backbone atoms <= ``max_bonds`` covalent bonds apart.

    Atom index layout per residue i: 4i+0 = N, 4i+1 = CA, 4i+2 = C,
    4i+3 = O; bonds are N-CA, CA-C, C-O and the peptide C(i)-N(i+1).
    Probe excludes 1-2/1-3/1-4 interactions from clash counting; BFS to
    depth 3 over this graph reproduces that exclusion set exactly.
    """
    adj = {}
    for i in range(L):
        b = 4 * i
        bonds = [(b, b + 1), (b + 1, b + 2), (b + 2, b + 3)]
        if i + 1 < L:
            bonds.append((b + 2, b + 4))
        for u, v in bonds:
            adj.setdefault(u, set()).add(v)
            adj.setdefault(v, set()).add(u)
    excluded = set()
    for start in range(4 * L):
        frontier = {start}
        seen = {start}
        for _ in range(max_bonds):
            frontier = {w for u in frontier for w in adj.get(u, ())} - seen
            seen |= frontier
            for w in frontier:
                excluded.add((min(start, w), max(start, w)))
    return excluded


def molprobity_clashscore(n: np.ndarray, ca: np.ndarray, c: np.ndarray,
                          o: Optional[np.ndarray], mask: np.ndarray,
                          overlap: float = _CLASH_OVERLAP) -> float:
    """Backbone MolProbity-style clashscore: serious steric overlaps per
    1000 atoms.

    MolProbity's clashscore (its "<20" target in BASELINE.md) runs Probe
    over an all-atom, hydrogen-added model and counts pairs whose van der
    Waals overlap is >= 0.4 A, normalized per 1000 atoms. We decode only
    the N/CA/C/O backbone, so this is the same *definition* restricted to
    backbone atoms: clash = r_i + r_j - d >= 0.4 A with Probe's radii,
    pairs <= 3 covalent bonds apart excluded (Probe's 1-2/1-3/1-4
    exclusion), each clashing pair counted once, per 1000 counted atoms.
    On well-formed experimental backbones this reads ~0; it is directly
    comparable across our samples, the reference's samples and ground
    truth, and is a lower bound on the all-atom score (hydrogens and
    sidechains can only add contacts). Distinct from ``clash_score``
    above, which reproduces the reference's own 3.2 A count-based metric
    (analyze_ensemble.py:203-226) and is NOT MolProbity-comparable.
    """
    valid = mask > 0.5
    parts = [n[valid], ca[valid], c[valid]]
    radii = [_VDW_RADII[:3]]
    if o is not None and np.any(np.abs(o) > 1e-8):
        parts.append(o[valid])
        radii.append(_VDW_RADII[3:])
        order = np.stack(parts, axis=1).reshape(-1, 3)       # N,CA,C,O rows
        r = np.tile(_VDW_RADII, valid.sum())
        per_res = 4
    else:
        order = np.stack(parts, axis=1).reshape(-1, 3)
        r = np.tile(_VDW_RADII[:3], valid.sum())
        per_res = 3
    n_atoms = len(order)
    if n_atoms == 0:
        return 0.0
    d = np.linalg.norm(order[:, None] - order[None, :], axis=-1)
    over = (r[:, None] + r[None, :]) - d
    # donor–acceptor N···O pairs carry Probe's H-bond allowance: they
    # clash only past _HBOND_OVERLAP, not _CLASH_OVERLAP (see above)
    t = np.arange(n_atoms) % per_res
    is_n, is_o = t == 0, t == 3
    hb = (is_n[:, None] & is_o[None, :]) | (is_o[:, None] & is_n[None, :])
    thr = np.where(hb, max(_HBOND_OVERLAP, overlap), overlap)
    cand = np.argwhere(np.triu(over >= thr, 1))
    if per_res == 4:
        excluded = _backbone_bond_exclusions(int(valid.sum()))
    else:
        # no O column: remap the 4-per-residue exclusion graph to 3
        excluded = {(u - u // 4, v - v // 4)
                    for u, v in _backbone_bond_exclusions(int(valid.sum()))
                    if u % 4 != 3 and v % 4 != 3}
    n_clash = sum(1 for u, v in cand if (int(u), int(v)) not in excluded)
    return 1000.0 * n_clash / n_atoms


def secondary_structure_content(phi: np.ndarray, psi: np.ndarray,
                                valid: np.ndarray) -> dict:
    """Coarse SS assignment from phi/psi (reference analyze_ensemble.py:229-258)."""
    phi_d = np.degrees(phi[valid])
    psi_d = np.degrees(psi[valid])
    n = max(len(phi_d), 1)
    helix = ((phi_d > -120) & (phi_d < -30) & (psi_d > -80) & (psi_d < 0)).sum()
    sheet = ((phi_d > -180) & (phi_d < -90) & (psi_d > 90) & (psi_d < 180)).sum()
    return dict(helix=float(helix) / n, sheet=float(sheet) / n,
                coil=float(n - helix - sheet) / n)


def bond_length_stats(n: np.ndarray, ca: np.ndarray, c: np.ndarray,
                      mask: np.ndarray, tol: float = 0.1) -> dict:
    """Mean abs error + violation fraction per backbone bond type
    (reference analyze_ensemble.py:261-278)."""
    valid = mask > 0.5
    out = {}
    d_nca = np.linalg.norm(ca - n, axis=-1)[valid]
    d_cac = np.linalg.norm(c - ca, axis=-1)[valid]
    pair = valid[:-1] & valid[1:]
    d_cn = np.linalg.norm(n[1:] - c[:-1], axis=-1)[pair]
    for name, d, ref in (("n_ca", d_nca, BOND_N_CA), ("ca_c", d_cac, BOND_CA_C),
                         ("c_n", d_cn, BOND_C_N)):
        if len(d) == 0:
            out[name] = dict(mean_error=0.0, violation_frac=0.0)
        else:
            err = np.abs(d - ref)
            out[name] = dict(mean_error=float(err.mean()),
                             violation_frac=float((err > tol).mean()))
    return out


def analyze_structure(ensemble_pdb: str, true_pdb: Optional[str] = None,
                      recon_pdb: Optional[str] = None, device="cuda") -> dict:
    ens = read_pdb_backbone(ensemble_pdb)
    mask = ens["mask"]
    valid = mask > 0.5
    K = ens["ca"].shape[0]

    diversity, rmsd_matrix = compute_ensemble_diversity(ens["ca"][:, valid],
                                                        device=device)

    rama_all, ss_all, clash_all, bonds_all, mp_all = [], [], [], [], []
    o_arr = ens.get("o")
    for k in range(K):
        phi, psi, v = phi_psi_from_backbone(ens["n"][k], ens["ca"][k],
                                            ens["c"][k], mask, device=device)
        rama_all.append(classify_ramachandran(phi, psi, v))
        ss_all.append(secondary_structure_content(phi, psi, v))
        clash_all.append(clash_score(ens["n"][k], ens["ca"][k], ens["c"][k], mask))
        mp_all.append(molprobity_clashscore(
            ens["n"][k], ens["ca"][k], ens["c"][k],
            o_arr[k] if o_arr is not None else None, mask))
        bonds_all.append(bond_length_stats(ens["n"][k], ens["ca"][k],
                                           ens["c"][k], mask))

    def _avg(dicts, key):
        return float(np.mean([d[key] for d in dicts]))

    result = dict(
        ensemble_pdb=ensemble_pdb,
        n_models=K,
        n_residues=int(valid.sum()),
        diversity=diversity,
        rmsd_matrix=rmsd_matrix,
        ramachandran=dict(favored=_avg(rama_all, "favored"),
                          allowed=_avg(rama_all, "allowed"),
                          outlier=_avg(rama_all, "outlier")),
        secondary_structure=dict(helix=_avg(ss_all, "helix"),
                                 sheet=_avg(ss_all, "sheet"),
                                 coil=_avg(ss_all, "coil")),
        clash_score=float(np.mean(clash_all)),
        molprobity_clashscore=float(np.mean(mp_all)),
        bond_stats={b: dict(mean_error=float(np.mean(
            [s[b]["mean_error"] for s in bonds_all])),
            violation_frac=float(np.mean(
                [s[b]["violation_frac"] for s in bonds_all])))
            for b in ("n_ca", "ca_c", "c_n")},
    )

    if true_pdb and os.path.exists(true_pdb):
        true = read_pdb_backbone(true_pdb)
        tv = (true["mask"] > 0.5) & valid[:len(true["mask"])]
        ens_to_gt = []
        for k in range(K):
            aligned = kabsch_align_np(ens["ca"][k][tv], true["ca"][0][tv])
            ens_to_gt.append(float(np.sqrt(
                ((aligned - true["ca"][0][tv]) ** 2).mean())))
        result["ensemble_to_gt_rmsd"] = dict(
            mean=float(np.mean(ens_to_gt)), min=float(np.min(ens_to_gt)),
            max=float(np.max(ens_to_gt)))
        if recon_pdb and os.path.exists(recon_pdb):
            rec = read_pdb_backbone(recon_pdb)
            aligned = kabsch_align_np(rec["ca"][0][tv], true["ca"][0][tv])
            result["reconstruction_rmsd"] = float(np.sqrt(
                ((aligned - true["ca"][0][tv]) ** 2).mean()))
    return result


def plot_structure_diagnostics(result: dict, ens: dict, out_prefix: str,
                               device="cuda") -> Optional[str]:
    """Optional plots: Ramachandran scatter + ensemble RMSD heatmap
    (reference analyze_ensemble.py:295-339,371-394). Matplotlib-guarded."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    mask = ens["mask"]
    phis, psis = [], []
    for k in range(ens["ca"].shape[0]):
        phi, psi, v = phi_psi_from_backbone(ens["n"][k], ens["ca"][k],
                                            ens["c"][k], mask, device=device)
        phis.append(np.degrees(phi[v]))
        psis.append(np.degrees(psi[v]))
    axes[0].scatter(np.concatenate(phis), np.concatenate(psis), s=4,
                    alpha=0.5)
    axes[0].set_xlim(-180, 180)
    axes[0].set_ylim(-180, 180)
    axes[0].axhline(0, color="gray", lw=0.5)
    axes[0].axvline(0, color="gray", lw=0.5)
    axes[0].set_xlabel("phi (deg)")
    axes[0].set_ylabel("psi (deg)")
    axes[0].set_title("Ramachandran")

    im = axes[1].imshow(result["rmsd_matrix"], cmap="viridis")
    fig.colorbar(im, ax=axes[1], label="RMSD (A)")
    axes[1].set_title("ensemble pairwise RMSD")
    fig.tight_layout()
    path = out_prefix + "_diagnostics.png"
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def analyze_directory(pdb_dir: str, output_path: Optional[str] = None,
                      verbose: bool = True, plots: bool = True,
                      device="cuda") -> dict:
    """Analyze all ``*_ensemble.pdb`` files in a directory; write the
    aggregate + detailed text report (reference analyze_ensemble.py:500-529)."""
    ensembles = sorted(glob.glob(os.path.join(pdb_dir, "*_ensemble.pdb")))
    if not ensembles:
        raise FileNotFoundError(f"no *_ensemble.pdb files in {pdb_dir}")

    results = []
    for ep in ensembles:
        base = ep[:-len("_ensemble.pdb")]
        r = analyze_structure(ep, true_pdb=base + "_true.pdb",
                              recon_pdb=base + "_reconstruction.pdb",
                              device=device)
        if plots:
            png = plot_structure_diagnostics(r, read_pdb_backbone(ep), base,
                                             device=device)
            if png:
                r["diagnostics_png"] = png
        results.append(r)
        if verbose:
            print(f"[analyze] {os.path.basename(ep)}: "
                  f"K={r['n_models']} div={r['diversity']:.3f}A "
                  f"rama_fav={r['ramachandran']['favored']:.2f} "
                  f"clash={r['clash_score']:.1f} "
                  f"mp_clash={r['molprobity_clashscore']:.1f}")

    agg = dict(
        n_structures=len(results),
        mean_diversity=float(np.mean([r["diversity"] for r in results])),
        mean_rama_favored=float(np.mean(
            [r["ramachandran"]["favored"] for r in results])),
        mean_rama_outlier=float(np.mean(
            [r["ramachandran"]["outlier"] for r in results])),
        mean_clash_score=float(np.mean([r["clash_score"] for r in results])),
        mean_molprobity_clashscore=float(np.mean(
            [r["molprobity_clashscore"] for r in results])),
    )
    recs = [r["reconstruction_rmsd"] for r in results
            if "reconstruction_rmsd" in r]
    if recs:
        agg["mean_reconstruction_rmsd"] = float(np.mean(recs))

    if output_path:
        with open(output_path, "w") as f:
            f.write("ENSEMBLE ANALYSIS REPORT\n" + "=" * 70 + "\n\n")
            for r in results:
                f.write(f"{os.path.basename(r['ensemble_pdb'])}\n")
                f.write(f"  models: {r['n_models']}  residues: {r['n_residues']}\n")
                f.write(f"  diversity (mean pairwise RMSD): {r['diversity']:.3f} A\n")
                if "reconstruction_rmsd" in r:
                    f.write(f"  reconstruction RMSD: "
                            f"{r['reconstruction_rmsd']:.3f} A\n")
                if "ensemble_to_gt_rmsd" in r:
                    g = r["ensemble_to_gt_rmsd"]
                    f.write(f"  ensemble-to-GT RMSD: mean {g['mean']:.3f} "
                            f"min {g['min']:.3f} max {g['max']:.3f} A\n")
                ra = r["ramachandran"]
                f.write(f"  Ramachandran: favored {ra['favored']*100:.1f}% "
                        f"allowed {ra['allowed']*100:.1f}% "
                        f"outlier {ra['outlier']*100:.1f}%\n")
                ss = r["secondary_structure"]
                f.write(f"  SS content: helix {ss['helix']*100:.1f}% "
                        f"sheet {ss['sheet']*100:.1f}% coil {ss['coil']*100:.1f}%\n")
                f.write(f"  clash score: {r['clash_score']:.1f}\n")
                f.write(f"  MolProbity-style backbone clashscore: "
                        f"{r['molprobity_clashscore']:.1f} "
                        f"(target <20)\n")
                for b, st in r["bond_stats"].items():
                    f.write(f"  bond {b}: mean err {st['mean_error']:.4f} A, "
                            f"violations {st['violation_frac']*100:.1f}%\n")
                f.write("\n")
            f.write("-" * 70 + "\nAGGREGATE\n")
            for k, v in agg.items():
                f.write(f"  {k}: {v:.4f}\n" if isinstance(v, float)
                        else f"  {k}: {v}\n")
    return dict(results=results, aggregate=agg)
