"""Standalone geometric-refinement CLI: repair an existing multi-model PDB
(counterpart of the JAX package's ``cli/refine.py``).

    python -m protein_ensemble_vae_torch.cli.refine --input ensemble.pdb \
        --output ensemble_refined.pdb [--device cuda]

Runs the generation-time relaxation (infer/refine.py) on backbones read
from any multi-MODEL PDB — including ensembles produced by the upstream
reference's generator, whose samples fail its own geometry gate 100 % of
the time (reference generate_ensemble_pdbs.py:290-340; no repair path
exists there). Prints a before/after report: gate pass counts, backbone
bond errors, clash score. The refinement runs on the GPU unless
``--device cpu`` is given; without a GPU and without ``--device cpu`` it
raises.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Relax the backbone geometry of a multi-model PDB "
                    "(bond/CA-spacing/angle/clash/Ramachandran energies "
                    "with a soft anchor to the input)")
    ap.add_argument("--input", required=True, help="PDB (single or multi-MODEL)")
    ap.add_argument("--output", required=True, help="refined PDB path")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--anchor", type=float, default=0.05,
                    help="pull toward the input coordinates (higher = "
                         "preserve more of the input conformation)")
    ap.add_argument("--w_rama", type=float, default=0.5,
                    help="Ramachandran-basin energy weight (0 = covalent-"
                         "only relaxation, preserves input torsions)")
    ap.add_argument("--w_omega", type=float, default=0.5,
                    help="trans-omega energy weight")
    ap.add_argument("--w_clash", type=float, default=5.0)
    ap.add_argument("--w_angle", type=float, default=0.5)
    ap.add_argument("--w_bond", type=float, default=1.0,
                    help="covalent bond-length weight (4.0 with --lr_decay "
                         "reaches the 0.005 A post-fix bar)")
    ap.add_argument("--w_clash_vdw", type=float, default=0.0,
                    help="MolProbity-event vdW-overlap clash weight "
                         "(targets the clashscore the analyzer reports)")
    ap.add_argument("--lr_decay", action="store_true",
                    help="cosine-anneal the step size to zero (kills the "
                         "Adam jitter floor on bonds/angles)")
    ap.add_argument("--torsion", action="store_true",
                    help="refine in torsion space on the ideal-covalent-"
                         "geometry NeRF manifold (infer/torsion_refine.py):"
                         " bond/angle errors are exactly zero by "
                         "construction; only --w_rama/--w_omega/"
                         "--w_clash_vdw/--anchor/--steps/--lr apply")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; pass cpu "
                         "to run on the CPU)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from protein_ensemble_vae_torch.ops.routing import resolve_device
    from protein_ensemble_vae_torch.eval.analyze import (bond_length_stats,
                                                         clash_score)
    from protein_ensemble_vae_torch.infer.gate import validate_protein_geometry
    from protein_ensemble_vae_torch.infer.pdb_io import (read_pdb_backbone,
                                                         write_multi_model_pdb)
    from protein_ensemble_vae_torch.infer.refine import refine_backbone
    from protein_ensemble_vae_torch.infer.torsion_refine import refine_torsions

    device = resolve_device(args.device)

    ens = read_pdb_backbone(args.input)
    n, ca, c, mask = ens["n"], ens["ca"], ens["c"], ens["mask"]
    K = ca.shape[0]
    # per-MODEL mask: in a heterogeneous ensemble (e.g. NMR models that
    # resolve different termini) a residue absent from model k sits at
    # (0,0,0) there — refining it under the union mask would drag model
    # k's real neighbors toward the origin
    mask_k = ens.get("model_mask")
    if mask_k is None:
        mask_k = np.broadcast_to(mask[None], ca.shape[:2])

    def report(tag, nn, cc_a, cc):
        ok = sum(validate_protein_geometry(cc_a[k], mask_k[k])[0]
                 for k in range(K))
        cl = float(np.mean([clash_score(nn[k], cc_a[k], cc[k], mask_k[k])
                            for k in range(K)]))
        b = bond_length_stats(nn[0], cc_a[0], cc[0], mask_k[0])
        print(f"[refine] {tag}: gate {ok}/{K}  clash {cl:.1f}  "
              f"C-N err {b['c_n']['mean_error']:.3f}A "
              f"(viol {b['c_n']['violation_frac']:.1%})")
        return ok

    report("before", n, ca, c)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for a in (n, ca, c, mask_k)]
    if args.torsion:
        rn, rca, rc = refine_torsions(
            *t, steps=args.steps, lr=args.lr,
            anchor_weight=args.anchor, w_rama=args.w_rama,
            w_omega=args.w_omega, w_clash_vdw=args.w_clash_vdw,
            lr_decay=True)  # always anneal: convergence, not jitter
    else:
        rn, rca, rc = refine_backbone(*t, steps=args.steps,
                                      lr=args.lr, anchor_weight=args.anchor,
                                      w_rama=args.w_rama,
                                      w_omega=args.w_omega,
                                      w_clash=args.w_clash,
                                      w_angle=args.w_angle,
                                      w_bond=args.w_bond,
                                      w_clash_vdw=args.w_clash_vdw,
                                      lr_decay=args.lr_decay)
    rn, rca, rc = (a.cpu().numpy() for a in (rn, rca, rc))
    ok = report("after ", rn, rca, rc)

    write_multi_model_pdb(rn, rca, rc, np.asarray(mask_k), args.output,
                          sequence=ens.get("sequence"),
                          title=f"REFINED ENSEMBLE ({K} MODELS)")
    print(f"[refine] wrote {args.output} ({ok}/{K} gate-valid)")


if __name__ == "__main__":
    main()
