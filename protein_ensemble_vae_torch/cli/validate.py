"""Validation CLI (counterpart of the JAX package's ``cli/validate.py``,
reference ``scripts/validation_metrics.py:662-698``).

    python -m protein_ensemble_vae_torch.cli.validate --pred pred.pdb \
        --true true.pdb [--output report.txt] [--device cuda]
    python -m protein_ensemble_vae_torch.cli.validate --ensemble ensemble.pdb

The ensemble battery (diversity, RMSF) runs on the GPU unless ``--device
cpu`` is given; without a GPU and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description="Structure validation metrics")
    ap.add_argument("--pred", default=None)
    ap.add_argument("--true", dest="true_pdb", default=None)
    ap.add_argument("--ensemble", default=None)
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; pass cpu "
                         "to run on the CPU)")
    args = ap.parse_args(argv)

    if not ((args.pred and args.true_pdb) or args.ensemble):
        ap.error("provide --pred & --true, and/or --ensemble")

    from protein_ensemble_vae_torch.ops.routing import resolve_device
    from protein_ensemble_vae_torch.eval.report import validate_files
    from protein_ensemble_vae_torch.ops.routing import set_full_fp32

    device = resolve_device(args.device)
    set_full_fp32()
    out = validate_files(pred_pdb=args.pred, true_pdb=args.true_pdb,
                         ensemble_pdb=args.ensemble, output=args.output,
                         device=device)
    if out["prediction"]:
        m = out["prediction"]
        print(f"RMSD {m['rmsd']:.3f}A | TM {m['tm_score']:.3f} "
              f"({m['tm_interpretation']}) | lDDT {m['lddt']:.3f} | "
              f"GDT-TS {m['gdt_ts']:.1f} | GDT-HA {m['gdt_ha']:.1f}")
    if out["ensemble"]:
        e = out["ensemble"]
        print(f"ensemble: {e['n_models']} models, diversity "
              f"{e['diversity']:.3f}A "
              f"({'OK' if e['diversity_ok'] else 'LOW'})")
    if args.output:
        print(f"report: {args.output}")


if __name__ == "__main__":
    main()
