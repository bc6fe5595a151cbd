"""Analysis CLI (counterpart of the JAX package's ``cli/analyze.py``,
reference ``analyze_ensemble.py``).

    python -m protein_ensemble_vae_torch.cli.analyze --pdb_dir generated/ \
        [--output report.txt] [--device cuda]

The torsions and the diversity battery run on the GPU unless ``--device
cpu`` is given; without a GPU and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description="Analyze generated ensembles")
    ap.add_argument("--pdb_dir", required=True)
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; pass cpu "
                         "to run on the CPU)")
    args = ap.parse_args(argv)

    from protein_ensemble_vae_torch.ops.routing import resolve_device
    from protein_ensemble_vae_torch.eval.analyze import analyze_directory
    from protein_ensemble_vae_torch.ops.routing import set_full_fp32

    device = resolve_device(args.device)
    set_full_fp32()
    output = args.output or os.path.join(args.pdb_dir, "analysis_report.txt")
    out = analyze_directory(args.pdb_dir, output_path=output, device=device)
    agg = out["aggregate"]
    print(f"[analyze] {agg['n_structures']} structures | "
          f"diversity {agg['mean_diversity']:.3f}A | "
          f"rama favored {agg['mean_rama_favored']*100:.1f}% | "
          f"clash {agg['mean_clash_score']:.1f} | "
          f"mp_clash {agg['mean_molprobity_clashscore']:.1f} | "
          f"report: {output}")


if __name__ == "__main__":
    main()
