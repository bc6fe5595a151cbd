"""Generation CLI (counterpart of the JAX package's ``cli/generate.py``).

    python -m protein_ensemble_vae_torch.cli.generate \
        --checkpoint ckpt/ --manifest data.csv --output_dir generated/ \
        --num_samples 10 [--device cuda]

The model is rebuilt from the checkpoint's config sidecar. It runs on the
GPU unless ``--device cpu`` is given; without a GPU and without
``--device cpu`` it raises rather than fall back to the CPU.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Generate conformational "
                                 "ensembles from a trained checkpoint")
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint directory (with state.pt + meta.json)")
    ap.add_argument("--manifest", required=True, help="manifest CSV")
    ap.add_argument("--output_dir", default="generated_ensembles")
    ap.add_argument("--num_samples", type=int, default=10)
    ap.add_argument("--max_structures", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--latent_source", default="posterior",
                    choices=["posterior", "prior"],
                    help="posterior = z ~ q(z|x) per structure; "
                         "prior = z ~ N(0, T^2 I)")
    ap.add_argument("--seq_decode", default="argmax",
                    choices=["argmax", "sample", "threshold"],
                    help="sequence decode mode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--refine_steps", type=int, default=0,
                    help="generation-time geometric refinement steps "
                         "(0 = off)")
    ap.add_argument("--refine_lr", type=float, default=0.05)
    ap.add_argument("--refine_anchor", type=float, default=0.05)
    ap.add_argument("--refine_w_rama", type=float, default=0.5)
    ap.add_argument("--refine_w_angle", type=float, default=0.5)
    ap.add_argument("--refine_w_bond", type=float, default=1.0)
    ap.add_argument("--refine_w_clash_vdw", type=float, default=0.0)
    ap.add_argument("--refine_lr_decay", action="store_true")
    ap.add_argument("--refine_mode", default="cartesian",
                    choices=["cartesian", "torsion", "polish"])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; pass cpu "
                         "to run on the CPU)")
    return ap


def main(argv=None):
    from protein_ensemble_vae_torch.ops.routing import resolve_device
    from protein_ensemble_vae_torch.utils import enable_compilation_cache

    args = build_parser().parse_args(argv)
    enable_compilation_cache()
    device = resolve_device(args.device)

    from protein_ensemble_vae_torch.data import (EnsembleDataset,
                                                 SingleConformerView)
    from protein_ensemble_vae_torch.infer import generate_ensembles
    from protein_ensemble_vae_torch.models import HierCVAE
    from protein_ensemble_vae_torch.train.checkpoint import (load_checkpoint,
                                                             load_run_config)

    cfg = load_run_config(args.checkpoint)
    model = HierCVAE(cfg.model).to(device)
    load_checkpoint(args.checkpoint, model)

    ds = EnsembleDataset(args.manifest, use_seqemb=cfg.model.use_seqemb,
                         verbose=True)
    view = SingleConformerView(ds)

    out = generate_ensembles(model, view, args.output_dir,
                             num_samples=args.num_samples, seed=args.seed,
                             max_structures=args.max_structures,
                             buckets=cfg.train.bucket_sizes,
                             temperature=args.temperature,
                             latent_source=args.latent_source,
                             seq_decode=args.seq_decode,
                             refine_steps=args.refine_steps,
                             refine_lr=args.refine_lr,
                             refine_anchor=args.refine_anchor,
                             refine_w_rama=args.refine_w_rama,
                             refine_kwargs=dict(
                                 w_angle=args.refine_w_angle,
                                 w_bond=args.refine_w_bond,
                                 w_clash_vdw=args.refine_w_clash_vdw,
                                 lr_decay=args.refine_lr_decay),
                             refine_mode=args.refine_mode)
    print(f"[generate] wrote {len(out['results'])} structures to "
          f"{args.output_dir}; summary: {out['summary_path']}")


if __name__ == "__main__":
    main()
