"""Train CLI (counterpart of the JAX package's ``pev-train``, same flags,
plus ``--device``).

    python -m protein_ensemble_vae_torch.cli.train \
        --manifest_train train.csv --manifest_val val.csv [--use_seqemb] \
        [--d_model 512 ...] [--kl_schedule cyclical] [--device cuda]

It runs on the GPU unless ``--device cpu`` is given; without a GPU and
without ``--device cpu`` it raises rather than fall back to the CPU. fp32
runs at fp32 accuracy, as the JAX side runs fp32 models at
``Precision.HIGHEST``: PyTorch's products with TF32 off, the EGNN band
kernels' in 3-pass TF32. ``--compute_dtype bfloat16`` computes in bf16 with
fp32 parameters, as the JAX side's ``HierCVAE(dtype=bfloat16)``: the EGNN
band kernels read bf16 projections and make one-pass TF32 products, with
the edge chain in fp32. Not ported yet, and raising ``NotImplementedError``
rather than running something else: ``--dp``/``--tp`` > 1 and
``--multihost`` (ROADMAP.md queue A, parallelism) and ``--watch_every`` > 0
(queue A, utils/watch).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Train the hierarchical conditional VAE on NMR / "
                    "cross-PDB conformational ensembles (PyTorch port)")
    ap.add_argument("--manifest_train", required=True)
    ap.add_argument("--manifest_val", required=True)
    ap.add_argument("--config", default=None,
                    help="JSON preset (see configs/): model/loss/train "
                         "sections applied as defaults before CLI flags")
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lr", type=float, default=3e-5)
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--use_seqemb", action="store_true")

    ap.add_argument("--d_model", type=int, default=512)
    ap.add_argument("--nhead", type=int, default=8)
    ap.add_argument("--ff", type=int, default=1024)
    ap.add_argument("--nlayers", type=int, default=6)
    ap.add_argument("--z_global", type=int, default=512)
    ap.add_argument("--z_local", type=int, default=256)
    ap.add_argument("--decoder_hidden", type=int, default=256)
    ap.add_argument("--decoder_layers", type=int, default=8)
    ap.add_argument("--max_neighbors", type=int, default=40)
    ap.add_argument("--dropout", type=float, default=0.1)

    ap.add_argument("--pair_stride", type=int, default=8)
    ap.add_argument("--w_rec", type=float, default=10.0)
    ap.add_argument("--w_pair", type=float, default=10.0)
    ap.add_argument("--kl_warmup_epochs", type=int, default=20)
    ap.add_argument("--klw_global", type=float, default=1.0)
    ap.add_argument("--klw_local", type=float, default=0.5)
    ap.add_argument("--w_dihedral", type=float, default=20.0)
    ap.add_argument("--w_rama", type=float, default=400.0)
    ap.add_argument("--w_bond", type=float, default=500.0)
    ap.add_argument("--w_angle", type=float, default=500.0)
    ap.add_argument("--w_seq", type=float, default=50.0)
    ap.add_argument("--w_clash", type=float, default=300.0)
    ap.add_argument("--bond_delta", type=float, default=1.0,
                    help="multiplier on the reference huber bond deltas "
                         "(1.0 = exact reference parity)")
    ap.add_argument("--w_ca_spacing", type=float, default=0.0,
                    help="beyond-reference virtual CA-CA 3.81A spacing bond "
                         "(0 = off/parity)")
    ap.add_argument("--w_clash_vdw", type=float, default=0.0,
                    help="beyond-reference vdW-overlap clash surrogate "
                         "matched to the MolProbity clashscore event "
                         "(losses.vdw_clash_loss; 0 = off/parity)")
    ap.add_argument("--strict_geometry", action="store_true",
                    help="preset: bond_delta=25 + w_ca_spacing=100")

    ap.add_argument("--kl_schedule", type=str, default="cyclical",
                    choices=["cyclical", "monotonic", "adaptive", "exponential"])
    ap.add_argument("--kl_cycles", type=int, default=4)
    ap.add_argument("--kl_ratio", type=float, default=0.4)

    ap.add_argument("--save", default="checkpoints/hier_cvae")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--init_from", default=None,
                    help="warm-start: load PARAMS ONLY from this checkpoint "
                         "dir (fresh optimizer/LR/KL-scheduler state, epoch "
                         "1). Mutually exclusive with --resume.")
    ap.add_argument("--checkpoint_every", type=int, default=0)
    ap.add_argument("--compute_dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--multihost", action="store_true")
    ap.add_argument("--coordinator_address", default=None)
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)

    ap.add_argument("--prepad_host_batches", type=int, default=1,
                    help="1: pad every conformer once and assemble epoch "
                         "batches by numpy gathers (same batches, no "
                         "per-epoch Python pad loops); 0: pad per batch")
    ap.add_argument("--early_stopping_patience", type=int, default=20)
    ap.add_argument("--plateau_patience", type=int, default=10)
    ap.add_argument("--early_stopping_metric", type=str, default="rec",
                    choices=["rec", "loss", "rmsd"])
    ap.add_argument("--early_stopping_delta", type=float, default=1e-4)

    ap.add_argument("--use_crosspdb", action="store_true",
                    help="include /crosspdb conformers (same-UniProt "
                         "augmentation) as extra training pair partners")
    ap.add_argument("--watch_every", type=int, default=0,
                    help="N>0: dump param/grad histograms every N epochs "
                         "(not ported yet: raises)")
    ap.add_argument("--wandb_project", type=str, default="Protein-VAE")
    ap.add_argument("--wandb_run_name", type=str, default=None)
    ap.add_argument("--wandb_mode", type=str, default="disabled",
                    choices=["online", "offline", "disabled"])
    ap.add_argument("--log_jsonl", type=str, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; pass cpu "
                         "to run on the CPU)")
    return ap


def check_supported(args) -> None:
    """Raise ``NotImplementedError`` for the features this port does not
    have yet, naming the ROADMAP.md item."""
    if args.dp > 1 or args.tp > 1 or args.multihost:
        raise NotImplementedError(
            "--dp/--tp > 1 and --multihost: data / tensor parallelism is not "
            "ported yet (ROADMAP.md, queue A, 'Parallelism')")
    if args.watch_every > 0:
        raise NotImplementedError(
            "--watch_every > 0: the param/grad histogram dumps (utils/watch, "
            "make_param_grad_fn) are not ported yet (ROADMAP.md, queue A, "
            "'Remainder')")


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.resume and args.init_from:
        raise SystemExit("--init_from and --resume are mutually exclusive")
    if args.config:
        with open(args.config) as f:
            preset = json.load(f)
        flat = {}
        for section in ("model", "loss", "train"):
            flat.update(preset.get(section, {}))
        parser.set_defaults(**{k: v for k, v in flat.items() if hasattr(args, k)})
        args = parser.parse_args(argv)
    check_supported(args)

    import torch

    from protein_ensemble_vae_torch.ops.routing import resolve_device
    from protein_ensemble_vae_torch.config import (LossWeights, ModelConfig,
                                                   RunConfig, TrainConfig)
    from protein_ensemble_vae_torch.data import EnsembleDataset
    from protein_ensemble_vae_torch.data.collate import make_prepadded_factory
    from protein_ensemble_vae_torch.models import HierCVAE
    from protein_ensemble_vae_torch.ops.routing import set_full_fp32
    from protein_ensemble_vae_torch.train.checkpoint import (
        load_checkpoint, load_meta, load_train_state, record_artifact,
        save_checkpoint)
    from protein_ensemble_vae_torch.train.training import (TrainState,
                                                           train_model)
    from protein_ensemble_vae_torch.utils import MetricLogger

    device = resolve_device(args.device)
    set_full_fp32()

    train_ds = EnsembleDataset(args.manifest_train, use_seqemb=args.use_seqemb,
                               use_crosspdb=args.use_crosspdb, verbose=True)
    val_ds = EnsembleDataset(args.manifest_val, use_seqemb=args.use_seqemb,
                             use_crosspdb=args.use_crosspdb, verbose=True)
    seqemb_dim = train_ds.seqemb_dim if args.use_seqemb else None
    if seqemb_dim is None:
        seqemb_dim = 1280  # zero-filled placeholder channel

    cfg = RunConfig(
        model=ModelConfig(
            seqemb_dim=seqemb_dim, d_model=args.d_model, nhead=args.nhead,
            ff=args.ff, nlayers=args.nlayers, z_global=args.z_global,
            z_local=args.z_local, dropout=args.dropout,
            decoder_hidden=args.decoder_hidden,
            decoder_layers=args.decoder_layers,
            max_neighbors=args.max_neighbors, use_seqemb=args.use_seqemb),
        loss=LossWeights(
            w_rec=args.w_rec, w_pair=args.w_pair, pair_stride=args.pair_stride,
            klw_global=args.klw_global, klw_local=args.klw_local,
            w_dihedral=args.w_dihedral, w_rama=args.w_rama,
            w_bond=args.w_bond, w_angle=args.w_angle, w_seq=args.w_seq,
            w_clash=args.w_clash,
            bond_delta=25.0 if args.strict_geometry else args.bond_delta,
            w_ca_spacing=100.0 if args.strict_geometry else args.w_ca_spacing,
            w_clash_vdw=args.w_clash_vdw),
        train=TrainConfig(
            batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
            seed=args.seed, kl_schedule=args.kl_schedule,
            kl_cycles=args.kl_cycles, kl_ratio=args.kl_ratio,
            kl_warmup_epochs=args.kl_warmup_epochs,
            early_stopping_patience=args.early_stopping_patience,
            plateau_patience=args.plateau_patience,
            early_stopping_metric=args.early_stopping_metric,
            early_stopping_delta=args.early_stopping_delta,
            save_path=args.save, checkpoint_every=args.checkpoint_every,
            resume=args.resume, compute_dtype=args.compute_dtype,
            dp=args.dp, tp=args.tp))

    torch.manual_seed(cfg.train.seed)
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    model = HierCVAE(cfg.model, dtype=dtype).to(device)

    logger = MetricLogger(jsonl_path=args.log_jsonl,
                          wandb_mode=args.wandb_mode,
                          wandb_project=args.wandb_project,
                          wandb_run_name=args.wandb_run_name,
                          config={"model": cfg.model.__dict__,
                                  "loss": cfg.loss.__dict__,
                                  "train": cfg.train.__dict__})
    make_batches = make_prepadded_factory() if args.prepad_host_batches else None

    def checkpoint_fn(state, epoch, loss_history, meta):
        tag = "best" if meta.get("best") else f"epoch{epoch:05d}"
        path = os.path.join(args.save, tag)
        save_checkpoint(path, model, cfg, epoch, loss_history, meta,
                        train_state=state)
        headline = {k: loss_history["val"][k][-1]
                    for k in ("loss", "rec") if loss_history["val"].get(k)}
        record_artifact(args.save, tag, path, epoch, headline)
        logger.info(f"[checkpoint] saved {path}")

    start_epoch = 1
    init_state = None
    if args.resume and os.path.isdir(os.path.join(args.save, "best")):
        path = os.path.join(args.save, "best")
        load_checkpoint(path, model)
        init_state = TrainState.create(model)
        load_train_state(path, init_state)
        start_epoch = load_meta(path)["epoch"] + 1
        logger.info(f"[resume] from {path} at epoch {start_epoch}")
    elif args.init_from:
        src_model = load_meta(args.init_from).get("config", {}).get("model")
        if src_model is not None and src_model != dataclasses.asdict(cfg.model):
            logger.info("[init_from] WARNING: checkpoint model config differs "
                        "from the current one; params must still match")
        load_checkpoint(args.init_from, model)
        logger.info(f"[init_from] params warm-started from {args.init_from} "
                    f"(epoch {load_meta(args.init_from)['epoch']}); optimizer/"
                    "scheduler state fresh")

    state, history = train_model(model, train_ds, val_ds, cfg, logger=logger,
                                 start_epoch=start_epoch,
                                 init_state=init_state,
                                 checkpoint_fn=checkpoint_fn,
                                 make_batches=make_batches)

    final_path = os.path.join(args.save, "final")
    final_epoch = len(history["train"]["loss"])
    save_checkpoint(final_path, model, cfg, epoch=final_epoch,
                    loss_history=history, train_state=state)
    record_artifact(args.save, "final", final_path, final_epoch)
    logger.info(f"[done] final checkpoint: {final_path}")
    logger.close()


if __name__ == "__main__":
    main()
