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
the edge chain in fp32. ``--watch_every N`` writes parameter and gradient
histograms of the first training batch every N epochs to
``<save>/watch/epoch_NNNNN.npz`` (``utils/watch.py``, the JAX package's
layout) and leaves the run as it was. ``PEV_COMPILE_CACHE`` moves the
kernels' build directory (``utils/compile_cache.py``).

Parallelism (``parallel/mesh.py``): ``--dp N --tp M`` on one host starts
N x M rank processes itself, each building the same global batches and
keeping its rows; ``--multihost`` makes this process one rank of
``--num_processes`` (meeting at ``--coordinator_address``, or the
``torchrun`` environment), fed its own shard by
``make_sharded_epoch_batches`` (``--batch_size`` per process). tp > 1
routes the decoder to the plain band path and the clash term to its dense
version: the kernels are single-device. Rank 0 alone logs and writes the
checkpoints, which hold the full parameters.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
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
    ap.add_argument("--multihost", action="store_true",
                    help="this process is one rank of --num_processes; "
                         "each feeds its own batch shard")
    ap.add_argument("--coordinator_address", default=None,
                    help="host:port served by process 0 (default: the "
                         "torchrun environment)")
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
                         "to <save>/watch/ (offline wandb.watch)")
    ap.add_argument("--wandb_project", type=str, default="Protein-VAE")
    ap.add_argument("--wandb_run_name", type=str, default=None)
    ap.add_argument("--wandb_mode", type=str, default="disabled",
                    choices=["online", "offline", "disabled"])
    ap.add_argument("--log_jsonl", type=str, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; pass cpu "
                         "to run on the CPU)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """The command line, with a ``--config`` preset's sections as defaults."""
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
    return args


def main(argv=None, datasets=None, timeout_s=None):
    """Train as the command line says. ``datasets`` = (train, val) stands
    in for the manifests' ``EnsembleDataset``s (objects with its interface;
    picklable when ranks are launched); ``timeout_s`` bounds the launched
    ranks' run (None: no bound)."""
    args = parse_args(argv)

    from protein_ensemble_vae_torch.config import ModelConfig
    from protein_ensemble_vae_torch.parallel.mesh import (initialize_multihost,
                                                          launch,
                                                          validate_mesh_config)
    from protein_ensemble_vae_torch.ops.routing import resolve_device
    from protein_ensemble_vae_torch.utils import enable_compilation_cache

    enable_compilation_cache()
    resolve_device(args.device)
    # multi-host: each process feeds --batch_size, the global batch is dp x that
    validate_mesh_config(args.dp, args.tp,
                         args.batch_size * (args.dp if args.multihost else 1),
                         ModelConfig(nhead=args.nhead, ff=args.ff,
                                     decoder_hidden=args.decoder_hidden))
    if args.multihost:
        import torch.distributed as dist

        initialize_multihost(args.coordinator_address, args.num_processes,
                             args.process_id, args.device)
        try:
            return train(args, datasets)
        finally:
            dist.destroy_process_group()
    if args.dp * args.tp > 1:
        launch(_rank_main, args.dp * args.tp, (argv, datasets), device=args.device,
               timeout_s=timeout_s)
        return None
    return train(args, datasets)


def _rank_main(argv, datasets):
    """One rank of a single-host ``--dp`` / ``--tp`` run (``launch``)."""
    from protein_ensemble_vae_torch.utils import enable_compilation_cache

    enable_compilation_cache()
    train(parse_args(argv), datasets)


def train(args, datasets=None):
    """Build the run from ``args`` and train it, in this process alone or as
    one rank of an initialised process group of ``--dp`` x ``--tp`` ranks."""
    import torch
    import torch.distributed as dist

    from protein_ensemble_vae_torch.config import (LossWeights, ModelConfig,
                                                   RunConfig, TrainConfig)
    from protein_ensemble_vae_torch.data import EnsembleDataset
    from protein_ensemble_vae_torch.data.collate import (make_prepadded_factory,
                                                         make_sharded_epoch_batches)
    from protein_ensemble_vae_torch.models import HierCVAE
    from protein_ensemble_vae_torch.ops.routing import resolve_device, set_full_fp32
    from protein_ensemble_vae_torch.parallel.mesh import (build_kernels_first,
                                                          current_device, make_mesh,
                                                          shard_model)
    from protein_ensemble_vae_torch.train.checkpoint import (
        load_checkpoint, load_meta, load_train_state, record_artifact,
        save_checkpoint)
    from protein_ensemble_vae_torch.train.training import (TrainState,
                                                           train_model)
    from protein_ensemble_vae_torch.utils import MetricLogger
    from protein_ensemble_vae_torch.utils.watch import make_watch_fn

    mesh = make_mesh(args.dp, args.tp) if dist.is_initialized() else None
    rank0 = mesh is None or mesh.rank == 0
    device = resolve_device(args.device) if mesh is None else current_device(args.device)
    set_full_fp32()

    if datasets is None:
        datasets = tuple(EnsembleDataset(m, use_seqemb=args.use_seqemb,
                                         use_crosspdb=args.use_crosspdb, verbose=rank0)
                         for m in (args.manifest_train, args.manifest_val))
    train_ds, val_ds = datasets
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
            max_neighbors=args.max_neighbors, use_seqemb=args.use_seqemb,
            # the band and clash kernels are single-device: tp shards the
            # plain band path (parallel/shard.py)
            use_pallas_egnn="auto" if args.tp == 1 else False),
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

    with open(os.devnull, "w") as devnull:
        logger = MetricLogger(jsonl_path=args.log_jsonl if rank0 else None,
                              wandb_mode=args.wandb_mode if rank0 else "disabled",
                              wandb_project=args.wandb_project,
                              wandb_run_name=args.wandb_run_name,
                              config={"model": cfg.model.__dict__,
                                      "loss": cfg.loss.__dict__,
                                      "train": cfg.train.__dict__},
                              stream=None if rank0 else devnull)
        make_batches = make_prepadded_factory() if args.prepad_host_batches else None
        if mesh is not None:
            devices = [None] * (args.dp * args.tp)
            dist.all_gather_object(devices, str(device))
            logger.info(f"[mesh] dp={args.dp} tp={args.tp} backend="
                        f"{dist.get_backend()} devices={','.join(devices)}")
            if args.tp > 1:
                logger.info("[mesh] tp>1: decoder routed to the plain band path "
                            "(the band kernels are single-device)")
            if args.multihost:
                make_batches = functools.partial(make_sharded_epoch_batches,
                                                 process_index=mesh.dp_rank,
                                                 process_count=mesh.dp)
            if device.type == "cuda" and cfg.model.use_pallas_egnn is not False:
                build_kernels_first()

        torch.manual_seed(cfg.train.seed)
        dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
        model = HierCVAE(cfg.model, dtype=dtype).to(device)

        def checkpoint_fn(state, epoch, loss_history, meta):
            tag = "best" if meta.get("best") else f"epoch{epoch:05d}"
            path = os.path.join(args.save, tag)
            save_checkpoint(path, model, cfg, epoch, loss_history, meta,
                            train_state=state)
            if rank0:
                headline = {k: loss_history["val"][k][-1]
                            for k in ("loss", "rec") if loss_history["val"].get(k)}
                record_artifact(args.save, tag, path, epoch, headline)
            logger.info(f"[checkpoint] saved {path}")

        start_epoch = 1
        resume_path = None
        if args.resume and os.path.isdir(os.path.join(args.save, "best")):
            resume_path = os.path.join(args.save, "best")
            load_checkpoint(resume_path, model)
            start_epoch = load_meta(resume_path)["epoch"] + 1
            logger.info(f"[resume] from {resume_path} at epoch {start_epoch}")
        elif args.init_from:
            src_model = load_meta(args.init_from).get("config", {}).get("model")
            if src_model is not None and src_model != dataclasses.asdict(cfg.model):
                logger.info("[init_from] WARNING: checkpoint model config differs "
                            "from the current one; params must still match")
            load_checkpoint(args.init_from, model)
            logger.info(f"[init_from] params warm-started from {args.init_from} "
                        f"(epoch {load_meta(args.init_from)['epoch']}); optimizer/"
                        "scheduler state fresh")
        if mesh is not None:
            shard_model(model, mesh)
        init_state = None
        if resume_path is not None:
            init_state = TrainState.create(model)
            load_train_state(resume_path, init_state)

        watch_fn = make_watch_fn(model, train_ds, cfg, os.path.join(args.save, "watch"),
                                 args.watch_every, logger=logger)
        state, history = train_model(model, train_ds, val_ds, cfg, logger=logger,
                                     start_epoch=start_epoch,
                                     init_state=init_state,
                                     checkpoint_fn=checkpoint_fn,
                                     make_batches=make_batches, mesh=mesh,
                                     local_batches=args.multihost, watch_fn=watch_fn)

        final_path = os.path.join(args.save, "final")
        final_epoch = len(history["train"]["loss"])
        save_checkpoint(final_path, model, cfg, epoch=final_epoch,
                        loss_history=history, train_state=state)
        if rank0:
            record_artifact(args.save, "final", final_path, final_epoch)
        logger.info(f"[done] final checkpoint: {final_path}")
        logger.close()
    return history


if __name__ == "__main__":
    main()
