"""The port's multi-rank dry run (counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``), and the rank worker that the tests and
``chip_smoke.py`` launch.

    python -m protein_ensemble_vae_torch.parallel.dryrun N [--device cuda|cpu]

starts N ranks on one host (dp = N / 2 and tp = 2 when N >= 4 and even,
else dp = N; gloo, or NCCL with a card per rank), on the GPU unless
``--device cpu`` is given (without a GPU it raises), takes one train step of
the JAX dry run's tiny model on its batch (B = 2 dp, L = 32, dropout 0.1;
the plain band path) and holds the sharded loss against the
single-process step on the same weights and batch at rtol 1e-5.

``parity_step`` is one rank's part of such a step, from a picklable
``spec``; ``single_step`` is the single-process step of the same spec. Both
return the loss, the metrics, the launch counts of the port's kernels, the
updated full parameters and Adam moment ``mu`` (gathered, ``TrainState``'s
flat layout, with its leaves' ``names``; from rank 0 only) and, with ``spec["reps"]``, the step's times (CUDA events on the
card) and, in a dp group, the times of its all-reduce alone.

``spec`` keys: ``model`` (ModelConfig fields), ``seed`` (the weights'
seed) or ``weights`` (a state_dict of arrays), ``batch`` ({"inp", "tgt"}
of arrays at the global batch), ``eps`` (optional, the global batch's
reparameterisation noise), ``rng``, ``consts`` (klw_g, klw_l, lr), ``dp``,
``tp``, ``device``, and ``reps`` / ``warmup`` (timed steps after the
checked one).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

# the JAX dry run's tiny flagship (__graft_entry__.py): the real
# architecture at widths that tp = 2 divides
DRYRUN_MODEL = dict(seqemb_dim=16, d_model=32, nhead=4, ff=64, nlayers=2,
                    z_global=16, z_local=8, decoder_hidden=16,
                    decoder_layers=2, max_neighbors=4)


def example_batch(seqemb_dim: int, B: int, L: int, seed: int = 0) -> dict:
    """The JAX dry run's batch (``_example_batch``): N(0, 3) coordinates,
    N(0, 1) embeddings and dihedrals, a full mask, labels 0; input and
    target the same conformer."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    conf = dict(seq_emb=rng.normal(0, 1, (B, L, seqemb_dim)).astype(f32),
                n=rng.normal(0, 3, (B, L, 3)).astype(f32),
                ca=rng.normal(0, 3, (B, L, 3)).astype(f32),
                c=rng.normal(0, 3, (B, L, 3)).astype(f32),
                dihedrals=rng.normal(0, 1, (B, L, 6)).astype(f32),
                mask=np.ones((B, L), f32))
    conf["seq_labels"] = np.zeros((B, L), np.int32)
    return {"inp": conf, "tgt": dict(conf)}


def _model(spec: dict, device):
    import torch

    from protein_ensemble_vae_torch.config import ModelConfig
    from protein_ensemble_vae_torch.models import HierCVAE

    torch.manual_seed(spec.get("seed", 0))
    model = HierCVAE(ModelConfig(**spec["model"]))
    if spec.get("weights") is not None:
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in spec["weights"].items()})
    return model.to(device)


def _run(spec: dict, device, mesh=None) -> dict:
    """The checked step (launch counts reset just before it and read just
    after), then the timed steps."""
    import torch

    from protein_ensemble_vae_torch.config import LossWeights
    from protein_ensemble_vae_torch.models.bridge import gather_params
    from protein_ensemble_vae_torch.ops.kernels import LAUNCHES, reset_launches
    from protein_ensemble_vae_torch.parallel.mesh import (make_parallel_step,
                                                          shard_model)
    from protein_ensemble_vae_torch.train.training import (TrainState,
                                                           make_train_step)

    model = _model(spec, device)
    if mesh is not None:
        shard_model(model, mesh)
    step = make_train_step(model, LossWeights(), train=True, mesh=mesh)
    if mesh is not None:
        step = make_parallel_step(mesh)(step)
    state = TrainState.create(model)
    batch = {side: {k: torch.as_tensor(v, device=device) for k, v in d.items()}
             for side, d in spec["batch"].items()}
    eps = spec.get("eps")
    if eps is not None:
        eps = tuple(torch.as_tensor(e, device=device) for e in eps)
    consts = [torch.tensor(v, dtype=torch.float32, device=device)
              for v in spec["consts"]]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    sync()
    reset_launches()
    state, metrics = step(state, batch, spec["rng"], *consts, eps=eps)
    sync()
    out = dict(launches=dict(LAUNCHES),
               loss=float(metrics["loss"]),
               metrics={k: float(v) for k, v in metrics.items()})
    weights = {k: v.detach() for k, v in model.state_dict().items()}
    tp = getattr(model, "tp", None)
    if tp is not None:
        weights = gather_params(weights, tp)
    mu = state.optimizer_state()["mu"]
    if mesh is None or mesh.rank == 0:     # copies: the timed steps move the state
        out["params"] = {k: v.cpu().numpy().copy() for k, v in weights.items()}
        out["mu"] = mu.numpy().copy()
        out["names"] = list(state.names)    # mu's leaves, in order

    times = []
    for i in range(spec.get("warmup", 0) + spec.get("reps", 0)):
        ms = _timed_ms(lambda: step(state, batch, spec["rng"] + 1 + i, *consts), device)
        if i >= spec.get("warmup", 0):
            times.append(ms)
    out["step_ms"] = times
    if times and mesh is not None and mesh.dp_group is not None:
        # the dp all-reduce alone: the flat gradient and the metrics
        buf = torch.zeros(state.flat.numel() + len(metrics), device=device)
        out["allreduce_ms"] = [_timed_ms(lambda: mesh.dp_sum(buf), device)
                               for _ in range(len(times))]
    return out


def _timed_ms(fn, device) -> float:
    """``fn()``'s time: CUDA events on the card, the host clock on the CPU."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def parity_step(spec: dict) -> dict:
    """One rank's part of ``spec``'s dp x tp step (run by ``launch``)."""
    import torch.distributed as dist

    from protein_ensemble_vae_torch.parallel.mesh import current_device, make_mesh

    mesh = make_mesh(spec["dp"], spec["tp"])
    device = current_device(spec["device"])
    return dict(_run(spec, device, mesh), rank=mesh.rank,
                backend=dist.get_backend(), device=str(device))


def single_step(spec: dict) -> dict:
    """``spec``'s step in this process alone."""
    import torch

    return _run(spec, torch.device(spec["device"]))


def epoch_worker(spec: dict) -> dict:
    """One rank of an eval epoch (``run_epoch``) over ``spec["batches"]``
    (PairBatches of any size): a batch that dp divides is sharded, the
    others run whole on every rank. Returns the epoch's statistics."""
    from protein_ensemble_vae_torch.config import LossWeights
    from protein_ensemble_vae_torch.parallel.mesh import (current_device, make_mesh,
                                                          make_parallel_step,
                                                          shard_model)
    from protein_ensemble_vae_torch.train.training import (TrainState,
                                                           make_train_step,
                                                           run_epoch)

    mesh = make_mesh(spec["dp"], spec["tp"])
    device = current_device(spec["device"])
    model = shard_model(_model(spec, device), mesh)
    step = make_parallel_step(mesh)(make_train_step(model, LossWeights(), train=False,
                                                    mesh=mesh))
    fallback = make_train_step(model, LossWeights(), train=False, mesh=mesh.without_dp())
    _, stats = run_epoch(TrainState.create(model), step, iter(spec["batches"]),
                         spec["rng"], *spec["consts"], model.config.seqemb_dim,
                         dp=mesh.dp, fallback_step_fn=fallback)
    return stats


def train_worker(spec: dict) -> dict:
    """One rank of ``train_model`` on ``spec["run_config"]`` (a RunConfig
    whose ``train.dp`` / ``train.tp`` give the mesh) over the pair datasets
    of ``spec["manifests"]`` (train, val); with ``spec["local_batches"]``
    each dp shard is fed its own batches by ``make_sharded_epoch_batches``,
    as ``--multihost`` feeds them. Returns the loss history."""
    import functools

    from protein_ensemble_vae_torch.data import EnsembleDataset
    from protein_ensemble_vae_torch.data.collate import make_sharded_epoch_batches
    from protein_ensemble_vae_torch.parallel.mesh import (current_device, make_mesh,
                                                          shard_model)
    from protein_ensemble_vae_torch.train.training import train_model

    cfg = spec["run_config"]
    mesh = make_mesh(cfg.train.dp, cfg.train.tp)
    device = current_device(spec["device"])
    model = shard_model(_model(dict(spec, model=dataclasses.asdict(cfg.model)),
                               device), mesh)
    train_ds, val_ds = (EnsembleDataset(m, use_seqemb=True) for m in spec["manifests"])
    make_batches = None
    if spec["local_batches"]:
        make_batches = functools.partial(make_sharded_epoch_batches,
                                         process_index=mesh.dp_rank,
                                         process_count=mesh.dp)
    _, history = train_model(model, train_ds, val_ds, cfg, make_batches=make_batches,
                             mesh=mesh, local_batches=spec["local_batches"])
    return history


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout_s: float = 600.0, store_dir=None) -> str:
    """Launch ``n_devices`` ranks, take the sharded step, hold its loss
    against the single-process step at rtol 1e-5; returns the parity line.
    It runs on the GPU unless ``device`` is "cpu", and raises without a GPU
    (as the CLIs do)."""
    from protein_ensemble_vae_torch.ops.routing import resolve_device
    from protein_ensemble_vae_torch.parallel.mesh import launch

    resolve_device(device)

    if n_devices >= 4 and n_devices % 2 == 0:
        dp, tp = n_devices // 2, 2
    else:
        dp, tp = n_devices, 1
    # decoder hidden 16, which the band kernels (32-256) do not take: the
    # plain band path on every device
    model = dict(DRYRUN_MODEL, use_pallas_egnn=False)
    spec = dict(model=model, seed=0, rng=1, consts=(1.0, 0.5, 1e-4), dp=dp,
                tp=tp, device=device,
                batch=example_batch(model["seqemb_dim"], 2 * dp, 32))
    ref = single_step(spec)
    ranks = launch(parity_step, n_devices, (spec,), device=device,
                   timeout_s=timeout_s, store_dir=store_dir)
    loss, loss_1 = ranks[0]["loss"], ref["loss"]
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun loss not finite: {loss}")
    if any(r["loss"] != loss for r in ranks):
        raise RuntimeError(f"ranks disagree on the loss: {[r['loss'] for r in ranks]}")
    if abs(loss - loss_1) > 1e-5 * abs(loss_1):
        raise RuntimeError(f"sharded loss {loss!r} != single-process loss {loss_1!r} "
                           "(rtol 1e-5)")
    return (f"[dryrun_multichip] mesh dp={dp} tp={tp}: one train step OK, "
            f"sharded loss={loss:.6f} == single-device loss={loss_1:.6f} "
            f"(rtol 1e-5 parity)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=8, help="number of ranks")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="where the ranks run (default cuda; pass cpu to run "
                         "on the CPU)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the ranks may take in all")
    args = ap.parse_args(argv)
    print(dryrun_multichip(args.n, args.device, args.timeout), flush=True)


if __name__ == "__main__":
    main()
