"""The sharded train step at the default widths on this host's cards,
against the single-process step.

    python scripts/parallel_step.py --dp 4 [--tp 1] [--out FILE.json]

Launches dp x tp ranks (``parallel.launch``: a card and NCCL per rank when
the host has a card for each, else every rank on the one card over gloo)
running ``parallel/dryrun.py``'s rank worker on a B = 2 dp, L = 256 fp32
step (``chip_smoke.py``'s batch: a NeRF fold of 230 residues, target masks
cut by 20 residues a row), random weights from seed 0; the kernel path at
tp = 1, the plain path otherwise. Holds the loss (rtol 1e-5), Adam's mu
(leaf by leaf) and the updated parameters (atol 1e-4) against the
single-process step on the same weights and batch on cuda:0
(``chip_smoke._parity``) and prints one JSON line: the card and its power
limit, the backend, the launches per rank, and CUDA-event ms (median of 5
after 2 warm-ups) of both steps and of the dp all-reduce alone. Needs a
GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dp", type=int, default=4)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)

    import torch

    from protein_ensemble_vae_torch.config import ModelConfig
    from protein_ensemble_vae_torch.parallel.dryrun import parity_step, single_step
    from protein_ensemble_vae_torch.parallel.mesh import launch

    device = cs.phase_device()
    cs.phase_build()
    cfg = ModelConfig(use_pallas_egnn="auto" if args.tp == 1 else False)
    world = args.dp * args.tp
    spec = dict(model=dataclasses.asdict(cfg), seed=cs.SEED, rng=0,
                consts=cs.PARALLEL_CONSTS, dp=args.dp, tp=args.tp, device=cs.DEVICE,
                batch=cs._parallel_batch(cfg.seqemb_dim, 2 * args.dp),
                warmup=cs.STEP_WARMUP, reps=cs.STEP_REPS)
    ref = single_step(spec)
    torch.cuda.empty_cache()
    ranks = launch(parity_step, world, (spec,), device=cs.DEVICE,
                   timeout_s=cs.PARALLEL_WAIT_S)
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    check = cs._parity(f"dp={args.dp} tp={args.tp}", ranks, ref, ref["launches"], backend)
    out = dict(card=device["smi"], count=device["count"], dp=args.dp, tp=args.tp,
               backend=backend, B=2 * args.dp, L=cs.PARALLEL_L, check=check,
               launches_by_rank=[r["launches"] for r in ranks],
               devices=[r["device"] for r in ranks],
               single_ms=float(np.median(ref["step_ms"])),
               sharded_ms=[float(np.median(r["step_ms"])) for r in ranks],
               allreduce_ms=([float(np.median(r["allreduce_ms"])) for r in ranks]
                             if args.dp > 1 else None))
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
