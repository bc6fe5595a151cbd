"""The single-process B4/L256 train step at the default widths (kernel path,
fp32 and bf16) in several checkouts of the repo, one process per checkout,
on one card: an A/B of two versions of the port's step.

    python scripts/train_step_ab.py --trees OLD . . OLD [--out FILE.json]

Each tree is a checkout holding ``chip_smoke.py`` and the port (for
example an earlier commit's ``git archive`` unpacked into a git-ignored
directory); it builds its own kernels. Each process takes ``chip_smoke.py``'s
B4/L256 batch (a NeRF fold of 230 residues) and random weights from its
seed, runs WARMUP steps, then times REPS steps with CUDA events and counts
the device records (kernels, copies, fills) of one more step with
torch.profiler. Prints one JSON line per tree run, in order, with the
card's name and power limit. Needs a GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

WARMUP, REPS = 3, 10


def one(tree: str) -> dict:
    """The steps of the port in ``tree``, in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from protein_ensemble_vae_torch.config import LossWeights, ModelConfig
    from protein_ensemble_vae_torch.models import HierCVAE
    from protein_ensemble_vae_torch.ops.routing import set_full_fp32
    from protein_ensemble_vae_torch.train.training import TrainState, make_train_step

    card = cs.phase_device()["smi"]
    cs.phase_build()
    set_full_fp32()
    cfg = ModelConfig()
    batch = cs._step_batch(4, 256, 230, cs.SEED + 8, cfg.seqemb_dim)
    consts = [torch.tensor(v, device="cuda") for v in (0.5, 0.25, 3e-5)]
    out = dict(tree=tree, card=card)
    for dtype in (torch.float32, torch.bfloat16):
        torch.manual_seed(cs.SEED)
        model = HierCVAE(cfg, dtype=dtype).to("cuda")
        state = TrainState.create(model)
        step = make_train_step(model, LossWeights(), train=True)
        for i in range(WARMUP):
            step(state, batch, i, *consts)
        torch.cuda.synchronize()
        times = []
        for i in range(REPS):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            step(state, batch, WARMUP + i, *consts)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(state, batch, WARMUP + REPS, *consts)
            torch.cuda.synchronize()
        records = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        out[name] = dict(median_ms=float(np.median(times)), ms=times, device_records=records)
        del model, state
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one(args.one)), flush=True)
        return
    lines = []
    for tree in args.trees:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                             capture_output=True, text=True)
        if run.returncode != 0:
            sys.stderr.write(run.stdout[-4000:] + run.stderr[-4000:])
            raise SystemExit(f"train_step_ab: the run in {tree} failed")
        lines.append(run.stdout.strip().splitlines()[-1])
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
