#!/usr/bin/env python3
"""A checkpoint's generation battery on the kernel path and on the kernels'
plain versions, on one card: whether a kernel moves the battery's quality.

    python scripts/battery_paths.py --checkpoint DIR --manifest CSV --out_dir DIR \
        [--tag NAME] [-- <cli.generate refine flags>]

Runs ``cli.generate`` (20 samples, temperature 0.7, ``--device cuda``, the
refine flags after ``--``) then ``cli.analyze`` in this process, once per
path into ``OUT_DIR/generated_<tag>_<path>/`` and
``OUT_DIR/analysis_<tag>_<path>.txt``:

- ``kernel``: as a user runs it: kernel 1 in the decoder, kernels 3-4 in
  the refiners' clash term;
- ``plain``: every routing decision (``pallas_policy`` in
  ``ops/kernels/egnn_band.py``, ``losses.py`` and ``infer/refine.py``)
  answers no, so the decoder and the clash term run the kernels' plain
  PyTorch versions on the card.

The refiners' CUDA graphs (``infer/refine.py``, cached per shape and step
count) are cleared before each path: a graph captured on one path would
replay that path's kernels in the other.

The launch counts of each run are read (the plain run must launch no
kernel, the kernel run must launch kernel 1) and, with each analysis's
aggregate and the card's name and power limit, written to
``OUT_DIR/battery_<tag>.json``. Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


@contextlib.contextmanager
def plain_routing():
    """Every kernel routed to its plain version inside the block."""
    import protein_ensemble_vae_torch.infer.refine as refine
    import protein_ensemble_vae_torch.losses as losses
    from protein_ensemble_vae_torch.ops.kernels import egnn_band

    mods = (egnn_band, losses, refine)
    orig = [m.pallas_policy for m in mods]
    for m in mods:
        m.pallas_policy = lambda t, use_pallas="auto": False
    try:
        yield
    finally:
        for m, o in zip(mods, orig):
            m.pallas_policy = o


def aggregate(path: str) -> dict:
    """The AGGREGATE block of a ``cli.analyze`` report."""
    with open(path) as f:
        text = f.read().split("AGGREGATE", 1)[1]
    return {k.strip(): float(v) for k, v in (line.split(":", 1) for line in text.splitlines()
                                             if ":" in line)}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--tag", default="battery")
    ap.add_argument("--num_samples", default="20")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from protein_ensemble_vae_torch.cli import analyze, generate
    from protein_ensemble_vae_torch.infer.refine import clear_graphs
    from protein_ensemble_vae_torch.ops.kernels import LAUNCHES, reset_launches

    out = dict(checkpoint=args.checkpoint, refine_flags=extra, paths={},
               card=card() if args.device == "cuda" else "not measured (cpu)")
    for path in ("kernel", "plain"):
        gen_dir = os.path.join(args.out_dir, f"generated_{args.tag}_{path}")
        report = os.path.join(args.out_dir, f"analysis_{args.tag}_{path}.txt")
        gen_argv = ["--checkpoint", args.checkpoint, "--manifest", args.manifest,
                    "--num_samples", args.num_samples, "--temperature", "0.7",
                    "--output_dir", gen_dir, "--device", args.device] + extra
        clear_graphs()
        with plain_routing() if path == "plain" else contextlib.nullcontext():
            reset_launches()
            generate.main(gen_argv)
            if args.device == "cuda":
                torch.cuda.synchronize()
            launches = dict(LAUNCHES)
        analyze.main(["--pdb_dir", gen_dir, "--output", report, "--device", args.device])
        if args.device == "cuda" and (
                (path == "plain" and any(launches.values()))
                or (path == "kernel" and not launches["egnn_band_fwd"])):
            raise RuntimeError(f"{path} path launched {launches}")
        out["paths"][path] = dict(launches=launches, aggregate=aggregate(report),
                                  generate_argv=gen_argv)
        print(f"[battery] {args.tag} {path}: launches {launches}; "
              f"{out['paths'][path]['aggregate']}", flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, f"battery_{args.tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
