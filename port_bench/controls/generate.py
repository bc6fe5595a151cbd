"""Readings of a generation cell's sound runs and of its control, on the
calls a run would check (the first call of the longest structure and
others drawn from the seed, each with the call seed a run gives it, out
of two cycles of the window's calls):

- sound: the program's ``generate_ensembles`` on those calls, judged
  against the fp32 reference (``drivers.generate.judge``), as a run
  judges them;
- the control: the reference in the program's place one precision
  lower, its products in TF32 and its chain rebuild in float32, judged
  the same way (its reconstruction and models printed as a PDB file
  prints them, every sample kept).

Half the samples decoded reads inf (the shapes differ) without a run.
Besides each seed's numbers it prints each call's per-sample gaps.

    python -m port_bench.controls.generate --workload <cell> --seeds <n> ... [--control <n>]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from port_bench import harness
from port_bench.data import log_uniform_lengths, make_structures
from port_bench.drivers import generate as G
from port_bench.reference.train import fold_seed


def checked_calls(tr: dict, seed: int, lengths: list) -> list:
    """The calls a run of ``seed`` checks, from two cycles of its window."""
    from protein_ensemble_vae_torch.data.collate import bucket_for

    cycle = G.order(lengths, tuple(tr["buckets"]))
    calls = [dict(structure=cycle[k % len(cycle)], seed=fold_seed(seed, 6, k),
                  bucket=bucket_for(lengths[cycle[k % len(cycle)]], tuple(tr["buckets"])))
             for k in range(2 * len(cycle))]
    return G.sample_calls(calls, lengths, tr["checked_ensembles"],
                          np.random.default_rng([seed, 7]))


def _set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on


def readings(cell, seed: int, device, control: bool = True) -> dict:
    from protein_ensemble_vae_torch.infer.generate import generate_ensembles
    from protein_ensemble_vae_torch.infer.refine import clear_graphs

    from port_bench.reference.generate import torsion_kwargs
    from port_bench.reference.model import HierCVAE
    from port_bench.reference.refine import torsion

    tr = cell.traffic
    model, w0, cfg = G.setup_model(cell, seed, device)
    lengths = log_uniform_lengths(*tr["lengths"], tr["structures"])
    structures = make_structures(lengths, 1, np.random.default_rng([seed, 1]),
                                 cfg["seqemb_dim"], tr["fold_tries"], device)
    calls = checked_calls(tr, seed, lengths)
    out_root = tempfile.mkdtemp(prefix="port_bench_control_")
    try:
        capture = G.Capture()
        for k, call in enumerate(calls):
            d = os.path.join(out_root, f"call{k}")
            i = call["structure"]
            res = generate_ensembles(model, G._view(structures[i], f"s{i:02d}"), d,
                                     seed=call["seed"], **G._kwargs(tr))["results"][0]
            sid = res["structure"]
            call.update(start=capture.start, cartesian=capture.cartesian, final=capture.final,
                        rec=G.read_backbone(os.path.join(d, f"{sid}_reconstruction.pdb"))[0],
                        models=G.read_backbone(os.path.join(d, f"{sid}_ensemble.pdb")))
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    del model
    clear_graphs()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref_model = HierCVAE(cfg).to(device)
    ref_model.load_state_dict(w0)
    tk = torsion_kwargs(tr)
    out = {"seed": seed, "sound": {}, "detail": []}
    if control:
        out["control"] = {}
    for call in calls:
        t0 = time.perf_counter()
        L = len(structures[call["structure"]]["seq_labels"])
        _set_tf32(False)
        ref = G.reference_chain(ref_model, structures[call["structure"]], call, tr, device)
        fin = torsion(call["cartesian"], ref["mask"], **tk)
        sound = G.judge(call, ref, fin, L)
        det = dict(L=L, cart=G.sample_gaps(call["cartesian"], ref["cart"], L).tolist(),
                   torsion=G.sample_gaps(call["final"], fin, L).tolist(),
                   models=G.model_gaps(call["models"], fin).tolist())
        if control:
            _set_tf32(True)
            c = G.reference_chain(ref_model, structures[call["structure"]], call, tr, device)
            final = torsion(c["cart"], c["mask"], nerf_dtype=torch.float32, **tk)
            _set_tf32(False)
            fin_c = torsion(c["cart"], c["mask"], **tk)
            got = dict(start=c["dec"], cartesian=c["cart"], final=final,
                       rec=G.pdb_digits(c["rec"][:L].cpu().numpy()),
                       models=G.pdb_digits(final[:, :, :L].permute(1, 2, 0, 3).cpu().numpy()))
            for k, v in G.judge(got, ref, fin_c, L).items():
                out["control"][k] = max(out["control"].get(k, 0.0), v)
            det.update(control_cart=G.sample_gaps(c["cart"], ref["cart"], L).tolist(),
                       control_torsion=G.sample_gaps(final, fin_c, L).tolist(),
                       control_models=G.model_gaps(got["models"], fin_c).tolist())
        for k, v in sound.items():
            out["sound"][k] = max(out["sound"].get(k, 0.0), v)
        det["seconds"] = time.perf_counter() - t0
        out["detail"].append(det)
    return out


def main(argv=None) -> int:
    harness.set_cache_env()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=None,
                    help="read the control on the first n seeds only (default: all)")
    args = ap.parse_args(argv)
    cell = harness.load_cell(harness.ROOT, args.workload)
    harness.require_cuda(cell.chips)
    from protein_ensemble_vae_torch.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    n = len(args.seeds) if args.control is None else args.control
    for k, seed in enumerate(args.seeds):
        print(json.dumps(readings(cell, seed, torch.device("cuda:0"), control=k < n)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
