"""The spread of a bf16 train step's parameter gradients at default widths,
per tensor, between the three ways ``chip_smoke.py:_compare_paths`` runs the
same bf16 step: the kernel path (kernels 1-2 in their bf16-model mode, one
TF32 pass), the kernels' plain version (the fp32 chain in full fp32) and
the plain path (the band's chain in bf16).

For each draw (model seed x reparameterisation-noise seed) it records, per
parameter tensor, |g - w| / |w| (Frobenius) of the kernel path against the
kernels' plain version and of the plain path against the same, for the
smooth objective that ``_compare_paths`` holds, as
``chip_smoke.bf16_rel_gaps`` reads it (the attention key biases, zero
analytically, as |g| / |query-bias gradient|).
Writes per-tensor maxima over the draws and the largest readings.

Run on the card:

    python scripts/bf16_grad_spread.py --out chiprun_out/bf16_grad_spread.json

Needs a GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-seeds", type=int, default=2)
    ap.add_argument("--eps-seeds", type=int, default=4)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from protein_ensemble_vae_torch.config import LossWeights, ModelConfig
    from protein_ensemble_vae_torch.models import HierCVAE

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    B, L = cs.TRAIN_HEADLINE
    mcfg = ModelConfig()
    weights = LossWeights(**cs.SMOOTH_WEIGHTS)
    pairs = {"kernel path vs kernels' plain version": {},
             "plain path (bf16 chain) vs kernels' plain version": {}}
    draws = []
    for ms in range(args.model_seeds):
        torch.manual_seed(cs.SEED + ms)
        kmodel = HierCVAE(mcfg, dtype=torch.bfloat16).to("cuda")
        pmodel = HierCVAE(dataclasses.replace(mcfg, use_pallas_egnn=False),
                          dtype=torch.bfloat16).to("cuda")
        pmodel.load_state_dict(kmodel.state_dict())
        batch = cs._step_batch(B, L, 230, cs.SEED + 8, mcfg.seqemb_dim)
        for es in range(args.eps_seeds):
            g = torch.Generator(device="cuda").manual_seed(cs.SEED + 5 + es)
            eps = (torch.randn(B, mcfg.z_global, generator=g, device="cuda"),
                   torch.randn(B, L, mcfg.z_local, generator=g, device="cuda"))

            def grads(model, plain=False):
                with cs._band_plain_version() if plain else cs.contextlib.nullcontext():
                    _, gr = cs._path_grads(model, batch, weights, eps)
                return {n: t.clone() for n, t in gr.items()}

            kg, vg, cg = grads(kmodel), grads(kmodel, plain=True), grads(pmodel)
            for label, got in zip(pairs, (kg, cg)):
                gaps = cs.bf16_rel_gaps(got, vg)
                for n, r in gaps.items():
                    pairs[label][n] = max(pairs[label].get(n, 0.0), r)
                worst = max(gaps, key=gaps.get)
                draws.append(dict(model_seed=ms, eps_seed=es, pair=label,
                                  worst=gaps[worst], worst_name=worst,
                                  above_0_1=sum(r > 0.1 for n, r in gaps.items()
                                                if not n.endswith("key.bias"))))
                print(f"model {ms} eps {es} {label}: worst {gaps[worst]:.4f} ({worst})",
                      flush=True)
        del kmodel, pmodel
        torch.cuda.empty_cache()
    out = dict(device=torch.cuda.get_device_name(0), shape=f"B{B}/L{L}",
               draws=draws, n_tensors=len(next(iter(pairs.values()))))
    for label, m in pairs.items():
        top = sorted(m.items(), key=lambda kv: -kv[1])[:args.top]
        out[label] = dict(top=top)
        print(label)
        for n, r in top:
            print(f"  {n}: {r:.4f}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
