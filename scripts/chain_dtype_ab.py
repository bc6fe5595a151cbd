"""The EGNN band kernels' edge-chain dtype on one NVIDIA GPU: the bf16 chain
(``chain_dtype=torch.bfloat16``) against the fp32 chain, the port's
counterpart of the JAX package's ``scripts/chain_dtype_onchip.py``.

    python scripts/chain_dtype_ab.py [--out FILE.json]

At that script's shape, B16/L256/Hd256/W40, on inputs of its scales (a, bs
~ N(0, 0.3^2), x ~ N(0, 3^2), ~10 % of residues masked, small weights; a
seeded torch generator), through ``egnn_band_fused`` on CUDA tensors
(``EGNNBandFunction``: kernel 1 forward, kernel 2 backward):

- values: the bf16 chain's forward against the fp32 chain's at fp32
  accuracy (``precision="highest"``), as the relative max of ``agg`` and of
  ``raw_delta`` (max |difference| / max |fp32|), and the worst such gap over
  the gradients of loss = 1e-3 (sum agg^2 + sum raw_delta^2) with respect to
  the ten differentiable inputs;
- times: forward + backward of that loss per call in the bf16 chain, the
  fp32 chain with one-pass TF32 products (``precision="default"``, the JAX
  script's ``precision=None``) and the fp32 chain in 3xTF32
  (``"highest"``): CUDA events around N back-to-back calls after warm-up
  (``chip_smoke._median_ms``), in turns (fp32, bf16, bf16, fp32 for each
  fp32 precision) in this one process.

Then the same at B4/L256/W40 at Hd 512 and 1024 (WIDER: the widths whose
bf16 chain runs on the shared-tile and the wide Hopper kernels; the edge
weights' scales divided by sqrt(Hd / 256), so the activations keep the
reference shape's scale), the times over fewer windows (WIDER_REPS of at
least WIDER_LAUNCHES calls), under ``wider``.

Prints one JSON line with the card's name and power limit. ``run()`` is the
mode's path in ``chip_smoke.py``: at Hd 256, 512 and 1024 it launches each
Hopper family in the bf16 chain. Needs a GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

B, L, HD, W = 16, 256, 256, 40
SEED = 0
WIDER = ((4, 256, 512), (4, 256, 1024))   # (B, L, Hd) after the reference shape
WIDER_REPS, WIDER_LAUNCHES = 3, 5
NAMES = ("a", "bs", "x", "w_d", "w_e2", "b_e2", "w_x1", "b_x1", "w_x2", "b_x2")


def make_inputs(seed: int = SEED, b: int = B, l: int = L, hd: int = HD) -> list:
    """The JAX script's inputs and scales (``make_inputs``), from a seeded
    torch generator: (a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2,
    b_x2), fp32, on the card; at another width the [hd, hd] and [hd, 1]
    weights' scales divided by sqrt(hd / HD)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    n = lambda shape, sd: torch.randn(shape, generator=g) * sd  # noqa: E731
    a, bs = n((b, l, hd), 0.3), n((b, l, hd), 0.3)
    x = n((b, l, 3), 3.0)
    cm = (torch.rand((b, l), generator=g) > 0.1).float()
    sw = 0.06 * (HD / hd) ** 0.5
    params = (n((1, hd), 0.05), n((hd, hd), sw), n((hd,), 0.05), n((hd, hd), sw),
              n((hd,), 0.05), n((hd, 1), sw), n((1,), 0.05))
    return [t.cuda().contiguous() for t in (a, bs, x, cm) + params]


def _rel(got, want) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def run(seed: int = SEED) -> dict:
    """The A/B at B16/L256/Hd256/W40, then at WIDER: value gaps of the bf16
    chain against the fp32 chain and fwd+bwd ms per call of each (module
    docstring)."""
    out = _ab(seed, B, L, HD)
    out["wider"] = [_ab(seed, b, l, hd, dict(reps=WIDER_REPS, min_launches=WIDER_LAUNCHES))
                    for b, l, hd in WIDER]
    return out


def _ab(seed: int, b: int, l: int, hd: int, timing: dict | None = None) -> dict:
    """One shape's A/B; ``timing``: ``_median_ms``'s windows."""
    import torch

    from protein_ensemble_vae_torch.ops.kernels.egnn_band import egnn_band_fused

    args = make_inputs(seed, b, l, hd)
    cm = args[3]
    diff = [t.clone().requires_grad_(True) for t in args[:3] + args[4:]]

    def fwd(precision, chain):
        return egnn_band_fused(diff[0], diff[1], diff[2], cm, *diff[3:], W,
                               precision, chain, use_pallas="auto")

    def step(precision, chain):
        agg, delta = fwd(precision, chain)
        loss = 1e-3 * (agg.square().sum() + delta.square().sum())
        return torch.autograd.grad(loss, diff)

    with torch.no_grad():
        agg32, d32 = fwd("highest", torch.float32)
        agg16, d16 = fwd("highest", torch.bfloat16)
    g32, g16 = step("highest", torch.float32), step("highest", torch.bfloat16)
    for t in (agg16, d16) + tuple(g16):
        if not torch.isfinite(t).all():
            raise RuntimeError("chain_dtype_ab: the bf16 chain gave a non-finite value")
    grad_gaps = {n: _rel(a, b) for n, a, b in zip(NAMES, g16, g32)}
    worst = max(grad_gaps, key=grad_gaps.get)
    out = dict(shape=f"B{b}/L{l}/Hd{hd}/W{W}", seed=seed,
               fwd_agg_rel_max=_rel(agg16, agg32), fwd_delta_rel_max=_rel(d16, d32),
               bwd_worst_grad_rel_max=grad_gaps[worst], bwd_worst_grad=worst,
               grad_rel_max=grad_gaps)
    bf16 = lambda: step("default", torch.bfloat16)  # noqa: E731
    for precision in ("default", "highest"):
        fp32 = lambda p=precision: step(p, torch.float32)  # noqa: E731
        t = [cs._median_ms(f, **(timing or {})) for f in (fp32, bf16, bf16, fp32)]
        out[f"fp32_chain_{precision}_ms"] = [t[0], t[3]]
        out[f"bf16_chain_ms_vs_{precision}"] = [t[1], t[2]]
    fp32_ms = min(out["fp32_chain_default_ms"])
    out["bf16_over_fp32_default"] = min(out["bf16_chain_ms_vs_default"]) / fp32_ms
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, metavar="FILE.json",
                    help="also write the result as JSON here")
    ns = ap.parse_args(argv)
    from protein_ensemble_vae_torch.ops.routing import set_full_fp32

    device = cs.phase_device()
    set_full_fp32()
    result = dict(device=device, **run())
    if ns.out:
        os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
        with open(ns.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
