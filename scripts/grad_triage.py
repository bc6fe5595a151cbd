"""Which part of the kernel path moves the train step's gradient, against
float64, on one NVIDIA GPU.

    python scripts/grad_triage.py [--hd 512 384 256] [--baseline DIR] [--out FILE.json]

For each decoder width: ``ModelConfig(decoder_hidden=hd)`` with random
weights from chip_smoke.py's seed, its B4/L256 timed-step batch and noise,
the smooth part of the loss (chip_smoke.py: ``_compare_paths``). Each
path's parameter gradients are measured against the float64 plain path's
(``chip_smoke._float64_reference``, ``_f64_dist``: 1 is the gradient
tolerance), as the worst tensor and the tensors within:

- the kernel path and the plain path;
- the plain path with its band outputs x (1 + 2^-23 N(0, 1)), one fp32
  rounding step (``chip_smoke._perturbed_band``, seeds PERTURB_SEEDS);
- the kernel path with kernel 1 split into S band-offset slices (another
  summation order at the same accuracy);
- kernel 1 with the plain backward (``chip_smoke._plain_backwards``), and
  the plain forward with kernel 2.

Then kernel 2's weight grads at B4/L256 against the float64 band function
with random cotangents (``tests/test_torch_gpu.py``'s
``test_weight_grads_hold_float64_at_full_width``): its distance beside the
fp32 plain version's. ``--baseline DIR`` repeats the kernel-2 rows with
another version's ``egnn_band_bwd.cu`` (and the ``egnn_tile.cuh`` beside
it, the same C interface) built under another library name, for example
a copy with one change undone. Needs a GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

SLICES = (1, 2, 5)


@contextlib.contextmanager
def _swapped(module, name: str, value):
    """``module.name`` set to ``value`` inside the block."""
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _bind_bwd(path: str):
    """Kernel 2's library at ``path`` bound as ``ops/kernels/egnn_band.py``
    binds its own (``_bwd_kernel_fn``)."""
    lib = ctypes.CDLL(path)
    fn = lib.egnn_band_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.egnn_band_bwd_error_string.argtypes = [ctypes.c_int]
    lib.egnn_band_bwd_error_string.restype = ctypes.c_char_p
    lib.egnn_band_bwd_scratch_floats.argtypes = [ctypes.c_int] * 7
    lib.egnn_band_bwd_scratch_floats.restype = ctypes.c_size_t
    lib.egnn_band_bwd_blocks_per_sm.argtypes = [ctypes.c_int] * 4
    lib.egnn_band_bwd_blocks_per_sm.restype = ctypes.c_int
    return fn, lib


def _build_bwd(src_dir: str) -> str:
    from protein_ensemble_vae_torch.ops.kernels.build import NVCC_FLAGS, nvcc_path

    out = os.path.join(src_dir, "libegnn_band_bwd_baseline.so")
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", out,
                    os.path.join(src_dir, "egnn_band_bwd.cu")], check=True,
                   capture_output=True)
    return out


def _weight_grads(hd: int) -> dict:
    """Kernel 2 and its fp32 plain version at B4/L256/W40 (random
    cotangents) against the float64 band function: distance per gradient."""
    import torch

    from protein_ensemble_vae_torch.ops.kernels.egnn_band import (
        band_chain, band_indices, egnn_band_bwd, egnn_band_bwd_reference)

    B, L, W = 4, 256, cs.W
    args = cs._egnn_inputs(B, L, cs.SEED + 7, hd)
    g = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED + hd)
    g_agg = torch.randn(B, L, hd, generator=g, device=cs.DEVICE)
    g_delta = torch.randn(B, L, 3, generator=g, device=cs.DEVICE)
    got = egnn_band_bwd(*args, g_agg, g_delta, W)
    plain = egnn_band_bwd_reference(*args, g_agg, g_delta, W)
    idx, in_range = band_indices(L, W, args[0].device)
    cm = args[3] > 0.5
    valid = in_range[None] & cm[:, :, None] & cm[:, idx]
    diff = [t.double().requires_grad_(True) for t in args[:3] + args[4:]]
    outs = band_chain(diff[0], diff[1], diff[2], idx, valid, *diff[3:], torch.float64)
    exact = torch.autograd.grad(outs, diff, (g_agg.double(), g_delta.double()))
    return {n: dict(kernel=cs._f64_dist(k, r), plain=cs._f64_dist(p, r))
            for n, k, p, r in zip(cs.GRAD_NAMES, got, plain, exact)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hd", type=int, nargs="+", default=[512, 384, 256])
    ap.add_argument("--baseline", default=None, metavar="DIR",
                    help="directory with another egnn_band_bwd.cu and egnn_tile.cuh")
    ap.add_argument("--out", default=None, metavar="FILE.json")
    args = ap.parse_args(argv)

    import torch

    from protein_ensemble_vae_torch.config import LossWeights, ModelConfig
    from protein_ensemble_vae_torch.models import HierCVAE
    from protein_ensemble_vae_torch.ops.kernels import egnn_band as eb
    from protein_ensemble_vae_torch.ops.routing import set_full_fp32

    device = cs.phase_device()
    cs.phase_build()
    set_full_fp32()
    libs = {"current": eb._bwd_kernel_fn()}
    if args.baseline:
        libs["baseline"] = _bind_bwd(_build_bwd(os.path.abspath(args.baseline)))
    weights = LossWeights(**cs.SMOOTH_WEIGHTS)
    rows = []
    for hd in args.hd:
        mcfg = ModelConfig(decoder_hidden=hd)
        torch.manual_seed(cs.SEED)
        kmodel = HierCVAE(mcfg).to(cs.DEVICE)
        pmodel = HierCVAE(dataclasses.replace(mcfg, use_pallas_egnn=False)).to(cs.DEVICE)
        pmodel.load_state_dict(kmodel.state_dict())
        rmodel = cs._float64_reference(kmodel)
        B, L = cs.TRAIN_HEADLINE
        batch = cs._step_batch(B, L, cs.TIMED_STEPS[0]["L_real"], cs.SEED + 8, mcfg.seqemb_dim)
        batch64 = {s: {k: v.double() if v.is_floating_point() else v for k, v in d.items()}
                   for s, d in batch.items()}
        g = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED + 5)
        eps = (torch.randn(B, mcfg.z_global, generator=g, device=cs.DEVICE),
               torch.randn(B, L, mcfg.z_local, generator=g, device=cs.DEVICE))
        rg = cs._path_grads(rmodel, batch64, weights, tuple(e.double() for e in eps))[1]

        def reading(path, model, ctx=None):
            with ctx or contextlib.nullcontext():
                grads = cs._path_grads(model, batch, weights, eps)[1]
            dist = {n: cs._f64_dist(grads[n], rg[n]) for n in rg}
            worst = sorted(dist, key=dist.get, reverse=True)[:3]
            row = dict(hd=hd, path=path, worst=dist[worst[0]],
                       within=sum(v <= 1 for v in dist.values()), n=len(dist),
                       farthest={n: dist[n] for n in worst})
            cs.log(f"[triage] Hd{hd} {path}: worst {row['worst']:.2f} ({worst[0]}), "
                   f"{row['within']}/{row['n']} within")
            rows.append(row)

        plain_forward = lambda: _swapped(eb, "egnn_band_fwd",  # noqa: E731
                                         lambda a, bs, x, cm, *rest: eb.egnn_band_reference(
                                             a, bs, x, cm, *rest[:8]))
        reading("kernel path", kmodel)
        reading("plain path", pmodel)
        for s in cs.PERTURB_SEEDS:
            reading(f"plain path, band outputs perturbed (seed {s})", pmodel,
                    cs._perturbed_band(s))
        for S in SLICES:
            reading(f"kernel path, kernel 1 in {S} offset slices", kmodel,
                    _swapped(eb, "fwd_plan", lambda *a, S=S, **kw: S))
        reading("kernel 1, plain backward", kmodel, cs._plain_backwards())
        for name, lib in libs.items():
            eb._BWD_FN = lib
            eb._PER_SM.clear()
            reading(f"plain forward, {name} kernel 2", kmodel, plain_forward())
            wg = _weight_grads(hd)
            worst = max(wg, key=lambda n: wg[n]["kernel"])
            cs.log(f"[triage] Hd{hd} {name} kernel 2's gradients at B4/L256 against float64: "
                   f"worst {wg[worst]['kernel']:.2f} ({worst}; fp32 plain "
                   f"{wg[worst]['plain']:.2f}); "
                   + ", ".join(f"{n} {v['kernel']:.2f}/{v['plain']:.2f}" for n, v in wg.items()))
            rows.append(dict(hd=hd, path=f"{name} kernel 2, weight grads", grads=wg))
        eb._BWD_FN = libs["current"]
        eb._PER_SM.clear()
        del kmodel, pmodel, rmodel
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=device, rows=rows), f)


if __name__ == "__main__":
    main()
