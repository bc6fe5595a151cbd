"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:

1. device: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; no CUDA device -> exit 1.
2. build: every CUDA source of the port, one ``nvcc`` each, in parallel,
   with ``-Xptxas -v``'s register / shared-memory / spill report.
3. kernels: each kernel's wrapper against its plain PyTorch version, on the
   card, at the shapes the main path gives it (TF32 off), with the stated
   tolerance; CUDA-event times (median over runs, after warm-up) of kernel
   and plain version, and the least time the card could take (bound).
4. main path: ``generate_ensembles`` with a fresh seeded ``HierCVAE`` at the
   default ``ModelConfig`` widths on two synthetic NeRF proteins (buckets
   256 and 640), ``num_samples=10``. Launch counts are reset just before and
   read just after: each structure makes 2 decodes x 8 EGNN layers = 16
   launches. Outputs must be finite and the PDB files written; the kernel
   decode of one latent is held against the plain decode of it.
5. one ``kernels`` JSON line, then, as the last line,
   ``{"ok": true, "device": {...}}``.

``--profile TRACE.json`` adds, after the checks, a torch.profiler pass over
the main path (device busy share, top operators by device time) and writes
its Chrome trace to ``TRACE.json``. It is not needed for the smoke run.

Imports nothing of JAX; builds from the repository's sources only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

SEED = 0
HD, W = 256, 40                       # ModelConfig decoder_hidden, max_neighbors
NUM_SAMPLES = 10
PROTEINS = (("synA", 230, 1), ("synB", 600, 2))   # id, length, fold seed
BUCKETS = (64, 128, 192, 256, 320, 384, 448, 512, 576, 640)
# Main-path kernel shapes: (B, L) = (1 | NUM_SAMPLES, bucket).
KERNEL_SHAPES = ((1, 256), (NUM_SAMPLES, 256), (1, 640), (NUM_SAMPLES, 640))
HEADLINE_SHAPE = (NUM_SAMPLES, 640)   # the shape reported in the kernels line

# Kernel vs plain version, both fp32 with sums in another order. agg and
# raw_delta are sums of 80 signed edge terms each, so an element that
# cancels to ~0 has no meaningful relative error: the absolute tolerance is
# scaled by the output's magnitude, atol = 1e-4 * max|plain|, rtol = 1e-4.
RTOL, ATOL_REL = 1e-4, 1e-4
# Kernel-path vs plain-path decode of one latent: 8 layers of the above,
# then the heads; 1e-3 A is the precision PDB files are written at.
COORD_ATOL = 1e-3

# Published dense peaks of one H100 SXM at its full 700 W (NVIDIA data
# sheet): fp32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def _median_ms(fn, warmup: int = 2, reps: int = 7) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    return dict(kind=name, count=torch.cuda.device_count(), smi=card)


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from protein_ensemble_vae_torch.ops.kernels import LAUNCHES, build

    t0 = time.perf_counter()
    report = build.build(sorted(LAUNCHES), verbose=True)
    log(f"[build] {len(report)} source(s) in "
        f"{time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------

def _egnn_inputs(B: int, L: int, seed: int):
    """Model-scale inputs: projections of unit-variance features through
    the split edge layer's init, coordinates of a ~15 A protein, the
    layer's init for the edge weights, and a masked tail on row 0."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def u(shape, fan_in):
        return (torch.rand(shape, generator=g) * 2 - 1) / np.sqrt(fan_in)

    fan_e1 = 2 * HD + 1
    a = torch.randn(B, L, HD, generator=g) * np.sqrt(HD / (3 * fan_e1))
    bs = torch.randn(B, L, HD, generator=g) * np.sqrt(HD / (3 * fan_e1))
    x = torch.randn(B, L, 3, generator=g) * 10.0
    cmask = torch.ones(B, L)
    cmask[0, L - L // 8:] = 0.0
    params = (u((1, HD), fan_e1), u((HD, HD), HD), u((HD,), HD),
              u((HD, HD), HD), u((HD,), HD), u((HD, 1), HD), u((1,), HD))
    return [t.cuda().contiguous() for t in (a, bs, x, cmask) + params]


def _egnn_bound(B: int, L: int, cmask) -> tuple[float, str, int]:
    """Least time for one launch on this run's inputs: exact valid edges
    x (4 Hd^2 + 2 Hd) FLOP over the fp32 peak, against each input read and
    each output written once over the HBM rate."""
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import band_indices

    idx, in_range = band_indices(L, W, cmask.device)
    cm = cmask > 0.5
    edges = int((in_range[None] & cm[:, :, None] & cm[:, idx]).sum())
    flops = edges * (4 * HD * HD + 2 * HD)
    nbytes = 4 * (2 * B * L * HD + B * L * 3 + B * L          # a, bs, x, cmask
                  + 2 * HD * HD + 4 * HD + 1                   # weights
                  + B * L * HD + B * L * 3)                    # agg, raw_delta
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    return 1e3 * max(t_ops, t_bytes), by, edges


def phase_kernels() -> list[dict]:
    import torch

    from protein_ensemble_vae_torch.ops.kernels.egnn_band import (
        egnn_band_fwd, egnn_band_reference)
    from protein_ensemble_vae_torch.ops.routing import set_full_fp32

    set_full_fp32()
    rows = []
    for k, (B, L) in enumerate(KERNEL_SHAPES):
        args = _egnn_inputs(B, L, SEED + k)
        agg, delta = egnn_band_fwd(*args, W)
        torch.cuda.synchronize()
        ragg, rdelta = egnn_band_reference(*args, W)
        errs = []
        for name, got, ref in (("agg", agg, ragg), ("raw_delta", delta, rdelta)):
            if not torch.isfinite(got).all():
                raise RuntimeError(f"egnn_band_fwd B{B}/L{L}: {name} not finite")
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            atol = ATOL_REL * scale
            ok = torch.allclose(got, ref, rtol=RTOL, atol=atol)
            strict = torch.allclose(got, ref, rtol=1e-4, atol=1e-4)
            log(f"[kernels] egnn_band_fwd B{B}/L{L} {name}: max abs err "
                f"{err:.3e}, max|plain| {scale:.3e}, rel {err / max(scale, 1e-30):.3e} "
                f"(rtol {RTOL}, atol {atol:.3e}) {'ok' if ok else 'FAIL'}; "
                f"within rtol 1e-4 / atol 1e-4: {strict}")
            if not ok:
                raise RuntimeError(f"egnn_band_fwd disagrees with its plain "
                                   f"version at B{B}/L{L} ({name})")
            errs.append(err)
        ms = _median_ms(lambda: egnn_band_fwd(*args, W))
        plain_ms = _median_ms(lambda: egnn_band_reference(*args, W))
        bound_ms, bound_by, edges = _egnn_bound(B, L, args[3])
        log(f"[kernels] egnn_band_fwd B{B}/L{L}: {ms:.3f} ms (plain "
            f"{plain_ms:.3f} ms), bound {bound_ms:.3f} ms by {bound_by} "
            f"({edges} valid edges), {100 * bound_ms / ms:.1f}% of bound")
        rows.append(dict(B=B, L=L, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, max_abs_err=max(errs)))
        del args, agg, delta, ragg, rdelta
    return rows


# ---------------------------------------------------------------------------
# 4. main path
# ---------------------------------------------------------------------------

def _protein_view(pid: str, L: int, seed: int, seqemb_dim: int):
    """A one-structure SingleConformerView over an in-memory NeRF fold."""
    from protein_ensemble_vae_torch.config import AA_ORDER
    from protein_ensemble_vae_torch.data.dataset import (Conformer,
                                                         SingleConformerView)
    from protein_ensemble_vae_torch.data.synthetic import (_torsions_np,
                                                           nerf_ensemble)

    n, ca, c = (v[0] for v in nerf_ensemble(L, 1, seed=seed, max_tries=16))
    mask = np.ones(L, np.float32)
    rng = np.random.default_rng(seed)
    conf = Conformer(n=n, ca=ca, c=c, mask=mask,
                     seq_emb=rng.normal(0, 1, (L, seqemb_dim)).astype(np.float32),
                     dihedrals=_torsions_np(n, ca, c, mask).astype(np.float32),
                     sequence="".join(rng.choice(list(AA_ORDER), L)),
                     protein_id=pid, h5_path="")
    ds = types.SimpleNamespace(conformers=[conf], proteins={pid: [0]})
    return SingleConformerView(ds)


def _pdb_coords(path: str) -> np.ndarray:
    with open(path) as f:
        xyz = [(float(l[30:38]), float(l[38:46]), float(l[46:54]))
               for l in f if l.startswith("ATOM  ")]
    return np.asarray(xyz, np.float64)


def setup_main_path():
    """A fresh seeded HierCVAE at the default widths on the card, and the
    two proteins (set-up, not timed)."""
    import torch

    from protein_ensemble_vae_torch.config import ModelConfig
    from protein_ensemble_vae_torch.models import HierCVAE

    cfg = ModelConfig()
    torch.manual_seed(SEED)
    model = HierCVAE(cfg).cuda().eval()
    log(f"[main] HierCVAE at default widths: "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    t0 = time.perf_counter()
    views = [_protein_view(pid, L, seed, cfg.seqemb_dim)
             for pid, L, seed in PROTEINS]
    log(f"[main] built {len(views)} NeRF proteins in "
        f"{time.perf_counter() - t0:.1f}s (set-up)")
    return model, views


def phase_main_path(model, views, out_dir: str) -> dict:
    import torch

    from protein_ensemble_vae_torch.infer.generate import generate_ensembles
    from protein_ensemble_vae_torch.models import HierCVAE
    from protein_ensemble_vae_torch.ops.kernels import LAUNCHES, reset_launches

    cfg = model.config
    # warm-up (library handles, allocator, per-shape GEMM choices), uncounted
    for view in views:
        generate_ensembles(model, view, os.path.join(out_dir, "warmup"),
                           num_samples=NUM_SAMPLES, seed=SEED, buckets=BUCKETS,
                           verbose=False)
    results, per_structure = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for view in views:
        t0 = time.perf_counter()
        out = generate_ensembles(model, view, out_dir,
                                 num_samples=NUM_SAMPLES, seed=SEED,
                                 buckets=BUCKETS)
        torch.cuda.synchronize()
        per_structure.append(time.perf_counter() - t0)
        results += out["results"]
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    expected = len(PROTEINS) * 2 * cfg.decoder_layers
    log(f"[main] launches {launches} (expected egnn_band_fwd = {expected})")
    if launches["egnn_band_fwd"] != expected:
        raise RuntimeError(f"main path launched egnn_band_fwd "
                           f"{launches['egnn_band_fwd']} times, expected {expected}")
    for r, (pid, L, _), secs in zip(results, PROTEINS, per_structure):
        sid = r["structure"]
        for suffix in ("true", "reconstruction", "ensemble"):
            path = os.path.join(out_dir, f"{sid}_{suffix}.pdb")
            if not os.path.exists(path):
                raise RuntimeError(f"missing {path}")
            xyz = _pdb_coords(path)
            if xyz.size == 0 or not np.isfinite(xyz).all():
                raise RuntimeError(f"non-finite or empty coordinates in {path}")
        for key in ("reconstruction_rmsd", "seq_recovery", "diversity"):
            if not np.isfinite(r[key]):
                raise RuntimeError(f"{sid}: {key} = {r[key]}")
        log(f"[main] {sid} L={L} (bucket {min(b for b in BUCKETS if b >= L)}): "
            f"{secs:.3f} s per structure (host clock, synchronized); "
            f"rec_rmsd {r['reconstruction_rmsd']:.3f} A, valid "
            f"{r['n_valid_samples']}/{r['n_samples']}, diversity "
            f"{r['diversity']:.3f} A")
    log(f"[main] peak device memory {peak / 2**20:.1f} MiB "
        f"(torch.cuda.max_memory_allocated)")
    if not os.path.exists(os.path.join(out_dir, "generation_summary.txt")):
        raise RuntimeError("generation_summary.txt not written")

    # The kernel decode of one ensemble latent against the plain decode.
    plain = HierCVAE(dataclasses.replace(cfg, use_pallas_egnn=False)).cuda().eval()
    plain.load_state_dict(model.state_dict())
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    L_pad = 640
    mask = torch.zeros(NUM_SAMPLES, L_pad, device="cuda")
    mask[:, :PROTEINS[1][1]] = 1.0
    z_g = torch.randn(NUM_SAMPLES, cfg.z_global, generator=g, device="cuda")
    z_l = torch.randn(NUM_SAMPLES, L_pad, cfg.z_local, generator=g, device="cuda")
    with torch.no_grad():
        got = model.decode(z_g, z_l, mask)
        want = plain.decode(z_g, z_l, mask)
    for name, a, b in zip(("N", "CA", "C"), got[:3], want[:3]):
        err = float((a - b).abs().max())
        log(f"[main] kernel vs plain decode B{NUM_SAMPLES}/L{L_pad}, {name}: "
            f"max abs err {err:.3e} A (atol {COORD_ATOL})")
        if not torch.isfinite(a).all() or err > COORD_ATOL:
            raise RuntimeError(f"kernel decode disagrees with the plain decode ({name})")
    return dict(launches=launches, per_structure=per_structure, peak=peak)


def phase_profile(model, views, out_dir: str, trace_path: str) -> None:
    """Where the time of one main-path pass goes: torch.profiler over both
    structures; device busy share, and the top operators by device time.
    The Chrome trace is written to ``trace_path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from protein_ensemble_vae_torch.infer.generate import generate_ensembles

    # one pass to warm the profiler up, one recorded pass
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for view in views:
                generate_ensembles(model, view, os.path.join(out_dir, "profile"),
                                   num_samples=NUM_SAMPLES, seed=SEED,
                                   buckets=BUCKETS, verbose=False)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
            prof.step()
    # device-side kernels and copies (the step marker spans the whole pass)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith("ProfilerStep")]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -1.0
    for a, b in spans:              # union of device intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    log(f"[profile] {len(views)} structures: wall {wall_ms:.1f} ms (profiled), "
        f"device busy {busy / 1e3:.1f} ms = {100 * busy / 1e3 / wall_ms:.1f}% "
        f"(idle {100 - 100 * busy / 1e3 / wall_ms:.1f}%), {len(events)} device events")
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=18)
    log(table)
    os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
    prof.export_chrome_trace(trace_path)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="TRACE.json", default=None,
                    help="after the checks, profile one more main-path pass "
                         "with torch.profiler and write its trace here")
    args = ap.parse_args(argv)

    device = phase_device()
    phase_build()
    rows = phase_kernels()
    model, views = setup_main_path()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        main_path = phase_main_path(model, views, out_dir)
        if args.profile:
            phase_profile(model, views, out_dir, args.profile)

    head = next(r for r in rows if (r["B"], r["L"]) == HEADLINE_SHAPE)
    kernels = [dict(
        name="egnn_band_fwd", route="cuda",
        source="protein_ensemble_vae_torch/csrc/egnn_band_fwd.cu",
        replaces="protein_ensemble_vae_tpu/ops/pallas/egnn_band.py:107",
        launches=main_path["launches"]["egnn_band_fwd"],
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None,
        shape=f"B{head['B']}/L{head['L']}/Hd{HD}/W{W}",
        shapes=rows)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()
