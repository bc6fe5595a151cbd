"""Time the port's EGNN band kernels (1: forward, 2: backward) against a
baseline build of other sources, on one NVIDIA GPU, in the same process.

    python scripts/band_kernels_ab.py --baseline DIR [--out FILE.json]

DIR holds ``egnn_band_fwd.cu``, ``egnn_band_bwd.cu`` and ``egnn_tile.cuh`` of
the version to compare with, for example an earlier commit's
``protein_ensemble_vae_torch/csrc/`` extracted with ``git show`` into a
git-ignored directory. They must have the C interface of the bf16-model
mode or later: ``egnn_band_fwd_launch(15 pointers, B, L, hd, W, S, bf16_in,
passes[, chain_bf16], stream)``, ``egnn_band_bwd_launch(22 pointers, B, L,
hd, W, G, nsplit, bf16_in, passes[, chain_bf16], stream)``,
``egnn_band_bwd_scratch_floats(B, L, hd, W, G, nsplit[, chain_bf16])`` and
``egnn_band_{fwd,bwd}_blocks_per_sm(hd, bf16_in, passes[, chain_bf16])``;
the ``chain_bf16`` argument is passed where the baseline's
``egnn_band_fwd.cu`` names it. The script builds them with ``nvcc`` under
other library names, holds both versions against the plain PyTorch
versions at chip_smoke.py's tolerances, and times them in turns (baseline,
current, current, baseline; chip_smoke.py's ``_median_ms``) at the main
path's shapes, in each mode both versions have: fp32 ``a`` / ``bs`` in
3xTF32 (``float32/highest``), bf16 ``a`` / ``bs`` with one TF32 pass
(``bfloat16/default``) and, where the baseline has it, the bf16 chain
(``bfloat16/bfloat16_chain``). Kernel 1 at generation's B1/B10 x
L256/L640 and the training shapes B4/L256, B2/L640; kernel 2 at the
training shapes. The current version runs through the package's wrappers;
the baseline gets the launch plan (offset slices, edge-pass grid) of its
own occupancy. Each row also gives the plain version's time, the fp32
bound and the tensor-core bound (chip_smoke.py). ``--sweep-slices`` also
times the current kernel 1 (fp32 mode) with its band offsets split into
each of SWEEP_SLICES slices (``fwd_plan`` overridden), in two turns per
count. ``--mma-rate`` also measures the card's rate for register-fed
``mma.sync.m16n8k8`` TF32 products (MMA_SRC: independent accumulators, no
memory traffic), the ceiling of kernels 1-2's products without wgmma.
Needs a GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

FWD_SHAPES = ((1, 256), (10, 256), (1, 640), (10, 640), (4, 256), (2, 640))
BWD_SHAPES = ((4, 256), (2, 640))
SWEEP_SLICES = (1, 2, 3, 4, 5, 10)

# Each warp issues ITERS x 16 m16n8k8 TF32 products into 16 independent
# accumulators; 2 x 16 x 8 x 8 FLOP each.
MMA_SRC = r"""
#include <cstdint>
__global__ void __launch_bounds__(256) mma_rate(float* out, int iters) {
    uint32_t a[4], b[2];
    for (int q = 0; q < 4; ++q) a[q] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + q);
    for (int q = 0; q < 2; ++q) b[q] = __float_as_uint(0.5f + q);
    float d[16][4] = {};
    for (int it = 0; it < iters; ++it)
#pragma unroll
        for (int j = 0; j < 16; ++j)
            asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                         "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                         : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                         : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    float s = 0.f;
    for (int j = 0; j < 16; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate_launch(float* out, int blocks, int iters, void* stream) {
    mma_rate<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters);
    return (int)cudaGetLastError();
}
"""


def _mma_rate(workdir: str, n_sm: int) -> dict:
    """TFLOP/s of register-fed TF32 mma.sync at 1 and 2 blocks of 8 warps
    per SM (CUDA events, median of 7 after 2 warm-ups)."""
    import torch

    from protein_ensemble_vae_torch.ops.kernels.build import NVCC_FLAGS, nvcc_path

    src, lib_path = os.path.join(workdir, "mma_rate.cu"), os.path.join(workdir, "libmma_rate.so")
    with open(src, "w") as f:
        f.write(MMA_SRC)
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", lib_path, src], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(lib_path).mma_rate_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    iters, res = 4096, {}
    for per_sm in (1, 2, 4):
        blocks = per_sm * n_sm
        out = torch.empty(blocks * 256, device="cuda")
        run = lambda: fn(out.data_ptr(), blocks, iters,  # noqa: E731
                         torch.cuda.current_stream().cuda_stream)
        ms = cs._median_ms(run)
        flop = blocks * 8 * iters * 16 * 2 * 16 * 8 * 8
        res[f"{8 * per_sm}_warps_per_sm_tflops"] = flop / ms / 1e9
    return res


def _build_baseline(src_dir: str) -> dict:
    """nvcc each baseline source into ``src_dir`` (library names with a
    ``_baseline`` suffix) and bind its C interface (with ``chain_bf16``
    where its ``egnn_band_fwd.cu`` has it)."""
    from protein_ensemble_vae_torch.ops.kernels.build import NVCC_FLAGS, nvcc_path

    procs = {}
    for name in ("egnn_band_fwd", "egnn_band_bwd"):
        out = os.path.join(src_dir, f"lib{name}_baseline.so")
        procs[name] = (subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", out, os.path.join(src_dir, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"baseline {name} failed to build:\n{log}")
        cs.log(f"[ab] baseline {name} built\n" + "\n".join(
            l for l in log.splitlines() if "registers" in l or "spill" in l))
        libs[name] = ctypes.CDLL(out)
    with open(os.path.join(src_dir, "egnn_band_fwd.cu")) as f:
        chain = int("chain_bf16" in f.read())
    I, P = ctypes.c_int, ctypes.c_void_p
    fwd = libs["egnn_band_fwd"].egnn_band_fwd_launch
    fwd.argtypes = [P] * 15 + [I] * (7 + chain) + [P]
    bwd = libs["egnn_band_bwd"].egnn_band_bwd_launch
    bwd.argtypes = [P] * 22 + [I] * (8 + chain) + [P]
    nsc = libs["egnn_band_bwd"].egnn_band_bwd_scratch_floats
    nsc.argtypes = [I] * (6 + chain)
    nsc.restype = ctypes.c_size_t
    per_sm = {}
    for k in ("fwd", "bwd"):
        q = getattr(libs[f"egnn_band_{k}"], f"egnn_band_{k}_blocks_per_sm")
        q.argtypes, q.restype = [I] * (3 + chain), I
        per_sm[k] = q
    return dict(fwd=fwd, bwd=bwd, scratch=nsc, per_sm=per_sm, chain=chain, cache={})


def _mode_args(lib, mode, Hd):
    """(bf16_in, passes[, chain_bf16]) of ``mode`` = (input dtype, precision,
    chain dtype) in the baseline's interface, and its blocks per SM."""
    import torch

    from protein_ensemble_vae_torch.ops.kernels.egnn_band import PASSES

    dtype, precision, chain = mode
    ints = (int(dtype == torch.bfloat16), PASSES[precision])
    ints += (int(chain == torch.bfloat16),) if lib["chain"] else ()
    if (ints, Hd) not in lib["cache"]:   # asked once: the query costs host time
        lib["cache"][ints, Hd] = {k: q(Hd, *ints) for k, q in lib["per_sm"].items()}
    return ints, lib["cache"][ints, Hd]


def _weights(args, chain):
    import torch

    w = args[4:]
    return [t.to(torch.bfloat16) for t in w] if chain == torch.bfloat16 else list(w)


def _baseline_fwd(lib, args, W, mode, n_sm):
    import torch

    from protein_ensemble_vae_torch.ops.kernels.egnn_band import fwd_slices

    B, L, Hd = args[0].shape
    ints, per_sm = _mode_args(lib, mode, Hd)
    S = fwd_slices(B, L, W, n_sm, per_sm["fwd"])
    agg = torch.empty((B, L, Hd), device="cuda")
    delta = torch.empty((B, L, 3), device="cuda")
    parts = ([torch.empty((S, B, L, Hd), device="cuda"), torch.empty((S, B, L, 3), device="cuda")]
             if S > 1 else None)
    err = lib["fwd"](*(t.data_ptr() for t in args[:4] + _weights(args, mode[2])),
                     agg.data_ptr(), delta.data_ptr(),
                     *((p.data_ptr() for p in parts) if parts else (None, None)),
                     B, L, Hd, W, S, *ints, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"baseline egnn_band_fwd failed: CUDA error {err}")
    return agg, delta


def _baseline_bwd(lib, args, g_agg, g_delta, W, mode, n_sm):
    import torch

    from protein_ensemble_vae_torch.ops.kernels.egnn_band import bwd_grid

    B, L, Hd = args[0].shape
    ints, per_sm = _mode_args(lib, mode, Hd)
    G, nsplit = bwd_grid(B, L, W, Hd, n_sm, per_sm["bwd"])
    outs = [torch.empty(s, device="cuda", dtype=d) for s, d in (
        ((B, L, Hd), args[0].dtype), ((B, L, Hd), args[0].dtype), ((B, L, 3), torch.float32),
        ((Hd, Hd), torch.float32), ((Hd, Hd), torch.float32), ((4 * Hd + 1,), torch.float32))]
    scratch = torch.empty((lib["scratch"](B, L, Hd, W, G, nsplit, *ints[2:]),), device="cuda")
    w = _weights(args, mode[2])
    w += [w[1].t().contiguous(), w[3].t().contiguous()]
    err = lib["bwd"](*(t.data_ptr() for t in (*args[:4], *w, g_agg, g_delta, *outs, scratch)),
                     B, L, Hd, W, G, nsplit, *ints, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"baseline egnn_band_bwd failed: CUDA error {err}")
    da, dbs, dx, dw_e2, dw_x1, dvec = outs
    dw_d, db_e2, db_x1, dw_x2 = dvec[:4 * Hd].view(4, Hd)
    return (da, dbs, dx, dw_d.reshape(1, Hd), dw_e2, db_e2, dw_x1, db_x1,
            dw_x2.reshape(Hd, 1), dvec[4 * Hd:])


def _check(label, names, got, want, mode):
    """Hold ``got`` against the plain version: chip_smoke.py's fp32
    tolerances in the fp32 mode, its bf16 fractions in the others."""
    import torch

    for n, g, w in zip(names, got, want):
        if mode[0] == torch.float32 and mode[2] == torch.float32:
            if len(names) == 2:
                scale = float(w.abs().max())
                if not torch.allclose(g, w, rtol=cs.RTOL, atol=cs.ATOL_REL * scale):
                    raise RuntimeError(f"{label} {n} disagrees with its plain version")
            else:
                cs._close_scaled(f"{label} {n}", g, w)
        else:
            frac = cs.BF16_VALUE_FRAC if len(names) == 2 else cs.BF16_GRAD_FRAC
            cs._bf16_err(f"{label} {n}", g, w, frac)


def _turns(base, cur) -> dict:
    """Baseline, current, current, baseline; each ``chip_smoke._median_ms``."""
    b1, c1, c2, b2 = (cs._median_ms(f) for f in (base, cur, cur, base))
    return dict(baseline_ms=[b1, b2], current_ms=[c1, c2])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, metavar="DIR",
                    help="directory with the baseline egnn_band_fwd.cu, "
                         "egnn_band_bwd.cu and egnn_tile.cuh")
    ap.add_argument("--out", default=None, metavar="FILE.json",
                    help="also write the rows as JSON here")
    ap.add_argument("--sweep-slices", action="store_true",
                    help="also time kernel 1 at each slice count of SWEEP_SLICES")
    ap.add_argument("--mma-rate", action="store_true",
                    help="also measure register-fed TF32 mma.sync throughput")
    args_ns = ap.parse_args(argv)

    import torch

    from protein_ensemble_vae_torch.ops.kernels import egnn_band
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import (
        bwd_plan, egnn_band_bwd, egnn_band_bwd_reference, egnn_band_fwd,
        egnn_band_reference, fwd_plan, band_work, mode_key)
    from protein_ensemble_vae_torch.ops.routing import set_full_fp32

    device = cs.phase_device()
    set_full_fp32()
    base = _build_baseline(os.path.abspath(args_ns.baseline))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    f32, b16 = torch.float32, torch.bfloat16
    modes = [(f32, "highest", f32), (b16, "default", f32)]
    modes += [(b16, "default", b16)] if base["chain"] else []
    W, rows = cs.W, []

    def cast(args, mode):
        return [args[0].to(mode[0]), args[1].to(mode[0])] + args[2:]

    for k, (B, L) in enumerate(FWD_SHAPES):
        args0 = cs._egnn_inputs(B, L, cs.SEED + k)
        for mode in modes:
            args, (_, precision, chain) = cast(args0, mode), mode
            tag = mode_key("egnn_band_fwd", *mode)
            ref = egnn_band_reference(*args, W, chain)
            cur = lambda: egnn_band_fwd(*args, W, precision, chain)  # noqa: E731
            old = lambda: _baseline_fwd(base, args, W, mode, n_sm)  # noqa: E731
            for label, fn in (("baseline", old), ("current", cur)):
                _check(f"{label} {tag} B{B}/L{L}", ("agg", "raw_delta"), fn(), ref, mode)
            passes = egnn_band.PASSES[precision] if chain == f32 else 1
            peak = cs.PEAK_TF32_FLOPS if chain == f32 else cs.PEAK_BF16_FLOPS
            bound, by, _, tc, _ = cs._egnn_bound(B, L, args[3], args[0].element_size(),
                                                 passes, peak)
            S = fwd_plan(B, L, W, cs.HD, args[0].device, *mode)
            row = dict(kernel="egnn_band_fwd", mode=tag.split(":", 1)[1], B=B, L=L,
                       **_turns(old, cur),
                       plain_ms=cs._median_ms(lambda: egnn_band_reference(*args, W, chain)),
                       bound_ms=bound, bound_by=by, tc_bound_ms=tc,
                       slices=S, blocks=B * band_work(B, L, W)[0] * S)
            if args_ns.sweep_slices and mode == modes[0]:
                sweep = {}
                for sl in SWEEP_SLICES:
                    egnn_band.fwd_plan = lambda *_, sl=sl: sl
                    sweep[sl] = [cs._median_ms(cur) for _ in range(2)]
                egnn_band.fwd_plan = fwd_plan
                row["slice_sweep_ms"] = sweep
            rows.append(row)
            cs.log(f"[ab] {json.dumps(row)}")
            del args, ref
    names = ("a", "bs", "x", "w_d", "w_e2", "b_e2", "w_x1", "b_x1", "w_x2", "b_x2")
    for k, (B, L) in enumerate(BWD_SHAPES):
        args0 = cs._egnn_inputs(B, L, cs.SEED + 10 + k)
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + k)
        g_agg = torch.randn(B, L, cs.HD, generator=g, device="cuda")
        g_delta = torch.randn(B, L, 3, generator=g, device="cuda")
        for mode in modes:
            args, (_, precision, chain) = cast(args0, mode), mode
            tag = mode_key("egnn_band_bwd", *mode)
            ref = egnn_band_bwd_reference(*args, g_agg, g_delta, W, chain)
            cur = lambda: egnn_band_bwd(*args, g_agg, g_delta, W, precision, chain)  # noqa: E731
            old = lambda: _baseline_bwd(base, args, g_agg, g_delta, W, mode, n_sm)  # noqa: E731
            for label, fn in (("baseline", old), ("current", cur)):
                _check(f"{label} {tag} B{B}/L{L}", names, fn(), ref, mode)
            passes = egnn_band.PASSES[precision] if chain == f32 else 1
            peak = cs.PEAK_TF32_FLOPS if chain == f32 else cs.PEAK_BF16_FLOPS
            bound, by, tc, _ = cs._band_bwd_bound(B, L, args[3], args[0].element_size(),
                                                  passes, peak)
            G, nsplit = bwd_plan(B, L, W, cs.HD, args[0].device, *mode)
            row = dict(kernel="egnn_band_bwd", mode=tag.split(":", 1)[1], B=B, L=L,
                       **_turns(old, cur),
                       plain_ms=cs._median_ms(
                           lambda: egnn_band_bwd_reference(*args, g_agg, g_delta, W, chain)),
                       bound_ms=bound, bound_by=by, tc_bound_ms=tc,
                       edge_blocks=G, wgrad_slices=nsplit, items=band_work(B, L, W)[2])
            rows.append(row)
            cs.log(f"[ab] {json.dumps(row)}")
            del args, ref
    result = dict(device=device, n_sm=n_sm, rows=rows)
    if args_ns.mma_rate:
        result["mma_sync_tf32"] = _mma_rate(os.path.abspath(args_ns.baseline), n_sm)
        cs.log(f"[ab] mma.sync m16n8k8 TF32: {json.dumps(result['mma_sync_tf32'])}")
    if args_ns.out:
        os.makedirs(os.path.dirname(os.path.abspath(args_ns.out)), exist_ok=True)
        with open(args_ns.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
