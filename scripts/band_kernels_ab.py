"""Time the port's EGNN band kernels (1: forward, 2: backward) against a
baseline build of other sources, on one NVIDIA GPU, in the same process.

    python scripts/band_kernels_ab.py --baseline DIR [--out FILE.json]

DIR holds ``egnn_band_fwd.cu``, ``egnn_band_bwd.cu`` and ``egnn_tile.cuh`` of
the version to compare with, for example an earlier commit's
``protein_ensemble_vae_torch/csrc/`` extracted with ``git show`` into a
git-ignored directory. They must have that version's C interface:
``egnn_band_fwd_f32(13 pointers, B, L, hd, W, stream)``,
``egnn_band_bwd_f32(22 pointers, B, L, hd, W, stream)`` and
``egnn_band_bwd_scratch_floats(B, L, hd, W)``. The script builds them with
``nvcc`` under other library names, holds both versions against the plain
PyTorch versions at chip_smoke.py's tolerances, and times them in turns
(baseline, current, current, baseline; CUDA events, median of 7 launches
after 2 warm-ups per turn) at the main path's shapes: kernel 1 at
generation's B1/B10 x L256/L640 and the training shapes B4/L256, B2/L640;
kernel 2 at the training shapes. The current version runs through the
package's wrappers. Each row also gives the plain version's time, the fp32
bound and the tensor-core bound (chip_smoke.py). ``--sweep-slices`` also
times the current kernel 1 with its band offsets split into each of
SWEEP_SLICES slices (``fwd_plan`` overridden), in two turns per count.
``--mma-rate`` also measures the card's rate for register-fed
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
    ``_baseline`` suffix) and bind its C interface."""
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
    fwd = libs["egnn_band_fwd"].egnn_band_fwd_f32
    fwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    bwd = libs["egnn_band_bwd"].egnn_band_bwd_f32
    bwd.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    nsc = libs["egnn_band_bwd"].egnn_band_bwd_scratch_floats
    nsc.argtypes = [ctypes.c_int] * 4
    nsc.restype = ctypes.c_size_t
    return dict(fwd=fwd, bwd=bwd, scratch=nsc)


def _baseline_fwd(lib, args, W):
    import torch

    B, L, Hd = args[0].shape
    agg = torch.empty((B, L, Hd), device="cuda")
    delta = torch.empty((B, L, 3), device="cuda")
    err = lib["fwd"](*(t.data_ptr() for t in args), agg.data_ptr(), delta.data_ptr(),
                     B, L, Hd, W, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"baseline egnn_band_fwd failed: CUDA error {err}")
    return agg, delta


def _baseline_bwd(lib, args, g_agg, g_delta, W):
    import torch

    B, L, Hd = args[0].shape
    outs = [torch.empty(s, device="cuda") for s in
            ((B, L, Hd), (B, L, Hd), (B, L, 3), (Hd, Hd), (Hd, Hd), (4 * Hd + 1,))]
    scratch = torch.empty((lib["scratch"](B, L, Hd, W),), device="cuda")
    w_e2t, w_x1t = args[5].t().contiguous(), args[7].t().contiguous()
    err = lib["bwd"](*(t.data_ptr() for t in (*args, w_e2t, w_x1t, g_agg, g_delta,
                                              *outs, scratch)),
                     B, L, Hd, W, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"baseline egnn_band_bwd failed: CUDA error {err}")
    da, dbs, dx, dw_e2, dw_x1, dvec = outs
    dw_d, db_e2, db_x1, dw_x2 = dvec[:4 * Hd].view(4, Hd)
    return (da, dbs, dx, dw_d.reshape(1, Hd), dw_e2, db_e2, dw_x1, db_x1,
            dw_x2.reshape(Hd, 1), dvec[4 * Hd:])


def _turns(base, cur) -> dict:
    """Baseline, current, current, baseline; each a median of 7 launches."""
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
        egnn_band_reference, fwd_plan, band_work)
    from protein_ensemble_vae_torch.ops.routing import set_full_fp32

    device = cs.phase_device()
    set_full_fp32()
    base = _build_baseline(os.path.abspath(args_ns.baseline))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    W, rows = cs.W, []
    for k, (B, L) in enumerate(FWD_SHAPES):
        args = cs._egnn_inputs(B, L, cs.SEED + k)
        ref = egnn_band_reference(*args, W)
        for label, out in (("baseline", _baseline_fwd(base, args, W)),
                           ("current", egnn_band_fwd(*args, W))):
            for name, got, want in zip(("agg", "raw_delta"), out, ref):
                scale = float(want.abs().max())
                if not torch.allclose(got, want, rtol=cs.RTOL, atol=cs.ATOL_REL * scale):
                    raise RuntimeError(f"{label} egnn_band_fwd B{B}/L{L} {name} disagrees")
        t = _turns(lambda: _baseline_fwd(base, args, W), lambda: egnn_band_fwd(*args, W))
        bound, by, _, tc = cs._egnn_bound(B, L, args[3])
        S = fwd_plan(B, L, W, cs.HD, args[0].device)
        row = dict(kernel="egnn_band_fwd", B=B, L=L, **t,
                   plain_ms=cs._median_ms(lambda: egnn_band_reference(*args, W)),
                   bound_ms=bound, bound_by=by, tc_bound_ms=tc,
                   slices=S, blocks=B * band_work(B, L, W)[0] * S)
        if args_ns.sweep_slices:
            sweep = {}
            for s in SWEEP_SLICES:
                egnn_band.fwd_plan = lambda *_, s=s: s
                sweep[s] = [cs._median_ms(lambda: egnn_band_fwd(*args, W)) for _ in range(2)]
            egnn_band.fwd_plan = fwd_plan
            row["slice_sweep_ms"] = sweep
        rows.append(row)
        cs.log(f"[ab] {json.dumps(row)}")
        del args, ref
    names = ("a", "bs", "x", "w_d", "w_e2", "b_e2", "w_x1", "b_x1", "w_x2", "b_x2")
    for k, (B, L) in enumerate(BWD_SHAPES):
        args = cs._egnn_inputs(B, L, cs.SEED + 10 + k)
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + k)
        g_agg = torch.randn(B, L, cs.HD, generator=g, device="cuda")
        g_delta = torch.randn(B, L, 3, generator=g, device="cuda")
        ref = egnn_band_bwd_reference(*args, g_agg, g_delta, W)
        for label, out in (("baseline", _baseline_bwd(base, args, g_agg, g_delta, W)),
                           ("current", egnn_band_bwd(*args, g_agg, g_delta, W))):
            for n, got, want in zip(names, out, ref):
                cs._close_scaled(f"{label} egnn_band_bwd B{B}/L{L} {n}", got, want)
        t = _turns(lambda: _baseline_bwd(base, args, g_agg, g_delta, W),
                   lambda: egnn_band_bwd(*args, g_agg, g_delta, W))
        bound, by, tc = cs._band_bwd_bound(B, L, args[3])
        G, nsplit = bwd_plan(B, L, W, cs.HD, args[0].device)
        row = dict(kernel="egnn_band_bwd", B=B, L=L, **t,
                   plain_ms=cs._median_ms(
                       lambda: egnn_band_bwd_reference(*args, g_agg, g_delta, W)),
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
