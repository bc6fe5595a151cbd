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
own occupancy. Each row also says whether the two versions' outputs are
bitwise equal and gives the plain version's time, the fp32 bound and the
tensor-core bound (chip_smoke.py). ``--onepass`` times only the one-pass
fp32-chain mode (bf16 ``a`` / ``bs``, ``precision="default"``: the bf16
model's mode) at ONEPASS_FWD_SHAPES / ONEPASS_BWD_SHAPES, the flagship's
training shapes B8/L128 and B8/L192 first; ``--x3`` only the fp32 model's
3xTF32 mode (fp32 ``a`` / ``bs``, ``precision="highest"``), the one whose
baseline is a commit that still builds it on ``mma.sync`` at Hd 256. ``--pass-split`` profiles the
current kernels with torch.profiler in that mode at PASS_SPLIT_SHAPES (and,
without ``--onepass``, in the fp32 model's 3xTF32 mode at
X3_PASS_SPLIT_SHAPES) and gives the device ms per call of each CUDA kernel they launch, by name
(kernel 2: edge, node, weight-grad and reduce passes). ``--l2-rate``
measures the card's L2 read rate (chip_smoke.py's L2_SRC: 16-byte
``ld.global.cg`` loads, which skip L1, over a buffer that stays resident
in L2; once with every block reading its own stripe of 16 MiB, once with
every block reading the same 512 KiB, the pattern of a weight stream that
every SM reads) and, for scale, the HBM read rate over 2 GiB; rows of the
Hopper kernels (the one-pass mode up to Hd 256) then also give their
weight-stream and scratch floors (chip_smoke.py's ``_sm90_floors``). ``--sweep-slices`` also
times the current kernel 1 (fp32 mode) with its band offsets split into
each of SWEEP_SLICES slices (``fwd_plan`` overridden), in two turns per
count. ``--mma-rate`` also measures the card's rate for register-fed
``mma.sync.m16n8k8`` TF32 products (MMA_SRC: independent accumulators, no
memory traffic), the ceiling of kernels 1-2's products without wgmma.
``--wide`` times both fp32-chain modes above width 512 (the Hopper kernels
``egnn_band_{fwd,bwd}_sm90_wide`` against a baseline whose
``egnn_band_fwd.cu`` / ``egnn_band_bwd.cu`` run those widths on their wide
variants, ``egnn_band_fwd_wide_launch`` with ``wide_fwd_grid``) at
WIDE_SHAPES: Hd 1024 at B4/L256, and Hd 768, 1280, 2048 at B1/L256; with
``--l2-rate`` its rows give the weight- and A-stream floors.
``--chain`` times only the bf16 chain (bf16 ``a`` / ``bs``,
``chain_dtype=bfloat16``) at CHAIN_SHAPES, the current Hopper kernels of
each width's family against a baseline that runs the chain on ``mma.sync``
(an earlier commit's ``egnn_band_fwd.cu`` / ``egnn_band_bwd.cu`` /
``egnn_tile.cuh``, its wide variants above 512): Hd 256 at B16/L256 and
B4/L256, Hd 512 and 1024 at B4/L256, and chip_smoke.py's WIDER_ROWS widths
640, 1100 and 2048 at B1/L256, both kernels, each held against the plain
version at chip_smoke.py's bf16-chain tolerances; beside each row the
one-pass fp32-chain kernel's time on the same inputs in the same call, the
plain version's time, the bf16 bounds and (with ``--l2-rate``) the bf16
chain's floors.
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
# the bf16 model's one-pass mode: the flagship's training shapes, then the
# training and generation shapes
ONEPASS_FWD_SHAPES = ((8, 128), (8, 192), (4, 256), (2, 640), (10, 640))
ONEPASS_BWD_SHAPES = ((8, 128), (8, 192), (4, 256))
PASS_SPLIT_SHAPES = ((8, 128), (8, 192))
# the fp32 model's 3xTF32 mode: the train step's B4/L256 and generation's B10/L256
X3_PASS_SPLIT_SHAPES = ((4, 256), (10, 256))
PASS_SPLIT_CALLS = 20
# --hd other than chip_smoke.py's HD (the decoder widths 257-512 run at 512):
# the fp32 model's 3xTF32 mode and the bf16 model's one-pass mode, kernel 1
# at the training shapes and generation's B10/L640, kernel 2 at the
# training shapes; --pass-split in both modes at the train step's B4/L256
WIDTH_FWD_SHAPES = ((4, 256), (2, 640), (10, 640))
WIDTH_BWD_SHAPES = ((4, 256), (2, 640))
WIDTH_PASS_SPLIT_SHAPES = ((4, 256),)
# --wide: (Hd, B, L) of both kernels above 512: the --decoder_hidden 1024
# epoch's train step, then the reconstruction decode's B1 over the widths
WIDE_SHAPES = ((1024, 4, 256), (768, 1, 256), (1280, 1, 256), (2048, 1, 256))
WIDE_REPS = 3
# --chain: (Hd, B, L) of both kernels in the bf16 chain
CHAIN_SHAPES = ((256, 16, 256), (256, 4, 256), (512, 4, 256), (1024, 4, 256), (640, 1, 256),
                (1100, 1, 256), (2048, 1, 256))


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


def _pass_split(call, calls: int = PASS_SPLIT_CALLS) -> dict:
    """Device ms per call of each CUDA kernel ``call`` launches, by the
    kernel's function name (torch.profiler over ``calls`` calls after one
    warm-up)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"(egnn_\w+)", e.name)
        key = m.group(1) if m else e.name[:48]
        by[key] = by.get(key, 0.0) + e.time_range.elapsed_us() / calls / 1e3
    return by


def _start_baseline(src_dir: str) -> dict:
    """Start nvcc on each baseline source in ``src_dir`` (library names with
    a ``_baseline`` suffix); ``_bind_baseline`` waits for them."""
    from protein_ensemble_vae_torch.ops.kernels.build import NVCC_FLAGS, nvcc_path

    procs = {}
    for name in ("egnn_band_fwd", "egnn_band_bwd"):
        out = os.path.join(src_dir, f"lib{name}_baseline.so")
        procs[name] = (subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", out, os.path.join(src_dir, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    return procs


def _bind_baseline(src_dir: str, procs: dict) -> dict:
    """Wait for ``_start_baseline``'s builds and bind their C interface (with
    ``chain_bf16`` where the baseline's ``egnn_band_fwd.cu`` has it)."""
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
    out = dict(fwd=fwd, bwd=bwd, scratch=nsc, per_sm=per_sm, chain=chain, cache={})
    lib = libs["egnn_band_fwd"]
    if hasattr(lib, "egnn_band_fwd_wide_launch"):   # a version with widths above 512
        out["fwd_wide"] = lib.egnn_band_fwd_wide_launch
        out["fwd_wide"].argtypes = [P] * 14 + [I] * (7 + chain) + [P]
        out["fwd_wide_scratch"] = lib.egnn_band_fwd_wide_scratch_floats
        out["fwd_wide_scratch"].argtypes = [I] * (2 + chain)
        out["fwd_wide_scratch"].restype = ctypes.c_size_t
    return out


def _build_baseline(src_dir: str) -> dict:
    """nvcc each baseline source into ``src_dir`` and bind its C interface."""
    return _bind_baseline(src_dir, _start_baseline(src_dir))


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
    agg = torch.empty((B, L, Hd), device="cuda")
    delta = torch.empty((B, L, 3), device="cuda")
    if Hd > 512:   # the baseline's wide variant: persistent blocks, no slices
        from protein_ensemble_vae_torch.ops.kernels.egnn_band import wide_fwd_grid

        G = wide_fwd_grid(B, L, n_sm, per_sm["fwd"])
        scratch = torch.empty((lib["fwd_wide_scratch"](Hd, G, *ints[2:]),), device="cuda")
        err = lib["fwd_wide"](*(t.data_ptr() for t in args[:4] + _weights(args, mode[2])),
                              agg.data_ptr(), delta.data_ptr(), scratch.data_ptr(), B, L, Hd, W,
                              G, *ints, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline egnn_band_fwd_wide failed: CUDA error {err}")
        return agg, delta
    S = fwd_slices(B, L, W, n_sm, per_sm["fwd"])
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
        else:   # values of the bf16 chain at its own tolerance
            value_frac = cs.CHAIN_VALUE_FRAC if mode[2] == torch.bfloat16 else cs.BF16_VALUE_FRAC
            frac = value_frac if len(names) == 2 else cs.BF16_GRAD_FRAC
            cs._bf16_err(f"{label} {n}", g, w, frac)


def _turns(base, cur, **kw) -> dict:
    """Baseline, current, current, baseline; each ``chip_smoke._median_ms``
    (``kw``: its reps and launches)."""
    b1, c1, c2, b2 = (cs._median_ms(f, **kw) for f in (base, cur, cur, base))
    return dict(baseline_ms=[b1, b2], current_ms=[c1, c2])


def _wide_rows(base, n_sm: int, W: int) -> list:
    """--wide: kernels 1-2 above 512 in both fp32-chain modes at WIDE_SHAPES,
    the current Hopper kernels against the baseline's wide variants in turns
    (WIDE_REPS windows of 3 calls: a call takes milliseconds), each held
    against the plain version first; the plain version's time, the bounds,
    the plan and (with the L2 rate measured) the stream floors."""
    import torch

    from protein_ensemble_vae_torch.ops.kernels.egnn_band import (
        PASSES, band_kernel, band_work, egnn_band_bwd, egnn_band_bwd_reference, egnn_band_fwd,
        egnn_band_reference, mode_key, wide_bwd_plan, wide_fwd_plan)

    f32, b16 = torch.float32, torch.bfloat16
    modes = [(f32, "highest", f32), (b16, "default", f32)]
    names = ("a", "bs", "x", "w_d", "w_e2", "b_e2", "w_x1", "b_x1", "w_x2", "b_x2")
    kw = dict(reps=WIDE_REPS, min_launches=3)
    rows = []
    for k, (hd, B, L) in enumerate(WIDE_SHAPES):
        args0 = cs._egnn_inputs(B, L, cs.SEED + 40 + k, hd)
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 40 + k)
        g_agg = torch.randn(B, L, hd, generator=g, device="cuda")
        g_delta = torch.randn(B, L, 3, generator=g, device="cuda")
        for mode in modes:
            dtype, precision, chain = mode
            args = [args0[0].to(dtype), args0[1].to(dtype)] + args0[2:]
            for kernel in ("egnn_band_fwd", "egnn_band_bwd"):
                fwd = kernel == "egnn_band_fwd"
                if fwd:
                    cur = lambda: egnn_band_fwd(*args, W, precision)  # noqa: E731
                    old = lambda: _baseline_fwd(base, args, W, mode, n_sm)  # noqa: E731
                    plain = lambda: egnn_band_reference(*args, W)  # noqa: E731
                    outs = ("agg", "raw_delta")
                else:
                    cur = lambda: egnn_band_bwd(*args, g_agg, g_delta, W, precision)  # noqa: E731
                    old = lambda: _baseline_bwd(base, args, g_agg, g_delta, W, mode,  # noqa: E731
                                                n_sm)
                    plain = lambda: egnn_band_bwd_reference(*args, g_agg, g_delta, W)  # noqa: E731
                    outs = names
                tag = f"{mode_key(kernel, dtype, precision)} Hd{hd} B{B}/L{L}"
                ref = plain()
                for label, fn in (("baseline", old), ("current", cur)):
                    _check(f"{label} {tag}", outs, fn(), ref, mode)
                del ref
                passes = PASSES[precision]
                bound_fn = cs._egnn_bound if fwd else cs._band_bwd_bound
                bound, by, *_, tc, _ = bound_fn(B, L, args[3], args[0].element_size(), passes,
                                                cs.PEAK_TF32_FLOPS, hd)
                served = band_kernel(kernel, hd, precision)
                if fwd:
                    S, _, G = wide_fwd_plan(B, L, W, args[0].device, dtype, precision)
                    plan = dict(slices=S, units=B * band_work(B, L, W)[0] * S, blocks=G)
                else:
                    G, nsplit = wide_bwd_plan(B, L, W, hd, args[0].device, dtype, precision)
                    plan = dict(edge_blocks=G, wgrad_slices=nsplit)
                floors = (cs._sm90_floors(served, B, L, args[3], hd, precision)
                          if cs.READ_RATE else {})
                row = dict(kernel=served, mode=f"{str(dtype)[6:]}/{precision}", Hd=hd, B=B, L=L,
                           **_turns(old, cur, **kw), plain_ms=cs._median_ms(plain, **kw),
                           bound_ms=bound, bound_by=by, tc_bound_ms=tc, **plan, **floors)
                rows.append(row)
                cs.log(f"[ab] {json.dumps(row)}")
            del args
        del args0, g_agg, g_delta
        torch.cuda.empty_cache()
    return rows


def _chain_rows(base, n_sm: int, W: int) -> list:
    """--chain: kernels 1-2 in the bf16 chain at CHAIN_SHAPES, the current
    Hopper kernels against the baseline's mma.sync ones in turns (above 512
    WIDE_REPS windows of 3 calls), each held against the plain version
    first; beside them the one-pass fp32-chain kernel on the same inputs,
    the plain version's time, the bf16 bounds, the plan and (with the L2
    rate measured) the bf16 chain's floors."""
    import torch

    import torch.nn.functional as F

    from protein_ensemble_vae_torch.ops.kernels.egnn_band import (
        MAX_NATIVE, band_kernel, egnn_band_bwd, egnn_band_bwd_reference, egnn_band_fwd,
        egnn_band_reference, native_width, pad_band_width, unpad_band_grads)

    b16 = torch.bfloat16

    # the baseline at a width it does not take: zero-padded to the native
    # width and sliced back, as the parent's wrappers did (the pad copies
    # timed with it)
    def old_fwd(args, n):
        if n == args[0].shape[-1]:
            return _baseline_fwd(base, args, W, mode, n_sm)
        agg, delta = _baseline_fwd(base, list(pad_band_width(*args, n)), W, mode, n_sm)
        return agg[..., :args[0].shape[-1]], delta

    def old_bwd(args, g_agg, g_delta, n):
        hd_ = args[0].shape[-1]
        if n == hd_:
            return _baseline_bwd(base, args, g_agg, g_delta, W, mode, n_sm)
        grads = _baseline_bwd(base, list(pad_band_width(*args, n)), F.pad(g_agg, (0, n - hd_)),
                              g_delta, W, mode, n_sm)
        return unpad_band_grads(grads, *args)

    mode = (b16, "default", b16)
    names = ("a", "bs", "x", "w_d", "w_e2", "b_e2", "w_x1", "b_x1", "w_x2", "b_x2")
    rows = []
    for k, (hd, B, L) in enumerate(CHAIN_SHAPES):
        args0 = cs._egnn_inputs(B, L, cs.SEED + 70 + k, hd)
        args = [args0[0].to(b16), args0[1].to(b16)] + args0[2:]
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 70 + k)
        g_agg = torch.randn(B, L, hd, generator=g, device="cuda")
        g_delta = torch.randn(B, L, 3, generator=g, device="cuda")
        kw = dict(reps=WIDE_REPS, min_launches=3) if native_width(hd) > MAX_NATIVE else {}
        for kernel in ("egnn_band_fwd", "egnn_band_bwd"):
            fwd = kernel == "egnn_band_fwd"
            if fwd:
                cur = lambda: egnn_band_fwd(*args, W, "default", b16)  # noqa: E731
                onepass = lambda: egnn_band_fwd(*args, W, "default")  # noqa: E731
                old = lambda: old_fwd(args, native_width(hd))  # noqa: E731
                plain = lambda: egnn_band_reference(*args, W, b16)  # noqa: E731
                outs = ("agg", "raw_delta")
            else:
                cur = lambda: egnn_band_bwd(*args, g_agg, g_delta, W, "default", b16)  # noqa: E731
                onepass = lambda: egnn_band_bwd(*args, g_agg, g_delta, W, "default")  # noqa: E731
                old = lambda: old_bwd(args, g_agg, g_delta, native_width(hd))  # noqa: E731
                plain = lambda: egnn_band_bwd_reference(*args, g_agg, g_delta, W, b16)  # noqa: E731
                outs = names
            served = band_kernel(kernel, hd, "default", b16)
            tag = f"{served}:bfloat16/bfloat16_chain Hd{hd} B{B}/L{L}"
            ref = plain()
            for label, fn in (("baseline", old), ("current", cur)):
                _check(f"{label} {tag}", outs, fn(), ref, mode)
            del ref
            bound_fn = cs._egnn_bound if fwd else cs._band_bwd_bound
            bound, by, *_, tc, _ = bound_fn(B, L, args[3], 2, 1, cs.PEAK_BF16_FLOPS, hd)
            floors = (cs._sm90_floors(served, B, L, args[3], hd, "default", True)
                      if cs.READ_RATE else {})
            turns = _turns(old, cur, **kw)
            row = dict(kernel=served, mode="bfloat16/bfloat16_chain", Hd=hd,
                       padded_to=native_width(hd), B=B, L=L, **turns,
                       ratio=min(turns["current_ms"]) / min(turns["baseline_ms"]),
                       onepass_fp32_chain_ms=cs._median_ms(onepass, **kw),
                       plain_ms=cs._median_ms(plain, **(kw or dict(reps=3))),
                       bound_ms=bound, bound_by=by, tc_bound_ms=tc, **floors)
            rows.append(row)
            cs.log(f"[ab] {json.dumps(row)}")
        del args, args0, g_agg, g_delta
        torch.cuda.empty_cache()
    return rows


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
    ap.add_argument("--onepass", action="store_true",
                    help="only the bf16 model's one-pass mode, at ONEPASS_*_SHAPES")
    ap.add_argument("--x3", action="store_true",
                    help="only the fp32 model's 3xTF32 mode (fp32 a / bs), at FWD_SHAPES / "
                         "BWD_SHAPES, --pass-split at X3_PASS_SPLIT_SHAPES")
    ap.add_argument("--pass-split", action="store_true",
                    help="also profile the current kernels' passes at PASS_SPLIT_SHAPES")
    ap.add_argument("--l2-rate", action="store_true",
                    help="also measure the card's L2 and HBM read rates")
    ap.add_argument("--wide", action="store_true",
                    help="only both fp32-chain modes above width 512, at WIDE_SHAPES")
    ap.add_argument("--chain", action="store_true",
                    help="only the bf16 chain, at CHAIN_SHAPES (the baseline on mma.sync)")
    ap.add_argument("--hd", type=int, default=None, metavar="N",
                    help="decoder width (default chip_smoke.py's HD); another width "
                         "times the 3xTF32 and one-pass modes at WIDTH_*_SHAPES")
    args_ns = ap.parse_args(argv)

    import torch

    from protein_ensemble_vae_torch.ops.kernels import egnn_band
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import (
        band_kernel, band_work, bwd_plan, egnn_band_bwd, egnn_band_bwd_reference, egnn_band_fwd,
        egnn_band_reference, fwd_plan, mode_key, sm90_bwd_plan, sm90_fwd_plan)
    from protein_ensemble_vae_torch.ops.routing import set_full_fp32

    device = cs.phase_device()
    set_full_fp32()
    base = _build_baseline(os.path.abspath(args_ns.baseline))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    f32, b16 = torch.float32, torch.bfloat16
    modes = [(f32, "highest", f32), (b16, "default", f32)]
    modes += [(b16, "default", b16)] if base["chain"] else []
    fwd_shapes, bwd_shapes = FWD_SHAPES, BWD_SHAPES
    if args_ns.onepass:
        modes, fwd_shapes, bwd_shapes = [(b16, "default", f32)], ONEPASS_FWD_SHAPES, \
            ONEPASS_BWD_SHAPES
    hd = args_ns.hd or cs.HD
    splits = [((b16, "default", f32), PASS_SPLIT_SHAPES)]
    splits += [] if args_ns.onepass else [((f32, "highest", f32), X3_PASS_SPLIT_SHAPES)]
    if args_ns.x3:
        modes, splits = [(f32, "highest", f32)], splits[1:]
    if hd != cs.HD:
        modes = [(f32, "highest", f32), (b16, "default", f32)]
        fwd_shapes, bwd_shapes = WIDTH_FWD_SHAPES, WIDTH_BWD_SHAPES
        splits = [(m, WIDTH_PASS_SPLIT_SHAPES) for m in modes]
    W, rows = cs.W, []
    result = dict(device=device, n_sm=n_sm, hd=hd, rows=rows)
    if args_ns.l2_rate:
        result["read_rate"] = cs.READ_RATE = cs._l2_rate()
        cs.log(f"[ab] read rates ({device['smi']}): {json.dumps(result['read_rate'])}")
    if args_ns.wide:
        splits = [(m, ((4, 256),)) for m in ((f32, "highest", f32), (b16, "default", f32))]
        hd = 1024
        result["hd"] = hd
    if args_ns.pass_split:
        split = {}
        for (dtype, precision, _), shapes in splits:
            for k, (B, L) in enumerate(shapes):
                args0 = cs._egnn_inputs(B, L, cs.SEED + 20 + k, hd)
                g = torch.Generator(device="cuda").manual_seed(cs.SEED + 20 + k)
                g_agg = torch.randn(B, L, hd, generator=g, device="cuda")
                g_delta = torch.randn(B, L, 3, generator=g, device="cuda")
                args = [args0[0].to(dtype), args0[1].to(dtype)] + args0[2:]
                split[f"{mode_key('', dtype, precision)[1:]} B{B}/L{L}"] = dict(
                    egnn_band_fwd=_pass_split(lambda: egnn_band_fwd(*args, W, precision)),
                    egnn_band_bwd=_pass_split(
                        lambda: egnn_band_bwd(*args, g_agg, g_delta, W, precision)))
                del args, args0, g_agg, g_delta
        result["pass_split_ms"] = split
        cs.log(f"[ab] device ms per call by CUDA kernel at Hd {hd} ({device['smi']}): "
               f"{json.dumps(split)}")

    def cast(args, mode):
        return [args[0].to(mode[0]), args[1].to(mode[0])] + args[2:]

    if args_ns.wide:
        fwd_shapes = bwd_shapes = ()
        rows += _wide_rows(base, n_sm, W)
    if args_ns.chain:
        if not base["chain"]:
            raise RuntimeError("--chain: the baseline has no bf16 chain (chain_bf16)")
        fwd_shapes = bwd_shapes = ()
        rows += _chain_rows(base, n_sm, W)

    for k, (B, L) in enumerate(fwd_shapes):
        args0 = cs._egnn_inputs(B, L, cs.SEED + k, hd)
        for mode in modes:
            args, (_, precision, chain) = cast(args0, mode), mode
            tag = mode_key("egnn_band_fwd", *mode)
            ref = egnn_band_reference(*args, W, chain)
            cur = lambda: egnn_band_fwd(*args, W, precision, chain)  # noqa: E731
            old = lambda: _baseline_fwd(base, args, W, mode, n_sm)  # noqa: E731
            for label, fn in (("baseline", old), ("current", cur)):
                _check(f"{label} {tag} B{B}/L{L}", ("agg", "raw_delta"), fn(), ref, mode)
            same = all(torch.equal(a, b) for a, b in zip(old(), cur()))
            passes = egnn_band.PASSES[precision] if chain == f32 else 1
            peak = cs.PEAK_TF32_FLOPS if chain == f32 else cs.PEAK_BF16_FLOPS
            bound, by, _, tc, _ = cs._egnn_bound(B, L, args[3], args[0].element_size(),
                                                 passes, peak, hd)
            served = band_kernel("egnn_band_fwd", hd, precision, chain)
            if served != "egnn_band_fwd":
                S, _, G = sm90_fwd_plan(B, L, W, hd, args[0].device, args[0].dtype, precision,
                                        chain)
                plan = dict(slices=S, units=B * band_work(B, L, W)[0] * S, blocks=G,
                            **(cs._sm90_floors(served, B, L, args[3], hd, precision, chain == b16)
                               if cs.READ_RATE else {}))
            else:
                S = fwd_plan(B, L, W, hd, args[0].device, *mode)
                plan = dict(slices=S, blocks=B * band_work(B, L, W)[0] * S)
            row = dict(kernel=served, mode=tag.split(":", 1)[1], B=B, L=L,
                       bitwise_equal_to_baseline=same, **_turns(old, cur),
                       plain_ms=cs._median_ms(lambda: egnn_band_reference(*args, W, chain)),
                       bound_ms=bound, bound_by=by, tc_bound_ms=tc, **plan)
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
    for k, (B, L) in enumerate(bwd_shapes):
        args0 = cs._egnn_inputs(B, L, cs.SEED + 10 + k, hd)
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + k)
        g_agg = torch.randn(B, L, hd, generator=g, device="cuda")
        g_delta = torch.randn(B, L, 3, generator=g, device="cuda")
        for mode in modes:
            args, (_, precision, chain) = cast(args0, mode), mode
            tag = mode_key("egnn_band_bwd", *mode)
            ref = egnn_band_bwd_reference(*args, g_agg, g_delta, W, chain)
            cur = lambda: egnn_band_bwd(*args, g_agg, g_delta, W, precision, chain)  # noqa: E731
            old = lambda: _baseline_bwd(base, args, g_agg, g_delta, W, mode, n_sm)  # noqa: E731
            for label, fn in (("baseline", old), ("current", cur)):
                _check(f"{label} {tag} B{B}/L{L}", names, fn(), ref, mode)
            same = all(torch.equal(a.reshape(-1), b.reshape(-1)) for a, b in zip(old(), cur()))
            passes = egnn_band.PASSES[precision] if chain == f32 else 1
            peak = cs.PEAK_TF32_FLOPS if chain == f32 else cs.PEAK_BF16_FLOPS
            bound, by, tc, _ = cs._band_bwd_bound(B, L, args[3], args[0].element_size(),
                                                  passes, peak, hd)
            served = band_kernel("egnn_band_bwd", hd, precision, chain)
            if served != "egnn_band_bwd":
                G, nsplit = sm90_bwd_plan(B, L, W, hd, args[0].device, args[0].dtype, precision,
                                          chain)
                floors = (cs._sm90_floors(served, B, L, args[3], hd, precision, chain == b16)
                          if cs.READ_RATE else {})
            else:
                G, nsplit = bwd_plan(B, L, W, hd, args[0].device, *mode)
                floors = {}
            row = dict(kernel=served, mode=tag.split(":", 1)[1], B=B, L=L,
                       bitwise_equal_to_baseline=same, **_turns(old, cur),
                       plain_ms=cs._median_ms(
                           lambda: egnn_band_bwd_reference(*args, g_agg, g_delta, W, chain)),
                       bound_ms=bound, bound_by=by, tc_bound_ms=tc,
                       edge_blocks=G, wgrad_slices=nsplit, items=band_work(B, L, W)[2], **floors)
            rows.append(row)
            cs.log(f"[ab] {json.dumps(row)}")
            del args, ref
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
