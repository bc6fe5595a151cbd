"""Time the port's clash kernels (3: forward, 4: backward) against a
baseline version of them, on one NVIDIA GPU, in the same process.

    python scripts/clash_kernels_ab.py --baseline DIR [--out FILE.json]

DIR holds ``clash.cu`` and ``clash.py`` of the version to compare with, for
example an earlier commit's ``protein_ensemble_vae_torch/csrc/clash.cu`` and
``protein_ensemble_vae_torch/ops/kernels/clash.py`` extracted with
``git show`` into a git-ignored directory. The baseline must have the
interface over interleaved atoms: ``clash_fwd_f32(atoms, amask, partial,
totals, B, A, clash_dist, soft_margin, stream)``, ``clash_bwd_f32(atoms,
amask, scale, grad, ...)`` and ``clash_n_tiles(A)``, with the wrappers
``clash_fwd(atoms, amask)``, ``clash_bwd(atoms, amask, scale)`` and
``clash_loss_kernel`` in its ``clash.py``. The script builds the baseline
source with ``nvcc`` under another library name and loads its wrapper
module bound to that library.

At chip_smoke.py's clash shapes (B4/L256, B2/L640 for training, B10/L256,
B10/L640 for refinement) on its NeRF folds, both versions are first held
against the plain PyTorch versions, then timed in turns (baseline, current,
current, baseline):
- device us per launch: CUDA events around N back-to-back launches of the
  bare C entry point on buffers allocated once, over N (chip_smoke.py's
  ``_median_ms``);
- graph us per launch: the same N launches captured in one CUDA graph and
  replayed, over N: the device's own time, with no host between launches;
- host us per wrapper call: ``time.perf_counter`` over N calls, no sync;
- the clash term: host us and device us of one ``clash_loss_kernel``
  forward + backward (``torch.autograd.grad`` with the upstream gradient
  given), and the device kernels it issues besides the clash kernels
  themselves (torch.profiler).
The empty kernel ``clash_noop`` of the current source gives the launch
floor on the same three clocks. Each row also gives the plain version's
time and chip_smoke.py's bound. ``--sweep-split`` also times the current
kernels with 1, 2 and 4 warps per J group (``block_split`` overridden) on
the graph clock, the measurement behind ``SPLIT_BUDGET``. ``--stages``
also builds variants of the current source that return early (after
staging; without the pair loop; without the last block's sums) and times
them on the graph clock: where a launch's time goes. Needs a GPU; imports
no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

SWEEP_SPLITS = (1, 2, 4)


def _build_baseline(src_dir: str):
    """nvcc the baseline ``clash.cu`` into ``src_dir`` and load its wrapper
    module ``clash.py`` bound to that library."""
    from protein_ensemble_vae_torch.ops.kernels.build import NVCC_FLAGS, nvcc_path

    out = os.path.join(src_dir, "libclash_baseline.so")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", out,
                           os.path.join(src_dir, "clash.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"baseline clash.cu failed to build:\n{proc.stdout}")
    cs.log("[ab] baseline clash built\n" + "\n".join(
        l for l in proc.stdout.splitlines() if "registers" in l or "spill" in l))
    lib = ctypes.CDLL(out)
    for fn in (lib.clash_fwd_f32, lib.clash_bwd_f32):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.clash_n_tiles.argtypes = [ctypes.c_int]
    lib.clash_n_tiles.restype = ctypes.c_int
    lib.clash_error_string.argtypes = [ctypes.c_int]
    lib.clash_error_string.restype = ctypes.c_char_p
    spec = importlib.util.spec_from_file_location("clash_baseline",
                                                  os.path.join(src_dir, "clash.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._FN = lib
    return lib, mod


# Variants of the current source that stop early, for ``--stages``: each
# replaces text of csrc/clash.cu (the script raises if it is missing).
STAGES = {
    "stage_only": [("    __syncthreads();\n\n    float acc = 0.f,",
                    "    __syncthreads();\n    if (bb.L > 0) return;\n\n    float acc = 0.f,")],
    "no_pairs": [("    if (mi == 0.f || !group_kept(sh, lane / GR, gj, clash_dist)) return;",
                  "    return;")],
    "no_finisher": [("    if (!last) return;", "    return;")],
}
STAGES["no_pairs_no_finisher"] = STAGES["no_pairs"] + STAGES["no_finisher"]


def _build_stages(workdir: str) -> dict:
    """nvcc each ``STAGES`` variant of the current csrc/clash.cu into
    ``workdir``, all together, and bind its C interface."""
    from protein_ensemble_vae_torch.ops.kernels.build import CSRC_DIR, NVCC_FLAGS, nvcc_path

    with open(os.path.join(CSRC_DIR, "clash.cu")) as f:
        src = f.read()
    procs = {}
    for name, edits in STAGES.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"stage variant {name}: {old!r} not in clash.cu")
            text = text.replace(old, new)
        path = os.path.join(workdir, f"clash_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        out = os.path.join(workdir, f"libclash_{name}.so")
        procs[name] = (subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", out, path],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"stage variant {name} failed to build:\n{log}")
        lib = ctypes.CDLL(out)
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        tail = [i32] * 3 + [i64] * 5 + [f32, f32, ptr]
        lib.clash_fwd_f32.argtypes = [ptr] * 7 + tail
        lib.clash_bwd_f32.argtypes = [ptr] * 9 + tail
        libs[name] = lib
    return libs


def _clocks(launch, wrapper) -> dict:
    return dict(device_us=1e3 * cs._median_ms(launch), graph_us=cs._graph_us(launch),
                host_us=cs._host_us(wrapper))


def _turns(base: tuple, cur: tuple) -> dict:
    """Baseline, current, current, baseline on each clock."""
    b1, c1, c2, b2 = (_clocks(*f) for f in (base, cur, cur, base))
    return {f"{who}_{k}": [x[k], y[k]] for who, (x, y) in
            (("baseline", (b1, b2)), ("current", (c1, c2))) for k in b1}


def _term_clocks(loss_fn, xs, mask, g) -> dict:
    import torch

    def term():
        return torch.autograd.grad(loss_fn(*xs, mask), xs, g)

    return dict(term_device_us=1e3 * cs._median_ms(term), term_host_us=cs._host_us(term))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, metavar="DIR",
                    help="directory with the baseline clash.cu and clash.py")
    ap.add_argument("--out", default=None, metavar="FILE.json",
                    help="also write the rows as JSON here")
    ap.add_argument("--sweep-split", action="store_true",
                    help="also time the current kernels at each split of SWEEP_SPLITS "
                         "(CUDA-graph clock, two turns each)")
    ap.add_argument("--stages", action="store_true",
                    help="also time variants of the current kernels that stop early "
                         "(STAGES; CUDA-graph clock): where a launch's time goes")
    args_ns = ap.parse_args(argv)

    import torch

    from protein_ensemble_vae_torch.ops.kernels import clash
    from protein_ensemble_vae_torch.ops.kernels.clash import (
        backbone_atoms, clash_bwd, clash_bwd_reference, clash_fwd,
        clash_fwd_reference, clash_loss_kernel, clash_noop, block_split, bwd_grid, fwd_grid,
        n_tiles, scratch_floats)
    from protein_ensemble_vae_torch.ops.routing import set_full_fp32

    device = cs.phase_device()
    set_full_fp32()
    blib, bmod = _build_baseline(os.path.abspath(args_ns.baseline))
    stages = _build_stages(os.path.abspath(args_ns.baseline)) if args_ns.stages else {}
    lib, dev = clash._lib(), torch.device("cuda", torch.cuda.current_device())
    stream = lambda: clash._stream(dev.index)  # noqa: E731
    noop = lambda: lib.clash_noop(stream())  # noqa: E731
    floor = dict(device_us=1e3 * cs._median_ms(noop), graph_us=cs._graph_us(noop),
                 host_us=cs._host_us(clash_noop))
    cs.log(f"[ab] launch floor: {json.dumps(floor)}")
    cd, sm = clash.CLASH_DIST, clash.SOFT_MARGIN
    rows = []
    for B, L in cs.CLASH_SHAPES:
        n, ca, c, mask = cs._clash_inputs(B, L)
        bb = (n, ca, c, mask)
        atoms, amask = (t.contiguous() for t in backbone_atoms(*bb))
        A = 3 * L
        loss, totals, counts = clash_fwd(*bb)
        ref_tot = clash_fwd_reference(atoms, amask)
        g = torch.tensor(0.75, device="cuda")
        scale = (g / (B * (counts + 1e-8))).contiguous()
        ref_grad = clash_bwd_reference(atoms, amask, scale)
        cs._close_scaled(f"baseline clash_fwd B{B}/L{L}", bmod.clash_fwd(atoms, amask), ref_tot)
        cs._close_scaled(f"current clash_fwd B{B}/L{L}", totals, ref_tot)
        cs._close_scaled(f"baseline clash_bwd B{B}/L{L}", bmod.clash_bwd(atoms, amask, scale),
                         ref_grad)
        cs._close_scaled(f"current clash_bwd B{B}/L{L}",
                         torch.stack(clash_bwd(*bb, g, counts), dim=2).reshape(B, A, 3),
                         ref_grad)

        # bare C entry points on buffers allocated once
        partial = torch.empty(B * blib.clash_n_tiles(A), device="cuda")
        b_tot = torch.empty(B, device="cuda")
        b_grad = torch.empty(B, A, 3, device="cuda")
        f_scr, b_scr = scratch_floats(B, L)
        out = torch.empty(1 + 2 * B, device="cuda")
        scr = torch.empty(max(f_scr, b_scr), device="cuda")
        grad = torch.empty(3, B, L, 3, device="cuda")
        tickets = torch.zeros(B * n_tiles(L), dtype=torch.int32, device="cuda")
        fsplit, bsplit = (block_split(math.prod(grid(B, L))) for grid in (fwd_grid, bwd_grid))
        strides = (*ca.stride(), *mask.stride())
        ptrs = [t.data_ptr() for t in bb]
        base_fwd = lambda: blib.clash_fwd_f32(  # noqa: E731
            atoms.data_ptr(), amask.data_ptr(), partial.data_ptr(), b_tot.data_ptr(),
            B, A, cd, sm, stream())
        base_bwd = lambda: blib.clash_bwd_f32(  # noqa: E731
            atoms.data_ptr(), amask.data_ptr(), scale.data_ptr(), b_grad.data_ptr(),
            B, A, cd, sm, stream())
        cur_fwd = lambda split=fsplit: lib.clash_fwd_f32(  # noqa: E731
            *ptrs, out.data_ptr(), scr.data_ptr(), tickets.data_ptr(), B, L, split, *strides,
            cd, sm, stream())
        cur_bwd = lambda split=bsplit: lib.clash_bwd_f32(  # noqa: E731
            *ptrs, g.data_ptr(), counts.data_ptr(), grad.data_ptr(), scr.data_ptr(),
            tickets.data_ptr(), B, L, split, *strides, cd, sm, stream())
        cur_fwd()
        cur_bwd()
        torch.cuda.synchronize()
        if not (torch.equal(out[1:1 + B], totals) and
                torch.equal(grad, torch.stack(clash_bwd(*bb, g, counts)))):
            raise RuntimeError(f"B{B}/L{L}: bare launches differ from the wrappers'")

        xs_b = [t.clone().requires_grad_(True) for t in (n, ca, c)]
        xs_c = [t.clone().requires_grad_(True) for t in (n, ca, c)]
        tb1, tc1, tc2, tb2 = (_term_clocks(*f) for f in (
            (bmod.clash_loss_kernel, xs_b, mask, g), (clash_loss_kernel, xs_c, mask, g),
            (clash_loss_kernel, xs_c, mask, g), (bmod.clash_loss_kernel, xs_b, mask, g)))
        pairs, near = float(counts.sum()), cs._clash_near_pairs(atoms, amask)
        row = dict(B=B, L=L, counts=pairs, near_pairs=near, split=[fsplit, bsplit],
                   fwd=_turns((base_fwd, lambda: bmod.clash_fwd(atoms, amask)),
                              (cur_fwd, lambda: clash_fwd(*bb))),
                   bwd=_turns((base_bwd, lambda: bmod.clash_bwd(atoms, amask, scale)),
                              (cur_bwd, lambda: clash_bwd(*bb, g, counts))),
                   term={f"{who}_{k}": [x[k], y[k]] for who, (x, y) in
                         (("baseline", (tb1, tb2)), ("current", (tc1, tc2))) for k in tb1},
                   plain_fwd_ms=cs._median_ms(lambda: clash_fwd_reference(atoms, amask), reps=3),
                   plain_bwd_ms=cs._median_ms(
                       lambda: clash_bwd_reference(atoms, amask, scale), reps=3),
                   bound_fwd_ms=cs._clash_bound(pairs, near, cs.CLASH_PEN_FLOP, 10 * B * L,
                                                1 + 2 * B)[0],
                   bound_bwd_ms=cs._clash_bound(pairs, near, cs.CLASH_GRAD_FLOP,
                                                10 * B * L + 1 + B, 9 * B * L)[0])
        # device kernels of one term besides the versions' own clash kernels
        row["term_other_kernels"] = {
            who: [k for k in cs._device_kernels(
                lambda: torch.autograd.grad(fn(*xs, mask), xs, g)) if "clash_" not in k]
            for who, fn, xs in (("baseline", bmod.clash_loss_kernel, xs_b),
                                ("current", clash_loss_kernel, xs_c))}
        if stages:
            row["stages_graph_us"] = {}
            for name, slib in stages.items():
                tk = torch.zeros_like(tickets)
                row["stages_graph_us"][name] = [cs._graph_us(lambda: slib.clash_fwd_f32(
                    *ptrs, out.data_ptr(), scr.data_ptr(), tk.data_ptr(), B, L, fsplit,
                    *strides, cd, sm, stream())), cs._graph_us(lambda: slib.clash_bwd_f32(
                    *ptrs, g.data_ptr(), counts.data_ptr(), grad.data_ptr(), scr.data_ptr(),
                    tk.data_ptr(), B, L, bsplit, *strides, cd, sm, stream()))]
        if args_ns.sweep_split:
            row["split_sweep_graph_us"] = {
                s: [[cs._graph_us(lambda: f(s)) for _ in range(2)] for f in (cur_fwd, cur_bwd)]
                for s in SWEEP_SPLITS}
        rows.append(row)
        cs.log(f"[ab] {json.dumps(row)}")
        del atoms, amask, ref_grad, partial, b_grad, scr, grad
    result = dict(device=device, floor=floor, rows=rows)
    if args_ns.out:
        os.makedirs(os.path.dirname(os.path.abspath(args_ns.out)), exist_ok=True)
        with open(args_ns.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
