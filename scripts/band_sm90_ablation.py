"""Where the Hopper band kernels' time goes: the one-pass kernels 1-2
(``csrc/egnn_band_fwd_sm90.cu``, ``csrc/egnn_band_bwd_sm90.cu``), or with
``--hd 512`` the width-512 kernels in both fp32-chain modes
(``csrc/egnn_band_{fwd,bwd}_sm90_hd512.cu``), timed with one part of their
work removed at a time, on one NVIDIA GPU.

    python scripts/band_sm90_ablation.py [--hd 512] [--workdir DIR] [--out FILE.json]

Each variant is a copy of ``protein_ensemble_vae_torch/csrc/`` in DIR (a
git-ignored directory; default ``protein_ensemble_vae_torch/_build/ablation``)
with text substitutions (VARIANTS; each must match), built with the
package's ``nvcc`` flags. A variant's outputs are wrong by design: only its
time is read. Every variant runs through the package's wrappers (its
libraries swapped in) at the flagship's training shapes in the bf16 model's
mode (at width 512: the train step's B4/L256 in the 3xTF32 and one-pass
modes, fp32 ``a`` / ``bs`` in 3xTF32 as the fp32 model has them), kernel 1
and kernel 2 (CUDA events, chip_smoke.py's ``_median_ms``),
and kernel 2 by pass (torch.profiler, ``band_kernels_ab._pass_split``). The
difference between the full kernels and a variant bounds what that part
costs where it does not overlap the rest. Needs a GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import band_kernels_ab as ab  # noqa: E402
import chip_smoke as cs  # noqa: E402

SHAPES = ((8, 128), (8, 192))
SOURCES = ("egnn_band_fwd_sm90", "egnn_band_bwd_sm90")
HD512_SHAPES = ((4, 256),)
HD512_SOURCES = ("egnn_band_fwd_sm90_hd512", "egnn_band_bwd_sm90_hd512")
# variant -> (file, regex, replacement) substitutions; the ones marked
# HD512_ONLY apply to the width-512 sources only (ALL_SIZES to both)
VARIANTS = {
    "full": (),
    # the tensor-core products (acc keeps whatever it held)
    "no_wgmma": (("egnn_sm90.cuh",
                  r"Wgmma<NW>::mma\(acc\[h\], desc\(a \+ 8 \* k8\), desc\(b \+ 8 \* k8\),\s*"
                  r"accumulate \|\| \(kc \| k8\) != 0\);", ";"),
                 ("egnn_sm90.cuh",
                  r"Wgmma<NW>::mma\(tmp, desc\(a \+ 8 \* k8\), desc\(b \+ 8 \* k8\),\s*"
                  r"\(kc - kg\) \| k8\);", ";")),
    # the exponentials and divisions of silu / silu'
    "no_silu": (("egnn_sm90.cuh", r"return __fdividef\(x, 1\.0f \+ __expf\(-x\)\);",
                 "return 0.5f * x;"),
                ("egnn_sm90.cuh", r"return __fdividef\(1\.0f, 1\.0f \+ __expf\(-x\)\);",
                 "return 0.5f + 0.125f * x;")),
    # the weight chunks' bulk copies (the producer arrives on each full
    # barrier with no bytes, so the ring's handshakes stay)
    "no_weight_copies": (("egnn_sm90.cuh",
                          r"mbar_expect_tx\(&full\[rp\.stage\], CHUNK \* 4\);\n"
                          r"        bulk_load\(ring \+ rp\.stage \* CHUNK, img \+ \(size_t\)q \* "
                          r"CHUNK, CHUNK \* 4, &full\[rp\.stage\]\);",
                          "mbar_arrive(&full[rp.stage]);"),),
    # kernel 2: the four copies of a step's tile to the weight-grad scratch
    "no_scratch_copies": (("egnn_band_bwd_sm90.cu", r"tile_to_scratch<HD>\(A, \w+, t, q\);", ""),),
    # kernel 2: the vector grads' column sums
    "no_column_sums": (("egnn_band_bwd_sm90.cu",
                        r"(__device__ __forceinline__ void add_cols8\(.*?\) \{\n).*?\n\}",
                        r"\1}"),),
}
HD512_VARIANTS = {
    "full": (),
    "no_wgmma": VARIANTS["no_wgmma"],
    "no_silu": VARIANTS["no_silu"],
    "no_weight_copies": VARIANTS["no_weight_copies"],
    "no_scratch_copies": (("egnn_band_bwd_sm90_hd512.cu", r"tile_to_scratch\(A, \w+, tid, q\);",
                           ""),),
    "no_column_sums": (("egnn_band_bwd_sm90_hd512.cu",
                        r"(__device__ __forceinline__ void add_cols8\(.*?\) \{\n).*?\n\}",
                        r"\1}"),),
    # 3xTF32: the in-place split of the tile between the second and third pass
    "no_split": (("egnn_sm90.cuh", r"split_tile<CONSUMERS \* WG>\(A, tid\);", ""),),
    # kernel 1's 3xTF32 products summed whole (no 128-K step sums; fails the
    # fp32 tolerance, PERF.md)
    "no_step_sums": (("egnn_sm90.cuh", r"constexpr int GROUP = PASSES == 3 \? 128 : 0;",
                      "constexpr int GROUP = 0;"),),
    # kernel 1 in 64-column chunks, twice the ring's stages (same bytes)
    "fwd_nw64": (("egnn_band_fwd_sm90_hd512.cu", r"constexpr int NW = 128;", "constexpr int NW = 64;"),
                 ("egnn_band_fwd_sm90_hd512.cu", r"constexpr int STAGES = 3;",
                  "constexpr int STAGES = 6;")),
    # kernel 2's edge pass in 128-column chunks, two stages a ring
    "bwd_nw128": (("egnn_band_bwd_sm90_hd512.cu", r"constexpr int NW = 64;", "constexpr int NW = 128;"),
                  ("egnn_band_bwd_sm90_hd512.cu", r"constexpr int STAGES = 5;",
                   "constexpr int STAGES = 2;")),
    # kernel 2's edge pass with the ring of the first design (3 stages)
    "bwd_stages3": (("egnn_band_bwd_sm90_hd512.cu", r"constexpr int STAGES = 5;",
                     "constexpr int STAGES = 3;"),),
    # the mbarrier waits without their watchdog (a clock read every 1,024 tries)
    "no_watchdog": (("egnn_sm90.cuh", r"if \(\(spins & 1023u\) == 0 && clock64\(\) - t0 > MBAR_CYCLES\) "
                     r"__trap\(\);", ";"),),
    # 3xTF32: the weight-grad pass's split of each stage
    "no_wgrad_split": (("egnn_band_bwd_sm90_hd512.cu",
                        r"dst\[i\] = make_float4\(lo\(v\.x\), lo\(v\.y\), lo\(v\.z\), "
                        r"lo\(v\.w\)\);", ""),),
}


def _variant_dir(workdir: str, name: str, csrc: str, variants: dict) -> str:
    """csrc copied to workdir/name with the variant's substitutions."""
    out = os.path.join(workdir, name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for fname, pattern, repl in variants[name]:
        path = os.path.join(out, fname)
        with open(path) as f:
            text = f.read()
        new, n = re.subn(pattern, repl, text, flags=re.S)
        if n == 0:
            raise RuntimeError(f"variant {name}: {pattern!r} matches nothing in {fname}")
        with open(path, "w") as f:
            f.write(new)
    return out


def _build_all(workdir: str, variants: dict, sources: tuple) -> dict:
    """nvcc every variant's two sources, all at once; returns name ->
    {source: library path}."""
    from protein_ensemble_vae_torch.ops.kernels.build import CSRC_DIR, NVCC_FLAGS, nvcc_path

    procs, libs = [], {}
    for name in variants:
        d = _variant_dir(workdir, name, CSRC_DIR, variants)
        libs[name] = {}
        for src in sources:
            lib = os.path.join(d, f"lib{src}.so")
            libs[name][src] = lib
            procs.append((name, src, subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", lib, os.path.join(d, src + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, src, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} {src} failed to build:\n{log}")
    return libs


def _use(libs: dict) -> None:
    """Route the package's Hopper wrappers to these libraries."""
    from protein_ensemble_vae_torch.ops.kernels import build, egnn_band

    loaded = {src: ctypes.CDLL(path) for src, path in libs.items()}
    orig = build.load_library
    build.load_library = lambda name: loaded[name] if name in loaded else orig(name)
    egnn_band._SM90_FN = egnn_band._SM90_BWD_FN = None
    egnn_band._HD512_FN = egnn_band._HD512_BWD_FN = None
    egnn_band._PER_SM.clear()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=None,
                    help="directory for the variants' sources and libraries")
    ap.add_argument("--hd", type=int, default=None, choices=(512,),
                    help="the width-512 kernels, both fp32-chain modes")
    ap.add_argument("--variants", default=None, metavar="A,B,...",
                    help="only these variants (\"full\" is always run)")
    ap.add_argument("--out", default=None, metavar="FILE.json")
    args = ap.parse_args(argv)

    import torch

    from protein_ensemble_vae_torch.ops.kernels import build
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import egnn_band_bwd, egnn_band_fwd

    device = cs.phase_device()
    workdir = os.path.abspath(args.workdir or os.path.join(build.DEFAULT_BUILD_DIR, "ablation"))
    os.makedirs(workdir, exist_ok=True)
    hd = args.hd or cs.HD
    if args.hd:
        variants, sources, shapes = HD512_VARIANTS, HD512_SOURCES, HD512_SHAPES
        modes = ((torch.float32, "highest"), (torch.bfloat16, "default"))
    else:
        variants, sources, shapes = VARIANTS, SOURCES, SHAPES
        modes = ((torch.bfloat16, "default"),)
    if args.variants:
        keep = {"full", *args.variants.split(",")}
        variants = {k: v for k, v in variants.items() if k in keep}
    libs = _build_all(workdir, variants, sources)
    rows = []
    for k, (B, L) in enumerate(shapes):
        a0 = cs._egnn_inputs(B, L, cs.SEED + k, hd)
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + k)
        g_agg = torch.randn(B, L, hd, generator=g, device="cuda")
        g_delta = torch.randn(B, L, 3, generator=g, device="cuda")
        for dtype, precision in modes:
            a = [a0[0].to(dtype).contiguous(), a0[1].to(dtype).contiguous()] + a0[2:]
            for name in variants:
                if name.endswith("split") and precision != "highest":
                    continue   # the splits run in 3xTF32 only
                _use(libs[name])
                fwd = lambda: egnn_band_fwd(*a, cs.W, precision)  # noqa: E731
                bwd = lambda: egnn_band_bwd(*a, g_agg, g_delta, cs.W, precision)  # noqa: E731
                row = dict(variant=name, precision=precision, Hd=hd, B=B, L=L,
                           fwd_ms=cs._median_ms(fwd), bwd_ms=cs._median_ms(bwd),
                           bwd_passes_ms=ab._pass_split(bwd))
                rows.append(row)
                cs.log(f"[ablation] {json.dumps(row)}")
    result = dict(device=device, rows=rows)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
