"""Where the Hopper band kernels' time goes: the one-pass kernels 1-2
(``csrc/egnn_band_fwd_sm90.cu``, ``csrc/egnn_band_bwd_sm90.cu``) timed with
one part of their work removed at a time, on one NVIDIA GPU.

    python scripts/band_sm90_ablation.py [--workdir DIR] [--out FILE.json]

Each variant is a copy of ``protein_ensemble_vae_torch/csrc/`` in DIR (a
git-ignored directory; default ``protein_ensemble_vae_torch/_build/ablation``)
with text substitutions (VARIANTS; each must match), built with the
package's ``nvcc`` flags. A variant's outputs are wrong by design: only its
time is read. Every variant runs through the package's wrappers (its
libraries swapped in) at the flagship's training shapes in the bf16 model's
mode, kernel 1 and kernel 2 (CUDA events, chip_smoke.py's ``_median_ms``),
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
# variant -> (file, regex, replacement) substitutions
VARIANTS = {
    "full": (),
    # the tensor-core products (acc keeps whatever it held)
    "no_wgmma": (("egnn_sm90.cuh",
                  r"Wgmma<C::NW>::mma\(acc\[h\], desc\(a \+ 8 \* k8\), desc\(b \+ 8 \* k8\), "
                  r"\(kc \| k8\) != 0\);", ""),),
    # the exponentials and divisions of silu / silu'
    "no_silu": (("egnn_sm90.cuh", r"return __fdividef\(x, 1\.0f \+ __expf\(-x\)\);",
                 "return 0.5f * x;"),
                ("egnn_sm90.cuh", r"return __fdividef\(1\.0f, 1\.0f \+ __expf\(-x\)\);",
                 "return 0.5f + 0.125f * x;")),
    # the weight chunks' bulk copies (the producer arrives on each full
    # barrier with no bytes, so the ring's handshakes stay)
    "no_weight_copies": (("egnn_sm90.cuh",
                          r"mbar_expect_tx\(&full\[rp\.stage\], C::CHUNK \* 4\);\n"
                          r"        bulk_load\(ring \+ rp\.stage \* C::CHUNK, img \+ \(size_t\)q \* "
                          r"C::CHUNK, C::CHUNK \* 4,\n                  &full\[rp\.stage\]\);",
                          "mbar_arrive(&full[rp.stage]);"),),
    # kernel 2: the four copies of a step's tile to the weight-grad scratch
    "no_scratch_copies": (("egnn_band_bwd_sm90.cu", r"tile_to_scratch<HD>\(A, \w+, t, q\);", ""),),
    # kernel 2: the vector grads' column sums
    "no_column_sums": (("egnn_band_bwd_sm90.cu",
                        r"(__device__ __forceinline__ void add_cols8\(.*?\) \{\n).*?\n\}",
                        r"\1}"),),
}


def _variant_dir(workdir: str, name: str, csrc: str) -> str:
    """csrc copied to workdir/name with the variant's substitutions."""
    out = os.path.join(workdir, name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for fname, pattern, repl in VARIANTS[name]:
        path = os.path.join(out, fname)
        with open(path) as f:
            text = f.read()
        new, n = re.subn(pattern, repl, text, flags=re.S)
        if n == 0:
            raise RuntimeError(f"variant {name}: {pattern!r} matches nothing in {fname}")
        with open(path, "w") as f:
            f.write(new)
    return out


def _build_all(workdir: str) -> dict:
    """nvcc every variant's two sources, all at once; returns name ->
    {source: library path}."""
    from protein_ensemble_vae_torch.ops.kernels.build import CSRC_DIR, NVCC_FLAGS, nvcc_path

    procs, libs = [], {}
    for name in VARIANTS:
        d = _variant_dir(workdir, name, CSRC_DIR)
        libs[name] = {}
        for src in SOURCES:
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
    egnn_band._PER_SM.clear()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=None,
                    help="directory for the variants' sources and libraries")
    ap.add_argument("--out", default=None, metavar="FILE.json")
    args = ap.parse_args(argv)

    import torch

    from protein_ensemble_vae_torch.ops.kernels import build
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import egnn_band_bwd, egnn_band_fwd

    device = cs.phase_device()
    workdir = os.path.abspath(args.workdir or os.path.join(build.DEFAULT_BUILD_DIR, "ablation"))
    os.makedirs(workdir, exist_ok=True)
    libs = _build_all(workdir)
    rows = []
    for k, (B, L) in enumerate(SHAPES):
        a = cs._egnn_inputs(B, L, cs.SEED + k)
        a = [a[0].bfloat16().contiguous(), a[1].bfloat16().contiguous()] + a[2:]
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + k)
        g_agg = torch.randn(B, L, cs.HD, generator=g, device="cuda")
        g_delta = torch.randn(B, L, 3, generator=g, device="cuda")
        for name in VARIANTS:
            _use(libs[name])
            fwd = lambda: egnn_band_fwd(*a, cs.W, "default")  # noqa: E731
            bwd = lambda: egnn_band_bwd(*a, g_agg, g_delta, cs.W, "default")  # noqa: E731
            row = dict(variant=name, B=B, L=L, fwd_ms=cs._median_ms(fwd),
                       bwd_ms=cs._median_ms(bwd), bwd_passes_ms=ab._pass_split(bwd))
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
