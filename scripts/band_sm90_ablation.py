"""Where the Hopper band kernels' time goes: the one-pass kernels 1-2
(``csrc/egnn_band_fwd_sm90.cu``, ``csrc/egnn_band_bwd_sm90.cu``), or with
``--hd 512`` the width-512 kernels in both fp32-chain modes
(``csrc/egnn_band_{fwd,bwd}_sm90_hd512.cu``), timed with one part of their
work removed at a time, on one NVIDIA GPU. ``--x3`` ablates the
shared-tile kernels in the fp32 model's 3xTF32 mode at Hd 256 (X3_VARIANTS,
at X3_SHAPES); ``--wide`` the kernels above 512 in both fp32-chain modes
(``csrc/egnn_band_{fwd,bwd}_sm90_wide.cu``, WIDE_VARIANTS) at Hd 1024,
B4/L256. ``--chain`` ablates the bf16 chain (bf16 ``a`` / ``bs``,
``chain_dtype=bfloat16``) instead, on the family of the width: the one-pass
kernels at Hd 256 (CHAIN_SHAPES), with ``--hd 512`` the shared-tile kernels,
with ``--wide`` those above 512 at Hd 1024 (CHAIN_VARIANTS of each).

    python scripts/band_sm90_ablation.py [--hd 512 | --x3 | --wide] [--chain]
        [--workdir DIR] [--out FILE.json]

Each variant is a copy of ``protein_ensemble_vae_torch/csrc/`` in DIR (a
git-ignored directory; default ``protein_ensemble_vae_torch/_build/ablation``)
with text substitutions (VARIANTS; each must match), built with the
package's ``nvcc`` flags. A variant's outputs are wrong by design: only its
time is read. Every variant runs through the package's wrappers (its
libraries swapped in) at the flagship's training shapes in the bf16 model's
mode (at width 512: the train step's B4/L256 in the 3xTF32 and one-pass
modes, fp32 ``a`` / ``bs`` in 3xTF32 as the fp32 model has them), kernel 1
and kernel 2 (CUDA events, chip_smoke.py's ``_median_ms``),
and both kernels by pass (torch.profiler, ``band_kernels_ab._pass_split``),
with ptxas's stack frame and spills of each variant's band kernels (in
its first row). The difference between the full kernels and a variant
bounds what that part costs where it does not overlap the rest. Needs a
GPU; imports no JAX.
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
                  r"Wgmma<NW(?:, BF)?>::mma\(acc\[h\], desc\(a \+ 8 \* k8\), desc\(b \+ 8 \* k8\),\s*"
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
    "no_scratch_copies": (("egnn_band_bwd_sm90.cu", r"tile_to_scratch<HD>\(A, \w+, t, q\);", ";"),),
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
    "no_scratch_copies": (("egnn_band_bwd_sm90_hd512.cu",
                           r"if constexpr \(CB\) tile_to_scratch_bf16<HD>\(A, dst, tid, q\);\s*"
                           r"else tile_to_scratch<HD>\(A, dst, tid, q\);", ";"),),
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
    "fwd_nw64": (("egnn_band_fwd_sm90_hd512.cu", r"NW_OF = HD == 512 \? 128 :",
                  "NW_OF = HD == 512 ? 64 :"),
                 ("egnn_band_fwd_sm90_hd512.cu", r"STAGES_OF = HD == 512 \? 3 :",
                  "STAGES_OF = HD == 512 ? 6 :")),
    # kernel 2's edge pass in 128-column chunks, two stages a ring
    "bwd_nw128": (("egnn_band_bwd_sm90_hd512.cu", r"NW_OF = HD / 2 < 64 \? HD / 2 : 64;",
                   "NW_OF = HD == 512 ? 128 : HD / 2 < 64 ? HD / 2 : 64;"),
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
                        r"dst\[i\] = make_float4\(s9::tf32_lo\(v\.x\), .*?\);", ""),),
}
# --x3: the shared-tile kernels in the fp32 model's 3xTF32 mode at Hd 256
# (egnn_sm90.cuh: product_split, the split tile)
X3_VARIANTS = {
    "full": (),
    # every product of the edge passes (the weight-grad pass keeps its own)
    "no_wgmma": (("egnn_sm90.cuh", r"Wgmma<NW>::mma\(s, desc\(a \+ 8 \* k8\), desc\(b \+ 8 \* k8\), "
                  r"\(kc \| k8\) != 0\);", ";"),
                 ("egnn_sm90.cuh", r"Wgmma<NW>::mma\(big, desc\(a \+ 8 \* k8\), desc\(b \+ 8 \* k8\), "
                  r"\(kz \| k8\) != 0\);", ";"),
                 ("egnn_sm90.cuh", r"Wgmma<NW>::mma\(s, desc\(as \+ 8 \* k8\), desc\(b \+ 8 \* k8\), 1\);",
                  ";")),
    # 3xTF32's small terms Xt.Ws and Xs.Wb (what 3xTF32 adds to one big pass)
    "no_small_terms": (("egnn_sm90.cuh", r"Wgmma<NW>::mma\(s, desc\(a \+ 8 \* k8\), "
                        r"desc\(b \+ 8 \* k8\), \(kc \| k8\) != 0\);", ";"),
                       ("egnn_sm90.cuh", r"Wgmma<NW>::mma\(s, desc\(as \+ 8 \* k8\), "
                        r"desc\(b \+ 8 \* k8\), 1\);", ";")),
    # the split tile's writes (fill and epilogues)
    "no_split_tile": (("egnn_sm90.cuh", r"if \(As\) \{", "if (false) {"),
                      ("egnn_band_fwd_sm90_hd512.cu",
                       r"if constexpr \(SPLIT<HD>\)\n(\s+)\*reinterpret_cast<float2\*>\(As",
                       r"if constexpr (false)\n\1*reinterpret_cast<float2*>(As"),
                      ("egnn_band_bwd_sm90_hd512.cu",
                       r"if constexpr \(SPLIT<HD>\)\n(\s+)\*reinterpret_cast<float2\*>\(As",
                       r"if constexpr (false)\n\1*reinterpret_cast<float2*>(As")),
    # silu / sigmoid in the accurate forms (expf, IEEE division) instead of the fast ones
    "accurate_silu": tuple((f, r"constexpr bool FAST_SILU = PASSES == 1 \|\| SPLIT<HD>;",
                            "constexpr bool FAST_SILU = PASSES == 1;")
                           for f in ("egnn_band_fwd_sm90_hd512.cu", "egnn_band_bwd_sm90_hd512.cu")),
    # the exponentials and divisions of silu / silu' (both forms)
    "no_silu": VARIANTS["no_silu"] + (
        ("egnn_tile.cuh", r"sigmoid\(float x\) \{ return 1\.0f / \(1\.0f \+ expf\(-x\)\); \}",
         "sigmoid(float x) { return 0.5f + 0.125f * x; }"),
        ("egnn_tile.cuh", r"silu\(float x\) \{ return x / \(1\.0f \+ expf\(-x\)\); \}",
         "silu(float x) { return 0.5f * x; }")),
    # kernel 1's big terms summed whole (no 32-K step sums), or 64 / 128 K apart
    "no_step_sums": (("egnn_band_fwd_sm90_hd512.cu", r"GROUP_OF = HD == 512 \? 128 : 32;",
                      "GROUP_OF = HD == 512 ? 128 : 0;"),),
    "step_sums_64": (("egnn_band_fwd_sm90_hd512.cu", r"GROUP_OF = HD == 512 \? 128 : 32;",
                      "GROUP_OF = HD == 512 ? 128 : 64;"),),
    "step_sums_128": (("egnn_band_fwd_sm90_hd512.cu", r"GROUP_OF = HD == 512 \? 128 : 32;",
                       "GROUP_OF = HD == 512 ? 128 : 128;"),),
    "no_weight_copies": VARIANTS["no_weight_copies"],
    "no_scratch_copies": HD512_VARIANTS["no_scratch_copies"],
    "no_column_sums": HD512_VARIANTS["no_column_sums"],
    "no_wgrad_split": HD512_VARIANTS["no_wgrad_split"],
    # the weight grads' step sums over each k8 step instead of a 32-row chunk
    "wgrad_sums_8": (("egnn_band_bwd_sm90_hd512.cu", r"WGRAD_SPAN = HD == 512 \? 8 : 32;",
                      "WGRAD_SPAN = HD == 512 ? 8 : 8;"),),
    # kernel 1 in 128-column chunks, three 16 KiB stages a ring
    "fwd_nw128": (("egnn_band_fwd_sm90_hd512.cu", r"HD / 2 < 64 \? HD / 2 : 64;",
                   "HD / 2 < 128 ? HD / 2 : 128;"),
                  ("egnn_band_fwd_sm90_hd512.cu", r"STAGES_OF = HD == 512 \? 3 : 6;",
                   "STAGES_OF = HD == 512 ? 3 : 3;")),
}


# The fp32 model's 3xTF32 mode at Hd 256 (--x3): the train step's B4/L256 and
# generation's B10/L256, fp32 a / bs.
X3_SHAPES = ((4, 256), (10, 256))
# --wide: the kernels above 512 (egnn_sm90_wide.cuh) at the
# --decoder_hidden 1024 epoch's train step, both fp32-chain modes
WIDE_HD, WIDE_SHAPES = 1024, ((4, 256),)
WIDE_SOURCES = ("egnn_band_fwd_sm90_wide", "egnn_band_bwd_sm90_wide")
_WIDE_EXPECT = r"mbar_expect_tx\(&full\[rp\.stage\], C::STAGE \* 4\);"
WIDE_VARIANTS = {
    "full": (),
    # every product of the edge passes (the weight-grad pass keeps its own)
    "no_wgmma": tuple(("egnn_sm90_wide.cuh", pat, ";") for pat in (
        r"Wgmma<NW(?:, CB)?>::mma\(acc, desc\(a \+ 8 \* k8\), desc\(wb \+ 8 \* k8\), "
        r"\(kc \| k8\) != 0\);",
        r"Wgmma<NW>::mma\(sml, desc\(a \+ 8 \* k8\), desc\(ws \+ 8 \* k8\), \(kc \| k8\) != 0\);",
        r"Wgmma<NW>::mma\(t, desc\(a \+ 8 \* k8\), desc\(wb \+ 8 \* k8\), k8 != 0\);",
        r"Wgmma<NW>::mma\(sml, desc\(as \+ 8 \* k8\), desc\(wb \+ 8 \* k8\), 1\);")),
    # 3xTF32's small terms Xt.Ws and Xs.Wb: the big pass alone (still
    # streaming the weights' small parts and splitting the A chunks)
    "no_small_terms": tuple(("egnn_sm90_wide.cuh", pat, ";") for pat in (
        r"Wgmma<NW>::mma\(sml, desc\(a \+ 8 \* k8\), desc\(ws \+ 8 \* k8\), \(kc \| k8\) != 0\);",
        r"Wgmma<NW>::mma\(sml, desc\(as \+ 8 \* k8\), desc\(wb \+ 8 \* k8\), 1\);")),
    # the activation's bulk copies (the A stream): the stages bring the
    # weight chunks only
    "no_a_stream": (("egnn_sm90_wide.cuh", _WIDE_EXPECT,
                     "mbar_expect_tx(&full[rp.stage], C::PARTS * C::WCHUNK * 4);"),
                    ("egnn_sm90_wide.cuh",
                     r"bulk_load\(st, x \+ \(size_t\)kc \* ACHUNK, ACHUNK \* 4, &full\[rp\.stage\]\);",
                     "")),
    # 3xTF32: the split of each A chunk in shared memory (the products read
    # whatever the split buffers hold)
    "no_a_split": (("egnn_sm90_wide.cuh",
                    r"reinterpret_cast<float4\*>\(as\)\[i\] =\s+make_float4\(tf32_lo\(v\.x\), "
                    r"tf32_lo\(v\.y\), tf32_lo\(v\.z\), tf32_lo\(v\.w\)\);", ""),),
    # the weight chunks' bulk copies
    "no_weight_copies": (("egnn_sm90_wide.cuh", _WIDE_EXPECT,
                          "mbar_expect_tx(&full[rp.stage], ACHUNK * 4);"),
                         ("egnn_sm90_wide.cuh",
                          r"bulk_load\(st \+ C::W_BIG, img_big \+ wq, C::WCHUNK \* 4, "
                          r"&full\[rp\.stage\]\);", ""),
                         ("egnn_sm90_wide.cuh",   # an empty statement: it is an if's body
                          r"bulk_load\(st \+ C::W_SMALL, img_small \+ wq, C::WCHUNK \* 4, "
                          r"&full\[rp\.stage\]\);", ";")),
    # kernel 1's agg sums from the ring stages, kernel 2's copies into the
    # weight-grad layout (the side work of each product's first column pass)
    "no_side": (("egnn_sm90_wide.cuh", r"if \(p == 0\) side\(kc, st\);", ""),),
    # kernel 2's per-edge scratch written with plain stores, not evict-first
    "no_stcs": (("egnn_band_bwd_sm90_wide.cu", r'#include "egnn_sm90_wide.cuh"\n',
                 '#include "egnn_sm90_wide.cuh"\n#define __stcs(p, v) (*(p) = (v))\n'),),
    # the weight grads' step sums over each k8 step in both modes
    "wgrad_span_8": (("egnn_band_bwd_sm90_wide.cu", r"WGRAD_SPAN = PASSES == 3 \? 32 : 8;",
                      "WGRAD_SPAN = 8;"),),
    # the epilogues' stores of the activations to the stream rows (the
    # fill's stay)
    "no_epilogue_stores": (("egnn_sm90_wide.cuh",
                            r"(__device__ __forceinline__ void put2\(.*?\) \{\n).*?\n\}", r"\1}"),),
}


# --chain: the bf16 chain. Its sigmoid's exponentials and reciprocals in
# fp32 (egnn_sm90.cuh: sigmoid2) are its own part; the products, the
# streams and the side work are the families' variants.
CHAIN_SHAPES = ((16, 256), (4, 256))
_CHAIN_OWN = {
    # the bf16 sigmoid's exponentials and reciprocals (its bf16x2 ops stay)
    "no_sigmoid_bf16": (("egnn_sm90.cuh",
                         r"const float2 d = f2\(add2\(one2\(\), bf2r\(__expf\(-v\.x\), "
                         r"__expf\(-v\.y\)\)\)\);\s*return bf2r\(__fdividef\(1\.0f, d\.x\), "
                         r"__fdividef\(1\.0f, d\.y\)\);",
                         "return bf2r(0.5f + 0.125f * v.x, 0.5f + 0.125f * v.y);"),),
}
CHAIN_VARIANTS = {
    "one_pass": {"full": (), "no_wgmma": VARIANTS["no_wgmma"], **_CHAIN_OWN,
                 "no_weight_copies": VARIANTS["no_weight_copies"],
                 "no_scratch_copies": (("egnn_band_bwd_sm90.cu",
                                        r"if constexpr \(CB\) tile_to_scratch_bf16<HD>\(A, dst, t, q\);",
                                        "if constexpr (CB) {}"),),
                 "no_column_sums": VARIANTS["no_column_sums"]},
    "hd512": {"full": (), "no_wgmma": VARIANTS["no_wgmma"], **_CHAIN_OWN,
              "no_weight_copies": VARIANTS["no_weight_copies"],
              "no_scratch_copies": HD512_VARIANTS["no_scratch_copies"],
              "no_column_sums": HD512_VARIANTS["no_column_sums"]},
    "wide": {"full": (), "no_wgmma": WIDE_VARIANTS["no_wgmma"][:1], **_CHAIN_OWN,
             **{k: WIDE_VARIANTS[k] for k in ("no_a_stream", "no_weight_copies", "no_side",
                                               "no_epilogue_stores")}},
}


def _variant_dir(workdir: str, name: str, csrc: str, variants: dict) -> str:
    """csrc copied to workdir/<name> with the variant's substitutions."""
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


def _spills(log: str) -> dict:
    """The band kernels' entries in an nvcc -Xptxas -v log: their mangled
    names' readable part -> ptxas's stack frame and spill line."""
    lines, out = log.splitlines(), {}
    for i, line in enumerate(lines[:-1]):
        m = re.search(r"Function properties for \S*?(egnn_(?:fwd|bwd_edges)\w*?)Ev", line)
        if m:
            out[m.group(1)] = lines[i + 1].strip()
    return out


def _build_all(workdir: str, variants: dict, sources: tuple) -> tuple[dict, dict]:
    """nvcc every variant's two sources, all at once; returns name ->
    {source: library path}, and name -> its band kernels' ptxas stack frame
    and spill lines (``_spills``)."""
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
    spills = {name: {} for name in variants}
    for name, src, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} {src} failed to build:\n{log}")
        spills[name].update(_spills(log))
    return libs, spills


def _drift(fwd_of, a, hd: int) -> dict:
    """Kernel 1's error against its plain version as a fraction of the GPU
    tests' tolerance (rtol 1e-4, atol 1e-4: ``tests/test_torch_gpu.py``'s
    ``test_odd_length_every_width``), the worst element of agg and of
    raw_delta: on ``a`` (the variant's timed inputs) and on B2/L37 at W 40
    (that test's shape, inputs from chip_smoke.py's generator). Variants
    that drop work are wrong by design; read it for the accumulation's."""
    import torch

    from protein_ensemble_vae_torch.ops.kernels.egnn_band import egnn_band_reference

    def frac(args):
        got, want = fwd_of(args), egnn_band_reference(*args, cs.W)
        return [float(((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max()) for g, w in zip(got, want)]

    small = cs._egnn_inputs(2, 37, cs.SEED + 77, hd)
    small = [small[0].to(a[0].dtype), small[1].to(a[0].dtype)] + small[2:]
    with torch.no_grad():
        return dict(timed=frac(a), b2_l37=frac(small))


def _use(libs: dict) -> None:
    """Route the package's Hopper wrappers to these libraries."""
    from protein_ensemble_vae_torch.ops.kernels import build, egnn_band

    loaded = {src: ctypes.CDLL(path) for src, path in libs.items()}
    orig = build.load_library
    build.load_library = lambda name: loaded[name] if name in loaded else orig(name)
    egnn_band._SM90_FN = egnn_band._SM90_BWD_FN = None
    egnn_band._HD512_FN = egnn_band._HD512_BWD_FN = None
    egnn_band._WIDE_FN = egnn_band._WIDE_BWD_FN = None
    egnn_band._PER_SM.clear()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=None,
                    help="directory for the variants' sources and libraries")
    ap.add_argument("--hd", type=int, default=None, choices=(512,),
                    help="the width-512 kernels, both fp32-chain modes")
    ap.add_argument("--x3", action="store_true",
                    help="the fp32 model's 3xTF32 mode at Hd 256 (X3_VARIANTS), at X3_SHAPES")
    ap.add_argument("--wide", action="store_true",
                    help="the kernels above 512 at Hd 1024 (WIDE_VARIANTS), both modes")
    ap.add_argument("--chain", action="store_true",
                    help="the bf16 chain (CHAIN_VARIANTS) on the family of the width")
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
    hd = WIDE_HD if args.wide else args.hd or cs.HD
    chain = torch.bfloat16 if args.chain else torch.float32
    if args.chain:
        family = "wide" if args.wide else "hd512" if args.hd else "one_pass"
        variants = CHAIN_VARIANTS[family]
        sources = {"wide": WIDE_SOURCES, "hd512": HD512_SOURCES, "one_pass": SOURCES}[family]
        shapes = CHAIN_SHAPES if family == "one_pass" else ((4, 256),)
        modes = ((torch.bfloat16, "default"),)
    elif args.wide:
        variants, sources, shapes = WIDE_VARIANTS, WIDE_SOURCES, WIDE_SHAPES
        modes = ((torch.float32, "highest"), (torch.bfloat16, "default"))
    elif args.x3:
        variants, sources, shapes = X3_VARIANTS, HD512_SOURCES, X3_SHAPES
        modes = ((torch.float32, "highest"),)
    elif args.hd:
        variants, sources, shapes = HD512_VARIANTS, HD512_SOURCES, HD512_SHAPES
        modes = ((torch.float32, "highest"), (torch.bfloat16, "default"))
    else:
        variants, sources, shapes = VARIANTS, SOURCES, SHAPES
        modes = ((torch.bfloat16, "default"),)
    if args.variants:
        keep = {"full", *args.variants.split(",")}
        variants = {k: v for k, v in variants.items() if k in keep}
    libs, spills = _build_all(workdir, variants, sources)
    rows = []
    for k, (B, L) in enumerate(shapes):
        a0 = cs._egnn_inputs(B, L, cs.SEED + k, hd)
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + k)
        g_agg = torch.randn(B, L, hd, generator=g, device="cuda")
        g_delta = torch.randn(B, L, 3, generator=g, device="cuda")
        for dtype, precision in modes:
            a = [a0[0].to(dtype).contiguous(), a0[1].to(dtype).contiguous()] + a0[2:]
            for name in variants:
                if ((name.endswith("split") or name == "no_small_terms")
                        and precision != "highest"):
                    continue   # the splits and small terms run in 3xTF32 only
                _use(libs[name])
                fwd_of = lambda x: egnn_band_fwd(*x, cs.W, precision, chain)  # noqa: E731
                bwd = lambda: egnn_band_bwd(*a, g_agg, g_delta, cs.W, precision,  # noqa: E731
                                            chain)
                fwd = lambda: fwd_of(a)  # noqa: E731
                kw = dict(reps=3, min_launches=3) if args.wide else {}
                row = dict(variant=name, precision=precision, Hd=hd, B=B, L=L,
                           chain=str(chain)[6:],
                           fwd_ms=cs._median_ms(fwd, **kw), bwd_ms=cs._median_ms(bwd, **kw),
                           fwd_passes_ms=ab._pass_split(fwd),
                           bwd_passes_ms=ab._pass_split(bwd))
                if args.x3 and k == 0:   # the variant's accumulation drift
                    row["drift"] = _drift(fwd_of, a, hd)
                if k == 0 and dtype == modes[0][0]:   # its kernels' registers spilled
                    row["ptxas"] = spills[name]
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
