"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--profile TRACE.json]

Phases, each of which raises (non-zero exit, no result line) on failure:

1. device: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; no CUDA device -> exit 1.
2. build: every CUDA source of the port, one ``nvcc`` each, in parallel,
   with ``-Xptxas -v``'s register / shared-memory / spill report.
3. kernels: each kernel's wrapper against its plain PyTorch version, on the
   card, at the shapes the main paths give it (TF32 off for PyTorch; kernels
   1-2 run their products in 3xTF32), with the stated tolerance; device
   time per call (CUDA events around >= 50 back-to-back calls filling
   >= 1 ms, median of 5 windows after warm-up) of kernel and plain version,
   host time per wrapper call (no synchronisation), the launch floor (an
   empty kernel through the same ctypes path); kernels 3-4, whose wrapper's
   host work paces back-to-back calls, are also timed by the replay of 100
   calls captured in a CUDA graph (``graph_ms``, the device's own time;
   ``ms`` stays the back-to-back clock of every row); the least time the card
   could take (bound, fp32 peak) and, for kernels 1-2, the tensor-core
   bound (3 x the FLOP at the TF32 peak). Kernel 1 (band forward) at
   generation's B1/B10 x L256/L640 and the training shapes B4/L256 and
   B2/L640; kernel 2 (band backward) at the training shapes; kernels 3-4
   (clash forward / backward) at the training shapes and refinement's
   B10/L256, B10/L640 and B10/L230 (``cli.refine`` on an ensemble file read
   back unpadded), with the counts equal to ``pair_count``; every
   kernel must give bitwise-identical output over two launches. A
   torch.profiler pass shows that one clash-term forward and backward
   issue exactly one kernel 3 and one kernel 4 on the device. Then the
   bf16-model mode of kernels 1-2 (bf16 ``a`` / ``bs``, one-pass TF32
   products, ``precision="default"``) against the plain version on the
   same bf16-rounded inputs at the JAX package's bf16 tolerances (3 % of
   max |value| forward, 5 % of max |grad| backward), with the error
   printed beside the tolerance: kernel 1 at B1/L256, B10/L256 and
   B10/L640, kernel 2 at B4/L256 and B2/L640; device ms of the mode beside
   the same shape's 3xTF32 ms in the same call, the plain version's ms,
   host us, the bound (the FLOP at the TF32 peak, the rate of one-pass
   TF32 products, or the bytes) and the fp32-core time (the FLOP at the
   fp32 peak). These are extra ``shapes`` rows of kernels 1-2
   with ``mode`` "bfloat16/default". Then the bf16 chain of kernels 1-2
   (``chain_dtype=bfloat16``) against its plain version (the JAX kernel's
   rounding op by op), values within 0.1 % and gradients within 5 % of
   max |plain|, and closer to it than to the one-pass fp32-chain kernel:
   both kernels at B16/L256 (the JAX package's chain A/B shape), B10/L640,
   B4/L256 and B2/L640 with bf16 ``a`` / ``bs``, and at B4/L256 with fp32
   ``a`` / ``bs``; device ms beside the one-pass fp32-chain ms and the
   3xTF32 ms of the same shape in the same call, plain ms, host us, the
   bound (the FLOP at the bf16 tensor-core peak, or the bytes), the
   fp32-core time and the bf16 weight-stream and scratch floors; rows of
   the one-pass Hopper kernels (``egnn_band_{fwd,bwd}_sm90``, which serve
   the bf16 chain up to Hd 256) with ``mode`` "<dtype>/bfloat16_chain".
   Then kernels 1-2 at Hd 512 (``phase_wide_kernels``: in every mode the
   width-512 Hopper kernels ``egnn_band_{fwd,bwd}_sm90_hd512`` with their
   weight-stream and scratch floors) in the three modes, kernel 1 at B4/L256 and B10/L640,
   kernel 2 at B4/L256 and B2/L640, and at widths the wrappers zero-pad to
   a native one: Hd 384 (-> 512) in the three modes, Hd 8 and 48 (-> 32,
   64) in fp32, at B4/L256; and above 512 (``WIDER_ROWS``: a run-time
   width, a multiple of 256, any other padded up), every mode on the
   Hopper kernels above 512 (``egnn_band_{fwd,bwd}_sm90_wide``, with their
   weight- and A-stream floors): Hd 1024 at B4/L256 and Hd 640 (-> 768), 1100 (-> 1280) and 2048
   at B1/L256, in the three modes, both kernels; each row at its mode's
   Hd-256 tolerance, two launches bitwise identical, its bound counted at
   the real width; ``shapes`` rows with ``Hd`` and ``padded_to``. Then the
   flagship path's shapes at Hd 256 (``FLAGSHIP_ROWS``): both kernels in
   the bf16-model mode at B8/L128 and B8/L192 (training), kernel 1 in fp32
   at B4/L128 and B20/L128 (generation), at their modes' tolerances; kernels
   3-4 at B4/L128, B8/L128 and B8/L192 join CLASH_SHAPES. Its path follows:
   ``scripts/chain_dtype_ab.py``'s ``run()`` (the bf16 chain against the
   fp32 chain at B16/L256: value gaps and fwd + bwd ms; then at B4/L256 at
   Hd 512 and 1024), counts reset just before and read just after: each
   Hopper family's kernels must launch in the bf16 chain, the mma.sync
   kernels (``egnn_band_fwd`` / ``egnn_band_bwd``) not at all.
4. generation main path: ``generate_ensembles`` with a fresh seeded
   ``HierCVAE`` at the default ``ModelConfig`` widths on two synthetic NeRF
   proteins (buckets 256 and 640), ``num_samples=10``. Launch counts are
   reset just before and read just after: each structure makes 2 decodes x
   8 EGNN layers = 16 launches. Outputs must be finite and the PDB files
   written; the kernel decode of one latent is held against the plain
   decode of it. Then data preparation (``phase_dataprep``): ESM-2 at the
   published t33 width (hidden 1280, 33 layers, 20 heads, FFN 5120; seeded
   random weights drawn as HF draws them, ``init_hf_``) on the card, its
   forward on a ragged B2/T64 batch with one <mask> token held against the
   port's CPU forward on the same weights (atol 5e-4), ``ESM2Embedder.embed``
   against the unpadded forward (atol 1e-4), and ``embed`` timed at 254,
   510 and 1022 residues (buckets of 256, 512, 1024 tokens; the stream
   span from CUDA events, median of 5 after one warm-up; tokens/s, peak
   memory) with one torch.profiler pass per length (device busy ms and
   share, the fp32 FLOP bound against the busy time; at 1022 also device
   time by kind); then
   the path: ``tests/fixtures/messy_9xyz.cif`` -> ``parse_mmcif_backbone``
   -> ``chain_to_arrays`` -> ``process_chain`` (torsions on the card) ->
   ``write_chain_h5`` (an H5 file by the port's own writer: this machine
   has no h5py) -> ``add_embeddings_to_h5`` (the ESM-2 embedding of chain
   AA, 58 residues, appended) -> ``EnsembleDataset`` reading the file ->
   ``generate_ensembles`` with the main model,
   ``num_samples=10`` -> PDB files. Counts reset just before the path and
   read just after: 3 structures x 16 launches of kernel 1, nothing else.
   Its weights are freed before the later phases.
5. training main path: ``train_model`` for 2 epochs at the default widths,
   fp32, batch 4, on an in-memory pair dataset of NeRF conformers (L = 230,
   K = 5, 10 pairs: 8 train / 2 val), checkpointing into a temporary
   directory. Launch counts are reset just before and read after each
   epoch: 8 band forward + 8 band backward + 1 clash forward + 1 clash
   backward per train step, 8 + 1 per eval step. Losses finite, parameters
   changed. Then one ``cli.train --compute_dtype bfloat16`` run (1 epoch,
   default widths, batch 4) on TRAIN_PROTEIN's fold written as H5 files
   by the port's writer and read through ``EnsembleDataset``
   (``_pair_manifests``: 10 train / 1 val pairs; the CLI phases 5b, 6b
   and 8 read the same files): counts reset just before and read just
   after, every band launch in the bf16 mode; losses finite, checkpoint
   written.
6. timed train steps, fp32 then bf16 (``HierCVAE(dtype=bfloat16)``):
   ``make_train_step`` at B4/L256 and at B2/L640 with ``decoder_remat``
   (16 band forwards per step), kernel path and plain path
   (``use_pallas_egnn=False``): median step ms over 5 steps after 2
   warm-ups (host clock, synchronised), peak device memory and the band
   launches by mode; on one B4/L256 batch of each dtype the kernel path's
   loss dict and gradients are held against the plain path's
   (``_compare_paths`` states what is held and what is only reported); in
   fp32 also the float64 triage (``_float64_triage``): both fp32 paths'
   gradients against the float64 plain path's, for the smooth part, the
   full loss and each physics term alone, the kernel path's worst distance
   held at F64_RATIO x the plain path's (``--grad-triage FILE`` writes the
   per-tensor distances).
6b. the decoder at Hd 512 (``phase_wide_decoder``), after the timed steps:
   ``ModelConfig(decoder_hidden=512)``, every other field at its default,
   random weights from the seed: generation at buckets 256 / 640 with
   phase 4's checks, timed beside the plain path, the fp32 B4/L256 step
   held against the plain path as in phase 6 (float64 triage included),
   fp32 and bf16 steps timed on both paths, launches by mode (the
   width-512 kernels must launch in the generation and in both steps);
   then ``cli.train --device cuda`` for one epoch at the widths of the
   repository's verify drive (decoder width 16, zero-padded to 32)
   through kernels 1-4, one at decoder width 384 (zero-padded to 512: the
   width-512 kernels must launch), and one epoch of
   ``cli.train --decoder_hidden 1024`` (every other width at its
   default) through the Hopper kernels above 512
   (``egnn_band_{fwd,bwd}_sm90_wide``) and kernels 3-4.
7. refinement, after the train steps (what it leaves allocated would count
   in their peak memory): checks first, counted apart from the path: the
   polish Cartesian energy and its gradient with the clash term through
   kernels 3-4 against the plain clash at B10/L256 and B10/L640 (rtol 1e-3,
   gradient atol 1e-4 * max|g|); 20 Adam steps replayed from a CUDA graph
   against the same loop run eagerly on the card (1e-4 A); at B10/L640 the
   torsion refiner's prefix-product rebuild against the sequential build in
   float64 (1e-3 A), a torch.profiler pass over each stage (device busy
   share, device ms per step, exactly one kernel 3 and one kernel 4 per
   replayed Cartesian step) and the device us of the clash and dense vdW
   terms against a step. Then the refine main path: ``generate_ensembles``
   with ``refine_mode="polish"`` (600 Cartesian steps, then 300 torsion
   steps) on both proteins and ``cli.refine`` (150 steps) on the bucket-256
   ensemble it wrote, after a first uncounted pass that captures the
   graphs. Counts reset just before and read just after: 32 band-forward
   launches and 600 x 2 + 150 = 1,350 of kernels 3 and 4 each (a replayed
   graph adds the launches its capture made; the counted ``cli.refine``
   call runs under torch.profiler, whose records must hold 150 of each
   clash kernel, profiled again uncounted if CUPTI dropped one; its window
   opens with 8 launches of the empty ``clash_noop`` kernel and a
   synchronise: without them CUPTI lost the window's first kernel-3
   record in 4 of 6 windows, with them in none of 4). Each stage's
   output is finite with its padded rows bitwise unchanged, and the torsion
   stage's bonds lie within 1e-4 A of ``config.BOND_*``. ``cli.analyze``
   and ``cli.validate`` then score the files on the card.
5b. grad-watch path (``phase_watch_path``): ``cli.train --watch_every 1``
   for 2 epochs at the default widths, fp32, batch 4, on the same pairs;
   counts reset just before and read just after: each epoch launches its
   train and val steps' kernels plus 8 / 8 / 1 / 1 for the dump (one
   gradient of the first batch through kernels 1-4). Two ``.npz`` dumps
   with a ``param/`` and a ``grad/`` entry for every parameter, all
   finite; the last dump's gradient statistics equal ``make_loss_fn``'s
   gradient of the same batch and seed recomputed on the kernel path (rtol
   1e-6 of each tensor's scale); two runs without the flag, the flagged run
   no further from the first than the second is (both largest parameter
   gaps logged). Then ``make_param_grad_fn`` on the kernel and the plain
   path (dropout on, same seed: the same masks), the smooth loss's
   gradients held per tensor at rtol 1e-3 / atol 1e-5 max|g|, the full
   loss's reported; ``viz.parameters.main`` and ``viz.training_curves`` on
   the run's checkpoint; the dump's cost (the gradient's CUDA-event ms, the
   whole hook's host ms); ``utils.profiling.trace`` around 3 warm B4/L256
   fp32 steps (its window opened with ``clash_noop`` markers; its records
   must name all four kernels), and ``time_fn`` / ``scan_step_time``
   beside a CUDA-event median of the same step, printed with phase 6's
   median and the card's name and power limit (recorded, gating nothing).
8. parallelism (``phase_parallel``), run before the timed steps (phase
   6), at the default widths, fp32,
   the B4/L256 step (4 pairs of TRAIN_PROTEIN's fold, target masks cut to 230,
   210, 190, 170 residues) with random weights from seed 0, through
   ``parallel/dryrun.py``'s rank worker (``parallel.launch``: forkserver
   ranks, each launch bounded by 600 s): (a) dp = 2, two ranks on the card
   over gloo (NCCL when there is a card per rank), 2 rows each; each
   rank's launch counts reset just before its step and read just after
   (8 + 8 band, 1 + 1 clash launches); loss within rtol 1e-5 of the
   single-process step on the same weights and batch, Adam's mu leaf by
   leaf within 1e-3 of the leaf's max |mu| + 1e-5 of the global max, the
   updated parameters within atol 1e-4; then one step in a
   world-size-1 NCCL group (its dp all-reduce over NCCL), held likewise;
   (b) tp = 2 on the plain path (no kernel), against the single-process
   plain step; (c) ``cli.train --dp 2`` for one epoch on TRAIN_PROTEIN's
   H5 files (each rank reads them through ``EnsembleDataset``), whose full
   checkpoint the single-process ``cli.generate`` decodes from the
   validation manifest; (d) CUDA-event times of
   the single-process, dp = 2 and tp = 2 steps (median of 5 after 2
   warm-ups) and of the dp all-reduce alone, printed with the card's name
   and power limit: two ranks sharing one card over gloo, a record of
   cost, not a scaling figure.
10. the flagship pipeline (``phase_flagship``), last:
   ``scripts/flagship_run_torch.py``'s stages data, train and gen at its
   full widths (``ModelConfig()``, bf16, B8, the nerf3 recipe) cut to 2
   epochs and batteries of 4 samples (raw, then polish with 20 torsion
   steps), its stage functions run in this process with each CLI command
   called through its ``main``: the 7 proteins' H5 files written by the
   port's writer and read through ``EnsembleDataset``; counts reset just
   before each stage and read just after, printed by mode: data none,
   train 8 band forwards per step and 8 band backwards per train step in
   the bf16-model mode and kernels 3-4 per step, gen 2 x 8 fp32 band
   forwards per structure and battery and kernels 3-4 in polish; the
   train log finite with no skipped step, both analyses and run.json
   written.
9. one ``parallel`` JSON line (phase 8's checks, times and launches by
   rank), one ``wide_decoder`` JSON line (phase 6b), one ``esm`` JSON line (the ESM-2 gates, timings and the path's
   stage seconds), one ``flagship`` JSON line (phase 10's stages, launches
   by mode, the batteries' aggregates), one ``watch`` JSON line (phase 5b's gaps, checks and
   times), one ``kernels`` JSON line (launches by path: generate,
   dataprep, refine, train, train_bf16, train_watch (phase 5b's counted
   run, dumps included), train_dp (both dp ranks' steps;
   every kernel must launch in each rank), wide_decoder (phase 6b: every
   kernel must launch), flagship (phase 10: every kernel must launch),
   and chain_dtype_ab's bf16-chain launches; the mma.sync kernels'
   counters must stay at 0 on every path; kernels
   1-2 also
   by mode on the two bf16 paths, chain_dtype_ab's fp32-chain launches
   there only; each kernel must have launched on its REQUIRED_PATHS: the
   Hopper kernels 1-2 (``egnn_band_fwd_sm90``, ``egnn_band_bwd_sm90``),
   which serve the bf16 model's one-pass mode up to Hd 256, on train_bf16
   and the flagship's training, with their own rows, the weight-stream
   and scratch floors beside the TF32 bound; the width-512 Hopper kernels
   (``egnn_band_{fwd,bwd}_sm90_hd512``), which serve both fp32-chain
   modes at Hd 257-512, on wide_decoder, their line's row the fp32
   B4/L256 one at Hd 512; the same sources under the 3xTF32 counters
   (``egnn_band_{fwd,bwd}_sm90_x3``), which serve the fp32 model's mode
   up to Hd 256, on generate, dataprep, refine, train, train_watch,
   train_dp, wide_decoder (its width-16 CLI epoch) and the flagship's
   generation, their line's rows the fp32 headline shapes; the Hopper
   kernels above 512 (``egnn_band_{fwd,bwd}_sm90_wide``), which serve both
   fp32-chain modes there, on wide_decoder (its width-1024 CLI epoch),
   their line's row the fp32 B4/L256 one at Hd 1024; the three families
   also on chain_dtype_ab, the bf16 chain's path, whose rows join their
   lines' shapes), then, as the last line, ``{"ok": true, "device":
   {...}}``.

Kernels 1-2 at Hd 256 in the fp32 model's 3xTF32 mode (phase 3's fp32
rows, the flagship's generation rows) and in the one-pass fp32 chain
(phase 3's bf16-model rows, the flagship's training rows) run on Hopper
kernels; their log lines name the kernel and give, beside the TF32 (or
3xTF32, 3 x the FLOP at the TF32 peak) tensor-core bound, the
weight-stream floor (the 64-row steps with a valid edge x the weights
each streams from L2 x the images a step streams: a pair of steps shares
one in one pass, each step streams Ws and Wb in 3xTF32; at this run's L2
read rate for a region every SM reads, measured first, ``_l2_rate``)
and, for kernel 2, the scratch floor (its five per-edge activations
written and read once at the HBM peak).

``--grad-triage FILE.json`` writes the float64 triage's per-tensor
gradient distances (Hd 256 and 512). ``--profile TRACE.json`` adds, after
the checks, torch.profiler passes over
the generation path and over the B4/L256 timed train steps, fp32 and bf16
(device busy share, top operators by device time) and writes their Chrome
traces to ``TRACE.json``, ``TRACE.train_fp32.json`` and
``TRACE.train_bf16.json``, and the refine stages' traces to
``TRACE.refine_cartesian.json`` and ``TRACE.refine_torsion.json``, and
the 1022-residue ESM-2 profile pass's to ``TRACE.esm2.json``. It is not
needed for the smoke run.

Imports nothing of JAX; builds from the repository's sources only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

SEED = 0
DEVICE = "cuda"
HD, W = 256, 40                       # ModelConfig decoder_hidden, max_neighbors
NUM_SAMPLES = 10
PROTEINS = (("synA", 230, 1), ("synB", 600, 2))   # id, length, fold seed
BUCKETS = (64, 128, 192, 256, 320, 384, 448, 512, 576, 640)
# Main-path shapes of kernel 1: generation's (B, L) = (1 | NUM_SAMPLES,
# bucket), then the training shapes (TRAIN_SHAPES below).
KERNEL_SHAPES = ((1, 256), (NUM_SAMPLES, 256), (1, 640), (NUM_SAMPLES, 640),
                 (4, 256), (2, 640))
HEADLINE_SHAPE = (NUM_SAMPLES, 640)   # the shape reported in the kernels line

# Kernel vs plain version, both fp32 with sums in another order. agg and
# raw_delta are sums of 80 signed edge terms each, so an element that
# cancels to ~0 has no meaningful relative error: the absolute tolerance is
# scaled by the output's magnitude, atol = 1e-4 * max|plain|, rtol = 1e-4.
RTOL, ATOL_REL = 1e-4, 1e-4
# Kernel-path vs plain-path decode of one latent: 8 layers of the above,
# then the heads; 1e-3 A is the precision PDB files are written at.
COORD_ATOL = 1e-3

# Kernel 2-4 vs plain version: gradients are sums over up to ~1e5 edges
# (weight grads) or ~1e3 atom pairs in another order, so the absolute
# tolerance scales with each output's magnitude.
G_RTOL, G_ATOL_REL = 2e-3, 1e-4
# The gradients kernel 2 returns, in order.
GRAD_NAMES = ("a", "bs", "x", "w_d", "w_e2", "b_e2", "w_x1", "b_x1", "w_x2", "b_x2")
# Training shapes (B, L) of kernels 2-4, and the timed train steps.
TRAIN_SHAPES = ((4, 256), (2, 640))
TRAIN_HEADLINE = (4, 256)
TRAIN_PROTEIN = ("synT", 230, 3, 5)   # id, length, fold seed, conformers
TIMED_STEPS = (dict(B=4, L=256, L_real=230, remat=False),
               dict(B=2, L=640, L_real=600, remat=True))
STEP_WARMUP, STEP_REPS = 2, 5

# Published dense peaks of one H100 SXM at its full 700 W (NVIDIA data
# sheet): fp32 outside the tensor cores, TF32 and bf16 on the tensor cores,
# and HBM3 bandwidth. A kernel's bound takes the peak of the type its
# products compute in (_ops_ms): fp32 for kernels 1-2's fp32 mode (3xTF32,
# three TF32 passes per fp32 product, whose tensor-core time, 3 x the FLOP
# at the TF32 rate, is logged beside it), TF32 for the bf16-model mode (one
# pass) and bf16 for the bf16 chain (chain_dtype=bfloat16).
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel timing windows: at least MIN_LAUNCHES back-to-back calls and at
# least WINDOW_MS of device time between one pair of CUDA events.
MIN_LAUNCHES, WINDOW_MS = 50, 1.0
# empty kernels that open a profiled window (_device_kernels): CUPTI has
# dropped a window's first 9 records or more (all 8 markers and the first
# clash kernel, in three profiled calls of cli.refine in a row)
PROFILER_MARKERS = 64
# Kernels 3-4 at the training shapes and at refinement's: B = num_samples
# over the padded buckets (600 Adam steps of one forward and one backward),
# and over the 230 residues of the ensemble file that cli.refine reads back
# (unpadded, not a multiple of the 32-residue tile); then the flagship
# path's: polish at phase 10's B4 over bucket 128, training at B8 over the
# buckets 128 and 192.
CLASH_SHAPES = ((4, 256), (2, 640), (NUM_SAMPLES, 256), (NUM_SAMPLES, 640),
                (NUM_SAMPLES, 230), (4, 128), (8, 128), (8, 192))

# The bf16-model mode of kernels 1-2: bf16 a / bs, precision "default"
# (one TF32 pass per product), held against the plain version (fp32 chain,
# full fp32 products) on the same bf16-rounded inputs at the JAX package's
# bf16 tolerances (tests/test_pallas.py:203-218): 3 % of max |value| for
# the forward, 5 % of max |grad| for the backward.
BF16_MODE = "bfloat16/default"
FP32_MODE = "float32/highest"
BF16_VALUE_FRAC, BF16_GRAD_FRAC = 0.03, 0.05
# a bf16 step's gradients, per tensor (_grad_gap): |g - w| / |w| at most
# BF16_GRAD_REL, set from scripts/bf16_grad_spread.py (PERF.md, section 6);
# the attention key biases (zero analytically) at most BF16_ZERO_GRAD_FRAC
# of their query bias's gradient norm; BF16_NOISY, whose gradient bf16
# noise outweighs, within BF16_GRAD_FRAC of the step's max |grad|
BF16_GRAD_REL, BF16_ZERO_GRAD_FRAC = 0.5, 0.05
BF16_NOISY = ("encoder.enc.geom_res_scale",)
# kernel 1's bf16 mode at the generation shapes and at the training shapes,
# where a bf16 model runs it
BF16_FWD_SHAPES = ((1, 256), (NUM_SAMPLES, 256), (NUM_SAMPLES, 640)) + TRAIN_SHAPES
BF16_BWD_SHAPES = TRAIN_SHAPES

# The bf16 chain of kernels 1-2 (chain_dtype=bfloat16: bf16 activations and
# cotangents, bf16 tensor-core products, fp32 sums; a mode no model path of
# either package routes to), both kernels at the JAX package's A/B shape
# (scripts/chain_dtype_onchip.py: B16/L256), HEADLINE_SHAPE and the training
# shapes, with bf16 a / bs, and with fp32 a / bs at CHAIN_FP32_INPUTS, on the
# one-pass Hopper kernels (bf16 wgmma); held
# against the plain version (the JAX kernel's rounding op by op): values
# within CHAIN_VALUE_FRAC of max |plain|, gradients within BF16_GRAD_FRAC,
# and closer to the plain bf16 chain than to the one-pass fp32-chain kernel.
# CHAIN_VALUE_FRAC lies between the kernel's reading (at most 2.0e-4) and
# the two chains' distance (2.5e-3 on agg, 1.2e-2 on raw_delta at B16/L256;
# PERF.md, section 6); the gradients' readings (up to 5.9e-3, mostly da / dbs
# rounded to bf16) overlap the chains' distance per tensor (5.8e-3 on bs),
# so the comparison with the fp32 chain tells the two modes apart there.
# Its path is scripts/chain_dtype_ab.py's run().
CHAIN_SHAPES = ((16, 256), HEADLINE_SHAPE) + TRAIN_SHAPES
CHAIN_FP32_INPUTS = (4, 256)
CHAIN_VALUE_FRAC = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def _window_ms(fn, n: int) -> float:
    """CUDA events around ``n`` back-to-back calls of ``fn``, per call."""
    import torch

    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def _median_ms(fn, reps: int = 5, min_launches: int = MIN_LAUNCHES) -> float:
    """Device ms per call: CUDA events around N back-to-back calls divided
    by N, median of ``reps`` windows after warm-up. N is the larger of
    ``min_launches`` and what fills WINDOW_MS, so that a call shorter than
    the host's time to issue it reads as the rate the card was fed at, not
    as one launch waiting for the host."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    n = max(min_launches, math.ceil(WINDOW_MS / max(_window_ms(fn, 3), 1e-6)))
    return float(np.median([_window_ms(fn, n) for _ in range(reps)]))


def _host_us(fn, n: int = 200) -> float:
    """Host us per call: ``time.perf_counter`` over ``n`` calls with no
    synchronisation inside the window (the card is drained before and
    after)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * secs / n


def _graph_us(fn, n: int = 100) -> float:
    """The device's own us per call: ``n`` calls captured in one CUDA graph
    (after warm-up on a side stream) and replayed, CUDA events around one
    replay over ``n``, median of 5 replays. No host work between launches,
    so a short kernel is not paced by the host that issues it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return float(np.median([1e3 * _window_ms(graph.replay, 1) / n for _ in range(5)]))


def _device_kernels(run) -> list[str]:
    """Names of the device kernels (and copies) that one call of ``run``
    issues, in order, by torch.profiler, after one warm-up call. The
    profiled window opens with PROFILER_MARKERS launches of the empty
    ``clash_noop`` kernel and a synchronise, so that the tracer records
    before ``run`` starts: CUPTI has dropped the first records of a window
    (the clash term's kernel 3 in three profiled calls in a row, my chip
    run 4, PR 6). The names returned are those after the last marker."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from protein_ensemble_vae_torch.ops.kernels.clash import clash_noop

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILER_MARKERS):
            clash_noop()
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    names = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
             if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = [i for i, name in enumerate(names) if "clash_noop" in name]
    return names[marks[-1] + 1:] if marks else names


def _launch_floor() -> dict:
    """The no-op kernel of csrc/clash.cu through the same ctypes path:
    device us per launch back to back (``_median_ms``) and inside a CUDA
    graph (``_graph_us``), and host us per call."""
    from protein_ensemble_vae_torch.ops.kernels.clash import clash_noop

    return dict(floor_us=1e3 * _median_ms(clash_noop), floor_graph_us=_graph_us(clash_noop),
                floor_host_us=_host_us(clash_noop))


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
    from protein_ensemble_vae_torch.ops.kernels import SOURCES, build

    t0 = time.perf_counter()
    # the sources of the kernels on the path (KERNEL_INFO), one nvcc each
    report = build.build(sorted({SOURCES[name] for name in KERNEL_INFO}), verbose=True)
    log(f"[build] {len(report)} source(s) in "
        f"{time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------

def _egnn_inputs(B: int, L: int, seed: int, hd: int = HD):
    """Model-scale inputs at hidden width ``hd``: projections of
    unit-variance features through the split edge layer's init, coordinates
    of a ~15 A protein, the layer's init for the edge weights, and a masked
    tail on row 0."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def u(shape, fan_in):
        return (torch.rand(shape, generator=g) * 2 - 1) / np.sqrt(fan_in)

    fan_e1 = 2 * hd + 1
    a = torch.randn(B, L, hd, generator=g) * np.sqrt(hd / (3 * fan_e1))
    bs = torch.randn(B, L, hd, generator=g) * np.sqrt(hd / (3 * fan_e1))
    x = torch.randn(B, L, 3, generator=g) * 10.0
    cmask = torch.ones(B, L)
    cmask[0, L - L // 8:] = 0.0
    params = (u((1, hd), fan_e1), u((hd, hd), hd), u((hd,), hd),
              u((hd, hd), hd), u((hd,), hd), u((hd, 1), hd), u((1,), hd))
    return [t.cuda().contiguous() for t in (a, bs, x, cmask) + params]


def _tc_ms(flops: float, passes: int = 3, peak: float = PEAK_TF32_FLOPS) -> float:
    """Tensor-core bound in ms: ``passes`` x ``flops`` (TF32 passes per
    product) over ``peak``, the TF32 peak (or PEAK_BF16_FLOPS for the bf16
    chain's one pass)."""
    return 1e3 * passes * flops / peak


def _ops_ms(flops: float, passes: int, peak: float) -> float:
    """The FLOP over the peak of the type the products compute in: fp32 in
    the 3xTF32 mode (``passes`` 3 stand in for an fp32 product, whose rate
    is PEAK_FP32_FLOPS), else ``peak`` (TF32 for one pass, bf16 for the
    bf16 chain)."""
    return 1e3 * flops / (PEAK_FP32_FLOPS if passes == 3 else peak)


def _egnn_bound(B: int, L: int, cmask, in_bytes: int = 4, passes: int = 3,
                peak: float = PEAK_TF32_FLOPS,
                hd: int = HD) -> tuple[float, str, int, float, float]:
    """Least time for one launch on this run's inputs at hidden width
    ``hd`` (the real width: a padded launch's extra columns are not work
    the function needs): exact valid edges x (4 hd^2 + 2 hd) FLOP over the
    peak of the products' type (``_ops_ms``), against each input read and
    each output written once over the HBM rate (a and bs at ``in_bytes``
    each). Also the valid edges, the tensor-core time (the same FLOP in
    ``passes`` passes at ``peak``, ``_tc_ms``) and the fp32-core time (the
    FLOP at PEAK_FP32_FLOPS)."""
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import band_indices

    idx, in_range = band_indices(L, W, cmask.device)
    cm = cmask > 0.5
    edges = int((in_range[None] & cm[:, :, None] & cm[:, idx]).sum())
    flops = edges * (4 * hd * hd + 2 * hd)
    nbytes = (in_bytes * 2 * B * L * hd                           # a, bs
              + 4 * (B * L * 3 + B * L                            # x, cmask
                     + 2 * hd * hd + 4 * hd + 1                   # weights
                     + B * L * hd + B * L * 3))                   # agg, raw_delta
    t_ops, t_bytes = _ops_ms(flops, passes, peak), 1e3 * nbytes / PEAK_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    return (max(t_ops, t_bytes), by, edges, _tc_ms(flops, passes, peak),
            1e3 * flops / PEAK_FP32_FLOPS)


# Every thread sums 16-byte loads that skip L1 (ld.global.cg): reps sweeps
# over n4 float4 values; shared = 1: every block sweeps all n4 values (one
# region that every SM reads, as the Hopper band kernels' weight ring
# does), shared = 0: the grid's threads stripe them.
L2_SRC = r"""
#include <cstddef>
__global__ void __launch_bounds__(512) l2_read(const float4* __restrict__ p, size_t n4,
                                               int reps, int shared, float* out) {
    float acc = 0.f;
    const size_t start = shared ? threadIdx.x : (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const size_t step = shared ? blockDim.x : (size_t)gridDim.x * blockDim.x;
    for (int r = 0; r < reps; ++r)
#pragma unroll 8
        for (size_t i = start; i < n4; i += step) {
            const float4 v = __ldcg(p + i);
            acc += v.x + v.y + v.z + v.w;
        }
    if (acc == 1234.5f) out[blockIdx.x] = acc;   // keeps the loads
}
extern "C" int l2_read_launch(const void* p, size_t n4, int reps, int shared, float* out,
                              int blocks, void* stream) {
    l2_read<<<blocks, 512, 0, (cudaStream_t)stream>>>((const float4*)p, n4, reps, shared, out);
    return (int)cudaGetLastError();
}
"""
READ_RATE = None   # _l2_rate() of this run, set by main


def _l2_rate() -> dict:
    """GB/s that L2_SRC reads: from L2 (16 MiB striped over the grid; 512
    KiB read whole by every block) and from HBM (2 GiB striped), 4 blocks of
    512 threads per SM (CUDA events, ``_median_ms``). Built into the
    package's build directory."""
    import ctypes

    import torch

    from protein_ensemble_vae_torch.ops.kernels import build

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    src = os.path.join(build.BUILD_DIR, "l2_read.cu")
    lib_path = os.path.join(build.BUILD_DIR, "libl2_read.so")
    with open(src, "w") as f:
        f.write(L2_SRC)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib_path, src], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(lib_path).l2_read_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(blocks, device=DEVICE)
    res = {}
    for label, nbytes, reps, shared in (("l2_striped_16MiB", 16 << 20, 64, 0),
                                        ("l2_shared_512KiB", 512 << 10, 4, 1),
                                        ("hbm_striped_2GiB", 2 << 30, 1, 0)):
        buf = torch.ones(nbytes // 4, device=DEVICE)
        run = lambda: fn(buf.data_ptr(), nbytes // 16, reps, shared, out.data_ptr(),  # noqa: E731
                         blocks, torch.cuda.current_stream().cuda_stream)
        ms = _median_ms(run)
        moved = nbytes * reps * (blocks if shared else 1)
        res[label] = dict(gb_per_s=moved / ms / 1e6, ms=ms, bytes=moved)
        del buf
    return res


def _sm90_floors(kernel: str, B: int, L: int, cmask, hd: int = HD,
                 precision: str = "default", chain_bf16: bool = False) -> dict:
    """The Hopper band kernels' floors on this run's inputs beside the TF32
    bound: the weight stream (the steps with a valid edge, each streaming
    two weights (kernel 1) or four (kernel 2) of n^2 fp32 from L2 once per
    image, at this run's L2 rate for a region every SM reads, n the native
    width the kernel runs: in the one-pass mode up to Hd 256 two steps (a
    pair) share an image and a weight streams once; on the shared-tile
    kernels every step streams its images: at Hd 512 (``kernel`` ending in
    ``_hd512``, or ``hd`` 512) one in one pass and three in 3xTF32,
    ``precision`` "highest" (Ws, Wb, Wb), up to 256 in 3xTF32 (``kernel``
    ending in ``_x3``) two (Ws, Wb)) and, for kernel 2, the scratch round
    trip (m1, m, cot_u, cot_v, cot_pre: 64 x n fp32 each per step with a
    valid edge, written once and read once, at the HBM peak). Above 512
    (``kernel`` ending in ``_sm90_wide``) every step streams each weight
    once per image (one in one pass, Wb and Ws in 3xTF32), and each of its
    products (two, or four in kernel 2) re-reads its A operand, 64 x n
    fp32, once per column pass of 2 x WIDE_NW columns: the A-stream floor,
    at the same L2 rate. In the bf16 chain (``chain_bf16``) each image,
    A chunk and scratch row holds bf16, two bytes a value (the images'
    K padded to 64 at Hd 32), streamed as in the one-pass mode."""
    import torch

    from protein_ensemble_vae_torch.ops.kernels.egnn_band import (OPS, PASSES, TILE, WIDE_NW,
                                                                  band_indices,
                                                                  bf16_image_words,
                                                                  native_width)

    idx, in_range = band_indices(L, W, cmask.device)
    cm = cmask > 0.5
    valid = (in_range[None] & cm[:, :, None] & cm[:, idx])              # [B, L, 2W + 1]
    valid = torch.cat([valid[..., :W], valid[..., W + 1:]], dim=-1)      # the 2W offsets
    n_tiles, n_steps = -(-L // TILE), -(-2 * W // OPS)
    n_pairs = -(-n_steps // 2)
    v = torch.zeros(B, n_tiles * TILE, 2 * n_pairs * OPS, dtype=torch.bool, device=cmask.device)
    v[:, :L, :2 * W] = valid
    steps = v.view(B, n_tiles, TILE, 2 * n_pairs, OPS).any(dim=4).any(dim=2)   # [B, tiles, steps]
    pairs = int(steps.view(B, n_tiles, -1, 2).any(dim=-1).sum())
    items = int(steps[..., :n_steps].sum())
    weights = 2 if kernel.startswith("egnn_band_fwd") else 4
    n = native_width(hd)   # the width the kernel streams (a padded width runs at its native one)
    l2 = READ_RATE["l2_shared_512KiB"]["gb_per_s"] * 1e9
    out = {}
    vb = 2 if chain_bf16 else 4                                    # bytes a value
    image = 4 * bf16_image_words(n) if chain_bf16 else 4 * n * n   # bytes of an image
    if kernel.endswith("_sm90_wide"):
        p = 1 if chain_bf16 else PASSES[precision]
        passes = items * (2 if p == 3 else 1)
        products = 2 if kernel.startswith("egnn_band_fwd") else 4
        col_passes = n // (2 * WIDE_NW[p])
        out["a_stream_floor_ms"] = 1e3 * items * products * col_passes * 64 * n * vb / l2
    elif kernel.endswith("_hd512") or n == 512:
        passes = items * (3 if precision == "highest" and not chain_bf16 else 1)
    elif kernel.endswith("_x3"):
        passes = items * 2
    else:
        passes = pairs
    out.update(weight_floor_ms=1e3 * passes * weights * image / l2, weight_passes=passes)
    if kernel.startswith("egnn_band_bwd"):
        out["scratch_floor_ms"] = 1e3 * 2 * 5 * items * 64 * n * vb / PEAK_BYTES_PER_S
    return out


def phase_kernels() -> dict[str, list[dict]]:
    """Kernel 1 in the fp32 model's mode (3xTF32, fp32 a / bs) at
    KERNEL_SHAPES against its plain version, under the kernel that serves
    the mode at HD (``band_kernel``: the shared-tile Hopper kernel's ``_x3``
    counter), with its 3xTF32 tensor-core bound and weight-stream floor."""
    import torch

    from protein_ensemble_vae_torch.ops.kernels.egnn_band import (
        band_kernel, band_work, egnn_band_fwd, egnn_band_reference, sm90_fwd_plan)
    from protein_ensemble_vae_torch.ops.routing import set_full_fp32

    set_full_fp32()
    fwd = band_kernel("egnn_band_fwd", HD, "highest")
    rows = []
    for k, (B, L) in enumerate(KERNEL_SHAPES):
        args = _egnn_inputs(B, L, SEED + k)
        agg, delta = egnn_band_fwd(*args, W)
        again = egnn_band_fwd(*args, W)
        torch.cuda.synchronize()
        if not (torch.equal(agg, again[0]) and torch.equal(delta, again[1])):
            raise RuntimeError(f"egnn_band_fwd B{B}/L{L}: two launches differ")
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
        host_us = _host_us(lambda: egnn_band_fwd(*args, W), n=MIN_LAUNCHES)
        plain_ms = _median_ms(lambda: egnn_band_reference(*args, W), reps=3)
        bound_ms, bound_by, edges, tc_ms, _ = _egnn_bound(B, L, args[3])
        S, _, G = sm90_fwd_plan(B, L, W, HD, args[0].device, torch.float32, "highest")
        units = B * band_work(B, L, W)[0] * S
        floors = _sm90_floors(fwd, B, L, args[3], HD, "highest")
        log(f"[kernels] egnn_band_fwd B{B}/L{L} ({fwd}): {ms:.3f} ms (plain "
            f"{plain_ms:.3f} ms), host {host_us:.1f} us per call, bound "
            f"{bound_ms:.3f} ms by {bound_by} ({edges} valid edges), "
            f"{100 * bound_ms / ms:.1f}% of bound; 3xTF32 tensor-core bound {tc_ms:.3f} ms"
            f"{_floor_text(floors)}; {S} slice(s), {units} units on {G} blocks; bitwise "
            f"identical over two launches")
        rows.append(dict(mode=FP32_MODE, B=B, L=L, ms=ms, host_us=host_us,
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         tc_bound_ms=tc_ms, slices=S, units=units, blocks=G,
                         max_abs_err=max(errs), **floors))
        del args, agg, delta, again, ragg, rdelta
    return {fwd: rows}


def _close_scaled(name: str, got, ref) -> float:
    """Raise unless ``got`` matches ``ref`` at rtol G_RTOL, atol
    G_ATOL_REL * max|ref|; return the max abs error."""
    import torch

    if not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: not finite")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not torch.allclose(got, ref, rtol=G_RTOL, atol=G_ATOL_REL * scale):
        raise RuntimeError(f"{name} disagrees with its plain version: max abs "
                           f"err {err:.3e}, max|plain| {scale:.3e}")
    return err


def _band_bwd_bound(B: int, L: int, cmask, in_bytes: int = 4, passes: int = 3,
                    peak: float = PEAK_TF32_FLOPS,
                    hd: int = HD) -> tuple[float, str, float, float]:
    """Least time for one backward launch at hidden width ``hd`` (the real
    width, as ``_egnn_bound``): per valid edge 6 hd x hd products (12 hd^2
    FLOP) plus the elementwise chain, over the peak of the products' type
    (``_ops_ms``), against the inputs (a, bs, x, cmask, weights, g_agg,
    g_delta) read once and the gradients written once over the HBM rate (a,
    bs and their gradients at ``in_bytes`` each). Also the tensor-core time
    (the same FLOP in ``passes`` passes at ``peak``, ``_tc_ms``) and the
    fp32-core time (the FLOP at PEAK_FP32_FLOPS)."""
    edges = _egnn_bound(B, L, cmask)[2]
    flops = edges * (12 * hd * hd + 20 * hd)
    nbytes = (in_bytes * 4 * B * L * hd                                        # a, bs, da, dbs
              + 4 * (B * L * hd + 2 * B * L * 3 + B * L + 2 * hd * hd + 4 * hd + 1  # g_agg, x, ...
                     + B * L * 3 + 2 * hd * hd + 4 * hd + 1))                  # dx, weight grads
    t_ops, t_bytes = _ops_ms(flops, passes, peak), 1e3 * nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            _tc_ms(flops, passes, peak), 1e3 * flops / PEAK_FP32_FLOPS)


def _clash_near_pairs(atoms, amask, clash_dist: float = 3.2) -> int:
    """Valid unordered atom pairs >= 2 residues apart that lie closer than
    ``clash_dist`` (d^2 < clash_dist^2, the plain version's difference):
    the pairs whose penalty or gradient the function must compute."""
    import torch

    A = atoms.shape[1]
    res = torch.arange(A, device=atoms.device) // 3
    later = (res[None, :] - res[:, None]) >= 2          # j at least 2 residues after i
    near = 0
    for a, m in zip(atoms, amask):
        diff = a[:, None, :] - a[None, :, :]
        close = (diff * diff).sum(-1) < clash_dist * clash_dist
        near += int((close & later & (m[:, None] * m[None, :] > 0)).sum())
    return near


# FLOP of the clash function: the d^2 test of every valid pair (3
# subtractions, 1 multiply, 2 multiply-adds), then, only for the pairs
# within clash_dist, the penalty (forward: the square root, viol, its
# square and the masked sum) or both atoms' gradient terms (backward: the
# square root, the derivative over d, 3 products and 6 sums).
CLASH_TEST_FLOP, CLASH_PEN_FLOP, CLASH_GRAD_FLOP = 8, 12, 22


def _clash_bound(pairs: float, near: int, near_flop: int, in_floats: int,
                 out_floats: int) -> tuple[float, str]:
    """Least time for one clash launch on this run's inputs: each valid
    unordered atom pair ``pairs`` (the forward's counts summed) tested once
    (CLASH_TEST_FLOP), and the ``near`` pairs within clash_dist
    (``_clash_near_pairs``) given ``near_flop`` more (CLASH_PEN_FLOP
    forward, CLASH_GRAD_FLOP backward), over the fp32 peak, against the
    inputs read once and the outputs written once over the HBM rate."""
    t_ops = (pairs * CLASH_TEST_FLOP + near * near_flop) / PEAK_FP32_FLOPS
    t_bytes = 4 * (in_floats + out_floats) / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


_FOLDS: dict = {}


def _clash_inputs(B: int, L: int):
    """n, ca, c [B, L, 3] and mask [B, L] on the card: the first B of
    NUM_SAMPLES NeRF conformers of one fold per length, squeezed by 10 % so
    that some pairs clash, with a masked tail on row 0 and a hole on the
    last row."""
    import torch

    from protein_ensemble_vae_torch.data.synthetic import nerf_ensemble

    if L not in _FOLDS:
        _FOLDS[L] = [torch.from_numpy(0.9 * v) for v in
                     nerf_ensemble(L, NUM_SAMPLES, seed=SEED + 20, max_tries=16)]
    n, ca, c = (v[:B].float().cuda().contiguous() for v in _FOLDS[L])
    mask = torch.ones(B, L)
    mask[0, L - L // 8:] = 0.0
    mask[-1, L // 2] = 0.0
    return n, ca, c, mask.cuda()


def phase_clash_kernels(floor: dict) -> dict[str, list[dict]]:
    """Kernels 3-4 against their plain versions at CLASH_SHAPES: the loss,
    the totals and the counts (exactly ``pair_count``), the gradients, two
    launches bitwise identical; device and host times beside the launch
    floor."""
    import torch

    from protein_ensemble_vae_torch.ops.kernels.clash import (
        backbone_atoms, clash_bwd, clash_bwd_reference, clash_fwd,
        clash_fwd_reference, fwd_grid, bwd_grid, pair_count)

    rows = {"clash_fwd": [], "clash_bwd": []}
    for B, L in CLASH_SHAPES:
        n, ca, c, mask = _clash_inputs(B, L)
        bb = (n, ca, c, mask)
        loss, tot, counts = clash_fwd(*bb)
        again = clash_fwd(*bb)
        atoms, amask = backbone_atoms(*bb)
        ref_tot = clash_fwd_reference(atoms, amask)
        if float(ref_tot.min()) <= 0:
            raise RuntimeError("clash inputs have no clashing pair")
        if not torch.equal(counts, pair_count(mask)):
            raise RuntimeError(f"clash_fwd B{B}/L{L}: counts differ from pair_count")
        ref_loss = torch.mean(ref_tot / (counts + 1e-8))
        e_fwd = max(_close_scaled(f"clash_fwd B{B}/L{L} totals", tot, ref_tot),
                    _close_scaled(f"clash_fwd B{B}/L{L} loss", loss, ref_loss))
        g = torch.tensor(0.75, device="cuda")
        grads = clash_bwd(*bb, g, counts)
        grads2 = clash_bwd(*bb, g, counts)
        torch.cuda.synchronize()
        if not (all(torch.equal(a, b) for a, b in zip((loss, tot, counts), again))
                and all(torch.equal(a, b) for a, b in zip(grads, grads2))):
            raise RuntimeError(f"clash kernels B{B}/L{L}: two launches differ")
        scale = g / (B * (counts + 1e-8))
        ref_grad = clash_bwd_reference(atoms, amask, scale).reshape(B, L, 3, 3).unbind(2)
        e_bwd = max(_close_scaled(f"clash_bwd B{B}/L{L} {k}", a, b)
                    for k, a, b in zip(("dn", "dca", "dc"), grads, ref_grad))
        in_floats, pairs, near = 10 * B * L, float(counts.sum()), _clash_near_pairs(atoms, amask)
        for name, err, fn, plain, bound, blocks in (
                ("clash_fwd", e_fwd, lambda: clash_fwd(*bb),
                 lambda: clash_fwd_reference(*backbone_atoms(*bb)),
                 _clash_bound(pairs, near, CLASH_PEN_FLOP, in_floats, 1 + 2 * B),
                 math.prod(fwd_grid(B, L))),
                ("clash_bwd", e_bwd, lambda: clash_bwd(*bb, g, counts),
                 lambda: clash_bwd_reference(*backbone_atoms(*bb), scale),
                 _clash_bound(pairs, near, CLASH_GRAD_FLOP, in_floats + 1 + B, 9 * B * L),
                 math.prod(bwd_grid(B, L)))):
            # ms: back to back, as every kernel's row; the wrapper's host work
            # paces it, so graph_ms gives the device's own time beside it
            ms, graph_ms, host_us = _median_ms(fn), 1e-3 * _graph_us(fn), _host_us(fn)
            plain_ms = _median_ms(plain, reps=3)
            log(f"[kernels] {name} B{B}/L{L}: {1e3 * ms:.2f} us back to back (floor "
                f"{floor['floor_us']:.2f}), {1e3 * graph_ms:.2f} us per launch in a CUDA "
                f"graph (floor {floor['floor_graph_us']:.2f}), host {host_us:.1f} us per call "
                f"(floor {floor['floor_host_us']:.1f}); plain {plain_ms:.3f} ms; bound "
                f"{1e3 * bound[0]:.3f} us by {bound[1]} ({pairs:.0f} pairs tested, {near} "
                f"within clash_dist; {100 * bound[0] / ms:.1f}% of bound back to back, "
                f"{100 * bound[0] / graph_ms:.1f}% in the graph); {blocks} blocks; max abs "
                f"err {err:.3e}; bitwise identical over two launches")
            rows[name].append(dict(B=B, L=L, ms=ms, graph_ms=graph_ms, host_us=host_us,
                                   plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                                   pairs=pairs, near_pairs=near, blocks=blocks,
                                   max_abs_err=err, **floor))
        del n, ca, c, mask, bb, atoms, amask, ref_tot, grads, grads2, ref_grad
    return rows


def clash_term_kernels(attempts: int = 3) -> int:
    """torch.profiler over one ``clash_loss_kernel`` forward and backward
    (upstream gradient given, as the train step's backward hands it over):
    the device kernels the clash term issues must be exactly one kernel 3
    and one kernel 4, with no copy or elementwise op around them. Any other
    kernel, or a second clash kernel, fails at once; a profiled call whose
    records lack one of the two is logged and profiled again, up to
    ``attempts`` calls in all."""
    import torch

    from protein_ensemble_vae_torch.ops.kernels import LAUNCHES
    from protein_ensemble_vae_torch.ops.kernels.clash import clash_loss_kernel

    n, ca, c, mask = _clash_inputs(*TRAIN_HEADLINE)
    xs = [t.requires_grad_(True) for t in (n, ca, c)]
    g = torch.ones((), device="cuda")
    kinds = ("clash_fwd", "clash_bwd")
    for attempt in range(1, attempts + 1):
        before = {k: LAUNCHES[k] for k in kinds}
        names = _device_kernels(lambda: torch.autograd.grad(clash_loss_kernel(*xs, mask), xs, g))
        launched = {k: LAUNCHES[k] - v for k, v in before.items()}
        seen = {k: sum(f"{k}_kernel" in name for name in names) for k in kinds}
        others = [name for name in names if not any(f"{k}_kernel" in name for k in kinds)]
        log(f"[kernels] clash term, one forward + backward at B{TRAIN_HEADLINE[0]}/"
            f"L{TRAIN_HEADLINE[1]} (profiled call {attempt}): the profiler recorded "
            f"{seen['clash_fwd']} + {seen['clash_bwd']} clash kernels and {len(others)} other "
            f"device kernel(s) {others}: {names}")
        if (others or max(seen.values()) > 1
                or launched != {"clash_fwd": 2, "clash_bwd": 2}):   # warm-up + profiled call
            raise RuntimeError(f"the clash term issued {seen} clash kernels, {others} and "
                               f"{launched} wrapper launches over two calls; expected one "
                               f"each of kernels 3 and 4 and nothing else per call")
        if seen == {"clash_fwd": 1, "clash_bwd": 1}:
            return 2
    raise RuntimeError(f"the profiler did not record both clash kernels in {attempts} "
                       f"profiled calls")


def phase_train_kernels() -> dict[str, list[dict]]:
    """Kernel 2 in the fp32 model's mode against its plain version at the
    training shapes, under the kernel that serves it (``band_kernel``), with
    its 3xTF32 tensor-core bound, weight-stream and scratch floors."""
    import torch

    from protein_ensemble_vae_torch.ops.kernels.egnn_band import (
        band_kernel, band_work, egnn_band_bwd, egnn_band_bwd_reference, sm90_bwd_plan)

    bwd = band_kernel("egnn_band_bwd", HD, "highest")
    rows = {bwd: []}
    names = GRAD_NAMES
    for k, (B, L) in enumerate(TRAIN_SHAPES):
        args = _egnn_inputs(B, L, SEED + 10 + k)
        g = torch.Generator(device="cuda").manual_seed(SEED + k)
        g_agg = torch.randn(B, L, HD, generator=g, device="cuda")
        g_delta = torch.randn(B, L, 3, generator=g, device="cuda")
        got = egnn_band_bwd(*args, g_agg, g_delta, W)
        again = egnn_band_bwd(*args, g_agg, g_delta, W)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"egnn_band_bwd B{B}/L{L}: two launches differ")
        ref = egnn_band_bwd_reference(*args, g_agg, g_delta, W)
        errs = {n: _close_scaled(f"egnn_band_bwd B{B}/L{L} {n}", a, b)
                for n, a, b in zip(names, got, ref)}
        rel = {n: errs[n] / max(float(r.abs().max()), 1e-30) for n, r in zip(names, ref)}
        worst = max(rel, key=rel.get)
        ms = _median_ms(lambda: egnn_band_bwd(*args, g_agg, g_delta, W))
        host_us = _host_us(lambda: egnn_band_bwd(*args, g_agg, g_delta, W), n=MIN_LAUNCHES)
        plain_ms = _median_ms(lambda: egnn_band_bwd_reference(*args, g_agg, g_delta, W),
                              reps=3)
        bound_ms, bound_by, tc_ms, _ = _band_bwd_bound(B, L, args[3])
        G, nsplit = sm90_bwd_plan(B, L, W, HD, args[0].device, torch.float32, "highest")
        floors = _sm90_floors(bwd, B, L, args[3], HD, "highest")
        log(f"[kernels] egnn_band_bwd B{B}/L{L} ({bwd}): {ms:.3f} ms (plain "
            f"{plain_ms:.3f} ms), host {host_us:.1f} us per call, "
            f"bound {bound_ms:.3f} ms by {bound_by}, {100 * bound_ms / ms:.1f}% of "
            f"bound; 3xTF32 tensor-core bound {tc_ms:.3f} ms{_floor_text(floors)}; {G} "
            f"edge-pass blocks over {band_work(B, L, W)[2]} work items, {nsplit} weight-grad "
            f"slices; max abs err {max(errs.values()):.3e}, largest err / max|plain| "
            f"{rel[worst]:.2e} ({worst}); bitwise identical over two launches")
        rows[bwd].append(dict(mode=FP32_MODE, B=B, L=L, ms=ms, host_us=host_us,
                              plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                              tc_bound_ms=tc_ms, edge_blocks=G, wgrad_slices=nsplit,
                              max_abs_err=max(errs.values()), errors=errs, **floors))
        del args, got, again, ref
    return rows


def _bf16_err(name: str, got, ref, frac: float) -> float:
    """Raise unless ``got`` is finite and within ``frac`` x max|ref| of
    ``ref``; log the error beside the tolerance; return err / max|ref|."""
    import torch

    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    ok = bool(torch.isfinite(got.float()).all()) and err <= frac * scale
    log(f"[kernels] {name}: max abs err {err:.3e} = {err / max(scale, 1e-30):.2e} of "
        f"max|plain| {scale:.3e} (tolerance {frac:.0%} of it) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name} disagrees with its plain version")
    return err / max(scale, 1e-30)


def _served(want: dict, mode: str = FP32_MODE, hd: int = HD) -> tuple[dict, dict]:
    """Expected launches of a path whose band calls run in ``mode`` at width
    ``hd``: ``want`` gives kernels 1-2 under "egnn_band_fwd" /
    "egnn_band_bwd", counted here under the kernel that serves the mode
    (``egnn_band.band_kernel``: the Hopper kernels take the one-pass fp32
    chain up to Hd 256), every other counter 0. Returns (launches by
    kernel, band launches by mode)."""
    from protein_ensemble_vae_torch.ops.kernels import LAUNCHES
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import band_kernel

    precision = "highest" if mode == FP32_MODE else "default"
    launches, modes = {k: 0 for k in LAUNCHES}, {}
    for k, v in want.items():
        name = band_kernel(k, hd, precision) if k.startswith("egnn_band") else k
        launches[name] += v
        if k.startswith("egnn_band") and v:
            modes[f"{name}:{mode}"] = v
    return launches, modes


def _floor_text(floors: dict) -> str:
    """The Hopper kernels' floors (``_sm90_floors``) for a log line."""
    text = ""
    if "weight_floor_ms" in floors:
        text += (f"; weight-stream floor {floors['weight_floor_ms']:.4f} ms "
                 f"({floors['weight_passes']} weight passes from L2)")
    if "a_stream_floor_ms" in floors:
        text += f"; A-stream floor {floors['a_stream_floor_ms']:.4f} ms (from L2)"
    if "scratch_floor_ms" in floors:
        text += f"; scratch floor {floors['scratch_floor_ms']:.4f} ms (HBM round trip)"
    return text


def phase_bf16_kernels() -> dict[str, list[dict]]:
    """The bf16-model mode of kernels 1-2 (BF16_MODE) against the plain
    version on the same bf16-rounded inputs: kernel 1 at BF16_FWD_SHAPES,
    kernel 2 at BF16_BWD_SHAPES; two launches bitwise identical; device ms
    beside the same shape's 3xTF32 ms (fp32 inputs, ``precision="highest"``)
    timed in this call, plain ms, host us, the bound (one-pass TF32
    products: the FLOP at the TF32 peak, or the bytes) and the fp32-core
    time (the FLOP at the fp32 peak)."""
    import torch

    from protein_ensemble_vae_torch.ops.kernels.egnn_band import (
        band_kernel, egnn_band_bwd, egnn_band_bwd_reference, egnn_band_fwd, egnn_band_reference)

    def bf16(args):
        return [args[0].bfloat16().contiguous(), args[1].bfloat16().contiguous()] + args[2:]

    fwd, bwd = (band_kernel(k, HD, "default") for k in ("egnn_band_fwd", "egnn_band_bwd"))
    rows = {fwd: [], bwd: []}
    for k, (B, L) in enumerate(BF16_FWD_SHAPES):
        args = _egnn_inputs(B, L, SEED + 40 + k)
        args16 = bf16(args)
        tag = f"egnn_band_fwd {BF16_MODE} B{B}/L{L}"
        out, again = egnn_band_fwd(*args16, W, "default"), egnn_band_fwd(*args16, W, "default")
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise RuntimeError(f"{tag}: two launches differ")
        ref = egnn_band_reference(*args16, W)
        rel = max(_bf16_err(f"{tag} {n}", o, r, BF16_VALUE_FRAC)
                  for n, o, r in zip(("agg", "raw_delta"), out, ref))
        err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        ms = _median_ms(lambda: egnn_band_fwd(*args16, W, "default"))
        fp32_ms = _median_ms(lambda: egnn_band_fwd(*args, W))
        host_us = _host_us(lambda: egnn_band_fwd(*args16, W, "default"), n=MIN_LAUNCHES)
        plain_ms = _median_ms(lambda: egnn_band_reference(*args16, W), reps=3)
        bound_ms, bound_by, _, tc_ms, core_ms = _egnn_bound(B, L, args[3], in_bytes=2,
                                                            passes=1)
        floors = _sm90_floors("egnn_band_fwd", B, L, args[3]) if fwd.endswith("_sm90") else {}
        log(f"[kernels] {tag} ({fwd}): {ms:.3f} ms (3xTF32 with fp32 inputs {fp32_ms:.3f} ms "
            f"in this call, plain {plain_ms:.3f} ms), host {host_us:.1f} us per call; bound "
            f"{bound_ms:.4f} ms by {bound_by} (one-pass TF32 products, "
            f"{100 * bound_ms / ms:.1f}% of it){_floor_text(floors)}, fp32-core time "
            f"{core_ms:.3f} ms; bitwise identical over two launches")
        rows[fwd].append(dict(
            mode=BF16_MODE, B=B, L=L, ms=ms, fp32_ms=fp32_ms, host_us=host_us,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, tc_bound_ms=tc_ms,
            fp32_core_ms=core_ms, max_abs_err=err, max_rel_err=rel, **floors))
        del args, args16, out, again, ref
    names = GRAD_NAMES
    for k, (B, L) in enumerate(BF16_BWD_SHAPES):
        args = _egnn_inputs(B, L, SEED + 50 + k)
        args16 = bf16(args)
        g = torch.Generator(device="cuda").manual_seed(SEED + 50 + k)
        g_agg = torch.randn(B, L, HD, generator=g, device="cuda")
        g_delta = torch.randn(B, L, 3, generator=g, device="cuda")
        tag = f"egnn_band_bwd {BF16_MODE} B{B}/L{L}"
        got = egnn_band_bwd(*args16, g_agg, g_delta, W, "default")
        again = egnn_band_bwd(*args16, g_agg, g_delta, W, "default")
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{tag}: two launches differ")
        if got[0].dtype != torch.bfloat16 or got[1].dtype != torch.bfloat16:
            raise RuntimeError(f"{tag}: da / dbs are {got[0].dtype}, expected bf16")
        ref = egnn_band_bwd_reference(*args16, g_agg, g_delta, W)
        rel = max(_bf16_err(f"{tag} {n}", a, b, BF16_GRAD_FRAC)
                  for n, a, b in zip(names, got, ref))
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
        ms = _median_ms(lambda: egnn_band_bwd(*args16, g_agg, g_delta, W, "default"))
        fp32_ms = _median_ms(lambda: egnn_band_bwd(*args, g_agg, g_delta, W))
        host_us = _host_us(lambda: egnn_band_bwd(*args16, g_agg, g_delta, W, "default"),
                           n=MIN_LAUNCHES)
        plain_ms = _median_ms(lambda: egnn_band_bwd_reference(*args16, g_agg, g_delta, W),
                              reps=3)
        bound_ms, bound_by, tc_ms, core_ms = _band_bwd_bound(B, L, args[3], in_bytes=2,
                                                             passes=1)
        floors = _sm90_floors("egnn_band_bwd", B, L, args[3]) if bwd.endswith("_sm90") else {}
        log(f"[kernels] {tag} ({bwd}): {ms:.3f} ms (3xTF32 with fp32 inputs {fp32_ms:.3f} ms "
            f"in this call, plain {plain_ms:.3f} ms), host {host_us:.1f} us per call; bound "
            f"{bound_ms:.4f} ms by {bound_by} (one-pass TF32 products, "
            f"{100 * bound_ms / ms:.1f}% of it){_floor_text(floors)}, fp32-core time "
            f"{core_ms:.3f} ms; bitwise identical over two launches")
        rows[bwd].append(dict(
            mode=BF16_MODE, B=B, L=L, ms=ms, fp32_ms=fp32_ms, host_us=host_us,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, tc_bound_ms=tc_ms,
            fp32_core_ms=core_ms, max_abs_err=err, max_rel_err=rel, **floors))
        del args, args16, got, again, ref
    return rows


def _chain_err(tag: str, names, got, plain, fp32_chain, frac: float) -> tuple[float, float]:
    """The bf16-chain kernel's outputs against the plain bf16 chain (each
    within ``frac`` x max|plain|, ``_bf16_err``) and against the one-pass
    fp32-chain kernel on the same inputs: the largest error / max|ref| over
    the outputs must be smaller to the plain bf16 chain than to the fp32
    chain (a kernel that ran the fp32 chain would read 0 against it).
    Returns both largest errors."""
    to_plain = max(_bf16_err(f"{tag} {n}", a, b, frac) for n, a, b in zip(names, got, plain))
    to_fp32 = max(float((a.float() - b.float()).abs().max())
                  / max(float(b.float().abs().max()), 1e-30) for a, b in zip(got, fp32_chain))
    ok = to_plain < to_fp32
    log(f"[kernels] {tag}: largest err / max|ref| {to_plain:.2e} to the plain bf16 chain, "
        f"{to_fp32:.2e} to the one-pass fp32-chain kernel {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{tag} lies no closer to the bf16 chain than to the fp32 chain")
    return to_plain, to_fp32


def phase_chain_kernels() -> dict[str, list[dict]]:
    """The bf16 chain of kernels 1-2 against its plain version at
    CHAIN_SHAPES (bf16 a / bs; also fp32 a / bs at CHAIN_FP32_INPUTS):
    values within CHAIN_VALUE_FRAC, gradients within BF16_GRAD_FRAC of
    max |plain|, and closer to the plain bf16 chain than to the one-pass
    fp32-chain kernel (``_chain_err``); da / dbs in the input dtype, two
    launches bitwise identical; device ms beside the same inputs' one-pass
    fp32-chain ms and the fp32 inputs' 3xTF32 ms in this call, plain ms,
    host us, the bound (bf16 tensor-core products: the FLOP at
    PEAK_BF16_FLOPS, or the bytes), the fp32-core time and the Hopper
    floors of the bf16 chain (``_sm90_floors``). Rows of mode
    ``<dtype>/bfloat16_chain``, under the kernel that serves the chain at
    HD (``band_kernel``: the one-pass Hopper kernels)."""
    import torch

    from protein_ensemble_vae_torch.ops.kernels.egnn_band import (
        band_kernel, egnn_band_bwd, egnn_band_bwd_reference, egnn_band_fwd,
        egnn_band_reference, mode_key)

    chain = torch.bfloat16
    names = GRAD_NAMES
    served = {k: band_kernel(k, HD, "default", chain) for k in ("egnn_band_fwd", "egnn_band_bwd")}
    rows = {served[k]: [] for k in served}
    cases = [(B, L, torch.bfloat16) for B, L in CHAIN_SHAPES] + [(*CHAIN_FP32_INPUTS, torch.float32)]
    for k, (B, L, in_dtype) in enumerate(cases):
        args = _egnn_inputs(B, L, SEED + 60 + k)
        xin = [args[0].to(in_dtype), args[1].to(in_dtype)] + args[2:]
        mode = mode_key("", in_dtype, "default", chain)[1:]
        in_bytes = 2 if in_dtype == torch.bfloat16 else 4
        g = torch.Generator(device="cuda").manual_seed(SEED + 60 + k)
        g_agg = torch.randn(B, L, HD, generator=g, device="cuda")
        g_delta = torch.randn(B, L, 3, generator=g, device="cuda")
        fwd = lambda: egnn_band_fwd(*xin, W, "default", chain)  # noqa: E731
        bwd = lambda: egnn_band_bwd(*xin, g_agg, g_delta, W, "default", chain)  # noqa: E731
        for name, call, plain, frac, outs in (
                ("egnn_band_fwd", fwd, lambda: egnn_band_reference(*xin, W, chain),
                 CHAIN_VALUE_FRAC, ("agg", "raw_delta")),
                ("egnn_band_bwd", bwd,
                 lambda: egnn_band_bwd_reference(*xin, g_agg, g_delta, W, chain),
                 BF16_GRAD_FRAC, names)):
            tag = f"{name} {mode} B{B}/L{L}"
            fp32_args = (args, g_agg, g_delta) if name == "egnn_band_bwd" else (args,)
            kernel = egnn_band_bwd if name == "egnn_band_bwd" else egnn_band_fwd
            onepass = lambda: kernel(*xin, *fp32_args[1:], W, "default")  # noqa: E731
            got, again = call(), call()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise RuntimeError(f"{tag}: two launches differ")
            if name == "egnn_band_bwd" and not (got[0].dtype == got[1].dtype == in_dtype):
                raise RuntimeError(f"{tag}: da / dbs are {got[0].dtype}, expected {in_dtype}")
            ref = plain()
            rel, rel_fp32 = _chain_err(tag, outs, got, ref, onepass(), frac)
            err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
            del got, again, ref
            ms = _median_ms(call)
            onepass_ms = _median_ms(onepass)
            tf32x3_ms = _median_ms(lambda: kernel(*args, *fp32_args[1:], W))
            host_us = _host_us(call, n=MIN_LAUNCHES)
            plain_ms = _median_ms(plain, reps=3)
            bound = _egnn_bound if name == "egnn_band_fwd" else _band_bwd_bound
            bound_ms, bound_by, *_, tc_ms, core_ms = bound(B, L, args[3], in_bytes, 1,
                                                           PEAK_BF16_FLOPS)
            floors = _sm90_floors(served[name], B, L, args[3], HD, "default", True)
            log(f"[kernels] {tag} ({served[name]}): {ms:.3f} ms (one-pass fp32 chain "
                f"{onepass_ms:.3f} ms, 3xTF32 with fp32 inputs {tf32x3_ms:.3f} ms in this call, "
                f"plain {plain_ms:.3f} ms), host {host_us:.1f} us per call; bound "
                f"{bound_ms:.4f} ms by {bound_by} (bf16 tensor-core products, "
                f"{100 * bound_ms / ms:.1f}% of it){_floor_text(floors)}, fp32-core time "
                f"{core_ms:.3f} ms; bitwise identical over two launches")
            rows[served[name]].append(dict(
                mode=mode, B=B, L=L, ms=ms, onepass_fp32_chain_ms=onepass_ms,
                fp32_ms=tf32x3_ms, host_us=host_us, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, tc_bound_ms=tc_ms, fp32_core_ms=core_ms,
                max_abs_err=err, max_rel_err=rel, max_rel_err_to_fp32_chain=rel_fp32, **floors))
        del args, xin, g_agg, g_delta
        torch.cuda.empty_cache()
    return rows


# The kernels of the bf16 chain on its path: the one-pass Hopper kernels
# (Hd 256), the shared-tile ones (512) and those above 512 (1024).
CHAIN_KERNELS = ("egnn_band_fwd_sm90", "egnn_band_bwd_sm90", "egnn_band_fwd_sm90_hd512",
                 "egnn_band_bwd_sm90_hd512", "egnn_band_fwd_sm90_wide",
                 "egnn_band_bwd_sm90_wide")


def phase_chain_path() -> dict:
    """The bf16 chain's path: ``scripts/chain_dtype_ab.py``'s ``run()`` (the
    counterpart of the JAX package's A/B of the knob, at Hd 256 and, at
    B4/L256, at Hd 512 and 1024), counts reset just before and read just
    after; each Hopper family's kernels (CHAIN_KERNELS) must have launched
    in the bf16 chain, and the mma.sync kernels not at all."""
    import importlib.util

    from protein_ensemble_vae_torch.ops.kernels import (BAND_MODE_LAUNCHES, LAUNCHES,
                                                        reset_launches)

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "chain_dtype_ab.py")
    spec = importlib.util.spec_from_file_location("chain_dtype_ab", path)
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    reset_launches()
    t0 = time.perf_counter()
    result = ab.run()
    secs = time.perf_counter() - t0
    launches, modes = dict(LAUNCHES), dict(BAND_MODE_LAUNCHES)
    chain = {k: v for k, v in modes.items() if k.endswith("/bfloat16_chain")}
    missing = [n for n in CHAIN_KERNELS if not any(k.startswith(n + ":") for k in chain)]
    if missing or launches["egnn_band_fwd"] or launches["egnn_band_bwd"]:
        raise RuntimeError(f"chain_dtype_ab: no bf16-chain launch of {missing}, or an mma.sync "
                           f"kernel ran: {launches}, by mode {modes}")
    log(f"[chain_ab] {json.dumps(result)}")
    log(f"[chain_ab] {secs:.1f}s; launches {launches}, by mode {modes}")
    return dict(launches=launches, modes=modes, result=result, seconds=secs)


# ---------------------------------------------------------------------------
# 4. generation main path
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# 3b. kernels 1-2 at Hd 512 and at padded widths
# ---------------------------------------------------------------------------

# Hd 512, the reference CLI's --decoder_hidden default (the width-512 Hopper
# kernels in every mode), in the three modes of the Hd-256 rows, at the
# shapes a model of
# that width gives the kernels: kernel 1 at B4/L256 (training) and
# B10/L640 (generation), kernel 2 at the training shapes. Widths outside
# NATIVE_HIDDEN run zero-padded to the next native width: 384 (-> 512) in
# the three modes, and the small widths 8 and 48 (-> 32, 64) in fp32, at
# B4/L256. Each row is held at its mode's Hd-256 tolerance; its bound
# counts the work at the real width, so a padded row's share of it shows
# what the padding costs.
WIDE_HD = 512
WIDE_ROWS = tuple((kernel, mode, WIDE_HD, B, L)
                  for mode in (FP32_MODE, BF16_MODE, "bfloat16/bfloat16_chain")
                  for kernel, shapes in (("egnn_band_fwd", ((4, 256), (NUM_SAMPLES, 640))),
                                         ("egnn_band_bwd", TRAIN_SHAPES))
                  for B, L in shapes)
PADDED_ROWS = (tuple((kernel, mode, 384, 4, 256)
                     for mode in (FP32_MODE, BF16_MODE, "bfloat16/bfloat16_chain")
                     for kernel in ("egnn_band_fwd", "egnn_band_bwd"))
               + tuple((kernel, FP32_MODE, hd, 4, 256) for hd in (8, 48)
                       for kernel in ("egnn_band_fwd", "egnn_band_bwd")))


def _band_row(kernel: str, mode: str, hd: int, B: int, L: int, seed: int) -> dict:
    """One kernel (``egnn_band_fwd`` or ``egnn_band_bwd``) in one mode
    (FP32_MODE, BF16_MODE or ``bfloat16/bfloat16_chain``) at width ``hd``
    against its plain version, at that mode's Hd-256 tolerance (fp32:
    rtol RTOL / atol ATOL_REL x max|plain| forward, ``_close_scaled``
    backward; bf16 model: BF16_VALUE_FRAC / BF16_GRAD_FRAC of max|plain|;
    bf16 chain: CHAIN_VALUE_FRAC / BF16_GRAD_FRAC and closer to the plain
    bf16 chain than to the one-pass fp32-chain kernel, ``_chain_err``); two
    launches bitwise identical; device ms, plain ms, host us and the bound
    at the real width."""
    import torch

    from protein_ensemble_vae_torch.ops.kernels.egnn_band import (
        MAX_NATIVE, band_kernel, egnn_band_bwd, egnn_band_bwd_reference, egnn_band_fwd,
        egnn_band_reference, native_width)

    args = _egnn_inputs(B, L, seed, hd)
    chain = torch.bfloat16 if mode.endswith("_chain") else torch.float32
    in_dtype = torch.float32 if mode == FP32_MODE else torch.bfloat16
    precision = "highest" if mode == FP32_MODE else "default"
    xin = [args[0].to(in_dtype), args[1].to(in_dtype)] + args[2:]
    tag = f"{kernel} {mode} Hd{hd} B{B}/L{L}" + (
        f" (padded to {native_width(hd)})" if native_width(hd) != hd else "")
    if kernel == "egnn_band_fwd":
        extra, outs = (), ("agg", "raw_delta")
        call = lambda: egnn_band_fwd(*xin, W, precision, chain)  # noqa: E731
        plain = lambda: egnn_band_reference(*xin, W, chain)  # noqa: E731
        onepass = lambda: egnn_band_fwd(*xin, W, "default")  # noqa: E731
    else:
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        extra = (torch.randn(B, L, hd, generator=g, device=DEVICE),
                 torch.randn(B, L, 3, generator=g, device=DEVICE))
        outs = GRAD_NAMES
        call = lambda: egnn_band_bwd(*xin, *extra, W, precision, chain)  # noqa: E731
        plain = lambda: egnn_band_bwd_reference(*xin, *extra, W, chain)  # noqa: E731
        onepass = lambda: egnn_band_bwd(*xin, *extra, W, "default")  # noqa: E731
    got, again = call(), call()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError(f"{tag}: two launches differ")
    if kernel == "egnn_band_bwd" and any(a.shape != b.shape
                                         for a, b in zip(got, xin[:3] + xin[4:])):
        raise RuntimeError(f"{tag}: gradients not shaped like their inputs")
    ref = plain()
    if mode == FP32_MODE:
        errs = []
        for name, a, b in zip(outs, got, ref):
            if kernel == "egnn_band_bwd":
                errs.append(_close_scaled(f"{tag} {name}", a, b))
                continue
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            if not (torch.isfinite(a).all()
                    and torch.allclose(a, b, rtol=RTOL, atol=ATOL_REL * scale)):
                raise RuntimeError(f"{tag} disagrees with its plain version ({name}: max "
                                   f"abs err {err:.3e}, max|plain| {scale:.3e})")
            errs.append(err)
        rel = max(e / max(float(b.abs().max()), 1e-30) for e, b in zip(errs, ref))
        rel_fp32 = None
    elif mode == BF16_MODE:
        frac = BF16_VALUE_FRAC if kernel == "egnn_band_fwd" else BF16_GRAD_FRAC
        rel = max(_bf16_err(f"{tag} {n}", a, b, frac) for n, a, b in zip(outs, got, ref))
        rel_fp32 = None
    else:
        frac = CHAIN_VALUE_FRAC if kernel == "egnn_band_fwd" else BF16_GRAD_FRAC
        rel, rel_fp32 = _chain_err(tag, outs, got, ref, onepass(), frac)
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
    del got, again, ref
    if hd > MAX_NATIVE:   # above 512: up to tens of ms a call
        ms = _median_ms(call, reps=WIDER_REPS, min_launches=WIDER_LAUNCHES)
        host_us = _host_us(call, n=WIDER_LAUNCHES)
        plain_ms = _median_ms(plain, reps=WIDER_REPS, min_launches=WIDER_LAUNCHES)
    else:
        ms = _median_ms(call)
        host_us = _host_us(call, n=MIN_LAUNCHES)
        plain_ms = _median_ms(plain, reps=3)
    in_bytes = 4 if in_dtype == torch.float32 else 2
    passes = 3 if mode == FP32_MODE else 1
    peak = PEAK_BF16_FLOPS if chain == torch.bfloat16 else PEAK_TF32_FLOPS
    bound = _egnn_bound if kernel == "egnn_band_fwd" else _band_bwd_bound
    bound_ms, bound_by, *_, tc_ms, core_ms = bound(B, L, args[3], in_bytes, passes, peak, hd)
    served = band_kernel(kernel, hd, precision, chain)
    floors = _sm90_floors(served, B, L, args[3], hd, precision, chain == torch.bfloat16)
    log(f"[kernels] {tag} ({served}): {ms:.3f} ms (plain {plain_ms:.3f} ms), host "
        f"{host_us:.1f} us per call; bound {bound_ms:.4f} ms by {bound_by} at Hd {hd}, "
        f"{100 * bound_ms / ms:.1f}% of it{_floor_text(floors)}; tensor-core time "
        f"{tc_ms:.3f} ms, fp32-core time {core_ms:.3f} ms; max err / max|plain| {rel:.2e}; "
        f"bitwise identical over two launches")
    del args, xin, extra
    torch.cuda.empty_cache()
    return dict(kernel=served, mode=mode, Hd=hd, padded_to=native_width(hd), B=B, L=L, ms=ms,
                host_us=host_us, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                tc_bound_ms=tc_ms, fp32_core_ms=core_ms, max_abs_err=err, max_rel_err=rel,
                **floors,
                **({} if rel_fp32 is None else {"max_rel_err_to_fp32_chain": rel_fp32}))


# Widths above 512 run a multiple of 256 given at run time (any other width
# zero-padded up: 640 -> 768, 1100 -> 1280): every mode on the Hopper
# kernels above 512 (csrc/egnn_band_{fwd,bwd}_sm90_wide.cu), in the three
# modes: Hd
# 1024 at B4/L256, the shape
# of the `cli.train --decoder_hidden 1024` epoch (phase 6b), and 640, 1100
# and 2048 at B1/L256. Each row is held at its mode's Hd-256 tolerance; a
# call there takes tens of ms, so its device time is the median of
# WIDER_REPS windows of at least WIDER_LAUNCHES calls.
WIDER_ROWS = (tuple((kernel, mode, 1024, 4, 256)
                    for mode in (FP32_MODE, BF16_MODE, "bfloat16/bfloat16_chain")
                    for kernel in ("egnn_band_fwd", "egnn_band_bwd"))
              + tuple((kernel, mode, hd, 1, 256) for hd in (640, 1100, 2048)
                      for mode in (FP32_MODE, BF16_MODE, "bfloat16/bfloat16_chain")
                      for kernel in ("egnn_band_fwd", "egnn_band_bwd")))
WIDER_REPS, WIDER_LAUNCHES = 3, 3

# The flagship path's own shapes at Hd 256 (phase 10 and
# scripts/flagship_run_torch.py): training's bf16-model mode of both
# kernels at B8 over the buckets 128 and 192, and generation's fp32
# forward over the validation protein's bucket 128 at phase 10's 4
# samples and the committed run's 20.
FLAGSHIP_ROWS = (tuple((kernel, BF16_MODE, HD, 8, L) for L in (128, 192)
                       for kernel in ("egnn_band_fwd", "egnn_band_bwd"))
                 + tuple(("egnn_band_fwd", FP32_MODE, HD, B, 128) for B in (4, 20)))


def phase_wide_kernels() -> dict[str, list[dict]]:
    """Kernels 1-2 at Hd 512 (WIDE_ROWS), at padded widths (PADDED_ROWS),
    above 512 (WIDER_ROWS) and at the flagship's shapes (FLAGSHIP_ROWS),
    each row by ``_band_row``."""
    rows = {}
    for k, (kernel, mode, hd, B, L) in enumerate(WIDE_ROWS + PADDED_ROWS + WIDER_ROWS
                                                 + FLAGSHIP_ROWS):
        row = _band_row(kernel, mode, hd, B, L, SEED + 90 + k)
        rows.setdefault(row.pop("kernel"), []).append(row)
    return rows


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


def main_model():
    """A fresh seeded HierCVAE at the default widths on the card."""
    import torch

    from protein_ensemble_vae_torch.config import ModelConfig
    from protein_ensemble_vae_torch.models import HierCVAE

    torch.manual_seed(SEED)
    model = HierCVAE(ModelConfig()).cuda().eval()
    log(f"[main] HierCVAE at default widths: "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    return model


def setup_main_path():
    """``main_model()`` and the two proteins (set-up, not timed)."""
    model = main_model()
    t0 = time.perf_counter()
    views = [_protein_view(pid, L, seed, model.config.seqemb_dim)
             for pid, L, seed in PROTEINS]
    log(f"[main] built {len(views)} NeRF proteins in "
        f"{time.perf_counter() - t0:.1f}s (set-up)")
    return model, views


def phase_main_path(model, views, out_dir: str) -> dict:
    import torch

    from protein_ensemble_vae_torch.infer.generate import generate_ensembles
    from protein_ensemble_vae_torch.models import HierCVAE
    from protein_ensemble_vae_torch.ops.kernels import (BAND_MODE_LAUNCHES, LAUNCHES,
                                                       reset_launches)
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import band_kernel

    cfg = model.config
    fwd = band_kernel("egnn_band_fwd", cfg.decoder_hidden, "highest")   # the fp32 model's
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
    launches, modes = dict(LAUNCHES), dict(BAND_MODE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    expected = len(PROTEINS) * 2 * cfg.decoder_layers
    log(f"[main] launches {launches} (expected {fwd} = {expected})")
    if launches[fwd] != expected:
        raise RuntimeError(f"main path launched {fwd} {launches[fwd]} times, expected "
                           f"{expected}")
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
    plain = HierCVAE(dataclasses.replace(cfg, use_pallas_egnn=False)).to(DEVICE).eval()
    plain.load_state_dict(model.state_dict())
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    L_pad = 640
    mask = torch.zeros(NUM_SAMPLES, L_pad, device=DEVICE)
    mask[:, :PROTEINS[1][1]] = 1.0
    z_g = torch.randn(NUM_SAMPLES, cfg.z_global, generator=g, device=DEVICE)
    z_l = torch.randn(NUM_SAMPLES, L_pad, cfg.z_local, generator=g, device=DEVICE)
    with torch.no_grad():
        got = model.decode(z_g, z_l, mask)
        want = plain.decode(z_g, z_l, mask)
    for name, a, b in zip(("N", "CA", "C"), got[:3], want[:3]):
        err = float((a - b).abs().max())
        log(f"[main] kernel vs plain decode B{NUM_SAMPLES}/L{L_pad}, {name}: "
            f"max abs err {err:.3e} A (atol {COORD_ATOL})")
        if not torch.isfinite(a).all() or err > COORD_ATOL:
            raise RuntimeError(f"kernel decode disagrees with the plain decode ({name})")
    return dict(launches=launches, modes=modes, per_structure=per_structure, peak=peak)


# ---------------------------------------------------------------------------
# 4b. data preparation: mmCIF -> aligned ensemble -> ESM-2 t33 -> generation
# ---------------------------------------------------------------------------

# ESM-2 at the published esm2_t33_650M_UR50D width (ESM2Config's defaults:
# hidden 1280, 33 layers, 20 heads, FFN 5120), seeded random weights drawn
# as HF draws them. The card's forward against the port's CPU forward on a
# ragged B2/T64 batch with one <mask> token within ESM_CPU_ATOL (the JAX
# package's tolerance for its t33 forward against HF); the bucketed embedder
# against the unpadded forward on the card within ESM_BUCKET_ATOL.
ESM_CPU_ATOL, ESM_BUCKET_ATOL = 5e-4, 1e-4
ESM_BUCKET_RESIDUES = 100                  # bucket 128: 26 padded tokens
ESM_TIMED_RESIDUES = (254, 510, 1022)      # buckets of 256, 512, 1024 tokens
ESM_TIMED_REPS = 5
DATAPREP_CIF = os.path.join("tests", "fixtures", "messy_9xyz.cif")
DATAPREP_CHAIN = ("AA", 3, 58)             # chain id, conformers, residues


def _esm2_flop(T: int, cfg) -> float:
    """FLOP of one ESM-2 forward over T tokens: per layer the q/k/v/out and
    FFN products, 2T(4D^2 + 2DF), and the two attention products, 4T^2 D."""
    D, F_ = cfg.hidden, cfg.intermediate
    return cfg.num_layers * (2 * T * (4 * D * D + 2 * D * F_) + 4 * T * T * D)


def _esm2_t33():
    """ESM2Embedder at the t33 width on the card, from init_hf_ with a
    seeded CUDA generator (no weights are read)."""
    import torch

    from protein_ensemble_vae_torch.models.esm2 import (ESM2, ESM2Config,
                                                        ESM2Embedder, init_hf_)

    cfg = ESM2Config()
    with torch.device("meta"):
        model = ESM2(cfg)
    model = init_hf_(model.to_empty(device=DEVICE),
                     torch.Generator(device=DEVICE).manual_seed(SEED))
    emb = ESM2Embedder(model.state_dict(), cfg, device=DEVICE)
    del model
    torch.cuda.empty_cache()
    return emb


def _esm_gates(emb) -> dict:
    """(b) the card's forward against the CPU forward; (c) bucket invariance."""
    import torch

    from protein_ensemble_vae_torch.models.esm2 import (CLS_ID, EOS_ID, ESM2, MASK_ID,
                                                        PAD_ID, tokenize)
    from protein_ensemble_vae_torch.ops.routing import set_full_fp32

    set_full_fp32()
    rng = np.random.default_rng(SEED)
    toks = rng.integers(4, 24, (2, 64)).astype(np.int64)
    toks[:, 0] = CLS_ID
    toks[0, -1] = EOS_ID
    toks[0, 9] = MASK_ID
    toks[1, 41:] = PAD_ID
    toks[1, 40] = EOS_ID
    toks = torch.from_numpy(toks)
    amask = toks != PAD_ID
    with torch.inference_mode():
        got = emb.model(toks.to(DEVICE), amask.to(DEVICE)).cpu()
    with torch.device("meta"):
        cpu = ESM2(emb.config)
    cpu = cpu.to_empty(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in emb.model.state_dict().items()})
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = cpu.eval()(toks, amask)
    cpu_s = time.perf_counter() - t0
    del cpu
    cpu_err = float((got[amask] - want[amask]).abs().max())
    log(f"[dataprep] ESM-2 t33 B2/T64 (ragged, one <mask>), card vs CPU forward: "
        f"max abs err {cpu_err:.3e} (atol {ESM_CPU_ATOL}); max |ref| "
        f"{float(want[amask].abs().max()):.2f}; CPU forward {cpu_s:.1f} s")
    if not torch.isfinite(got).all() or cpu_err > ESM_CPU_ATOL:
        raise RuntimeError(f"ESM-2 on the card disagrees with the CPU forward: {cpu_err}")

    seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), ESM_BUCKET_RESIDUES))
    reps = emb.embed(seq)
    ids = torch.from_numpy(tokenize(seq)[None].astype(np.int64)).to(DEVICE)
    with torch.inference_mode():
        direct = emb.model(ids)[0, 1:-1].cpu().numpy()
    bucket_err = float(np.abs(reps - direct).max())
    log(f"[dataprep] ESM2Embedder.embed ({ESM_BUCKET_RESIDUES} residues, bucket "
        f"{emb._bucket(ESM_BUCKET_RESIDUES + 2)}) vs the unpadded forward on the card: "
        f"max abs err {bucket_err:.3e} (atol {ESM_BUCKET_ATOL})")
    if reps.shape != (ESM_BUCKET_RESIDUES, emb.config.hidden) or bucket_err > ESM_BUCKET_ATOL:
        raise RuntimeError(f"bucketed embedding disagrees: {reps.shape}, {bucket_err}")
    return dict(cpu_err=cpu_err, cpu_atol=ESM_CPU_ATOL, bucket_err=bucket_err,
                bucket_atol=ESM_BUCKET_ATOL)


def _esm_timing(emb, trace_path) -> list[dict]:
    """(e) ``embed`` at ESM_TIMED_RESIDUES: the stream span (CUDA events
    around one call, which take in tokenisation, the copies and the host's
    dispatch; median of ESM_TIMED_REPS after one warm-up), host ms,
    tokens/s over the span, peak device memory; then one torch.profiler
    pass per length for the device's busy time (the union of its kernels'
    intervals) and busy share. The fp32 FLOP bound is held against the
    busy time, a device figure, and beside it against the span."""
    import torch

    weights = sum(p.numel() * p.element_size() for p in emb.model.parameters())
    rng = np.random.default_rng(SEED + 7)
    rows = []
    for n in ESM_TIMED_RESIDUES:
        seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n))
        T = emb._bucket(n + 2)
        emb.embed(seq)                                      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        span, host = [], []
        for _ in range(ESM_TIMED_REPS):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            s.record()
            out = emb.embed(seq)                            # ends in a copy to the host
            e.record()
            e.synchronize()
            host.append(1e3 * (time.perf_counter() - t0))
            span.append(s.elapsed_time(e))
        if out.shape != (n, emb.config.hidden) or not np.isfinite(out).all():
            raise RuntimeError(f"ESM-2 embedding at {n} residues: {out.shape}, non-finite")
        span_ms = float(np.median(span))
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        longest = n == ESM_TIMED_RESIDUES[-1]
        prof = _profile(lambda: emb.embed(seq), f"ESM-2 t33 embed {n} residues",
                        longest and trace_path and trace_path.replace(".json", ".esm2.json"),
                        table=longest)
        busy_ms = prof["busy_ms"]
        flop = _esm2_flop(T, emb.config)
        # the weights are the bytes that must move (the activations of one
        # sequence are a few MiB)
        t_ops, t_bytes = 1e3 * flop / PEAK_FP32_FLOPS, 1e3 * weights / PEAK_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes)
        rows.append(dict(residues=n, tokens=T, span_ms=span_ms, host_ms=float(np.median(host)),
                         device_busy_ms=busy_ms, busy_share=prof["busy_share"],
                         tokens_per_s=T / (span_ms / 1e3), peak_mib=peak_mib,
                         weights_mib=weights / 2**20, tflop=flop / 1e12, bound_ms=bound_ms,
                         bound_by="operations" if t_ops >= t_bytes else "bytes",
                         bound_share_busy=bound_ms / busy_ms, bound_share_span=bound_ms / span_ms))
        if longest:
            rows[-1]["device_us_by_kind"] = prof["us_by_kind"]
        log(f"[dataprep] ESM-2 t33 embed {n} residues ({T} tokens): stream span {span_ms:.2f} ms "
            f"(median of {ESM_TIMED_REPS}), {rows[-1]['host_ms']:.2f} ms host, device busy "
            f"{busy_ms:.2f} ms ({100 * prof['busy_share']:.1f}% of the profiled call), "
            f"{rows[-1]['tokens_per_s']:.0f} tokens/s, peak {peak_mib:.0f} MiB "
            f"(weights {weights / 2**20:.0f}); {flop / 1e12:.3f} TFLOP, fp32 bound "
            f"{bound_ms:.2f} ms = {100 * bound_ms / busy_ms:.1f}% of the busy time, "
            f"{100 * bound_ms / span_ms:.1f}% of the span")
    return rows


def phase_dataprep(model, out_dir: str, trace_path=None) -> dict:
    """ESM-2 t33 on the card (gates and timing), then the path: the mmCIF
    fixture through parse, gates, core-fit alignment and torsions on the
    card, the chain's H5 file (``write_chain_h5``, the port's own writer:
    the chip machine has no h5py), its ESM-2 embedding appended to it
    (``add_embeddings_to_h5``), the file read back through
    ``EnsembleDataset`` and ``generate_ensembles`` with the main model.
    Kernel 1's counts are reset just before the path and read just after:
    2 decodes x decoder_layers per structure."""
    import torch

    from protein_ensemble_vae_torch.data.dataset import EnsembleDataset, SingleConformerView
    from protein_ensemble_vae_torch.dataprep.esm import GROUP, add_embeddings_to_h5
    from protein_ensemble_vae_torch.dataprep.mmcif import (chain_to_arrays,
                                                           parse_mmcif_backbone)
    from protein_ensemble_vae_torch.dataprep.pipeline import process_chain, write_chain_h5
    from protein_ensemble_vae_torch.infer.generate import generate_ensembles
    from protein_ensemble_vae_torch.ops.kernels import LAUNCHES, reset_launches
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import band_kernel

    t_phase = t0 = time.perf_counter()
    emb = _esm2_t33()
    log(f"[dataprep] ESM-2 t33 (hidden {emb.config.hidden}, {emb.config.num_layers} layers, "
        f"{emb.config.num_heads} heads, FFN {emb.config.intermediate}) on the card: "
        f"{sum(p.numel() for p in emb.model.parameters())} parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    gates = _esm_gates(emb)
    timed = _esm_timing(emb, trace_path)

    cid, K, L = DATAPREP_CHAIN
    gen_dir = os.path.join(out_dir, "dataprep")
    torch.cuda.synchronize()
    reset_launches()
    stages = {}
    t0 = time.perf_counter()
    arrays = chain_to_arrays(parse_mmcif_backbone(DATAPREP_CIF)[cid])
    stages["parse_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    chain = process_chain(arrays, device=DEVICE)
    stages["process_chain_s"] = time.perf_counter() - t0
    if chain is None or chain["mask"].shape != (K, L):
        raise RuntimeError(f"chain {cid} of {DATAPREP_CIF}: expected K={K}, L={L}")
    t0 = time.perf_counter()
    h5 = write_chain_h5(os.path.join(out_dir, "dataprep_h5", f"9xyz_{cid}_nmr.h5"), chain)
    stages["write_h5_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not add_embeddings_to_h5(h5, emb, verbose=False):
        raise RuntimeError(f"no embedding written to {h5}")
    stages["embed_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    manifest = os.path.join(out_dir, "dataprep_h5", "manifest.csv")
    with open(manifest, "w") as f:
        f.write(f"h5_path\n{h5}\n")
    ds = EnsembleDataset(manifest, use_seqemb=True, verbose=False)
    stages["read_h5_s"] = time.perf_counter() - t0
    seq_emb = ds.conformers[0].seq_emb
    if (seq_emb is None or seq_emb.shape != (L, emb.config.hidden)
            or not np.isfinite(seq_emb).all() or len(ds.conformers) != K
            or not np.array_equal(ds.conformers[0].ca, chain["coords_ca"][0])):
        raise RuntimeError(f"{h5} ({GROUP}) read back {len(ds.conformers)} conformers, "
                           f"embedding {None if seq_emb is None else seq_emb.shape}")
    view = SingleConformerView(ds)
    t0 = time.perf_counter()
    out = generate_ensembles(model, view, gen_dir, num_samples=NUM_SAMPLES, seed=SEED,
                             buckets=BUCKETS, verbose=False)
    torch.cuda.synchronize()
    stages["generate_s"] = time.perf_counter() - t0
    launches = dict(LAUNCHES)

    expected = K * 2 * model.config.decoder_layers
    fwd = band_kernel("egnn_band_fwd", model.config.decoder_hidden, "highest")
    log(f"[dataprep] path launches {launches} (expected {fwd} = {expected}: "
        f"{K} structures x 2 decodes x {model.config.decoder_layers} layers)")
    if launches[fwd] != expected or sum(launches.values()) != expected:
        raise RuntimeError(f"dataprep path launched {launches}, expected "
                           f"{fwd} = {expected} and nothing else")
    for r in out["results"]:
        for suffix in ("true", "reconstruction", "ensemble"):
            path = os.path.join(gen_dir, f"{r['structure']}_{suffix}.pdb")
            xyz = _pdb_coords(path) if os.path.exists(path) else np.zeros(0)
            if xyz.size == 0 or not np.isfinite(xyz).all():
                raise RuntimeError(f"missing, empty or non-finite {path}")
    log(f"[dataprep] {DATAPREP_CIF} chain {cid} (K={K}, L={L}, bucket "
        f"{min(b for b in BUCKETS if b >= L)}) -> {len(out['results'])} ensembles of "
        f"{NUM_SAMPLES}: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + " (host clock)")
    del emb
    torch.cuda.empty_cache()
    log(f"[dataprep] phase {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, stages=stages, timed=timed, **gates)


# ---------------------------------------------------------------------------
# 5. training main path
# ---------------------------------------------------------------------------

class PairSet:
    """An in-memory pair dataset, duck-typed like ``EnsembleDataset``: every
    unordered pair of ``pairs`` over ``conformers``."""

    def __init__(self, conformers, pairs, seqemb_dim: int):
        self.conformers, self.pairs = conformers, pairs
        self.use_seqemb, self.seqemb_dim = True, seqemb_dim

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int):
        from protein_ensemble_vae_torch.data.dataset import process_conformer

        i, j = self.pairs[idx]
        return (process_conformer(self.conformers[i]),
                process_conformer(self.conformers[j]))

    def pair_length(self, idx: int) -> int:
        return self.conformers[self.pairs[idx][0]].length


def _nerf_conformers(pid: str, L: int, seed: int, K: int, seqemb_dim: int):
    """K NeRF conformers of one fold, sharing one sequence and embedding."""
    from protein_ensemble_vae_torch.config import AA_ORDER
    from protein_ensemble_vae_torch.data.dataset import Conformer
    from protein_ensemble_vae_torch.data.synthetic import (_torsions_np,
                                                           nerf_ensemble)

    n, ca, c = nerf_ensemble(L, K, seed=seed, max_tries=16)
    rng = np.random.default_rng(seed)
    mask = np.ones(L, np.float32)
    emb = rng.normal(0, 1, (L, seqemb_dim)).astype(np.float32)
    seq = "".join(rng.choice(list(AA_ORDER), L))
    return [Conformer(n=n[k], ca=ca[k], c=c[k], mask=mask, seq_emb=emb,
                      dihedrals=_torsions_np(n[k], ca[k], c[k], mask).astype(np.float32),
                      sequence=seq, protein_id=pid, h5_path="") for k in range(K)]


def _pair_manifests(out_dir: str, protein: tuple, seqemb_dim: int) -> tuple[str, str]:
    """``protein``'s NeRF fold (id, length, seed, conformers K) as real H5
    files, written by the port's own writer (``data.synthetic.
    write_synthetic_h5`` through ``data/h5file.py``: the card's machine has
    no h5py), and their manifests, read back by the CLIs through the normal
    ``EnsembleDataset``: K conformers to train on (K (K - 1) / 2 pairs) and
    2 conformers of the seed + 1 fold to validate on (1 pair). Written once
    per ``out_dir``."""
    from protein_ensemble_vae_torch.data.synthetic import write_synthetic_h5

    pid, L, seed, K = protein
    root = os.path.join(out_dir, "h5", f"{pid}_{seqemb_dim}")
    csvs = tuple(os.path.join(root, f"manifest_{s}.csv") for s in ("train", "val"))
    if all(os.path.exists(c) for c in csvs):
        return csvs
    for csv_path, tag, k, sd in ((csvs[0], "", K, seed), (csvs[1], "v", 2, seed + 1)):
        h5 = write_synthetic_h5(os.path.join(root, f"{pid}{tag}_nmr.h5"), K=k, L=L, seed=sd,
                                noise=0.105, seqemb_dim=seqemb_dim, fold="nerf")
        with open(csv_path, "w") as f:
            f.write(f"h5_path\n{h5}\n")
    return csvs


def _pair_steps(protein: tuple, batch_size: int) -> tuple[int, int]:
    """Train and val steps of one epoch over ``_pair_manifests``' pairs
    (one length, so one bucket)."""
    K = protein[3]
    return -(-(K * (K - 1) // 2) // batch_size), 1


class EpochLaunches:
    """A MetricLogger stand-in for ``train_model``: it records the launch
    counts and the statistics at the end of every epoch."""

    def __init__(self):
        self.epochs = []

    def log_epoch(self, epoch, train, val, **kw):
        from protein_ensemble_vae_torch.ops.kernels import LAUNCHES

        self.epochs.append(dict(epoch=epoch, launches=dict(LAUNCHES),
                                train=train, val=val, **kw))

    def info(self, msg: str) -> None:
        log(f"[train] {msg}")


def phase_train_path(out_dir: str) -> dict:
    """``train_model`` for 2 epochs at the default widths, with the launch
    counts of every epoch checked."""
    import torch

    from protein_ensemble_vae_torch.config import (LossWeights, ModelConfig,
                                                   RunConfig, TrainConfig)
    from protein_ensemble_vae_torch.data.collate import make_prepadded_factory
    from protein_ensemble_vae_torch.models import HierCVAE
    from protein_ensemble_vae_torch.ops.kernels import reset_launches
    from protein_ensemble_vae_torch.train.checkpoint import save_checkpoint
    from protein_ensemble_vae_torch.train.training import train_model

    pid, L, seed, K = TRAIN_PROTEIN
    cfg = RunConfig(model=ModelConfig(), loss=LossWeights(),
                    train=TrainConfig(batch_size=4, epochs=2, seed=SEED))
    t0 = time.perf_counter()
    confs = _nerf_conformers(pid, L, seed, K, cfg.model.seqemb_dim)
    pairs = [(i, j) for i in range(K) for j in range(i + 1, K)]
    train_ds = PairSet(confs, pairs[:8], cfg.model.seqemb_dim)
    val_ds = PairSet(confs, pairs[8:], cfg.model.seqemb_dim)
    torch.manual_seed(SEED)
    model = HierCVAE(cfg.model).to(DEVICE)
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    log(f"[train] {len(train_ds)} train / {len(val_ds)} val pairs of a NeRF "
        f"fold (L={L}, K={K}) and the model built in "
        f"{time.perf_counter() - t0:.1f}s (set-up)")
    saved = []

    def checkpoint_fn(state, epoch, loss_history, meta):
        tag = "best" if meta.get("best") else f"epoch{epoch:05d}"
        saved.append(save_checkpoint(os.path.join(out_dir, "train", tag), model,
                                     cfg, epoch, loss_history, meta,
                                     train_state=state))

    logger = EpochLaunches()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state, history = train_model(model, train_ds, val_ds, cfg, logger=logger,
                                 checkpoint_fn=checkpoint_fn,
                                 make_batches=make_prepadded_factory())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0

    n_layers = cfg.model.decoder_layers
    tr_steps = -(-len(train_ds) // cfg.train.batch_size)
    va_steps = -(-len(val_ds) // cfg.train.batch_size)
    want, _ = _served({"egnn_band_fwd": n_layers * (tr_steps + va_steps),
                       "egnn_band_bwd": n_layers * tr_steps,
                       "clash_fwd": tr_steps + va_steps, "clash_bwd": tr_steps},
                      hd=cfg.model.decoder_hidden)
    prev = {k: 0 for k in want}
    for rec in logger.epochs:
        got = {k: rec["launches"][k] - prev[k] for k in want}
        prev = {k: rec["launches"][k] for k in want}
        log(f"[train] epoch {rec['epoch']}: launches {got} (expected {want}); "
            f"train loss {rec['train']['loss']:.3f} rec {rec['train']['rec']:.3f}, "
            f"val loss {rec['val']['loss']:.3f}; skipped steps "
            f"{rec['train']['nonfinite_frac']:.2f}")
        if got != want:
            raise RuntimeError(f"epoch {rec['epoch']} launched {got}, expected {want}")
    if len(logger.epochs) != cfg.train.epochs:
        raise RuntimeError(f"{len(logger.epochs)} epochs ran, expected {cfg.train.epochs}")
    for split in ("train", "val"):
        for k, vals in history[split].items():
            if not np.isfinite(vals).all():
                raise RuntimeError(f"{split} {k} not finite: {vals}")
    moved = sum(not torch.equal(v, p0[k]) for k, v in model.state_dict().items())
    if moved == 0 or state.step != cfg.train.epochs * tr_steps:
        raise RuntimeError(f"parameters unchanged or wrong step count ({state.step})")
    if not saved or not all(os.path.exists(os.path.join(p, "state.pt")) for p in saved):
        raise RuntimeError("no checkpoint written")
    log(f"[train] 2 epochs in {secs:.2f} s ({cfg.train.epochs * (tr_steps + va_steps)} "
        f"steps, host clock, synchronised, first-use set-up included); "
        f"{moved}/{len(p0)} parameter tensors changed; {len(saved)} checkpoints")
    return dict(launches={k: v for k, v in logger.epochs[-1]["launches"].items()},
                seconds=secs, history=history)


def phase_train_cli_bf16(out_dir: str) -> dict:
    """``cli.train --compute_dtype bfloat16`` for one epoch at the default
    widths, batch 4, on TRAIN_PROTEIN's H5 files (``_pair_manifests``: 10
    train / 1 val pairs) read through ``EnsembleDataset``. Counts reset just
    before and read just after: per train step 8 band forwards, 8 band
    backwards, one of each clash kernel; per eval step 8 + 1; every band
    launch in the bf16 mode."""
    import torch

    from protein_ensemble_vae_torch.cli import train as train_cli
    from protein_ensemble_vae_torch.config import ModelConfig
    from protein_ensemble_vae_torch.ops.kernels import (BAND_MODE_LAUNCHES, LAUNCHES,
                                                       reset_launches)

    cfg = ModelConfig()
    train_csv, val_csv = _pair_manifests(out_dir, TRAIN_PROTEIN, cfg.seqemb_dim)
    save = os.path.join(out_dir, "train_cli_bf16")
    argv = ["--manifest_train", train_csv, "--manifest_val", val_csv, "--use_seqemb",
            "--epochs", "1", "--batch_size", "4", "--compute_dtype", "bfloat16",
            "--save", save, "--device", DEVICE]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    train_cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, modes = dict(LAUNCHES), dict(BAND_MODE_LAUNCHES)
    tr_steps, va_steps = _pair_steps(TRAIN_PROTEIN, 4)
    want, want_modes = _served({"egnn_band_fwd": cfg.decoder_layers * (tr_steps + va_steps),
                                "egnn_band_bwd": cfg.decoder_layers * tr_steps,
                                "clash_fwd": tr_steps + va_steps, "clash_bwd": tr_steps},
                               BF16_MODE, cfg.decoder_hidden)
    log(f"[train] cli.train --compute_dtype bfloat16, 1 epoch: launches {launches} "
        f"(expected {want}), band launches by mode {modes}")
    if launches != want or modes != want_modes:
        raise RuntimeError(f"cli.train bf16 launched {launches} / {modes}, expected "
                           f"{want} / {want_modes}")
    final = os.path.join(save, "final")
    with open(os.path.join(final, "history.json")) as f:
        history = json.load(f)
    with open(os.path.join(final, "meta.json")) as f:
        meta = json.load(f)
    for split in ("train", "val"):
        for k, vals in history[split].items():
            if not np.isfinite(vals).all():
                raise RuntimeError(f"cli.train bf16 {split} {k} not finite: {vals}")
    if meta["config"]["train"]["compute_dtype"] != "bfloat16":
        raise RuntimeError("cli.train bf16 checkpoint does not record bfloat16")
    log(f"[train] cli.train bf16: {secs:.2f} s for 1 epoch ({tr_steps} train + {va_steps} "
        f"val steps, host clock, synchronised, model set-up and first use included); train "
        f"loss {history['train']['loss'][-1]:.3f}, val loss {history['val']['loss'][-1]:.3f}; "
        f"checkpoint {final}")
    return dict(launches=launches, modes=modes, seconds=secs)


# ---------------------------------------------------------------------------
# 5b. grad-watch path
# ---------------------------------------------------------------------------

# kernel -> a substring of its device kernel's name in profiler records
# (kernel 2's edge pass stands for its four passes): the kernels of the
# fp32 model's step at HD (3xTF32: the shared-tile Hopper kernels)
KERNEL_RECORDS = {"egnn_band_fwd_sm90_x3": "egnn_fwd_sm90_hd512",
                  "egnn_band_bwd_sm90_x3": "egnn_bwd_edges_sm90_hd512",
                  "clash_fwd": "clash_fwd_kernel", "clash_bwd": "clash_bwd_kernel"}
WATCH_RTOL = 1e-6   # dump statistics vs the same gradient recomputed, of the tensor's scale


def _max_gap(a: dict, b: dict) -> float:
    """Largest |a - b| over the tensors of two state dicts."""
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def _watch_stats_gap(npz, want: dict) -> tuple[float, float]:
    """Worst gap of the dump's grad statistics to ``want`` (histogram
    summaries of the recomputed gradient) as a multiple of WATCH_RTOL times
    the tensor's scale (max |g|; l2 for l2), and of its bin counts as a
    multiple of ceil(WATCH_RTOL n) for a tensor of n values."""
    worst, counts = 0.0, 0.0
    for name, w in want.items():
        scale = max(abs(w["min"]), abs(w["max"]), 1e-30)
        for s in ("mean", "std", "min", "max", "l2"):
            ref = w["l2"] if s == "l2" else scale
            worst = max(worst, abs(float(npz[f"grad/{name}/{s}"]) - w[s])
                        / (WATCH_RTOL * max(ref, 1e-30)))
        n = int(w["counts"].sum())
        counts = max(counts, float(np.abs(npz[f"grad/{name}/counts"] - w["counts"]).max())
                     / np.ceil(WATCH_RTOL * n))
    return worst, counts


def phase_watch_path(out_dir: str, card: str) -> dict:
    """``cli.train --watch_every 1`` for 2 epochs at the default widths, fp32,
    batch 4, on TRAIN_PROTEIN's H5 files (``_pair_manifests``: 10 train / 1
    val pairs, read through ``EnsembleDataset``): counts reset just
    before and read just after; each epoch launches its train and val
    steps' kernels plus 8 / 8 / 1 / 1 for the dump. Two dumps, each with a
    ``param/`` and a ``grad/`` entry for every parameter, all finite; the
    last dump's gradient statistics against ``make_loss_fn``'s gradient of
    the same batch and seed recomputed on the kernel path (rtol WATCH_RTOL of
    the tensor's scale, counts within ceil(WATCH_RTOL n)); two runs without
    the flag, the flagged run no further from the first than the second is.
    Then ``make_param_grad_fn`` on the kernel and the plain path (smooth
    loss held per tensor at rtol 1e-3 / atol 1e-5 max|g|, the full loss
    reported), ``viz.parameters.main`` and ``viz.training_curves`` on the
    run's checkpoint, and ``utils.profiling``: ``trace`` around 3 warm
    B4/L256 steps (its records must name all four kernels), ``time_fn`` and
    ``scan_step_time`` beside a CUDA-event median of the same step."""
    import torch

    import protein_ensemble_vae_torch.utils.watch as watch
    from protein_ensemble_vae_torch.cli import train as train_cli
    from protein_ensemble_vae_torch.config import LossWeights, ModelConfig
    from protein_ensemble_vae_torch.data.collate import make_epoch_batches
    from protein_ensemble_vae_torch.models import HierCVAE
    from protein_ensemble_vae_torch.ops.kernels import LAUNCHES, reset_launches
    from protein_ensemble_vae_torch.ops.kernels.clash import clash_noop
    from protein_ensemble_vae_torch.train.checkpoint import load_run_config
    from protein_ensemble_vae_torch.train.training import (TrainState, batch_to_arrays,
                                                           fold_seed, make_loss_fn,
                                                           make_param_grad_fn,
                                                           make_train_step)
    from protein_ensemble_vae_torch.utils import profiling
    from protein_ensemble_vae_torch.viz import parameters as viz_params
    from protein_ensemble_vae_torch.viz import training_curves

    from protein_ensemble_vae_torch.data import EnsembleDataset

    t_phase = time.perf_counter()
    cfg = ModelConfig()
    train_csv, val_csv = _pair_manifests(out_dir, TRAIN_PROTEIN, cfg.seqemb_dim)
    sets = tuple(EnsembleDataset(m, use_seqemb=True, verbose=False)
                 for m in (train_csv, val_csv))
    argv = ["--manifest_train", train_csv, "--manifest_val", val_csv, "--use_seqemb",
            "--epochs", "2", "--batch_size", "4", "--seed", str(SEED), "--device", DEVICE]
    dumps = []
    orig_dump = watch.dump_watch_npz

    def recording_dump(path, params, grads=None, bins=64):
        torch.cuda.synchronize()
        d = dict(path=path, launches=dict(LAUNCHES), t_in=time.perf_counter(),
                 params={k: v.detach().cpu().clone() for k, v in params.items()})
        out = orig_dump(path, params, grads, bins)
        dumps.append(dict(d, t_out=time.perf_counter()))
        return out

    runs = {}
    for tag, extra in (("watched", ["--watch_every", "1"]), ("plain", []), ("plain2", [])):
        save = os.path.join(out_dir, f"train_watch_{tag}")
        watch.dump_watch_npz = recording_dump
        try:
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            train_cli.main(argv + ["--save", save] + extra)
            torch.cuda.synchronize()
        finally:
            watch.dump_watch_npz = orig_dump
        runs[tag] = dict(save=save, seconds=time.perf_counter() - t0, launches=dict(LAUNCHES),
                         model=torch.load(os.path.join(save, "final", "state.pt"),
                                          weights_only=True)["model"])
        if tag == "watched":
            t_start = t0
    launches = runs["watched"]["launches"]

    # launches per epoch: the train and val steps' plus one gradient's
    tr_steps, va_steps = -(-len(sets[0]) // 4), -(-len(sets[1]) // 4)
    n = cfg.decoder_layers
    want, _ = _served({"egnn_band_fwd": n * (tr_steps + va_steps + 1),
                       "egnn_band_bwd": n * (tr_steps + 1),
                       "clash_fwd": tr_steps + va_steps + 1, "clash_bwd": tr_steps + 1},
                      hd=cfg.decoder_hidden)
    if len(dumps) != 2:
        raise RuntimeError(f"--watch_every 1 over 2 epochs dumped {len(dumps)} times")
    prev = {k: 0 for k in want}
    for epoch, d in enumerate(dumps, 1):
        got = {k: d["launches"][k] - prev[k] for k in want}
        prev = d["launches"]
        log(f"[watch] epoch {epoch}: launches {got} (expected {want}: train + val steps "
            f"+ {n} / {n} / 1 / 1 for the dump)")
        if got != want:
            raise RuntimeError(f"watch epoch {epoch} launched {got}, expected {want}")
    if launches != dumps[-1]["launches"]:
        raise RuntimeError(f"kernels launched after the last dump: {launches}")

    # the files
    names = list(runs["watched"]["model"])
    files = sorted(os.listdir(os.path.join(runs["watched"]["save"], "watch")))
    if files != ["epoch_00001.npz", "epoch_00002.npz"]:
        raise RuntimeError(f"watch files {files}")
    for f in files:
        z = np.load(os.path.join(runs["watched"]["save"], "watch", f))
        for prefix in ("param", "grad"):
            for name in names:
                if int(z[f"{prefix}/{name}/nonfinite"]) != 0 or \
                        not np.isfinite(float(z[f"{prefix}/{name}/l2"])):
                    raise RuntimeError(f"{f}: {prefix}/{name} not finite")

    # the last dump's gradient, recomputed through make_loss_fn on the kernel path
    run_cfg = load_run_config(os.path.join(runs["watched"]["save"], "final"))
    model = HierCVAE(run_cfg.model).to(DEVICE)
    model.load_state_dict(dumps[-1]["params"])
    first = next(iter(make_epoch_batches(sets[0], run_cfg.train.batch_size,
                                         run_cfg.train.bucket_sizes, False,
                                         run_cfg.train.seed)))
    batch = {s: {k: torch.as_tensor(v, device=DEVICE) for k, v in d.items()}
             for s, d in batch_to_arrays(first, cfg.seqemb_dim).items()}
    model.train()
    with torch.random.fork_rng(devices=[torch.device(DEVICE)] if DEVICE == "cuda" else []):
        torch.manual_seed(fold_seed(run_cfg.train.seed, 2))
        total, _ = make_loss_fn(model, run_cfg.loss)(batch, run_cfg.loss.klw_global,
                                                     run_cfg.loss.klw_local)
        total.backward()
    recomputed = watch.histogram_summaries({k: p.grad for k, p in model.named_parameters()})
    z = np.load(dumps[-1]["path"])
    worst, count_gap = _watch_stats_gap(z, recomputed)
    log(f"[watch] epoch-2 dump vs make_loss_fn's gradient recomputed on the kernel path: "
        f"worst statistic {worst:.3f}x rtol {WATCH_RTOL} of the tensor's scale, worst bin "
        f"count {count_gap:.3f}x ceil({WATCH_RTOL} n)")
    if worst > 1.0 or count_gap > 1.0:
        raise RuntimeError(f"the dump's statistics leave the recomputed gradient's: worst "
                           f"{worst:.3f}x, counts {count_gap:.3f}x")
    del model

    # the flag leaves the run as it was
    gap_watch = _max_gap(runs["watched"]["model"], runs["plain"]["model"])
    gap_twice = _max_gap(runs["plain2"]["model"], runs["plain"]["model"])
    log(f"[watch] final parameters: run with --watch_every 1 vs without, largest gap "
        f"{gap_watch:.3e}; two runs without it, largest gap {gap_twice:.3e}")
    if not gap_watch <= gap_twice:
        raise RuntimeError(f"--watch_every changed the run: gap {gap_watch:.3e} > the "
                           f"gap between two runs without it {gap_twice:.3e}")
    hists = {}
    for tag in runs:
        with open(os.path.join(runs[tag]["save"], "final", "history.json")) as f:
            hists[tag] = json.load(f)
    same_hist = hists["watched"] == hists["plain"]
    log(f"[watch] history.json equal with and without the flag: {same_hist}; two runs "
        f"without it equal: {hists['plain'] == hists['plain2']}")

    # reading the run back
    final = os.path.join(runs["watched"]["save"], "final")
    viz_params.main(["--checkpoint", final, "--output_dir",
                     os.path.join(out_dir, "watch_params"), "--device", DEVICE])
    if not os.path.exists(os.path.join(out_dir, "watch_params", "parameter_summary.txt")):
        raise RuntimeError("viz.parameters wrote no summary")
    summary = training_curves.text_summary(training_curves.load_history_any(final))
    if not summary.startswith("epochs trained: 2"):
        raise RuntimeError(f"viz.training_curves read {summary!r}")
    log(f"[watch] viz.training_curves: {summary.splitlines()[0]}; {summary.splitlines()[-1]}")

    # kernel path vs plain path through make_param_grad_fn
    torch.manual_seed(SEED)
    kmodel = HierCVAE(cfg).to(DEVICE)
    pmodel = HierCVAE(dataclasses.replace(cfg, use_pallas_egnn=False)).to(DEVICE)
    pmodel.load_state_dict(kmodel.state_dict())
    step_batch = _step_batch(*TRAIN_HEADLINE, TIMED_STEPS[0]["L_real"], SEED + 8,
                             cfg.seqemb_dim)
    compare = {}
    for label, weights in (("smooth", LossWeights(**SMOOTH_WEIGHTS)), ("full", LossWeights())):
        kg = make_param_grad_fn(kmodel, weights)(step_batch, SEED + 11, 0.5, 0.25)
        pg = make_param_grad_fn(pmodel, weights)(step_batch, SEED + 11, 0.5, 0.25)
        bad, worst_g, worst_name = _grad_gap(kg, pg, False)
        held = label == "smooth"
        log(f"[watch] make_param_grad_fn kernel path vs plain path, B4/L256 fp32, dropout "
            f"on, {label} loss: {len(pg) - len(bad)}/{len(pg)} tensors within rtol 1e-3 / "
            f"atol 1e-5 max|g| (worst {worst_g:.2f}x the tolerance, {worst_name})"
            + ("" if held else " [reported, not held]"))
        if held and bad:
            raise RuntimeError(f"watch gradient: kernel path differs from the plain path in "
                               f"{bad} (worst {worst_g:.2f}x, {worst_name})")
        compare[label] = dict(worst=worst_g, worst_name=worst_name, within=len(pg) - len(bad),
                              n=len(pg))
    del pmodel, kg, pg

    # the dump's own cost at the run's shape: gradient (CUDA events) and the whole hook
    watch_fn = watch.make_watch_fn(kmodel, sets[0], run_cfg, os.path.join(out_dir, "watch_t"), 1)
    grad_fn = make_param_grad_fn(kmodel, run_cfg.loss)
    grad_fn(batch, 1, 1.0, 0.5)
    grad_ms = float(np.median([_window_ms(lambda: grad_fn(batch, 1, 1.0, 0.5), 1)
                               for _ in range(5)]))
    hook_ms = []
    for epoch in range(1, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        watch_fn(None, epoch)
        torch.cuda.synchronize()
        hook_ms.append(1e3 * (time.perf_counter() - t0))
    # each epoch from the previous dump's end (the run's start) to this dump's
    # histograms: its steps, checkpoints and this dump's gradient
    epoch_s = (dumps[0]["t_in"] - t_start, dumps[1]["t_in"] - dumps[0]["t_out"])
    histogram_s = [d["t_out"] - d["t_in"] for d in dumps]
    log(f"[watch] dump cost ({card}): gradient of the B4/L256 first batch "
        f"{grad_ms:.2f} ms (CUDA events, median of 5 calls); whole hook (batch, "
        f"gradient, gather, histograms, .npz) {float(np.median(hook_ms)):.2f} ms (host clock, "
        f"synchronised, median of 3); in the watched run, epochs 1 and 2 took "
        f"{epoch_s[0]:.2f} s (first use included) and {epoch_s[1]:.2f} s up to their "
        f"dump's histograms (steps, checkpoints and the dump's gradient), which then took "
        f"{histogram_s[0]:.2f} / {histogram_s[1]:.2f} s (copies to the host, histograms, "
        f".npz)")

    # utils.profiling on the B4/L256 fp32 step
    state = TrainState.create(kmodel)
    step = make_train_step(kmodel, LossWeights(), train=True)
    consts = [torch.tensor(v, device=DEVICE) for v in (0.5, 0.25, 3e-5)]
    for i in range(STEP_WARMUP):
        step(state, step_batch, i, *consts)
    torch.cuda.synchronize()
    tdir = os.path.join(out_dir, "watch_trace")
    with profiling.trace(tdir):
        for _ in range(PROFILER_MARKERS):
            clash_noop()
        torch.cuda.synchronize()
        for i in range(3):
            step(state, step_batch, i, *consts)
        torch.cuda.synchronize()
    with open(os.path.join(tdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    records = {k: sum(sub in name for name in kernels) for k, sub in KERNEL_RECORDS.items()}
    log(f"[watch] utils.profiling.trace over 3 B4/L256 fp32 steps: {len(kernels)} kernel "
        f"records, of the port's kernels {records} (3 steps launch {3 * n} / {3 * n} / 3 / 3)")
    if 0 in records.values():
        raise RuntimeError(f"the trace names no record of some kernel: {records}")

    tf = profiling.time_fn(lambda: step(state, step_batch, 0, *consts)[1], warmup=1, iters=5)

    def make_run(k):
        def run():
            for i in range(k):
                _, m = step(state, step_batch, i, *consts)
            return m["loss"]
        return run

    scan_s, scan_detail = profiling.scan_step_time(make_run, n1=2, n2=10, repeats=5,
                                                   return_detail=True)
    scan_med = float(np.median([r["per_step_ms"] for r in scan_detail["repeats"]]))
    event_ms = []
    for i in range(STEP_REPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step(state, step_batch, i, *consts)
        end.record()
        end.synchronize()
        event_ms.append(start.elapsed_time(end))
    times = dict(time_fn_ms=1e3 * tf["mean_s"], scan_step_ms=1e3 * scan_s,
                 scan_median_ms=scan_med, scan_detail=scan_detail,
                 event_median_ms=float(np.median(event_ms)), grad_ms=grad_ms,
                 hook_ms=float(np.median(hook_ms)), epoch_s=epoch_s,
                 histogram_s=histogram_s, phase_s=time.perf_counter() - t_phase)
    log(f"[watch] B4/L256 fp32 kernel-path train step ({card}): utils.profiling.time_fn "
        f"{times['time_fn_ms']:.2f} ms (mean of 5), scan_step_time {times['scan_step_ms']:.2f} "
        f"ms (2 vs 10 steps, min of 5 repeats; their median {scan_med:.2f} ms), CUDA events "
        f"{times['event_median_ms']:.2f} ms (median of {STEP_REPS}); phase 5b took "
        f"{times['phase_s']:.1f} s")
    del state, step, kmodel, watch_fn, grad_fn, batch, step_batch
    torch.cuda.empty_cache()
    return dict(launches=launches, dumps=len(dumps), gap_watch=gap_watch,
                gap_twice=gap_twice, same_history=same_hist, stats_worst=worst,
                counts_worst=count_gap,
                compare=compare, records=records, times=times,
                seconds=runs["watched"]["seconds"])


# ---------------------------------------------------------------------------
# 6. timed train steps
# ---------------------------------------------------------------------------

def _step_batch(B: int, L: int, L_real: int, seed: int, seqemb_dim: int) -> dict:
    """One pair batch on the card: conformers 0 -> 1 of a NeRF fold of
    ``L_real`` residues, padded to L, repeated B times."""
    import torch

    from protein_ensemble_vae_torch.data.collate import PairBatch, pad_conformers
    from protein_ensemble_vae_torch.data.dataset import process_conformer
    from protein_ensemble_vae_torch.train.training import batch_to_arrays

    confs = _nerf_conformers("synS", L_real, seed, 2, seqemb_dim)
    items = [process_conformer(c) for c in confs]
    pb = PairBatch(inp=pad_conformers([items[0]] * B, L, seqemb_dim),
                   tgt=pad_conformers([items[1]] * B, L, seqemb_dim))
    arrays = batch_to_arrays(pb, seqemb_dim)
    return {s: {k: torch.from_numpy(v).to(DEVICE) for k, v in d.items()}
            for s, d in arrays.items()}


# Smooth part of the objective: reconstruction, KL and sequence terms only.
SMOOTH_WEIGHTS = dict(w_pair=0.0, w_dihedral=0.0, w_rama=0.0, w_bond=0.0,
                      w_angle=0.0, w_clash=0.0)


def _path_grads(model, batch, weights, eps) -> tuple[dict, dict]:
    from protein_ensemble_vae_torch.train.training import make_loss_fn

    model.eval().zero_grad(set_to_none=True)
    total, (d, _) = make_loss_fn(model, weights)(batch, 0.5, 0.25, eps=eps)
    total.backward()
    return ({k: v.detach() for k, v in d.items()},
            {n: p.grad for n, p in model.named_parameters()})


def bf16_rel_gaps(got: dict, want: dict) -> dict[str, float]:
    """Per parameter tensor, |got - want| / |want| (Frobenius); for the
    attention key biases, whose gradient is zero analytically, max(|got|,
    |want|) / |want's query-bias gradient|."""
    out = {}
    for n, w in want.items():
        g = got[n]
        if n.endswith("key.bias"):
            q = want[n[:-len("key.bias")] + "query.bias"]
            out[n] = max(float(g.norm()), float(w.norm())) / max(float(q.norm()), 1e-30)
        else:
            out[n] = float((g - w).norm()) / max(float(w.norm()), 1e-30)
    return out


def _grad_gap(kg: dict, pg: dict, bf16: bool) -> tuple[list, float, str]:
    """Tensors whose kernel-path gradient ``kg`` leaves the reference ``pg``
    by more than the tolerance, and the worst ratio of error to it. fp32:
    rtol 1e-3 / atol 1e-5 * max|g| per tensor (floored at 1e-6). bf16:
    ``bf16_rel_gaps`` within BF16_GRAD_REL (key biases BF16_ZERO_GRAD_FRAC),
    each tensor on its own scale; BF16_NOISY within BF16_GRAD_FRAC of the
    step's max |grad|."""
    import torch

    for n, got in kg.items():
        if got is None or not torch.isfinite(got).all():
            raise RuntimeError(f"kernel-path gradient of {n} missing or not finite")
    if bf16:
        step_max = max(float(w.abs().max()) for w in pg.values())
        ratios = {n: (float((kg[n] - pg[n]).abs().max()) / (BF16_GRAD_FRAC * step_max)
                      if n in BF16_NOISY else
                      r / (BF16_ZERO_GRAD_FRAC if n.endswith("key.bias") else BF16_GRAD_REL))
                  for n, r in bf16_rel_gaps(kg, pg).items()}
    else:
        ratios = {}
        for n, want in pg.items():
            atol = max(1e-5 * float(want.abs().max()), 1e-6)
            ratios[n] = float(((kg[n] - want).abs() / (atol + 1e-3 * want.abs())).max())
    worst_name = max(ratios, key=ratios.get)
    return [n for n, r in ratios.items() if r > 1.0], ratios[worst_name], worst_name


@contextlib.contextmanager
def _plain_backwards():
    """The backward of kernels 2 and 4 (``egnn_band_bwd``, ``clash_bwd``)
    swapped for their plain versions inside the block; the forward kernels
    stay."""
    from protein_ensemble_vae_torch.ops.kernels import clash, egnn_band

    def band_bwd(a, bs, x, cmask, *rest):   # rest: 7 weights, g_agg, g_delta, W, ...
        return egnn_band.egnn_band_bwd_reference(a, bs, x, cmask, *rest[:10])

    def clash_bwd(n, ca, c, mask, g, counts, *params):
        B, L = mask.shape
        atoms, amask = clash.backbone_atoms(n, ca, c, mask)
        grad = clash.clash_bwd_reference(atoms, amask, g / (B * (counts + 1e-8)), *params)
        return grad.reshape(B, L, 3, 3).unbind(2)

    orig = (egnn_band.egnn_band_bwd, clash.clash_bwd)
    egnn_band.egnn_band_bwd, clash.clash_bwd = band_bwd, clash_bwd
    try:
        yield
    finally:
        egnn_band.egnn_band_bwd, clash.clash_bwd = orig


@contextlib.contextmanager
def _band_plain_version():
    """Route ``egnn_band_fused`` to the kernels' plain version (fp32 chain,
    full fp32 products) also for CUDA tensors, inside the block."""
    from protein_ensemble_vae_torch.ops.kernels import egnn_band

    orig = egnn_band.pallas_policy
    egnn_band.pallas_policy = lambda t, use_pallas="auto": False
    try:
        yield
    finally:
        egnn_band.pallas_policy = orig


# The float64 triage of the kernel path's gradient (``_float64_triage``).
# Model level, reported: both fp32 paths' parameter gradients against the
# float64 plain path's, for the smooth part, the full loss and the smooth
# part plus each of PHYSICS_TERMS alone, beside the plain path rerun with
# its band outputs multiplied by 1 + 2^-23 N(0, 1) (one fp32 rounding step;
# seeds PERTURB_SEEDS): at random initialisation such a perturbation alone
# flips the model's ReLU / clamp switches and moves whole gradients far
# past the tolerance (PERF.md, section 6), so a gradient's distance
# to float64 there measures the switches, not the kernels. Layer level,
# held: at the model's own inputs (each band layer's inputs and cotangents
# and the clash term's, recorded from the kernel path's full-loss
# gradient), kernels 1-4 against the float64 plain version, no farther
# than F64_RATIO x the fp32 plain version, or within the gradient
# tolerance (``_f64_dist`` <= 1). The band function and the clash term
# away from its threshold are smooth, so no switch moves this reading.
PHYSICS_TERMS = ("w_pair", "w_dihedral", "w_rama", "w_bond", "w_angle", "w_clash")
PERTURB_SEEDS = (100, 101, 102)
F64_RATIO = 2.0
TRIAGE_PATH = None   # --grad-triage: where the per-tensor distances go


def _float64_reference(model):
    """The plain path of ``model`` in float64: the same weights (fp32 values
    cast exactly), every Linear, LayerNorm, the band chain, the coordinates
    and the losses in float64."""
    import torch

    from protein_ensemble_vae_torch.models import HierCVAE

    ref = HierCVAE(dataclasses.replace(model.config, use_pallas_egnn=False),
                   dtype=torch.float64)
    ref.load_state_dict(model.state_dict())
    ref = ref.double().to(DEVICE)
    for m in ref.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return ref


def _f64_dist(got, want) -> float:
    """``_grad_gap``'s fp32 measure of ``got`` against the float64 value
    ``want``: max |got - want| / (1e-5 max|want| (>= 1e-6) + 1e-3 |want|),
    so that 1 is the gradient tolerance."""
    want = want.double()
    atol = max(1e-5 * float(want.abs().max()), 1e-6)
    return float(((got.double() - want).abs() / (atol + 1e-3 * want.abs())).max())


@contextlib.contextmanager
def _perturbed_band(seed: int):
    """The plain path's band outputs (agg, raw_delta) each multiplied by
    1 + 2^-23 N(0, 1), drawn from ``seed``, inside the block."""
    import torch

    from protein_ensemble_vae_torch.models import decoder

    orig = decoder.band_chain
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def chain(*args, **kw):
        return tuple(t * (1 + 2.0 ** -23 * torch.randn(t.shape, generator=g, device=t.device))
                     for t in orig(*args, **kw))

    decoder.band_chain = chain
    try:
        yield
    finally:
        decoder.band_chain = orig


@contextlib.contextmanager
def _recorded_backwards():
    """Record the arguments and outputs of every kernel 2 and kernel 4 call
    (the backward wrappers) inside the block; yields the list of
    (kernel, args, outputs)."""
    import torch

    from protein_ensemble_vae_torch.ops.kernels import clash, egnn_band

    calls, orig = [], (egnn_band.egnn_band_bwd, clash.clash_bwd)

    def recording(name, fn):
        def call(*args):
            out = fn(*args)
            calls.append((name, [t.detach().clone() if torch.is_tensor(t) else t for t in args],
                          [t.detach().clone() for t in out]))
            return out
        return call

    egnn_band.egnn_band_bwd = recording("egnn_band_bwd", orig[0])
    clash.clash_bwd = recording("clash_bwd", orig[1])
    try:
        yield calls
    finally:
        egnn_band.egnn_band_bwd, clash.clash_bwd = orig


def _band_versions(args, kgrads) -> dict:
    """Kernels 1-2 on one band layer's recorded arguments (a, bs, x, cmask,
    the 7 weights, g_agg, g_delta, W, precision, chain_dtype) and the fp32
    and float64 plain versions: {output: (kernel, fp32 plain, float64)}."""
    import torch

    from protein_ensemble_vae_torch.ops.kernels.egnn_band import (
        band_chain, band_indices, egnn_band_bwd_reference, egnn_band_fwd, egnn_band_reference)

    a, bs, x, cmask, *rest = args
    params, (g_agg, g_delta, W, precision, chain) = rest[:7], rest[7:]
    kout = egnn_band_fwd(a, bs, x, cmask, *params, W, precision, chain)
    pout = egnn_band_reference(a, bs, x, cmask, *params, W)
    pgrads = egnn_band_bwd_reference(a, bs, x, cmask, *params, g_agg, g_delta, W)
    idx, in_range = band_indices(a.shape[1], W, a.device)
    cm = cmask > 0.5
    valid = in_range[None] & cm[:, :, None] & cm[:, idx]
    diff = [t.double().requires_grad_(True) for t in (a, bs, x, *params)]
    with torch.enable_grad():
        rout = band_chain(diff[0], diff[1], diff[2], idx, valid, *diff[3:], torch.float64)
        rgrads = torch.autograd.grad(rout, diff, (g_agg.double(), g_delta.double()))
    names = ("agg", "raw_delta") + tuple(f"d{n}" for n in GRAD_NAMES)
    return {n: v for n, *v in zip(names, (*kout, *kgrads), (*pout, *pgrads),
                                  (*rout, *rgrads))}


def _clash_versions(args, kgrads) -> dict:
    """Kernels 3-4 on the clash term's recorded arguments (n, ca, c, mask,
    g, counts, clash_dist, soft_margin) and the fp32 and float64 plain
    versions: {output: (kernel, fp32 plain, float64)}."""
    from protein_ensemble_vae_torch.ops.kernels.clash import (backbone_atoms,
                                                              clash_bwd_reference)

    from protein_ensemble_vae_torch.ops.kernels.clash import clash_fwd, clash_fwd_reference

    n, ca, c, mask, g, counts, *params = args
    B, L = mask.shape
    versions = {}
    for dtype in ("float", "double"):
        atoms, amask = backbone_atoms(*(getattr(t, dtype)() for t in (n, ca, c, mask)))
        scale = getattr(g, dtype)() / (B * (getattr(counts, dtype)() + 1e-8))
        versions[dtype] = (clash_fwd_reference(atoms, amask, *params),) + tuple(
            clash_bwd_reference(atoms, amask, scale, *params).reshape(B, L, 3, 3).unbind(2))
    kernel = (clash_fwd(n, ca, c, mask, *params)[1],) + tuple(kgrads)
    return {k: v for k, *v in zip(("totals", "dn", "dca", "dc"), kernel, versions["float"],
                                  versions["double"])}


def _float64_triage(kmodel, pmodel, batch, eps) -> dict:
    """See the note above PHYSICS_TERMS: the model-level distances
    (reported) and the layer-level gate (held). Per-tensor distances go to
    TRIAGE_PATH when it is set."""
    import torch

    from protein_ensemble_vae_torch.config import LossWeights

    hd = kmodel.config.decoder_hidden
    rmodel = _float64_reference(kmodel)
    batch64 = {s: {k: v.double() if v.is_floating_point() else v for k, v in d.items()}
               for s, d in batch.items()}
    eps64 = tuple(e.double() for e in eps)
    default = LossWeights()
    cases = [("smooth", LossWeights(**SMOOTH_WEIGHTS)), ("full", default)] + [
        (f"smooth+{t[2:]}", LossWeights(**{**SMOOTH_WEIGHTS, t: getattr(default, t)}))
        for t in PHYSICS_TERMS]

    def run(model, b, w, e, ctx=contextlib.nullcontext):
        with ctx():
            d, g = _path_grads(model, b, w, e)
        return {k: v.double() for k, v in d.items()}, {n: t.clone() for n, t in g.items()}

    out, per_tensor = {"model": {}}, {}
    for label, weights in cases:
        rd, rg = run(rmodel, batch64, weights, eps64)
        paths = {"kernel": run(kmodel, batch, weights, eps), "plain": run(pmodel, batch, weights, eps)}
        paths.update({f"plain, perturbed {s}": run(pmodel, batch, weights, eps,
                                                   lambda s=s: _perturbed_band(s))
                      for s in PERTURB_SEEDS})
        dist = {path: {n: _f64_dist(g[n], rg[n]) for n in rg} for path, (_, g) in paths.items()}
        worst = {path: max(d.values()) for path, d in dist.items()}
        loss_err = {path: max(float((d[k] - rd[k]).abs() / rd[k].abs().clamp(min=1e-30))
                              for k in rd) for path, (d, _) in paths.items()}
        out["model"][label] = dict(
            worst=worst, worst_name={p: max(d, key=d.get) for p, d in dist.items()},
            within={p: sum(v <= 1 for v in d.values()) for p, d in dist.items()}, n=len(rg),
            ratio=worst["kernel"] / max(worst["plain"], 1e-30), loss_rel_err=loss_err)
        per_tensor[label] = {n: [dist[p][n] for p in paths] for n in rg}
        log(f"[steps] float64 triage Hd{hd}, {label} loss (worst tensor's distance to the "
            f"float64 gradient, 1 = the gradient tolerance; tensors within): "
            + "; ".join(f"{p} {worst[p]:.2f} ({out['model'][label]['within'][p]}/{len(rg)})"
                        for p in paths)
            + f"; kernel / plain {out['model'][label]['ratio']:.2f}; loss dict max rel err "
            f"to float64: kernel {loss_err['kernel']:.2e}, plain {loss_err['plain']:.2e} "
            "[reported]")
    per_tensor["paths"] = list(paths)
    del rmodel
    torch.cuda.empty_cache()

    # layer level: kernels 1-4 at the model's inputs, against float64
    with _recorded_backwards() as calls:
        _path_grads(kmodel, batch, default, eps)
    layer, bad = {}, []
    for k, (name, args, kgrads) in enumerate(calls):
        key = "kernels 1-2" if name == "egnn_band_bwd" else "kernels 3-4"
        row = layer.setdefault(key, dict(kernel_worst=0.0, plain_worst=0.0, calls=0))
        row["calls"] += 1
        versions = (_band_versions if name == "egnn_band_bwd" else _clash_versions)(args, kgrads)
        for o, (kv, pv, rv) in versions.items():
            dk, dp = _f64_dist(kv, rv), _f64_dist(pv, rv)
            row["kernel_worst"] = max(row["kernel_worst"], dk)
            row["plain_worst"] = max(row["plain_worst"], dp)
            if dk > max(F64_RATIO * dp, 1.0):
                bad.append(f"call {k} ({name}) {o}: kernel {dk:.2f}, plain {dp:.2f}")
        del versions
    del calls
    torch.cuda.empty_cache()
    for key, row in layer.items():
        log(f"[steps] float64 triage Hd{hd}, {key} at the model's inputs ({row['calls']} calls "
            f"of the full loss's gradient): worst distance to float64 kernel "
            f"{row['kernel_worst']:.3f}, fp32 plain version {row['plain_worst']:.3f} (held: "
            f"kernel <= {F64_RATIO} x plain, or <= 1) {'FAIL' if bad else 'ok'}")
    out["layer"] = layer
    if TRIAGE_PATH:
        os.makedirs(os.path.dirname(os.path.abspath(TRIAGE_PATH)), exist_ok=True)
        triage = {}
        if os.path.exists(TRIAGE_PATH):
            with open(TRIAGE_PATH) as f:
                triage = json.load(f)
        triage[f"Hd{hd}"] = dict(summary=out, per_tensor=per_tensor)
        with open(TRIAGE_PATH, "w") as f:
            json.dump(triage, f)
    if bad:
        raise RuntimeError(f"float64 triage Hd{hd}: kernel outputs farther from float64 than "
                           f"{F64_RATIO}x the fp32 plain version: {bad[:8]}")
    return out


def _compare_paths(kmodel, pmodel, batch, hold_plain: bool = True) -> dict:
    """Kernel path vs reference paths on one batch, same injected noise,
    dropout off; the loss dict and every parameter gradient, for the smooth
    part of the objective (reconstruction, KL, sequence terms) and the full
    loss.

    fp32: two references, the plain path (the band's plain version, the
    dense clash) and the kernel path with the backward of kernels 2 and 4
    swapped for their plain versions (``_plain_backwards``). Held: the full
    default loss dict to rtol 1e-4 against the plain path; the smooth
    part's gradients within rtol 1e-3 / atol 1e-5 * max|g| per tensor (the
    CPU parity tests' tolerance) against the plain backward, and against
    the plain path when ``hold_plain``; the full loss's gradients are
    reported. The plain backward runs on the kernel path's own forward, so
    both take every ReLU / clamp switch the same way. Against the plain
    path a switch may flip: at random initialisation one fp32 rounding
    step on the band outputs already flips switches that move whole
    gradients past the tolerance (``_float64_triage`` measures it: PERF.md,
    section 6). Then the float64 triage (``_float64_triage``).

    bf16: two references, the same bf16 model with kernels 1-2 routed to
    their plain version (``_band_plain_version``: the fp32 chain in full
    fp32, where the kernels make one-pass TF32 products) and the plain path
    (its band in the bf16 edge chain, JAX's XLA path at bf16). Held: the
    loss dict to 3 % of both; the smooth part's gradients against the
    plain version per tensor, on each tensor's own scale (``_grad_gap``),
    and that this check flags one zeroed decoder EGNN weight gradient.
    Any difference in a bf16 model flips downstream bf16 roundings, so two
    correct bf16 steps differ by bf16 noise: the two references' own
    distance is logged beside it on the same scale. Reported: the full
    loss's gradients, and the kernel path against the bf16-chain path."""
    import torch

    from protein_ensemble_vae_torch.config import LossWeights

    cfg = kmodel.config
    bf16 = kmodel.dtype == torch.bfloat16
    loss_tol = BF16_VALUE_FRAC if bf16 else 1e-4
    B, L = batch["tgt"]["mask"].shape
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    eps = (torch.randn(B, cfg.z_global, generator=g, device=DEVICE),
           torch.randn(B, L, cfg.z_local, generator=g, device=DEVICE))

    def run(model, ctx=contextlib.nullcontext):
        with ctx():
            d, grads = _path_grads(model, batch, weights, eps)
        return d, {n: t.clone() for n, t in grads.items()}

    out = {}
    for label, weights in (("smooth", LossWeights(**SMOOTH_WEIGHTS)),
                           ("full", LossWeights())):
        kd, kg = run(kmodel)
        if bf16:
            vd, vg = run(kmodel, _band_plain_version)
            cd, cg = run(pmodel)
            _, rworst, rname = _grad_gap(cg, vg, True)
            log(f"[steps] bf16-chain plain path vs kernels' plain version, B{B}/L{L}, "
                f"{label} loss: worst gradient {rworst:.2f}x the per-tensor tolerance ({rname})")
            out[f"{label} references"] = dict(worst=rworst, worst_name=rname)
            refs = (("kernels' plain version", vd, vg, {"smooth"}),
                    ("plain path, bf16 chain", cd, cg, set()))
        else:
            pd, pg = run(pmodel)
            bd, bg = run(kmodel, _plain_backwards)
            refs = (("plain path", pd, pg, {"smooth"} if hold_plain else set()),
                    ("kernel forward, plain backward", bd, bg, {"smooth"}))
        for ref, pd, pg, hold_labels in refs:
            loss_err = max(float(((kd[k].float() - pd[k].float())
                                  / pd[k].float().abs().clamp(min=1e-30)).abs()) for k in pd)
            if loss_err > loss_tol:
                raise RuntimeError(f"{label} loss: kernel-path loss dict differs from the "
                                   f"{ref}, rel err {loss_err:.3e} (tolerance {loss_tol})")
            bad, worst, worst_name = _grad_gap(kg, pg, bf16)
            held = label in hold_labels
            if bad and held:
                raise RuntimeError(f"{label} loss: kernel-path gradients of {bad} differ from "
                                   f"the {ref} (worst {worst:.2f}x the tolerance, {worst_name})")
            if held:
                # the check sees one wrong tensor, however small its gradients
                zeroed = "decoder.egnn_1.phi_e2_kernel"
                if zeroed not in _grad_gap({**kg, zeroed: 0 * kg[zeroed]}, pg, bf16)[0]:
                    raise RuntimeError(f"the gradient check passes a zeroed {zeroed}")
            tol = ("rtol 1e-3 / atol 1e-5 max|g|" if not bf16 else
                   f"|g - w| <= {BF16_GRAD_REL} |w| per tensor (key biases: "
                   f"|g|, |w| <= {BF16_ZERO_GRAD_FRAC} |query-bias grad|; {', '.join(BF16_NOISY)}: "
                   f"{BF16_GRAD_FRAC} of the step's max |grad|)")
            log(f"[steps] kernel path vs {ref}, B{B}/L{L} {'bf16' if bf16 else 'fp32'}, "
                f"{label} loss: loss dict max rel err {loss_err:.2e} (tolerance {loss_tol}); "
                f"gradients within {tol}: {len(pg) - len(bad)}/{len(pg)} tensors (worst "
                f"{worst:.2f}x the tolerance, {worst_name})"
                + ("" if held else " [gradients reported, not held]"))
            out[f"{label} vs {ref}"] = dict(loss_rel_err=loss_err, worst=worst,
                                            worst_name=worst_name,
                                            within=len(pg) - len(bad), n=len(pg))
    if not bf16:
        out["float64"] = _float64_triage(kmodel, pmodel, batch, eps)
    return out


def phase_timed_steps(trace_path=None) -> list[dict]:
    import torch

    from protein_ensemble_vae_torch.config import ModelConfig
    from protein_ensemble_vae_torch.models import HierCVAE

    rows = []
    for dtype, mode in ((torch.float32, FP32_MODE), (torch.bfloat16, BF16_MODE)):
        dname = "bf16" if dtype == torch.bfloat16 else "fp32"
        for spec in TIMED_STEPS:
            B, L = spec["B"], spec["L"]
            mcfg = ModelConfig(decoder_remat=spec["remat"])
            torch.manual_seed(SEED)
            kmodel = HierCVAE(mcfg, dtype=dtype).to(DEVICE)
            pmodel = HierCVAE(dataclasses.replace(mcfg, use_pallas_egnn=False),
                              dtype=dtype).to(DEVICE)
            pmodel.load_state_dict(kmodel.state_dict())
            batch = _step_batch(B, L, spec["L_real"], SEED + 8, mcfg.seqemb_dim)
            if (B, L) == TRAIN_HEADLINE:
                rows.append(dict(dtype=dname, compare=_compare_paths(kmodel, pmodel, batch)))
            tag = f"B{B}/L{L}" + ("+remat" if spec["remat"] else "") + f" {dname}"
            for path, model in (("kernel", kmodel), ("plain", pmodel)):
                profile = (trace_path.replace(".json", f".train_{dname}.json")
                           if trace_path and path == "kernel" and (B, L) == TRAIN_HEADLINE
                           else None)
                rows.append(dict(shape=tag, dtype=dname, path=path,
                                 **_timed_steps(model, batch, path, mode, tag, profile)))
            del kmodel, pmodel, batch
            torch.cuda.empty_cache()
    return rows


def _timed_steps(model, batch, path: str, mode: str, tag: str, profile=None) -> dict:
    """``make_train_step`` on ``model`` (the kernel or the plain path):
    median ms of STEP_REPS synchronised steps after STEP_WARMUP warm-ups,
    peak device memory, and the launches per step, held at the model's
    count (kernels 1-2 in ``mode``, twice kernel 1 per layer under remat;
    none on the plain path). ``profile``: a torch.profiler trace path for
    one more step."""
    import torch

    from protein_ensemble_vae_torch.config import LossWeights
    from protein_ensemble_vae_torch.ops.kernels import (BAND_MODE_LAUNCHES, LAUNCHES,
                                                       reset_launches)
    from protein_ensemble_vae_torch.train.training import TrainState, make_train_step

    mcfg = model.config
    consts = [torch.tensor(v, device=DEVICE) for v in (0.5, 0.25, 3e-5)]
    state = TrainState.create(model)
    step = make_train_step(model, LossWeights(), train=True)
    for i in range(STEP_WARMUP):
        step(state, batch, i, *consts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**20
    reset_launches()
    times = []
    for i in range(STEP_REPS):
        t0 = time.perf_counter()
        _, metrics = step(state, batch, i, *consts)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    launches = {k: v // STEP_REPS for k, v in LAUNCHES.items()}
    modes = {k: v // STEP_REPS for k, v in BAND_MODE_LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    if not all(bool(torch.isfinite(v)) for v in metrics.values()):
        raise RuntimeError(f"{path} step {tag}: non-finite metrics")
    per_layer = 2 if mcfg.decoder_remat else 1
    want, want_modes = (_served({"egnn_band_fwd": per_layer * mcfg.decoder_layers,
                                 "egnn_band_bwd": mcfg.decoder_layers, "clash_fwd": 1,
                                 "clash_bwd": 1}, mode, mcfg.decoder_hidden)
                        if path == "kernel" else ({k: 0 for k in LAUNCHES}, {}))
    if launches != want or modes != want_modes:
        raise RuntimeError(f"{path} step {tag} launched {launches} / {modes}, "
                           f"expected {want} / {want_modes}")
    ms = float(np.median(times))
    log(f"[steps] {tag} {path} path: {ms:.2f} ms per train step (median of "
        f"{STEP_REPS} after {STEP_WARMUP} warm-ups, host clock, synchronised; "
        f"min {min(times):.2f}), peak device memory {peak:.1f} MiB ({base:.1f} "
        f"allocated before the steps: both models, optimizer state, batch), "
        f"launches per step {launches}, band launches by mode {modes}")
    prof = {}
    if profile:
        p = _profile(lambda: step(state, batch, 0, *consts), f"train step {tag}", profile)
        prof = dict(profile={k: p[k] for k in ("busy_share", "busy_ms", "wall_ms",
                                               "us_by_kernel")})
    return dict(ms=ms, min_ms=min(times), peak_mib=peak, base_mib=base,
                launches=launches, modes=modes, **prof)


# ---------------------------------------------------------------------------
# 6b. the decoder at Hd 512 and at the verify drive's width
# ---------------------------------------------------------------------------

# cli.train at the widths of the repository's end-to-end drive
# (.claude/skills/verify/SKILL.md): decoder width 16, run zero-padded to 32.
TINY_CLI = ["--use_seqemb", "--batch_size", "4", "--lr", "1e-4", "--d_model", "32",
            "--nhead", "4", "--ff", "64", "--nlayers", "1", "--z_global", "16",
            "--z_local", "8", "--decoder_hidden", "16", "--decoder_layers", "2",
            "--max_neighbors", "4"]
TINY_PROTEIN = ("synU", 24, 4, 4)   # id, length, fold seed, conformers (6 pairs)


def _tiny_cli_train(out_dir: str, hd: int = 16) -> dict:
    """``cli.train --device cuda`` for one epoch at TINY_CLI's widths on
    TINY_PROTEIN's H5 files (``_pair_manifests``: 6 train / 1 val pairs),
    the decoder at width ``hd`` (16, zero-padded to 32, is the verify
    drive's; 384 runs zero-padded to 512 on the width-512 kernels).
    Counts reset just before and read just after: per train step 2 band
    forwards, 2 band backwards, one of each clash kernel; per eval step
    2 + 1; every band launch in FP32_MODE."""
    import torch

    from protein_ensemble_vae_torch.cli import train as train_cli
    from protein_ensemble_vae_torch.ops.kernels import (BAND_MODE_LAUNCHES, LAUNCHES,
                                                       reset_launches)
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import native_width

    train_csv, val_csv = _pair_manifests(out_dir, TINY_PROTEIN, 16)
    save = os.path.join(out_dir, f"train_cli_tiny_{hd}")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    train_cli.main(["--manifest_train", train_csv, "--manifest_val", val_csv,
                    *TINY_CLI, "--decoder_hidden", str(hd), "--epochs", "1", "--save", save,
                    "--device", DEVICE])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, modes = dict(LAUNCHES), dict(BAND_MODE_LAUNCHES)
    tr, va = _pair_steps(TINY_PROTEIN, 4)
    want, want_modes = _served({"egnn_band_fwd": 2 * (tr + va), "egnn_band_bwd": 2 * tr,
                                "clash_fwd": tr + va, "clash_bwd": tr}, FP32_MODE, hd)
    with open(os.path.join(save, "final", "history.json")) as f:
        history = json.load(f)
    finite = all(np.isfinite(v).all() for split in ("train", "val")
                 for v in history[split].values())
    log(f"[wide] cli.train --device {DEVICE} at the verify drive's widths (decoder "
        f"{hd}, zero-padded to {native_width(hd)}), 1 epoch: {secs:.2f} s (host clock, model set-up and "
        f"first use included), launches {launches} (expected {want}), by mode {modes}; "
        f"losses finite: {finite}")
    if launches != want or modes != want_modes or not finite:
        raise RuntimeError(f"cli.train at decoder width {hd} launched {launches} / {modes}, "
                           f"expected {want} / {want_modes}, or gave non-finite losses")
    return dict(launches=launches, modes=modes, seconds=secs)


WIDER_CLI_HD = 1024   # a decoder above the native widths: the Hopper kernels above 512


def _wider_cli_train(out_dir: str) -> dict:
    """``cli.train --decoder_hidden WIDER_CLI_HD --device cuda`` for one
    epoch, every other width at its default, fp32, batch 4, on
    TRAIN_PROTEIN's H5 files (``_pair_manifests``). Counts reset just
    before and read just after: per train step 8 band forwards and 8 band
    backwards (``egnn_band_{fwd,bwd}_sm90_wide``), one of each clash kernel; per eval step
    8 + 1; every band launch in FP32_MODE; losses finite."""
    import torch

    from protein_ensemble_vae_torch.cli import train as train_cli
    from protein_ensemble_vae_torch.config import ModelConfig
    from protein_ensemble_vae_torch.ops.kernels import (BAND_MODE_LAUNCHES, LAUNCHES,
                                                       reset_launches)

    cfg = ModelConfig()
    train_csv, val_csv = _pair_manifests(out_dir, TRAIN_PROTEIN, cfg.seqemb_dim)
    save = os.path.join(out_dir, "train_cli_wider")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    train_cli.main(["--manifest_train", train_csv, "--manifest_val", val_csv, "--use_seqemb",
                    "--epochs", "1", "--batch_size", "4", "--decoder_hidden",
                    str(WIDER_CLI_HD), "--save", save, "--device", DEVICE])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, modes = dict(LAUNCHES), dict(BAND_MODE_LAUNCHES)
    tr, va = _pair_steps(TRAIN_PROTEIN, 4)
    n = cfg.decoder_layers
    want, want_modes = _served({"egnn_band_fwd": n * (tr + va), "egnn_band_bwd": n * tr,
                                "clash_fwd": tr + va, "clash_bwd": tr}, FP32_MODE, WIDER_CLI_HD)
    with open(os.path.join(save, "final", "history.json")) as f:
        history = json.load(f)
    finite = all(np.isfinite(v).all() for split in ("train", "val")
                 for v in history[split].values())
    log(f"[wide] cli.train --decoder_hidden {WIDER_CLI_HD} --device {DEVICE}, 1 epoch: "
        f"{secs:.2f} s (host clock, model set-up and first use included), launches "
        f"{launches} (expected {want}), by mode {modes}; losses finite: {finite}; train "
        f"loss {history['train']['loss'][-1]:.3f}")
    if launches != want or modes != want_modes or not finite:
        raise RuntimeError(f"cli.train at decoder width {WIDER_CLI_HD} launched {launches} / "
                           f"{modes}, expected {want} / {want_modes}, or gave non-finite "
                           "losses")
    return dict(launches=launches, modes=modes, seconds=secs)


def wide_steps(trace_path=None, compare: bool = True) -> tuple[list[dict], dict]:
    """The B4/L256 train step of ``ModelConfig(decoder_hidden=WIDE_HD)`` in
    fp32 and bf16, each timed on the kernel and the plain path
    (``_timed_steps``), the fp32 one first held against the plain path
    (``_compare_paths``: the loss dict, the smooth part's gradients and
    the float64 triage) when ``compare``. ``trace_path``: torch.profiler
    traces of one kernel-path step each (``TRACE.wide_fp32.json``,
    ``TRACE.wide_bf16.json``; device busy share, top operators)."""
    import torch

    from protein_ensemble_vae_torch.config import ModelConfig
    from protein_ensemble_vae_torch.models import HierCVAE

    mcfg = ModelConfig(decoder_hidden=WIDE_HD)
    B, L = TRAIN_HEADLINE
    batch = _step_batch(B, L, TIMED_STEPS[0]["L_real"], SEED + 8, mcfg.seqemb_dim)
    steps, result = [], None
    for dtype, mode in ((torch.float32, FP32_MODE), (torch.bfloat16, BF16_MODE)):
        dname = "bf16" if dtype == torch.bfloat16 else "fp32"
        torch.manual_seed(SEED)
        kmodel = HierCVAE(mcfg, dtype=dtype).to(DEVICE)
        pmodel = HierCVAE(dataclasses.replace(mcfg, use_pallas_egnn=False),
                          dtype=dtype).to(DEVICE)
        pmodel.load_state_dict(kmodel.state_dict())
        if dtype == torch.float32 and compare:
            # against the plain path the gradients are reported: one fp32
            # rounding step on the band outputs flips switches here (PERF.md)
            result = _compare_paths(kmodel, pmodel, batch, hold_plain=False)
        tag = f"B{B}/L{L}/Hd{WIDE_HD} {dname}"
        for path, m in (("kernel", kmodel), ("plain", pmodel)):
            profile = (trace_path.replace(".json", f".wide_{dname}.json")
                       if trace_path and path == "kernel" else None)
            steps.append(dict(shape=tag, dtype=dname, path=path,
                              **_timed_steps(m, batch, path, mode, tag, profile)))
        del kmodel, pmodel
        torch.cuda.empty_cache()
    return steps, result


WIDE_CLI_HD = 384   # a CLI epoch at a width the wrappers pad to WIDE_HD


def _plain_generation(model, views, out_dir: str) -> list[float]:
    """Seconds per structure of ``generate_ensembles`` on the plain path
    (``model``'s weights, ``use_pallas_egnn=False``): one warm-up pass,
    then one timed pass per view (host clock, synchronised). No kernel may
    launch."""
    import torch

    from protein_ensemble_vae_torch.infer.generate import generate_ensembles
    from protein_ensemble_vae_torch.models import HierCVAE
    from protein_ensemble_vae_torch.ops.kernels import LAUNCHES, reset_launches

    plain = HierCVAE(dataclasses.replace(model.config, use_pallas_egnn=False)).to(DEVICE).eval()
    plain.load_state_dict(model.state_dict())
    for view in views:
        generate_ensembles(plain, view, os.path.join(out_dir, "plain_warmup"),
                           num_samples=NUM_SAMPLES, seed=SEED, buckets=BUCKETS, verbose=False)
    torch.cuda.synchronize()
    reset_launches()
    secs = []
    for view in views:
        t0 = time.perf_counter()
        generate_ensembles(plain, view, os.path.join(out_dir, "plain"), num_samples=NUM_SAMPLES,
                           seed=SEED, buckets=BUCKETS, verbose=False)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    if any(LAUNCHES.values()):
        raise RuntimeError(f"the plain generation path launched {dict(LAUNCHES)}")
    del plain
    return secs


def phase_wide_decoder(views, out_dir: str, trace_path=None) -> dict:
    """``ModelConfig(decoder_hidden=WIDE_HD)``, every other field at its
    default, random weights from SEED: generation at buckets 256 / 640 with
    ``phase_main_path``'s checks (launch counts, files, the kernel decode of
    one latent within COORD_ATOL of the plain decode), timed beside the
    plain path (``_plain_generation``); the fp32 B4/L256 train step
    (``_compare_paths``: the loss dict, the smooth part's gradients and the
    float64 triage) and the bf16 one, each timed on the kernel and the
    plain path (``wide_steps``; profiled with ``trace_path``); then
    ``_tiny_cli_train`` at decoder widths 16 and WIDE_CLI_HD and
    ``_wider_cli_train``. The width-512 kernels must launch in the
    generation, in both steps and in the WIDE_CLI_HD epoch. Launches of
    every kernel on these paths: generation's, the timed kernel-path
    steps' (STEP_REPS each) and the CLIs'."""
    import torch

    from protein_ensemble_vae_torch.config import ModelConfig
    from protein_ensemble_vae_torch.models import HierCVAE
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import band_kernel

    mcfg = ModelConfig(decoder_hidden=WIDE_HD)
    torch.manual_seed(SEED)
    model = HierCVAE(mcfg).to(DEVICE).eval()
    log(f"[wide] HierCVAE(decoder_hidden={WIDE_HD}): "
        f"{sum(p.numel() for p in model.parameters())} parameters; generation with "
        f"phase 4's checks ([main] lines)")
    gen = phase_main_path(model, views, os.path.join(out_dir, "wide"))
    fwd = band_kernel("egnn_band_fwd", WIDE_HD, "highest")
    want = {f"{fwd}:{FP32_MODE}": gen["launches"][fwd]}
    if gen["modes"] != want or not gen["launches"][fwd]:
        raise RuntimeError(f"Hd {WIDE_HD} generation launched {gen['modes']}, expected {want}")
    plain_gen = _plain_generation(model, views, os.path.join(out_dir, "wide"))
    log(f"[wide] Hd {WIDE_HD} generation, seconds per structure (host clock, synchronised; "
        f"buckets {[min(b for b in BUCKETS if b >= L) for _, L, _ in PROTEINS]}): kernel path "
        f"{[round(t, 4) for t in gen['per_structure']]}, plain path "
        f"{[round(t, 4) for t in plain_gen]}")
    del model
    torch.cuda.empty_cache()
    steps, compare = wide_steps(trace_path)
    for r in steps:
        precision = "highest" if r["dtype"] == "fp32" else "default"
        if r["path"] == "kernel" and not all(r["launches"][band_kernel(k, WIDE_HD, precision)]
                                             for k in ("egnn_band_fwd", "egnn_band_bwd")):
            raise RuntimeError(f"{r['shape']} step did not launch the width-{WIDE_HD} kernels: "
                               f"{r['launches']}")
    cli = _tiny_cli_train(out_dir)
    cli_wide = _tiny_cli_train(out_dir, WIDE_CLI_HD)
    if not all(cli_wide["launches"][band_kernel(k, WIDE_CLI_HD, "highest")]
               for k in ("egnn_band_fwd", "egnn_band_bwd")):
        raise RuntimeError(f"the width-{WIDE_CLI_HD} CLI epoch did not launch the width-"
                           f"{WIDE_HD} kernels: {cli_wide['launches']}")
    wider = _wider_cli_train(out_dir)
    launches = {k: gen["launches"][k] + cli["launches"][k] + cli_wide["launches"][k]
                + wider["launches"][k]
                + sum(STEP_REPS * r["launches"][k] for r in steps if r["path"] == "kernel")
                for k in cli["launches"]}
    log(f"[wide] Hd {WIDE_HD} path launches {launches}: generation {gen['launches']}, "
        f"{STEP_REPS} fp32 + {STEP_REPS} bf16 timed steps, the width-16 CLI epoch "
        f"{cli['launches']}, the width-{WIDE_CLI_HD} CLI epoch {cli_wide['launches']}, the "
        f"width-{WIDER_CLI_HD} CLI epoch {wider['launches']}")
    return dict(launches=launches, per_structure=gen["per_structure"],
                plain_per_structure=plain_gen, peak_mib=gen["peak"] / 2**20,
                steps=steps, compare=compare, cli=cli, cli_wide=cli_wide, cli_wider=wider)


# ---------------------------------------------------------------------------
# 10. the flagship pipeline
# ---------------------------------------------------------------------------

# scripts/flagship_run_torch.py at its full widths (ModelConfig(), bf16,
# B8, the nerf3 recipe) cut to 2 epochs and batteries of 4 samples with 20
# torsion-stage polish steps (the Cartesian stage's 600 are fixed).
FLAGSHIP_ENV = dict(FLAGSHIP_EPOCHS="2", FLAGSHIP_FOLD="nerf", FLAGSHIP_PLATEAU="160",
                    FLAGSHIP_SAMPLES="4", FLAGSHIP_REFINE="20")
FLAGSHIP_STRUCTURES = 5   # the validation protein's conformers (K = 5)


def _flagship_steps(manifest: str, batch_size: int) -> int:
    """Steps of one epoch over a manifest's pairs, batched by length bucket."""
    from protein_ensemble_vae_torch.config import TrainConfig
    from protein_ensemble_vae_torch.data import EnsembleDataset
    from protein_ensemble_vae_torch.data.collate import make_epoch_batches

    ds = EnsembleDataset(manifest, use_seqemb=True, verbose=False)
    return sum(1 for _ in make_epoch_batches(ds, batch_size, TrainConfig().bucket_sizes,
                                             False, 0))


def phase_flagship(out_dir: str) -> dict:
    """``scripts/flagship_run_torch.py``'s stages ``data``, ``train`` and
    ``gen`` with FLAGSHIP_ENV on the card: its own stage functions, each of
    its CLI commands called through the module's ``main`` in this process
    (so that the counts are read here; the commands are the script's).
    The data stage writes the 7 proteins' H5 files with the port's writer
    (no h5py on this machine) and the train and gen stages read them
    through ``EnsembleDataset``. Counts reset just before each stage and
    read just after, by mode: data launches nothing; train launches per
    epoch 8 band forwards per train and val step and 8 band backwards per
    train step, all in the bf16-model mode, and one of each clash kernel
    per step; gen (the raw battery, then polish) 2 decodes x 8 layers per
    structure and battery of fp32 band forwards, and kernels 3-4 in
    polish's Cartesian stage. The train log is finite with no skipped step,
    both analyses are written, run.json records every stage."""
    import importlib
    import importlib.util

    import torch

    from protein_ensemble_vae_torch.config import ModelConfig
    from protein_ensemble_vae_torch.infer.refine import clear_graphs
    from protein_ensemble_vae_torch.ops.kernels import (BAND_MODE_LAUNCHES, LAUNCHES,
                                                       reset_launches)
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import band_kernel

    t_phase = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "flagship_run_torch", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                           "scripts", "flagship_run_torch.py"))
    fr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fr)
    root = os.path.join(out_dir, "flagship")
    s = fr.settings(dict(FLAGSHIP_ENV, FLAGSHIP_ROOT=root, FLAGSHIP_DEVICE=DEVICE))

    def in_process(cmds, record):
        for cmd in cmds:
            record.append(cmd)
            importlib.import_module(cmd[2]).main(cmd[3:])

    stages = {}
    fr._run = in_process
    for name, stage in (("data", fr.build_data), ("train", fr.train),
                        ("gen", fr.generate_and_analyze)):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        stage(s)
        torch.cuda.synchronize()
        stages[name] = dict(seconds=time.perf_counter() - t0, launches=dict(LAUNCHES),
                            modes=dict(BAND_MODE_LAUNCHES))
        log(f"[flagship] {name}: {stages[name]['seconds']:.1f} s (host clock), launches "
            f"{stages[name]['launches']}, band launches by mode {stages[name]['modes']}")
    clear_graphs()

    n = ModelConfig().decoder_layers
    epochs = int(FLAGSHIP_ENV["FLAGSHIP_EPOCHS"])
    tr = _flagship_steps(os.path.join(root, "data", "manifest_train.csv"), 8)
    va = _flagship_steps(os.path.join(root, "data", "manifest_val.csv"), 8)
    want_train, want_train_modes = _served(
        {"egnn_band_fwd": epochs * n * (tr + va), "egnn_band_bwd": epochs * n * tr,
         "clash_fwd": epochs * (tr + va), "clash_bwd": epochs * tr}, BF16_MODE)
    gen_fwd = 2 * FLAGSHIP_STRUCTURES * 2 * n
    gen_kernel = band_kernel("egnn_band_fwd", ModelConfig().decoder_hidden, "highest")
    got_gen = stages["gen"]["launches"]
    bad = []
    if any(stages["data"]["launches"].values()):
        bad.append(f"data launched {stages['data']['launches']}")
    if (stages["train"]["launches"] != want_train
            or stages["train"]["modes"] != want_train_modes):
        bad.append(f"train launched {stages['train']['launches']} / {stages['train']['modes']}, "
                   f"expected {want_train} / {want_train_modes}")
    if (got_gen[gen_kernel] != gen_fwd
            or any(got_gen[k] for k in got_gen if k.startswith("egnn") and k != gen_kernel)
            or stages["gen"]["modes"] != {f"{gen_kernel}:{FP32_MODE}": gen_fwd}
            or not got_gen["clash_fwd"] or not got_gen["clash_bwd"]):
        bad.append(f"gen launched {got_gen} / {stages['gen']['modes']}, expected "
                   f"{gen_fwd} fp32 band forwards and kernels 3-4 in polish")
    recs = [json.loads(line) for line in open(os.path.join(root, "train_log.jsonl"))]
    if len(recs) != epochs or any(
            r.get("train/nonfinite_frac", 1) != 0 or not all(
                np.isfinite(v) for v in r.values() if isinstance(v, float)) for r in recs):
        bad.append(f"train_log.jsonl: {len(recs)} epochs, or non-finite / skipped steps")
    for f in ("analysis.txt", "analysis_raw.txt"):
        with open(os.path.join(root, f)) as fh:
            if "AGGREGATE" not in fh.read():
                bad.append(f"{f} has no aggregate")
    with open(os.path.join(root, "run.json")) as f:
        run = json.load(f)
    if [st["stage"] for st in run["stages"]] != ["data", "train", "gen"] or not all(
            st["ok"] for st in run["stages"]):
        bad.append(f"run.json stages {[(st['stage'], st['ok']) for st in run['stages']]}")
    if bad:
        raise RuntimeError("flagship: " + "; ".join(bad))
    aggregate = {}
    for tag, f in (("raw", "analysis_raw.txt"), ("polish", "analysis.txt")):
        with open(os.path.join(root, f)) as fh:
            text = fh.read().split("AGGREGATE", 1)[1]
        aggregate[tag] = {k.strip(): float(v) for k, v in
                          (line.split(":", 1) for line in text.splitlines()
                           if line.strip().startswith("mean_"))}
    log(f"[flagship] {epochs} epochs ({tr} + {va} steps each, B8), val RMSD "
        f"{[round(r['val/rmsd'], 3) for r in recs]}, {recs[-1]['seconds']:.2f} s for the last "
        f"epoch; raw battery {aggregate['raw']}; polish battery {aggregate['polish']}; "
        f"phase {time.perf_counter() - t_phase:.1f} s (random-init weights: the "
        "numbers mean nothing)")
    launches = {k: sum(st["launches"][k] for st in stages.values()) for k in LAUNCHES}
    return dict(launches=launches, stages=stages, aggregate=aggregate,
                epoch_seconds=[r["seconds"] for r in recs])


# ---------------------------------------------------------------------------
# 7. refinement
# ---------------------------------------------------------------------------

# generate_ensembles' polish pipeline: the fixed 600-step Cartesian stage
# (infer/generate.py:POLISH_CARTESIAN), then the torsion stage at the first
# polish row of runs/refine_sweep_polish.json (300 steps, lr 0.01, anchor
# 0.01, w_rama 2, w_omega 1, w_clash_vdw 400, lr_decay), its vdW weight and
# decay passed explicitly. Then cli.refine on one ensemble it wrote.
REFINE = dict(refine_mode="polish", refine_steps=300, refine_lr=0.01,
              refine_anchor=0.01, refine_w_rama=2.0,
              refine_kwargs=dict(w_clash_vdw=400.0, lr_decay=True))
CLI_REFINE_STEPS = 150
REFINE_SHAPES = ((NUM_SAMPLES, 256), (NUM_SAMPLES, 640))
# Kernels 3-4 vs the plain clash inside the whole Cartesian energy: the
# energy at rtol 1e-3, its gradient at rtol 1e-3 / atol 1e-4 * max|g|.
E_RTOL, E_G_ATOL_REL = 1e-3, 1e-4
LOOP_STEPS, LOOP_ATOL = 20, 1e-4   # Adam loop from a CUDA graph vs eager, A
BOND_ATOL = 1e-4                   # torsion stage's bonds vs config.BOND_*, A
NERF_ATOL = 1e-3                   # prefix-product rebuild vs float64 sequential, A
PROFILE_STEPS = 10                 # Adam steps of a profiled refine stage
# The profiler at times drops a kernel's record (one clash_bwd of 20 in a
# run of 20 steps): a call with fewer records than launches is profiled
# again, one with more fails at once.
PROFILE_ATTEMPTS = 3


def _polish_weights() -> dict:
    """The polish Cartesian stage's energy weights, ``refine_backbone``'s
    defaults where POLISH_CARTESIAN names none."""
    import inspect

    from protein_ensemble_vae_torch.infer.generate import POLISH_CARTESIAN
    from protein_ensemble_vae_torch.infer.refine import WEIGHTS, refine_backbone

    params = inspect.signature(refine_backbone).parameters
    return {k: float(POLISH_CARTESIAN.get(k, params[k].default)) for k in WEIGHTS}


def _torsion_stage_kwargs() -> dict:
    """``refine_torsions``' arguments in the polish pipeline under REFINE,
    as generate_ensembles forms them."""
    return dict(steps=REFINE["refine_steps"], lr=REFINE["refine_lr"],
                anchor_weight=REFINE["refine_anchor"], w_rama=REFINE["refine_w_rama"],
                w_omega=REFINE["refine_w_rama"] / 2.0, vdw_include_o=True,
                **REFINE["refine_kwargs"])


def _refine_energy_gate(B: int, L: int, n, ca, c, mask) -> float:
    """The polish Cartesian energy and its gradient with the clash term
    through kernels 3-4 against the same energy on the plain clash, at
    coordinates moved 0.1 A (rms per axis) off the anchor; returns the
    largest gradient error over max|g|."""
    import torch

    from protein_ensemble_vae_torch.infer import refine as R
    from protein_ensemble_vae_torch.ops.kernels import LAUNCHES

    ref = dict(zip(R.ATOMS, (n, ca, c)))
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 30 + L)
    moved = {k: v + 0.1 * torch.randn(v.shape, generator=g, device=DEVICE)
             for k, v in ref.items()}
    w = {k: torch.tensor(v, device=DEVICE) for k, v in _polish_weights().items()}
    res = {}
    for label, use in (("kernel", "auto"), ("plain", False)):
        xs = {k: v.clone().requires_grad_(True) for k, v in moved.items()}
        before = (LAUNCHES["clash_fwd"], LAUNCHES["clash_bwd"])
        e = R._energy(xs, ref, mask, w, rama_on=True, vdw_on=True, use_pallas=use)
        grads = torch.autograd.grad(e, [xs[k] for k in R.ATOMS])
        launched = (LAUNCHES["clash_fwd"] - before[0], LAUNCHES["clash_bwd"] - before[1])
        if launched != ((1, 1) if use else (0, 0)):
            raise RuntimeError(f"refine energy ({label}) launched kernels 3-4 {launched}")
        res[label] = (e.detach(), grads)
    (ek, gk), (ep, gp) = res["kernel"], res["plain"]
    e_err = float((ek - ep).abs() / ep.abs())
    if not bool(torch.isfinite(ek)) or e_err > E_RTOL:
        raise RuntimeError(f"refine energy B{B}/L{L}: kernel path {float(ek)} vs plain "
                           f"{float(ep)} (rel err {e_err:.2e})")
    g_rel = 0.0
    for k, a, b in zip(R.ATOMS, gk, gp):
        scale = float(b.abs().max())
        if not (bool(torch.isfinite(a).all())
                and torch.allclose(a, b, rtol=E_RTOL, atol=E_G_ATOL_REL * scale)):
            raise RuntimeError(f"refine energy gradient B{B}/L{L} ({k}): max abs err "
                               f"{float((a - b).abs().max()):.3e}, max|g| {scale:.3e}")
        g_rel = max(g_rel, float((a - b).abs().max()) / scale)
    log(f"[refine] energy + gradient B{B}/L{L}, clash through kernels 3-4 vs plain: "
        f"energy {float(ek):.6f} vs {float(ep):.6f} (rel err {e_err:.2e}, rtol {E_RTOL}); "
        f"gradient max err / max|g| {g_rel:.2e} (rtol {E_RTOL}, atol {E_G_ATOL_REL} max|g|)")
    return g_rel


@contextlib.contextmanager
def _eager_loops():
    """Run the refiners' Adam loops eagerly, also on the card, inside the
    block (``adam_descent`` with ``graph=False``)."""
    import functools

    from protein_ensemble_vae_torch.infer import refine as R
    from protein_ensemble_vae_torch.infer import torsion_refine as T

    orig = R.adam_descent
    R.adam_descent = T.adam_descent = functools.partial(orig, graph=False)
    try:
        yield
    finally:
        R.adam_descent = T.adam_descent = orig


def _refine_loop_gate(B: int, L: int, n, ca, c, mask) -> float:
    """LOOP_STEPS steps of the polish Cartesian loop replayed from a CUDA
    graph against the same loop run eagerly on the card: within LOOP_ATOL,
    finite, padded rows bitwise equal to the input."""
    import torch

    from protein_ensemble_vae_torch.infer import refine as R
    from protein_ensemble_vae_torch.infer.generate import POLISH_CARTESIAN

    def run():
        return torch.stack(R._refine(n, ca, c, mask, _polish_weights(), POLISH_CARTESIAN["lr"],
                                     steps=LOOP_STEPS, lr_decay=True, rama_on=True,
                                     vdw_on=True))

    x0 = torch.stack((n, ca, c))
    got = run()
    with _eager_loops():
        want = run()
    err, moved = float((got - want).abs().max()), float((got - x0).abs().max())
    pad = mask == 0
    if not bool(torch.isfinite(got).all()) or err > LOOP_ATOL:
        raise RuntimeError(f"refine loop B{B}/L{L}: graph vs eager max abs err {err:.3e} A")
    if not torch.equal(got[:, pad], x0[:, pad]):
        raise RuntimeError(f"refine loop B{B}/L{L}: padded rows moved")
    log(f"[refine] {LOOP_STEPS} Adam steps B{B}/L{L} from a CUDA graph vs eager on the "
        f"card: max abs err {err:.3e} A (atol {LOOP_ATOL}); atoms moved up to "
        f"{moved:.3f} A; {int(pad.sum())} padded rows bitwise unchanged")
    return err


def _nerf_gate(B: int, L: int, n, ca, c, mask) -> float:
    """The torsion refiner's rebuild (a prefix product of rigid transforms,
    fp32 in and out, float64 inside) against the sequential plain build in
    float64 from the same torsions and seed: within NERF_ATOL."""
    import torch

    from protein_ensemble_vae_torch.infer.torsion_refine import (
        ideal_seed_frame, nerf_rebuild, nerf_rebuild_reference,
        torsions_from_coords)

    tors = torsions_from_coords(n, ca, c, mask)
    seed = ideal_seed_frame(n[:, 0], ca[:, 0], c[:, 0])
    got = torch.stack(nerf_rebuild(*tors, *seed)).double()
    want = torch.stack(nerf_rebuild_reference(*(t.double() for t in tors + seed)))
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > NERF_ATOL:
        raise RuntimeError(f"NeRF rebuild B{B}/L{L}: max abs err {err:.3e} A from the "
                           f"float64 sequential build")
    log(f"[refine] NeRF rebuild B{B}/L{L}, prefix product (fp32 out) vs the sequential "
        f"build in float64: max abs err {err:.3e} A (atol {NERF_ATOL})")
    return err


def _refine_split(B: int, L: int, n, ca, c, mask, trace_path) -> dict:
    """One profiled call of each refine stage (PROFILE_STEPS steps replayed
    from its CUDA graph, captured before the profiler starts) at the polish
    settings: device busy share and device ms per step; the Cartesian
    stage's records must hold exactly one kernel 3 and one kernel 4 per
    replayed step. Then the device us of the clash term and of the dense
    vdW term (forward + gradient, replayed from a CUDA graph) against a
    step."""
    import torch

    from protein_ensemble_vae_torch.infer.generate import POLISH_CARTESIAN
    from protein_ensemble_vae_torch.infer.refine import refine_backbone
    from protein_ensemble_vae_torch.infer.torsion_refine import refine_torsions
    from protein_ensemble_vae_torch.losses import vdw_clash_loss, vdw_pair_tables
    from protein_ensemble_vae_torch.ops.kernels.clash import clash_loss_kernel

    runs = {"cartesian": lambda: refine_backbone(
                n, ca, c, mask, **dict(POLISH_CARTESIAN, steps=PROFILE_STEPS)),
            "torsion": lambda: refine_torsions(
                n, ca, c, mask, **dict(_torsion_stage_kwargs(), steps=PROFILE_STEPS))}
    out = {}
    for stage, run in runs.items():
        run()                                 # captures the step's graph
        trace = trace_path and trace_path.replace(".json", f".refine_{stage}.json")
        want = PROFILE_STEPS if stage == "cartesian" else 0
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            prof = _profile(run, f"refine {stage} stage B{B}/L{L}, {PROFILE_STEPS} steps "
                            f"replayed from a CUDA graph (profiled call {attempt})", trace)
            seen = {k: sum(f"{k}_kernel" in name for name in prof["names"])
                    for k in ("clash_fwd", "clash_bwd")}
            log(f"[refine] {stage} stage: the profiler recorded {seen} clash kernels over "
                f"{PROFILE_STEPS} replayed steps (expected {want} each), "
                f"{len(prof['names'])} device events")
            if max(seen.values()) > want:
                raise RuntimeError(f"refine {stage} stage issued clash kernels {seen}, "
                                   f"expected {want} of each")
            if seen == {"clash_fwd": want, "clash_bwd": want}:
                break
        else:
            raise RuntimeError(f"the profiler did not record {want} of each clash kernel "
                               f"in {PROFILE_ATTEMPTS} profiled calls of the {stage} stage")
        out[stage] = dict(busy_share=prof["busy_share"],
                          step_ms=prof["wall_ms"] * prof["busy_share"] / PROFILE_STEPS)
    xs = [t.clone().requires_grad_(True) for t in (n, ca, c)]
    # the pair tables, as the refiners build them once per call
    tabs = {o: vdw_pair_tables(L, o, device=n.device) for o in (False, True)}
    terms = {"clash (kernels 3-4)": lambda: clash_loss_kernel(*xs, mask),
             "vdW N/CA/C": lambda: vdw_clash_loss(*xs, mask, tables=tabs[False]),
             "vdW N/CA/C/O": lambda: vdw_clash_loss(*xs, mask, include_o=True,
                                                    tables=tabs[True])}
    for name, term in terms.items():
        us = _graph_us(lambda: torch.autograd.grad(term(), xs), n=10)
        stage = "torsion" if name.endswith("/O") else "cartesian"
        out[name] = us
        log(f"[refine] {name} forward + gradient B{B}/L{L}: {us:.1f} us from a CUDA "
            f"graph = {0.1 * us / out[stage]['step_ms']:.1f}% of a {stage} step's "
            f"{out[stage]['step_ms']:.3f} device ms")
    return out


def refine_gates(trace_path=None) -> dict:
    """Refinement's checks at REFINE_SHAPES, made before its main path and
    counted apart from it: the energy with kernels 3-4 against the plain
    clash (both shapes), the Adam loop from a CUDA graph against the eager
    loop (B10/L256), the profiled stages and the split of a step
    (B10/L640). Drops the graphs it captured."""
    import torch

    from protein_ensemble_vae_torch.infer.refine import clear_graphs

    out = {}
    for B, L in REFINE_SHAPES:
        bb = _clash_inputs(B, L)
        out[f"B{B}/L{L}"] = dict(grad_rel_err=_refine_energy_gate(B, L, *bb))
        if L == 256:
            out["loop_err"] = _refine_loop_gate(B, L, *bb)
        else:
            out["nerf_err"] = _nerf_gate(B, L, *bb)
            out["split"] = _refine_split(B, L, *bb, trace_path)
    clear_graphs()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _recording_stages(calls: list):
    """Let ``generate_ensembles`` call the refiners through wrappers that
    keep each stage's input and output (what runs is unchanged)."""
    import torch

    from protein_ensemble_vae_torch.infer import generate as G

    orig = {"refine_backbone": G.refine_backbone, "refine_torsions": G.refine_torsions}

    def wrap(stage, fn):
        def run(n, ca, c, mask, **kw):
            out = fn(n, ca, c, mask, **kw)
            calls.append(dict(stage=stage, inp=torch.stack((n, ca, c)), mask=mask.clone(),
                              out=torch.stack(out)))
            return out
        return run

    G.refine_backbone = wrap("cartesian", orig["refine_backbone"])
    G.refine_torsions = wrap("torsion", orig["refine_torsions"])
    try:
        yield
    finally:
        for k, fn in orig.items():
            setattr(G, k, fn)


def _check_stage(call: dict) -> str:
    """A refine stage's output: finite, padded rows bitwise equal to its
    input; after the torsion stage N-CA, CA-C and C-N within BOND_ATOL of
    config.BOND_*. Returns a line for the log."""
    import torch

    from protein_ensemble_vae_torch.config import BOND_C_N, BOND_CA_C, BOND_N_CA

    x, x0, m = call["out"], call["inp"], call["mask"] > 0.5
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"{call['stage']} stage: non-finite coordinates")
    if not torch.equal(x[:, ~m], x0[:, ~m]):
        raise RuntimeError(f"{call['stage']} stage: padded rows differ from the input")
    line = f"finite, {int((~m).sum())} padded rows bitwise unchanged"
    if call["stage"] == "torsion":
        n, ca, c = x.double()
        errs = {"N-CA": ((ca - n).norm(dim=-1) - BOND_N_CA)[m],
                "CA-C": ((c - ca).norm(dim=-1) - BOND_CA_C)[m],
                "C-N": ((n[:, 1:] - c[:, :-1]).norm(dim=-1) - BOND_C_N)[m[:, 1:] & m[:, :-1]]}
        worst = {k: float(v.abs().max()) for k, v in errs.items()}
        if max(worst.values()) > BOND_ATOL:
            raise RuntimeError(f"torsion stage bonds off config.BOND_*: {worst}")
        line += "; bonds off config.BOND_* by " + ", ".join(
            f"{k} {v:.2e}" for k, v in worst.items()) + f" A (atol {BOND_ATOL})"
    return line


def _quality(x, mask) -> dict:
    """Gate passes, mean clash_score and mean molprobity_clashscore (carbonyl
    O placed) over the samples of one structure [3, B, L, 3], host numpy."""
    from protein_ensemble_vae_torch.eval.analyze import (clash_score,
                                                         molprobity_clashscore)
    from protein_ensemble_vae_torch.infer.gate import validate_protein_geometry
    from protein_ensemble_vae_torch.infer.pdb_io import compute_backbone_oxygen

    n, ca, c = x.double().cpu().numpy()
    m = mask.cpu().numpy()
    B = ca.shape[0]
    return dict(
        gate=sum(validate_protein_geometry(ca[k], m[k])[0] for k in range(B)),
        clash=float(np.mean([clash_score(n[k], ca[k], c[k], m[k]) for k in range(B)])),
        mp_clash=float(np.mean([molprobity_clashscore(
            n[k], ca[k], c[k], compute_backbone_oxygen(n[k], ca[k], c[k], m[k]), m[k])
            for k in range(B)])))


def phase_refine_path(model, views, out_dir: str, plain_seconds: list) -> dict:
    """The refine main path: ``generate_ensembles`` with REFINE on both
    proteins, then ``cli.refine`` (CLI_REFINE_STEPS steps) on the first
    one's ensemble; a first pass captures every step's CUDA graph, uncounted.
    Counts reset just before the second pass and read just after: per
    structure 16 band-forward launches and POLISH_CARTESIAN steps of kernels
    3-4, plus CLI_REFINE_STEPS from the CLI. Then cli.analyze and
    cli.validate score the files on the card."""
    import torch

    from protein_ensemble_vae_torch.cli import analyze as analyze_cli
    from protein_ensemble_vae_torch.cli import refine as refine_cli
    from protein_ensemble_vae_torch.cli import validate as validate_cli
    from protein_ensemble_vae_torch.infer.generate import (POLISH_CARTESIAN,
                                                           generate_ensembles)
    from protein_ensemble_vae_torch.ops.kernels import LAUNCHES, reset_launches

    def run_cli(ens: str, dest: str, profiled: bool):
        """cli.refine on ``ens``: its seconds and, when ``profiled`` (under
        torch.profiler, device activity only), the clash kernels' records
        and how many of the window's PROFILER_MARKERS empty kernels were
        recorded. The window opens with those markers and a synchronise,
        as ``_device_kernels``' windows do: CUPTI has dropped a window's
        first records."""
        from torch.profiler import ProfilerActivity, profile

        from protein_ensemble_vae_torch.ops.kernels.clash import clash_noop

        argv = ["--input", ens, "--output", os.path.join(dest, "refined_cli.pdb"),
                "--steps", str(CLI_REFINE_STEPS), "--device", DEVICE]
        with (profile(activities=[ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof:
            if profiled:
                for _ in range(PROFILER_MARKERS):
                    clash_noop()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            refine_cli.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        if not profiled:
            return secs, None, None
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        seen = {k: sum(f"{k}_kernel" in e.name for e in events)
                for k in ("clash_fwd", "clash_bwd")}
        marks = sum("clash_noop" in e.name for e in events)
        if min(seen.values()) < CLI_REFINE_STEPS:
            # where the records fall short: the steps whose kernel-4 record
            # has no kernel-3 record before it, and the device kernels by name
            order = ["f" if "clash_fwd_kernel" in e.name else "b" for e in events
                     if "clash_fwd_kernel" in e.name or "clash_bwd_kernel" in e.name]
            gaps = [i for i, k in enumerate(order) if k == "b" and (i == 0 or order[i - 1] == "b")]
            names: dict = {}
            for e in events:
                names[e.name[:60]] = names.get(e.name[:60], 0) + 1
            log(f"[refine] profiler records short: kernel-4 records without a kernel-3 "
                f"record before them at clash records {gaps} of {len(order)}; "
                f"{len(events)} device records by name: {sorted(names.items())}")
        return secs, seen, marks

    def run(dest: str, verbose: bool, profiled: bool):
        secs, results = [], []
        for view in views:
            t0 = time.perf_counter()
            out = generate_ensembles(model, view, dest, num_samples=NUM_SAMPLES, seed=SEED,
                                     buckets=BUCKETS, verbose=verbose, **REFINE)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            results += out["results"]
        ens = os.path.join(dest, f"{results[0]['structure']}_ensemble.pdb")
        return (results, secs, ens) + run_cli(ens, dest, profiled)

    t0 = time.perf_counter()
    run(os.path.join(out_dir, "refine_first"), verbose=False, profiled=False)
    first = time.perf_counter() - t0
    dest = os.path.join(out_dir, "refine")
    calls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with _recording_stages(calls):
        results, secs, ens, cli_secs, seen, marks = run(dest, verbose=True, profiled=True)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()

    n_clash = POLISH_CARTESIAN["steps"] * len(views) + CLI_REFINE_STEPS
    want, _ = _served({"egnn_band_fwd": len(views) * 2 * model.config.decoder_layers,
                       "clash_fwd": n_clash, "clash_bwd": n_clash})
    log(f"[refine] launches {launches} (expected {want}; each replayed graph adds the "
        f"launches its capture made)")
    if launches != want:
        raise RuntimeError(f"refine path launched {launches}, expected {want}")
    # The replays as the device saw them: the profiler's records of the
    # counted cli.refine call, one Cartesian stage of CLI_REFINE_STEPS
    # replays, must hold CLI_REFINE_STEPS of each clash kernel. More fails
    # at once. CUPTI has dropped a record (one of 20, PR 5 run 3), so a
    # call short of records is profiled again, uncounted, up to
    # PROFILE_ATTEMPTS calls in all.
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        log(f"[refine] cli.refine ({CLI_REFINE_STEPS} steps replayed from a CUDA graph, "
            f"{'the counted call' if attempt == 1 else 'profiled again, uncounted'}): the "
            f"profiler recorded {seen} clash kernels (expected {CLI_REFINE_STEPS} each) "
            f"and {marks} of the {PROFILER_MARKERS} marker kernels that opened its window")
        if max(seen.values()) > CLI_REFINE_STEPS:
            raise RuntimeError(f"cli.refine issued clash kernels {seen}, expected "
                               f"{CLI_REFINE_STEPS} of each")
        if min(seen.values()) == CLI_REFINE_STEPS:
            break
        if attempt < PROFILE_ATTEMPTS:
            seen, marks = run_cli(ens, os.path.join(out_dir, "refine_first"), profiled=True)[1:]
    else:
        raise RuntimeError(f"the profiler did not record {CLI_REFINE_STEPS} of each clash "
                           f"kernel in {PROFILE_ATTEMPTS} profiled calls of cli.refine")
    if [c["stage"] for c in calls] != ["cartesian", "torsion"] * len(views):
        raise RuntimeError(f"refine stages ran as {[c['stage'] for c in calls]}")
    for k, call in enumerate(calls):
        log(f"[refine] {results[k // 2]['structure']} {call['stage']} stage: "
            f"{_check_stage(call)}")
    for k, (r, (pid, L, _)) in enumerate(zip(results, PROTEINS)):
        st = r["refine_seconds"]
        before = _quality(calls[2 * k]["inp"], calls[2 * k]["mask"])
        after = _quality(calls[2 * k + 1]["out"], calls[2 * k + 1]["mask"])
        log(f"[refine] {r['structure']} L={L}: {secs[k]:.3f} s per structure with polish "
            f"refinement ({plain_seconds[k]:.3f} s without; host clock, synchronised): "
            f"Cartesian stage {st['cartesian']:.3f} s ({POLISH_CARTESIAN['steps']} steps), "
            f"torsion stage {st['torsion']:.3f} s ({REFINE['refine_steps']} steps); "
            f"before -> after: gate {before['gate']} -> {after['gate']}/{NUM_SAMPLES}, "
            f"clash_score {before['clash']:.1f} -> {after['clash']:.1f}, "
            f"molprobity_clashscore {before['mp_clash']:.1f} -> {after['mp_clash']:.1f} "
            f"(random weights: the numbers only show the path)")
    log(f"[refine] cli.refine ({CLI_REFINE_STEPS} steps, under the profiler) "
        f"{cli_secs:.3f} s; first pass "
        f"(graph captures included) {first:.3f} s; peak device memory "
        f"{peak / 2**20:.1f} MiB allocated (torch.cuda.max_memory_allocated), "
        f"{reserved / 2**20:.1f} MiB reserved (max_memory_reserved: with the "
        f"captured graphs' pools)")
    for cli, argv in ((analyze_cli, ["--pdb_dir", dest]),
                      (validate_cli, ["--ensemble", os.path.join(dest, "refined_cli.pdb")])):
        t0 = time.perf_counter()
        cli.main(argv + ["--device", DEVICE])
        log(f"[refine] {cli.__name__.rsplit('.', 1)[1]} CLI on the card: "
            f"{time.perf_counter() - t0:.3f} s")
    if not os.path.exists(os.path.join(dest, "analysis_report.txt")):
        raise RuntimeError("cli.analyze wrote no report")
    return dict(launches=launches, seconds=secs, cli_seconds=cli_secs, peak=peak,
                reserved=reserved, stages=[r["refine_seconds"] for r in results],
                cli_records=dict(seen, profiled_calls=attempt))


# ---------------------------------------------------------------------------
# 8. parallelism
# ---------------------------------------------------------------------------

# The B4/L256 fp32 train step at the default widths (2 rows per dp rank),
# at the train CLI's default learning rate
PARALLEL_B, PARALLEL_L = 4, 256
PARALLEL_CONSTS = (0.5, 0.25, 3e-5)
PARALLEL_WAIT_S = 600.0     # each launch's bound: a hung rank fails the run


def _parallel_batch(seqemb_dim: int, B: int = PARALLEL_B) -> dict:
    """B x L256 as arrays: row r pairs conformers r -> r + 1 of a NeRF fold
    of TRAIN_PROTEIN's length and seed, its target mask cut to 230 - 20 r
    residues, so the dp ranks hold different normalisers."""
    from protein_ensemble_vae_torch.data.collate import PairBatch, pad_conformers
    from protein_ensemble_vae_torch.data.dataset import process_conformer
    from protein_ensemble_vae_torch.train.training import batch_to_arrays

    pid, L_real, seed, _ = TRAIN_PROTEIN
    items = [process_conformer(c)
             for c in _nerf_conformers(pid, L_real, seed, B + 1, seqemb_dim)]
    arrays = batch_to_arrays(
        PairBatch(inp=pad_conformers(items[:B], PARALLEL_L, seqemb_dim),
                  tgt=pad_conformers(items[1:B + 1], PARALLEL_L, seqemb_dim)), seqemb_dim)
    for r in range(B):
        arrays["tgt"]["mask"][r, L_real - 20 * r:L_real] = 0.0
    return arrays


def _mu_leaves(flat, names: list, params: dict) -> dict:
    """``TrainState``'s flat ``mu`` as one vector per parameter (each
    padded to 4 entries in the flat layout)."""
    out, off = {}, 0
    for n in names:
        k = params[n].size
        out[n] = flat[off:off + k]
        off += -(-k // 4) * 4
    return out


def _parity(tag: str, ranks: list, ref: dict, want: dict, backend: str) -> dict:
    """Every rank launched ``want`` over ``backend`` and reports the same
    loss; the loss is within rtol 1e-5 of the single-process step's, and
    Adam's mu after the step (0.1 x the clipped gradient) is, leaf by leaf,
    within 1e-3 of that leaf's max |mu| plus 1e-5 of the global max |mu|,
    so a leaf with a small gradient is held to its own scale. The updated
    parameters are held to the JAX package's bound (tests/test_parallel.py,
    atol 1e-4) as well, but Adam's first step moves an entry by at most
    ~lr (3e-5 here), so only a non-finite or missing update fails that
    bound: the gradient is checked through mu."""
    for r in ranks:
        if r["launches"] != want or r["backend"] != backend or r["loss"] != ranks[0]["loss"]:
            raise RuntimeError(f"{tag}: rank {r['rank']} launched {r['launches']} (expected "
                               f"{want}) over {r['backend']} (expected {backend}), loss "
                               f"{r['loss']!r} (rank 0: {ranks[0]['loss']!r})")
    loss, loss_1 = ranks[0]["loss"], ref["loss"]
    rel = abs(loss - loss_1) / abs(loss_1)
    p_err = max(float(np.abs(ranks[0]["params"][k] - v).max())
                for k, v in ref["params"].items())
    got_mu, want_mu = (_mu_leaves(m, ref["names"], ref["params"])
                       for m in (ranks[0]["mu"], ref["mu"]))
    floor = 1e-5 * float(np.abs(ref["mu"]).max())
    mu_ratio, mu_leaf = max(
        (float(np.abs(got_mu[n] - w).max()) / (1e-3 * float(np.abs(w).max()) + floor), n)
        for n, w in want_mu.items())
    mu_err = float(np.abs(ranks[0]["mu"] - ref["mu"]).max() / np.abs(ref["mu"]).max())
    log(f"[parallel] {tag}: loss {loss:.6f} vs single-process {loss_1:.6f} (rel "
        f"{rel:.2e}, rtol 1e-5); mu leaf by leaf at worst {mu_ratio:.3f} of its bound "
        f"({mu_leaf}; max |diff| / max |mu| over all {mu_err:.2e}); updated parameters "
        f"max |diff| {p_err:.2e} (atol 1e-4); launches per rank "
        f"{[r['launches'] for r in ranks]} over {backend} on {[r['device'] for r in ranks]}")
    if not (np.isfinite(loss) and rel <= 1e-5 and p_err <= 1e-4 and mu_ratio <= 1.0):
        raise RuntimeError(f"{tag}: the sharded step is not the single-process step")
    return dict(loss=loss, single_loss=loss_1, loss_rel=rel, param_err=p_err, mu_err=mu_err,
                mu_leaf_ratio=mu_ratio, mu_worst_leaf=mu_leaf)


def _parallel_cli(out_dir: str) -> dict:
    """``cli.train --dp 2`` for one epoch at the default widths, batch 4, on
    TRAIN_PROTEIN's H5 files (``_pair_manifests``; each rank reads them
    through ``EnsembleDataset``), then the single-process ``cli.generate``
    on its checkpoint from the validation manifest."""
    import torch

    from protein_ensemble_vae_torch.cli import generate as gen_cli
    from protein_ensemble_vae_torch.cli import train as train_cli
    from protein_ensemble_vae_torch.config import ModelConfig
    from protein_ensemble_vae_torch.models import HierCVAE

    cfg = ModelConfig()
    train_csv, val_csv = _pair_manifests(out_dir, TRAIN_PROTEIN, cfg.seqemb_dim)
    save = os.path.join(out_dir, "train_cli_dp2")
    argv = ["--manifest_train", train_csv, "--manifest_val", val_csv, "--use_seqemb",
            "--epochs", "1", "--batch_size", "4", "--dp", "2", "--save", save,
            "--device", DEVICE]
    t0 = time.perf_counter()
    train_cli.main(argv, timeout_s=PARALLEL_WAIT_S)
    secs = time.perf_counter() - t0
    final = os.path.join(save, "final")
    with open(os.path.join(final, "history.json")) as f:
        history = json.load(f)
    for split in ("train", "val"):
        for k, vals in history[split].items():
            if len(vals) != 1 or not np.isfinite(vals).all():
                raise RuntimeError(f"cli.train --dp 2 {split} {k}: {vals}")
    saved = torch.load(os.path.join(final, "state.pt"), weights_only=True)["model"]
    full = {k: v.shape for k, v in HierCVAE(cfg).state_dict().items()}
    if {k: v.shape for k, v in saved.items()} != full:
        raise RuntimeError("cli.train --dp 2 checkpoint does not hold the full parameters")
    gen_dir = os.path.join(out_dir, "generate_dp2")
    gen_cli.main(["--checkpoint", final, "--manifest", val_csv, "--output_dir",
                  gen_dir, "--num_samples", "2", "--max_structures", "1",
                  "--device", DEVICE])
    pdbs = sorted(f for f in os.listdir(gen_dir) if f.endswith(".pdb"))
    if not any(f.endswith("_ensemble.pdb") for f in pdbs):
        raise RuntimeError(f"cli.generate on the dp=2 checkpoint wrote {pdbs}")
    log(f"[parallel] cli.train --dp 2, 1 epoch: {secs:.2f} s (2 ranks launched, set-up "
        f"included; host clock); train loss {history['train']['loss'][0]:.3f}, val loss "
        f"{history['val']['loss'][0]:.3f}; full checkpoint {final}; single-process "
        f"cli.generate wrote {pdbs}")
    return dict(seconds=secs, history=history)


def phase_parallel(out_dir: str, card: str) -> dict:
    """``parallel/dryrun.py``'s rank worker at the default widths: (a) dp = 2
    (two ranks on the card; kernels 1-4 in each) and one world-size-1 NCCL
    step, (b) tp = 2 on the plain path, each against the single-process step
    on the same weights and batch, (c) ``cli.train --dp 2``, (d) the steps'
    times. Launch counts are reset just before each rank's checked step and
    read just after."""
    import torch

    from protein_ensemble_vae_torch.config import ModelConfig
    from protein_ensemble_vae_torch.parallel.dryrun import parity_step, single_step
    from protein_ensemble_vae_torch.parallel.mesh import launch

    cfg = ModelConfig()
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    spec = dict(model=dataclasses.asdict(cfg), seed=SEED, rng=0, consts=PARALLEL_CONSTS,
                dp=2, tp=1, device=DEVICE, batch=_parallel_batch(cfg.seqemb_dim),
                warmup=STEP_WARMUP, reps=STEP_REPS)
    want, _ = _served({"egnn_band_fwd": cfg.decoder_layers,
                       "egnn_band_bwd": cfg.decoder_layers, "clash_fwd": 1, "clash_bwd": 1})

    def ranks(n, s):
        return launch(parity_step, n, (s,), device=DEVICE, timeout_s=PARALLEL_WAIT_S)

    ref = single_step(spec)
    torch.cuda.empty_cache()
    if ref["launches"] != want:
        raise RuntimeError(f"single-process step launched {ref['launches']}, expected {want}")
    dp = ranks(2, spec)
    checks = {"dp2": _parity("dp=2", dp, ref, want, backend)}
    nccl = ranks(1, dict(spec, dp=1, warmup=0, reps=0))
    checks["nccl_world1"] = _parity("world-size-1 NCCL group", nccl, ref, want, "nccl")
    plain = dict(spec, model=dict(spec["model"], use_pallas_egnn=False), dp=1, tp=2)
    ref_tp = single_step(plain)
    torch.cuda.empty_cache()
    tp = ranks(2, plain)
    checks["tp2"] = _parity("tp=2 (plain path)", tp, ref_tp, {k: 0 for k in want}, backend)
    cli = _parallel_cli(out_dir)

    med = lambda xs: float(np.median(xs))  # noqa: E731
    times = dict(single_ms=med(ref["step_ms"]), dp2_ms=med(dp[0]["step_ms"]),
                 dp2_rank_ms=[med(r["step_ms"]) for r in dp],
                 dp2_allreduce_ms=med(dp[0]["allreduce_ms"]),
                 single_plain_ms=med(ref_tp["step_ms"]), tp2_ms=med(tp[0]["step_ms"]),
                 tp2_rank_ms=[med(r["step_ms"]) for r in tp])
    log(f"[parallel] times ({card}; CUDA events, median of {STEP_REPS} after "
        f"{STEP_WARMUP} warm-ups; two ranks share one card over gloo, which stages "
        f"every collective through the host: a record of cost, not a scaling figure): "
        f"B4/L256 fp32 train step single-process {times['single_ms']:.2f} ms, dp=2 "
        f"{times['dp2_ms']:.2f} ms (ranks {[round(t, 2) for t in times['dp2_rank_ms']]}; "
        f"its all-reduce of the flat gradient + metrics alone {times['dp2_allreduce_ms']:.2f} "
        f"ms); plain path single-process {times['single_plain_ms']:.2f} ms, tp=2 "
        f"{times['tp2_ms']:.2f} ms (ranks {[round(t, 2) for t in times['tp2_rank_ms']]})")
    return dict(launches={k: sum(r["launches"][k] for r in dp) for k in want},
                launches_by_rank=[r["launches"] for r in dp], checks=checks, times=times,
                cli_seconds=cli["seconds"])


# ---------------------------------------------------------------------------
# profile
# ---------------------------------------------------------------------------

def _profile(run_once, label: str, trace_path, active: int = 1, table: bool = True) -> dict:
    """torch.profiler over ``active`` calls of ``run_once`` after one warm-up
    call: device busy share (union of device intervals over the wall time),
    the top operators by device time (logged if ``table``), and the Chrome
    trace at ``trace_path`` (none if it is falsy). Returns the busy share,
    the busy ms per call and the device events' names in time order."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sched = torch.profiler.schedule(wait=0, warmup=1, active=active, repeat=1)
    wall_ms = 0.0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched) as prof:
        for k in range(1 + active):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_once()
            torch.cuda.synchronize()
            if k:
                wall_ms += 1e3 * (time.perf_counter() - t0)
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
    log(f"[profile] {label} x{active}: wall {wall_ms:.1f} ms (profiled), "
        f"device busy {busy / 1e3:.1f} ms = {100 * busy / 1e3 / wall_ms:.1f}% "
        f"(idle {100 - 100 * busy / 1e3 / wall_ms:.1f}%), {len(events)} device events")
    if table:
        log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=18))
    if trace_path:
        os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
        prof.export_chrome_trace(trace_path)
    us_by_kind: dict[str, float] = {}
    us_by_kernel: dict[str, float] = {}   # the port's own kernels, by function name
    for e in events:
        kind = next((k for k, words in DEVICE_KINDS if any(w in e.name.lower() for w in words)),
                    "other")
        us_by_kind[kind] = us_by_kind.get(kind, 0.0) + e.time_range.elapsed_us() / active
        own = re.search(r"((?:egnn|clash)_\w+)", e.name)
        if own:
            us_by_kernel[own.group(1)] = (us_by_kernel.get(own.group(1), 0.0)
                                          + e.time_range.elapsed_us() / active)
    if us_by_kernel:
        log(f"[profile] {label}: device us per call of the port's kernels "
            f"{json.dumps({k: round(v, 1) for k, v in us_by_kernel.items()})}")
    return dict(busy_share=busy / 1e3 / wall_ms, busy_ms=busy / 1e3 / active, wall_ms=wall_ms,
                us_by_kind=us_by_kind, us_by_kernel=us_by_kernel,
                names=[e.name for e in sorted(events, key=lambda e: e.time_range.start)])


# Device kernels by kind (the first whose words a kernel's name holds).
DEVICE_KINDS = (("gemm", ("gemm", "cutlass", "sm90_xmma", "ampere_", "gemv")),
                ("softmax", ("softmax",)), ("layer_norm", ("layer_norm", "layernorm")),
                ("copy", ("memcpy", "memset", "copy")))


def profile_generation(model, views, out_dir: str, trace_path: str) -> None:
    from protein_ensemble_vae_torch.infer.generate import generate_ensembles

    def run_once():
        for view in views:
            generate_ensembles(model, view, os.path.join(out_dir, "profile"),
                               num_samples=NUM_SAMPLES, seed=SEED,
                               buckets=BUCKETS, verbose=False)

    _profile(run_once, f"generation, {len(views)} structures", trace_path)


KERNEL_INFO = {
    "egnn_band_fwd_sm90": ("protein_ensemble_vae_torch/csrc/egnn_band_fwd_sm90.cu",
                           "protein_ensemble_vae_tpu/ops/pallas/egnn_band.py:107"),
    "egnn_band_bwd_sm90": ("protein_ensemble_vae_torch/csrc/egnn_band_bwd_sm90.cu",
                           "protein_ensemble_vae_tpu/ops/pallas/egnn_band.py:235"),
    "egnn_band_fwd_sm90_hd512": ("protein_ensemble_vae_torch/csrc/egnn_band_fwd_sm90_hd512.cu",
                                 "protein_ensemble_vae_tpu/ops/pallas/egnn_band.py:107"),
    "egnn_band_bwd_sm90_hd512": ("protein_ensemble_vae_torch/csrc/egnn_band_bwd_sm90_hd512.cu",
                                 "protein_ensemble_vae_tpu/ops/pallas/egnn_band.py:235"),
    "egnn_band_fwd_sm90_x3": ("protein_ensemble_vae_torch/csrc/egnn_band_fwd_sm90_hd512.cu",
                              "protein_ensemble_vae_tpu/ops/pallas/egnn_band.py:107"),
    "egnn_band_bwd_sm90_x3": ("protein_ensemble_vae_torch/csrc/egnn_band_bwd_sm90_hd512.cu",
                              "protein_ensemble_vae_tpu/ops/pallas/egnn_band.py:235"),
    "egnn_band_fwd_sm90_wide": ("protein_ensemble_vae_torch/csrc/egnn_band_fwd_sm90_wide.cu",
                                "protein_ensemble_vae_tpu/ops/pallas/egnn_band.py:107"),
    "egnn_band_bwd_sm90_wide": ("protein_ensemble_vae_torch/csrc/egnn_band_bwd_sm90_wide.cu",
                                "protein_ensemble_vae_tpu/ops/pallas/egnn_band.py:235"),
    "clash_fwd": ("protein_ensemble_vae_torch/csrc/clash.cu",
                  "protein_ensemble_vae_tpu/ops/pallas/clash.py:54"),
    "clash_bwd": ("protein_ensemble_vae_torch/csrc/clash.cu",
                  "protein_ensemble_vae_tpu/ops/pallas/clash.py:79"),
}

# The paths on which each kernel must have launched: the Hopper kernels above
# 512 both fp32-chain modes (the wide_decoder path's width-1024 CLI epoch)
# and the bf16 chain at 1024 (chain_dtype_ab); the one-pass Hopper kernels
# the bf16 model's one-pass mode up to Hd 256 (train_bf16, the flagship's
# training) and the bf16 chain at 256 (chain_dtype_ab); the fp32 model's
# 3xTF32 mode up to Hd 256 (the _x3 counters of the shared-tile kernels:
# generation, dataprep, refine, the fp32 training paths, the flagship's
# generation and the wide_decoder path's width-16 CLI epoch); at Hd 512
# both fp32-chain modes (the wide_decoder path: its generation, fp32 and
# bf16 steps and its width-384 CLI epoch, each checked there) and the bf16
# chain (chain_dtype_ab); kernels 3-4 every path with a loss. The mma.sync
# kernels (egnn_band_fwd / egnn_band_bwd) serve no mode: their counters must
# stay at 0 on every path (MMA_SYNC_KERNELS).
REQUIRED_PATHS = {
    "egnn_band_fwd_sm90": ("train_bf16", "flagship", "chain_dtype_ab"),
    "egnn_band_bwd_sm90": ("train_bf16", "flagship", "chain_dtype_ab"),
    "egnn_band_fwd_sm90_hd512": ("wide_decoder", "chain_dtype_ab"),
    "egnn_band_bwd_sm90_hd512": ("wide_decoder", "chain_dtype_ab"),
    "egnn_band_fwd_sm90_x3": ("generate", "dataprep", "refine", "train", "train_watch",
                              "train_dp", "wide_decoder", "flagship"),
    "egnn_band_bwd_sm90_x3": ("train", "train_watch", "train_dp", "wide_decoder"),
    "egnn_band_fwd_sm90_wide": ("wide_decoder", "chain_dtype_ab"),
    "egnn_band_bwd_sm90_wide": ("wide_decoder", "chain_dtype_ab"),
    "clash_fwd": ("refine", "train", "train_bf16", "train_watch", "train_dp", "wide_decoder",
                  "flagship"),
    "clash_bwd": ("refine", "train", "train_bf16", "train_watch", "train_dp", "wide_decoder",
                  "flagship"),
}
MMA_SYNC_KERNELS = ("egnn_band_fwd", "egnn_band_bwd")
# the row each kernel's line reports (shape, mode, width): the flagship's
# B8/L128 in the bf16 model's mode for the one-pass Hopper kernels, the
# train step's B4/L256 in fp32 at Hd 512 for those of width 512 and at
# WIDER_CLI_HD for those above it, the fp32 headline shapes for the 3xTF32
# ones (each line's shapes list the bf16 chain's rows too)
KERNEL_HEAD = {"egnn_band_fwd_sm90_x3": (HEADLINE_SHAPE, FP32_MODE, HD),
               "egnn_band_bwd_sm90_x3": (TRAIN_HEADLINE, FP32_MODE, HD),
               "egnn_band_fwd_sm90": ((8, 128), BF16_MODE, HD),
               "egnn_band_bwd_sm90": ((8, 128), BF16_MODE, HD),
               "egnn_band_fwd_sm90_hd512": (TRAIN_HEADLINE, FP32_MODE, WIDE_HD),
               "egnn_band_bwd_sm90_hd512": (TRAIN_HEADLINE, FP32_MODE, WIDE_HD),
               "egnn_band_fwd_sm90_wide": (TRAIN_HEADLINE, FP32_MODE, WIDER_CLI_HD),
               "egnn_band_bwd_sm90_wide": (TRAIN_HEADLINE, FP32_MODE, WIDER_CLI_HD),
               "clash_fwd": (TRAIN_HEADLINE, FP32_MODE, HD),
               "clash_bwd": (TRAIN_HEADLINE, FP32_MODE, HD)}


def _descendants() -> list[int]:
    """The live processes descended from this one, from ``/proc``."""
    parent = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] != "Z":
            parent[int(name)] = int(fields[1])
    found, frontier = [], {os.getpid()}
    while frontier:
        frontier = {pid for pid, ppid in parent.items() if ppid in frontier}
        found += sorted(frontier)
    return found


def stop_children(timeout_s: float = 30.0) -> None:
    """Stop every process this run started: the rank server and resource
    tracker that ``parallel.launch`` leaves for later launches (stopped and
    waited for), then any other descendant still alive (killed, and named
    in the log)."""
    import signal

    if "protein_ensemble_vae_torch.parallel.mesh" in sys.modules:
        sys.modules["protein_ensemble_vae_torch.parallel.mesh"].stop_rank_servers()
    left = _descendants()
    if not left:
        return
    log(f"[exit] killing processes left running: {left}")
    for pid in left:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    deadline = time.monotonic() + timeout_s
    while _descendants() and time.monotonic() < deadline:
        with contextlib.suppress(ChildProcessError):
            os.waitpid(-1, os.WNOHANG)
        time.sleep(0.1)
    if _descendants():
        raise RuntimeError(f"processes still running at exit: {_descendants()}")


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="TRACE.json", default=None,
                    help="after the checks, profile the generation path and "
                         "the B4/L256 train steps with torch.profiler and "
                         "write their traces (TRACE.json, "
                         "TRACE.train_fp32.json, TRACE.train_bf16.json)")
    ap.add_argument("--grad-triage", metavar="FILE.json", default=None,
                    help="write the float64 triage's per-tensor gradient distances "
                         "(kernel path and fp32 plain path, Hd 256 and 512) to FILE")
    args = ap.parse_args(argv)
    global TRIAGE_PATH
    TRIAGE_PATH = args.grad_triage

    device = phase_device()
    phase_build()
    floor = _launch_floor()
    log(f"[kernels] launch floor (clash_noop, same ctypes path): {floor['floor_us']:.2f} us "
        f"per launch back to back, {floor['floor_graph_us']:.2f} us in a CUDA graph, "
        f"{floor['floor_host_us']:.1f} us per call on the host")
    global READ_RATE
    READ_RATE = _l2_rate()
    log(f"[kernels] read rates ({device['smi']}): {json.dumps(READ_RATE)}")
    shapes = {name: [] for name in KERNEL_INFO}
    for name, rows in phase_kernels().items():
        shapes[name] += rows
    for name, rows in phase_train_kernels().items():
        shapes[name] += rows
    for name, rows in phase_bf16_kernels().items():
        shapes[name] += rows
    for name, rows in phase_chain_kernels().items():
        shapes[name] += rows
    for name, rows in phase_wide_kernels().items():
        shapes[name] += rows
    chain_ab = phase_chain_path()
    for name, rows in phase_clash_kernels(floor).items():
        shapes[name] += rows
    clash_term_kernels()
    model, views = setup_main_path()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        gen = phase_main_path(model, views, out_dir)
        if args.profile:
            profile_generation(model, views, out_dir, args.profile)
        dataprep = phase_dataprep(model, out_dir, args.profile)
        del model
        train = phase_train_path(out_dir)
        train_bf16 = phase_train_cli_bf16(out_dir)
        watch = phase_watch_path(out_dir, device["smi"])
        parallel = phase_parallel(out_dir, device["smi"])
        steps = phase_timed_steps(args.profile)
        wide = phase_wide_decoder(views, out_dir, args.profile)
        # refinement after the train steps: what it leaves allocated would
        # count in their peak memory
        refine_gates(args.profile)
        refine = phase_refine_path(main_model(), views, out_dir, gen["per_structure"])
        flagship = phase_flagship(out_dir)

    kernels = []
    for name in MMA_SYNC_KERNELS:
        ran = {"generate": gen["launches"][name], "refine": refine["launches"][name],
               "train": train["launches"][name], "train_bf16": train_bf16["launches"][name],
               "train_watch": watch["launches"][name], "train_dp": parallel["launches"][name],
               "dataprep": dataprep["launches"][name], "chain_dtype_ab": chain_ab["launches"][name],
               "wide_decoder": wide["launches"][name], "flagship": flagship["launches"][name]}
        if any(ran.values()):
            raise RuntimeError(f"{name} (mma.sync) ran on a path: {ran}")
    for name, (source, replaces) in KERNEL_INFO.items():
        rows = shapes[name]
        want, want_mode, want_hd = KERNEL_HEAD[name]
        head = next(r for r in rows if (r["B"], r["L"]) == want and r.get("mode", FP32_MODE)
                    == want_mode and r.get("Hd", HD) == want_hd)
        chain_modes = {k.split(":", 1)[1]: v for k, v in chain_ab["modes"].items()
                       if k.startswith(name + ":")}
        # chain_dtype_ab's path is the bf16 chain's: its fp32-chain launches
        # (what it compares with) stand in chain_dtype_ab_modes only
        by_path = {"generate": gen["launches"][name], "refine": refine["launches"][name],
                   "train": train["launches"][name],
                   "train_bf16": train_bf16["launches"][name],
                   "train_watch": watch["launches"][name],
                   "train_dp": parallel["launches"][name],
                   "dataprep": dataprep["launches"][name],
                   "chain_dtype_ab": sum(v for k, v in chain_modes.items()
                                         if k.endswith("/bfloat16_chain")),
                   "wide_decoder": wide["launches"][name],
                   "flagship": flagship["launches"][name]}
        if (any(by_path[p] == 0 for p in REQUIRED_PATHS[name])
                or ("train_dp" in REQUIRED_PATHS[name]
                    and any(r[name] == 0 for r in parallel["launches_by_rank"]))):
            raise RuntimeError(f"{name} was not launched on its main path: {by_path}, "
                               f"chain_dtype_ab modes {chain_modes}")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=None, host_us=head["host_us"],
            graph_ms=head.get("graph_ms"),
            **floor,
            tc_bound_ms=head.get("tc_bound_ms"),
            **{k: head[k] for k in ("weight_floor_ms", "a_stream_floor_ms", "scratch_floor_ms")
               if k in head},
            # kernels 1-2: the train_bf16 path's launches by mode
            **({"train_bf16_modes": {k.split(":", 1)[1]: v
                                     for k, v in train_bf16["modes"].items()
                                     if k.startswith(name + ":")},
                "chain_dtype_ab_modes": chain_modes}
               if name.startswith("egnn") else {}),
            # kernels 3-4 run on the refine path from replayed CUDA graphs:
            # their count there is the capture's launches x the replays, and
            # the profiler's records of the cli.refine call back it up
            **({"refine_counted_as": "launches at capture x graph replays",
                "refine_cli_records": {"steps": CLI_REFINE_STEPS,
                                       "records": refine["cli_records"][name],
                                       "profiled_calls": refine["cli_records"]["profiled_calls"]}}
               if name.startswith("clash") else {}),
            shape=f"B{head['B']}/L{head['L']}" + (f"/Hd{want_hd}/W{W}" if "egnn" in name else ""),
            shapes=[{k: v for k, v in r.items() if k != "errors"} for r in rows]))
    fp32_step = next(r for r in steps if r.get("shape") == "B4/L256 fp32"
                     and r.get("path") == "kernel")
    wt = watch["times"]
    log(f"[watch] the same B4/L256 fp32 kernel-path step ({device['smi']}): "
        f"utils.profiling.time_fn {wt['time_fn_ms']:.2f} ms, scan_step_time "
        f"{wt['scan_step_ms']:.2f} ms (median of its repeats {wt['scan_median_ms']:.2f}), "
        f"CUDA events {wt['event_median_ms']:.2f} ms (phase 5b); "
        f"phase 6's median {fp32_step['ms']:.2f} ms (host clock, synchronised)")
    log(json.dumps({"watch": {k: watch[k] for k in ("gap_watch", "gap_twice", "same_history",
                                                     "stats_worst", "counts_worst", "compare",
                                                     "records", "times", "seconds")}}))
    log(json.dumps({"train_steps": steps}))
    log(json.dumps({"wide_decoder": {k: wide[k] for k in ("per_structure", "plain_per_structure",
                                                          "peak_mib", "steps", "compare", "cli",
                                                          "cli_wide", "cli_wider")}}))
    log(json.dumps({"parallel": {k: parallel[k] for k in ("checks", "times",
                                                           "launches_by_rank",
                                                           "cli_seconds")}}))
    log(json.dumps({"esm": {k: dataprep[k] for k in ("timed", "stages", "cpu_err", "cpu_atol",
                                                     "bucket_err", "bucket_atol")}}))
    log(json.dumps({"flagship": {k: flagship[k] for k in ("stages", "aggregate",
                                                          "epoch_seconds")}}))
    stop_children()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}),
        flush=True)


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_children()
