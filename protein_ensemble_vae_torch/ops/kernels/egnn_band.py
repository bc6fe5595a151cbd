"""EGNN band message passing: the Hopper CUDA kernels 1 (forward) and 2
(backward) (``csrc/egnn_band_{fwd,bwd}_sm90*.cu``), their wrappers, their
plain PyTorch versions, and ``EGNNBandFunction``, the autograd function
that joins them.

Counterpart of the JAX package's ``ops/pallas/egnn_band.py``
(``egnn_band_fused`` with its custom VJP). Algebra, for receiver i and
offset k (j = i+k-W):

    pre[i,k] = a[i] + bs[j] + |x_i - x_j|^2 * w_d
    m  = silu(silu(pre) @ W_e2 + b_e2)
    agg[i]       = sum_k m * valid(i,k)
    raw_delta[i] = sum_k (silu(m @ W_x1 + b_x1) @ w_x2 + b_x2) * valid * rel

valid(i,k) = in-range & k != W & cmask_i & cmask_j; callers apply
deg_inv * 0.2 to raw_delta. The gradient takes no derivative through
``cmask`` (a mask) and ``W``.

Modes, as the JAX function's arguments:
- ``a`` / ``bs`` in fp32 or bf16 (a bf16 model's projections). The kernels
  read bf16 as it lies and widen it in registers; the plain version upcasts
  it. ``agg`` and ``raw_delta`` are fp32 in every mode, and the gradients
  of ``a`` / ``bs`` come back in their dtype.
- ``precision``: ``"highest"`` (JAX ``Precision.HIGHEST``, an fp32 model):
  the kernels' products in 3xTF32, fp32 accuracy; ``"default"`` (JAX
  ``None``, a bf16 model): one TF32 pass, the backend's fast product.
  The plain version computes in full fp32 in both (as JAX's ``None`` does
  on the CPU).
- ``chain_dtype``: fp32, or bf16 (JAX ``chain_dtype=jnp.bfloat16``): the
  edge MLP's activations and the cotangent chain in bf16, rounded where
  the JAX kernel rounds them (after every elementwise op; each product's
  fp32 sum rounded once), with bf16 weights (cast once per call) and bf16
  tensor-core products on the card; ``d2``, ``agg`` / ``raw_delta`` and
  every gradient sum stay fp32. ``precision`` selects nothing in this mode
  (bf16 operands give JAX's ``HIGHEST`` and ``None`` the same product) but
  must be one of the two. The plain version follows the JAX kernel op by
  op (``_bf16_chain_edges``, ``_bf16_chain_backward``); no JAX model path
  uses this mode, and the port's decoder does not either.

Kernels by mode. Every mode runs on Hopper kernels (``wgmma`` products fed
by ``mbarrier`` rings) at every width, and for a CUDA tensor only there
(``band_kernel`` names the kernel, and counter, of a call):
- the one-pass mode (``precision="default"``; ``a`` / ``bs`` in bf16, the
  bf16 model's mode, or in fp32) and the bf16 chain at the native widths
  SM90_HIDDEN (32 to 256, and the widths padded to them) on
  ``csrc/egnn_band_fwd_sm90.cu`` / ``csrc/egnn_band_bwd_sm90.cu`` (two
  consumer warpgroups on a step each, sharing one weight ring; counters
  ``egnn_band_fwd_sm90`` / ``egnn_band_bwd_sm90``);
- 3xTF32 (``"highest"``, the fp32 model's mode) at SM90_HIDDEN, and every
  mode at the native width 512 (and the widths 257 to 511 padded to it),
  on the shared-tile kernels ``csrc/egnn_band_fwd_sm90_hd512.cu`` /
  ``csrc/egnn_band_bwd_sm90_hd512.cu`` (the two consumer warpgroups
  sharing one activation tile and splitting the output columns, each fed
  by its own ring; the weights' 3xTF32 split written once per call into
  their images, the activation's into a second tile up to 256 and over the
  tile in place at 512; counters ``egnn_band_fwd_sm90_x3`` /
  ``egnn_band_bwd_sm90_x3`` up to 256, ``egnn_band_fwd_sm90_hd512`` /
  ``egnn_band_bwd_sm90_hd512`` at 512);
- every mode above 512 (any multiple of WIDE_GROUP, given at run time; the
  widths between padded up) on ``csrc/egnn_band_fwd_sm90_wide.cu`` /
  ``csrc/egnn_band_bwd_sm90_wide.cu`` (``csrc/egnn_sm90_wide.cuh``: the
  activation tile, too large for shared memory, streams from the block's
  device-memory rows beside the weight chunks through one ring; the two
  consumer warpgroups split each column pass; counters
  ``egnn_band_fwd_sm90_wide`` / ``egnn_band_bwd_sm90_wide``).
In the bf16 chain each family runs bf16 tiles, images and scratch (two
values a 4-byte word in the same swizzled layout) on bf16 ``wgmma``
(m64nNk16), the C entries' ``passes`` BF16_CHAIN (``kernel_passes``).
The ``mma.sync`` kernels ``csrc/egnn_band_fwd.cu`` / ``csrc/egnn_band_bwd.cu``
(and their wide variants) serve no mode any more; their launch plans
(``fwd_slices``, ``bwd_grid``, ``fwd_plan``, ``bwd_plan``) and C bindings
(``_kernel_fn``, ``_bwd_kernel_fn``) stay for the scripts that time them
as a baseline.

Widths: any width from 1 up. The kernels are instantiated at the native
widths NATIVE_HIDDEN (32 to 512), with the step's activation tile in
shared memory; above MAX_NATIVE that tile, 64 x Hd x 4 bytes, would
outgrow the 227 KB of shared memory a block may have, so the kernels
above it take every width that WIDE_GROUP divides, given at run time,
with the activations streamed from the block's device-memory rows. For CUDA
tensors of any other width the wrappers zero-pad to the next width the
kernels take (``native_width``, ``pad_band_width``), launch, and slice the
results back, which is exact up to summation order (``pad_band_width``
says why).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from protein_ensemble_vae_torch.ops.kernels import (BAND_MODE_LAUNCHES, LAUNCHES,
                                                   check_outputs)
from protein_ensemble_vae_torch.ops.routing import pallas_policy
from protein_ensemble_vae_torch.parallel.shard import copy_to_tp, reduce_from_tp
from protein_ensemble_vae_torch.utils.profiling import span

Tensor = torch.Tensor

# the kernels' generic names (band_kernel's argument; the mma.sync kernels'
# counters, which no mode launches any more)
KERNEL = "egnn_band_fwd"
BWD_KERNEL = "egnn_band_bwd"
# widths the kernels are instantiated at (SM90_HIDDEN and HD512); above
# MAX_NATIVE the kernels above 512 take the multiples of WIDE_GROUP; the
# wrappers zero-pad any other width up to the next of these (pad_band_width)
NATIVE_HIDDEN = (32, 64, 128, 256, 512)
MAX_NATIVE = NATIVE_HIDDEN[-1]
WIDE_GROUP = 256          # widths above 512 are its multiples (the Hopper kernels above
                          # 512: two consumers' column passes of WIDE_NW[1] columns)
INPUT_DTYPES = (torch.float32, torch.bfloat16)   # of a and bs
CHAIN_DTYPES = (torch.float32, torch.bfloat16)   # of the edge chain
PASSES = {"highest": 3, "default": 1}   # precision -> TF32 passes per product (fp32 chain)
BF16_CHAIN = 0            # the Hopper C entries' `passes` of the bf16 chain (egnn_tile.cuh: CHAIN_BF16)
TILE = 8                  # receivers per tile (csrc/egnn_tile.cuh: T)
OPS = 8                   # band offsets per step (csrc/egnn_tile.cuh: OPS)
WGRAD_TILE = 128          # weight-grad output tile edge (csrc/egnn_band_bwd.cu)
FWD_WAVES = 8             # waves of resident blocks kernel 1's grid should span
# The Hopper kernels of the one-pass fp32 chain (csrc/egnn_band_{fwd,bwd}_sm90.cu,
# csrc/egnn_sm90.cuh), their widths and the constants of their layouts
SM90_KERNEL = "egnn_band_fwd_sm90"
SM90_BWD_KERNEL = "egnn_band_bwd_sm90"
SM90_HIDDEN = (32, 64, 128, 256)
SM90_THREADS = 384        # a producer warpgroup and two consumer warpgroups
SM90_FWD_WAVES = 2        # waves of the persistent blocks kernel 1's units should span
SM90_KB = 32              # K values per 128-byte swizzled row of a K block
SM90_NW_MAX = 128         # output columns per wgmma (m64nNk8), at most
SM90_FWD_STAGES = 5       # ring chunks of kernel 1 (egnn_band_fwd_sm90.cu: STAGES)
SM90_BWD_STAGES = 3       # ring chunks of kernel 2's edge pass (egnn_band_bwd_sm90.cu: STAGES)
SM90_WGRAD_STAGES = 4     # stages of its weight-grad pass (egnn_band_bwd_sm90.cu: WSTAGES)
SM90_WGRAD_M = 64         # weight-grad tile rows (one m64 warpgroup product)
# The shared-tile Hopper kernels (csrc/egnn_band_{fwd,bwd}_sm90_hd512.cu):
# width 512 in both fp32-chain modes, and the widths of SM90_HIDDEN in
# 3xTF32 under their own counters (X3_KERNEL, X3_BWD_KERNEL), and their
# layout constants
HD512_KERNEL = "egnn_band_fwd_sm90_hd512"
HD512_BWD_KERNEL = "egnn_band_bwd_sm90_hd512"
X3_KERNEL = "egnn_band_fwd_sm90_x3"
X3_BWD_KERNEL = "egnn_band_bwd_sm90_x3"
HD512 = 512
HD512_HALF = 256          # output columns of each consumer warpgroup at 512 (Hd / 2)
HD512_FWD_NW = 128        # columns per wgmma of kernel 1 at 512 (egnn_band_fwd_sm90_hd512.cu: NW_OF)
HD512_BWD_NW = 64         # of kernel 2's edge pass, and of kernel 1 up to 256, at most
HD512_FWD_STAGES = 3      # chunks of each consumer's ring, kernel 1 at 512
HD512_BF16_STAGES = 5     # and in the bf16 chain, whose tile is half the bytes (BF16_STAGES)
X3_FWD_STAGES = 6         # and up to 256 (egnn_band_fwd_sm90_hd512.cu: STAGES_OF)
HD512_BWD_STAGES = 5      # of kernel 2's edge pass
HD512_WGRAD_STAGES = 3    # stages of its weight-grad pass (WSTAGES)
HD512_WGRAD_TILE = 64     # its output tiles are 64 x 64 (64 x Hd below 64)
HD512_UNIT_COST = 0.1     # a unit's closing sums, in steps (hd512_fwd_plan_of)
SMEM_LIMIT = 232448       # shared memory one block may have on an H100
# The Hopper kernels above width 512 in both fp32-chain modes
# (csrc/egnn_band_{fwd,bwd}_sm90_wide.cu, csrc/egnn_sm90_wide.cuh) and their
# layout constants, by TF32 passes (1: one pass, 3: 3xTF32)
WIDE_KERNEL = "egnn_band_fwd_sm90_wide"
WIDE_BWD_KERNEL = "egnn_band_bwd_sm90_wide"
WIDE_NW = {1: 128, 3: 64}     # columns per consumer and column pass (egnn_sm90_wide.cuh: Cfg::NW)
WIDE_STAGES = {1: 5, 3: 4}    # ring stages (Cfg::STAGES)
WIDE_WGRAD_TILE = 64          # weight-grad output tile edge (egnn_band_bwd_sm90_wide.cu: WGRAD_TN)
IMG_T, IMG_N = 0, 1       # weight image orientations: B[n][k] = W[k][n], W[n][k]

_FN = None
_BWD_FN = None
_SM90_FN = None
_SM90_BWD_FN = None
_HD512_FN = None
_HD512_BWD_FN = None
_WIDE_FN = None
_WIDE_BWD_FN = None
_SM_COUNT: dict = {}
_PER_SM: dict = {}


def band_work(B: int, L: int, W: int) -> tuple[int, int, int]:
    """(receiver tiles per batch row, offset steps, work items): a work item
    of both kernels is one 64-edge step (batch row, tile of TILE receivers,
    OPS of the 2W band offsets)."""
    n_tiles = -(-L // TILE)
    n_steps = -(-2 * W // OPS)
    return n_tiles, n_steps, B * n_tiles * n_steps


def fwd_slices(B: int, L: int, W: int, n_sm: int, per_sm: int) -> int:
    """Slices S of the band offsets for kernel 1: each of its B x tiles x S
    blocks walks ceil(steps / S) steps, and a second pass sums the S
    partial outputs in slice order. The grid should span FWD_WAVES waves of
    the ``n_sm * per_sm`` resident blocks (``per_sm``: the occupancy query's
    answer, 2 up to Hd 256 and 1 at Hd 512), so that the last, partly filled
    wave costs little: S = 1 where B x tiles blocks already do; otherwise
    the most steps per block that still give that many blocks (one step
    per block at the least)."""
    n_tiles, n_steps, _ = band_work(B, L, W)
    blocks = B * n_tiles
    want = FWD_WAVES * n_sm * max(1, per_sm)
    if blocks >= want:
        return 1
    per = max(1, n_steps * blocks // want)
    return -(-n_steps // per)


def bwd_grid(B: int, L: int, W: int, Hd: int, n_sm: int,
             per_sm: int) -> tuple[int, int]:
    """Kernel 2's grid: G persistent edge-pass blocks, one per resident slot
    (``per_sm`` blocks on each of ``n_sm`` SMs, the occupancy query's answer:
    two 256-thread blocks up to Hd 256, one 512-thread block at Hd 512;
    block g takes work items g, g + G, ...), and the weight-grad pass's
    slices of the items, enough for its 2 x (Hd / tile)^2 output tiles to
    fill two slots per SM (that pass's 256-thread blocks, two per SM at
    every width)."""
    _, _, items = band_work(B, L, W)
    out_tiles = 2 * (Hd // min(Hd, WGRAD_TILE)) ** 2
    return (max(1, min(items, n_sm * max(1, per_sm))),
            max(1, min(items, -(-2 * n_sm // out_tiles))))


def wide_fwd_grid(B: int, L: int, n_sm: int, per_sm: int) -> int:
    """Blocks of the mma.sync kernel 1's wide variant (the A/B scripts'
    baseline; no mode launches it): one
    persistent block per resident slot (``per_sm`` on each of ``n_sm`` SMs), each walking (batch row,
    tile) items g, g + G, ... with every band step of each; no more blocks
    than items."""
    n_tiles, _, _ = band_work(B, L, 1)
    return max(1, min(B * n_tiles, n_sm * max(1, per_sm)))


def takes_sm90(Hd: int, precision: str, chain_dtype=torch.float32) -> bool:
    """Whether the Hopper kernels take a call at native width Hd in this
    mode: the one-pass fp32 chain or the bf16 chain at a width of
    SM90_HIDDEN."""
    return Hd in SM90_HIDDEN and (precision == "default" or bool(_chain_bf16(chain_dtype)))


def takes_hd512(Hd: int, precision: str, chain_dtype=torch.float32) -> bool:
    """Whether the shared-tile Hopper kernels take a call at native width Hd
    in this mode: every mode (3xTF32, one pass, the bf16 chain) at 512, and
    3xTF32 at a width of SM90_HIDDEN."""
    if _chain_bf16(chain_dtype):
        return Hd == HD512
    return Hd == HD512 or (precision == "highest" and Hd in SM90_HIDDEN)


def takes_wide(Hd: int, precision: str, chain_dtype=torch.float32) -> bool:
    """Whether the Hopper kernels above width 512 take a call at native
    width Hd in this mode: every mode above MAX_NATIVE."""
    return Hd > MAX_NATIVE


def kernel_passes(precision: str, chain_dtype=torch.float32) -> int:
    """The Hopper C entries' ``passes`` of a mode: the TF32 passes of
    ``precision`` in the fp32 chain, BF16_CHAIN in the bf16 chain."""
    return BF16_CHAIN if _chain_bf16(chain_dtype) else PASSES[precision]


def bf16_image_words(Hd: int) -> int:
    """4-byte words of one bf16 weight image at native width Hd (two bf16
    a word; K padded to one 64-value block at Hd 32; egnn_sm90.cuh:
    image_words_bf16)."""
    return max(Hd // 2, SM90_KB) * Hd


def band_kernel(kernel: str, Hd: int, precision: str = "highest",
                chain_dtype=torch.float32) -> str:
    """The kernel, and launch counter, that serves ``kernel``
    (``"egnn_band_fwd"`` or ``"egnn_band_bwd"``) at hidden width Hd (any
    width; the kernels run it at ``native_width(Hd)``) in the mode."""
    n = native_width(Hd)
    if takes_wide(n, precision, chain_dtype):
        return kernel + "_sm90_wide"
    if takes_hd512(n, precision, chain_dtype):
        return kernel + ("_sm90_hd512" if n == HD512 else "_sm90_x3")
    return kernel + "_sm90" if takes_sm90(n, precision, chain_dtype) else kernel


def shared_tile_nw(kernel: str, Hd: int) -> int:
    """Output columns per product (m64nNWk8) of a shared-tile kernel at
    native width Hd: kernel 1 (HD512_KERNEL or X3_KERNEL) HD512_FWD_NW at
    512, else HD512_BWD_NW as kernel 2's edge pass, or a consumer's Hd / 2
    where that is fewer (egnn_band_{fwd,bwd}_sm90_hd512.cu: NW_OF)."""
    if kernel in (HD512_KERNEL, X3_KERNEL) and Hd == HD512:
        return HD512_FWD_NW
    return min(Hd // 2, HD512_BWD_NW)


def sm90_cols(Hd: int) -> tuple[int, int]:
    """(NW, NH): output columns per product (m64nNWk8) and column groups."""
    nw = min(Hd, SM90_NW_MAX)
    return nw, Hd // nw


def sm90_fwd_plan_of(B: int, L: int, W: int, n_sm: int,
                     per_sm: int) -> tuple[int, int, int]:
    """Kernel 1's Hopper plan: (S, pairs per slice, G). A work unit is
    (batch row, receiver tile, slice of the band's step pairs; a pair is two
    64-edge-row steps, one per consumer warpgroup); G persistent blocks
    (``per_sm`` on each of ``n_sm`` SMs, no more than the units) walk units
    g, g + G, ... The slices S split the pairs so that the units span
    SM90_FWD_WAVES waves of the G blocks where the pairs allow (each unit
    ends in a cross-warp sum of its receivers' rows, so fewer, longer units
    where the card is full), every slice owning at least one pair; with
    S > 1 a second pass sums the slices' partial outputs in slice order."""
    n_tiles, n_steps, _ = band_work(B, L, W)
    n_pairs = -(-n_steps // 2)
    blocks = B * n_tiles
    slots = n_sm * max(1, per_sm)
    S = max(1, min(n_pairs, -(-SM90_FWD_WAVES * slots // max(1, blocks))))
    per = -(-n_pairs // S)
    S = -(-n_pairs // per)
    return S, per, max(1, min(blocks * S, slots))


def hd512_fwd_plan_of(B: int, L: int, W: int, n_sm: int,
                      per_sm: int) -> tuple[int, int, int]:
    """Kernel 1's plan at width 512, and above 512 (the same units serve
    egnn_band_fwd_sm90_wide.cu: B x tiles units are too few for the card at
    B1/L256, 32 tiles of 10 steps on 132 SMs): (S, steps per slice, G). A
    work unit is (batch row, receiver tile, slice of the band's
    64-edge-row steps); G persistent blocks (``per_sm`` on each of ``n_sm``
    SMs, no more than the units) walk units g, g + G, ... S is the slice
    count (every slice owning at least one step) that gives the least
    estimated makespan, in steps: the most units a block takes times the
    steps of a unit, plus HD512_UNIT_COST a unit for its closing sums (the
    fewer slices on a tie). With S > 1 a second pass sums the slices'
    partial outputs in slice order."""
    n_tiles, n_steps, _ = band_work(B, L, W)
    blocks = B * n_tiles
    slots = n_sm * max(1, per_sm)
    best = None
    for per in range(1, n_steps + 1):
        S = -(-n_steps // per)
        if (S - 1) * per >= n_steps:
            continue
        G = max(1, min(blocks * S, slots))
        key = (-(-blocks * S // G) * (per + HD512_UNIT_COST), S)
        if best is None or key < best[0]:
            best = (key, S, per, G)
    return best[1:]


def sm90_smem_bytes(kernel: str, Hd: int, passes: int = 1, steps: int = 0) -> int:
    """Shared memory one block of a Hopper kernel asks for at width Hd
    (mirror of the layouts in csrc/egnn_band_{fwd,bwd}_sm90*.cu; + 1 KiB to
    align the swizzled tiles): ``"egnn_band_fwd_sm90"``, the edge pass
    ``"egnn_band_bwd_sm90"`` or its weight-grad pass ``"wgrad"``; the
    shared-tile kernels HD512_KERNEL / X3_KERNEL, the edge pass
    HD512_BWD_KERNEL / X3_BWD_KERNEL or its weight-grad pass
    ``"wgrad_hd512"``; the kernels above 512, WIDE_KERNEL, the edge pass
    WIDE_BWD_KERNEL or its weight-grad pass ``"wgrad_wide"`` (the same at
    every width) (``passes``: 1, 3 (3xTF32's split stages) or BF16_CHAIN,
    whose tiles hold bf16; ``steps``: the slice's step list)."""
    bf16 = passes == BF16_CHAIN
    if bf16 and kernel in (WIDE_KERNEL, WIDE_BWD_KERNEL, "wgrad_wide", "wgrad_hd512", "wgrad"):
        # the one-pass layouts: bf16 operands fill the same 128-byte rows
        return sm90_smem_bytes(kernel, Hd, 1, steps)
    if kernel in (WIDE_KERNEL, WIDE_BWD_KERNEL):
        # the ring (an A chunk and a weight chunk of 2 x NW rows a stage, the
        # weight's small part too in 3xTF32), three split buffers of an A
        # chunk (3xTF32), rows (6: valid, d2, j, rel[3]; 7 with cw in kernel
        # 2), the second consumer's dot products (1, or 2), flags, barriers
        # (full, empty, act); any width
        parts = 2 if passes == 3 else 1
        stage = (64 + parts * 2 * WIDE_NW[passes]) * SM90_KB * 4
        splits = 3 * 64 * SM90_KB * 4 if passes == 3 else 0
        rows, dots = (6, 1) if kernel == WIDE_KERNEL else (7, 2)
        return (WIDE_STAGES[passes] * stage + splits + (rows + dots) * 64 * 4 + 8
                + (2 * WIDE_STAGES[passes] + 1) * 8 + 1024)
    if kernel == "wgrad_wide":
        # as wgrad_hd512 at its 64 x 64 tiles: any width
        return sm90_smem_bytes("wgrad_hd512", HD512, passes, steps)
    nw, _ = sm90_cols(Hd)
    chunk = nw * SM90_KB * 4
    # two activation tiles of 64 rows: Hd fp32 words a row, or the bf16
    # chain's max(Hd / 2, 32)
    a_tiles = 2 * 64 * (max(Hd // 2, SM90_KB) if bf16 else Hd) * 4
    if kernel == SM90_KERNEL:
        # the unit's sums, 8 x TILE x (Hd + 3) fp32, live in the A region
        red = -(-8 * TILE * (Hd + 3) * 4 // 1024) * 1024
        return (max(a_tiles, red) + SM90_FWD_STAGES * chunk + 2 * 6 * 64 * 4 + 32
                + 2 * SM90_FWD_STAGES * 8 + 1024)
    if kernel == SM90_BWD_KERNEL:
        # A tiles, ring, the eight warps' vector-grad column sums, rows, flags, barriers
        return (a_tiles + SM90_BWD_STAGES * chunk + 8 * 4 * Hd * 4 + 2 * 7 * 64 * 4 + 32
                + 2 * SM90_BWD_STAGES * 8 + 1024)
    if kernel == "wgrad":
        stage = SM90_WGRAD_M * SM90_KB * 4 + nw * SM90_KB * 4
        return SM90_WGRAD_STAGES * stage + 2 * SM90_WGRAD_STAGES * 8 + 1024
    # the shared-tile kernels: the activation tile (bf16 in the bf16 chain),
    # and up to 256 its split
    tile = 64 * Hd * (2 if bf16 else 4 * (2 if Hd < HD512 else 1))
    if kernel in (HD512_KERNEL, X3_KERNEL):
        # tile(s), the consumers' rings, rows (valid, d2, j, rel[3]), the
        # second consumer's dot products, flags, barriers
        stages = (HD512_BF16_STAGES if bf16 else HD512_FWD_STAGES) if Hd == HD512 else X3_FWD_STAGES
        ring = 2 * stages * shared_tile_nw(kernel, Hd) * SM90_KB * 4
        return tile + ring + 6 * 64 * 4 + 64 * 4 + 16 + 4 * stages * 8 + 1024
    if kernel in (HD512_BWD_KERNEL, X3_BWD_KERNEL):
        # tile(s), rings, rows (valid, d2, cw, j, rel[3]), two dot products,
        # flags, barriers (the column sums live in device memory)
        ring = 2 * HD512_BWD_STAGES * shared_tile_nw(kernel, Hd) * SM90_KB * 4
        return tile + ring + 7 * 64 * 4 + 2 * 64 * 4 + 16 + 4 * HD512_BWD_STAGES * 8 + 1024
    if kernel == "wgrad_hd512":
        # stages of X (the m64 operand) and Y (TN rows, 32 K each), two split
        # stages in 3xTF32, barriers, the slice's step list
        stage = (64 + min(Hd, HD512_WGRAD_TILE)) * SM90_KB * 4
        return ((HD512_WGRAD_STAGES + 2 * (passes == 3)) * stage + 2 * HD512_WGRAD_STAGES * 8
                + 4 * steps + 1024)
    raise ValueError(f"not a Hopper kernel: {kernel!r}")


def rna_tf32(v):
    """numpy float32 values rounded to TF32 as cvt.rna.tf32.f32 rounds
    them (to nearest, ties away from zero; egnn_tile.cuh: rna_tf32)."""
    u = np.asarray(v, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def sw_off(row, k, rows: int):
    """Float offset of element (row, k) in a K-major, 128-byte-swizzled
    tile of ``rows`` rows (egnn_sm90.cuh: sw_off); numpy arrays or ints."""
    return ((k // SM90_KB) * rows * SM90_KB + row * SM90_KB
            + ((((k // 4) & 7) ^ (row & 7)) << 2) + (k & 3))


def weight_image(w, orient: int):
    """numpy mirror of the layout kernel (egnn_sm90.cuh: weight_images):
    the Hd x Hd fp32 weight ``w`` as the ring streams it, chunks of NW
    output rows x 32 K values in the order (K block, column group), each
    in the swizzled byte order, values rounded to TF32. ``orient`` IMG_T:
    B[n][k] = w[k][n] (products x @ w), IMG_N: B[n][k] = w[n][k] (x @ w^T).
    Returns the flat image, Hd * Hd float32."""
    w = np.asarray(w, dtype=np.float32)
    Hd = w.shape[0]
    nw, nh = sm90_cols(Hd)
    chunk = nw * SM90_KB
    e = np.arange(Hd * Hd)
    q, r = e // chunk, e % chunk
    nl, pos = r // SM90_KB, r % SM90_KB
    kl = ((((pos >> 2) ^ (nl & 7)) & 7) << 2) | (pos & 3)
    n, k = (q % nh) * nw + nl, (q // nh) * SM90_KB + kl
    return rna_tf32(w[k, n] if orient == IMG_T else w[n, k])


def weight_image_hd512(w, orient: int, part: int, nw: int, hmajor: bool):
    """numpy mirror of the shared-tile kernels' layout kernel (egnn_sm90.cuh:
    weight_images_half): the Hd x Hd fp32 weight ``w`` (Hd 512, or a width
    of SM90_HIDDEN) as the two consumers' rings stream it, the half of the
    output columns of consumer 0, then of consumer 1 (Hd / 2 each), each as
    chunks of ``nw`` output rows x 32 K values in the order (K block, column
    group), or with ``hmajor`` (column group, K block) as kernel 1 streams
    them, each in the swizzled byte order. ``orient`` as ``weight_image``;
    ``part`` 0: the values rounded to TF32 (big), 1: the rest of each value
    rounded to TF32 (small; 3xTF32). Returns the flat image."""
    w = np.asarray(w, dtype=np.float32)
    Hd = w.shape[0]
    n_half = Hd // 2
    nh, chunk, half = n_half // nw, nw * SM90_KB, n_half * Hd
    nkc = Hd // SM90_KB
    e = np.arange(Hd * Hd)
    h2, eh = e // half, e % half
    q, r = eh // chunk, eh % chunk
    nl, pos = r // SM90_KB, r % SM90_KB
    kl = ((((pos >> 2) ^ (nl & 7)) & 7) << 2) | (pos & 3)
    h, kc = (q // nkc, q % nkc) if hmajor else (q % nh, q // nh)
    n, k = h2 * n_half + h * nw + nl, kc * SM90_KB + kl
    v = w[k, n] if orient == IMG_T else w[n, k]
    big = rna_tf32(v)
    return rna_tf32(v - big) if part else big


def weight_image_wide(w, orient: int, part: int, nc: int):
    """numpy mirror of the wide kernels' layout kernel (egnn_sm90_wide.cuh:
    weight_images_wide): the Hd x Hd fp32 weight ``w`` (Hd a multiple of
    ``nc``) as chunks of ``nc`` output rows x 32 K values in the order
    (column pass, K block), each in the swizzled byte order; ``orient`` as
    ``weight_image``; ``part`` 0: the values rounded to TF32 (big), 1: the
    rest of each value rounded to TF32 (small; 3xTF32). Returns the flat
    image, Hd * Hd float32."""
    w = np.asarray(w, dtype=np.float32)
    Hd = w.shape[0]
    nkc, chunk = Hd // SM90_KB, nc * SM90_KB
    e = np.arange(Hd * Hd)
    q, r = e // chunk, e % chunk
    nl, pos = r // SM90_KB, r % SM90_KB
    kl = ((((pos >> 2) ^ (nl & 7)) & 7) << 2) | (pos & 3)
    n, k = (q // nkc) * nc + nl, (q % nkc) * SM90_KB + kl
    v = w[k, n] if orient == IMG_T else w[n, k]
    big = rna_tf32(v)
    return rna_tf32(v - big) if part else big


def _sm_count(dev) -> int:
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SM_COUNT[dev]


def band_indices(L: int, W: int, device=None) -> tuple[Tensor, Tensor]:
    """Static band geometry: neighbor indices [L, K] (clipped) and the
    in-range/non-self mask [L, K], K = 2W+1."""
    offs = torch.arange(2 * W + 1, device=device) - W
    base = torch.arange(L, device=device)[:, None] + offs[None, :]
    idx = base.clamp(0, L - 1)
    in_range = (base >= 0) & (base < L) & (offs != 0)[None, :]
    return idx, in_range


def band_gather(v: Tensor, idx: Tensor) -> Tensor:
    """Gather neighbors along the band: v [B, L, D], idx [L, K] -> [B, L, K, D]."""
    return v[:, idx]


def check_mode(precision: str, chain_dtype=torch.float32) -> None:
    """Raise unless (precision, chain_dtype) is a mode of the kernels."""
    if precision not in PASSES:
        raise ValueError(f"precision {precision!r}: expected one of {tuple(PASSES)}")
    if chain_dtype not in CHAIN_DTYPES:
        raise ValueError(f"chain_dtype={chain_dtype}: the band kernels' edge chain is "
                         f"one of {CHAIN_DTYPES}")


def _chain_bf16(chain_dtype) -> int:
    return int(chain_dtype == torch.bfloat16)


def native_width(Hd: int) -> int:
    """The width the kernels run a band layer of hidden width Hd at: the
    narrowest native width (NATIVE_HIDDEN) that holds Hd, or above
    MAX_NATIVE the next multiple of WIDE_GROUP (the kernels above 512). Raises
    for Hd < 1."""
    if Hd < 1:
        raise ValueError(f"hidden width {Hd}: the band kernels take widths of at least 1")
    for n in NATIVE_HIDDEN:
        if Hd <= n:
            return n
    return -(-Hd // WIDE_GROUP) * WIDE_GROUP


def pad_band_width(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                   width: int) -> tuple[Tensor, ...]:
    """The band inputs zero-padded from hidden width Hd to ``width``: a, bs
    [B, L, width]; w_d, b_e2, b_x1, w_x2 flat [width]; w_e2, w_x1 [width,
    width]; x, cmask and b_x2 as given. In the kernels' argument order.

    The padded function equals the real one on the real columns, and its
    gradient on the real entries, up to summation order (a sum gains exact
    zero terms):
    - a padded column's pre-activation is 0 + 0 + d2 * 0 = 0, and
      silu(0) = 0, so m1 is 0 there (in the bf16 chain too);
    - the zero rows of w_e2 / w_x1 add nothing to a real column of u / v,
      and their zero columns and biases make the padded u, v 0, so m and
      silu(v) are 0 there: ``agg``'s padded columns are 0 (sliced off), and
      the zero entries of w_x2 add nothing to ``raw_delta``;
    - backward, every padded cotangent meets a zero weight: cot_v is
      cot_wsc * w_x2 * silu'(v), 0 on padded columns; the padded g_agg is
      0, so cot_m, cot_u and cot_pre are 0 there, and they add nothing to
      the real columns through the zero rows of w_x1^T and w_e2^T; each
      real weight-grad entry sums products of real columns only."""
    p = width - a.shape[-1]
    flat = lambda t: F.pad(t.reshape(-1), (0, p))  # noqa: E731
    square = lambda t: F.pad(t, (0, p, 0, p))      # noqa: E731
    return (F.pad(a, (0, p)), F.pad(bs, (0, p)), x, cmask, flat(w_d), square(w_e2),
            flat(b_e2), square(w_x1), flat(b_x1), flat(w_x2), b_x2)


def band_chain(a, bs, x, nbr_idx, valid, w_d, w_e2, b_e2, w_x1, b_x1, w_x2,
               b_x2, dtype: torch.dtype, tp=None) -> tuple[Tensor, Tensor]:
    """The band-gather formulation, materialising the [B, L, K, Hd] edge
    tensors, with the edge chain in ``dtype``: ``a``, ``bs``, the weights
    and the squared distances (computed in fp32) are cast to it, and
    ``raw_delta`` is summed in ``x``'s dtype. ``nbr_idx`` [L, K] and
    ``valid`` [B, L, K] as ``band_indices`` and the caller's masks give
    them. fp32 is the kernels' chain (``egnn_band_reference``); bf16 is a
    bf16 model's plain path, the JAX package's XLA band path at bf16.
    Under tensor parallelism (``tp``, a ``parallel.shard.TP``) ``a``, ``bs``,
    ``w_d``, ``w_x1`` and ``b_x1`` hold this rank's hidden columns and
    ``w_e2``, ``w_x2`` its rows; the products through ``w_e2`` and ``w_x2``
    are summed over the tp group before their biases.
    Returns (agg [B, L, Hd] in ``dtype``, raw_delta [B, L, 3])."""
    c = lambda t: t.to(dtype)  # noqa: E731
    mask_k = c(valid)[..., None]                                 # [B, L, K, 1]
    rel = x[:, :, None, :] - band_gather(x, nbr_idx)             # [B, L, K, 3]
    d2 = copy_to_tp(c(torch.sum(rel * rel, dim=-1, keepdim=True)), tp)
    pre = c(a)[:, :, None, :] + band_gather(c(bs), nbr_idx) + d2 * c(w_d).reshape(-1)
    m = F.silu(pre)
    m = F.silu(reduce_from_tp(m @ c(w_e2), tp) + c(b_e2).reshape(-1))
    agg = torch.sum(m * mask_k, dim=2)
    w = reduce_from_tp(F.silu(copy_to_tp(m, tp) @ c(w_x1) + c(b_x1).reshape(-1))
                       @ c(w_x2).reshape(-1, 1), tp) + c(b_x2).reshape(1)
    raw_delta = torch.sum((w * mask_k).to(x.dtype) * rel, dim=2)
    return agg, raw_delta


def egnn_band_reference(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2,
                        b_x2, W: int, chain_dtype=torch.float32) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version, same arguments and outputs as the kernel. The
    fp32 chain is ``band_chain`` in fp32 (bf16 ``a`` / ``bs`` upcast). The
    bf16 chain is ``_bf16_chain_edges``, the JAX kernel's rounding op by op;
    its gradient is ``_bf16_chain_backward`` (``_BF16ChainPlain``)."""
    if _chain_bf16(chain_dtype):
        return _BF16ChainPlain.apply(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1,
                                     w_x2, b_x2, W)
    idx, in_range = band_indices(a.shape[1], W, a.device)
    cm = cmask > 0.5
    valid = in_range[None] & cm[:, :, None] & cm[:, idx]
    return band_chain(a, bs, x, idx, valid, w_d, w_e2, b_e2, w_x1, b_x1, w_x2,
                      b_x2, torch.float32)


# ---- the bf16 chain's plain version --------------------------------------
# JAX's `_fwd_kernel` / `_edge_chain_cotangents` with cdt = bf16: torch's bf16
# ops compute in fp32 and round their result to bf16, as the JAX kernel's
# ops on bf16 arrays do, so each expression below rounds where JAX rounds.

def _bf16_sigmoid(x: Tensor) -> Tensor:
    one = x.new_ones(())
    return one / (one + torch.exp(-x))          # JAX `_sigmoid`


def _bf16_silu(x: Tensor) -> Tensor:
    return x * _bf16_sigmoid(x)                 # JAX `_silu`


def _bf16_dsilu(x: Tensor) -> Tensor:
    one = x.new_ones(())
    s = _bf16_sigmoid(x)
    return s * (one + x * (one - s))            # JAX `_dsilu`


def _bf16_mm(a: Tensor, b: Tensor) -> Tensor:
    """JAX `_mm` into bf16: bf16 operands, fp32 sums, rounded once."""
    return (a.float() @ b.float()).to(torch.bfloat16)


def _bf16_chain_edges(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                      W: int) -> dict:
    """The bf16 chain's forward on every band edge [B, L, K] (K = 2W+1):
    the weights cast to bf16 (JAX `_param_tuple`), a / bs cast to bf16,
    d2 summed in fp32 then cast. Returns the edge tensors the forward and
    the backward read: valid_f, rel, d2 (fp32), pre, m1, u, m, v, w1, wsc
    (bf16), the bf16 weights and the band indices."""
    bf = torch.bfloat16
    idx, in_range = band_indices(a.shape[1], W, a.device)
    cm = cmask > 0.5
    valid_f = (in_range[None] & cm[:, :, None] & cm[:, idx]).float()[..., None]
    w = dict(w_d=w_d.reshape(-1), w_e2=w_e2, b_e2=b_e2.reshape(-1), w_x1=w_x1,
             b_x1=b_x1.reshape(-1), w_x2=w_x2.reshape(-1, 1), b_x2=b_x2.reshape(1))
    w = {k: v.to(bf) for k, v in w.items()}
    xf = x.float()
    rel = xf[:, :, None, :] - band_gather(xf, idx)                # [B, L, K, 3]
    d2 = torch.sum(rel * rel, dim=-1, keepdim=True)
    pre = (a.to(bf)[:, :, None, :] + band_gather(bs.to(bf), idx)) + d2.to(bf) * w["w_d"]
    m1 = _bf16_silu(pre)
    u = _bf16_mm(m1, w["w_e2"]) + w["b_e2"]
    m = _bf16_silu(u)
    v = _bf16_mm(m, w["w_x1"]) + w["b_x1"]
    w1 = _bf16_silu(v)
    wsc = _bf16_mm(w1, w["w_x2"]) + w["b_x2"]                     # [B, L, K, 1]
    return dict(valid_f=valid_f, rel=rel, d2=d2, pre=pre, m1=m1, u=u, m=m, v=v,
                w1=w1, wsc=wsc, w=w, idx=idx)


def _bf16_chain_forward(e: dict) -> tuple[Tensor, Tensor]:
    """(agg, raw_delta) from ``_bf16_chain_edges``: fp32 sums over the band
    of the masked bf16 messages and of wsc * rel."""
    valid = e["valid_f"].to(torch.bfloat16)
    agg = (e["m"] * valid).float().sum(dim=2)
    raw_delta = ((e["wsc"] * valid).float() * e["rel"]).sum(dim=2)
    return agg, raw_delta


def _bf16_chain_backward(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                         g_agg, g_delta, W: int) -> tuple[Tensor, ...]:
    """The bf16 chain's gradient as JAX's `_edge_chain_cotangents` rounds it:
    g_agg and cot_wsc cast to bf16, the cotangent chain in bf16 ops and
    products, cot_d2 and every sum over edges in fp32. Returns the gradients
    of (a, bs, x, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2), each shaped like
    its input, a / bs in their dtype, the rest fp32."""
    bf = torch.bfloat16
    e = _bf16_chain_edges(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2, W)
    w, idx, valid_f, rel = e["w"], e["idx"], e["valid_f"], e["rel"]
    valid = valid_f.to(bf)
    B, L, K = valid_f.shape[:3]
    gd = g_delta.float()[:, :, None, :]
    cot_wsc_f = torch.sum(gd * rel, dim=-1, keepdim=True) * valid_f
    cot_wsc = cot_wsc_f.to(bf)
    cot_w1 = _bf16_mm(cot_wsc, w["w_x2"].t())
    cot_v = cot_w1 * _bf16_dsilu(e["v"])
    cot_m = g_agg.to(bf)[:, :, None, :] * valid + _bf16_mm(cot_v, w["w_x1"].t())
    cot_u = cot_m * _bf16_dsilu(e["u"])
    cot_pre = _bf16_mm(cot_u, w["w_e2"].t()) * _bf16_dsilu(e["pre"])
    cot_d2 = torch.sum((cot_pre * w["w_d"]).float(), dim=-1, keepdim=True)
    d_rel = gd * (e["wsc"].float() * valid_f) + 2.0 * rel * cot_d2
    cp = cot_pre.float()

    def to_senders(t: Tensor) -> Tensor:
        """Sum edge values [B, L, K, D] onto their sender residues."""
        out = t.new_zeros((B, L, t.shape[-1]))
        return out.index_add_(1, idx.reshape(-1), t.reshape(B, L * K, -1))

    def outer(p: Tensor, q: Tensor) -> Tensor:
        """Sum over edges of p^T q (bf16 operands, fp32 sums)."""
        return p.float().reshape(-1, p.shape[-1]).t() @ q.float().reshape(-1, q.shape[-1])

    def vsum(t: Tensor) -> Tensor:
        return t.float().reshape(-1, t.shape[-1]).sum(dim=0)

    return (cp.sum(dim=2).to(a.dtype), to_senders(cp).to(bs.dtype),
            (d_rel.sum(dim=2) - to_senders(d_rel)).to(x.dtype),
            vsum(cp * e["d2"]).reshape(w_d.shape), outer(e["m1"], cot_u),
            vsum(cot_u).reshape(b_e2.shape), outer(e["m"], cot_v),
            vsum(cot_v).reshape(b_x1.shape), outer(e["w1"], cot_wsc).reshape(w_x2.shape),
            cot_wsc_f.sum().reshape(b_x2.shape))


class _BF16ChainPlain(torch.autograd.Function):
    """The bf16 chain's plain version with its plain gradient: forward
    ``_bf16_chain_edges``, backward ``_bf16_chain_backward`` (JAX's rounding
    points, not autograd through the rounded forward)."""

    @staticmethod
    def forward(ctx, a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2, W):
        ctx.W = W
        ctx.save_for_backward(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2)
        return _bf16_chain_forward(_bf16_chain_edges(a, bs, x, cmask, w_d, w_e2, b_e2,
                                                     w_x1, b_x1, w_x2, b_x2, W))

    @staticmethod
    @once_differentiable
    def backward(ctx, g_agg, g_delta):
        a, bs, x, cmask, *params = ctx.saved_tensors
        g_agg = torch.zeros(a.shape, device=a.device) if g_agg is None else g_agg
        g_delta = torch.zeros(x.shape, device=x.device) if g_delta is None else g_delta
        da, dbs, dx, *dparams = _bf16_chain_backward(a, bs, x, cmask, *params, g_agg,
                                                     g_delta, ctx.W)
        return (da, dbs, dx, None, *dparams, None)


def _kernel_fn():
    global _FN
    if _FN is None:
        from protein_ensemble_vae_torch.ops.kernels.build import load_library

        lib = load_library(KERNEL)
        fn = lib.egnn_band_fwd_launch
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.egnn_band_fwd_wide_launch.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
                                                  + [ctypes.c_void_p])
        lib.egnn_band_fwd_wide_launch.restype = ctypes.c_int
        lib.egnn_band_fwd_wide_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.egnn_band_fwd_wide_scratch_floats.restype = ctypes.c_size_t
        lib.egnn_band_fwd_error_string.argtypes = [ctypes.c_int]
        lib.egnn_band_fwd_error_string.restype = ctypes.c_char_p
        lib.egnn_band_fwd_blocks_per_sm.argtypes = [ctypes.c_int] * 4
        lib.egnn_band_fwd_blocks_per_sm.restype = ctypes.c_int
        _FN = (fn, lib)
    return _FN


def _check(name: str, t: Tensor, shape: tuple, device,
           dtypes: tuple = (torch.float32,)) -> None:
    """Raise unless ``t`` is what the kernel reads: of one of ``dtypes``,
    contiguous, 16-byte aligned, on ``device``, of ``shape`` (a 1-D
    ``shape`` accepts any layout of that many elements, e.g. [1, Hd] or
    [Hd, 1]). Nothing is copied to make it so."""
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    ok = (t.numel() == shape[0]) if len(shape) == 1 else tuple(t.shape) == shape
    if not ok:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def unpad_band_grads(grads, a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2,
                     b_x2) -> tuple[Tensor, ...]:
    """The gradients of a call on ``pad_band_width``'s inputs, (a, bs, x,
    w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2) at the padded width, sliced
    back to the real inputs given after them: each shaped like its input
    (views of the padded gradients). At the real width it returns them as
    they are."""
    Hd = a.shape[-1]
    da, dbs, dx, dw_d, dw_e2, db_e2, dw_x1, db_x1, dw_x2, db_x2 = grads
    vec = lambda g, t: g.reshape(-1)[:Hd].reshape(t.shape)  # noqa: E731
    return (da[..., :Hd], dbs[..., :Hd], dx, vec(dw_d, w_d), dw_e2[:Hd, :Hd],
            vec(db_e2, b_e2), dw_x1[:Hd, :Hd], vec(db_x1, b_x1), vec(dw_x2, w_x2), db_x2)


def _check_inputs(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                  W: int) -> None:
    """Raise unless the band inputs are what both kernels take: a width of
    at least 1 (``native_width``), a and bs of one dtype of INPUT_DTYPES,
    everything else fp32."""
    B, L, Hd = a.shape
    native_width(Hd)
    if W < 1:
        raise ValueError(f"band half-width W={W} must be >= 1")
    if bs.dtype != a.dtype:
        raise ValueError(f"a and bs must share a dtype, got {a.dtype} and {bs.dtype}")
    for name, t, shape in (("a", a, (B, L, Hd)), ("bs", bs, (B, L, Hd))):
        _check(name, t, shape, a.device, INPUT_DTYPES)
    for name, t, shape in (
            ("x", x, (B, L, 3)), ("cmask", cmask, (B, L)), ("w_d", w_d, (Hd,)),
            ("w_e2", w_e2, (Hd, Hd)), ("b_e2", b_e2, (Hd,)),
            ("w_x1", w_x1, (Hd, Hd)), ("b_x1", b_x1, (Hd,)),
            ("w_x2", w_x2, (Hd,)), ("b_x2", b_x2, (1,))):
        _check(name, t, shape, a.device)


def mode_key(kernel: str, dtype: torch.dtype, precision: str,
             chain_dtype=torch.float32) -> str:
    """Key of a mode in ``BAND_MODE_LAUNCHES``:
    ``<kernel>:<dtype of a / bs>/<precision>`` in the fp32 chain,
    ``<kernel>:<dtype of a / bs>/bfloat16_chain`` in the bf16 chain, where
    ``precision`` selects nothing."""
    mode = "bfloat16_chain" if _chain_bf16(chain_dtype) else precision
    return f"{kernel}:{str(dtype).replace('torch.', '')}/{mode}"


def _count(kernel: str, dtype: torch.dtype, precision: str, chain_dtype) -> None:
    """One launch of ``kernel`` in the mode (dtype of a / bs, precision, chain)."""
    LAUNCHES[kernel] += 1
    key = mode_key(kernel, dtype, precision, chain_dtype)
    BAND_MODE_LAUNCHES[key] = BAND_MODE_LAUNCHES.get(key, 0) + 1


def egnn_band_fwd(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                  W: int, precision: str = "highest",
                  chain_dtype=torch.float32) -> tuple[Tensor, Tensor]:
    """The kernel's wrapper. For CPU tensors it is the plain version; for
    CUDA tensors it launches the kernel on the current stream or raises.

    a, bs [B, L, Hd], both fp32 or both bf16; x [B, L, 3]; cmask [B, L];
    w_d [1, Hd] or [Hd]; w_e2, w_x1 [Hd, Hd]; b_e2, b_x1 [Hd]; w_x2 [Hd, 1]
    or [Hd]; b_x2 [1]; all but a, bs fp32; Hd >= 1 (a width the kernels do
    not take runs zero-padded to ``native_width(Hd)``, ``pad_band_width``).
    ``precision`` and ``chain_dtype`` as in the module docstring. Returns
    (agg [B, L, Hd], raw_delta [B, L, 3]), fp32.
    """
    check_mode(precision, chain_dtype)
    if not a.is_cuda:
        return egnn_band_reference(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1,
                                   b_x1, w_x2, b_x2, W, chain_dtype)
    with span("band.fwd"):
        return _fwd_cuda(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                         W, precision, chain_dtype)


def _fwd_cuda(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2, W: int,
              precision: str, chain_dtype) -> tuple[Tensor, Tensor]:
    """``egnn_band_fwd``'s host work for CUDA tensors: checks, padding,
    outputs, planning, scratch, weight images and the launch."""
    B, L, Hd = a.shape
    dev = a.device
    _check_inputs(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2, W)
    n = native_width(Hd)
    if n != Hd:
        agg, delta = _fwd_cuda(*pad_band_width(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1,
                                               b_x1, w_x2, b_x2, n),
                               W, precision, chain_dtype)
        return agg[..., :Hd], delta
    agg = torch.empty((B, L, Hd), dtype=torch.float32, device=dev)
    delta = torch.empty((B, L, 3), dtype=torch.float32, device=dev)
    if B == 0 or L == 0:
        return agg, delta
    weights = (w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2)
    if takes_wide(Hd, precision, chain_dtype):
        return _fwd_sm90_wide(a, bs, x, cmask, weights, agg, delta, W, precision, chain_dtype)
    if takes_hd512(Hd, precision, chain_dtype):
        return _fwd_hd512(a, bs, x, cmask, weights, agg, delta, W, precision, chain_dtype)
    # the rest of the native widths (SM90_HIDDEN) in one pass or the bf16 chain
    return _fwd_sm90(a, bs, x, cmask, weights, agg, delta, W, precision, chain_dtype)


def _sm90_fn():
    global _SM90_FN
    if _SM90_FN is None:
        from protein_ensemble_vae_torch.ops.kernels.build import load_library

        lib = load_library(SM90_KERNEL)
        fn = lib.egnn_band_fwd_sm90_launch
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.egnn_band_fwd_sm90_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.egnn_band_fwd_sm90_blocks_per_sm.restype = ctypes.c_int
        lib.egnn_bf16_weight_images.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                                                + [ctypes.c_void_p] * 2)
        lib.egnn_bf16_weight_images.restype = ctypes.c_int
        lib.egnn_band_fwd_sm90_error_string.argtypes = [ctypes.c_int]
        lib.egnn_band_fwd_sm90_error_string.restype = ctypes.c_char_p
        lib.egnn_sm90_weight_images.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                                                + [ctypes.c_void_p] * 2)
        lib.egnn_sm90_weight_images.restype = ctypes.c_int
        _SM90_FN = (fn, lib)
    return _SM90_FN


def sm90_fwd_plan(B: int, L: int, W: int, Hd: int, dev,
                  dtype: torch.dtype = torch.bfloat16, precision: str = "default",
                  chain_dtype=torch.float32) -> tuple[int, int, int]:
    """``sm90_fwd_plan_of`` (``hd512_fwd_plan_of`` for the shared-tile
    kernel: width 512, or 3xTF32) on CUDA device ``dev``: its SM count and
    the blocks of the Hopper kernel 1 of the mode that one SM holds."""
    if takes_hd512(Hd, precision, chain_dtype):
        lib = _hd512_fn()[1]
        per_sm = _blocks_per_sm(HD512_KERNEL, lambda hd, b16, passes, cb: (
            lib.egnn_band_fwd_sm90_hd512_blocks_per_sm(hd, b16, BF16_CHAIN if cb else passes)),
            Hd, dev, dtype, precision, chain_dtype)
        return hd512_fwd_plan_of(B, L, W, _sm_count(dev), per_sm)
    lib = _sm90_fn()[1]
    per_sm = _blocks_per_sm(SM90_KERNEL, lambda hd, b16, passes, cb: (
        lib.egnn_band_fwd_sm90_blocks_per_sm(hd, b16, BF16_CHAIN if cb else 1)),
        Hd, dev, dtype, "default", chain_dtype)
    return sm90_fwd_plan_of(B, L, W, _sm_count(dev), per_sm)


def _image_words(Hd: int, passes: int) -> int:
    """Words of one weight's images in a mode of the Hopper kernels: Wb
    (and Ws in 3xTF32) in fp32, or its bf16 image in the bf16 chain."""
    return bf16_image_words(Hd) if passes == BF16_CHAIN else (2 if passes == 3 else 1) * Hd * Hd


def _fwd_sm90(a, bs, x, cmask, weights, agg, delta, W, precision,
              chain_dtype=torch.float32) -> tuple[Tensor, Tensor]:
    """Kernel 1 on Hopper (the one-pass fp32 chain or the bf16 chain at a
    width of SM90_HIDDEN): one C call writes the weight images, runs the
    kernel on the ``sm90_fwd_plan`` grid and, with S > 1 slices, sums their
    partials. The images and the partials share one scratch allocation."""
    B, L, Hd = a.shape
    dev = a.device
    fn, lib = _sm90_fn()
    passes = kernel_passes(precision, chain_dtype)
    S, _, G = sm90_fwd_plan(B, L, W, Hd, dev, a.dtype, precision, chain_dtype)
    n_img = 2 * _image_words(Hd, passes)
    n_part = (S * B * L * Hd, S * B * L * 3) if S > 1 else (0, 0)
    scratch = torch.empty((n_img + sum(n_part),), dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    parts = (base + 4 * n_img, base + 4 * (n_img + n_part[0])) if S > 1 else (None, None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a.data_ptr(), bs.data_ptr(), x.data_ptr(), cmask.data_ptr(),
                 *(t.data_ptr() for t in weights), base, agg.data_ptr(), delta.data_ptr(),
                 *parts, B, L, Hd, W, S, G, int(a.dtype == torch.bfloat16), passes, stream)
    if err != 0:
        raise RuntimeError(f"{SM90_KERNEL} launch failed: CUDA error {err} "
                           f"({lib.egnn_band_fwd_sm90_error_string(err).decode()})")
    _count(SM90_KERNEL, a.dtype, precision, chain_dtype)
    return agg, delta


def _hd512_fn():
    global _HD512_FN
    if _HD512_FN is None:
        from protein_ensemble_vae_torch.ops.kernels.build import load_library

        lib = load_library(HD512_KERNEL)
        fn = lib.egnn_band_fwd_sm90_hd512_launch
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.egnn_band_fwd_sm90_hd512_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.egnn_band_fwd_sm90_hd512_blocks_per_sm.restype = ctypes.c_int
        lib.egnn_band_fwd_sm90_hd512_error_string.argtypes = [ctypes.c_int]
        lib.egnn_band_fwd_sm90_hd512_error_string.restype = ctypes.c_char_p
        lib.egnn_hd512_weight_images.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                                 + [ctypes.c_void_p] * 2)
        lib.egnn_hd512_weight_images.restype = ctypes.c_int
        _HD512_FN = (fn, lib)
    return _HD512_FN


def _fwd_hd512(a, bs, x, cmask, weights, agg, delta, W, precision,
               chain_dtype=torch.float32) -> tuple[Tensor, Tensor]:
    """Kernel 1 on the shared-tile Hopper kernel (width 512 in every mode,
    3xTF32 at SM90_HIDDEN): one C call writes the weight images (Wb, and Ws
    in 3xTF32, of W_e2 and W_x1; their bf16 images in the bf16 chain), runs
    the kernel on the ``sm90_fwd_plan`` grid and, with S > 1 slices, sums
    their partials. The images and the partials share one scratch
    allocation; the launch counts under ``band_kernel``'s name."""
    B, L, Hd = a.shape
    dev = a.device
    fn, lib = _hd512_fn()
    passes = kernel_passes(precision, chain_dtype)
    S, _, G = sm90_fwd_plan(B, L, W, Hd, dev, a.dtype, precision, chain_dtype)
    n_img = 2 * _image_words(Hd, passes)
    n_part = (S * B * L * Hd, S * B * L * 3) if S > 1 else (0, 0)
    scratch = torch.empty((n_img + sum(n_part),), dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    parts = (base + 4 * n_img, base + 4 * (n_img + n_part[0])) if S > 1 else (None, None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a.data_ptr(), bs.data_ptr(), x.data_ptr(), cmask.data_ptr(),
                 *(t.data_ptr() for t in weights), base, agg.data_ptr(), delta.data_ptr(),
                 *parts, B, L, Hd, W, S, G, int(a.dtype == torch.bfloat16), passes, stream)
    name = band_kernel(KERNEL, Hd, precision, chain_dtype)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.egnn_band_fwd_sm90_hd512_error_string(err).decode()})")
    _count(name, a.dtype, precision, chain_dtype)
    return agg, delta


def hd512_weight_images(ws, orients, parts, nw: int, hmajor: bool) -> Tensor:
    """The shared-tile kernels' layout kernel alone: the images of the CUDA
    fp32 [Hd, Hd] weights ``ws`` (Hd 512 or a width of SM90_HIDDEN) in
    orientations ``orients``, parts ``parts`` (0 big, 1 small), ``nw``
    columns per chunk (``shared_tile_nw``) and the chunk order ``hmajor``,
    [len(ws), Hd * Hd], as the kernels' C entries write them (for tests
    against ``weight_image_hd512``)."""
    Hd, dev = ws[0].shape[0], ws[0].device
    lib = _hd512_fn()[1]
    out = torch.empty((len(ws), Hd * Hd), dtype=torch.float32, device=dev)
    srcs = (ctypes.c_void_p * len(ws))(*(w.data_ptr() for w in ws))
    kinds = (ctypes.c_int * len(ws))(*orients)
    pieces = (ctypes.c_int * len(ws))(*parts)
    with torch.cuda.device(dev):
        err = lib.egnn_hd512_weight_images(
            ctypes.cast(srcs, ctypes.c_void_p), ctypes.cast(kinds, ctypes.c_void_p),
            ctypes.cast(pieces, ctypes.c_void_p), len(ws), Hd, nw, int(hmajor), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"egnn_hd512_weight_images failed: CUDA error {err}")
    return out


def weight_image_bf16(w, orient: int, nw: int, halves: int = 1, hmajor: bool = False):
    """numpy mirror of the bf16 chain's layout kernel (egnn_sm90.cuh:
    weight_images_bf16): the Hd x Hd fp32 weight ``w`` rounded to bf16 (to
    nearest even) as the Hopper kernels stream it in the bf16 chain:
    ``halves`` parts of Hd / halves output columns (2: the shared-tile
    kernel's consumers), each of chunks of ``nw`` output rows x one K block
    of 64 K values (32 words of two bf16, K padded with zeros to one block
    at Hd 32), in the order (K block, column group), or with ``hmajor``
    (column group, K block), each chunk's words in the 128-byte swizzle.
    ``orient`` as ``weight_image``. Returns the flat image as uint16 bf16
    bit patterns, 2 x ``bf16_image_words(Hd)`` of them (word w's K value 2w
    first)."""
    w = np.asarray(w, dtype=np.float32)
    Hd = w.shape[0]
    kw = max(Hd // 2, SM90_KB)
    nkc, cols = kw // SM90_KB, Hd // halves
    nh = cols // nw
    e = np.arange(kw * Hd)
    half, eh = e // (kw * cols), e % (kw * cols)
    q, r = eh // (nw * SM90_KB), eh % (nw * SM90_KB)
    nl, pos = r // SM90_KB, r % SM90_KB
    kl = ((((pos >> 2) ^ (nl & 7)) & 7) << 2) | (pos & 3)
    h, kc = (q // nkc, q % nkc) if hmajor else (q % nh, q // nh)
    n = half * cols + h * nw + nl
    k = np.stack([2 * (kc * SM90_KB + kl), 2 * (kc * SM90_KB + kl) + 1], axis=-1)
    kk = np.minimum(k, Hd - 1)
    v = w[kk, n[:, None]] if orient == IMG_T else w[n[:, None], kk]
    return bf16_bits(np.where(k < Hd, v, np.float32(0)).reshape(-1))


def bf16_bits(v):
    """numpy float32 values rounded to bf16 (to nearest, ties to even, as
    torch's cast), as uint16 bit patterns."""
    u = np.asarray(v, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + np.uint64(0x7FFF) + ((u >> np.uint64(16)) & np.uint64(1))) >> np.uint64(16)
    return u.astype(np.uint16)


def bf16_weight_images(ws, orients, nw: int, halves: int = 1, hmajor: bool = False) -> Tensor:
    """The bf16 chain's layout kernel alone: the bf16 images of the CUDA
    fp32 [Hd, Hd] weights ``ws`` in orientations ``orients``, chunk order
    (``nw``, ``halves``, ``hmajor``), [len(ws), 2 * bf16_image_words(Hd)]
    bf16, as the C entries of every Hopper family write them (for tests
    against ``weight_image_bf16``)."""
    Hd, dev = ws[0].shape[0], ws[0].device
    lib = _sm90_fn()[1]
    out = torch.empty((len(ws), 2 * bf16_image_words(Hd)), dtype=torch.bfloat16, device=dev)
    srcs = (ctypes.c_void_p * len(ws))(*(w.data_ptr() for w in ws))
    kinds = (ctypes.c_int * len(ws))(*orients)
    with torch.cuda.device(dev):
        err = lib.egnn_bf16_weight_images(
            ctypes.cast(srcs, ctypes.c_void_p), ctypes.cast(kinds, ctypes.c_void_p), len(ws), Hd,
            nw, halves, int(hmajor), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"egnn_bf16_weight_images failed: CUDA error {err}")
    return out


def sm90_weight_images(ws, orients) -> Tensor:
    """The layout kernel alone: the images of the CUDA fp32 [Hd, Hd] weights
    ``ws`` in orientations ``orients`` (IMG_T / IMG_N), [len(ws), Hd * Hd],
    as the band kernels' C entries write them (for tests against
    ``weight_image``)."""
    Hd, dev = ws[0].shape[0], ws[0].device
    lib = _sm90_fn()[1]
    out = torch.empty((len(ws), Hd * Hd), dtype=torch.float32, device=dev)
    srcs = (ctypes.c_void_p * len(ws))(*(w.data_ptr() for w in ws))
    kinds = (ctypes.c_int * len(ws))(*orients)
    with torch.cuda.device(dev):
        err = lib.egnn_sm90_weight_images(ctypes.cast(srcs, ctypes.c_void_p),
                                          ctypes.cast(kinds, ctypes.c_void_p), len(ws), Hd,
                                          out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"egnn_sm90_weight_images failed: CUDA error {err}")
    return out


def _wide_fn():
    global _WIDE_FN
    if _WIDE_FN is None:
        from protein_ensemble_vae_torch.ops.kernels.build import load_library

        lib = load_library(WIDE_KERNEL)
        fn = lib.egnn_band_fwd_sm90_wide_launch
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.egnn_band_fwd_sm90_wide_blocks_per_sm.argtypes = [ctypes.c_int] * 2
        lib.egnn_band_fwd_sm90_wide_blocks_per_sm.restype = ctypes.c_int
        lib.egnn_band_fwd_sm90_wide_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.egnn_band_fwd_sm90_wide_scratch_floats.restype = ctypes.c_size_t
        lib.egnn_band_fwd_sm90_wide_error_string.argtypes = [ctypes.c_int]
        lib.egnn_band_fwd_sm90_wide_error_string.restype = ctypes.c_char_p
        lib.egnn_wide_weight_images.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                                + [ctypes.c_void_p] * 2)
        lib.egnn_wide_weight_images.restype = ctypes.c_int
        _WIDE_FN = (fn, lib)
    return _WIDE_FN


def wide_fwd_plan(B: int, L: int, W: int, dev, dtype: torch.dtype = torch.float32,
                  precision: str = "highest", chain_dtype=torch.float32) -> tuple[int, int, int]:
    """``hd512_fwd_plan_of`` on CUDA device ``dev`` for kernel 1 above width
    512: its SM count and the blocks of that kernel one SM holds in the
    mode."""
    lib = _wide_fn()[1]
    per_sm = _blocks_per_sm(WIDE_KERNEL, lambda _, b16, passes, cb: (
        lib.egnn_band_fwd_sm90_wide_blocks_per_sm(b16, BF16_CHAIN if cb else passes)), 0, dev,
        dtype, precision, chain_dtype)
    return hd512_fwd_plan_of(B, L, W, _sm_count(dev), per_sm)


def _fwd_sm90_wide(a, bs, x, cmask, weights, agg, delta, W, precision,
                   chain_dtype=torch.float32) -> tuple[Tensor, Tensor]:
    """Kernel 1 above width 512 in every mode: one C call writes the weight
    images (Wb, and Ws in 3xTF32, of W_e2 and W_x1; their bf16 images in
    the bf16 chain) into the scratch, runs the kernel on the
    ``wide_fwd_plan`` grid (each block with its stream buffers in the
    scratch) and, with S > 1 slices, sums their partials, which share the
    allocation."""
    B, L, Hd = a.shape
    dev = a.device
    fn, lib = _wide_fn()
    passes = kernel_passes(precision, chain_dtype)
    S, _, G = wide_fwd_plan(B, L, W, dev, a.dtype, precision, chain_dtype)
    n_own = lib.egnn_band_fwd_sm90_wide_scratch_floats(Hd, G, passes)
    n_part = (S * B * L * Hd, S * B * L * 3) if S > 1 else (0, 0)
    scratch = torch.empty((n_own + sum(n_part),), dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    parts = (base + 4 * n_own, base + 4 * (n_own + n_part[0])) if S > 1 else (None, None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a.data_ptr(), bs.data_ptr(), x.data_ptr(), cmask.data_ptr(),
                 *(t.data_ptr() for t in weights), base, agg.data_ptr(), delta.data_ptr(),
                 *parts, B, L, Hd, W, S, G, int(a.dtype == torch.bfloat16), passes, stream)
    if err != 0:
        raise RuntimeError(f"{WIDE_KERNEL} launch failed: CUDA error {err} "
                           f"({lib.egnn_band_fwd_sm90_wide_error_string(err).decode()})")
    _count(WIDE_KERNEL, a.dtype, precision, chain_dtype)
    return agg, delta


def wide_weight_images(ws, orients, parts, nc: int) -> Tensor:
    """The wide kernels' layout kernel alone: the images of the CUDA fp32
    [Hd, Hd] weights ``ws`` in orientations ``orients``, parts ``parts`` (0
    big, 1 small), in chunks of ``nc`` rows (2 x WIDE_NW of the mode),
    [len(ws), Hd * Hd], as the kernels' C entries write them (for tests
    against ``weight_image_wide``)."""
    Hd, dev = ws[0].shape[0], ws[0].device
    lib = _wide_fn()[1]
    out = torch.empty((len(ws), Hd * Hd), dtype=torch.float32, device=dev)
    srcs = (ctypes.c_void_p * len(ws))(*(w.data_ptr() for w in ws))
    kinds = (ctypes.c_int * len(ws))(*orients)
    pieces = (ctypes.c_int * len(ws))(*parts)
    with torch.cuda.device(dev):
        err = lib.egnn_wide_weight_images(
            ctypes.cast(srcs, ctypes.c_void_p), ctypes.cast(kinds, ctypes.c_void_p),
            ctypes.cast(pieces, ctypes.c_void_p), len(ws), Hd, nc, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"egnn_wide_weight_images failed: CUDA error {err}")
    return out


def egnn_band_bwd_reference(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1,
                            w_x2, b_x2, g_agg, g_delta, W: int,
                            chain_dtype=torch.float32) -> tuple[Tensor, ...]:
    """Plain version of the backward: in the fp32 chain torch autograd
    through ``egnn_band_reference``, in the bf16 chain
    ``_bf16_chain_backward``. Returns the gradients of (a, bs, x, w_d,
    w_e2, b_e2, w_x1, b_x1, w_x2, b_x2), each shaped like its input and in
    its dtype."""
    if _chain_bf16(chain_dtype):
        return _bf16_chain_backward(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1,
                                    w_x2, b_x2, g_agg, g_delta, W)
    diff = [t.detach().requires_grad_(True)
            for t in (a, bs, x, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2)]
    with torch.enable_grad():
        a_, bs_, x_, *p = diff
        outs = egnn_band_reference(a_, bs_, x_, cmask, *p, W)
        return torch.autograd.grad(outs, diff, (g_agg, g_delta))


def _bwd_kernel_fn():
    global _BWD_FN
    if _BWD_FN is None:
        from protein_ensemble_vae_torch.ops.kernels.build import load_library

        lib = load_library(BWD_KERNEL)
        fn = lib.egnn_band_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.egnn_band_bwd_error_string.argtypes = [ctypes.c_int]
        lib.egnn_band_bwd_error_string.restype = ctypes.c_char_p
        lib.egnn_band_bwd_scratch_floats.argtypes = [ctypes.c_int] * 7
        lib.egnn_band_bwd_scratch_floats.restype = ctypes.c_size_t
        lib.egnn_band_bwd_blocks_per_sm.argtypes = [ctypes.c_int] * 4
        lib.egnn_band_bwd_blocks_per_sm.restype = ctypes.c_int
        _BWD_FN = (fn, lib)
    return _BWD_FN


def _blocks_per_sm(name: str, query, Hd: int, dev, dtype: torch.dtype,
                   precision: str, chain_dtype) -> int:
    """Blocks of kernel ``name`` in the mode (dtype of a / bs, precision,
    chain) at width Hd that one SM of ``dev`` holds, asked of its library
    once (``query``: its ``*_blocks_per_sm``)."""
    key = (name, Hd, dev, dtype, precision, chain_dtype)
    if key not in _PER_SM:
        with torch.cuda.device(dev):
            n = query(Hd, int(dtype == torch.bfloat16), PASSES[precision],
                      _chain_bf16(chain_dtype))
        if n < 1:
            raise RuntimeError(f"{name}: occupancy query failed (CUDA error "
                               f"{-n}) or no block fits on an SM")
        _PER_SM[key] = n
    return _PER_SM[key]


def fwd_plan(B: int, L: int, W: int, Hd: int, dev, dtype: torch.dtype = torch.float32,
             precision: str = "highest", chain_dtype=torch.float32) -> int:
    """``fwd_slices`` on CUDA device ``dev``: its SM count and the blocks
    of the mode that one SM holds."""
    per_sm = _blocks_per_sm(KERNEL, _kernel_fn()[1].egnn_band_fwd_blocks_per_sm, Hd, dev,
                            dtype, precision, chain_dtype)
    return fwd_slices(B, L, W, _sm_count(dev), per_sm)


def bwd_plan(B: int, L: int, W: int, Hd: int, dev, dtype: torch.dtype = torch.float32,
             precision: str = "highest", chain_dtype=torch.float32) -> tuple[int, int]:
    """``bwd_grid`` on CUDA device ``dev``: its SM count and the edge-pass
    blocks of the mode that one SM holds."""
    per_sm = _blocks_per_sm(BWD_KERNEL, _bwd_kernel_fn()[1].egnn_band_bwd_blocks_per_sm,
                            Hd, dev, dtype, precision, chain_dtype)
    return bwd_grid(B, L, W, Hd, _sm_count(dev), per_sm)


def egnn_band_bwd(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                  g_agg, g_delta, W: int, precision: str = "highest",
                  chain_dtype=torch.float32) -> tuple[Tensor, ...]:
    """The backward kernel's wrapper. For CPU tensors it is the plain
    version; for CUDA tensors it launches the kernel (four passes, one
    count) on the current stream or raises.

    Inputs as ``egnn_band_fwd`` plus the output cotangents g_agg [B, L, Hd]
    and g_delta [B, L, 3], fp32. Returns the gradients of (a, bs, x, w_d,
    w_e2, b_e2, w_x1, b_x1, w_x2, b_x2), each shaped like its input: those
    of a and bs in their dtype, the rest fp32. The kernel is deterministic:
    it sums across blocks in fixed order. A width outside NATIVE_HIDDEN
    runs zero-padded as in ``egnn_band_fwd`` (g_agg padded with zeros).
    """
    check_mode(precision, chain_dtype)
    if not a.is_cuda:
        return egnn_band_bwd_reference(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1,
                                       b_x1, w_x2, b_x2, g_agg, g_delta, W, chain_dtype)
    with span("band.bwd"):
        return _bwd_cuda(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                         g_agg, g_delta, W, precision, chain_dtype)


def _bwd_cuda(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2, g_agg, g_delta,
              W: int, precision: str, chain_dtype) -> tuple[Tensor, ...]:
    """``egnn_band_bwd``'s host work for CUDA tensors, as ``_fwd_cuda``."""
    B, L, Hd = a.shape
    dev = a.device
    _check_inputs(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2, W)
    _check("g_agg", g_agg, (B, L, Hd), dev)
    _check("g_delta", g_delta, (B, L, 3), dev)
    n = native_width(Hd)
    if n != Hd:
        args = (a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2)
        return unpad_band_grads(
            _bwd_cuda(*pad_band_width(*args, n), F.pad(g_agg, (0, n - Hd)), g_delta,
                      W, precision, chain_dtype), *args)
    f32 = dict(dtype=torch.float32, device=dev)
    alloc = torch.empty if B and L else torch.zeros
    da = alloc((B, L, Hd), dtype=a.dtype, device=dev)
    dbs = alloc((B, L, Hd), dtype=a.dtype, device=dev)
    dx = alloc((B, L, 3), **f32)
    dw_e2 = alloc((Hd, Hd), **f32)
    dw_x1 = alloc((Hd, Hd), **f32)
    dvec = alloc((4 * Hd + 1,), **f32)
    weights = (w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2)
    outs = (da, dbs, dx, dw_e2, dw_x1, dvec)
    if B and L and takes_wide(Hd, precision, chain_dtype):
        _bwd_sm90_wide(a, bs, x, cmask, weights, g_agg, g_delta, outs, W, precision, chain_dtype)
    elif B and L and takes_hd512(Hd, precision, chain_dtype):
        _bwd_hd512(a, bs, x, cmask, weights, g_agg, g_delta, outs, W, precision, chain_dtype)
    elif B and L:   # the rest of the native widths in one pass or the bf16 chain
        _bwd_sm90(a, bs, x, cmask, weights, g_agg, g_delta, outs, W, precision, chain_dtype)
    dw_d, db_e2, db_x1, dw_x2 = dvec[:4 * Hd].view(4, Hd)
    return (da, dbs, dx, dw_d.reshape(w_d.shape), dw_e2,
            db_e2.reshape(b_e2.shape), dw_x1, db_x1.reshape(b_x1.shape),
            dw_x2.reshape(w_x2.shape), dvec[4 * Hd:].reshape(b_x2.shape))


def _sm90_bwd_fn():
    global _SM90_BWD_FN
    if _SM90_BWD_FN is None:
        from protein_ensemble_vae_torch.ops.kernels.build import load_library

        lib = load_library(SM90_BWD_KERNEL)
        fn = lib.egnn_band_bwd_sm90_launch
        fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.egnn_band_bwd_sm90_scratch_floats.argtypes = [ctypes.c_int] * 7
        lib.egnn_band_bwd_sm90_scratch_floats.restype = ctypes.c_size_t
        lib.egnn_band_bwd_sm90_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.egnn_band_bwd_sm90_blocks_per_sm.restype = ctypes.c_int
        lib.egnn_band_bwd_sm90_error_string.argtypes = [ctypes.c_int]
        lib.egnn_band_bwd_sm90_error_string.restype = ctypes.c_char_p
        _SM90_BWD_FN = (fn, lib)
    return _SM90_BWD_FN


def sm90_bwd_grid(B: int, L: int, W: int, Hd: int, n_sm: int,
                  per_sm: int, shared: bool = False) -> tuple[int, int]:
    """Kernel 2's Hopper plan: G persistent edge-pass blocks (``per_sm`` on
    each of ``n_sm`` SMs, no more than the step pairs; block g takes pairs
    g, g + G, ...) and the weight-grad pass's slices of the steps, enough
    for its 2 x ceil(Hd / 64) x (Hd / NW) output tiles to fill two blocks
    per SM. On the shared-tile kernel (``shared``: width 512, or 3xTF32) a
    block takes single steps (items) g, g + G, ..., and the weight-grad
    pass's 2 x ceil(Hd / 64) x (Hd / TN) tiles of 64 x TN (TN =
    min(Hd, 64); 2 x 8 x 8 at 512) take as many slices as fit two blocks
    per SM in one wave."""
    n_tiles, n_steps, items = band_work(B, L, W)
    if shared or Hd == HD512:
        tn = min(Hd, HD512_WGRAD_TILE)
        tiles = 2 * -(-Hd // HD512_WGRAD_TILE) * (Hd // tn)
        return (max(1, min(items, n_sm * max(1, per_sm))),
                max(1, min(items, 2 * n_sm // tiles)))
    pairs = B * n_tiles * -(-n_steps // 2)
    nw, nh = sm90_cols(Hd)
    out_tiles = 2 * -(-Hd // SM90_WGRAD_M) * nh
    return (max(1, min(pairs, n_sm * max(1, per_sm))),
            max(1, min(items, -(-2 * n_sm // out_tiles))))


def sm90_bwd_plan(B: int, L: int, W: int, Hd: int, dev,
                  dtype: torch.dtype = torch.bfloat16, precision: str = "default",
                  chain_dtype=torch.float32) -> tuple[int, int]:
    """``sm90_bwd_grid`` on CUDA device ``dev``: its SM count and the
    edge-pass blocks of the Hopper kernel 2 (the shared-tile one at width
    512 or in 3xTF32) in the mode that one SM holds."""
    if takes_hd512(Hd, precision, chain_dtype):
        lib = _hd512_bwd_fn()[1]
        per_sm = _blocks_per_sm(HD512_BWD_KERNEL, lambda hd, b16, passes, cb: (
            lib.egnn_band_bwd_sm90_hd512_blocks_per_sm(hd, b16, BF16_CHAIN if cb else passes)),
            Hd, dev, dtype, precision, chain_dtype)
        return sm90_bwd_grid(B, L, W, Hd, _sm_count(dev), per_sm, shared=True)
    lib = _sm90_bwd_fn()[1]
    per_sm = _blocks_per_sm(SM90_BWD_KERNEL, lambda hd, b16, passes, cb: (
        lib.egnn_band_bwd_sm90_blocks_per_sm(hd, b16, BF16_CHAIN if cb else 1)),
        Hd, dev, dtype, "default", chain_dtype)
    return sm90_bwd_grid(B, L, W, Hd, _sm_count(dev), per_sm)


def _bwd_sm90(a, bs, x, cmask, weights, g_agg, g_delta, outs, W, precision,
              chain_dtype=torch.float32) -> None:
    """Kernel 2 on Hopper (the one-pass fp32 chain or the bf16 chain at a
    width of SM90_HIDDEN) into ``outs`` = (da, dbs, dx, dw_e2, dw_x1, dvec):
    one C call writes the four weight images into the scratch and runs the
    edge, node, weight-grad and reduce passes on the ``sm90_bwd_plan``
    grid."""
    B, L, Hd = a.shape
    dev = a.device
    fn, lib = _sm90_bwd_fn()
    passes = kernel_passes(precision, chain_dtype)
    G, nsplit = sm90_bwd_plan(B, L, W, Hd, dev, a.dtype, precision, chain_dtype)
    scratch = torch.empty(
        (lib.egnn_band_bwd_sm90_scratch_floats(B, L, Hd, W, G, nsplit, passes),),
        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in (a, bs, x, cmask, *weights, g_agg, g_delta, *outs,
                                          scratch)),
                 B, L, Hd, W, G, nsplit, int(a.dtype == torch.bfloat16), passes, stream)
    if err != 0:
        raise RuntimeError(f"{SM90_BWD_KERNEL} launch failed: CUDA error {err} "
                           f"({lib.egnn_band_bwd_sm90_error_string(err).decode()})")
    _count(SM90_BWD_KERNEL, a.dtype, precision, chain_dtype)


def _hd512_bwd_fn():
    global _HD512_BWD_FN
    if _HD512_BWD_FN is None:
        from protein_ensemble_vae_torch.ops.kernels.build import load_library

        lib = load_library(HD512_BWD_KERNEL)
        fn = lib.egnn_band_bwd_sm90_hd512_launch
        fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.egnn_band_bwd_sm90_hd512_scratch_floats.argtypes = [ctypes.c_int] * 7
        lib.egnn_band_bwd_sm90_hd512_scratch_floats.restype = ctypes.c_size_t
        lib.egnn_band_bwd_sm90_hd512_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.egnn_band_bwd_sm90_hd512_blocks_per_sm.restype = ctypes.c_int
        lib.egnn_band_bwd_sm90_hd512_error_string.argtypes = [ctypes.c_int]
        lib.egnn_band_bwd_sm90_hd512_error_string.restype = ctypes.c_char_p
        _HD512_BWD_FN = (fn, lib)
    return _HD512_BWD_FN


def _bwd_hd512(a, bs, x, cmask, weights, g_agg, g_delta, outs, W, precision,
               chain_dtype=torch.float32) -> None:
    """Kernel 2 on the shared-tile Hopper kernel (width 512 in every mode,
    3xTF32 at SM90_HIDDEN) into ``outs`` = (da, dbs, dx, dw_e2, dw_x1,
    dvec): one C call writes the weight images (four orientations, each Wb
    and in 3xTF32 Ws, or in the bf16 chain its bf16 image) into the scratch
    and runs the edge, node, weight-grad and reduce passes on the
    ``sm90_bwd_plan`` grid; the launch counts under ``band_kernel``'s
    name."""
    B, L, Hd = a.shape
    dev = a.device
    fn, lib = _hd512_bwd_fn()
    passes = kernel_passes(precision, chain_dtype)
    G, nsplit = sm90_bwd_plan(B, L, W, Hd, dev, a.dtype, precision, chain_dtype)
    scratch = torch.empty(
        (lib.egnn_band_bwd_sm90_hd512_scratch_floats(B, L, Hd, W, G, nsplit, passes),),
        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in (a, bs, x, cmask, *weights, g_agg, g_delta, *outs,
                                          scratch)),
                 B, L, Hd, W, G, nsplit, int(a.dtype == torch.bfloat16), passes, stream)
    name = band_kernel(BWD_KERNEL, Hd, precision, chain_dtype)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.egnn_band_bwd_sm90_hd512_error_string(err).decode()})")
    _count(name, a.dtype, precision, chain_dtype)


def _wide_bwd_fn():
    global _WIDE_BWD_FN
    if _WIDE_BWD_FN is None:
        from protein_ensemble_vae_torch.ops.kernels.build import load_library

        lib = load_library(WIDE_BWD_KERNEL)
        fn = lib.egnn_band_bwd_sm90_wide_launch
        fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.egnn_band_bwd_sm90_wide_scratch_floats.argtypes = [ctypes.c_int] * 7
        lib.egnn_band_bwd_sm90_wide_scratch_floats.restype = ctypes.c_size_t
        lib.egnn_band_bwd_sm90_wide_blocks_per_sm.argtypes = [ctypes.c_int] * 2
        lib.egnn_band_bwd_sm90_wide_blocks_per_sm.restype = ctypes.c_int
        lib.egnn_band_bwd_sm90_wide_error_string.argtypes = [ctypes.c_int]
        lib.egnn_band_bwd_sm90_wide_error_string.restype = ctypes.c_char_p
        _WIDE_BWD_FN = (fn, lib)
    return _WIDE_BWD_FN


def wide_bwd_plan(B: int, L: int, W: int, Hd: int, dev, dtype: torch.dtype = torch.float32,
                  precision: str = "highest", chain_dtype=torch.float32) -> tuple[int, int]:
    """Kernel 2's plan above width 512 on CUDA device ``dev``: as the
    shared-tile kernel's (``sm90_bwd_grid`` with ``shared``: a persistent
    edge pass over single steps, weight-grad tiles of 64 x 64), with the
    edge-pass blocks one SM holds in the mode."""
    lib = _wide_bwd_fn()[1]
    per_sm = _blocks_per_sm(WIDE_BWD_KERNEL, lambda _, b16, passes, cb: (
        lib.egnn_band_bwd_sm90_wide_blocks_per_sm(b16, BF16_CHAIN if cb else passes)), 0, dev,
        dtype, precision, chain_dtype)
    return sm90_bwd_grid(B, L, W, Hd, _sm_count(dev), per_sm, shared=True)


def _bwd_sm90_wide(a, bs, x, cmask, weights, g_agg, g_delta, outs, W, precision,
                   chain_dtype=torch.float32) -> None:
    """Kernel 2 above width 512 in every mode into ``outs`` = (da, dbs, dx,
    dw_e2, dw_x1, dvec): one C call writes the weight images (four
    orientations, each Wb and in 3xTF32 Ws, or in the bf16 chain its bf16
    image) into the scratch and runs the edge, node, weight-grad and reduce
    passes on the ``wide_bwd_plan`` grid."""
    B, L, Hd = a.shape
    dev = a.device
    fn, lib = _wide_bwd_fn()
    passes = kernel_passes(precision, chain_dtype)
    G, nsplit = wide_bwd_plan(B, L, W, Hd, dev, a.dtype, precision, chain_dtype)
    scratch = torch.empty(
        (lib.egnn_band_bwd_sm90_wide_scratch_floats(B, L, Hd, W, G, nsplit, passes),),
        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in (a, bs, x, cmask, *weights, g_agg, g_delta, *outs,
                                          scratch)),
                 B, L, Hd, W, G, nsplit, int(a.dtype == torch.bfloat16), passes, stream)
    if err != 0:
        raise RuntimeError(f"{WIDE_BWD_KERNEL} launch failed: CUDA error {err} "
                           f"({lib.egnn_band_bwd_sm90_wide_error_string(err).decode()})")
    _count(WIDE_BWD_KERNEL, a.dtype, precision, chain_dtype)


class EGNNBandFunction(torch.autograd.Function):
    """Kernel 1 forward, kernel 2 backward. Like the JAX custom VJP it saves
    only the inputs (nothing of size K = 2W+1): the backward recomputes
    the edge chain."""

    @staticmethod
    def forward(ctx, a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2,
                b_x2, W, precision="highest", chain_dtype=torch.float32):
        ctx.W, ctx.precision, ctx.chain_dtype = W, precision, chain_dtype
        ctx.save_for_backward(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1,
                              w_x2, b_x2)
        outs = egnn_band_fwd(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1,
                             w_x2, b_x2, W, precision, chain_dtype)
        check_outputs(KERNEL, *outs)
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, g_agg, g_delta):
        a, bs, x, cmask, *params = ctx.saved_tensors
        g_agg = (torch.zeros(a.shape, dtype=torch.float32, device=a.device)
                 if g_agg is None else g_agg.to(torch.float32).contiguous())
        g_delta = (torch.zeros_like(x) if g_delta is None
                   else g_delta.to(torch.float32).contiguous())
        da, dbs, dx, *dparams = egnn_band_bwd(a, bs, x, cmask, *params,
                                              g_agg, g_delta, ctx.W,
                                              ctx.precision, ctx.chain_dtype)
        check_outputs(BWD_KERNEL, da, dbs, dx, *dparams)
        return (da, dbs, dx, None, *dparams, None, None, None)


def egnn_band_fused(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2,
                    W: int, precision=None, chain_dtype=torch.float32, *,
                    use_pallas: object = "auto") -> tuple[Tensor, Tensor]:
    """Routed entry of the decoder: ``EGNNBandFunction`` (kernel forward and
    backward) where ``pallas_policy`` says so (``ops/routing.py``), else the
    plain version, whose gradient is torch autograd (in the bf16 chain
    ``_bf16_chain_backward``, JAX's rounding points). The JAX function's
    arguments in its order: ``precision`` (None, JAX's default, is
    ``"default"``, one TF32 pass on the card; ``"highest"`` is
    Precision.HIGHEST) and ``chain_dtype`` as in the module docstring; the
    port's routing knob ``use_pallas`` (``ModelConfig.use_pallas_egnn``)
    follows as a keyword."""
    precision = "default" if precision is None else precision
    check_mode(precision, chain_dtype)
    if pallas_policy(a, use_pallas):
        return EGNNBandFunction.apply(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1,
                                      b_x1, w_x2, b_x2, W, precision, chain_dtype)
    return egnn_band_reference(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1,
                               w_x2, b_x2, W, chain_dtype)
