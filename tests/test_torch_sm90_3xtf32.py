"""CPU tests of what surrounds the fp32 model's 3xTF32 mode of kernels 1-2
at the widths 32 to 256, which the shared-tile Hopper kernels serve
(``csrc/egnn_band_fwd_sm90_hd512.cu``, ``csrc/egnn_band_bwd_sm90_hd512.cu``,
``csrc/egnn_sm90.cuh``: ``Half``, ``product_split``): the routing of every
width, the launch plans and the shared-memory budget with three passes,
the two weight images (Wb, Ws) read back as ``wgmma`` reads them, the
order in which the producer streams the chunk pairs and the consumers read
them, and the work maps of the epilogues (the scratch copies of a step's
tile, the vector grads' column sums, the agg columns). The width-512 modes
and the numpy model of the split are in ``tests/test_torch_sm90_hd512.py``;
the kernels themselves are held against the plain versions on the card
(``tests/test_torch_gpu.py``, ``x3`` tests).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from protein_ensemble_vae_torch.ops.kernels import LAUNCHES  # noqa: E402
from protein_ensemble_vae_torch.ops.kernels.egnn_band import (  # noqa: E402
    HD512_FWD_STAGES, HD512_WGRAD_TILE, IMG_N, IMG_T, SM90_HIDDEN, SM90_KB, SMEM_LIMIT,
    X3_BWD_KERNEL, X3_KERNEL, band_kernel, band_work, egnn_band_bwd, egnn_band_bwd_reference,
    egnn_band_fwd, egnn_band_reference, hd512_fwd_plan_of, native_width, rna_tf32,
    shared_tile_nw, sm90_bwd_grid, sm90_smem_bytes, weight_image_hd512)

N_SM = 132        # SMs of an H100 SXM
W = 40            # the decoder's band half-width (ModelConfig.max_neighbors)
CT = 256          # consumer threads of a block (two warpgroups)
# the train step's B4/L256, generation's shapes, the padded tail of a batch
SHAPES = [(4, 256), (2, 640), (1, 256), (10, 256), (10, 640), (3, 77)]


@pytest.mark.parametrize("lo,hi", [(1, 32), (33, 64), (65, 128), (129, 256)])
def test_routing_of_highest_at_every_width_up_to_256(lo, hi):
    """Every width from 1 to 256 runs at its native width, and in 3xTF32
    (fp32 chain) on the shared-tile kernels under the ``_x3`` counters;
    the one-pass mode and the bf16 chain there run on the one-pass Hopper
    kernels."""
    for hd in range(lo, hi + 1):
        assert native_width(hd) == hi
        assert band_kernel("egnn_band_fwd", hd, "highest") == X3_KERNEL
        assert band_kernel("egnn_band_bwd", hd, "highest") == X3_BWD_KERNEL
        assert band_kernel("egnn_band_fwd", hd, "default") == "egnn_band_fwd_sm90"
        assert band_kernel("egnn_band_bwd", hd, "default") == "egnn_band_bwd_sm90"
        for precision in ("highest", "default"):
            assert band_kernel("egnn_band_fwd", hd, precision, torch.bfloat16) == "egnn_band_fwd_sm90"
            assert band_kernel("egnn_band_bwd", hd, precision, torch.bfloat16) == "egnn_band_bwd_sm90"


@pytest.mark.parametrize("kernel", [X3_KERNEL, X3_BWD_KERNEL, "wgrad_hd512"])
@pytest.mark.parametrize("Hd", SM90_HIDDEN)
def test_shared_memory_fits_a_block_in_3xtf32(kernel, Hd):
    """Each kernel's block asks for at most 232,448 bytes at every width
    with three passes (the split tile beside the activation tile; the
    weight-grad pass's two split stages and its step list at the largest
    path shape, two of its blocks per SM)."""
    steps = 0
    if kernel == "wgrad_hd512":
        _, _, items = band_work(10, 640, W)
        _, nsplit = sm90_bwd_grid(10, 640, W, Hd, N_SM, 1, shared=True)
        steps = -(-items // nsplit)
    nbytes = sm90_smem_bytes(kernel, Hd, 3, steps)
    assert nbytes <= SMEM_LIMIT
    if kernel == "wgrad_hd512":
        assert 2 * nbytes <= 228 * 1024
    else:   # the two tiles: 64 rows of Hd fp32 each
        assert nbytes >= 2 * 64 * Hd * 4


@pytest.mark.parametrize("Hd", SM90_HIDDEN)
@pytest.mark.parametrize("B,L", SHAPES)
def test_plans_cover_every_step_once_in_3xtf32(B, L, Hd):
    """Kernel 1's units (batch row, tile, slice), walked g, g + G, ... by
    its G blocks, cover each 64-row step exactly once; kernel 2's G blocks
    take every step (item) once, its weight-grad slices each own at least
    one, and its 2 x ceil(Hd / 64) x (Hd / TN) output tiles times the
    slices fit two blocks per SM."""
    S, per, G = hd512_fwd_plan_of(B, L, W, N_SM, 1)
    n_tiles, n_steps, items = band_work(B, L, W)
    seen = np.zeros(items, dtype=int)
    units = B * n_tiles * S
    assert (S - 1) * per < n_steps and 1 <= G <= min(units, N_SM)
    for g in range(G):
        for u in range(g, units, G):
            sl, tile, b = u % S, (u // S) % n_tiles, u // (S * n_tiles)
            for step in range(sl * per, min(n_steps, (sl + 1) * per)):
                seen[(b * n_tiles + tile) * n_steps + step] += 1
    assert np.all(seen == 1)
    G2, nsplit = sm90_bwd_grid(B, L, W, Hd, N_SM, 1, shared=True)
    assert 1 <= G2 <= min(items, N_SM) and 1 <= nsplit <= items
    tn = min(Hd, HD512_WGRAD_TILE)
    tiles = 2 * -(-Hd // 64) * (Hd // tn)
    assert tiles * nsplit <= 2 * N_SM or nsplit == 1


def _desc_read(img: np.ndarray, Hd: int, nw: int, hmajor: bool, n: np.ndarray,
               k: np.ndarray) -> np.ndarray:
    """Element (n, k) of the B operand as the consumer of column half
    n // (Hd / 2) reads it: its producer streams that half of the image,
    chunk (K block, column group) after chunk (``hmajor``: (column group, K
    block)), each landing 1024-byte aligned in its ring; the descriptor of a
    k8 step starts 32 bytes per step into the chunk, rows 128 bytes apart in
    8-row groups 1024 bytes (SBO) apart; then the 128-byte swizzle XORs
    address bits 4-6 with bits 7-9."""
    n_half = Hd // 2
    nh, nkc = n_half // nw, Hd // SM90_KB
    half, nn = n // n_half, n % n_half
    q = (nn // nw) * nkc + k // SM90_KB if hmajor else (k // SM90_KB) * nh + nn // nw
    chunk = (half * n_half * Hd + q * nw * SM90_KB) * 4     # bytes
    nl, kl = nn % nw, k % SM90_KB
    addr = (kl // 8) * 32 + (nl // 8) * 1024 + (nl % 8) * 128 + (kl % 8) * 4
    addr = addr ^ (((addr >> 7) & 7) << 4)
    return img[(chunk + addr) // 4]


@pytest.mark.parametrize("part", [0, 1])
@pytest.mark.parametrize("orient", [IMG_T, IMG_N])
@pytest.mark.parametrize("kernel,hmajor", [(X3_KERNEL, True), (X3_BWD_KERNEL, False)])
@pytest.mark.parametrize("Hd", SM90_HIDDEN)
def test_weight_images_read_back_through_the_descriptor(Hd, kernel, hmajor, orient, part):
    """Every element of the Wb (part 0) and Ws (part 1) images at each
    width, in kernel 1's h-major and kernel 2's K-block-major chunk order
    and their columns per product, read at the descriptor's address, is
    the TF32 big part of the weight entry the product needs (B[n][k] =
    W[k][n] for x @ W, W[n][k] for x @ W^T), or its small part; big +
    small holds W to 2^-22 of it."""
    nw = shared_tile_nw(kernel, Hd)
    w = (np.random.default_rng(Hd + 2 * orient + part).standard_normal((Hd, Hd))
         / 20).astype(np.float32)
    img = weight_image_hd512(w, orient, part, nw, hmajor)
    n, k = np.meshgrid(np.arange(Hd), np.arange(Hd), indexing="ij")
    want = w[k, n] if orient == IMG_T else w[n, k]
    big = rna_tf32(want)
    got = _desc_read(img, Hd, nw, hmajor, n, k)
    if part == 0:
        assert np.array_equal(got.view(np.uint32), big.view(np.uint32))
    else:
        assert np.array_equal(got.view(np.uint32), rna_tf32(want - big).view(np.uint32))
        err = np.abs(big.astype(np.float64) + got - want)
        assert np.all(err <= 2.0 ** -22 * np.abs(want) + 1e-30)


@pytest.mark.parametrize("kernel,hmajor", [(X3_KERNEL, True), (X3_BWD_KERNEL, False)])
@pytest.mark.parametrize("Hd", SM90_HIDDEN)
def test_chunk_pairs_reach_the_consumer_in_its_order(Hd, kernel, hmajor):
    """produce_split streams chunk q of the Ws image, then chunk q of the
    Wb image, for q in image order; product_split walks (column group h, K
    block kc) h-major for kernel 1, K-block-major for kernel 2, and reads
    two ring stages per (h, kc): the Ws and Wb chunks of exactly that
    (h, kc), each image chunk once; the ring holds at least one pair."""
    nw = shared_tile_nw(kernel, Hd)
    nh, nkc = Hd // 2 // nw, Hd // SM90_KB
    stream = [(part, q) for q in range(nh * nkc) for part in ("Ws", "Wb")]
    walk = ([(h, kc) for h in range(nh) for kc in range(nkc)] if hmajor
            else [(h, kc) for kc in range(nkc) for h in range(nh)])
    for i, (h, kc) in enumerate(walk):
        q = h * nkc + kc if hmajor else kc * nh + h
        assert stream[2 * i] == ("Ws", q) and stream[2 * i + 1] == ("Wb", q)
    assert len(stream) == 2 * len(set(walk)) == 2 * nh * nkc
    assert HD512_FWD_STAGES >= 2


@pytest.mark.parametrize("Hd", SM90_HIDDEN + (512,))
def test_tile_copies_cover_the_tile_once(Hd):
    """Kernel 2's tile_to_scratch, called with the parts q of one product's
    chunk pairs (q < Hd / 32 x NH), gives every 4 x 4 block of the [64][Hd]
    tile (16 row blocks x Hd / 4 feature chunks) to exactly one thread."""
    nw = shared_tile_nw(X3_BWD_KERNEL, Hd)
    nq = (Hd // SM90_KB) * (Hd // 2 // nw)
    seen = np.zeros((16, Hd // 4), dtype=int)
    for q in range(nq):
        for tid in range(CT):
            lane, wi = tid % 32, tid // 32 + 8 * q
            if wi >= Hd // 8:
                continue
            seen[4 * (wi % 4) + lane // 8, 8 * (wi // 4) + lane % 8] += 1
    assert np.all(seen == 1)


@pytest.mark.parametrize("Hd", SM90_HIDDEN + (512,))
def test_column_sums_take_each_column_once(Hd):
    """Kernel 2's vector-grad column sums: a consumer's lanes (tq) walk the
    column pairs jj of each column group h, and a flush after every PAIRS
    pairs (four, or a group's NW / 8) adds the pairs' two columns each, from
    the flush's first column; every one of the consumer's Hd / 2 columns is
    added exactly once per flush set, none outside them."""
    nw = shared_tile_nw(X3_BWD_KERNEL, Hd)
    pairs = min(nw // 8, 4)
    added = np.zeros(Hd // 2, dtype=int)
    for h in range(Hd // 2 // nw):
        for jj in range(nw // 8):
            if (jj & 3) != pairs - 1:
                continue
            for tq in range(4):
                base = h * nw + 8 * jj + 2 * tq - 8 * (pairs - 1)
                for p in range(pairs):
                    for c in range(2):
                        added[base + 8 * p + c] += 1
    assert np.all(added == 1)


@pytest.mark.parametrize("Hd", SM90_HIDDEN + (512,))
def test_agg_columns_cover_the_width_once(Hd):
    """Kernel 1's agg: consumer thread tid owns columns CPT tid .. (CPT = 2
    at 512, else 1, the first Hd threads), every column exactly once."""
    cpt = max(1, Hd // CT)
    seen = np.zeros(Hd, dtype=int)
    for tid in range(CT):
        if cpt * tid < Hd:
            seen[cpt * tid:cpt * tid + cpt] += 1
    assert np.all(seen == 1)


def test_cpu_tensors_keep_the_plain_version_in_3xtf32():
    """A CPU call at Hd 256 in 3xTF32, forward and backward, is the plain
    version: the reference's values, no kernel launches."""
    g = torch.Generator().manual_seed(7)
    B, L, Hd, Wb = 1, 10, 256, 3
    a, bs = (torch.randn(B, L, Hd, generator=g) * 0.3 for _ in range(2))
    x = torch.randn(B, L, 3, generator=g) * 5
    cmask = torch.ones(B, L)
    params = [torch.randn(*s, generator=g) / Hd ** 0.5
              for s in ((1, Hd), (Hd, Hd), (Hd,), (Hd, Hd), (Hd,), (Hd, 1), (1,))]
    g_agg, g_delta = torch.randn(B, L, Hd, generator=g), torch.randn(B, L, 3, generator=g)
    before = dict(LAUNCHES)
    got = egnn_band_fwd(a, bs, x, cmask, *params, Wb, "highest")
    want = egnn_band_reference(a, bs, x, cmask, *params, Wb)
    assert all(torch.equal(p, q) for p, q in zip(got, want))
    got = egnn_band_bwd(a, bs, x, cmask, *params, g_agg, g_delta, Wb, "highest")
    want = egnn_band_bwd_reference(a, bs, x, cmask, *params, g_agg, g_delta, Wb)
    assert all(torch.equal(p, q) for p, q in zip(got, want))
    assert dict(LAUNCHES) == before
