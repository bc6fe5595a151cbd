"""CPU tests of what surrounds the Hopper band kernels above decoder width
512 (``csrc/egnn_band_fwd_sm90_wide.cu``, ``csrc/egnn_band_bwd_sm90_wide.cu``,
``csrc/egnn_sm90_wide.cuh``): the routing of both fp32-chain modes above
512, kernel 1's launch plan and kernel 2's grid, the shared-memory budget
against the sources' constants and notes, the stream buffers' layout (an
activation's K blocks as the producer's bulk copies bring them, and the
copy into the weight-grad layout) and the weight images read back as
``wgmma`` reads them, the plain version on CPU tensors, and a numpy model
of the kernels' truncating 3xTF32 accumulation at Hd 1024 and 2048.
No GPU is needed; the kernels themselves are held against the plain
versions on the card (``tests/test_torch_gpu.py``, ``wide`` tests).
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from protein_ensemble_vae_torch.ops.kernels import LAUNCHES, SOURCES  # noqa: E402
from protein_ensemble_vae_torch.ops.kernels.egnn_band import (  # noqa: E402
    IMG_N, IMG_T, MAX_NATIVE, SM90_KB, SMEM_LIMIT, WIDE_BWD_KERNEL, WIDE_GROUP, WIDE_KERNEL,
    WIDE_NW, WIDE_STAGES, WIDE_WGRAD_TILE, band_kernel, band_work, egnn_band_bwd,
    egnn_band_bwd_reference, egnn_band_fwd, egnn_band_reference, mode_key, native_width,
    hd512_fwd_plan_of, rna_tf32, sm90_bwd_grid, sm90_smem_bytes, sw_off, weight_image_wide)

from test_torch_sm90_hd512 import _forward, _rz_add, _trunc  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "protein_ensemble_vae_torch", "csrc")
N_SM = 132        # SMs of an H100 SXM
W = 40            # the decoder's band half-width (ModelConfig.max_neighbors)
WIDE_HD = (768, 1024, 1280, 2048)
# the --decoder_hidden 1024 epoch's B4/L256, the reconstruction decode's
# B1/L256, and a long chain
SHAPES = [(4, 256), (1, 256), (2, 640)]


def _src(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def test_routing_names_the_hopper_kernels_above_512():
    """Every width from 513 to 2048 in both fp32-chain modes, with fp32 or
    bf16 a / bs, is served (and counted) by egnn_band_{fwd,bwd}_sm90_wide at
    the next multiple of WIDE_GROUP, and so is the bf16 chain there; 512
    keeps its own kernels."""
    for hd in range(MAX_NATIVE + 1, 2049, 37):
        assert native_width(hd) % WIDE_GROUP == 0 and native_width(hd) - hd < WIDE_GROUP
        for precision in ("highest", "default"):
            for kernel, want in (("egnn_band_fwd", WIDE_KERNEL), ("egnn_band_bwd", WIDE_BWD_KERNEL)):
                assert band_kernel(kernel, hd, precision) == want
                for dtype in (torch.float32, torch.bfloat16):
                    key = mode_key(band_kernel(kernel, hd, precision), dtype, precision)
                    assert key == f"{want}:{str(dtype)[6:]}/{precision}"
                assert band_kernel(kernel, hd, precision, torch.bfloat16) == want
    for precision in ("highest", "default"):
        assert band_kernel("egnn_band_fwd", MAX_NATIVE, precision) == "egnn_band_fwd_sm90_hd512"
    for name in (WIDE_KERNEL, WIDE_BWD_KERNEL):
        assert SOURCES[name] == name and LAUNCHES[name] == 0


@pytest.mark.parametrize("Hd", WIDE_HD)
@pytest.mark.parametrize("B,L", SHAPES)
def test_fwd_plan_covers_every_step_once_and_fills_the_card(B, L, Hd):
    """Kernel 1's units (batch row, tile, slice), walked g, g + G, ... by the
    G blocks, cover each (batch row, tile, step) exactly once, every slice
    owning at least one step; the grid holds a block on at least 95 % of
    the SMs, and the busiest block walks at most 1.35 x the mean steps
    (320 steps at B1/L256 cannot split evenly over 132 SMs). Kernel 2's
    edge pass holds one block per SM and its weight-grad pass fills two
    slots per SM with 64 x 64 tiles."""
    S, per, G = hd512_fwd_plan_of(B, L, W, N_SM, 1)
    n_tiles, n_steps, items = band_work(B, L, W)
    units = B * n_tiles * S
    assert (S - 1) * per < n_steps and 1 <= G <= min(units, N_SM)
    seen = np.zeros(items, dtype=int)
    for g in range(G):
        for u in range(g, units, G):
            sl, tile, b = u % S, (u // S) % n_tiles, u // (S * n_tiles)
            for step in range(sl * per, min(n_steps, (sl + 1) * per)):
                seen[(b * n_tiles + tile) * n_steps + step] += 1
    assert np.all(seen == 1)
    assert G >= 0.95 * N_SM
    assert -(-units // G) * per <= 1.35 * items / G
    G2, nsplit = sm90_bwd_grid(B, L, W, Hd, N_SM, 1, shared=True)
    tiles = 2 * (Hd // WIDE_WGRAD_TILE) ** 2
    assert G2 == N_SM and nsplit >= 1 and tiles * nsplit >= 2 * N_SM


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("kernel", [WIDE_KERNEL, WIDE_BWD_KERNEL, "wgrad_wide"])
def test_shared_memory_fits_a_block(kernel, passes):
    """Each kernel's block above 512 asks for at most 232,448 bytes in both
    modes at every width up to 2048 (the edge passes' do not grow with the
    width); the weight-grad pass, with its step list at B2/L640 and at
    B4/L256, fits two blocks per SM."""
    sizes = {sm90_smem_bytes(kernel, hd, passes) for hd in range(768, 2049, WIDE_GROUP)}
    assert len(sizes) == 1 and sizes.pop() <= SMEM_LIMIT
    if kernel == "wgrad_wide":
        for B, L in ((2, 640), (4, 256)):
            _, _, items = band_work(B, L, W)
            _, nsplit = sm90_bwd_grid(B, L, W, 2048, N_SM, 1, shared=True)
            steps = -(-items // nsplit)
            assert 2 * sm90_smem_bytes(kernel, 2048, passes, steps) <= 228 * 1024


def test_wrapper_constants_match_the_sources():
    """The wrapper's mirror of the layouts reads the same constants as the
    sources (columns per consumer and pass, ring stages, the weight-grad
    tile), and the sources' budget tables give its totals in both modes."""
    hdr = _src("egnn_sm90_wide.cuh")
    assert (f"static constexpr int NW = PASSES == 1 ? {WIDE_NW[1]} : {WIDE_NW[3]};" in hdr)
    assert (f"static constexpr int STAGES = PASSES == 1 ? {WIDE_STAGES[1]} : {WIDE_STAGES[3]};"
            in hdr)
    bwd = _src("egnn_band_bwd_sm90_wide.cu")
    assert f"constexpr int WGRAD_TN = {WIDE_WGRAD_TILE};" in bwd
    for name, kernel in (("egnn_band_fwd_sm90_wide.cu", WIDE_KERNEL),
                         ("egnn_band_bwd_sm90_wide.cu", WIDE_BWD_KERNEL)):
        src = _src(name)
        for passes in (1, 3):
            row = re.search(rf"^//\s+{passes}\s+\|.*\|\s+([\d,]+)\s+\(of 232,448\)\s*$", src, re.M)
            assert int(row.group(1).replace(",", "")) == sm90_smem_bytes(kernel, 1024, passes)
    wg = re.search(r"step list: ([\d,]+) / ([\d,]+) \+ 4 x steps", bwd)
    for passes, got in zip((1, 3), wg.groups()):
        assert int(got.replace(",", "")) == sm90_smem_bytes("wgrad_wide", 1024, passes)


def _desc_read(img: np.ndarray, nc: int, hd: int, n: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Element (n, k) of the B operand as consumer c = (n % nc) // (nc / 2)
    reads it in column pass n // nc: the producer's bulk copy lands chunk
    (pass, K block) 1024-byte aligned in a ring stage; the consumer's
    descriptor starts nc / 2 rows (nc / 2 x 128 bytes) in for c = 1 and 32
    bytes per k8 step, rows 128 bytes apart in 8-row groups 1024 bytes (SBO)
    apart; then the 128-byte swizzle XORs address bits 4-6 with 7-9."""
    nw = nc // 2
    nkc = hd // SM90_KB
    q = (n // nc) * nkc + k // SM90_KB
    chunk = q * nc * SM90_KB * 4                               # bytes
    c, nl, kl = (n % nc) // nw, n % nw, k % SM90_KB
    addr = c * nw * 128 + (kl // 8) * 32 + (nl // 8) * 1024 + (nl % 8) * 128 + (kl % 8) * 4
    addr = addr ^ (((addr >> 7) & 7) << 4)
    return img[(chunk + addr) // 4]


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("part", [0, 1])
@pytest.mark.parametrize("orient", [IMG_T, IMG_N])
def test_weight_image_reads_back_through_the_descriptor(passes, orient, part):
    """Every element of the wide images (chunks of 2 x WIDE_NW rows in the
    order (column pass, K block)), read at the descriptor's address of the
    consumer that owns its column, is the TF32 big part of the weight entry
    the product needs (B[n][k] = W[k][n] for x @ W, W[n][k] for x @ W^T),
    or its small part, and big + small holds W to 2^-22 of it."""
    hd, nc = 768, 2 * WIDE_NW[passes]
    w = (np.random.default_rng(passes + 2 * orient + 4 * part).standard_normal((hd, hd))
         / 20).astype(np.float32)
    img = weight_image_wide(w, orient, part, nc)
    n, k = np.meshgrid(np.arange(hd), np.arange(hd), indexing="ij")
    want = w[k, n] if orient == IMG_T else w[n, k]
    big = rna_tf32(want)
    got = _desc_read(img, nc, hd, n, k)
    if part == 0:
        assert np.array_equal(got.view(np.uint32), big.view(np.uint32))
    else:
        assert np.array_equal(got.view(np.uint32), rna_tf32(want - big).view(np.uint32))
        err = np.abs(big.astype(np.float64) + got - want)
        assert np.all(err <= 2.0 ** -22 * np.abs(want) + 1e-30)


@pytest.mark.parametrize("hd", [768, 2048])
def test_stream_rows_and_the_weight_grad_copy(hd):
    """The stream buffers' layout: element (row r, column k) of an activation
    at sw_off(r, k, 64), so K block kc is the 8 KiB run [kc 2048, (kc + 1)
    2048) that one bulk copy brings, in the swizzled order the A descriptor
    reads (row r at 128 r bytes, chunk (k / 4) ^ (r % 8)); and the copy of a
    K block from its ring stage into the weight-grad layout
    (egnn_band_bwd_sm90_wide.cu: chunk_to_scratch, 4 x 4 blocks, 128
    threads a K block) writes every element of the step once, at (r / 32)
    hd 32 + sw_off(k, r % 32, hd), where the weight-grad pass's bulk copies
    read a feature's 32 edge rows."""
    r, k = np.meshgrid(np.arange(64), np.arange(hd), indexing="ij")
    off = sw_off(r, k, 64)
    assert np.array_equal(np.sort(off.ravel()), np.arange(64 * hd))
    assert np.array_equal(off // (64 * SM90_KB), k // SM90_KB)
    inner = off % (64 * SM90_KB)
    assert np.array_equal(inner // SM90_KB, r)
    assert np.array_equal((inner % SM90_KB) // 4, ((k % SM90_KB) // 4) ^ (r % 8))
    act = np.random.default_rng(hd).standard_normal((64, hd)).astype(np.float32)
    stream = np.empty(64 * hd, np.float32)
    stream[off] = act
    dst = np.full(64 * hd, np.nan, np.float32)
    writes = np.zeros(64 * hd, int)
    for kc in range(hd // SM90_KB):
        st = stream[kc * 64 * SM90_KB:(kc + 1) * 64 * SM90_KB]
        for t in range(128):
            m, cf = t // 8, t % 8
            v = np.stack([st[(4 * m + j) * SM90_KB + ((cf ^ ((4 * m + j) & 7)) << 2)
                             + np.arange(4)] for j in range(4)])      # [row j][feature i]
            h, mr = m // 8, m % 8
            for i in range(4):
                kk = kc * SM90_KB + 4 * cf + i
                at = h * hd * SM90_KB + kk * SM90_KB + ((mr ^ (kk & 7)) << 2) + np.arange(4)
                dst[at] = v[:, i]
                writes[at] += 1
    assert np.all(writes == 1)
    want_at = (r // 32) * hd * SM90_KB + sw_off(k, r % 32, hd)
    assert np.array_equal(dst[want_at], act)


def test_cpu_tensors_keep_the_plain_version():
    """A CPU call above 512 (768, and 700 that the card would pad) in either
    mode, forward and backward, is the plain version: no kernel launches,
    the reference's values (the backward's up to the order of autograd's
    threaded CPU sums)."""
    g = torch.Generator().manual_seed(5)
    before = dict(LAUNCHES)
    for Hd in (768, 700):
        B, L, Wb = 1, 10, 3
        a, bs = (torch.randn(B, L, Hd, generator=g) * 0.3 for _ in range(2))
        x = torch.randn(B, L, 3, generator=g) * 5
        cmask = torch.ones(B, L)
        params = [torch.randn(*s, generator=g) / Hd ** 0.5
                  for s in ((1, Hd), (Hd, Hd), (Hd,), (Hd, Hd), (Hd,), (Hd, 1), (1,))]
        g_agg, g_delta = torch.randn(B, L, Hd, generator=g), torch.randn(B, L, 3, generator=g)
        want = egnn_band_reference(a, bs, x, cmask, *params, Wb)
        want_g = egnn_band_bwd_reference(a, bs, x, cmask, *params, g_agg, g_delta, Wb)
        for precision in ("highest", "default"):
            got = egnn_band_fwd(a, bs, x, cmask, *params, Wb, precision)
            assert all(torch.equal(p, q) for p, q in zip(got, want))
            got = egnn_band_bwd(a, bs, x, cmask, *params, g_agg, g_delta, Wb, precision)
            for p, q in zip(got, want_g):   # autograd's CPU sums: threads, not a kernel
                torch.testing.assert_close(p, q)
    assert dict(LAUNCHES) == before


# ---- numpy model of the truncating 3xTF32 accumulation ------------------------

def _mm3_wide(x, w, group=SM90_KB):
    """x @ w as the kernels above 512 compute it in 3xTF32
    (egnn_sm90_wide.cuh: consume): the A chunk read truncated, Xs =
    rna(X - trunc(X)), Wb = rna(W), Ws = rna(W - Wb); per K block Xt.Ws,
    then Xt.Wb into a step sum and Xs.Wb, each k8 step added rounding
    toward zero as the tensor cores accumulate; each ``group`` K values'
    step sum added to the result in round-to-nearest fp32 (32: one K
    block), the small terms' accumulator at the end."""
    shape = x.shape[:-1] + (w.shape[1],)
    x = x.reshape(-1, x.shape[-1])
    xt = _trunc(x)
    xs = rna_tf32(x - xt)
    wb = rna_tf32(w)
    ws = rna_tf32(w - wb)
    f64 = lambda a, k: a[:, k:k + 8].astype(np.float64)  # noqa: E731
    out = np.zeros((x.shape[0], w.shape[1]), np.float32)
    sml = np.zeros_like(out)
    for g in range(0, x.shape[1], group):
        step = np.zeros_like(out)
        for kb in range(g, g + group, SM90_KB):
            for k in range(kb, kb + SM90_KB, 8):
                sml = _rz_add(sml, f64(xt, k) @ ws[k:k + 8].astype(np.float64))
            for k in range(kb, kb + SM90_KB, 8):
                step = _rz_add(step, f64(xt, k) @ wb[k:k + 8].astype(np.float64))
                sml = _rz_add(sml, f64(xs, k) @ wb[k:k + 8].astype(np.float64))
        out = (out + step).astype(np.float32)
    return (out + sml).astype(np.float32).reshape(shape)


@pytest.mark.parametrize("Hd", [1024, 2048])
def test_three_pass_accumulation_holds_the_plain_version(Hd):
    """Kernel 1's 3xTF32 above 512, modelled with its 32-K step sums
    (_mm3_wide), holds the GPU tests' forward tolerance (rtol 1e-4 / atol
    1e-4 max|plain| of the fp32 plain version) with room to spare: its worst
    element stays under a tenth of it at Hd 1024 and 2048 (the shared-tile
    kernels' 32-K sums read 0.53 of it on the card at Hd 256, where this
    model read less than the card); one TF32 pass does not hold it."""
    rng = np.random.default_rng(11)
    B, L, Wb = 1, 16, 4
    sd = np.float32((Hd / (3 * (2 * Hd + 1))) ** 0.5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    a, bs, x = f(B, L, Hd) * sd, f(B, L, Hd) * sd, f(B, L, 3) * np.float32(10)
    cmask = np.ones((B, L), np.float32)
    cmask[0, L - 3:] = 0
    u = lambda s, fan: ((rng.random(s) * 2 - 1) / np.sqrt(fan)).astype(np.float32)  # noqa: E731
    params = (u((1, Hd), 2 * Hd + 1), u((Hd, Hd), Hd), u((Hd,), Hd), u((Hd, Hd), Hd),
              u((Hd,), Hd), u((Hd, 1), Hd), u((1,), Hd))
    t = [torch.from_numpy(v) for v in (a, bs, x, cmask) + params]
    want = [r.numpy() for r in egnn_band_reference(*t, Wb)]

    def worst(got):
        return max(float(np.max(np.abs(g - r) / (1e-4 * np.abs(r) + 1e-4 * np.abs(r).max())))
                   for g, r in zip(got, want))

    assert worst(_forward(a, bs, x, cmask, params, Wb, _mm3_wide)) < 0.1
    one_pass = lambda v, m: (rna_tf32(v) @ rna_tf32(m)).astype(np.float32)  # noqa: E731
    assert worst(_forward(a, bs, x, cmask, params, Wb, one_pass)) > 1
