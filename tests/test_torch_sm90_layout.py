"""CPU tests of what surrounds the Hopper band kernels
(``csrc/egnn_band_fwd_sm90.cu``, ``csrc/egnn_band_bwd_sm90.cu``,
``csrc/egnn_sm90.cuh``): the weight images read back as ``wgmma`` reads
them, the accumulator map, the launch plans, the shared-memory budget
against the sources' own constants, and a numpy emulation of the one-pass
products (TF32 operands rounded as the kernels round them, fp32 sums in
the kernels' k order) held against the fp32 plain versions at the
bf16-model tolerances. No GPU is needed; the kernels themselves are held
against the plain versions on the card (``tests/test_torch_gpu.py``).
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from protein_ensemble_vae_torch.ops.kernels.egnn_band import (  # noqa: E402
    IMG_N, IMG_T, OPS, SM90_BWD_STAGES, SM90_FWD_STAGES, SM90_HIDDEN, SM90_KB,
    SM90_NW_MAX, SM90_THREADS, SM90_WGRAD_STAGES, SMEM_LIMIT, TILE, band_kernel, band_work,
    egnn_band_bwd_reference, egnn_band_reference, rna_tf32, sm90_bwd_grid, sm90_cols,
    sm90_fwd_plan_of, sm90_smem_bytes, sw_off, weight_image)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "protein_ensemble_vae_torch", "csrc")
# chip_smoke.py's bf16-model tolerances (fractions of max |plain|)
BF16_VALUE_FRAC, BF16_GRAD_FRAC = 0.03, 0.05
N_SM = 132        # SMs of an H100 SXM
# the flagship's training shapes, then the training and generation shapes
SHAPES = [(8, 128), (8, 192), (4, 256), (2, 640), (10, 640)]


def _src(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constexpr(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _desc_read(img: np.ndarray, Hd: int, n: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Element (n, k) of the B operand as wgmma reads it from the ring: the
    chunk that holds it lands 1024-byte aligned; the descriptor of its k8
    step starts 32 bytes per step into the chunk, rows 128 bytes apart in
    8-row groups 1024 bytes (SBO) apart; then the 128-byte swizzle XORs
    address bits 4-6 with bits 7-9."""
    nw, nh = sm90_cols(Hd)
    chunk = ((k // SM90_KB) * nh + n // nw) * nw * SM90_KB * 4     # bytes
    nl, kl = n % nw, k % SM90_KB
    start = (kl // 8) * 32
    addr = start + (nl // 8) * 1024 + (nl % 8) * 128 + (kl % 8) * 4
    addr = addr ^ (((addr >> 7) & 7) << 4)
    return img[(chunk + addr) // 4]


@pytest.mark.parametrize("orient", [IMG_T, IMG_N])
@pytest.mark.parametrize("Hd", SM90_HIDDEN)
def test_weight_image_reads_back_through_the_descriptor(Hd, orient):
    """The image of W, read back through the descriptor's address and the
    swizzle, returns W^T (IMG_T: B[n][k] = W[k][n]) or W (IMG_N) bit for
    bit (W made of TF32 values, which the image's rounding keeps)."""
    w = rna_tf32(np.random.default_rng(Hd).standard_normal((Hd, Hd)).astype(np.float32))
    img = weight_image(w, orient)
    n, k = np.meshgrid(np.arange(Hd), np.arange(Hd), indexing="ij")
    got = _desc_read(img, Hd, n, k)
    want = w.T if orient == IMG_T else w
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # and sw_off is the same map for an A tile (64 rows x Hd)
    r, kk = np.meshgrid(np.arange(64), np.arange(Hd), indexing="ij")
    offs = sw_off(r, kk, 64)
    assert np.array_equal(np.sort(offs.ravel()), np.arange(64 * Hd))


def test_weight_image_rounds_to_nearest_tf32():
    """Values are rounded as cvt.rna.tf32.f32 rounds: to nearest, ties
    away from zero, 13 low bits cleared."""
    v = np.array([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 3 * 2.0 ** -11), 1.0 + 2.0 ** -13],
                 dtype=np.float32)
    got = rna_tf32(v)
    assert list(got) == [1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -9), 1.0]
    assert np.all(got.view(np.uint32) & 0x1FFF == 0)


def _acc_coords(N: int) -> tuple[np.ndarray, np.ndarray]:
    """(row, col) of accumulator register i of thread t of an m64nN fp32
    wgmma (PTX ISA's fragment layout): warp w = t / 32, g = lane / 4,
    t' = lane % 4; register 4 j + e is row 16 w + g + 8 (e / 2), column
    8 j + 2 t' + e % 2. The kernels' epilogues index it so."""
    t, i = np.meshgrid(np.arange(128), np.arange(N // 2), indexing="ij")
    w, lane = t // 32, t % 32
    g, tq, j, e = lane // 4, lane % 4, i // 4, i % 4
    return 16 * w + g + 8 * (e // 2), 8 * j + 2 * tq + e % 2


@pytest.mark.parametrize("N", [32, 64, 128])
def test_accumulator_rows_of_a_lane_share_a_receiver(N):
    """Every (row, column) of the m64nN tile is held once, and with edge
    row r = (offset slot r / 8, receiver r % 8) all rows a lane holds
    belong to one receiver, g: agg sums in registers."""
    row, col = _acc_coords(N)
    flat = row * N + col
    assert np.array_equal(np.sort(flat.ravel()), np.arange(64 * N))
    receiver = row % TILE
    assert np.all(receiver == receiver[:, :1])
    assert np.array_equal(receiver[:, 0], (np.arange(128) % 32) // 4)


@pytest.mark.parametrize("B,L", SHAPES + [(1, 37), (3, 70)])
@pytest.mark.parametrize("W", [4, 40])
def test_fwd_plan_covers_every_step_once(B, L, W):
    """Kernel 1's units (batch row, tile, slice of step pairs) cover every
    (batch row, tile, step) once, every slice owns a pair, and the
    persistent grid is no larger than the units."""
    S, per, G = sm90_fwd_plan_of(B, L, W, N_SM, 1)
    n_tiles, n_steps, items = band_work(B, L, W)
    n_pairs = -(-n_steps // 2)
    seen = np.zeros(items, dtype=int)
    units = B * n_tiles * S
    for u in range(units):
        sl, tile, b = u % S, (u // S) % n_tiles, u // (S * n_tiles)
        pairs = range(sl * per, min(n_pairs, (sl + 1) * per))
        assert len(pairs) >= 1
        for p in pairs:
            for s in (2 * p, 2 * p + 1):
                if s < n_steps:
                    seen[(b * n_tiles + tile) * n_steps + s] += 1
    assert np.all(seen == 1)
    assert 1 <= G <= min(units, N_SM)


@pytest.mark.parametrize("B,L", SHAPES)
def test_plans_fill_the_card_at_the_path_shapes(B, L):
    """At the flagship's and the training / generation shapes both
    persistent grids hold a block on every SM, kernel 1's units span
    several waves of them, and the weight-grad pass's tiles x slices fill
    two blocks per SM."""
    W = 40
    S, _, G = sm90_fwd_plan_of(B, L, W, N_SM, 1)
    assert G == N_SM and B * band_work(B, L, W)[0] * S >= 2 * N_SM
    G2, nsplit = sm90_bwd_grid(B, L, W, 256, N_SM, 1)
    assert G2 == N_SM
    out_tiles = 2 * (256 // 64) * (256 // SM90_NW_MAX)
    assert out_tiles * nsplit >= 2 * N_SM


@pytest.mark.parametrize("B,L,W", [(8, 128, 40), (1, 37, 4), (2, 19, 12)])
def test_bwd_pairs_cover_every_item_once(B, L, W):
    """Kernel 2's edge pass takes pairs pi = (batch row, tile, pair); the
    items it writes, ((b, tile), 2p + wg) below n_steps, are every work
    item once (the node and weight-grad passes read them by that index)."""
    n_tiles, n_steps, items = band_work(B, L, W)
    n_pairs = -(-n_steps // 2)
    seen = np.zeros(items, dtype=int)
    for pi in range(B * n_tiles * n_pairs):
        for wg in (0, 1):
            step = 2 * (pi % n_pairs) + wg
            if step < n_steps:
                seen[(pi // n_pairs) * n_steps + step] += 1
    assert np.all(seen == 1)


@pytest.mark.parametrize("kernel", ["egnn_band_fwd_sm90", "egnn_band_bwd_sm90", "wgrad"])
@pytest.mark.parametrize("Hd", SM90_HIDDEN)
def test_shared_memory_fits_a_block(kernel, Hd):
    """Each Hopper kernel's block asks for at most 232,448 bytes at every
    width it takes (the weight-grad pass with its step list at the largest
    path shape, and two of its blocks per SM)."""
    nbytes = sm90_smem_bytes(kernel, Hd)
    if kernel == "wgrad":
        _, _, items = band_work(10, 640, 40)
        _, nsplit = sm90_bwd_grid(10, 640, 40, Hd, N_SM, 1)
        nbytes += 4 * -(-items // nsplit)
        assert 2 * nbytes <= 228 * 1024
    assert nbytes <= SMEM_LIMIT


def test_wrapper_constants_match_the_sources():
    """The wrapper's mirror of the layouts reads the same constants as the
    .cu files, and the source notes' budget tables give its totals."""
    hdr, fwd, bwd = (_src(f) for f in ("egnn_sm90.cuh", "egnn_band_fwd_sm90.cu",
                                       "egnn_band_bwd_sm90.cu"))
    assert _constexpr(fwd, "STAGES") == SM90_FWD_STAGES
    assert _constexpr(bwd, "STAGES") == SM90_BWD_STAGES
    assert _constexpr(bwd, "WSTAGES") == SM90_WGRAD_STAGES
    assert _constexpr(hdr, "KB") == SM90_KB
    assert "constexpr int THREADS = (CONSUMERS + 1) * WG;" in hdr
    assert (_constexpr(hdr, "CONSUMERS") + 1) * _constexpr(hdr, "WG") == SM90_THREADS
    assert f"HD < {SM90_NW_MAX} ? HD : {SM90_NW_MAX}" in hdr
    for src, kernel in ((fwd, "egnn_band_fwd_sm90"), (bwd, "egnn_band_bwd_sm90")):
        for Hd in SM90_HIDDEN:
            row = re.search(rf"^//\s+{Hd} \|.*\|\s+([\d,]+)(?:\s+\(.*\))?\s*$", src, re.M)
            assert int(row.group(1).replace(",", "")) == sm90_smem_bytes(kernel, Hd), (kernel, Hd)


def test_routing_names_the_kernel_of_each_mode():
    """The one-pass fp32 chain and the bf16 chain at widths up to 256
    (padded ones included) go to the one-pass Hopper kernels; 3xTF32 there
    to the shared-tile kernels under their own counters; at Hd 512 (and
    384, padded to it) the one-pass mode goes to the width-512 Hopper
    kernels (tests/test_torch_sm90_hd512.py and
    tests/test_torch_sm90_3xtf32.py route every mode and width)."""
    assert band_kernel("egnn_band_fwd", 256, "default") == "egnn_band_fwd_sm90"
    assert band_kernel("egnn_band_bwd", 48, "default") == "egnn_band_bwd_sm90"
    assert band_kernel("egnn_band_fwd", 256, "highest") == "egnn_band_fwd_sm90_x3"
    assert band_kernel("egnn_band_fwd", 256, "default", torch.bfloat16) == "egnn_band_fwd_sm90"
    assert band_kernel("egnn_band_bwd", 512, "default") == "egnn_band_bwd_sm90_hd512"
    assert band_kernel("egnn_band_bwd", 384, "default") == "egnn_band_bwd_sm90_hd512"


# ---- numpy emulation of the one-pass products ------------------------------

def _silu(v):
    with np.errstate(over="ignore"):   # exp(-v) -> inf: silu -> 0, as in fp32 on the card
        return v / (np.float32(1) + np.exp(-v))


def _dsilu(v):
    with np.errstate(over="ignore"):
        s = np.float32(1) / (np.float32(1) + np.exp(-v))
    return s * (np.float32(1) + v * (np.float32(1) - s))


def _mm(a, b):
    """a @ b as wgmma computes it here: both operands rounded to TF32 as the
    kernels write them, fp32 sums over k8 steps in k order."""
    a, b = rna_tf32(a), rna_tf32(b)
    acc = np.zeros(a.shape[:-1] + (b.shape[1],), dtype=np.float32)
    for k in range(0, a.shape[-1], 8):
        acc += a[..., k:k + 8] @ b[k:k + 8]
    return acc


def _inputs(B, L, Hd, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sd = np.float32((Hd / (3 * (2 * Hd + 1))) ** 0.5)
    a, bs = f(B, L, Hd) * sd, f(B, L, Hd) * sd
    x = f(B, L, 3) * np.float32(10)
    cmask = np.ones((B, L), np.float32)
    cmask[0, L - L // 5:] = 0
    u = lambda shape, fan: ((rng.random(shape) * 2 - 1) / np.sqrt(fan)).astype(np.float32)  # noqa: E731
    params = (u((1, Hd), 2 * Hd + 1), u((Hd, Hd), Hd), u((Hd,), Hd), u((Hd, Hd), Hd),
              u((Hd,), Hd), u((Hd, 1), Hd), u((1,), Hd))
    # a bf16 model's projections: a / bs rounded to bf16
    a, bs = (torch.from_numpy(t).bfloat16().float().numpy() for t in (a, bs))
    return a, bs, x, cmask, params


def _edges(x, cmask, W):
    B, L, _ = x.shape
    offs = np.array([o for o in range(-W, W + 1) if o], dtype=int)
    j = np.arange(L)[:, None] + offs[None, :]
    inr = (j >= 0) & (j < L)
    jc = np.clip(j, 0, L - 1)
    valid = (inr[None] & (cmask[:, :, None] > 0.5) & (cmask[:, jc] > 0.5)).astype(np.float32)
    rel = (x[:, :, None, :] - x[:, jc, :]) * valid[..., None]
    return jc, valid, rel


def _emulate(a, bs, x, cmask, params, W, g_agg, g_delta):
    """The kernels' one-pass chain over every band edge [B, L, 2W]: forward
    (agg, raw_delta) and the ten gradients."""
    w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2 = params
    jc, valid, rel = _edges(x, cmask, W)
    v4 = valid[..., None]
    d2 = np.sum(rel * rel, axis=-1, keepdims=True)
    pre = a[:, :, None, :] + bs[:, jc, :] + d2 * w_d.reshape(-1)
    m1 = _silu(pre) * v4
    u = _mm(m1, w_e2) + b_e2
    m = _silu(u)
    v = _mm(m, w_x1) + b_x1
    w1 = _silu(v)
    wsc = w1 @ w_x2.reshape(-1, 1) + b_x2
    agg = np.sum(m * v4, axis=2)
    raw_delta = np.sum(wsc * v4 * rel, axis=2)
    gd = g_delta[:, :, None, :]
    cw = np.sum(gd * rel, axis=-1, keepdims=True) * v4
    cot_v = cw * w_x2.reshape(-1) * _dsilu(v)
    cot_u = (v4 * g_agg[:, :, None, :] + _mm(cot_v, w_x1.T)) * _dsilu(u)
    cot_pre = _mm(cot_u, w_e2.T) * _dsilu(pre) * v4
    cot_d2 = np.sum(cot_pre * w_d.reshape(-1), axis=-1, keepdims=True)
    d_rel = v4 * wsc * gd + 2 * rel * cot_d2
    B, L, K, Hd = cot_pre.shape

    def senders(t):
        out = np.zeros((B, L, t.shape[-1]), np.float32)
        for b in range(B):
            np.add.at(out[b], jc.reshape(-1), t[b].reshape(L * K, -1))
        return out

    def outer(p, q):
        p, q = rna_tf32(p.reshape(-1, Hd)), rna_tf32(q.reshape(-1, Hd))
        return p.T @ q

    vsum = lambda t: t.reshape(-1, t.shape[-1]).sum(axis=0)  # noqa: E731
    grads = (cot_pre.sum(axis=2), senders(cot_pre), d_rel.sum(axis=2) - senders(d_rel),
             vsum(cot_pre * d2).reshape(w_d.shape), outer(m1, cot_u), vsum(cot_u),
             outer(m, cot_v), vsum(cot_v), vsum(w1 * cw).reshape(w_x2.shape),
             cw.sum().reshape(b_x2.shape))
    return (agg, raw_delta), grads


@pytest.mark.parametrize("Hd,L,W", [(32, 37, 4), (64, 37, 12), (32, 64, 40)])
def test_one_pass_emulation_holds_the_plain_version(Hd, L, W):
    """TF32-rounded operands in the kernels' k order stay within the
    bf16-model tolerances of the fp32 plain versions: 3 % of max |value|
    forward, 5 % of max |grad| backward."""
    B = 2
    a, bs, x, cmask, params = _inputs(B, L, Hd, seed=Hd + L + W)
    rng = np.random.default_rng(7)
    g_agg = rng.standard_normal((B, L, Hd)).astype(np.float32)
    g_delta = rng.standard_normal((B, L, 3)).astype(np.float32)
    outs, grads = _emulate(a, bs, x, cmask, params, W, g_agg, g_delta)
    t = [torch.from_numpy(v) for v in (a, bs, x, cmask) + params]
    want = egnn_band_reference(*t, W)
    for name, got, ref in zip(("agg", "raw_delta"), outs, want):
        ref = ref.numpy()
        assert np.abs(got - ref).max() <= BF16_VALUE_FRAC * np.abs(ref).max(), name
    wgrads = egnn_band_bwd_reference(*t, torch.from_numpy(g_agg), torch.from_numpy(g_delta), W)
    for k, (got, ref) in enumerate(zip(grads, wgrads)):
        ref = ref.float().numpy()
        assert got.shape == ref.shape, k
        assert np.abs(got - ref).max() <= BF16_GRAD_FRAC * np.abs(ref).max(), k


def test_step_is_eight_offsets_of_eight_receivers():
    """The 64 edge rows of a step: OPS offsets x TILE receivers, the rows a
    consumer warpgroup's m64 product covers."""
    assert OPS * TILE == 64
