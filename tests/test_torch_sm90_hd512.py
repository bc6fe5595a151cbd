"""CPU tests of what surrounds the width-512 Hopper band kernels
(``csrc/egnn_band_fwd_sm90_hd512.cu``, ``csrc/egnn_band_bwd_sm90_hd512.cu``,
``csrc/egnn_sm90.cuh``: ``Half``): the launch plans, the shared-memory
budget against the sources' own constants and notes (at 512, and at the
widths up to 256 those kernels serve in 3xTF32), the weight images
(the N-half chunk order, big and small parts) read back as ``wgmma`` reads
them, the routing of every mode and width, and a numpy emulation of the
3xTF32 split the kernels use (the tile read truncated, its remainder
rounded; at Hd 256 the remainder in its own tile) held against the fp32
plain version, where one TF32 pass fails. The widths up to 256 in 3xTF32
have their own tests (``tests/test_torch_sm90_3xtf32.py``).
No GPU is needed; the kernels themselves are held against the plain
versions on the card (``tests/test_torch_gpu.py``, ``hd512`` tests).
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from protein_ensemble_vae_torch.ops.kernels import LAUNCHES, SOURCES  # noqa: E402
from protein_ensemble_vae_torch.ops.kernels.egnn_band import (  # noqa: E402
    HD512, HD512_BWD_KERNEL, HD512_BWD_NW, HD512_BWD_STAGES, HD512_FWD_NW, HD512_FWD_STAGES,
    HD512_HALF, HD512_KERNEL, HD512_WGRAD_STAGES, HD512_WGRAD_TILE, IMG_N, IMG_T, SM90_HIDDEN,
    SM90_KB, SMEM_LIMIT, X3_BWD_KERNEL, X3_FWD_STAGES, X3_KERNEL, band_kernel, band_work, egnn_band_reference,
    hd512_fwd_plan_of, rna_tf32, sm90_bwd_grid, sm90_smem_bytes, weight_image_hd512)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "protein_ensemble_vae_torch", "csrc")
N_SM = 132        # SMs of an H100 SXM
W = 40            # the decoder's band half-width (ModelConfig.max_neighbors)
# the train step's shapes and generation's B10/L640
SHAPES = [(4, 256), (2, 640), (10, 640)]


def _src(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constexpr(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("B,L", SHAPES + [(1, 256), (8, 128), (3, 77)])
def test_fwd_plan_covers_every_step_once(B, L):
    """Kernel 1's units (batch row, tile, slice), walked g, g + G, ... by the
    G blocks, cover each (batch row, tile, step) exactly once, every slice
    owning at least one step."""
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


@pytest.mark.parametrize("B,L", SHAPES)
def test_plans_fill_the_card(B, L):
    """At the path's shapes both kernels' persistent grids hold a block on
    at least 95 % of the SMs, and kernel 1's busiest block walks at most
    15 % more steps than the mean."""
    S, per, G = hd512_fwd_plan_of(B, L, W, N_SM, 1)
    n_tiles, n_steps, items = band_work(B, L, W)
    assert G >= 0.95 * N_SM
    busiest = -(-B * n_tiles * S // G) * per
    assert busiest <= 1.15 * items / G
    G2, nsplit = sm90_bwd_grid(B, L, W, HD512, N_SM, 1)
    assert G2 == N_SM and -(-items // G2) <= 1.15 * items / G2
    tiles = 2 * (HD512 // HD512_WGRAD_TILE) ** 2
    assert tiles * nsplit <= 2 * N_SM and tiles * (nsplit + 1) > 2 * N_SM


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("kernel", [HD512_KERNEL, HD512_BWD_KERNEL, "wgrad_hd512"])
def test_shared_memory_fits_a_block(kernel, passes):
    """Each width-512 kernel's block asks for at most 232,448 bytes in both
    modes; the weight-grad pass, with its step list at the largest path
    shape, fits two blocks per SM."""
    steps = 0
    if kernel == "wgrad_hd512":
        _, _, items = band_work(10, 640, W)
        _, nsplit = sm90_bwd_grid(10, 640, W, HD512, N_SM, 1)
        steps = -(-items // nsplit)
    nbytes = sm90_smem_bytes(kernel, HD512, passes, steps)
    assert nbytes <= SMEM_LIMIT
    if kernel == "wgrad_hd512":
        assert 2 * nbytes <= 228 * 1024


def test_wrapper_constants_match_the_sources():
    """The wrapper's mirror of the layouts reads the same constants as the
    .cu files (the columns per product at 512, NW_OF's cap), and the source
    notes' budget tables give its totals at 512 and, in 3xTF32, at every
    width up to 256; the 3xTF32 counters name the shared-tile sources."""
    hdr, fwd, bwd = (_src(f) for f in ("egnn_sm90.cuh", "egnn_band_fwd_sm90_hd512.cu",
                                       "egnn_band_bwd_sm90_hd512.cu"))
    assert (f"constexpr int NW_OF = HD == 512 ? {HD512_FWD_NW} : HD / 2 < {HD512_BWD_NW} ? "
            f"HD / 2 : {HD512_BWD_NW};") in fwd
    assert f"constexpr int NW_OF = HD / 2 < {HD512_BWD_NW} ? HD / 2 : {HD512_BWD_NW};" in bwd
    assert f"constexpr int STAGES_OF = HD == 512 ? {HD512_FWD_STAGES} : {X3_FWD_STAGES};" in fwd
    assert _constexpr(bwd, "STAGES") == HD512_BWD_STAGES
    assert _constexpr(bwd, "WSTAGES") == HD512_WGRAD_STAGES
    assert "constexpr int GROUP_OF = HD == 512 ? 128 : 32;" in fwd
    assert "static constexpr int HD = HD_, N = HD_ / 2;" in hdr and HD512_HALF == HD512 // 2
    for src, kernels in ((fwd, (HD512_KERNEL, X3_KERNEL)), (bwd, (HD512_BWD_KERNEL, X3_BWD_KERNEL))):
        for hd in (HD512,) + SM90_HIDDEN:
            row = re.search(rf"^//\s+{hd} \|.*\|\s+([\d,]+)(?:\s+\(.*\))?\s*$", src, re.M)
            want = sm90_smem_bytes(kernels[hd < HD512], hd, 3)
            assert int(row.group(1).replace(",", "")) == want, (kernels, hd)
    wg = re.search(r"step list, at TN 64:\n// ([\d,]+) / ([\d,]+) \+ 4 x steps", bwd)
    for passes, got in zip((1, 3), wg.groups()):
        assert int(got.replace(",", "")) == sm90_smem_bytes("wgrad_hd512", HD512, passes)
    for name in (HD512_KERNEL, HD512_BWD_KERNEL):
        assert SOURCES[name] == name and name in LAUNCHES
    for name, src in ((X3_KERNEL, HD512_KERNEL), (X3_BWD_KERNEL, HD512_BWD_KERNEL)):
        assert SOURCES[name] == src and name in LAUNCHES


def _desc_read(img: np.ndarray, nw: int, hmajor: bool, n: np.ndarray,
               k: np.ndarray) -> np.ndarray:
    """Element (n, k) of the B operand as the consumer of column half
    n // 256 reads it: its producer streams that half of the image, chunk
    (K block, column group) after chunk (with ``hmajor`` (column group, K
    block)), each landing 1024-byte aligned in its ring; the descriptor of
    a k8 step starts 32 bytes per step into the chunk, rows 128 bytes apart
    in 8-row groups 1024 bytes (SBO) apart; then the 128-byte swizzle XORs
    address bits 4-6 with bits 7-9."""
    nh, nkc = HD512_HALF // nw, HD512 // SM90_KB
    half, nn = n // HD512_HALF, n % HD512_HALF
    q = (nn // nw) * nkc + k // SM90_KB if hmajor else (k // SM90_KB) * nh + nn // nw
    chunk = (half * HD512_HALF * HD512 + q * nw * SM90_KB) * 4     # bytes
    nl, kl = nn % nw, k % SM90_KB
    addr = (kl // 8) * 32 + (nl // 8) * 1024 + (nl % 8) * 128 + (kl % 8) * 4
    addr = addr ^ (((addr >> 7) & 7) << 4)
    return img[(chunk + addr) // 4]


@pytest.mark.parametrize("part", [0, 1])
@pytest.mark.parametrize("orient", [IMG_T, IMG_N])
@pytest.mark.parametrize("nw,hmajor", [(HD512_FWD_NW, True), (HD512_BWD_NW, False)])
def test_weight_image_reads_back_through_the_descriptor(nw, hmajor, orient, part):
    """Every element of the N-half images (kernel 1's h-major chunk order,
    kernel 2's K-block-major one), read at the descriptor's address, is
    the TF32 big part of the weight entry the product needs (B[n][k] =
    W[k][n] for x @ W, W[n][k] for x @ W^T), or its small part, and big +
    small holds W to 2^-22 of it."""
    w = (np.random.default_rng(nw + 2 * orient + part).standard_normal((HD512, HD512))
         / 20).astype(np.float32)
    img = weight_image_hd512(w, orient, part, nw, hmajor)
    n, k = np.meshgrid(np.arange(HD512), np.arange(HD512), indexing="ij")
    want = w[k, n] if orient == IMG_T else w[n, k]
    big = rna_tf32(want)
    got = _desc_read(img, nw, hmajor, n, k)
    if part == 0:
        assert np.array_equal(got.view(np.uint32), big.view(np.uint32))
    else:
        assert np.array_equal(got.view(np.uint32), rna_tf32(want - big).view(np.uint32))
        err = np.abs(big.astype(np.float64) + got - want)
        assert np.all(err <= 2.0 ** -22 * np.abs(want) + 1e-30)


def test_routing_names_the_kernel_of_each_mode_and_width():
    """Both fp32-chain modes and the bf16 chain at widths 257 to 512 go to
    the width-512 kernels; above 512 both fp32-chain modes go to the Hopper
    kernels above 512; up to 256, 3xTF32
    goes to the shared-tile kernels under their own counters and the
    one-pass mode to the one-pass Hopper kernels."""
    for hd in (257, 300, 384, 511, 512):
        for precision in ("highest", "default"):
            assert band_kernel("egnn_band_fwd", hd, precision) == HD512_KERNEL
            assert band_kernel("egnn_band_bwd", hd, precision) == HD512_BWD_KERNEL
        assert band_kernel("egnn_band_fwd", hd, "default", torch.bfloat16) == HD512_KERNEL
        assert band_kernel("egnn_band_bwd", hd, "highest", torch.bfloat16) == HD512_BWD_KERNEL
    for hd in (513, 640, 1024):
        for precision in ("highest", "default"):
            assert band_kernel("egnn_band_fwd", hd, precision) == "egnn_band_fwd_sm90_wide"
            assert band_kernel("egnn_band_bwd", hd, precision) == "egnn_band_bwd_sm90_wide"
    for hd in (16, 200, 256):
        assert band_kernel("egnn_band_fwd", hd, "highest") == X3_KERNEL
        assert band_kernel("egnn_band_bwd", hd, "default") == "egnn_band_bwd_sm90"


def test_cpu_tensors_keep_the_plain_version():
    """A CPU call at width 512 in either mode is the plain version: no
    kernel launches, the reference's values."""
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import egnn_band_fwd

    g = torch.Generator().manual_seed(5)
    B, L, Hd, Wb = 1, 12, HD512, 3
    a, bs = (torch.randn(B, L, Hd, generator=g) * 0.3 for _ in range(2))
    x = torch.randn(B, L, 3, generator=g) * 5
    cmask = torch.ones(B, L)
    params = [torch.randn(*s, generator=g) / Hd ** 0.5
              for s in ((1, Hd), (Hd, Hd), (Hd,), (Hd, Hd), (Hd,), (Hd, 1), (1,))]
    before = dict(LAUNCHES)
    want = egnn_band_reference(a, bs, x, cmask, *params, Wb)
    for precision in ("highest", "default"):
        got = egnn_band_fwd(a, bs, x, cmask, *params, Wb, precision)
        assert all(torch.equal(p, q) for p, q in zip(got, want))
    assert dict(LAUNCHES) == before


# ---- numpy emulation of the 3xTF32 split ------------------------------------

def _trunc(v):
    """fp32 values read as TF32 by wgmma: the low 13 bits dropped."""
    return (np.asarray(v, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _rz_add(acc, inc):
    """acc + inc in fp32 rounded toward zero, as the tensor cores accumulate."""
    exact = acc.astype(np.float64) + inc
    r = exact.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(exact)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _mm3(x, w, group=128):
    """x @ w as kernel 1 computes it in 3xTF32: the tile holds X and is read
    truncated, Xs = rna(X - trunc(X)); Wb = rna(W), Ws = rna(W - Wb); the
    passes Xt.Ws, Xt.Wb, Xs.Wb, each k8 step added to a step sum rounding
    toward zero, each ``group`` K values' step sum added to the result in
    round-to-nearest fp32 (product_hmajor)."""
    shape = x.shape[:-1] + (w.shape[1],)
    x = x.reshape(-1, x.shape[-1])
    xt = _trunc(x)
    xs = rna_tf32(x - xt)
    wb = rna_tf32(w)
    ws = rna_tf32(w - wb)
    out = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for a, b in ((xt, ws), (xt, wb), (xs, wb)):
        for g in range(0, x.shape[1], group):
            step = np.zeros_like(out)
            for k in range(g, g + group, 8):
                step = _rz_add(step, a[:, k:k + 8].astype(np.float64) @ b[k:k + 8].astype(np.float64))
            out = (out + step).astype(np.float32)
    return out.reshape(shape)


def _mm3_split(x, w, group=32):
    """x @ w as kernel 1 computes it in 3xTF32 up to Hd 256 (product_split):
    Xt.Wb, each k8 step added to a step sum rounding toward zero, each
    ``group`` K values' step sum added to the result in round-to-nearest
    fp32 (32 up to Hd 256); the small terms Xt.Ws and Xs.Wb (Xs from the split tile) in their
    own accumulator rounding toward zero, in the order the chunk pairs
    stream them (a K block's Ws chunk, then its Wb chunk), added to the
    result in round-to-nearest fp32 at the end."""
    shape = x.shape[:-1] + (w.shape[1],)
    x = x.reshape(-1, x.shape[-1])
    xt = _trunc(x)
    xs = rna_tf32(x - xt)
    wb = rna_tf32(w)
    ws = rna_tf32(w - wb)
    f64 = lambda a, k: a[..., k:k + 8].astype(np.float64)  # noqa: E731
    out = np.zeros((x.shape[0], w.shape[1]), np.float32)
    sml = np.zeros_like(out)
    for g in range(0, x.shape[1], group):
        step = np.zeros_like(out)
        for kb in range(g, g + group, 32):
            for k in range(kb, kb + 32, 8):
                sml = _rz_add(sml, f64(xt, k) @ ws[k:k + 8].astype(np.float64))
            for k in range(kb, kb + 32, 8):
                step = _rz_add(step, f64(xt, k) @ wb[k:k + 8].astype(np.float64))
                sml = _rz_add(sml, f64(xs, k) @ wb[k:k + 8].astype(np.float64))
        out = (out + step).astype(np.float32)
    return (out + sml).astype(np.float32).reshape(shape)


def _mm1(x, w):
    """One TF32 pass: both operands rounded as the kernels write them."""
    return (rna_tf32(x) @ rna_tf32(w)).astype(np.float32)


def _silu(v):
    with np.errstate(over="ignore"):
        return v / (np.float32(1) + np.exp(-v))


def _forward(a, bs, x, cmask, params, Wb, mm):
    """agg and raw_delta of the band layer with products ``mm``."""
    w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2 = params
    B, L, _ = x.shape
    offs = np.array([o for o in range(-Wb, Wb + 1) if o], dtype=int)
    j = np.arange(L)[:, None] + offs[None, :]
    jc = np.clip(j, 0, L - 1)
    valid = (((j >= 0) & (j < L))[None] & (cmask[:, :, None] > 0.5)
             & (cmask[:, jc] > 0.5)).astype(np.float32)[..., None]
    rel = (x[:, :, None, :] - x[:, jc, :]) * valid
    d2 = np.sum(rel * rel, axis=-1, keepdims=True)
    m1 = _silu(a[:, :, None, :] + bs[:, jc, :] + d2 * w_d.reshape(-1)) * valid
    m = _silu(mm(m1, w_e2) + b_e2)
    wsc = _silu(mm(m, w_x1) + b_x1) @ w_x2.reshape(-1, 1) + b_x2
    return np.sum(m * valid, axis=2), np.sum(wsc * valid * rel, axis=2)


@pytest.mark.parametrize("Hd", [256, HD512])
def test_three_pass_split_holds_the_plain_version(Hd):
    """Kernel 1's 3xTF32 holds rtol 1e-4 / atol 1e-4 max|plain| of the fp32
    plain version forward; one TF32 pass does not. At Hd 512 the tile is
    read truncated and rewritten as its rounded remainder, three passes
    over two weight images with truncating accumulation in 128-K step sums
    (_mm3); at Hd 256 the remainder lies in its own tile, each Wb chunk
    serves both, the small terms have their own accumulator and the big
    terms' step sums span 32 K (_mm3_split)."""
    rng = np.random.default_rng(11)
    B, L, Wb = 2, 24, 6
    sd = np.float32((Hd / (3 * (2 * Hd + 1))) ** 0.5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    a, bs, x = f(B, L, Hd) * sd, f(B, L, Hd) * sd, f(B, L, 3) * np.float32(10)
    cmask = np.ones((B, L), np.float32)
    cmask[0, L - 4:] = 0
    u = lambda s, fan: ((rng.random(s) * 2 - 1) / np.sqrt(fan)).astype(np.float32)  # noqa: E731
    params = (u((1, Hd), 2 * Hd + 1), u((Hd, Hd), Hd), u((Hd,), Hd), u((Hd, Hd), Hd),
              u((Hd,), Hd), u((Hd, 1), Hd), u((1,), Hd))
    t = [torch.from_numpy(v) for v in (a, bs, x, cmask) + params]
    want = [r.numpy() for r in egnn_band_reference(*t, Wb)]

    def holds(got):
        return all(np.allclose(g, r, rtol=1e-4, atol=1e-4 * np.abs(r).max())
                   for g, r in zip(got, want))

    assert holds(_forward(a, bs, x, cmask, params, Wb, _mm3 if Hd == HD512 else _mm3_split))
    assert not holds(_forward(a, bs, x, cmask, params, Wb, _mm1))
