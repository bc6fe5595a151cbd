"""The bf16 edge chain (``chain_dtype=bfloat16``) on the Hopper kernels,
checked on the CPU: its routing at every width to the three families
(``egnn_band_{fwd,bwd}_sm90`` up to 256, ``_sm90_hd512`` at 512 and the
padded widths below it, ``_sm90_wide`` above), the shared memory of each
family's bf16 layout against the sources' budget tables, the bf16 weight
images and their 16-bit swizzle through a numpy mirror of the layout
kernel (``weight_image_bf16``), the copy of a step's bf16 tile into the
weight-grad layout, and a numpy model of one bf16 ``wgmma`` product (bf16
operands, an fp32 sum, one rounding) against the plain version's
``_bf16_mm``. The kernels themselves run in tests/test_torch_gpu.py on the
chip."""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from protein_ensemble_vae_torch.ops.kernels import LAUNCHES, SOURCES  # noqa: E402
from protein_ensemble_vae_torch.ops.kernels.egnn_band import (  # noqa: E402
    BF16_CHAIN, HD512_BF16_STAGES, HD512_BWD_KERNEL, HD512_KERNEL, IMG_N, IMG_T, SM90_BWD_KERNEL,
    SM90_HIDDEN, SM90_KB, SM90_KERNEL, SMEM_LIMIT, WIDE_BWD_KERNEL, WIDE_KERNEL, WIDE_NW,
    _bf16_mm, band_kernel, band_work, bf16_bits, bf16_image_words, kernel_passes, mode_key,
    native_width, shared_tile_nw, sm90_bwd_grid, sm90_cols, sm90_smem_bytes, sw_off,
    weight_image_bf16)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "protein_ensemble_vae_torch", "csrc")
N_SM = 132
CHAIN = torch.bfloat16


def _src(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _family(hd: int) -> tuple[str, str]:
    """The kernels (counters) that serve the bf16 chain at native width hd."""
    if hd > 512:
        return WIDE_KERNEL, WIDE_BWD_KERNEL
    if hd == 512:
        return HD512_KERNEL, HD512_BWD_KERNEL
    return SM90_KERNEL, SM90_BWD_KERNEL


# ---- routing ----------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(8, 256), (257, 512), (513, 1024), (1025, 2048)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_routing_of_the_bf16_chain_at_every_width(lo, hi, dtype):
    """Every width from 8 to 2048 in the bf16 chain, with bf16 or fp32 a /
    bs and either precision (which selects nothing there), runs on a Hopper
    family at its native width and counts under that family's name with the
    mode's bfloat16_chain key; no width names an mma.sync kernel."""
    for hd in range(lo, hi + 1, 7):
        want = _family(native_width(hd))
        for precision in ("highest", "default"):
            got = tuple(band_kernel(k, hd, precision, CHAIN)
                        for k in ("egnn_band_fwd", "egnn_band_bwd"))
            assert got == want, (hd, precision)
            for name in got:
                key = mode_key(name, dtype, precision, CHAIN)
                assert key == f"{name}:{str(dtype)[6:]}/bfloat16_chain"
            assert kernel_passes(precision, CHAIN) == BF16_CHAIN == 0


def test_no_mode_or_width_names_an_mma_sync_kernel():
    """In every mode (3xTF32, one pass, the bf16 chain) and at every width
    up to 2048, ``band_kernel`` names a Hopper kernel, one that
    ``LAUNCHES`` counts and ``SOURCES`` builds."""
    for hd in range(1, 2049, 5):
        for precision, chain in (("highest", torch.float32), ("default", torch.float32),
                                 ("default", CHAIN), ("highest", CHAIN)):
            for k in ("egnn_band_fwd", "egnn_band_bwd"):
                name = band_kernel(k, hd, precision, chain)
                assert "_sm90" in name and name in LAUNCHES and name in SOURCES, (hd, name)


# ---- shared memory ----------------------------------------------------------

def _budget_rows(src: str) -> dict:
    """The '(bf16)' rows of a source's budget tables: first column -> total."""
    rows = {}
    for m in re.finditer(r"^//\s+(\d+)\s+\|.*\|\s+([\d,]+)\s+\(bf16\)\s*$", src, re.M):
        rows[int(m.group(1))] = int(m.group(2).replace(",", ""))
    return rows


@pytest.mark.parametrize("kernel,src", [(SM90_KERNEL, "egnn_band_fwd_sm90.cu"),
                                        (SM90_BWD_KERNEL, "egnn_band_bwd_sm90.cu")])
def test_one_pass_family_budgets_match_the_sources(kernel, src):
    """The bf16 chain's shared memory up to 256: the mirror gives each
    source's '(bf16)' budget row at every width, under the block limit."""
    rows = _budget_rows(_src(src))
    assert sorted(rows) == list(SM90_HIDDEN)
    for hd in SM90_HIDDEN:
        got = sm90_smem_bytes(kernel, hd, BF16_CHAIN)
        assert got == rows[hd] and got <= SMEM_LIMIT, (kernel, hd)


@pytest.mark.parametrize("kernel,src", [(HD512_KERNEL, "egnn_band_fwd_sm90_hd512.cu"),
                                        (HD512_BWD_KERNEL, "egnn_band_bwd_sm90_hd512.cu")])
def test_shared_tile_budgets_match_the_sources(kernel, src):
    """The bf16 chain at 512: the mirror gives the '(bf16)' row (a 64 KiB
    bf16 tile; kernel 1 with BF16_STAGES chunks a ring), under the limit."""
    rows = _budget_rows(_src(src))
    assert list(rows) == [512]
    got = sm90_smem_bytes(kernel, 512, BF16_CHAIN)
    assert got == rows[512] and got <= SMEM_LIMIT


@pytest.mark.parametrize("kernel", [SM90_KERNEL, SM90_BWD_KERNEL, HD512_KERNEL, HD512_BWD_KERNEL,
                                    WIDE_KERNEL, WIDE_BWD_KERNEL])
def test_bf16_layouts_fit_a_block(kernel):
    """Every family's block asks for at most 232,448 bytes in the bf16
    chain at each width it takes; the bf16 tiles are at most the fp32
    ones (the wide kernels: the one-pass layout, at every width)."""
    widths = {SM90_KERNEL: SM90_HIDDEN, SM90_BWD_KERNEL: SM90_HIDDEN, HD512_KERNEL: (512,),
              HD512_BWD_KERNEL: (512,)}.get(kernel, range(768, 2049, 256))
    for hd in widths:
        got = sm90_smem_bytes(kernel, hd, BF16_CHAIN)
        assert got <= SMEM_LIMIT, (kernel, hd)
        if kernel in (WIDE_KERNEL, WIDE_BWD_KERNEL):
            assert got == sm90_smem_bytes(kernel, hd, 1)


@pytest.mark.parametrize("kernel,hd", [("wgrad", 256), ("wgrad_hd512", 512), ("wgrad_wide", 2048)])
def test_weight_grad_passes_fit_two_blocks(kernel, hd):
    """The weight-grad passes keep their one-pass layout in the bf16 chain
    (a stage of 64 + TN rows of 128 bytes); with the step list of B2/L640
    two blocks fit an SM."""
    _, _, items = band_work(2, 640, 40)
    _, nsplit = sm90_bwd_grid(2, 640, 40, hd, N_SM, 1, shared=kernel != "wgrad")
    steps = -(-items // nsplit)
    got = sm90_smem_bytes(kernel, hd, BF16_CHAIN, steps)
    assert got == sm90_smem_bytes(kernel, hd, 1, steps)
    assert 2 * got <= 228 * 1024


def test_wrapper_constants_match_the_sources():
    """The wrapper reads the sources' constants of the bf16 chain: its
    `passes` code, the shared-tile kernel 1's ring depth, the words of a
    bf16 image, the per-width k steps, and the wgmma form."""
    hdr, fwd512 = _src("egnn_sm90.cuh"), _src("egnn_band_fwd_sm90_hd512.cu")
    assert f"constexpr int BF16_STAGES = {HD512_BF16_STAGES};" in fwd512
    assert "return (size_t)kwords_bf16(hd) * hd;" in hdr
    assert "return hd / 2 < KB ? KB : hd / 2;" in hdr
    assert "static constexpr int KS = BF && HD < 64 ? 2 : KB / 8;" in hdr
    assert 'k16.f32.bf16.bf16 " REGS' in hdr and "p, 1, 1, 0, 0;" in hdr
    for name in ("egnn_band_fwd_sm90.cu", "egnn_band_bwd_sm90.cu"):
        assert "passes ? f(hd_c, in_c, std::false_type{}) : f(hd_c, in_c, std::true_type{})" in _src(name)
    for name in ("egnn_band_fwd_sm90_hd512.cu", "egnn_band_bwd_sm90_hd512.cu"):
        assert ("if (hd == 512 && passes == 0) return by_in(Int<512>{}, Int<1>{}, std::true_type{});"
                in _src(name))
    for name in ("egnn_band_fwd_sm90_wide.cu", "egnn_band_bwd_sm90_wide.cu"):
        assert "if (passes == 0) return by_in(Int<1>{}, std::true_type{});" in _src(name)
    for hd in (32, 64, 256, 512, 1024):
        assert bf16_image_words(hd) == max(hd // 2, SM90_KB) * hd


# ---- the bf16 weight images ---------------------------------------------------

def _image_configs():
    """(Hd, nw, halves, hmajor) of every family's images in the bf16 chain."""
    out = [(hd, sm90_cols(hd)[0], 1, False) for hd in SM90_HIDDEN]
    out += [(512, shared_tile_nw(HD512_KERNEL, 512), 2, True),
            (512, shared_tile_nw(HD512_BWD_KERNEL, 512), 2, False)]
    out += [(hd, 2 * WIDE_NW[1], 1, True) for hd in (768, 1024)]
    return out


def _desc_read_bf16(img: np.ndarray, hd: int, nw: int, halves: int, hmajor: bool,
                    n: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Element (n, k) of the B operand as a consumer's descriptor reads it:
    the chunk of output row n's column group and K value k's block, each
    chunk nw rows of 128 bytes (8-row groups 1024 bytes apart), a k16 step
    32 bytes in; the 128-byte swizzle XORs the 16-byte chunk index with the
    row's index mod 8; two bf16 a word, the even K value in the low half."""
    kw = max(hd // 2, SM90_KB)
    nkc, cols = kw // SM90_KB, hd // halves
    nh = cols // nw
    half, nn = n // cols, n % cols
    h, nl = nn // nw, nn % nw
    kc, kk = k // (2 * SM90_KB), k % (2 * SM90_KB)
    q = h * nkc + kc if hmajor else kc * nh + h
    chunk = half * (kw * cols) + q * nw * SM90_KB
    word = chunk + nl * SM90_KB + ((((kk // 8) ^ (nl & 7)) & 7) << 2) + (kk // 2) % 4
    return img[2 * word + kk % 2]


@pytest.mark.parametrize("hd,nw,halves,hmajor", _image_configs())
@pytest.mark.parametrize("orient", [IMG_T, IMG_N])
def test_bf16_image_reads_back_through_the_descriptor(hd, nw, halves, hmajor, orient):
    """Every element of the bf16 image, read where the descriptor finds it,
    is its weight entry rounded to bf16 (to nearest even): w[k][n] for
    x @ W (IMG_T), w[n][k] for x @ W^T (IMG_N)."""
    rng = np.random.default_rng(hd + nw + orient)
    w = rng.normal(0, 0.3, (hd, hd)).astype(np.float32)
    img = weight_image_bf16(w, orient, nw, halves, hmajor)
    assert img.dtype == np.uint16 and img.size == 2 * bf16_image_words(hd)
    n, k = np.meshgrid(np.arange(hd), np.arange(hd), indexing="ij")
    got = _desc_read_bf16(img, hd, nw, halves, hmajor, n, k)
    want = bf16_bits(w[k, n] if orient == IMG_T else w[n, k])
    assert np.array_equal(got, want)


def test_bf16_rounding_is_torchs():
    """bf16_bits rounds as torch's cast does, ties to even, at the bf16
    grid's halfway points and away from them."""
    base = np.float32(1.0) + np.arange(-64, 64, dtype=np.float32) * np.float32(2.0 ** -9)
    v = np.concatenate([base, -base, np.float32(3.0e-3) * base,
                        np.random.default_rng(0).normal(0, 10, 4096).astype(np.float32)])
    want = torch.from_numpy(v).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(bf16_bits(v), want)


def test_width_32_pads_k_with_zeros():
    """At Hd 32 a K block of 64 values is half used: the image holds the
    32 K values of each row and zeros in the other half (the kernels run
    two k16 steps of four there and never read them)."""
    w = np.random.default_rng(3).normal(0, 1, (32, 32)).astype(np.float32)
    img = weight_image_bf16(w, IMG_T, 32)
    n, k = np.meshgrid(np.arange(32), np.arange(32, 64), indexing="ij")
    assert np.all(_desc_read_bf16(img, 32, 32, 1, False, n, k) == 0)
    assert np.count_nonzero(img) == np.count_nonzero(bf16_bits(w))


# ---- the weight-grad copy ----------------------------------------------------

def _copy(tile_words: np.ndarray, hd: int, tasks) -> np.ndarray:
    """egnn_sm90.cuh's wgrad_copy_bf16 over `tasks` (K block, word column
    fp, 8-row group c) of a step's bf16 tile ([64][Hd / 2] words, swizzled),
    into the weight-grad layout ([Hd][32] words): each task reads its rows
    from 8c + c % 8 on (v[i] = row 8c + (i + c) % 8) and rotates them back by
    c in three conditional steps; returns the layout as uint16 and the count
    of writes to each of its words."""
    dst = np.zeros(hd * SM90_KB, dtype=np.uint32)
    writes = np.zeros(hd * SM90_KB, dtype=int)
    for kb, fp, c in tasks:
        blk = tile_words[kb * 64 * SM90_KB:]
        v = []
        for i in range(8):
            r = 8 * c + ((i + c) & 7)
            v.append(int(blk[r * SM90_KB + ((((fp >> 2) ^ (r & 7)) & 7) << 2) + (fp & 3)]))
        b = 1
        while b < 8:
            if c & b:
                v = [v[(j - b) & 7] for j in range(8)]
            b <<= 1
        k = 64 * kb + 2 * fp
        for f in range(2):
            parts = [(v[2 * j] >> 16 * f) & 0xFFFF | ((v[2 * j + 1] >> 16 * f) & 0xFFFF) << 16
                     for j in range(4)]
            at = (k + f) * SM90_KB + ((c ^ ((k + f) & 7)) << 2)
            dst[at:at + 4] = parts
            writes[at:at + 4] += 1
    return dst.view(np.uint16), writes


def _task(task: int, fp_n: int) -> tuple[int, int]:
    """egnn_sm90.cuh's wgrad_task_bf16: (fp, c) of a K block's task."""
    return 4 * ((task >> 5) % (fp_n >> 2)) + (task & 3), (task >> 2) & 7


def _tasks(hd: int, family: str):
    """The copy's tasks in the order each family's threads take them."""
    kw = max(hd // 2, SM90_KB)
    fp_n = hd // 2 if hd < 64 else SM90_KB
    if family == "one_pass":   # tile_to_scratch_bf16: K block by K block
        per_kb = fp_n * 8
        return [(t // per_kb, *_task(t % per_kb, fp_n)) for t in range(kw // SM90_KB * per_kb)]
    if family == "shared":     # eight parts of 256 threads
        return [(t // 256, *_task(t % 256, SM90_KB)) for t in range(8 * 256)]
    # wide: K block kc by the consumer kc % 2, its 128 threads two tasks each
    return [(kc, *_task(task, SM90_KB)) for kc in range(hd // 64) for t in range(128)
            for task in (t, t + 128)]


@pytest.mark.parametrize("hd,family", [(32, "one_pass"), (64, "one_pass"), (128, "one_pass"),
                                       (256, "one_pass"), (512, "shared"), (1024, "wide")])
def test_weight_grad_copy_transposes_the_tile_once(hd, family):
    """Every (feature, edge row) of a step's bf16 tile lands once in the
    weight-grad layout, where that pass's descriptor reads it: feature k's
    row of one 64-row K block, edge e's value at the swizzled word e / 2."""
    rng = np.random.default_rng(hd)
    vals = rng.integers(1, 2 ** 16, (64, hd), dtype=np.uint64)   # (edge, feature)
    kw = max(hd // 2, SM90_KB)
    tile = np.zeros(64 * kw * 2, dtype=np.uint16)
    e, k = np.meshgrid(np.arange(64), np.arange(hd), indexing="ij")
    tile[2 * sw_off(e, k // 2, 64) + k % 2] = vals[e, k]
    dst, writes = _copy(tile.view(np.uint32), hd, _tasks(hd, family))
    assert np.all(writes == 1)
    got = dst[2 * (k * SM90_KB + ((((e // 8) ^ (k & 7)) & 7) << 2) + (e // 2) % 4) + e % 2]
    assert np.array_equal(got, vals[e, k].astype(np.uint16))


# ---- one bf16 wgmma product ---------------------------------------------------

def _bf16(v):
    """numpy float32 values rounded to bf16, as float32."""
    return (bf16_bits(v).astype(np.uint32) << 16).view(np.float32)


@pytest.mark.parametrize("hd", [256, 1024])
def test_bf16_product_model_holds_the_plain_version(hd):
    """A bf16 wgmma product as the kernels use it: bf16 operands (exact
    products in fp32), fp32 sums of each 16-value k step added in K order,
    the result rounded once to bf16 (the chain's epilogue). Against the
    plain version's ``_bf16_mm`` (an fp32 matrix product of the same bf16
    values, rounded once) it differs only in the order of the fp32 sums: at
    most one bf16 step anywhere, and in few elements."""
    rng = np.random.default_rng(hd)
    a = _bf16(rng.normal(0, 1, (64, hd)).astype(np.float32))
    w = _bf16(rng.normal(0, hd ** -0.5, (hd, hd)).astype(np.float32))
    acc = np.zeros((64, hd), dtype=np.float32)
    for k0 in range(0, hd, 16):
        acc += (a[:, k0:k0 + 16].astype(np.float64) @ w[k0:k0 + 16].astype(np.float64)).astype(np.float32)
    model = _bf16(acc)
    plain = _bf16_mm(torch.from_numpy(a).bfloat16(), torch.from_numpy(w).bfloat16()).float().numpy()
    step = np.abs(plain) * 2.0 ** -7 + 1e-30     # one bf16 step at |plain|, at most
    diff = np.abs(model - plain)
    assert np.all(diff <= step)
    assert np.count_nonzero(diff) <= 0.02 * diff.size
