"""The EGNN band kernels' launch plan and product arithmetic, on the CPU.

- The work split: kernel 1 splits the band offsets of each (batch row, tile
  of 8 receivers) into S slices; kernel 2's edge pass walks (batch row, tile,
  offset step) work items on a persistent grid, block g taking items g,
  g + G, .... Both must cover every step exactly once, and fill the card
  where the grid alone would not.
- The products: kernels 1-2 multiply in 3xTF32 (cvt.rna to TF32, then
  small*big + big*small + big*big in fp32). A numpy emulation of that
  rounding, put through the band function's products, must hold the fp32
  plain version at the forward's tolerance; a single TF32 pass must not.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from protein_ensemble_vae_torch.ops.kernels.egnn_band import (  # noqa: E402
    OPS, TILE, band_gather, band_indices, band_work, bwd_grid,
    egnn_band_reference, fwd_slices)

H100_SMS = 132
# (B, L) of the main paths: generation B1 / B10 at buckets 256 and 640,
# training B4/L256 and B2/L640; W = 40.
MAIN_SHAPES = [(1, 256), (10, 256), (1, 640), (10, 640), (4, 256), (2, 640)]


# ---------------------------------------------------------------------------
# (a) the work split
# ---------------------------------------------------------------------------

def work_items(B, L, W):
    """The work items as (batch row, tile, step) in the order the kernels
    decode item k (csrc/egnn_band_bwd.cu: step fastest, then tile)."""
    n_tiles, n_steps, _ = band_work(B, L, W)
    return [(b, t, s) for b in range(B) for t in range(n_tiles)
            for s in range(n_steps)]


def fwd_slice_steps(W, S):
    """The offset steps each of kernel 1's S slices walks, as the kernel
    splits them (csrc/egnn_band_fwd.cu: ceil(steps / S) per slice)."""
    n_steps = -(-2 * W // OPS)
    per = -(-n_steps // S)
    return [range(s * per, min(n_steps, (s + 1) * per)) for s in range(S)]


@pytest.mark.parametrize("B,L,W", [(1, 256, 40), (4, 256, 40), (2, 640, 40),
                                   (2, 37, 4), (3, 19, 12), (1, 8, 1)])
def test_work_items_are_every_step_once(B, L, W):
    n_tiles, n_steps, items = band_work(B, L, W)
    assert n_tiles == -(-L // TILE) and n_steps == -(-2 * W // OPS)
    listed = work_items(B, L, W)
    assert len(listed) == items
    assert set(listed) == {(b, t, s) for b in range(B) for t in range(n_tiles)
                           for s in range(n_steps)}
    # step fastest, then tile, then batch row: how the kernel decodes item k
    for k, (b, t, s) in enumerate(listed):
        assert (s, (k // n_steps) % n_tiles, k // (n_steps * n_tiles)) == (s, t, b)
        assert k % n_steps == s


@pytest.mark.parametrize("n_sm", [1, 16, 132, 1000])
@pytest.mark.parametrize("B,L", MAIN_SHAPES + [(2, 37)])
def test_persistent_grid_takes_every_item_once(B, L, n_sm):
    _, _, items = band_work(B, L, 40)
    G, nsplit = bwd_grid(B, L, 40, 256, n_sm)
    assert 1 <= G <= min(items, 2 * n_sm) and 1 <= nsplit <= items
    taken = [k for g in range(G) for k in range(g, items, G)]
    assert sorted(taken) == list(range(items))
    # weight-grad slices: ceil(items / nsplit) items each, none left over
    per = -(-items // nsplit)
    assert sum(len(range(s * per, min(items, (s + 1) * per))) for s in range(nsplit)) == items


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("B,L", MAIN_SHAPES)
def test_full_width_grids_fill_the_card(B, L, per_sm):
    _, _, items = band_work(B, L, 40)
    G, nsplit = bwd_grid(B, L, 40, 256, H100_SMS, per_sm)
    assert G == per_sm * H100_SMS <= items       # one wave: a block per slot
    assert 2 * (256 // 128) ** 2 * nsplit >= 2 * H100_SMS
    n_tiles = band_work(B, L, 40)[0]
    assert B * n_tiles * fwd_slices(B, L, 40, H100_SMS) >= 128


@pytest.mark.parametrize("W", [1, 4, 12, 40])
@pytest.mark.parametrize("B,L", MAIN_SHAPES + [(1, 37), (2, 19)])
def test_offset_slices_cover_every_step_once(B, L, W):
    S = fwd_slices(B, L, W, H100_SMS)
    n_steps = band_work(B, L, W)[1]
    slices = fwd_slice_steps(W, S)
    assert len(slices) == S and all(len(r) > 0 for r in slices)
    assert [s for r in slices for s in r] == list(range(n_steps))


@pytest.mark.parametrize("B,L,S", [
    (1, 256, 10), (1, 640, 10), (4, 256, 10), (2, 640, 10),   # one step a block
    (10, 256, 10), (10, 640, 4),
    (80, 256, 1), (32, 640, 1), (64, 512, 1)])                # >= 8 waves already
def test_offset_slices_at_the_main_shapes(B, L, S):
    """Two blocks per SM on 132 SMs: 264 slots, 8 waves = 2,112 blocks.
    B1/L256 has 32 (batch row, tile) blocks -> one step per block, 320
    blocks; B10/L640 has 800 -> 3 steps per block, 4 slices, 3,200 blocks;
    grids of >= 2,112 blocks keep one slice and need no second pass."""
    assert fwd_slices(B, L, 40, H100_SMS, 2) == S
    blocks = B * band_work(B, L, 40)[0]
    assert S == 1 or blocks * S >= 8 * 2 * H100_SMS or S == band_work(B, L, 40)[1]


# ---------------------------------------------------------------------------
# (b) 3xTF32 products
# ---------------------------------------------------------------------------

def tf32_rna(x: np.ndarray) -> np.ndarray:
    """Round fp32 to TF32 as ``cvt.rna.tf32.f32`` does: keep 10 mantissa
    bits, round half away from zero (add half of the dropped range to the
    magnitude bits, then clear the low 13 bits)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels compute it: each operand split into TF32 big +
    small parts, small*big + big*small + big*big accumulated in fp32 (each
    TF32 x TF32 product is exact in fp32)."""
    def split(t):
        v = t.detach().numpy()
        big = tf32_rna(v)
        return torch.from_numpy(big), torch.from_numpy(tf32_rna(v - big))

    (ab, al), (bb, bl) = split(a), split(b)
    return al @ bb + ab @ bl + ab @ bb


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass."""
    return (torch.from_numpy(tf32_rna(a.numpy()))
            @ torch.from_numpy(tf32_rna(b.numpy())))


def band_chain(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2, b_x2, W, mm):
    """``egnn_band_reference`` with its two Hd x Hd products (the ones the
    kernels run on the tensor cores) taken by ``mm``."""
    L = a.shape[1]
    idx, in_range = band_indices(L, W)
    cm = cmask > 0.5
    valid = in_range[None] & cm[:, :, None] & cm[:, idx]
    mask_k = valid.to(a.dtype)[..., None]
    rel = x[:, :, None, :] - band_gather(x, idx)
    d2 = torch.sum(rel * rel, dim=-1, keepdim=True)
    pre = a[:, :, None, :] + band_gather(bs, idx) + d2 * w_d.reshape(-1)
    m = F.silu(mm(F.silu(pre), w_e2) + b_e2.reshape(-1))
    agg = torch.sum(m * mask_k, dim=2)
    w = F.silu(mm(m, w_x1) + b_x1.reshape(-1)) @ w_x2.reshape(-1, 1) + b_x2.reshape(1)
    return agg, torch.sum((w * mask_k) * rel, dim=2)


def _model_scale_inputs(B, L, Hd, seed):
    """Inputs at the model's scale (chip_smoke.py's): unit-variance
    projections through the split edge layer, ~15 A coordinates, the
    layer's init for the weights, a masked tail."""
    rng = np.random.default_rng(seed)
    fan_e1 = 2 * Hd + 1
    sd = np.sqrt(Hd / (3 * fan_e1))

    def u(shape, fan_in):
        return (rng.uniform(-1, 1, shape) / np.sqrt(fan_in)).astype(np.float32)

    a = (rng.normal(0, 1, (B, L, Hd)) * sd).astype(np.float32)
    bs = (rng.normal(0, 1, (B, L, Hd)) * sd).astype(np.float32)
    x = (rng.normal(0, 1, (B, L, 3)) * 10.0).astype(np.float32)
    cmask = np.ones((B, L), np.float32)
    cmask[0, L - L // 8:] = 0.0
    params = (u((1, Hd), fan_e1), u((Hd, Hd), Hd), u((Hd,), Hd), u((Hd, Hd), Hd),
              u((Hd,), Hd), u((Hd, 1), Hd), u((1,), Hd))
    return [torch.from_numpy(v) for v in (a, bs, x, cmask) + params]


def test_tf32_rounding_is_round_half_away():
    # ties (half a TF32 ulp = 2^-11 at 1) go away from zero, both signs
    x = np.array([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                  -(1 + 2 ** -12), 0.0], np.float32)
    want = np.array([1.0, 1 + 2 ** -10, 1 + 2 * 2 ** -10, -(1 + 2 ** -10), 1.0,
                     -1.0, 0.0], np.float32)
    got = tf32_rna(x)
    np.testing.assert_array_equal(got, want)
    assert not (got.view(np.uint32) & 0x1FFF).any()


def test_band_chain_is_the_plain_version():
    args = _model_scale_inputs(1, 32, 64, seed=1)
    for got, want in zip(band_chain(*args, 8, mm=torch.matmul),
                         egnn_band_reference(*args, 8)):
        assert torch.equal(got, want)


def test_3xtf32_holds_the_forward_tolerance():
    """Hd = 256, B1/L64, W = 40 at the model's scale: the 3xTF32 products
    hold rtol 1e-4 / atol 1e-4 * max|plain| against the fp32 plain version
    (the forward's tolerance on the card); one TF32 pass is far worse."""
    args = _model_scale_inputs(1, 64, 256, seed=3)
    plain = egnn_band_reference(*args, 40)
    three = band_chain(*args, 40, mm=mm_3xtf32)
    one = band_chain(*args, 40, mm=mm_tf32)
    for name, got, single, want in zip(("agg", "raw_delta"), three, one, plain):
        scale = float(want.abs().max())
        err3 = float((got - want).abs().max()) / scale
        err1 = float((single - want).abs().max()) / scale
        print(f"{name}: max |error| / max|plain|: 3xTF32 {err3:.2e}, "
              f"one TF32 pass {err1:.2e}")
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
        assert err3 < err1 / 30


@pytest.mark.parametrize("rows", [64, 5120])
def test_3xtf32_weight_grad_product(rows):
    """The backward's weight-grad products X^T Y sum over many edges: 3xTF32
    stays within 1e-5 of the float64 product's scale."""
    rng = np.random.default_rng(rows)
    xs = torch.from_numpy(rng.normal(0, 3, (rows, 256)).astype(np.float32))
    ys = torch.from_numpy(rng.normal(0, 0.1, (rows, 256)).astype(np.float32))
    exact = xs.double().t() @ ys.double()
    scale = float(exact.abs().max())
    err3 = float((mm_3xtf32(xs.t().contiguous(), ys).double() - exact).abs().max())
    err1 = float((mm_tf32(xs.t().contiguous(), ys).double() - exact).abs().max())
    assert err3 < 1e-5 * scale and err3 < err1 / 30
