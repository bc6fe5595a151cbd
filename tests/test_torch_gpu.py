"""Tests of the port that need an NVIDIA GPU (marker ``gpu``): the CUDA
kernels against their plain PyTorch versions, at small and full widths, the
autograd functions that join them, and a train step with no host
synchronisation.

They skip where no CUDA device is present. This file imports neither JAX
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py -q
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from protein_ensemble_vae_torch.config import ModelConfig  # noqa: E402
from protein_ensemble_vae_torch.models import HierCVAE  # noqa: E402
from protein_ensemble_vae_torch.ops.kernels import LAUNCHES  # noqa: E402
from protein_ensemble_vae_torch.ops.kernels.clash import (  # noqa: E402
    backbone_atoms, clash_bwd, clash_bwd_reference, clash_fwd,
    clash_fwd_reference, clash_loss_kernel)
from protein_ensemble_vae_torch.ops.kernels.egnn_band import (  # noqa: E402
    egnn_band_bwd, egnn_band_bwd_reference, egnn_band_fused, egnn_band_fwd,
    egnn_band_reference)
from protein_ensemble_vae_torch.ops.routing import set_full_fp32  # noqa: E402

pytestmark = pytest.mark.gpu

# fp32 kernel vs fp32 plain version, sums in another order.
RTOL = ATOL = 1e-4


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_full_fp32()
    return torch.device("cuda")


def _inputs(B, L, Hd, device, seed=0, x_scale=10.0):
    """Model-scale inputs (init-scale weights, unit-variance projections
    through the split edge layer, ~15 A coordinates), masked tail + hole."""
    g = torch.Generator().manual_seed(seed)

    def u(shape, fan_in):
        return (torch.rand(shape, generator=g) * 2 - 1) / fan_in ** 0.5

    fan_e1 = 2 * Hd + 1
    sd = (Hd / (3 * fan_e1)) ** 0.5
    a = torch.randn(B, L, Hd, generator=g) * sd
    bs = torch.randn(B, L, Hd, generator=g) * sd
    x = torch.randn(B, L, 3, generator=g) * x_scale
    cmask = torch.ones(B, L)
    cmask[0, L - L // 5:] = 0.0
    cmask[-1, L // 3] = 0.0
    params = (u((1, Hd), fan_e1), u((Hd, Hd), Hd), u((Hd,), Hd),
              u((Hd, Hd), Hd), u((Hd,), Hd), u((Hd, 1), Hd), u((1,), Hd))
    return [t.to(device).contiguous() for t in (a, bs, x, cmask) + params]


@pytest.mark.parametrize("B,L,Hd,W", [
    (2, 37, 32, 4), (3, 70, 64, 4), (1, 50, 128, 8), (2, 19, 64, 12),
    (2, 256, 256, 40), (1, 640, 256, 40), (4, 129, 256, 40),
])
def test_kernel_matches_plain_version(cuda, B, L, Hd, W):
    args = _inputs(B, L, Hd, cuda, seed=B * 1000 + L)
    before = LAUNCHES["egnn_band_fwd"]
    agg, delta = egnn_band_fwd(*args, W)
    torch.cuda.synchronize()
    assert LAUNCHES["egnn_band_fwd"] == before + 1
    ragg, rdelta = egnn_band_reference(*args, W)
    torch.testing.assert_close(agg, ragg, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(delta, rdelta, rtol=RTOL, atol=ATOL)
    # masked receivers stay exactly zero
    n_masked = L // 5
    if n_masked:
        assert float(agg[0, L - n_masked:].abs().max()) == 0.0


def test_routing_and_checks_on_cuda(cuda):
    args = _inputs(2, 64, 32, cuda)
    before = LAUNCHES["egnn_band_fwd"]
    for mode in ("auto", "interpret", True):
        egnn_band_fused(*args, 4, "highest", use_pallas=mode)
    assert LAUNCHES["egnn_band_fwd"] == before + 3
    egnn_band_fused(*args, 4, "highest", use_pallas=False)
    assert LAUNCHES["egnn_band_fwd"] == before + 3
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(ValueError, match="float32"):
        egnn_band_fwd(*bad, 4)
    bad[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        egnn_band_fwd(*bad, 4)
    bad[0] = args[0][..., :30].contiguous()
    with pytest.raises(ValueError):
        egnn_band_fwd(*bad, 4)
    # a width outside the native ones runs the kernel, zero-padded to 64
    args48 = _inputs(1, 16, 48, cuda)
    before = LAUNCHES["egnn_band_fwd"]
    agg, delta = egnn_band_fwd(*args48, 4)
    assert LAUNCHES["egnn_band_fwd"] == before + 1 and agg.shape == (1, 16, 48)
    for got, want in zip((agg, delta), egnn_band_reference(*args48, 4)):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("Hd", [513, 1024])
def test_width_above_the_limit_raises(cuda, Hd):
    """Above 512 (once the limit, where both wrappers raised) the wide
    variants run: 513 zero-padded to 768, 1024 at its own width. Both
    wrappers and the routed entry launch their kernel once each and match
    the plain versions (forward at rtol 1e-4 / atol 1e-4 x max|plain|, the
    gradients as the other widths')."""
    args = _inputs(1, 16, Hd, cuda)
    before = dict(LAUNCHES)
    out = egnn_band_fwd(*args, 4)
    g = torch.Generator(device="cpu").manual_seed(Hd)
    g_agg = torch.randn(1, 16, Hd, generator=g).to(cuda)
    g_delta = torch.randn(1, 16, 3, generator=g).to(cuda)
    grads = egnn_band_bwd(*args, g_agg, g_delta, 4)
    routed = egnn_band_fused(*args, 4, "highest")
    torch.cuda.synchronize()
    assert LAUNCHES["egnn_band_fwd"] == before["egnn_band_fwd"] + 2
    assert LAUNCHES["egnn_band_bwd"] == before["egnn_band_bwd"] + 1
    want = egnn_band_reference(*args, 4)
    for got in (out, routed):
        for a, b in zip(got, want):
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL * float(b.abs().max()))
    for name, a, b in zip(_GRAD_NAMES, grads, egnn_band_bwd_reference(*args, g_agg, g_delta, 4)):
        assert a.shape == b.shape, name
        _close_scaled(a, b, name)


# Widths above 512: the wide variants of kernels 1-2 (Hd a multiple of 256
# at run time; any other width zero-padded up: 640 -> 768, 1100 -> 1280) in
# every mode, against the plain versions at the tolerances of the other
# widths: 3xTF32 at rtol 1e-4 / atol 1e-4 x max|plain| (values) and
# _close_scaled (gradients); the bf16-model mode (bf16 a / bs, one TF32
# pass) at BF16_VALUE_FRAC / BF16_GRAD_FRAC; the bf16 chain through
# _check_chain.
WIDE_HD = [640, 1024, 1100, 2048]


@pytest.mark.parametrize("mode", ["highest", "default", "bfloat16_chain"])
@pytest.mark.parametrize("Hd", WIDE_HD)
def test_wide_widths_match_plain_versions(cuda, Hd, mode):
    from protein_ensemble_vae_torch.ops.kernels import BAND_MODE_LAUNCHES
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import mode_key

    B, L, W = 2, 37, 12
    args = _inputs(B, L, Hd, cuda, seed=Hd + 3)
    if mode == "bfloat16_chain":
        _check_chain(_bf16_args(args), W, seed=Hd)
        return
    if mode == "default":
        args = _bf16_args(args)
    keys = [mode_key(k, args[0].dtype, mode) for k in ("egnn_band_fwd", "egnn_band_bwd")]
    before = [BAND_MODE_LAUNCHES.get(k, 0) for k in keys]
    out = egnn_band_fwd(*args, W, mode)
    g = torch.Generator(device="cpu").manual_seed(Hd)
    g_agg = torch.randn(B, L, Hd, generator=g).to(cuda)
    g_delta = torch.randn(B, L, 3, generator=g).to(cuda)
    got = egnn_band_bwd(*args, g_agg, g_delta, W, mode)
    torch.cuda.synchronize()
    assert [BAND_MODE_LAUNCHES.get(k, 0) for k in keys] == [n + 1 for n in before]
    want = egnn_band_reference(*args, W)
    wgrads = egnn_band_bwd_reference(*args, g_agg, g_delta, W)
    for name, a, b in zip(("agg", "raw_delta"), out, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        if mode == "highest":
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL * float(b.abs().max()))
        else:
            _within_frac(a, b, BF16_VALUE_FRAC, name)
    for name, a, b in zip(_GRAD_NAMES, got, wgrads):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if mode == "highest":
            _close_scaled(a, b, name)
        else:
            _within_frac(a, b, BF16_GRAD_FRAC, name)


@pytest.mark.parametrize("Hd", [1024, 2048])
def test_wide_widths_two_launches_are_bitwise_identical(cuda, Hd):
    """The wide variants sum in a fixed order (the lane that owns a column,
    then the groups, then the persistent blocks' partials): two launches at
    B2/L256/W40 give bitwise-identical outputs, and a masked tail stays
    exactly zero."""
    B, L = 2, 256
    args = _inputs(B, L, Hd, cuda, seed=Hd + 17)
    g = torch.Generator(device="cpu").manual_seed(L)
    g_agg = torch.randn(B, L, Hd, generator=g).to(cuda)
    g_delta = torch.randn(B, L, 3, generator=g).to(cuda)
    first = egnn_band_fwd(*args, 40) + egnn_band_bwd(*args, g_agg, g_delta, 40)
    second = egnn_band_fwd(*args, 40) + egnn_band_bwd(*args, g_agg, g_delta, 40)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert float(first[0][0, L - L // 5:].abs().max()) == 0.0


@pytest.mark.parametrize("hidden", [16, 48, 512])
def test_decoder_kernel_path_at_every_width(cuda, hidden):
    """A model at a padded width (16, 48) and at Hd 512 runs its band
    layers through kernels 1-2 under "auto", forward and backward, and
    matches the plain path."""
    cfg = ModelConfig(seqemb_dim=16, d_model=32, nhead=4, ff=64, nlayers=1,
                      z_global=16, z_local=8, decoder_hidden=hidden,
                      decoder_layers=2, max_neighbors=8)
    torch.manual_seed(0)
    model = HierCVAE(cfg).to(cuda).eval()
    plain = HierCVAE(dataclasses.replace(cfg, use_pallas_egnn=False)).to(cuda).eval()
    plain.load_state_dict(model.state_dict())
    g = torch.Generator().manual_seed(4)
    B, L = 2, 64
    mask = torch.ones(B, L)
    mask[0, 50:] = 0.0
    z_g = torch.randn(B, cfg.z_global, generator=g).to(cuda)
    z_l = torch.randn(B, L, cfg.z_local, generator=g).to(cuda)
    before = dict(LAUNCHES)
    outs = []
    for m in (model, plain):
        out = m.decode(z_g, z_l, mask.to(cuda))
        (out[0].square().sum() + out[1].square().sum()).backward()
        outs.append((out, {n: p.grad for n, p in m.named_parameters()}))
    assert LAUNCHES["egnn_band_fwd"] == before["egnn_band_fwd"] + cfg.decoder_layers
    assert LAUNCHES["egnn_band_bwd"] == before["egnn_band_bwd"] + cfg.decoder_layers
    (got, kg), (want, pg) = outs
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    for n, w in pg.items():
        if w is not None:
            _close_scaled(kg[n], w, n)


def test_decoder_kernel_path_matches_plain_path(cuda):
    cfg = ModelConfig(seqemb_dim=16, d_model=64, nhead=4, ff=128, nlayers=1,
                      z_global=32, z_local=16, decoder_hidden=64,
                      decoder_layers=3, max_neighbors=8)
    torch.manual_seed(0)
    model = HierCVAE(cfg).to(cuda).eval()
    plain = HierCVAE(dataclasses.replace(cfg, use_pallas_egnn=False))
    plain.load_state_dict(model.state_dict())
    plain = plain.to(cuda).eval()
    g = torch.Generator().manual_seed(3)
    B, L = 3, 96
    mask = torch.ones(B, L)
    mask[0, 70:] = 0.0
    mask[2, [5, 6, 40]] = 0.0
    z_g = torch.randn(B, cfg.z_global, generator=g)
    z_l = torch.randn(B, L, cfg.z_local, generator=g)
    before = LAUNCHES["egnn_band_fwd"]
    with torch.no_grad():
        got = model.decode(z_g.to(cuda), z_l.to(cuda), mask.to(cuda))
        want = plain.decode(z_g.to(cuda), z_l.to(cuda), mask.to(cuda))
    assert LAUNCHES["egnn_band_fwd"] == before + cfg.decoder_layers
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


# Gradients: sums over up to ~1e5 edges in another order, so the absolute
# tolerance scales with each output's magnitude (as in chip_smoke.py).
G_RTOL, G_ATOL_REL = 2e-3, 1e-4


def _close_scaled(got, want, name):
    atol = G_ATOL_REL * float(want.abs().max()) + 1e-30
    torch.testing.assert_close(got, want, rtol=G_RTOL, atol=atol, msg=name)


@pytest.mark.parametrize("B,L,Hd,W", [
    (2, 37, 32, 4), (3, 70, 64, 4), (1, 50, 128, 8), (2, 19, 64, 12),
    (2, 256, 256, 40), (1, 129, 256, 40),
])
def test_band_backward_matches_plain_version(cuda, B, L, Hd, W):
    args = _inputs(B, L, Hd, cuda, seed=B * 1000 + L + 1)
    g = torch.Generator(device="cpu").manual_seed(L)
    g_agg = torch.randn(B, L, Hd, generator=g).to(cuda)
    g_delta = torch.randn(B, L, 3, generator=g).to(cuda)
    before = LAUNCHES["egnn_band_bwd"]
    got = egnn_band_bwd(*args, g_agg, g_delta, W)
    torch.cuda.synchronize()
    assert LAUNCHES["egnn_band_bwd"] == before + 1
    want = egnn_band_bwd_reference(*args, g_agg, g_delta, W)
    names = ("a", "bs", "x", "w_d", "w_e2", "b_e2", "w_x1", "b_x1", "w_x2", "b_x2")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        _close_scaled(a, b, name)
    # deterministic: a second launch is bitwise identical
    again = egnn_band_bwd(*args, g_agg, g_delta, W)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


_GRAD_NAMES = ("a", "bs", "x", "w_d", "w_e2", "b_e2", "w_x1", "b_x1", "w_x2", "b_x2")


def _check_fwd_bwd(args, W, seed):
    """Kernels 1 and 2 against their plain versions on ``args``; returns the
    kernel outputs (agg, raw_delta, the ten gradients)."""
    B, L, Hd = args[0].shape
    agg, delta = egnn_band_fwd(*args, W)
    ragg, rdelta = egnn_band_reference(*args, W)
    torch.testing.assert_close(agg, ragg, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(delta, rdelta, rtol=RTOL, atol=ATOL)
    g = torch.Generator(device="cpu").manual_seed(seed)
    g_agg = torch.randn(B, L, Hd, generator=g).to(args[0].device)
    g_delta = torch.randn(B, L, 3, generator=g).to(args[0].device)
    got = egnn_band_bwd(*args, g_agg, g_delta, W)
    want = egnn_band_bwd_reference(*args, g_agg, g_delta, W)
    for name, a, b in zip(_GRAD_NAMES, got, want):
        assert torch.isfinite(a).all(), name
        _close_scaled(a, b, name)
    return (agg, delta) + tuple(got)


def test_fwd_offset_split_at_b1_l256(cuda):
    """B1/L256 has 32 (batch row, tile) blocks: the wrapper splits the band
    offsets so that kernel 1 launches >= 128 blocks, and the summed slices
    match the plain version and repeat bitwise."""
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import band_work, fwd_plan

    B, L, Hd, W = 1, 256, 256, 40
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    S = fwd_plan(B, L, W, Hd, cuda)
    assert S > 1 and B * band_work(B, L, W)[0] * S >= min(128, n_sm)
    args = _inputs(B, L, Hd, cuda, seed=11)
    agg, delta = egnn_band_fwd(*args, W)
    ragg, rdelta = egnn_band_reference(*args, W)
    torch.testing.assert_close(agg, ragg, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(delta, rdelta, rtol=RTOL, atol=ATOL)
    again = egnn_band_fwd(*args, W)
    assert torch.equal(agg, again[0]) and torch.equal(delta, again[1])


@pytest.mark.parametrize("case", ["all_masked_sample", "padding_tile"])
def test_masked_steps_are_skipped_exactly(cuda, case):
    """Steps with no valid edge are skipped by both kernels: a wholly masked
    sample, and a tile of 8 receivers that is all padding (as in a length
    bucket), still match the plain versions, and their rows are exact
    zeros."""
    B, L, Hd, W = 2, 96, 256, 40
    args = _inputs(B, L, Hd, cuda, seed=21)
    cmask = args[3]
    if case == "all_masked_sample":
        cmask[1] = 0.0
        rows = (1, slice(None))
    else:
        cmask[:, 40:48] = 0.0
        rows = (slice(None), slice(40, 48))
    agg, delta, da, dbs, dx, *_ = _check_fwd_bwd(args, W, seed=5)
    for t in (agg, delta, da, dbs, dx):
        assert float(t[rows].abs().max()) == 0.0


@pytest.mark.parametrize("W", [4, 12, 40])
@pytest.mark.parametrize("Hd", [32, 64, 128, 256, 8, 16, 48, 96, 384, 512])
def test_odd_length_every_width(cuda, Hd, W):
    """L = 37 (not a multiple of the 8-receiver tile) at every native
    hidden width, at padded ones (8, 16, 48, 96, 384) and band half-widths
    4-40."""
    args = _inputs(2, 37, Hd, cuda, seed=Hd + W)
    _check_fwd_bwd(args, W, seed=Hd * W)


@pytest.mark.parametrize("B,L", [(1, 256), (4, 256), (2, 640)])
def test_two_launches_are_bitwise_identical(cuda, B, L):
    """Kernels 1 and 2 sum across blocks in a fixed order (offset slices,
    persistent-grid partials, weight-grad slices): repeated launches give
    bitwise-identical outputs."""
    args = _inputs(B, L, 256, cuda, seed=B + L)
    g = torch.Generator(device="cpu").manual_seed(L)
    g_agg = torch.randn(B, L, 256, generator=g).to(cuda)
    g_delta = torch.randn(B, L, 3, generator=g).to(cuda)
    first = egnn_band_fwd(*args, 40) + egnn_band_bwd(*args, g_agg, g_delta, 40)
    second = egnn_band_fwd(*args, 40) + egnn_band_bwd(*args, g_agg, g_delta, 40)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("Hd", [512, 384])
@pytest.mark.parametrize("B,L", [(1, 256), (4, 256)])
def test_two_launches_are_bitwise_identical_at_wide_widths(cuda, B, L, Hd):
    """As above at Hd 512 (one 512-thread block per SM) and at Hd 384
    (zero-padded to 512), where the kernels also match the plain versions
    at chip_smoke.py's tolerances: the forward at rtol 1e-4 / atol 1e-4 x
    max|plain| (raw_delta sums 80 edges of ~10 A offsets, so at full width
    an absolute 1e-4 is ~2e-6 of its scale), the gradients as above."""
    args = _inputs(B, L, Hd, cuda, seed=B + L + Hd)
    g = torch.Generator(device="cpu").manual_seed(L)
    g_agg = torch.randn(B, L, Hd, generator=g).to(cuda)
    g_delta = torch.randn(B, L, 3, generator=g).to(cuda)
    first = egnn_band_fwd(*args, 40) + egnn_band_bwd(*args, g_agg, g_delta, 40)
    second = egnn_band_fwd(*args, 40) + egnn_band_bwd(*args, g_agg, g_delta, 40)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    want = egnn_band_reference(*args, 40)
    for got, ref in zip(first[:2], want):
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL * float(ref.abs().max()))
    want = egnn_band_bwd_reference(*args, g_agg, g_delta, 40)
    for name, got, ref in zip(_GRAD_NAMES, first[2:], want):
        assert got.shape == ref.shape, name
        _close_scaled(got, ref, name)


def _f64_dist(got, want):
    """max |got - want| / (1e-5 max|want| + 1e-3 |want|): 1 is the model's
    gradient tolerance (chip_smoke.py: _f64_dist)."""
    want = want.double()
    atol = max(1e-5 * float(want.abs().max()), 1e-6)
    return float(((got.double() - want).abs() / (atol + 1e-3 * want.abs())).max())


@pytest.mark.parametrize("Hd", [512, 384, 256])
def test_weight_grads_hold_float64_at_full_width(cuda, Hd):
    """Kernel 2's weight grads sum ~82,000 edge rows at B4/L256: at Hd 512
    (and 384, padded to it) its weight-grad pass takes 9 slices, ~9,000 rows
    an accumulator, and summed them in the tensor cores' truncating fp32
    until each k8 step was rounded to nearest (WGRAD_STEP_SUM), which put
    dW_e2 at 2-5x the model's gradient tolerance from float64 where the
    fp32 plain version lies at ~0.2x. Every gradient must lie no farther
    from the float64 band function than 2x the fp32 plain version, or
    within the tolerance."""
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import band_chain, band_indices

    B, L, W = 4, 256, 40
    args = _inputs(B, L, Hd, cuda, seed=Hd + 3)
    g = torch.Generator(device="cpu").manual_seed(Hd)
    g_agg = torch.randn(B, L, Hd, generator=g).to(cuda)
    g_delta = torch.randn(B, L, 3, generator=g).to(cuda)
    got = egnn_band_bwd(*args, g_agg, g_delta, W)
    plain = egnn_band_bwd_reference(*args, g_agg, g_delta, W)
    idx, in_range = band_indices(L, W, cuda)
    cm = args[3] > 0.5
    valid = in_range[None] & cm[:, :, None] & cm[:, idx]
    diff = [t.double().requires_grad_(True) for t in args[:3] + args[4:]]
    outs = band_chain(diff[0], diff[1], diff[2], idx, valid, *diff[3:], torch.float64)
    exact = torch.autograd.grad(outs, diff, (g_agg.double(), g_delta.double()))
    for name, k, p, r in zip(_GRAD_NAMES, got, plain, exact):
        dk, dp = _f64_dist(k, r), _f64_dist(p, r)
        assert dk <= max(2 * dp, 1.0), f"{name}: kernel {dk:.2f}, plain {dp:.2f}"


# The bf16-model mode of kernels 1-2 (bf16 a / bs, one-pass TF32 products)
# against the plain version (fp32 chain in full fp32) on the same
# bf16-rounded inputs, at the JAX package's bf16 tolerances
# (tests/test_pallas.py:test_egnn_fused_bf16_chain): 3 % of max |value| for
# the forward, 5 % of max |grad| for the backward.
BF16_VALUE_FRAC, BF16_GRAD_FRAC = 0.03, 0.05


def _bf16_args(args):
    return [args[0].bfloat16().contiguous(), args[1].bfloat16().contiguous()] + args[2:]


def _within_frac(got, want, frac, name):
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert torch.isfinite(got.float()).all() and err <= frac * scale, (
        f"{name}: max abs err {err:.3e} > {frac} x {scale:.3e}")


@pytest.mark.parametrize("B,L,Hd,W", [
    (2, 37, 32, 4), (3, 70, 64, 12), (2, 256, 256, 40), (1, 640, 256, 40),
    (2, 37, 48, 4), (2, 256, 512, 40),
])
def test_bf16_mode_matches_plain_version(cuda, B, L, Hd, W):
    from protein_ensemble_vae_torch.ops.kernels import BAND_MODE_LAUNCHES

    args = _bf16_args(_inputs(B, L, Hd, cuda, seed=B * 100 + L))
    before = dict(BAND_MODE_LAUNCHES)
    agg, delta = egnn_band_fwd(*args, W, "default")
    assert agg.dtype == delta.dtype == torch.float32
    for name, got, want in zip(("agg", "raw_delta"), (agg, delta),
                               egnn_band_reference(*args, W)):
        _within_frac(got, want, BF16_VALUE_FRAC, name)
    g = torch.Generator(device="cpu").manual_seed(L)
    g_agg = torch.randn(B, L, Hd, generator=g).to(cuda)
    g_delta = torch.randn(B, L, 3, generator=g).to(cuda)
    got = egnn_band_bwd(*args, g_agg, g_delta, W, "default")
    want = egnn_band_bwd_reference(*args, g_agg, g_delta, W)
    for name, a, b in zip(_GRAD_NAMES, got, want):
        assert a.dtype == b.dtype == (torch.bfloat16 if name in ("a", "bs") else torch.float32)
        _within_frac(a, b, BF16_GRAD_FRAC, name)
    for k in ("egnn_band_fwd", "egnn_band_bwd"):
        key = f"{k}:bfloat16/default"
        assert BAND_MODE_LAUNCHES.get(key, 0) == before.get(key, 0) + 1


def test_bf16_unaligned_inputs_raise(cuda):
    """A bf16 a / bs that is not 16-byte aligned (here 2 bytes off) is
    refused, not copied to an aligned buffer behind the caller's back;
    so are mixed dtypes of a and bs."""
    B, L, Hd, W = 2, 64, 32, 4
    args = _bf16_args(_inputs(B, L, Hd, cuda, seed=7))
    buf = torch.empty(B * L * Hd + 1, dtype=torch.bfloat16, device=cuda)
    shifted = buf[1:].view(B, L, Hd)
    shifted.copy_(args[0])
    g_agg = torch.zeros(B, L, Hd, device=cuda)
    g_delta = torch.zeros(B, L, 3, device=cuda)
    before = dict(LAUNCHES)
    for pos in (0, 1):
        bad = list(args)
        bad[pos] = shifted
        with pytest.raises(ValueError, match="16-byte aligned"):
            egnn_band_fwd(*bad, W, "default")
        with pytest.raises(ValueError, match="16-byte aligned"):
            egnn_band_bwd(*bad, g_agg, g_delta, W, "default")
    mixed = list(args)
    mixed[1] = args[1].float()
    with pytest.raises(ValueError, match="share a dtype"):
        egnn_band_fwd(*mixed, W, "default")
    assert LAUNCHES == before


@pytest.mark.parametrize("B,L", [(1, 256), (4, 256), (2, 640)])
def test_bf16_mode_two_launches_are_bitwise_identical(cuda, B, L):
    args = _bf16_args(_inputs(B, L, 256, cuda, seed=B + L + 3))
    g = torch.Generator(device="cpu").manual_seed(L + 1)
    g_agg = torch.randn(B, L, 256, generator=g).to(cuda)
    g_delta = torch.randn(B, L, 3, generator=g).to(cuda)

    def run():
        return (egnn_band_fwd(*args, 40, "default")
                + egnn_band_bwd(*args, g_agg, g_delta, 40, "default"))

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


def test_bf16_kernel_runs_in_a_remat_layer(cuda):
    """A bf16 decoder with ``decoder_remat``: each EGNN layer runs kernel 1
    twice (forward, and again in the backward's recompute) and kernel 2
    once, all in the bf16 mode; its gradients equal the same decoder's
    without remat."""
    from protein_ensemble_vae_torch.models.decoder import EGNNDecoder
    from protein_ensemble_vae_torch.ops.kernels import BAND_MODE_LAUNCHES, reset_launches

    kw = dict(z_g=32, z_l=16, hidden=64, num_layers=3, max_neighbors=8, dropout=0.0,
              use_pallas="auto", dtype=torch.bfloat16)
    torch.manual_seed(0)
    remat = EGNNDecoder(**kw, remat=True).to(cuda)
    flat = EGNNDecoder(**kw, remat=False).to(cuda)
    flat.load_state_dict(remat.state_dict())
    g = torch.Generator().manual_seed(5)
    B, L = 2, 96
    mask = torch.ones(B, L)
    mask[0, 80:] = 0.0
    z_g = torch.randn(B, 32, generator=g).to(cuda)
    z_l = torch.randn(B, L, 16, generator=g).to(cuda)
    grads = {}
    for name, dec in (("remat", remat), ("flat", flat)):
        reset_launches()
        n, ca, c, seq = dec.train()(z_g, z_l, mask.to(cuda))
        (n.square().sum() + ca.square().sum() + c.square().sum() + seq.square().sum()).backward()
        torch.cuda.synchronize()
        per_layer = 2 if name == "remat" else 1
        assert BAND_MODE_LAUNCHES == {"egnn_band_fwd:bfloat16/default": per_layer * 3,
                                      "egnn_band_bwd:bfloat16/default": 3}, name
        grads[name] = {k: p.grad for k, p in dec.named_parameters()}
    for k, a in grads["remat"].items():
        assert a is not None and torch.isfinite(a).all(), k
        torch.testing.assert_close(a, grads["flat"][k], msg=k)


# The bf16 chain (chain_dtype=bfloat16: bf16 activations and cotangents,
# bf16 tensor-core products, fp32 sums) against its plain version, which
# rounds where the JAX kernel rounds, on the same inputs: the kernel's sums
# inside a product run in another order before their bf16 rounding, so a
# value can land one bf16 step away. Values are held at CHAIN_VALUE_FRAC of
# max |plain| (the card read at most 2.0e-4 at full width, the two chains lie
# 2.5e-3 apart on agg; chip_smoke.py), gradients at the JAX package's 5 %
# (tests/test_pallas.py:test_egnn_fused_bf16_chain), and all outputs must lie
# closer to the plain bf16 chain than to the one-pass fp32-chain kernel.
CHAIN = torch.bfloat16
CHAIN_VALUE_FRAC = 1e-3


def _worst_rel(got, want):
    return max(float((a.float() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1e-30) for a, b in zip(got, want))


def _check_chain(args, W, seed):
    """Kernels 1 and 2 in the bf16 chain against the plain version: values
    within CHAIN_VALUE_FRAC, gradients within 5 % of max |plain|, all
    outputs closer to it than to the one-pass fp32-chain kernel, da / dbs
    in the input dtype, one launch each counted under the mode's key;
    returns the outputs (agg, raw_delta, the ten gradients)."""
    from protein_ensemble_vae_torch.ops.kernels import BAND_MODE_LAUNCHES
    from protein_ensemble_vae_torch.ops.kernels.egnn_band import mode_key

    B, L, Hd = args[0].shape
    keys = [mode_key(k, args[0].dtype, "default", CHAIN)
            for k in ("egnn_band_fwd", "egnn_band_bwd")]
    before = [BAND_MODE_LAUNCHES.get(k, 0) for k in keys]
    out = egnn_band_fwd(*args, W, "default", CHAIN)
    assert out[0].dtype == out[1].dtype == torch.float32
    ref = egnn_band_reference(*args, W, CHAIN)
    for name, got, want in zip(("agg", "raw_delta"), out, ref):
        _within_frac(got, want, CHAIN_VALUE_FRAC, name)
    g = torch.Generator(device="cpu").manual_seed(seed)
    g_agg = torch.randn(B, L, Hd, generator=g).to(args[0].device)
    g_delta = torch.randn(B, L, 3, generator=g).to(args[0].device)
    got = egnn_band_bwd(*args, g_agg, g_delta, W, "default", CHAIN)
    want = egnn_band_bwd_reference(*args, g_agg, g_delta, W, CHAIN)
    for name, a, b in zip(_GRAD_NAMES, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert a.dtype == (args[0].dtype if name in ("a", "bs") else torch.float32), name
        _within_frac(a, b, BF16_GRAD_FRAC, name)
    assert [BAND_MODE_LAUNCHES.get(k, 0) for k in keys] == [n + 1 for n in before]
    fp32_chain = (egnn_band_fwd(*args, W, "default")
                  + egnn_band_bwd(*args, g_agg, g_delta, W, "default"))
    for n, (mine, plain) in enumerate(((out, ref), (got, want))):
        other = fp32_chain[:2] if n == 0 else fp32_chain[2:]
        assert _worst_rel(mine, plain) < _worst_rel(mine, other), (
            "closer to the fp32 chain than to the plain bf16 chain")
    return out + tuple(got)


@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Hd", [32, 64, 128, 256, 8, 16, 48, 96, 384, 512])
def test_chain_bf16_matches_plain_version(cuda, Hd, in_dtype):
    """Every native width and padded ones at an odd length (L = 37, not a
    multiple of the 8-receiver tile), bf16 and fp32 inputs a / bs."""
    args = _inputs(2, 37, Hd, cuda, seed=Hd + 7)
    if in_dtype == torch.bfloat16:
        args = _bf16_args(args)
    _check_chain(args, 12, seed=Hd)


@pytest.mark.parametrize("B,L", [(2, 256), (1, 640)])
def test_chain_bf16_full_width(cuda, B, L):
    _check_chain(_bf16_args(_inputs(B, L, 256, cuda, seed=B + L + 9)), 40, seed=L)


def test_chain_bf16_fp32_inputs_round_as_bf16_inputs(cuda):
    """fp32 a / bs in the bf16 chain are rounded to bf16 first: the result
    equals the kernels' on the bf16-rounded inputs (da / dbs compared after
    rounding to bf16) up to the order of the fp32 sums across blocks, which
    follows each instantiation's occupancy (offset slices, edge-pass grid)."""
    args = _inputs(2, 96, 256, cuda, seed=13)
    args16 = _bf16_args(args)
    g = torch.Generator(device="cpu").manual_seed(2)
    g_agg = torch.randn(2, 96, 256, generator=g).to(cuda)
    g_delta = torch.randn(2, 96, 3, generator=g).to(cuda)
    outs = [egnn_band_fwd(*t, 40, "default", CHAIN)
            + egnn_band_bwd(*t, g_agg, g_delta, 40, "default", CHAIN) for t in (args, args16)]
    for k, (a, b) in enumerate(zip(*outs)):
        # da / dbs (outputs 2, 3) in bf16 may round one bf16 step apart
        rtol = 2.0 ** -7 if k in (2, 3) else 1e-5
        torch.testing.assert_close(a.to(b.dtype).float(), b.float(), rtol=rtol,
                                   atol=1e-6 * float(b.float().abs().max()))


@pytest.mark.parametrize("B,L", [(4, 256), (2, 640)])
def test_chain_bf16_two_launches_are_bitwise_identical(cuda, B, L):
    args = _bf16_args(_inputs(B, L, 256, cuda, seed=B + L + 5))
    g = torch.Generator(device="cpu").manual_seed(L + 2)
    g_agg = torch.randn(B, L, 256, generator=g).to(cuda)
    g_delta = torch.randn(B, L, 3, generator=g).to(cuda)

    def run():
        return (egnn_band_fwd(*args, 40, "default", CHAIN)
                + egnn_band_bwd(*args, g_agg, g_delta, 40, "default", CHAIN))

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


def test_chain_bf16_never_runs_the_plain_version_on_cuda(cuda, monkeypatch):
    """A CUDA call in the bf16 chain launches its kernel (one count per
    call) and never falls back: with the plain versions made to raise,
    EGNNBandFunction's forward and backward still run."""
    from protein_ensemble_vae_torch.ops.kernels import egnn_band

    def refuse(*_, **__):
        raise AssertionError("plain version called on CUDA tensors")

    for name in ("egnn_band_reference", "egnn_band_bwd_reference", "_bf16_chain_edges",
                 "_bf16_chain_backward"):
        monkeypatch.setattr(egnn_band, name, refuse)
    args = _bf16_args(_inputs(2, 64, 64, cuda, seed=3))
    diff = [t.clone().requires_grad_(True) for t in args[:3] + args[4:]]
    before = dict(LAUNCHES)
    agg, delta = egnn_band_fused(diff[0], diff[1], diff[2], args[3], *diff[3:], 8,
                                 "default", CHAIN)
    (agg.square().sum() + delta.square().sum()).backward()
    torch.cuda.synchronize()
    assert LAUNCHES["egnn_band_fwd"] == before["egnn_band_fwd"] + 1
    assert LAUNCHES["egnn_band_bwd"] == before["egnn_band_bwd"] + 1
    assert all(t.grad is not None for t in diff)


def test_chain_bf16_function_gradients_on_cuda(cuda):
    """EGNNBandFunction in the bf16 chain (kernel forward and backward)
    against the plain route's gradients (``_BF16ChainPlain``) within 5 %
    of max |plain|."""
    args = _inputs(2, 96, 128, cuda, seed=8)
    grads = {}
    for mode in ("auto", False):
        diff = [t.clone().requires_grad_(True) for t in args[:3] + args[4:]]
        agg, delta = egnn_band_fused(diff[0], diff[1], diff[2], args[3], *diff[3:], 12,
                                     "highest", CHAIN, use_pallas=mode)
        (agg.square().sum() + delta.square().sum()).backward()
        grads[mode] = [t.grad for t in diff]
    for name, a, b in zip(_GRAD_NAMES, grads["auto"], grads[False]):
        _within_frac(a, b, BF16_GRAD_FRAC, name)


def test_band_function_gradients_on_cuda(cuda):
    """egnn_band_fused on CUDA tensors backpropagates through the kernels
    (the forward used to return tensors with no grad_fn)."""
    args = _inputs(2, 64, 32, cuda, seed=4)
    diff = [t.clone().requires_grad_(True) for t in args[:3] + args[4:]]
    plain = [t.clone().requires_grad_(True) for t in args[:3] + args[4:]]
    cm = args[3]

    def run(ts, mode):
        a, bs, x, *p = ts
        agg, delta = egnn_band_fused(a, bs, x, cm, *p, 4, "highest", use_pallas=mode)
        assert agg.requires_grad and delta.requires_grad
        return (agg.square().sum() + delta.square().sum())

    before = LAUNCHES["egnn_band_bwd"]
    run(diff, "auto").backward()
    assert LAUNCHES["egnn_band_bwd"] == before + 1
    run(plain, False).backward()
    for a, b in zip(diff, plain):
        assert a.grad is not None
        _close_scaled(a.grad, b.grad, "grad")


def _clash_inputs(B, L, device, seed=0, scale=1.2):
    g = torch.Generator().manual_seed(seed)
    n, ca, c = (torch.randn(B, L, 3, generator=g) * scale * L ** (1 / 3)
                for _ in range(3))
    mask = torch.ones(B, L)
    mask[0, L - L // 6:] = 0.0
    mask[-1, L // 2] = 0.0
    return [t.to(device) for t in (n, ca, c, mask)]


def _clash_fold(B, L, device, seed=0):
    """B NeRF conformers of one fold squeezed by 10 % (some pairs clash),
    a masked tail on row 0 and a hole on the last row."""
    from protein_ensemble_vae_torch.data.synthetic import nerf_ensemble

    n, ca, c = (torch.from_numpy(0.9 * v) for v in nerf_ensemble(L, B, seed=seed))
    mask = torch.ones(B, L)
    mask[0, L - L // 8:] = 0.0
    mask[-1, L // 2] = 0.0
    return [t.float().to(device) for t in (n, ca, c, mask)]


def _check_clash(n, ca, c, mask):
    """Kernels 3-4 against their plain versions on one input: loss and
    totals rtol 1e-3 / atol 1e-6, counts exactly ``pair_count``, gradients
    by ``_close_scaled``, one launch each way, both bitwise repeatable.
    Returns (loss, totals, counts, dn, dca, dc)."""
    from protein_ensemble_vae_torch.ops.kernels.clash import pair_count

    B, L = mask.shape
    before = (LAUNCHES["clash_fwd"], LAUNCHES["clash_bwd"])
    loss, tot, counts = clash_fwd(n, ca, c, mask)
    atoms, amask = backbone_atoms(n, ca, c, mask)
    ref = clash_fwd_reference(atoms, amask)
    assert torch.equal(counts, pair_count(mask))
    torch.testing.assert_close(tot, ref, rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(loss, torch.mean(ref / (counts + 1e-8)), rtol=1e-3, atol=1e-6)
    g = torch.tensor(0.6, device=mask.device)
    grads = clash_bwd(n, ca, c, mask, g, counts)
    scale = g / (B * (counts + 1e-8))
    want = clash_bwd_reference(atoms, amask, scale).reshape(B, L, 3, 3)
    for k, d in enumerate(grads):
        assert d.shape == (B, L, 3) and torch.isfinite(d).all()
        _close_scaled(d, want[:, :, k], f"clash grad {k}")
    assert (LAUNCHES["clash_fwd"], LAUNCHES["clash_bwd"]) == (before[0] + 1, before[1] + 1)
    again = clash_fwd(n, ca, c, mask) + clash_bwd(n, ca, c, mask, g, counts)
    for a, b in zip((loss, tot, counts) + tuple(grads), again):
        assert torch.equal(a, b)
    return (loss, tot, counts) + tuple(grads)


@pytest.mark.parametrize("B,L", [(1, 37), (2, 64), (4, 230), (2, 640), (10, 256), (10, 640)])
def test_clash_kernels_match_plain_versions(cuda, B, L):
    """A dense random cloud (nearly every group pair kept) with a masked
    tail and, from B = 2, an all-masked sample (its total, count and
    gradient are exact zeros)."""
    n, ca, c, mask = _clash_inputs(B, L, cuda, seed=L)
    if B >= 2:
        mask[1] = 0.0
    loss, tot, counts, *grads = _check_clash(n, ca, c, mask)
    valid = mask.sum(1) > 0
    assert float(tot[valid].min()) > 0          # the inputs do clash
    if B >= 2:
        assert float(tot[1]) == 0.0 and float(counts[1]) == 0.0
        assert all(float(d[1].abs().max()) == 0.0 for d in grads)


@pytest.mark.parametrize("B,L", [(4, 256), (2, 640), (10, 256), (10, 640)])
def test_clash_kernels_on_folds(cuda, B, L):
    """NeRF folds, where most group pairs are culled: still the plain
    versions' values and gradients."""
    n, ca, c, mask = _clash_fold(B, L, cuda, seed=L)
    tot = _check_clash(n, ca, c, mask)[1]
    assert float(tot.min()) > 0


def test_clash_tickets_reset_across_shapes(cuda):
    """Launches of other shapes in between leave the launch counters at
    zero: each launch's last block sums, so results repeat bitwise."""
    inputs = [_clash_inputs(B, L, cuda, seed=B + L) for B, L in ((3, 100), (1, 37), (5, 300))]
    first = [clash_fwd(*x) for x in inputs]
    for _ in range(3):
        for x, want in zip(inputs, first):
            got = clash_fwd(*x)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            clash_bwd(*x, torch.tensor(1.0, device=cuda), want[2])


def test_clash_strided_inputs_and_checks(cuda):
    """n, ca, c as slices of one [B, L, 3, 3] tensor (shared strides) and a
    transposed mask give the contiguous inputs' results bitwise; a wrong
    dtype, shape or set of strides raises."""
    n, ca, c, mask = _clash_inputs(2, 90, cuda, seed=7)
    both = torch.stack([n, ca, c], dim=2)
    views = both.unbind(2)
    mask_t = mask.t().contiguous().t()
    want = clash_fwd(n, ca, c, mask)
    got = clash_fwd(*views, mask_t)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    g = torch.tensor(1.0, device=cuda)
    for a, b in zip(clash_bwd(*views, mask_t, g, want[2]), clash_bwd(n, ca, c, mask, g, want[2])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="float32"):
        clash_fwd(n.double(), ca, c, mask)
    with pytest.raises(ValueError, match="shape"):
        clash_fwd(n[:, :50], ca, c, mask)
    with pytest.raises(ValueError, match="strides"):
        clash_fwd(views[0], ca, c, mask)


def test_clash_term_issues_one_kernel_each_way(cuda):
    """One clash_loss_kernel forward and backward (upstream gradient given)
    put exactly one kernel 3 and one kernel 4 on the device and nothing
    else, by torch.profiler's records, and one wrapper launch each way. A
    profiled call whose records lack a clash kernel is profiled again, up
    to three calls; another kernel or a second clash kernel fails."""
    from torch.profiler import ProfilerActivity, profile

    n, ca, c, mask = _clash_fold(4, 230, cuda)
    xs = [t.requires_grad_(True) for t in (n, ca, c)]
    g = torch.ones((), device=cuda)
    torch.autograd.grad(clash_loss_kernel(*xs, mask), xs, g)
    torch.cuda.synchronize()
    kinds = ("clash_fwd", "clash_bwd")
    for _ in range(3):
        before = (LAUNCHES["clash_fwd"], LAUNCHES["clash_bwd"])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(clash_loss_kernel(*xs, mask), xs, g)
            torch.cuda.synchronize()
        assert (LAUNCHES["clash_fwd"], LAUNCHES["clash_bwd"]) == (before[0] + 1, before[1] + 1)
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = [sum(f"{k}_kernel" in name for name in names) for k in kinds]
        others = [k for k in names if not any(f"{kind}_kernel" in k for kind in kinds)]
        assert others == [] and max(seen) <= 1, names
        if seen == [1, 1]:
            return
    pytest.fail(f"the profiler did not record both clash kernels in 3 calls: {names}")


def test_clash_nan_coordinate_propagates(cuda):
    """A NaN coordinate of a valid atom reaches its sample's total, the
    loss and that atom's gradient, as in the plain version; the other
    samples keep the plain version's values and gradients."""
    n, ca, c, mask = _clash_fold(3, 230, cuda, seed=3)
    ca[0, 100, 1] = float("nan")
    loss, tot, counts = clash_fwd(n, ca, c, mask)
    atoms, amask = backbone_atoms(n, ca, c, mask)
    ref = clash_fwd_reference(atoms, amask)
    assert torch.isnan(loss) and torch.isnan(tot[0]) and torch.isnan(ref[0])
    torch.testing.assert_close(tot[1:], ref[1:], rtol=1e-3, atol=1e-6)
    g = torch.tensor(1.0, device=cuda)
    scale = g / (3 * (counts + 1e-8))
    want = clash_bwd_reference(atoms, amask, scale).reshape(3, 230, 3, 3)
    grads = clash_bwd(n, ca, c, mask, g, counts)
    assert torch.isnan(grads[1][0, 100]).all() and torch.isnan(want[0, 100, 1]).all()
    for k, d in enumerate(grads):
        _close_scaled(d[1:], want[1:, :, k], f"clash grad {k}")


def test_clash_function_gradients_on_cuda(cuda):
    from protein_ensemble_vae_torch.losses import clash_loss

    n, ca, c, mask = _clash_inputs(2, 50, cuda, seed=2)
    k = [t.clone().requires_grad_(True) for t in (n, ca, c)]
    d = [t.clone().requires_grad_(True) for t in (n, ca, c)]
    lk = clash_loss_kernel(*k, mask)
    ld = clash_loss(*d, mask)
    torch.testing.assert_close(lk, ld, rtol=1e-3, atol=0.0)
    lk.backward()
    ld.backward()
    for a, b in zip(k, d):
        _close_scaled(a.grad, b.grad, "clash loss grad")


def test_train_step_has_no_host_sync(cuda):
    """A B4/L256 train step at small widths under sync-debug "error": any
    host synchronisation inside the step raises."""
    from protein_ensemble_vae_torch.config import LossWeights
    from protein_ensemble_vae_torch.train.training import (TrainState,
                                                           make_train_step)

    cfg = ModelConfig(seqemb_dim=16, d_model=64, nhead=4, ff=128, nlayers=1,
                      z_global=32, z_local=16, decoder_hidden=64,
                      decoder_layers=2, max_neighbors=8)
    torch.manual_seed(0)
    model = HierCVAE(cfg).to(cuda)
    state = TrainState.create(model)
    step = make_train_step(model, LossWeights(), train=True)
    batch = _train_batch(4, 256, cfg.seqemb_dim, cuda)
    consts = [torch.tensor(v, device=cuda) for v in (0.5, 0.25, 1e-4)]
    step(state, batch, 0, *consts)          # warm-up: kernel builds, handles
    torch.cuda.synchronize()
    before = dict(LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, metrics = step(state, batch, 1, *consts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert LAUNCHES["egnn_band_bwd"] == before["egnn_band_bwd"] + 2
    assert LAUNCHES["clash_bwd"] == before["clash_bwd"] + 1
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def _train_batch(B, L, seqemb_dim, device, seed=0):
    from protein_ensemble_vae_torch.data.synthetic import nerf_ensemble

    n, ca, c = (torch.from_numpy(v[:2]) for v in nerf_ensemble(L - 20, 2, seed=seed))
    g = torch.Generator().manual_seed(seed)

    def conf(k):
        pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 20))  # noqa: E731
        mask = torch.zeros(B, L)
        mask[:, :L - 20] = 1.0
        return dict(n=pad(n[k]).expand(B, L, 3), ca=pad(ca[k]).expand(B, L, 3),
                    c=pad(c[k]).expand(B, L, 3), mask=mask,
                    seq_emb=torch.randn(B, L, seqemb_dim, generator=g),
                    dihedrals=torch.zeros(B, L, 6),
                    seq_labels=torch.randint(0, 20, (B, L), generator=g))

    return {side: {k: v.contiguous().to(device) for k, v in conf(i).items()}
            for i, side in enumerate(("inp", "tgt"))}


# ---------------------------------------------------------------------------
# Refinement: the Adam loops replayed from a CUDA graph, kernels 3-4 inside
# ---------------------------------------------------------------------------

_POLISH_W = dict(anchor_weight=0.003, w_bond=4.0, bond_delta_scale=50.0,
                 w_spacing=1.0, spacing_delta=3.0, w_angle=8.0, w_clash=5.0,
                 w_rama=2.0, w_omega=2.0, w_clash_vdw=400.0)


@pytest.mark.parametrize("B,L", [(2, 64), (10, 256)])
def test_refine_energy_kernel_clash_matches_plain(cuda, B, L):
    """The Cartesian refinement energy with the clash term through kernels
    3-4 against the same energy on the plain clash: energy rtol 1e-3,
    gradient rtol 1e-3 / atol 1e-4 * max|g|."""
    from protein_ensemble_vae_torch.infer import refine as R

    n, ca, c, mask = _clash_fold(B, L, cuda, seed=L)
    ref = dict(zip(R.ATOMS, (n, ca, c)))
    g = torch.Generator().manual_seed(B + L)
    moved = {k: v + 0.1 * torch.randn(v.shape, generator=g).to(cuda) for k, v in ref.items()}
    w = {k: torch.tensor(v, device=cuda) for k, v in _POLISH_W.items()}
    out = []
    for use in ("auto", False):
        xs = {k: v.clone().requires_grad_(True) for k, v in moved.items()}
        before = LAUNCHES["clash_bwd"]
        e = R._energy(xs, ref, mask, w, rama_on=True, vdw_on=True, use_pallas=use)
        out.append((e, torch.autograd.grad(e, [xs[k] for k in R.ATOMS])))
        assert LAUNCHES["clash_bwd"] == before + (1 if use else 0)
    (ek, gk), (ep, gp) = out
    torch.testing.assert_close(ek, ep, rtol=1e-3, atol=0.0)
    for a, b in zip(gk, gp):
        atol = 1e-4 * float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-3, atol=atol)


def test_refine_loops_from_a_graph_match_eager(cuda, monkeypatch):
    """refine_backbone and refine_torsions replayed from a CUDA graph give
    the eager loop's coordinates on the card (1e-4 A), keep padded rows
    bitwise, and count kernels 3-4 once per replayed Cartesian step."""
    import functools

    from protein_ensemble_vae_torch.infer import refine as R
    from protein_ensemble_vae_torch.infer import torsion_refine as T

    n, ca, c, mask = _clash_fold(3, 96, cuda, seed=9)
    x0 = torch.stack((n, ca, c))
    pad = mask == 0
    steps = 12
    R.clear_graphs()
    for refine, kw in ((R.refine_backbone, dict(_POLISH_W, lr=0.05, lr_decay=True)),
                       (T.refine_torsions, dict(lr=0.01, anchor_weight=0.01, w_rama=2.0,
                                                w_omega=1.0, w_clash_vdw=400.0,
                                                vdw_include_o=True))):
        with monkeypatch.context() as m:        # the same loop, eager on the card
            eager = functools.partial(R.adam_descent, graph=False)
            m.setattr(R, "adam_descent", eager)
            m.setattr(T, "adam_descent", eager)
            want = torch.stack(refine(n, ca, c, mask, steps=steps, **kw))
        got = torch.stack(refine(n, ca, c, mask, steps=steps, **kw))       # captures
        before = LAUNCHES["clash_fwd"], LAUNCHES["clash_bwd"]
        again = torch.stack(refine(n, ca, c, mask, steps=steps, **kw))     # replays
        per_step = 1 if refine is R.refine_backbone else 0
        assert (LAUNCHES["clash_fwd"], LAUNCHES["clash_bwd"]) == (
            before[0] + per_step * steps, before[1] + per_step * steps)
        assert torch.isfinite(got).all()
        assert torch.equal(got, again)
        torch.testing.assert_close(got, want, rtol=0.0, atol=1e-4)
        assert torch.equal(got[:, pad], x0[:, pad])
    R.clear_graphs()


def test_refine_step_has_no_host_sync(cuda, monkeypatch):
    """One Adam step of each refinement energy (energy, gradient, update)
    under sync-debug "error": a host synchronisation, which a CUDA graph
    cannot capture, raises."""
    from protein_ensemble_vae_torch.infer import refine as R
    from protein_ensemble_vae_torch.infer import torsion_refine as T

    def one_step(energy, x0, consts, lr, *, steps, lr_decay, key, graph=None):
        x, count = x0.clone(), torch.zeros((), device=x0.device)
        m, v = torch.zeros_like(x), torch.zeros_like(x)
        lr_t = torch.tensor(lr, device=x0.device)
        R._adam_step(energy, x, consts, m, v, count, lr_t, steps, lr_decay)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            R._adam_step(energy, x, consts, m, v, count, lr_t, steps, lr_decay)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return x

    monkeypatch.setattr(R, "adam_descent", one_step)
    monkeypatch.setattr(T, "adam_descent", one_step)
    n, ca, c, mask = _clash_fold(2, 64, cuda, seed=5)
    before = LAUNCHES["clash_fwd"]
    R.refine_backbone(n, ca, c, mask, steps=2, lr_decay=True, **_POLISH_W)
    T.refine_torsions(n, ca, c, mask, steps=2, vdw_include_o=True)
    assert LAUNCHES["clash_fwd"] == before + 2


def _esm2_small(seed=0):
    """A small ESM-2 (4 layers at hidden 320, 20 heads, FFN 1280) with
    HF's seeded initialisation, on the CPU."""
    from protein_ensemble_vae_torch.models.esm2 import ESM2, ESM2Config, init_hf_

    cfg = ESM2Config(hidden=320, num_layers=4, num_heads=20, intermediate=1280)
    return init_hf_(ESM2(cfg), torch.Generator().manual_seed(seed)).eval()


def test_esm2_forward_on_card_matches_cpu(cuda):
    """Ragged batch with a <mask> token: the card's forward (full fp32
    products) against the CPU forward on the same weights, atol 1e-5."""
    from protein_ensemble_vae_torch.models.esm2 import EOS_ID, MASK_ID, PAD_ID

    model = _esm2_small()
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(4, 24, (2, 40), generator=g)
    toks[:, 0] = 0
    toks[0, -1] = EOS_ID
    toks[0, 7] = MASK_ID
    toks[1, 25:] = PAD_ID
    toks[1, 24] = EOS_ID
    amask = toks != PAD_ID
    with torch.no_grad():
        want = model(toks, amask)
        got = model.to(cuda)(toks.to(cuda), amask.to(cuda)).cpu()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[amask], want[amask], rtol=0.0, atol=1e-5)


def test_esm2_embedder_bucket_invariance_on_card(cuda):
    """``ESM2Embedder.embed`` on the card (padded to its 64-token bucket)
    against the unpadded forward on the card, atol 1e-4."""
    from protein_ensemble_vae_torch.models.esm2 import ESM2Embedder, tokenize

    model = _esm2_small(seed=2)
    emb = ESM2Embedder(model.state_dict(), model.config, device="cuda")
    seq = "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQAPILSRVGDGTQDNLSGAEKAVQ"
    reps = emb.embed(seq)
    ids = torch.from_numpy(tokenize(seq)[None].astype("int64")).to(cuda)
    with torch.no_grad():
        direct = emb.model(ids)[0, 1:-1].cpu().numpy()
    assert reps.shape == (len(seq), 320)
    torch.testing.assert_close(torch.from_numpy(reps), torch.from_numpy(direct),
                               rtol=0.0, atol=1e-4)


def test_dataprep_torsions_on_card_match_cpu(cuda):
    """``process_chain``'s torsions computed on the card against the CPU,
    atol 1e-5; every other output is the same host-side numpy."""
    import os

    from protein_ensemble_vae_torch.dataprep import mmcif, pipeline

    cif = os.path.join(os.path.dirname(__file__), "fixtures", "messy_9xyz.cif")
    arrays = mmcif.chain_to_arrays(mmcif.parse_mmcif_backbone(cif)["AA"])
    got = pipeline.process_chain(arrays, device="cuda")
    want = pipeline.process_chain(arrays, device="cpu")
    for k in ("torsion_phi_sincos", "torsion_psi_sincos", "torsion_omega_sincos"):
        torch.testing.assert_close(torch.from_numpy(got[k]), torch.from_numpy(want[k]),
                                   rtol=0.0, atol=1e-5)


def test_dp2_step_on_one_card_launches_kernels_and_matches(cuda, tmp_path):
    """dp = 2 through ``parallel.launch``: with one card both ranks share it
    over gloo (NCCL refuses two ranks on one device); kernels 1-4 launch in
    each rank's step, and the step is the single-process step (loss rtol
    1e-5, updated parameters atol 1e-4)."""
    import numpy as np

    from protein_ensemble_vae_torch.parallel.dryrun import (example_batch,
                                                            parity_step,
                                                            single_step)
    from protein_ensemble_vae_torch.parallel.mesh import launch

    model = dict(seqemb_dim=16, d_model=64, nhead=4, ff=128, nlayers=1,
                 z_global=32, z_local=16, decoder_hidden=64, decoder_layers=2,
                 max_neighbors=8)
    batch = example_batch(16, 4, 64, seed=1)
    batch["tgt"]["mask"][0, 50:] = 0.0
    batch["tgt"]["mask"][3, 7] = 0.0
    spec = dict(model=model, seed=0, rng=5, consts=(0.5, 0.25, 1e-4), dp=2, tp=1,
                device="cuda", batch=batch)
    ref = single_step(spec)
    ranks = launch(parity_step, 2, (spec,), device="cuda", timeout_s=300,
                   store_dir=str(tmp_path))
    want = {"egnn_band_fwd": 2, "egnn_band_bwd": 2, "clash_fwd": 1, "clash_bwd": 1}
    assert ref["launches"] == want
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    for r in ranks:
        assert r["launches"] == want and r["backend"] == backend, r
        assert r["loss"] == ranks[0]["loss"]
    np.testing.assert_allclose(ranks[0]["loss"], ref["loss"], rtol=1e-5)
    for k, v in ref["params"].items():
        np.testing.assert_allclose(ranks[0]["params"][k], v, rtol=0, atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# Grad-watch gradient, debug mode and the build cache on the card
# ---------------------------------------------------------------------------

_WATCH_CFG = dict(seqemb_dim=16, d_model=64, nhead=4, ff=128, nlayers=1, z_global=32,
                  z_local=16, decoder_hidden=64, decoder_layers=2, max_neighbors=8,
                  dropout=0.1)


def test_watch_gradient_kernel_path_matches_plain_path(cuda):
    """``make_param_grad_fn`` (the grad-watch gradient, dropout on) on the
    kernel path and the plain path, same weights and seed, so the same
    dropout masks: 2 + 2 band and 1 + 1 clash launches on the kernel path,
    none on the plain path; on the smooth loss weights every gradient
    within rtol 1e-3 / atol 1e-5 max|g| per tensor."""
    from protein_ensemble_vae_torch.config import LossWeights
    from protein_ensemble_vae_torch.train.training import make_param_grad_fn

    torch.manual_seed(0)
    kmodel = HierCVAE(ModelConfig(**_WATCH_CFG)).to(cuda)
    pmodel = HierCVAE(ModelConfig(**_WATCH_CFG, use_pallas_egnn=False)).to(cuda)
    pmodel.load_state_dict(kmodel.state_dict())
    batch = _train_batch(4, 128, _WATCH_CFG["seqemb_dim"], cuda)
    before = dict(LAUNCHES)
    grads = make_param_grad_fn(kmodel, LossWeights())(batch, 7, 1.0, 0.5)
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == {
        "egnn_band_fwd": 2, "egnn_band_bwd": 2, "clash_fwd": 1, "clash_bwd": 1}
    assert all(torch.isfinite(g).all() for g in grads.values())
    smooth = LossWeights(w_pair=0.0, w_dihedral=0.0, w_rama=0.0, w_bond=0.0,
                         w_angle=0.0, w_clash=0.0)
    got = make_param_grad_fn(kmodel, smooth)(batch, 7, 1.0, 0.5)
    before = dict(LAUNCHES)
    want = make_param_grad_fn(pmodel, smooth)(batch, 7, 1.0, 0.5)
    assert dict(LAUNCHES) == before
    assert all(p.grad is None for p in kmodel.parameters())
    for name, w in want.items():
        atol = max(1e-5 * float(w.abs().max()), 1e-6)
        torch.testing.assert_close(got[name], w, rtol=1e-3, atol=atol, msg=name)


def test_debug_mode_on_the_kernel_path(cuda):
    """Under ``enable_debug_mode`` a kernel-path train step runs silent (its
    kernels write into ``torch.empty`` memory), and NaN coordinates reaching
    the band kernel raise."""
    import numpy as np

    from protein_ensemble_vae_torch.config import LossWeights
    from protein_ensemble_vae_torch.train.training import TrainState, make_train_step
    from protein_ensemble_vae_torch.utils.profiling import (disable_debug_mode,
                                                            enable_debug_mode)

    torch.manual_seed(0)
    model = HierCVAE(ModelConfig(**_WATCH_CFG)).to(cuda)
    state = TrainState.create(model)
    step = make_train_step(model, LossWeights(), train=True)
    batch = _train_batch(2, 128, _WATCH_CFG["seqemb_dim"], cuda)
    consts = [torch.tensor(v, device=cuda) for v in (0.5, 0.25, 1e-4)]
    args = _inputs(2, 64, 64, cuda)
    args[2] = args[2].clone()
    args[2][0, 3, 1] = float(np.nan)
    before = dict(LAUNCHES)
    enable_debug_mode()
    try:
        _, metrics = step(state, batch, 0, *consts)
        with pytest.raises(FloatingPointError):
            egnn_band_fused(*args, 4, "highest")
    finally:
        disable_debug_mode()
    assert LAUNCHES["egnn_band_bwd"] == before["egnn_band_bwd"] + 2
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def test_build_into_a_compile_cache_dir(cuda, monkeypatch, tmp_path):
    """``PEV_COMPILE_CACHE=<dir>`` builds the libraries under
    ``<dir>/<nvcc release>-sm_90a``."""
    from protein_ensemble_vae_torch.ops.kernels import build
    from protein_ensemble_vae_torch.utils.compile_cache import (
        enable_compilation_cache, host_fingerprint)

    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setenv("PEV_COMPILE_CACHE", str(tmp_path))
    where = enable_compilation_cache()
    fp = host_fingerprint()
    assert fp.startswith("nvcc-") and not fp.startswith("nvcc-none") and fp.endswith("sm_90a")
    assert where == str(tmp_path / fp)
    report = build.build(["clash"])
    lib = build.library_path("clash")
    assert report["clash"]["seconds"] > 0 and lib.startswith(where)
    import ctypes
    assert ctypes.CDLL(lib).clash_noop is not None
