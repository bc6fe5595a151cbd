"""Tests of the port that need an NVIDIA GPU (marker ``gpu``): the CUDA
kernels against their plain PyTorch versions, at small and full widths.

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
from protein_ensemble_vae_torch.ops.kernels.egnn_band import (  # noqa: E402
    egnn_band_fused, egnn_band_fwd, egnn_band_reference)
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
        egnn_band_fused(*args, 4, use_pallas=mode)
    assert LAUNCHES["egnn_band_fwd"] == before + 3
    egnn_band_fused(*args, 4, use_pallas=False)
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
    with pytest.raises(ValueError, match="hidden width"):
        egnn_band_fwd(*_inputs(1, 16, 48, cuda), 4)


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
