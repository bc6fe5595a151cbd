"""Every decoder width through the EGNN band kernels, on the CPU.

The CUDA kernels are instantiated at the native widths (``NATIVE_HIDDEN``,
32 to 512), and above 512 their wide variants take every multiple of
``WIDE_GROUP``; for a CUDA tensor of any other width the wrappers zero-pad
to the next of these (``native_width``, ``pad_band_width``), launch, and
slice the results back (``unpad_band_grads`` for the gradients). Here the same padding and
slicing run around the kernels' plain version: the padded function, sliced
back, must be the unpadded one to fp32 rounding, values and gradients, and
at Hd 8, 16 and 48 it must match the JAX package's ``egnn_band_fused``
(Pallas interpret mode) at the JAX package's own tolerances. Then the
train CLI builds and trains a model at the reference CLI's default decoder
width, 512. The kernels at these widths run on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from protein_ensemble_vae_torch.ops.kernels.egnn_band import (  # noqa: E402
    MAX_NATIVE, NATIVE_HIDDEN, WIDE_GROUP, egnn_band_bwd_reference, egnn_band_reference,
    native_width, pad_band_width, unpad_band_grads, wide_fwd_grid)
from protein_ensemble_vae_tpu.ops.pallas.egnn_band import (  # noqa: E402
    egnn_band_fused as jax_egnn_band_fused)

PARAM_ORDER = ("w_d", "w_e2", "b_e2", "w_x1", "b_x1", "w_x2", "b_x2")
DIFF_NAMES = ("a", "bs", "x") + PARAM_ORDER


def _inputs(seed, B=2, L=64, Hd=8):
    """tests/test_torch_egnn_band.py's inputs (a masked tail on row 0)."""
    rng = np.random.default_rng(seed)
    f = lambda s, sd=1.0: rng.normal(0, sd, s).astype(np.float32)  # noqa: E731
    cmask = np.ones((B, L), np.float32)
    cmask[0, -10:] = 0.0
    params = (f((1, Hd), 0.5), f((Hd, Hd), 0.3), f((Hd,), 0.1), f((Hd, Hd), 0.3),
              f((Hd,), 0.1), f((Hd, 1), 0.3), f((1,), 0.1))
    arrays = (f((B, L, Hd)), f((B, L, Hd)), f((B, L, 3)), cmask) + params
    return arrays, f((B, L, Hd)), f((B, L, 3))


def _torch(arrays):
    return [torch.from_numpy(v) for v in arrays]


def _padded_plain(args, W, chain_dtype=torch.float32):
    """The CUDA wrapper's path with the plain version in the kernel's
    place: pad to the native width, run, slice ``agg`` back."""
    Hd = args[0].shape[-1]
    agg, delta = egnn_band_reference(*pad_band_width(*args, native_width(Hd)), W,
                                     chain_dtype)
    return agg[..., :Hd], delta


def _padded_plain_grads(args, g_agg, g_delta, W, chain_dtype=torch.float32):
    """The CUDA backward wrapper's path with the plain backward in the
    kernel's place."""
    n = native_width(args[0].shape[-1])
    grads = egnn_band_bwd_reference(*pad_band_width(*args, n),
                                    F.pad(g_agg, (0, n - g_agg.shape[-1])), g_delta, W,
                                    chain_dtype)
    return unpad_band_grads(grads, *args)


@pytest.mark.parametrize("Hd,want", [(1, 32), (8, 32), (16, 32), (31, 32), (32, 32),
                                     (33, 64), (48, 64), (96, 128), (200, 256),
                                     (256, 256), (384, 512), (511, 512), (512, 512),
                                     (640, 768), (768, 768), (1100, 1280), (2048, 2048)])
def test_native_width(Hd, want):
    assert native_width(Hd) == want
    assert (native_width(Hd) == Hd) == (Hd in NATIVE_HIDDEN or
                                        (Hd > MAX_NATIVE and Hd % WIDE_GROUP == 0))


@pytest.mark.parametrize("Hd", [0, -3, MAX_NATIVE + 1, 1024])
def test_native_width_raises_outside_the_limit(Hd):
    """Only a width below 1 raises; above 512 (once the limit) the wide
    variants take the next multiple of WIDE_GROUP: 513 runs at 768, 1024
    at its own width."""
    if Hd < 1:
        with pytest.raises(ValueError, match="at least 1"):
            native_width(Hd)
    else:
        assert native_width(Hd) == {MAX_NATIVE + 1: 768, 1024: 1024}[Hd]


@pytest.mark.parametrize("B,L,n_sm,per_sm,want", [
    (1, 37, 132, 2, 5), (4, 256, 132, 2, 128), (10, 640, 132, 2, 264), (2, 64, 132, 0, 16)])
def test_wide_fwd_grid(B, L, n_sm, per_sm, want):
    """Kernel 1's wide variant: one block per resident slot, at most one
    per (batch row, 8-receiver tile) item."""
    assert wide_fwd_grid(B, L, n_sm, per_sm) == want


def test_padding_is_zeros_around_the_real_entries():
    arrays, _, _ = _inputs(seed=1, Hd=48)
    args = _torch(arrays)
    padded = pad_band_width(*args, 64)
    shapes = [(2, 64, 64), (2, 64, 64), (2, 64, 3), (2, 64), (64,), (64, 64), (64,),
              (64, 64), (64,), (64,), (1,)]
    assert [tuple(t.shape) for t in padded] == shapes
    for got, orig in zip(padded, args):
        if got.shape == orig.shape:
            assert got is orig      # x, cmask, b_x2 pass as they are
            continue
        if got.dim() == 3:
            assert torch.equal(got[..., :48], orig) and not got[..., 48:].any()
        elif got.dim() == 2:
            assert torch.equal(got[:48, :48], orig) and not got[48:].any()
            assert not got[:, 48:].any()
        else:
            assert torch.equal(got[:48], orig.reshape(-1)) and not got[48:].any()
        assert got.is_contiguous()


@pytest.mark.parametrize("chain_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hd", [8, 16, 48, 96])
def test_padded_plain_is_the_plain_version(Hd, chain_dtype):
    """The padded function sliced back against the unpadded one: fp32
    rounding apart in the fp32 chain (the padded sums gain exact zero
    terms, in another blocking order). In the bf16 chain each product is
    rounded to bf16 from its fp32 sum, so a last-bit difference of that sum
    may flip one rounding: agg and raw_delta within 2^-8 of max|value|
    (one bf16 ulp), the gradients within 2^-7 of max|grad|."""
    arrays, g_agg, g_delta = _inputs(seed=Hd, Hd=Hd)
    args = _torch(arrays)
    ga, gd = torch.from_numpy(g_agg), torch.from_numpy(g_delta)
    W = 4
    bf16 = chain_dtype == torch.bfloat16
    for got, want in zip(_padded_plain(args, W, chain_dtype),
                         egnn_band_reference(*args, W, chain_dtype)):
        scale = float(want.abs().max())
        if bf16:
            assert float((got - want).abs().max()) <= 2 ** -8 * scale
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)
    got = _padded_plain_grads(args, ga, gd, W, chain_dtype)
    want = egnn_band_bwd_reference(*args, ga, gd, W, chain_dtype)
    for name, g, w, inp in zip(DIFF_NAMES, got, want, args[:3] + args[4:]):
        assert g.shape == w.shape == inp.shape and g.dtype == w.dtype, name
        scale = float(w.abs().max())
        if bf16:
            assert float((g - w).abs().max()) <= 2 ** -7 * scale, name
        else:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * scale, msg=name)


def test_padding_a_native_width_changes_nothing():
    """``unpad_band_grads`` of a call made at the real width is the call's
    own result (the wrapper pads only widths outside NATIVE_HIDDEN)."""
    arrays, g_agg, g_delta = _inputs(seed=3, Hd=32)
    args = _torch(arrays)
    grads = egnn_band_bwd_reference(*args, torch.from_numpy(g_agg),
                                    torch.from_numpy(g_delta), 4)
    for g, u in zip(grads, unpad_band_grads(grads, *args)):
        assert torch.equal(g, u)


# The JAX package's tolerances for its band kernel against its reference
# (tests/test_pallas.py): rtol 1e-4 forward, 2e-3 for the gradients.
RTOL, ATOL = 1e-4, 1e-5
G_RTOL, G_ATOL = 2e-3, 1e-4


@pytest.mark.parametrize("Hd", [8, 16, 48])
def test_padded_path_matches_pallas_interpret(Hd):
    arrays, g_agg, g_delta = _inputs(seed=70 + Hd, Hd=Hd)
    W = 4
    want = jax_egnn_band_fused(*(jnp.asarray(v) for v in arrays), W,
                               jax.lax.Precision.HIGHEST)
    for g, w in zip(_padded_plain(_torch(arrays), W), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)

    def loss(*d):
        agg, delta = jax_egnn_band_fused(d[0], d[1], d[2], jnp.asarray(arrays[3]), *d[3:],
                                         W, jax.lax.Precision.HIGHEST)
        return jnp.sum(agg * g_agg) + jnp.sum(delta * g_delta)

    diff = [jnp.asarray(v) for v in arrays[:3] + arrays[4:]]
    jgrads = jax.grad(loss, argnums=tuple(range(10)))(*diff)
    got = _padded_plain_grads(_torch(arrays), torch.from_numpy(g_agg),
                              torch.from_numpy(g_delta), W)
    for name, g, w in zip(DIFF_NAMES, got, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=G_RTOL, atol=G_ATOL,
                                   err_msg=f"grad {name}")


def test_train_cli_builds_and_trains_at_hd512(tmp_path):
    """``cli.train --decoder_hidden 512`` (the reference CLI's default width)
    on the CPU: the model has 512 x 512 edge weights, one epoch trains to
    finite losses, and the checkpoint records the width."""
    from protein_ensemble_vae_torch.cli import train as train_cli
    from protein_ensemble_vae_torch.data import make_synthetic_dataset

    tr, va = make_synthetic_dataset(str(tmp_path / "data"), n_proteins=2, K=3,
                                    lengths=(24,), seqemb_dim=16, seed=7)
    train_cli.main(["--manifest_train", tr, "--manifest_val", va, "--use_seqemb",
                    "--batch_size", "4", "--d_model", "32", "--nhead", "4", "--ff", "64",
                    "--nlayers", "1", "--z_global", "16", "--z_local", "8",
                    "--decoder_hidden", "512", "--decoder_layers", "1",
                    "--max_neighbors", "4", "--epochs", "1", "--device", "cpu",
                    "--save", str(tmp_path / "ckpt")])
    final = tmp_path / "ckpt" / "final"
    meta = json.loads((final / "meta.json").read_text())
    assert meta["config"]["model"]["decoder_hidden"] == 512
    state = torch.load(final / "state.pt", weights_only=True)["model"]
    assert tuple(state["decoder.egnn_0.phi_e2_kernel"].shape) == (512, 512)
    hist = json.loads((final / "history.json").read_text())
    assert all(np.isfinite(v).all() for v in hist["train"].values())
