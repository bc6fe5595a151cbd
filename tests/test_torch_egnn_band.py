"""EGNN band forward and backward: the port's plain version against the JAX
package's Pallas kernels (interpret mode on the CPU) and its XLA band path,
values and gradients, and the port's kernel routing and autograd function
on CPU tensors. The CUDA kernels themselves are held against the plain
versions on the GPU by tests/test_torch_gpu.py and chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from protein_ensemble_vae_torch.ops.kernels import LAUNCHES  # noqa: E402
from protein_ensemble_vae_torch.ops.kernels.egnn_band import (  # noqa: E402
    EGNNBandFunction, egnn_band_bwd, egnn_band_bwd_reference, egnn_band_fused,
    egnn_band_fwd, egnn_band_reference)
from protein_ensemble_vae_tpu.models.decoder import (band_gather,  # noqa: E402
                                                     band_indices)
from protein_ensemble_vae_tpu.ops.pallas.egnn_band import (  # noqa: E402
    egnn_band_fused as jax_egnn_band_fused)

PARAM_ORDER = ("w_d", "w_e2", "b_e2", "w_x1", "b_x1", "w_x2", "b_x2")


def _inputs(seed, B=2, L=64, Hd=8):
    """The shapes of tests/test_pallas.py:_egnn_inputs (masked tail)."""
    rng = np.random.default_rng(seed)
    f = lambda s, sd=1.0: rng.normal(0, sd, s).astype(np.float32)  # noqa: E731
    cmask = np.ones((B, L), np.float32)
    cmask[0, -10:] = 0.0
    params = dict(w_d=f((1, Hd), 0.5), w_e2=f((Hd, Hd), 0.3),
                  b_e2=f((Hd,), 0.1), w_x1=f((Hd, Hd), 0.3),
                  b_x1=f((Hd,), 0.1), w_x2=f((Hd, 1), 0.3),
                  b_x2=f((1,), 0.1))
    return f((B, L, Hd)), f((B, L, Hd)), f((B, L, 3)), cmask, params


def _jax_band_plain(a, bs, x, cmask, w_d, w_e2, b_e2, w_x1, b_x1, w_x2,
                    b_x2, W):
    """The JAX package's XLA band path (models/decoder.py non-Pallas
    branch) at HIGHEST precision, for lengths the Pallas kernel refuses."""
    L = a.shape[1]
    with jax.default_matmul_precision("highest"):
        nbr_idx, in_range = band_indices(L, W)
        cm = jnp.asarray(cmask).astype(bool)
        mask_k = (in_range[None] & cm[:, :, None]
                  & cm[:, nbr_idx]).astype(jnp.float32)[..., None]
        rel = x[:, :, None, :] - band_gather(x, nbr_idx)
        d2 = jnp.sum(rel ** 2, -1, keepdims=True)
        pre = a[:, :, None, :] + band_gather(bs, nbr_idx) + d2 * w_d
        m = jax.nn.silu(jax.nn.silu(pre) @ w_e2 + b_e2)
        agg = jnp.sum(m * mask_k, axis=2)
        w = jax.nn.silu(m @ w_x1 + b_x1) @ w_x2 + b_x2
        return agg, jnp.sum((w * mask_k) * rel, axis=2)


def _torch(a, bs, x, cmask, p):
    t = torch.from_numpy
    return (t(a), t(bs), t(x), t(cmask)) + tuple(t(p[k]) for k in PARAM_ORDER)


# Same tolerance as the JAX package's own kernel-vs-reference test
# (tests/test_pallas.py): fp32, sums in another order.
RTOL, ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("W", [4, 8])
def test_reference_matches_pallas_interpret(W):
    a, bs, x, cmask, p = _inputs(seed=11 + W)
    want = jax_egnn_band_fused(
        jnp.array(a), jnp.array(bs), jnp.array(x), jnp.array(cmask),
        *(jnp.array(p[k]) for k in PARAM_ORDER), W,
        jax.lax.Precision.HIGHEST)
    got = egnn_band_reference(*_torch(a, bs, x, cmask, p), W)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("L", [37, 70])
def test_reference_matches_jax_band_at_unaligned_length(L):
    """The Pallas kernel asserts L % 64 == 0; the port takes any L, so an
    unaligned length is held against the JAX package's XLA band path."""
    a, bs, x, cmask, p = _inputs(seed=L, L=L)
    W = 4
    want = _jax_band_plain(*(jnp.array(v) for v in (a, bs, x, cmask)),
                           *(jnp.array(p[k]) for k in PARAM_ORDER), W)
    got = egnn_band_reference(*_torch(a, bs, x, cmask, p), W)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_routing_on_cpu_tensors():
    a, bs, x, cmask, p = _inputs(seed=5)
    args = _torch(a, bs, x, cmask, p)
    before = LAUNCHES["egnn_band_fwd"]
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        egnn_band_fused(*args, 4, use_pallas=True)
    ref = egnn_band_reference(*args, 4)
    for mode in ("auto", "interpret", False):
        got = egnn_band_fused(*args, 4, use_pallas=mode)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    # the wrapper itself takes the plain version for a CPU tensor
    for g, r in zip(egnn_band_fwd(*args, 4), ref):
        assert torch.equal(g, r)
    assert LAUNCHES["egnn_band_fwd"] == before


def test_masked_receivers_and_senders_contribute_nothing():
    a, bs, x, cmask, p = _inputs(seed=8)
    agg, delta = egnn_band_reference(*_torch(a, bs, x, cmask, p), 4)
    assert float(agg[0, -10:].abs().max()) == 0.0
    assert float(delta[0, -10:].abs().max()) == 0.0
    # a masked sender's features do not reach its neighbours
    bs2 = bs.copy()
    bs2[0, -10:] += 100.0
    agg2, _ = egnn_band_reference(*_torch(a, bs2, x, cmask, p), 4)
    assert torch.equal(agg, agg2)


# Gradients: the JAX package's own tolerance for its band backward
# (tests/test_pallas.py:test_egnn_fused_grad_parity).
G_RTOL, G_ATOL = 2e-3, 1e-4
DIFF_NAMES = ("a", "bs", "x") + PARAM_ORDER


def _jax_grads(fn, a, bs, x, cmask, p, g_agg, g_delta):
    """Gradients of sum(agg * g_agg) + sum(delta * g_delta) w.r.t. (a, bs,
    x, params) through ``fn(a, bs, x, cmask, *params)``."""
    def loss(*d):
        agg, delta = fn(d[0], d[1], d[2], jnp.asarray(cmask), *d[3:])
        return jnp.sum(agg * g_agg) + jnp.sum(delta * g_delta)

    args = [jnp.asarray(v) for v in (a, bs, x)] + [jnp.asarray(p[k]) for k in PARAM_ORDER]
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(10)))(*args)]


def _port_grads_all(a, bs, x, cmask, p, g_agg, g_delta, W):
    """The port's gradients three ways: the plain backward, autograd through
    the routed entry on CPU tensors, and EGNNBandFunction (whose wrappers
    run their plain versions on CPU tensors)."""
    args = _torch(a, bs, x, cmask, p)
    ga, gd = torch.from_numpy(g_agg), torch.from_numpy(g_delta)
    out = {"bwd_reference": egnn_band_bwd_reference(*args, ga, gd, W),
           "bwd_wrapper": egnn_band_bwd(*args, ga, gd, W)}
    for name, fn in (("fused_auto", lambda *t: egnn_band_fused(*t, W)),
                     ("function", lambda *t: EGNNBandFunction.apply(*t, W))):
        diff = [t.clone().requires_grad_(True) for t in args[:3] + args[4:]]
        agg, delta = fn(*diff[:3], args[3], *diff[3:])
        out[name] = torch.autograd.grad(
            (agg * ga).sum() + (delta * gd).sum(), diff)
    return out


def _cotangents(seed, a, x):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, a.shape).astype(np.float32),
            rng.normal(0, 1, x.shape).astype(np.float32))


def _assert_grads(port, want):
    for how, grads in port.items():
        assert len(grads) == len(want)
        for name, g, w in zip(DIFF_NAMES, grads, want):
            assert torch.isfinite(g).all(), (how, name)
            np.testing.assert_allclose(g.numpy(), w, rtol=G_RTOL, atol=G_ATOL,
                                       err_msg=f"{how}: grad {name}")


@pytest.mark.parametrize("W", [4, 8])
def test_grads_match_pallas_backward_interpret(W):
    a, bs, x, cmask, p = _inputs(seed=31 + W)
    g_agg, g_delta = _cotangents(W, a, x)
    want = _jax_grads(lambda *t: jax_egnn_band_fused(*t, W, jax.lax.Precision.HIGHEST),
                      a, bs, x, cmask, p, g_agg, g_delta)
    _assert_grads(_port_grads_all(a, bs, x, cmask, p, g_agg, g_delta, W), want)


@pytest.mark.parametrize("L", [37, 70])
def test_grads_match_jax_band_at_unaligned_length(L):
    a, bs, x, cmask, p = _inputs(seed=L + 1, L=L)
    W = 4
    g_agg, g_delta = _cotangents(L, a, x)
    want = _jax_grads(lambda *t: _jax_band_plain(*t, W), a, bs, x, cmask, p,
                      g_agg, g_delta)
    _assert_grads(_port_grads_all(a, bs, x, cmask, p, g_agg, g_delta, W), want)


def test_backward_routing_on_cpu_counts_no_launch():
    a, bs, x, cmask, p = _inputs(seed=6)
    before = dict(LAUNCHES)
    args = _torch(a, bs, x, cmask, p)
    g = egnn_band_bwd(*args, torch.ones(a.shape), torch.ones(x.shape), 4)
    assert [tuple(t.shape) for t in g] == [tuple(t.shape) for t in args[:3] + args[4:]]
    assert LAUNCHES == before
