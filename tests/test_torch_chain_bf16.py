"""The bf16 edge chain of the EGNN band kernels (``chain_dtype=bfloat16``):
the port's plain version against the JAX package's Pallas kernels in
interpret mode on the CPU, at the inputs of tests/test_pallas.py's
``_egnn_inputs`` (B2/L64, a masked tail, Hd 8 and 32, W 4 and 8).

The plain version rounds where the JAX kernel rounds (``_fwd_kernel`` and
``_edge_chain_cotangents`` with a bf16 chain: every elementwise op, each
product's fp32 sum rounded once, fp32 sums over edges), and its gradient
follows ``_edge_chain_cotangents`` op by op rather than autograd through
the rounded forward. Measured on these inputs (seeds 13 and 0; the test
prints them): ``agg`` bitwise equal to JAX's, ``raw_delta`` within 6.7e-3
of max |JAX|, the gradients within 6.3e-3. They are held at 1e-2 (values)
and 2e-2 (gradients) of max |JAX|: the fp32 sums feeding each bf16
rounding run in another order in the two frameworks, and one bf16 step is
3.9e-3 relative.

The port also mirrors ``tests/test_pallas.py::test_egnn_fused_bf16_chain``
(the bf16 chain within 3 % / 5 % of the fp32 chain) at that test's seed 13.
That bound is a property of those inputs, not of the mode: at seed 0 JAX's
own bf16 chain lies 7.05e-2 of max from its fp32 chain on ``w_x1``'s
gradient, which is why the JAX comparison above holds the port against
JAX's bf16 chain.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from protein_ensemble_vae_torch.ops.kernels import BAND_MODE_LAUNCHES, LAUNCHES  # noqa: E402
from protein_ensemble_vae_torch.ops.kernels.egnn_band import (  # noqa: E402
    EGNNBandFunction, check_mode, egnn_band_bwd, egnn_band_bwd_reference,
    egnn_band_fused, egnn_band_fwd, egnn_band_reference, mode_key)
from protein_ensemble_vae_tpu.ops.pallas.egnn_band import (  # noqa: E402
    egnn_band_fused as jax_egnn_band_fused)

PARAM_ORDER = ("w_d", "w_e2", "b_e2", "w_x1", "b_x1", "w_x2", "b_x2")
NAMES = ("a", "bs", "x") + PARAM_ORDER
CHAIN = torch.bfloat16
VALUE_TOL, GRAD_TOL = 1e-2, 2e-2       # of max |JAX bf16 chain|, see the docstring
VALUE_FRAC, GRAD_FRAC = 0.03, 0.05     # bf16 chain vs fp32 chain (tests/test_pallas.py)


def _inputs(seed, B=2, L=64, Hd=8):
    """tests/test_pallas.py:_egnn_inputs, in its order of draws."""
    rng = np.random.default_rng(seed)
    f = lambda s, sd=1.0: rng.normal(0, sd, s).astype(np.float32)  # noqa: E731
    a, bs, x = f((B, L, Hd)), f((B, L, Hd)), f((B, L, 3))
    cmask = np.ones((B, L), np.float32)
    cmask[0, -10:] = 0.0
    params = dict(w_d=f((1, Hd), 0.5), w_e2=f((Hd, Hd), 0.3), b_e2=f((Hd,), 0.1),
                  w_x1=f((Hd, Hd), 0.3), b_x1=f((Hd,), 0.1), w_x2=f((Hd, 1), 0.3),
                  b_x2=f((1,), 0.1))
    return a, bs, x, cmask, params


def _torch(a, bs, x, cmask, p):
    t = torch.from_numpy
    return [t(a), t(bs), t(x), t(cmask)] + [t(p[k]) for k in PARAM_ORDER]


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("seed", [13, 0])
@pytest.mark.parametrize("Hd,W", [(8, 4), (32, 8)])
def test_plain_bf16_chain_matches_pallas_interpret(Hd, W, seed):
    """Values and the gradients of sum(agg * g_agg) + sum(delta * g_delta)
    against JAX's interpret-mode bf16 chain, through every CPU entry."""
    a, bs, x, cmask, p = _inputs(seed, Hd=Hd)
    rng = np.random.default_rng(seed + 1)
    g_agg = rng.normal(0, 1, a.shape).astype(np.float32)
    g_delta = rng.normal(0, 1, x.shape).astype(np.float32)
    jargs = [jnp.asarray(v) for v in (a, bs, x, cmask)] + [jnp.asarray(p[k]) for k in PARAM_ORDER]

    def loss(*d):
        out = jax_egnn_band_fused(d[0], d[1], d[2], jargs[3], *d[3:], W, None, jnp.bfloat16)
        return jnp.sum(out[0] * g_agg) + jnp.sum(out[1] * g_delta), out

    (_, want), want_g = jax.value_and_grad(loss, argnums=tuple(range(10)), has_aux=True)(
        *jargs[:3], *jargs[4:])
    targs = _torch(a, bs, x, cmask, p)
    for got in (egnn_band_fwd(*targs, W, "highest", CHAIN),
                egnn_band_reference(*targs, W, CHAIN)):
        for name, g, w in zip(("agg", "raw_delta"), got, want):
            assert g.dtype == torch.float32
            assert _rel(g.detach().numpy(), w) <= VALUE_TOL, name
    ga, gd = torch.from_numpy(g_agg), torch.from_numpy(g_delta)
    diff = [t.clone().requires_grad_(True) for t in targs[:3] + targs[4:]]
    agg, delta = egnn_band_fused(*diff[:3], targs[3], *diff[3:], W, "auto", "highest", CHAIN)
    routes = {"bwd_wrapper": egnn_band_bwd(*targs, ga, gd, W, "highest", CHAIN),
              "bwd_reference": egnn_band_bwd_reference(*targs, ga, gd, W, CHAIN),
              "fused_auto": torch.autograd.grad((agg * ga).sum() + (delta * gd).sum(), diff)}
    gaps = {}
    for how, grads in routes.items():
        for name, g, w in zip(NAMES, grads, want_g):
            assert g.shape == tuple(w.shape) and g.dtype == torch.float32, (how, name)
            gaps[how, name] = _rel(g.numpy(), w)
            assert gaps[how, name] <= GRAD_TOL, (how, name, gaps[how, name])
    worst = max(gaps, key=gaps.get)
    print(f"Hd {Hd} W {W} seed {seed}: values {[_rel(g.numpy(), w) for g, w in zip(got, want)]}, "
          f"worst gradient {gaps[worst]:.3e} {worst}")


def test_bf16_chain_tracks_fp32_chain():
    """The port's mirror of tests/test_pallas.py::test_egnn_fused_bf16_chain
    (its seed, the ``rng`` fixture's 13): fp32 outputs, values within 3 %
    and finite gradients of sum(agg^2) + sum(delta^2) within 5 % of the
    fp32 chain's max |value|."""
    targs = _torch(*_inputs(13))
    out = {}
    for chain in (torch.float32, CHAIN):
        diff = [t.clone().requires_grad_(True) for t in targs[:3] + targs[4:]]
        agg, delta = egnn_band_fused(*diff[:3], targs[3], *diff[3:], 4, "auto", "highest", chain)
        assert agg.dtype == delta.dtype == torch.float32
        grads = torch.autograd.grad(agg.square().sum() + delta.square().sum(), diff)
        out[chain] = ((agg.detach(), delta.detach()), grads)
    (v32, g32), (v16, g16) = out[torch.float32], out[CHAIN]
    for a, b in zip(v16, v32):
        assert float((a - b).abs().max()) < VALUE_FRAC * float(b.abs().max())
    for name, a, b in zip(NAMES, g16, g32):
        assert torch.isfinite(a).all(), name
        assert float((a - b).abs().max()) < GRAD_FRAC * (float(b.abs().max()) + 1e-6), name


def test_fp32_chain_bound_depends_on_the_seed():
    """At seed 0 the bf16 chain lies more than 5 % of max from the fp32 chain
    on w_x1's gradient of sum(agg^2) + sum(delta^2), in JAX (measured
    7.05e-2) and in the port alike (within 1e-2 of JAX's gap): the JAX
    test's bound holds at its seed 13 only, so the port is held against
    JAX's bf16 chain, not against a bound on the distance between chains."""
    a, bs, x, cmask, p = _inputs(0)
    jargs = [jnp.asarray(v) for v in (a, bs, x, cmask)] + [jnp.asarray(p[k]) for k in PARAM_ORDER]
    k = NAMES.index("w_x1")

    def jax_grad(cdt):
        def loss(w):
            d = list(jargs[4:])
            d[k - 3] = w
            agg, delta = jax_egnn_band_fused(*jargs[:4], *d, 4, None, cdt)
            return jnp.sum(agg ** 2) + jnp.sum(delta ** 2)
        return np.asarray(jax.grad(loss)(jargs[4 + k - 3]))

    g32, g16 = jax_grad(jnp.float32), jax_grad(jnp.bfloat16)
    jax_gap = float(np.abs(g16 - g32).max() / np.abs(g32).max())
    targs = _torch(a, bs, x, cmask, p)
    port = {}
    for chain in (torch.float32, CHAIN):
        w = targs[4 + k - 3].clone().requires_grad_(True)
        ps = targs[4:]
        ps[k - 3] = w
        agg, delta = egnn_band_fused(*targs[:4], *ps, 4, "auto", "highest", chain)
        port[chain] = torch.autograd.grad(agg.square().sum() + delta.square().sum(), w)[0]
    port_gap = _rel(port[CHAIN].numpy(), port[torch.float32].numpy())
    print(f"w_x1 gradient, bf16 chain vs fp32 chain at seed 0: JAX {jax_gap:.4e}, "
          f"port {port_gap:.4e}")
    assert jax_gap > GRAD_FRAC and port_gap > GRAD_FRAC
    assert abs(port_gap - jax_gap) < 1e-2


@pytest.mark.parametrize("chain", [torch.float16, torch.float64, "bfloat16"])
def test_check_mode_rejects_other_chain_dtypes(chain):
    check_mode("highest", torch.float32)
    check_mode("default", torch.bfloat16)
    with pytest.raises(ValueError, match="chain_dtype"):
        check_mode("highest", chain)
    targs = _torch(*_inputs(3))
    with pytest.raises(ValueError, match="chain_dtype"):
        egnn_band_fused(*targs, 4, "auto", "highest", chain)
    with pytest.raises(ValueError, match="precision"):
        check_mode("fast", torch.bfloat16)


def test_cpu_bf16_chain_counts_no_launch():
    """On CPU tensors every entry runs the plain version: no launch is
    counted, in total or by mode."""
    targs = _torch(*_inputs(5, Hd=32))
    before, before_modes = dict(LAUNCHES), dict(BAND_MODE_LAUNCHES)
    diff = [t.clone().requires_grad_(True) for t in targs[:3] + targs[4:]]
    for mode in ("auto", "interpret", False):
        agg, delta = egnn_band_fused(*diff[:3], targs[3], *diff[3:], 4, mode, "default", CHAIN)
        (agg.sum() + delta.sum()).backward()
    agg, delta = EGNNBandFunction.apply(*diff[:3], targs[3], *diff[3:], 4, "default", CHAIN)
    (agg.sum() + delta.sum()).backward()
    egnn_band_bwd(*targs, torch.ones(agg.shape), torch.ones(delta.shape), 4, "default", CHAIN)
    assert LAUNCHES == before and BAND_MODE_LAUNCHES == before_modes


def test_fp32_inputs_round_as_bf16_inputs():
    """fp32 a / bs in the bf16 chain are cast to bf16 first (JAX: the
    chain's `.astype(cdt)`): forward and gradients equal those of the
    bf16-rounded inputs, the gradients of a / bs after rounding to bf16."""
    targs = _torch(*_inputs(7, Hd=32))
    t16 = [targs[0].bfloat16(), targs[1].bfloat16()] + targs[2:]
    for g, w in zip(egnn_band_fwd(*targs, 8, "default", CHAIN),
                    egnn_band_fwd(*t16, 8, "default", CHAIN)):
        assert torch.equal(g, w)
    gen = torch.Generator().manual_seed(1)
    ga, gd = torch.randn(2, 64, 32, generator=gen), torch.randn(2, 64, 3, generator=gen)
    got = egnn_band_bwd(*targs, ga, gd, 8, "default", CHAIN)
    want = egnn_band_bwd(*t16, ga, gd, 8, "default", CHAIN)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == (torch.float32 if name in ("a", "bs") else w.dtype), name
        assert torch.equal(g.to(w.dtype), w), name


def test_mode_keys_append_the_chain():
    """The launch-count keys of the fp32 chain are as before; the bf16 chain
    puts ``bfloat16_chain`` in the place of the precision, which selects
    nothing there."""
    assert mode_key("egnn_band_fwd", torch.bfloat16, "default") == "egnn_band_fwd:bfloat16/default"
    assert mode_key("egnn_band_bwd", torch.float32, "highest", torch.float32) == \
        "egnn_band_bwd:float32/highest"
    for precision in ("default", "highest"):
        assert mode_key("egnn_band_fwd", torch.float32, precision, CHAIN) == \
            "egnn_band_fwd:float32/bfloat16_chain"
