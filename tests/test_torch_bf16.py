"""The bf16 compute path: the port against the JAX package on the CPU, at
small widths (Hd 32, W 4, L 64), inputs made with numpy from a seed.

(a) ``egnn_band_fused`` with bf16 ``a`` / ``bs``, ``precision`` "default"
    (JAX ``None``) and the fp32 chain: the port's plain version against the
    JAX Pallas kernel in interpret mode. Both upcast the same bf16-rounded
    inputs and run the fp32 chain (full fp32 products on the CPU), so the
    values are held at the fp32 band tolerance (rtol 1e-4) and the
    gradients of the other 8 inputs at the fp32 band-gradient tolerance
    (rtol 2e-3, atol 1e-4); the gradients of ``a`` / ``bs`` come back in
    bf16 on both sides and are held after that rounding, at 1e-2 relative
    (one bf16 ulp is 2^-8 = 3.9e-3 relative).
(b) ``chain_dtype=bfloat16`` runs with bf16 inputs (it raised, naming
    ROADMAP.md, until it was ported); ``float16`` raises.
(c) The bf16 ``EGNNDecoder`` and ``HierCVAE`` forward with parameters
    carried over through ``params_from_flax``, on the two routing pairings:
    port ``False`` (its bf16-chain band path) against JAX ``False`` (its
    XLA band path), and port ``"auto"`` on CPU tensors (the kernel's plain
    version) against JAX ``"interpret"`` (the Pallas kernel). bf16 rounds
    at other places in the two frameworks, so each output is held within
    3 % of its max |value|, the JAX package's own bf16 tolerance for the
    band kernel's values (tests/test_pallas.py:test_egnn_fused_bf16_chain),
    except N and C, held within 15 %: each is CA plus a bond length times
    the normalised first three outputs of a 4-wide head, and bf16 rounding
    turns that direction where the three outputs are short. Measured on
    these inputs and six other latents: JAX's own bf16 decode differs from
    its fp32 decode by up to 8.1 % of max |N|, and the port's bf16 from
    JAX's bf16 by up to 9.1 % (C); CA stays within 1.3 %.
(d) One bf16 train step, the loss dict and every parameter gradient with
    the same injected noise, against the JAX bf16 step (use_pallas False
    and "auto" / "interpret"): each loss within 3 % of its |value|; each
    gradient on its own scale, |g - w| / |w| <= 0.25 in the Frobenius
    norm. A threshold on the whole step's max |grad| would be blind here:
    the step's max is up to 2.9e5x a tensor's own max (the decoder's
    ``phi_e1_d2_kernel``), so 5 % of it lies above the whole
    magnitude of many tensors. 0.25 is set from the bf16 noise between two
    placements of the roundings of the same JAX model (jitted, where XLA
    keeps excess fp32 precision, against op by op): up to 0.16 per tensor
    on these inputs (``decoder.n_off1.bias``), the port against the jitted
    step up to 0.18 (the same tensor). A zeroed gradient reads 1.0, and
    the test holds that the check flags one (``decoder.egnn_1.
    phi_e2_kernel``). The attention key biases' gradients are zero
    analytically (softmax is shift-invariant per query) and bf16 noise on
    both sides; each is held on both sides below 5 % of the norm of its
    attention's query-bias gradient (measured: up to 1.2 % on JAX's
    side, 0.19 % on the port's).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import bf16_rel_gaps  # noqa: E402
from protein_ensemble_vae_torch.config import LossWeights as TLossWeights  # noqa: E402
from protein_ensemble_vae_torch.config import ModelConfig as TModelConfig  # noqa: E402
from protein_ensemble_vae_torch.models import HierCVAE as THierCVAE  # noqa: E402
from protein_ensemble_vae_torch.models.bridge import params_from_flax  # noqa: E402
from protein_ensemble_vae_torch.models.decoder import EGNNDecoder as TEGNNDecoder  # noqa: E402
from protein_ensemble_vae_torch.ops.kernels import LAUNCHES  # noqa: E402
from protein_ensemble_vae_torch.ops.kernels.egnn_band import (  # noqa: E402
    EGNNBandFunction, egnn_band_bwd, egnn_band_bwd_reference, egnn_band_fused,
    egnn_band_fwd)
from protein_ensemble_vae_torch.train.training import make_loss_fn  # noqa: E402
from protein_ensemble_vae_tpu.config import LossWeights, ModelConfig  # noqa: E402
from protein_ensemble_vae_tpu.losses import compute_total_loss  # noqa: E402
from protein_ensemble_vae_tpu.models import HierCVAE  # noqa: E402
from protein_ensemble_vae_tpu.models.decoder import EGNNDecoder  # noqa: E402
from protein_ensemble_vae_tpu.ops.pallas.egnn_band import (  # noqa: E402
    egnn_band_fused as jax_egnn_band_fused)

PARAM_ORDER = ("w_d", "w_e2", "b_e2", "w_x1", "b_x1", "w_x2", "b_x2")
DIFF_NAMES = ("a", "bs", "x") + PARAM_ORDER
HD, W, L = 32, 4, 64
RTOL, ATOL = 1e-4, 1e-5          # band values, fp32 chain on both sides
G_RTOL, G_ATOL = 2e-3, 1e-4      # band gradients, fp32
BF16_RTOL = 1e-2                 # gradients of a / bs after bf16 rounding
VALUE_FRAC = 0.03
DIRECTION_FRAC = 0.15            # N and C: CA + bond * normalised head, see (c)
GRAD_REL = 0.25                  # per-tensor |g - w| / |w| of the train step, see (d)
ZERO_GRAD_FRAC = 0.05            # key biases: |g| / |query-bias grad|, see (d)


# ---------------------------------------------------------------------------
# (a), (b) the band kernel's bf16-input mode
# ---------------------------------------------------------------------------

def _band_inputs(seed, B=2):
    rng = np.random.default_rng(seed)
    f = lambda s, sd=1.0: rng.normal(0, sd, s).astype(np.float32)  # noqa: E731
    cmask = np.ones((B, L), np.float32)
    cmask[0, -10:] = 0.0
    params = dict(w_d=f((1, HD), 0.5), w_e2=f((HD, HD), 0.2),
                  b_e2=f((HD,), 0.1), w_x1=f((HD, HD), 0.2),
                  b_x1=f((HD,), 0.1), w_x2=f((HD, 1), 0.2),
                  b_x2=f((1,), 0.1))
    return f((B, L, HD)), f((B, L, HD)), f((B, L, 3)), cmask, params


def _jax_args(a, bs, x, cmask, p):
    return ((jnp.asarray(a, jnp.bfloat16), jnp.asarray(bs, jnp.bfloat16))
            + tuple(jnp.asarray(v) for v in (x, cmask))
            + tuple(jnp.asarray(p[k]) for k in PARAM_ORDER))


def _torch_args(a, bs, x, cmask, p):
    t = torch.from_numpy
    return ((t(a).bfloat16(), t(bs).bfloat16(), t(x), t(cmask))
            + tuple(t(p[k]) for k in PARAM_ORDER))


def test_band_bf16_inputs_match_pallas_interpret():
    a, bs, x, cmask, p = _band_inputs(seed=61)
    jargs, targs = _jax_args(a, bs, x, cmask, p), _torch_args(a, bs, x, cmask, p)
    # both sides hold the same bf16 inputs
    for j, t in zip(jargs[:2], targs[:2]):
        np.testing.assert_array_equal(np.asarray(j.astype(jnp.float32)), t.float().numpy())
    want = jax_egnn_band_fused(*jargs[:11], W, None, jnp.float32)
    before = dict(LAUNCHES)
    for got in (egnn_band_fused(*targs, W, "auto", "default"),
                egnn_band_fwd(*targs, W, "default"),
                EGNNBandFunction.apply(*targs, W, "default")):
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and w.dtype == jnp.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    assert LAUNCHES == before    # CPU tensors: the plain version, no launch


def _port_grads(targs, ga, gd):
    """The port's gradients of sum(agg * ga) + sum(delta * gd) three ways:
    the plain backward, the backward wrapper (its plain version on CPU
    tensors) and autograd through the routed entry."""
    out = {"bwd_reference": egnn_band_bwd_reference(*targs, ga, gd, W),
           "bwd_wrapper": egnn_band_bwd(*targs, ga, gd, W, "default")}
    diff = [t.clone().requires_grad_(True) for t in targs[:3] + targs[4:]]
    agg, delta = egnn_band_fused(*diff[:3], targs[3], *diff[3:], W, "auto", "default")
    out["fused_auto"] = torch.autograd.grad((agg * ga).sum() + (delta * gd).sum(), diff)
    return out


def test_band_bf16_inputs_gradients_match_pallas_interpret():
    a, bs, x, cmask, p = _band_inputs(seed=62)
    rng = np.random.default_rng(63)
    g_agg = rng.normal(0, 1, a.shape).astype(np.float32)
    g_delta = rng.normal(0, 1, x.shape).astype(np.float32)
    jargs = _jax_args(a, bs, x, cmask, p)

    def loss(*d):
        agg, delta = jax_egnn_band_fused(d[0], d[1], d[2], jargs[3], *d[3:], W, None,
                                         jnp.float32)
        return jnp.sum(agg * g_agg) + jnp.sum(delta * g_delta)

    want = jax.grad(loss, argnums=tuple(range(10)))(*jargs[:3], *jargs[4:])
    targs = _torch_args(a, bs, x, cmask, p)
    for how, grads in _port_grads(targs, torch.from_numpy(g_agg),
                                  torch.from_numpy(g_delta)).items():
        for name, g, w in zip(DIFF_NAMES, grads, want):
            assert torch.isfinite(g.float()).all(), (how, name)
            if name in ("a", "bs"):
                assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, (how, name)
                np.testing.assert_allclose(g.float().numpy(),
                                           np.asarray(w.astype(jnp.float32)),
                                           rtol=BF16_RTOL, atol=G_ATOL,
                                           err_msg=f"{how}: grad {name}")
            else:
                assert g.dtype == torch.float32, (how, name)
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=G_RTOL,
                                           atol=G_ATOL, err_msg=f"{how}: grad {name}")


@pytest.mark.parametrize("entry", ["fused", "fwd", "bwd"])
def test_band_bf16_chain_raises_naming_roadmap(entry):
    """The bf16 chain was the mode that raised (naming ROADMAP.md) until it
    was ported, whence the name; now every entry runs it with bf16 inputs
    and finite results, and only a chain dtype the kernels lack, float16,
    raises. tests/test_torch_chain_bf16.py holds the same behaviours in
    depth: test_plain_bf16_chain_matches_pallas_interpret (every entry's
    values against JAX) and test_check_mode_rejects_other_chain_dtypes."""
    a, bs, x, cmask, p = _band_inputs(seed=64)
    targs = _torch_args(a, bs, x, cmask, p)
    g = (torch.zeros(a.shape), torch.zeros(x.shape))
    call = {"fused": lambda c: egnn_band_fused(*targs, W, "auto", "default", c),
            "fwd": lambda c: egnn_band_fwd(*targs, W, "default", c),
            "bwd": lambda c: egnn_band_bwd(*targs, *g, W, "default", c)}[entry]
    for out in call(torch.bfloat16):
        assert torch.isfinite(out.float()).all()
    with pytest.raises(ValueError, match="chain_dtype"):
        call(torch.float16)


# ---------------------------------------------------------------------------
# (c) the bf16 decoder and model
# ---------------------------------------------------------------------------

SMALL = dict(seqemb_dim=12, d_model=32, nhead=4, ff=64, nlayers=1,
             z_global=16, z_local=8, decoder_hidden=HD, decoder_layers=2,
             max_neighbors=W, dropout=0.0)
B = 2
# (port use_pallas_egnn, JAX use_pallas_egnn)
PAIRINGS = {"plain": (False, False), "kernel": ("auto", "interpret")}


def _model_inputs(seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    mask = np.ones((B, L), np.float32)
    mask[0, -7:] = 0.0          # padded tail
    mask[1, [3, 11, 12]] = 0.0  # holes
    return dict(seq_emb=f(B, L, SMALL["seqemb_dim"]), n=3 * f(B, L, 3),
                ca=3 * f(B, L, 3), c=3 * f(B, L, 3),
                dihedrals=np.clip(f(B, L, 6), -1, 1), mask=mask)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _frac(name: str) -> float:
    return DIRECTION_FRAC if name in ("N", "C") else VALUE_FRAC


def _close_frac(got, want, frac, name):
    """|got - want| <= frac * max|want|, elementwise, both finite."""
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape and np.isfinite(g).all(), name
    err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
    assert err <= frac * scale, f"{name}: max abs err {err:.3e} > {frac} x {scale:.3e}"


@pytest.fixture(scope="module")
def bf16_params():
    """One Flax parameter tree of the bf16 HierCVAE (parameters fp32)."""
    x = _model_inputs()
    jmodel = HierCVAE(ModelConfig(**SMALL, use_pallas_egnn=False), dtype=jnp.bfloat16)
    variables = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)},
        x["seq_emb"], x["n"], x["ca"], x["c"], x["dihedrals"], x["mask"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    assert all(v.dtype == np.float32 for v in jax.tree_util.tree_leaves(params))
    return variables["params"], params


def test_bf16_model_takes_the_flax_tree_as_it_is(bf16_params):
    """A bf16 model's parameters are fp32, as the Flax tree's: the bridge
    carries them over unchanged."""
    _, params = bf16_params
    model = THierCVAE(TModelConfig(**SMALL), dtype=torch.bfloat16)
    sd = params_from_flax(params, model)
    model.load_state_dict(sd)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    fp32_keys = THierCVAE(TModelConfig(**SMALL)).state_dict().keys()
    assert sorted(sd) == sorted(fp32_keys)
    np.testing.assert_array_equal(
        model.decoder.egnn_1.phi_e2_kernel.detach().numpy(),
        params["decoder"]["egnn_1"]["phi_e2_kernel"])


@pytest.mark.parametrize("pairing", sorted(PAIRINGS))
def test_bf16_decoder_forward_matches_jax(bf16_params, pairing):
    port_mode, jax_mode = PAIRINGS[pairing]
    _, params = bf16_params
    dec_params = params["decoder"]
    x = _model_inputs()
    rng = np.random.default_rng(9)
    z_g = rng.normal(0, 1, (B, SMALL["z_global"])).astype(np.float32)
    z_l = rng.normal(0, 1, (B, L, SMALL["z_local"])).astype(np.float32)
    kw = dict(z_g=SMALL["z_global"], z_l=SMALL["z_local"], hidden=HD,
              num_layers=SMALL["decoder_layers"], max_neighbors=W, dropout=0.0)
    jdec = EGNNDecoder(**kw, use_pallas=jax_mode, dtype=jnp.bfloat16)
    want = jdec.apply({"params": dec_params}, z_g, z_l, x["mask"])
    tdec = TEGNNDecoder(**kw, use_pallas=port_mode, dtype=torch.bfloat16)
    tdec.load_state_dict(params_from_flax(dec_params, tdec))
    with torch.no_grad():
        got = tdec.eval()(_t(z_g), _t(z_l), _t(x["mask"]))
    for name, g, w in zip(("N", "CA", "C", "seq"), got, want):
        assert g.dtype == torch.float32, name
        _close_frac(g, w, _frac(name), f"{pairing} {name}")


def _jax_forward(jmodel, variables, x, eps_g, eps_l):
    args = (x["seq_emb"], x["n"], x["ca"], x["c"], x["dihedrals"], x["mask"])
    _, _, mu_g, lv_g, mu_l, lv_l = jmodel.apply(
        variables, *args, method=HierCVAE.encode, rngs={"reparam": jax.random.PRNGKey(0)})
    z_g = mu_g + eps_g * jnp.exp(0.5 * jnp.clip(lv_g, -10.0, 10.0))
    z_l = mu_l + eps_l * jnp.exp(0.5 * jnp.clip(lv_l, -10.0, 10.0))
    dec = jmodel.apply(variables, z_g, z_l, x["mask"], method=HierCVAE.decode)
    return tuple(dec) + (mu_g, lv_g, mu_l, lv_l)


def _eps(seed=21):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, SMALL["z_global"])).astype(np.float32),
            rng.normal(0, 1, (B, L, SMALL["z_local"])).astype(np.float32))


def _tmodel(params, port_mode):
    model = THierCVAE(TModelConfig(**SMALL, use_pallas_egnn=port_mode), dtype=torch.bfloat16)
    model.load_state_dict(params_from_flax(params, model))
    return model


@pytest.mark.parametrize("pairing", sorted(PAIRINGS))
def test_bf16_model_forward_matches_jax(bf16_params, pairing):
    port_mode, jax_mode = PAIRINGS[pairing]
    jparams, params = bf16_params
    x = _model_inputs()
    eps_g, eps_l = _eps()
    jmodel = HierCVAE(ModelConfig(**SMALL, use_pallas_egnn=jax_mode), dtype=jnp.bfloat16)
    want = _jax_forward(jmodel, {"params": jparams}, x, eps_g, eps_l)
    model = _tmodel(params, port_mode).eval()
    with torch.no_grad():
        got = model(*(_t(x[k]) for k in ("seq_emb", "n", "ca", "c", "dihedrals", "mask")),
                    eps=(_t(eps_g), _t(eps_l)))
    names = ("N", "CA", "C", "seq", "mu_g", "lv_g", "mu_l", "lv_l")
    for name, g, w in zip(names, got, want):
        # coordinates and logits fp32, the latent heads in the compute dtype
        assert g.dtype == (torch.bfloat16 if name[:2] in ("mu", "lv") else torch.float32)
        _close_frac(g, w, _frac(name), f"{pairing} {name}")


# ---------------------------------------------------------------------------
# (d) one bf16 train step
# ---------------------------------------------------------------------------

KLW = (0.7, 0.3)


def _batch(seed=5):
    """Input / target conformers of one NeRF fold (padded tail, a hole)."""
    from protein_ensemble_vae_torch.data.synthetic import _torsions_np, nerf_ensemble

    n, ca, c = nerf_ensemble(L - 6, 2, seed=seed, max_tries=16)
    rng = np.random.default_rng(seed)
    out = {}
    for k, side in enumerate(("inp", "tgt")):
        pad = lambda v: np.pad(v, ((0, 6), (0, 0)))  # noqa: E731
        m = np.ones(L, np.float32)
        m[-6:] = 0.0
        cen = ca[k][:L - 6].mean(0)
        nn_, cca, cc = (pad(v[k] - cen) for v in (n, ca, c))
        rows = dict(n=nn_, ca=cca, c=cc, mask=m, dihedrals=_torsions_np(nn_, cca, cc, m))
        batch = {key: np.stack([v, v]).astype(np.float32) for key, v in rows.items()}
        batch["mask"][1, :] = 1.0
        batch["mask"][1, 9] = 0.0
        batch["seq_emb"] = rng.normal(0, 1, (B, L, SMALL["seqemb_dim"])).astype(np.float32)
        batch["seq_labels"] = rng.integers(0, 20, (B, L)).astype(np.int32)
        out[side] = batch
    return out


def _jax_loss(jmodel):
    def loss(params, batch, eps_g, eps_l):
        inp, tgt = batch["inp"], batch["tgt"]
        x = dict(inp, mask=tgt["mask"])
        pn, pca, pc, pseq, mu_g, lv_g, mu_l, lv_l = _jax_forward(
            jmodel, {"params": params}, x, eps_g, eps_l)
        d = compute_total_loss(pn, pca, pc, pseq, tgt["n"], tgt["ca"], tgt["c"],
                               tgt["seq_labels"], tgt["mask"], mu_g, lv_g, mu_l, lv_l,
                               tgt["dihedrals"], *KLW, weights=LossWeights(),
                               use_pallas=False)
        return d["total"], d

    return loss


@pytest.mark.parametrize("pairing", sorted(PAIRINGS))
def test_bf16_train_step_matches_jax(bf16_params, pairing):
    port_mode, jax_mode = PAIRINGS[pairing]
    jparams, params = bf16_params
    batch = _batch()
    eps_g, eps_l = _eps(seed=4)
    jmodel = HierCVAE(ModelConfig(**SMALL, use_pallas_egnn=jax_mode), dtype=jnp.bfloat16)
    (_, jd), jgrads = jax.jit(jax.value_and_grad(_jax_loss(jmodel), has_aux=True))(
        jparams, batch, eps_g, eps_l)
    model = _tmodel(params, port_mode).train()
    tbatch = {s: {k: _t(v) for k, v in d.items()} for s, d in batch.items()}
    total, (td, _) = make_loss_fn(model, TLossWeights())(
        tbatch, *KLW, eps=(_t(eps_g), _t(eps_l)))
    assert total.dtype == torch.float32 and set(td) == set(jd)
    for k in jd:
        got, want = float(td[k].detach()), float(jd[k])
        assert np.isfinite(got) and abs(got - want) <= VALUE_FRAC * abs(want), (
            f"{pairing} loss {k}: {got} vs {want}")
    total.backward()
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads), model)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        assert g is not None and g.dtype == torch.float32 and torch.isfinite(g).all(), name
    bad = _grad_gaps(got, want)
    assert not bad, f"{pairing}: " + "; ".join(bad)
    # the check sees one wrong tensor, however small its gradients
    name = "decoder.egnn_1.phi_e2_kernel"
    assert any(b.startswith(name) for b in _grad_gaps({**got, name: 0 * got[name]}, want))


def _grad_gaps(got: dict, want: dict) -> list[str]:
    """The tensors whose gradient leaves JAX's on its own scale, see (d)."""
    bad = []
    for name, r in bf16_rel_gaps(got, want).items():
        limit = ZERO_GRAD_FRAC if name.endswith("key.bias") else GRAD_REL
        if not r <= limit:
            bad.append(f"{name}: {r:.3e} > {limit}")
    return bad
