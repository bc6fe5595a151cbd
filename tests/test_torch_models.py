"""HierCVAE parity: the PyTorch port against the JAX package, through the
Flax -> torch weight bridge, at a small width on the CPU.

Inputs, latents and noise are made with numpy from a seed and handed to
both sides as numpy arrays.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from protein_ensemble_vae_torch.config import ModelConfig as TModelConfig  # noqa: E402
from protein_ensemble_vae_torch.models import HierCVAE as THierCVAE  # noqa: E402
from protein_ensemble_vae_torch.models.bridge import params_from_flax  # noqa: E402
from protein_ensemble_vae_tpu.config import ModelConfig  # noqa: E402
from protein_ensemble_vae_tpu.models import HierCVAE  # noqa: E402

SMALL = dict(seqemb_dim=12, d_model=32, nhead=4, ff=64, nlayers=1,
             z_global=16, z_local=8, decoder_hidden=16, decoder_layers=2,
             max_neighbors=4, use_pallas_egnn=False)
B, L = 2, 40

# Encoder and decoder sums run through LayerNorm, softmax and 2 EGNN layers
# whose fp32 sums are ordered differently by XLA and by torch: 1e-4 covers
# that and still fails any layout or init mistake by orders of magnitude.
RTOL = ATOL = 1e-4


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    mask = np.ones((B, L), np.float32)
    mask[0, -7:] = 0.0          # padded tail
    mask[1, [3, 11, 12]] = 0.0  # holes
    return dict(seq_emb=f(B, L, SMALL["seqemb_dim"]), n=3 * f(B, L, 3),
                ca=3 * f(B, L, 3), c=3 * f(B, L, 3),
                dih=np.clip(f(B, L, 6), -1, 1), mask=mask)


@pytest.fixture(scope="module")
def pair():
    x = _inputs()
    jmodel = HierCVAE(ModelConfig(**SMALL))
    variables = jax.jit(jmodel.init)(   # one compile, not one per op
        {"params": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)},
        x["seq_emb"], x["n"], x["ca"], x["c"], x["dih"], x["mask"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    torch.manual_seed(0)
    tmodel = THierCVAE(TModelConfig(**SMALL))
    tmodel.load_state_dict(params_from_flax(params, tmodel))
    tmodel.eval().requires_grad_(False)
    return jmodel, {"params": variables["params"]}, params, tmodel, x


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_encode_parity(pair):
    jmodel, variables, _, tmodel, x = pair
    args = (x["seq_emb"], x["n"], x["ca"], x["c"], x["dih"], x["mask"])
    want = jmodel.apply(variables, *args, method=HierCVAE.encode,
                        rngs={"reparam": jax.random.PRNGKey(5)})
    got = tmodel.encode(*map(_t, args))
    for g, w in zip(got[2:], want[2:]):     # mu_g, lv_g, mu_l, lv_l
        _close(g, w)


def test_decode_parity(pair):
    jmodel, variables, _, tmodel, x = pair
    rng = np.random.default_rng(9)
    z_g = rng.normal(0, 1, (B, SMALL["z_global"])).astype(np.float32)
    z_l = rng.normal(0, 1, (B, L, SMALL["z_local"])).astype(np.float32)
    want = jmodel.apply(variables, z_g, z_l, x["mask"], method=HierCVAE.decode)
    got = tmodel.decode(_t(z_g), _t(z_l), _t(x["mask"]))
    for g, w in zip(got, want):             # N, CA, C, seq logits
        _close(g, w)
    # padded positions emit zeros
    assert float(got[1][0, -7:].abs().max()) == 0.0


def test_forward_parity_with_injected_eps(pair):
    jmodel, variables, _, tmodel, x = pair
    rng = np.random.default_rng(21)
    eps_g = rng.normal(0, 1, (B, SMALL["z_global"])).astype(np.float32)
    eps_l = rng.normal(0, 1, (B, L, SMALL["z_local"])).astype(np.float32)
    args = (x["seq_emb"], x["n"], x["ca"], x["c"], x["dih"], x["mask"])
    _, _, mu_g, lv_g, mu_l, lv_l = jmodel.apply(
        variables, *args, method=HierCVAE.encode,
        rngs={"reparam": jax.random.PRNGKey(0)})
    z_g = mu_g + eps_g * jnp.exp(0.5 * jnp.clip(lv_g, -10.0, 10.0))
    z_l = mu_l + eps_l * jnp.exp(0.5 * jnp.clip(lv_l, -10.0, 10.0))
    dec = jmodel.apply(variables, z_g, z_l, x["mask"], method=HierCVAE.decode)
    want = tuple(dec) + (mu_g, lv_g, mu_l, lv_l)
    got = tmodel(*map(_t, args), eps=(_t(eps_g), _t(eps_l)))
    assert len(got) == 8
    for g, w in zip(got, want):
        _close(g, w)


def test_bridge_raises_on_missing_or_extra_key(pair):
    _, _, params, tmodel, _ = pair
    import copy
    missing = copy.deepcopy(params)
    del missing["decoder"]["egnn_1"]["phi_x2_bias"]
    with pytest.raises(KeyError, match="phi_x2_bias"):
        params_from_flax(missing, tmodel)
    extra = copy.deepcopy(params)
    extra["decoder"]["stray"] = {"kernel": np.zeros((2, 2), np.float32),
                                 "bias": np.zeros(2, np.float32)}
    with pytest.raises(KeyError, match="stray"):
        params_from_flax(extra, tmodel)


def test_fresh_init_tree_matches_flax(pair):
    _, _, params, _, _ = pair
    torch.manual_seed(1)
    fresh = THierCVAE(TModelConfig(**SMALL)).state_dict()
    bridged = params_from_flax(params, THierCVAE(TModelConfig(**SMALL)))
    assert sorted(fresh) == sorted(bridged)
    for k in fresh:
        assert tuple(fresh[k].shape) == tuple(bridged[k].shape), k
    # the overrides carried over: logvar bias -2, zero-bias l2c_out, the
    # 0.1-scaled l2c_out weight, the residual scale 0.1
    assert torch.all(fresh["encoder.latent.global_out.bias"][16:] == -2.0)
    assert torch.all(fresh["decoder.l2c_out.bias"] == 0.0)
    assert float(fresh["decoder.l2c_out.weight"].abs().max()) <= 0.1 / np.sqrt(8)
    assert float(fresh["encoder.enc.geom_res_scale"]) == pytest.approx(0.1)
    # the split edge layer uses the joint fan-in 2H+1
    bound = 1.0 / np.sqrt(2 * 16 + 1)
    assert float(fresh["decoder.egnn_0.phi_e1_hi_kernel"].abs().max()) <= bound
