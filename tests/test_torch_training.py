"""Training-step parity: the port's loss closure, optimizer, train step and
host-side helpers against the JAX package's, at the small widths of
tests/test_torch_models.py (dropout 0), weights carried over through
``params_from_flax``.

(a) loss dict and parameter gradients for one batch with injected
    reparameterisation noise: loss rtol 1e-4; gradients rtol 1e-3 with
    atol 1e-5 * max|g| per tensor (fp32 through an encoder, 2 EGNN layers
    and 16 loss terms, summed in another order), floored at 1e-6 for the
    tensors whose gradient is zero analytically (the attention key biases:
    softmax is shift-invariant), where both sides hold fp32 round-off;
(b) the optimizer alone on the same numpy gradients, non-finite steps
    included: params, moments and counters rtol 1e-5;
(c) one full train step: same metric keys, finite values, and parameters
    within 2 * lr of the JAX step's. The two steps draw different noise, so
    this is the bound Adam's first update (~ lr * sign(g)) allows;
(d) KL schedules, plateau LR and the epoch batchers: equal sequences and
    arrays.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from protein_ensemble_vae_torch.config import LossWeights as TLossWeights  # noqa: E402
from protein_ensemble_vae_torch.config import ModelConfig as TModelConfig  # noqa: E402
from protein_ensemble_vae_torch.data.dataset import (  # noqa: E402
    EnsembleDataset as TEnsembleDataset)
from protein_ensemble_vae_torch.data.synthetic import nerf_ensemble  # noqa: E402
from protein_ensemble_vae_torch.models import HierCVAE as THierCVAE  # noqa: E402
from protein_ensemble_vae_torch.models.bridge import params_from_flax  # noqa: E402
from protein_ensemble_vae_torch.train import kl_schedulers as TKL  # noqa: E402
from protein_ensemble_vae_torch.train.lr_schedule import (  # noqa: E402
    ReduceLROnPlateau as TPlateau)
from protein_ensemble_vae_torch.train.training import (  # noqa: E402
    EPOCH_METRICS, Optimizer, TrainState, make_loss_fn, make_train_step)
from protein_ensemble_vae_tpu.config import LossWeights, ModelConfig  # noqa: E402
from protein_ensemble_vae_tpu.losses import compute_total_loss  # noqa: E402
from protein_ensemble_vae_tpu.models import HierCVAE  # noqa: E402
from protein_ensemble_vae_tpu.train import kl_schedulers as JKL  # noqa: E402
from protein_ensemble_vae_tpu.train import training as JT  # noqa: E402
from protein_ensemble_vae_tpu.train.lr_schedule import ReduceLROnPlateau  # noqa: E402

SMALL = dict(seqemb_dim=12, d_model=32, nhead=4, ff=64, nlayers=1,
             z_global=16, z_local=8, decoder_hidden=16, decoder_layers=2,
             max_neighbors=4, dropout=0.0, use_pallas_egnn=False)
B, L = 2, 40
KLW = (0.7, 0.3)


def _batch(seed=0):
    """Input / target conformers of one NeRF fold, padded tail on row 0."""
    from protein_ensemble_vae_torch.data.synthetic import _torsions_np

    n, ca, c = nerf_ensemble(L - 6, 2, seed=seed, max_tries=16)
    rng = np.random.default_rng(seed)
    out = {}
    for k, side in enumerate(("inp", "tgt")):
        pad = lambda v: np.pad(v, ((0, 6), (0, 0)))  # noqa: E731
        m = np.ones(L, np.float32)
        m[-6:] = 0.0
        cen = ca[k][:L - 6].mean(0)
        nn_, cca, cc = (pad(v[k] - cen) for v in (n, ca, c))
        rows = dict(n=nn_, ca=cca, c=cc, mask=m,
                    dihedrals=_torsions_np(nn_, cca, cc, m))
        batch = {key: np.stack([v, v]).astype(np.float32) for key, v in rows.items()}
        batch["mask"][1, :] = 1.0                  # row 1 has no padding
        batch["mask"][1, 9] = 0.0                  # but a hole
        batch["seq_emb"] = rng.normal(0, 1, (B, L, SMALL["seqemb_dim"])).astype(np.float32)
        batch["seq_labels"] = rng.integers(0, 20, (B, L)).astype(np.int32)
        out[side] = batch
    return out


def _to_torch(batch):
    return {s: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
            for s, d in batch.items()}


@pytest.fixture(scope="module")
def setup():
    batch = _batch()
    jmodel = HierCVAE(ModelConfig(**SMALL))
    inp = batch["inp"]
    variables = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)},
        inp["seq_emb"], inp["n"], inp["ca"], inp["c"], inp["dihedrals"],
        batch["tgt"]["mask"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])

    def tmodel():
        torch.manual_seed(0)
        m = THierCVAE(TModelConfig(**SMALL))
        m.load_state_dict(params_from_flax(params, m))
        return m

    return jmodel, variables["params"], params, tmodel, batch


def _eps(seed=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, SMALL["z_global"])).astype(np.float32),
            rng.normal(0, 1, (B, L, SMALL["z_local"])).astype(np.float32))


def _jax_loss(jmodel, weights):
    def loss(params, batch, eps_g, eps_l):
        inp, tgt = batch["inp"], batch["tgt"]
        mask = tgt["mask"]
        v = {"params": params}
        _, _, mu_g, lv_g, mu_l, lv_l = jmodel.apply(
            v, inp["seq_emb"], inp["n"], inp["ca"], inp["c"], inp["dihedrals"],
            mask, method=HierCVAE.encode, rngs={"reparam": jax.random.PRNGKey(0)})
        z_g = mu_g + eps_g * jnp.exp(0.5 * jnp.clip(lv_g, -10.0, 10.0))
        z_l = mu_l + eps_l * jnp.exp(0.5 * jnp.clip(lv_l, -10.0, 10.0))
        pn, pca, pc, pseq = jmodel.apply(v, z_g, z_l, mask, method=HierCVAE.decode)
        d = compute_total_loss(pn, pca, pc, pseq, tgt["n"], tgt["ca"], tgt["c"],
                               tgt["seq_labels"], mask, mu_g, lv_g, mu_l, lv_l,
                               tgt["dihedrals"], *KLW, weights=weights,
                               use_pallas=False)
        return d["total"], d

    return loss


@pytest.mark.parametrize("weights", [{}, {"w_ca_spacing": 100.0, "w_clash_vdw": 3.0}])
def test_loss_and_gradients_match_jax(setup, weights):
    jmodel, jparams, params, tmodel, batch = setup
    eps_g, eps_l = _eps()
    (jtotal, jd), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss(jmodel, LossWeights(**weights)), has_aux=True))(
        jparams, batch, eps_g, eps_l)
    model = tmodel().train()
    loss_fn = make_loss_fn(model, TLossWeights(**weights))
    total, (td, _) = loss_fn(_to_torch(batch), *KLW,
                             eps=(torch.from_numpy(eps_g), torch.from_numpy(eps_l)))
    assert set(td) == set(jd)
    for k in jd:
        np.testing.assert_allclose(float(td[k].detach()), float(jd[k]), rtol=1e-4,
                                   err_msg=k)
    total.backward()
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads), model)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].grad
        assert g is not None and torch.isfinite(g).all(), name
        atol = max(1e-5 * float(w.abs().max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3,
                                   atol=atol, err_msg=name)


class _Leaves(torch.nn.Module):
    def __init__(self, leaves):
        super().__init__()
        self.p = torch.nn.ParameterList(
            [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in leaves])


@pytest.mark.parametrize("max_errors", [100, 2])
def test_optimizer_matches_optax(max_errors):
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(0, 1, (3, 4)).astype(np.float32),
            "b": rng.normal(0, 1, (5,)).astype(np.float32),
            "c": rng.normal(0, 1, (2, 2, 2)).astype(np.float32)}
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    # gradient scales: clipped (norm > 10), unclipped, non-finite x3, normal
    plan = [30.0, 0.5, np.nan, np.inf, np.nan, 1.0]
    grads = []
    for k, s in enumerate(plan):
        g = [rng.normal(0, abs(s) if np.isfinite(s) else 1, v.shape).astype(np.float32)
             for v in leaves]
        if not np.isfinite(s):
            g[k % 3].flat[1] = s
        grads.append(g)
    lr = 1e-2
    tx = optax.apply_if_finite(optax.chain(optax.clip_by_global_norm(10.0),
                                           optax.scale_by_adam()), max_errors)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = tx.init(jparams)
    state = TrainState.create(_Leaves(leaves))
    opt = Optimizer(max_consecutive_errors=max_errors)
    for g in grads:
        jg = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(v) for v in g])
        upd, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, jax.tree_util.tree_map(lambda u: -lr * u, upd))
        before = state.flat.clone()
        opt.apply(state, state.pack([torch.from_numpy(v) for v in g]), lr)
        inner = jstate.inner_state[1]
        for mine, theirs, atol in ((state.flat, jparams, 1e-7),
                                   (state.mu, inner.mu, 1e-12),
                                   (state.nu, inner.nu, 1e-12)):
            for a, b in zip(state.views(mine), jax.tree_util.tree_leaves(theirs)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                           atol=atol)
        assert int(state.count) == int(inner.count)
        assert int(state.notfinite_count) == int(jstate.notfinite_count)
        assert int(state.total_notfinite) == int(jstate.total_notfinite)
        assert bool(state.last_finite) == bool(jstate.last_finite)
        if not bool(jstate.last_finite) and int(jstate.notfinite_count) <= max_errors:
            assert torch.equal(state.flat, before)      # skipped: unchanged
    assert int(state.total_notfinite) == 3


def test_train_step_matches_jax_step(setup):
    jmodel, jparams, params, tmodel, batch = setup
    lr = 1e-3
    lw = LossWeights()
    tx = JT.make_optimizer()
    jstate = JT.TrainState(params=jparams, opt_state=tx.init(jparams),
                           step=jnp.zeros((), jnp.int32))
    jstep = JT.make_train_step(jmodel, lw, train=True)
    jstate, jmetrics = jstep(jstate, batch, jax.random.PRNGKey(3),
                             jnp.float32(KLW[0]), jnp.float32(KLW[1]), jnp.float32(lr))
    model = tmodel()
    state = TrainState.create(model)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    step = make_train_step(model, TLossWeights(), train=True)
    consts = [torch.tensor(v) for v in (*KLW, lr)]
    state, metrics = step(state, _to_torch(batch), 3, *consts)
    assert set(metrics) == set(jmetrics)
    assert set(EPOCH_METRICS) <= set(metrics)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert state.step == 1 and int(state.count) == 1
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params), model)
    for name, p in model.named_parameters():
        moved = (p.detach() - p0[name]).abs().max()
        assert float(moved) <= lr * 1.001, name            # Adam's first step
        # 2 * lr, plus the fp32 rounding of parameters near 1 (ulp 1.2e-7)
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=2 * lr + 1e-6, err_msg=name)
    # an eval step leaves the state as it is
    flat = state.flat.clone()
    _, ev = make_train_step(model, TLossWeights(), train=False)(
        state, _to_torch(batch), 4, *consts)
    assert torch.equal(state.flat, flat) and state.step == 1
    assert float(ev["grad_norm"]) == 0.0


@pytest.mark.parametrize("schedule", ["cyclical", "monotonic", "adaptive", "exponential"])
def test_kl_schedules_match(schedule):
    kw = dict(max_weight=0.5, warmup_epochs=20, n_cycles=4, ratio=0.4)
    j = JKL.create_kl_scheduler(schedule, **kw)
    t = TKL.create_kl_scheduler(schedule, **kw)
    rmsd = np.random.default_rng(1).uniform(0.5, 3.0, 200)
    for e in range(1, 201):
        assert t.step(e, 200, val_rmsd=float(rmsd[e - 1])) == \
            j.step(e, 200, val_rmsd=float(rmsd[e - 1]))
    assert t.get_state() == j.get_state()


def test_plateau_lr_matches():
    j, t = ReduceLROnPlateau(1e-3, patience=3), TPlateau(1e-3, patience=3)
    metric = np.concatenate([np.linspace(5, 1, 10), np.full(30, 1.0),
                             np.linspace(1, 0.5, 5), np.full(20, 0.6)])
    for m in metric:
        assert t.step(float(m)) == j.step(float(m))
    assert t.get_state() == j.get_state()


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    from protein_ensemble_vae_tpu.data import EnsembleDataset, make_synthetic_dataset

    root = tmp_path_factory.mktemp("syn")
    tr, _ = make_synthetic_dataset(str(root), n_proteins=4, K=4,
                                   lengths=(24, 70, 130), seqemb_dim=8, seed=3)
    return EnsembleDataset(tr, use_seqemb=True), TEnsembleDataset(tr, use_seqemb=True)


@pytest.mark.parametrize("shuffle,drop", [(False, False), (True, False), (True, True)])
def test_epoch_batches_match(datasets, shuffle, drop):
    from protein_ensemble_vae_torch.data import collate as TC
    from protein_ensemble_vae_tpu.data import collate as JC

    jds, tds = datasets
    buckets = (64, 128, 192)
    runs = [(JC.make_epoch_batches(jds, 3, buckets, shuffle, 7, drop),
             TC.make_epoch_batches(tds, 3, buckets, shuffle, 7, drop)),
            (JC.make_prepadded_factory()(jds, 3, buckets, shuffle, 7, drop),
             TC.make_prepadded_factory()(tds, 3, buckets, shuffle, 7, drop))]
    for jb, tb in runs:
        jb, tb = list(jb), list(tb)
        assert len(jb) == len(tb) > 1
        for a, b in zip(jb, tb):
            for side in ("inp", "tgt"):
                for k, v in getattr(a, side).as_dict().items():
                    np.testing.assert_array_equal(getattr(getattr(b, side), k), v)
