"""Data and tensor parallelism of the port (``protein_ensemble_vae_torch
.parallel``) on the CPU, at the JAX tests' tiny sizes:

(1) the tp layout equals the JAX package's ``tp_param_pspecs`` element for
    element, through the weight bridge's layouts;
(2) ``validate_mesh_config`` rejects JAX's bad combinations with its
    message fragments;
(3) the dp = 2 and dp = 4 x tp = 2 train step, dropout 0.1, against the
    single-process port step: loss and metrics rtol 1e-5, parameters atol
    1e-4 (``tests/test_parallel.py``'s bound), Adam's ``mu`` rtol 1e-3;
(4) the dp = 2 x tp = 2 step against the JAX single-device step on bridged
    weights, dropout 0, injected noise: loss rtol 1e-4, ``mu`` at the
    gradient tolerance of tests/test_torch_training.py, parameters within
    2 lr (its train-step bound);
(5) ``run_epoch``'s val fallback under dp = 4 (batches of 4 and 3) against
    the plain epoch;
(6) a ``cli.train --dp 2 --tp 2`` run against the single-process run of the
    same command: equal histories, and a full checkpoint that loads into a
    single-process model, equals the single-process parameters and
    generates;
(7) ``make_sharded_epoch_batches`` against the JAX function;
(8) a two-rank multi-host ``train_model`` (each rank fed its own shard)
    against the single-process loop over the concatenated shards;
(9) the port's dry run on 8 ranks prints its parity line;
(10) a failing rank and a launch past its bound fail the launch, and the
    store barrier meets across ranks.

Every multi-process case launches gloo ranks through
``parallel.mesh.launch`` (forkserver processes, one thread each, a FileStore
under ``tmp_path``, every wait bounded by 60 s) running the workers of
``parallel/dryrun.py``.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from protein_ensemble_vae_torch.cli import generate as gen_cli  # noqa: E402
from protein_ensemble_vae_torch.cli import train as train_cli  # noqa: E402
from protein_ensemble_vae_torch.config import LossWeights as TLossWeights  # noqa: E402
from protein_ensemble_vae_torch.config import ModelConfig as TModelConfig  # noqa: E402
from protein_ensemble_vae_torch.config import RunConfig as TRunConfig  # noqa: E402
from protein_ensemble_vae_torch.config import TrainConfig as TTrainConfig  # noqa: E402
from protein_ensemble_vae_torch.data import EnsembleDataset as TEnsembleDataset  # noqa: E402
from protein_ensemble_vae_torch.data import make_synthetic_dataset  # noqa: E402
from protein_ensemble_vae_torch.data.collate import (  # noqa: E402
    ConformerBatch, PairBatch)
from protein_ensemble_vae_torch.data.collate import (  # noqa: E402
    make_sharded_epoch_batches as t_sharded_batches)
from protein_ensemble_vae_torch.models import HierCVAE as THierCVAE  # noqa: E402
from protein_ensemble_vae_torch.models.bridge import params_from_flax  # noqa: E402
from protein_ensemble_vae_torch.parallel import dryrun  # noqa: E402
from protein_ensemble_vae_torch.parallel.dryrun import (  # noqa: E402
    DRYRUN_MODEL, epoch_worker, example_batch, parity_step, single_step,
    train_worker)
from protein_ensemble_vae_torch.parallel.mesh import (  # noqa: E402
    coordination_barrier, host_layout, launch, rank_device, tp_param_specs,
    validate_mesh_config)
from protein_ensemble_vae_torch.train.checkpoint import (  # noqa: E402
    load_checkpoint, load_run_config)
from protein_ensemble_vae_torch.train.training import (  # noqa: E402
    TrainState, make_train_step, run_epoch, train_model)
from protein_ensemble_vae_tpu.config import LossWeights, ModelConfig  # noqa: E402
from protein_ensemble_vae_tpu.data import EnsembleDataset as JEnsembleDataset  # noqa: E402
from protein_ensemble_vae_tpu.data.collate import (  # noqa: E402
    make_sharded_epoch_batches as j_sharded_batches)
from protein_ensemble_vae_tpu.losses import compute_total_loss  # noqa: E402
from protein_ensemble_vae_tpu.models import HierCVAE  # noqa: E402
from protein_ensemble_vae_tpu.parallel import tp_param_pspecs  # noqa: E402
from protein_ensemble_vae_tpu.train import training as JT  # noqa: E402

WAIT_S = 60
TINY = TModelConfig(**DRYRUN_MODEL)


def _launch(fn, world, spec, tmp_path):
    return launch(fn, world, (spec,), device="cpu", timeout_s=WAIT_S,
                  store_dir=str(tmp_path), collective_timeout_s=WAIT_S)


def _batch(B, L, seqemb_dim=16, seed=1):
    """The dry run's batch with a different mask on every row (a padded
    tail of 3 * r % 7 residues and a hole at r + 2), so dp ranks hold
    different normalisers, and random labels."""
    b = example_batch(seqemb_dim, B, L, seed)
    mask = b["tgt"]["mask"]
    for r in range(B):
        mask[r, L - (3 * r) % 7:] = 0.0
        mask[r, r + 2] = 0.0
    b["tgt"]["seq_labels"][:] = np.random.default_rng(seed).integers(0, 20, (B, L))
    return b


def test_tp_param_specs_match_jax():
    """Each parameter's shard of rank t under JAX's layout, carried through
    ``params_from_flax``, is the port's shard of rank t."""
    inp = jax.tree_util.tree_map(jnp.asarray, example_batch(16, 2, 16)["inp"])
    jmodel = HierCVAE(ModelConfig(**DRYRUN_MODEL))
    params = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0),
                                          "reparam": jax.random.PRNGKey(1)},
                            inp["seq_emb"], inp["n"], inp["ca"], inp["c"],
                            inp["dihedrals"], inp["mask"])["params"]

    def shard_ids(spec, leaf):
        """Which of 2 tp shards holds each element (-1: every shard)."""
        ids = np.full(leaf.shape, -1.0, np.float32)
        for axis, name in enumerate(spec):
            if name == "tp":
                n = leaf.shape[axis]
                shape = [1] * leaf.ndim
                shape[axis] = n
                ids = np.broadcast_to((np.arange(n) // (n // 2)).reshape(shape),
                                      leaf.shape).astype(np.float32)
        return ids

    ids = jax.tree_util.tree_map(shard_ids, tp_param_pspecs(params), params,
                                 is_leaf=lambda x: isinstance(x, P))
    tmodel = THierCVAE(TINY)
    want = params_from_flax(ids, tmodel)
    specs = tp_param_specs(tmodel)
    assert set(specs) == set(want)
    for name, dim in specs.items():
        shape = tuple(want[name].shape)
        if dim is None:
            got = np.full(shape, -1.0, np.float32)
        else:
            idx = np.arange(shape[dim]) // (shape[dim] // 2)
            got = np.broadcast_to(idx.reshape([-1 if i == dim else 1
                                               for i in range(len(shape))]), shape)
        np.testing.assert_array_equal(got, want[name].numpy(), err_msg=name)
    sharded = {n for n, d in specs.items() if d is not None}
    assert len(sharded) == 2 * 6 + 2 * 4 + 2 * 8   # layers, 2 pools, EGNN layers


def test_validate_mesh_config_rejects_bad_combos():
    validate_mesh_config(4, 2, 8, TINY, n_devices=8)
    validate_mesh_config(1, 1, 2, TINY, n_devices=1)
    with pytest.raises(ValueError, match="not divisible by dp"):
        validate_mesh_config(4, 1, 6, TINY, n_devices=8)
    with pytest.raises(ValueError, match="devices"):
        validate_mesh_config(8, 2, 16, TINY, n_devices=8)
    with pytest.raises(ValueError, match="geometric"):
        validate_mesh_config(2, 4, 8, TINY, n_devices=8)
    with pytest.raises(ValueError, match="heads"):
        validate_mesh_config(1, 3, 3, TINY, n_devices=8)


# (cards on each host, ranks on each host, ranks laid out host by host) ->
# every rank's device index and the world's backend
LAYOUTS = [
    ((8,), (4,), [0, 1, 2, 3], "nccl"),               # one host, a card per rank
    ((1,), (2,), [0, 0], "gloo"),                     # two ranks share one card
    ((8, 8), (8, 8), list(range(8)) * 2, "nccl"),     # 2 hosts x 8 cards, 16 ranks
    ((8, 1), (8, 2), list(range(8)) + [0, 0], "gloo"),  # one host short of cards
]


@pytest.mark.parametrize("cards,ranks,want,backend", LAYOUTS)
def test_rank_device_rule(cards, ranks, want, backend, monkeypatch):
    """Each rank's card and the backend from the ranks' posts (host name,
    card count) under multi-host, and from (rank, world) on one host."""
    posts = [(f"host{h}", n) for h, (n, k) in enumerate(zip(cards, ranks))
             for _ in range(k)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    got = []
    for rank, (host, n) in enumerate(posts):
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=n: n)
        dev, be = rank_device("cuda", *host_layout(posts, rank))
        assert be == backend, rank
        got.append(dev.index)
        if len(cards) == 1:
            assert rank_device("cuda", rank, len(posts)) == (dev, backend)
    assert got == want
    assert rank_device("cpu", 0, 4) == (torch.device("cpu"), "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_device("cuda", 0, 1)


@pytest.mark.parametrize("dp,tp", [(2, 1), (4, 2)])
def test_sharded_step_matches_single_process(dp, tp, tmp_path):
    model = dict(DRYRUN_MODEL, use_pallas_egnn="auto" if tp == 1 else False)
    spec = dict(model=model, seed=0, rng=5, consts=(1.0, 0.5, 1e-4), dp=dp,
                tp=tp, device="cpu", batch=_batch(8, 16))
    assert TModelConfig(**model).dropout == 0.1
    ref = single_step(spec)
    ranks = _launch(parity_step, dp * tp, spec, tmp_path)
    assert [r["rank"] for r in ranks] == list(range(dp * tp))
    assert all(r["backend"] == "gloo" for r in ranks)
    got = ranks[0]
    for r in ranks:
        assert r["metrics"] == got["metrics"], r["rank"]  # one global result
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert set(got["params"]) == set(ref["params"])
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["mu"], ref["mu"], rtol=1e-3,
                               atol=1e-5 * np.abs(ref["mu"]).max())


SMALL = dict(seqemb_dim=12, d_model=32, nhead=4, ff=64, nlayers=1, z_global=16,
             z_local=8, decoder_hidden=16, decoder_layers=2, max_neighbors=4,
             dropout=0.0, use_pallas_egnn=False)
KLW = (0.7, 0.3)


def test_sharded_step_matches_jax_step(tmp_path):
    """dp = 2 x tp = 2 against JAX's value_and_grad + ``make_optimizer``
    update on the same weights, batch and noise."""
    B, L, lr = 4, 24, 1e-3
    batch = _batch(B, L, SMALL["seqemb_dim"], seed=3)
    rng = np.random.default_rng(4)
    eps = (rng.normal(0, 1, (B, SMALL["z_global"])).astype(np.float32),
           rng.normal(0, 1, (B, L, SMALL["z_local"])).astype(np.float32))
    jmodel = HierCVAE(ModelConfig(**SMALL))
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    inp, tgt = jb["inp"], jb["tgt"]
    shapes = jax.eval_shape(
        jmodel.init, {"params": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)},
        inp["seq_emb"], inp["n"], inp["ca"], inp["c"], inp["dihedrals"], tgt["mask"])

    def init(path, leaf):
        """Random weights at init scale (no JAX init to compile)."""
        name = str(path[-1].key)
        if leaf.ndim < 2 and name != "scale":
            return jnp.asarray(0.05 * rng.normal(0, 1, leaf.shape), jnp.float32)
        if name == "scale":
            return jnp.asarray(1 + 0.1 * rng.normal(0, 1, leaf.shape), jnp.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if leaf.ndim == 3 and \
            str(path[-2].key) == "out" else leaf.shape[0]
        return jnp.asarray(rng.normal(0, fan_in ** -0.5, leaf.shape), jnp.float32)

    params = jax.tree_util.tree_map_with_path(init, shapes["params"])

    def loss(p):
        v = {"params": p}
        mask = tgt["mask"]
        _, _, mu_g, lv_g, mu_l, lv_l = jmodel.apply(
            v, inp["seq_emb"], inp["n"], inp["ca"], inp["c"], inp["dihedrals"],
            mask, method=HierCVAE.encode, rngs={"reparam": jax.random.PRNGKey(0)})
        z_g = mu_g + eps[0] * jnp.exp(0.5 * jnp.clip(lv_g, -10.0, 10.0))
        z_l = mu_l + eps[1] * jnp.exp(0.5 * jnp.clip(lv_l, -10.0, 10.0))
        pn, pca, pc, pseq = jmodel.apply(v, z_g, z_l, mask, method=HierCVAE.decode)
        return compute_total_loss(pn, pca, pc, pseq, tgt["n"], tgt["ca"], tgt["c"],
                                  tgt["seq_labels"], mask, mu_g, lv_g, mu_l, lv_l,
                                  tgt["dihedrals"], *KLW, weights=LossWeights(),
                                  use_pallas=False)["total"]

    tx = JT.make_optimizer()

    @jax.jit
    def step(p):
        total, grads = jax.value_and_grad(loss)(p)
        upd, opt_state = tx.update(grads, tx.init(p), p)
        return total, opt_state, optax.apply_updates(
            p, jax.tree_util.tree_map(lambda u: -lr * u, upd))

    jtotal, opt_state, jparams = step(params)

    tmodel = THierCVAE(TModelConfig(**SMALL))
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    weights = {k: v.numpy() for k, v in params_from_flax(as_np(params), tmodel).items()}
    spec = dict(model=SMALL, weights=weights, rng=0, consts=(*KLW, lr), dp=2, tp=2,
                device="cpu", batch=batch, eps=eps)
    got = _launch(parity_step, 4, spec, tmp_path)[0]
    np.testing.assert_allclose(got["loss"], float(jtotal), rtol=1e-4)

    want_mu = params_from_flax(as_np(opt_state.inner_state[1].mu), tmodel)
    tmodel.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    state = TrainState.create(tmodel)
    mu = dict(zip(state.names, state.views(torch.from_numpy(got["mu"]))))
    want_p = params_from_flax(as_np(jparams), tmodel)
    for name, w in want_mu.items():
        atol = max(1e-5 * float(w.abs().max()), 1e-7)
        np.testing.assert_allclose(mu[name].numpy(), w.numpy(), rtol=1e-3, atol=atol,
                                   err_msg=name)
        np.testing.assert_allclose(got["params"][name], want_p[name].numpy(), rtol=0,
                                   atol=2 * lr + 1e-6, err_msg=name)


def _pair_batch(B, L, seed):
    r = np.random.default_rng(seed)
    conf = ConformerBatch(
        n=r.normal(0, 3, (B, L, 3)).astype(np.float32),
        ca=r.normal(0, 3, (B, L, 3)).astype(np.float32),
        c=r.normal(0, 3, (B, L, 3)).astype(np.float32),
        mask=np.ones((B, L), np.float32),
        seq_emb=r.normal(0, 1, (B, L, TINY.seqemb_dim)).astype(np.float32),
        dihedrals=r.normal(0, 1, (B, L, 6)).astype(np.float32),
        seq_labels=np.zeros((B, L), np.int32))
    return PairBatch(inp=conf, tgt=conf)


def test_run_epoch_val_fallback_covers_partial_batches(tmp_path):
    """dp = 4: the batch of 4 is sharded, the batch of 3 runs whole on every
    rank; the epoch's statistics are the plain epoch's."""
    batches = [_pair_batch(4, 16, 10), _pair_batch(3, 16, 11)]   # 3 % 4 != 0
    spec = dict(model=DRYRUN_MODEL, seed=0, rng=7, consts=(1.0, 0.5, 1e-4), dp=4,
                tp=1, device="cpu", batches=batches)
    stats = _launch(epoch_worker, 4, spec, tmp_path)
    torch.manual_seed(0)
    model = THierCVAE(TINY)
    plain = make_train_step(model, TLossWeights(), train=False)
    _, ref = run_epoch(TrainState.create(model), plain, iter(batches), 7, 1.0, 0.5,
                       1e-4, TINY.seqemb_dim)
    assert all(s == stats[0] for s in stats)
    assert np.isfinite(stats[0]["loss"])
    for k in ("loss", "rec", "seq_acc", "clash"):
        np.testing.assert_allclose(stats[0][k], ref[k], rtol=1e-5, err_msg=k)


CLI_TINY = ["--use_seqemb", "--batch_size", "2", "--lr", "1e-5", "--d_model", "32",
            "--nhead", "4", "--ff", "64", "--nlayers", "1", "--z_global", "16",
            "--z_local", "8", "--decoder_hidden", "16", "--decoder_layers", "2",
            "--max_neighbors", "4", "--epochs", "1", "--device", "cpu"]


def test_cli_dp2_tp2_checkpoint_matches_single_process(tmp_path):
    """6 train pairs in batches of 2 (no remainder to drop) and 3 val pairs
    (the last batch of 1 runs whole on every rank): the sharded run's
    history is the single-process run's, and its checkpoint holds the full
    parameters, within 1e-4 of the single-process run's after 3 steps at lr
    1e-5 (Adam moves a parameter by at most ~lr per step)."""
    tr, va = make_synthetic_dataset(str(tmp_path / "data"), n_proteins=2, K=3,
                                    lengths=(24,), seqemb_dim=16, seed=7)
    base = ["--manifest_train", tr, "--manifest_val", va, *CLI_TINY]
    one, sharded = tmp_path / "one", tmp_path / "dp2tp2"
    hist = train_cli.main(base + ["--save", str(one)])
    assert train_cli.main(base + ["--save", str(sharded), "--dp", "2", "--tp", "2"]) is None
    a = torch.load(one / "final" / "state.pt", weights_only=True)
    b = torch.load(sharded / "final" / "state.pt", weights_only=True)
    assert {k: v.shape for k, v in a["model"].items()} == \
        {k: v.shape for k, v in b["model"].items()}
    for k, v in a["model"].items():
        np.testing.assert_allclose(b["model"][k].numpy(), v.numpy(), rtol=0, atol=1e-4,
                                   err_msg=k)
    assert b["train"]["mu"].shape == a["train"]["mu"].shape and b["train"]["step"] == 3
    with open(sharded / "final" / "history.json") as f:
        hist_b = json.load(f)
    for split in ("train", "val"):
        for k, vals in hist[split].items():
            np.testing.assert_allclose(hist_b[split][k], vals, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{split} {k}")
    model = load_checkpoint(str(sharded / "final"),
                            THierCVAE(load_run_config(str(sharded / "final")).model))
    assert all(torch.isfinite(p).all() for p in model.parameters())
    out = tmp_path / "gen"
    gen_cli.main(["--checkpoint", str(sharded / "final"), "--manifest", va,
                  "--output_dir", str(out), "--num_samples", "2",
                  "--max_structures", "1", "--device", "cpu"])
    assert any(p.endswith("_ensemble.pdb") for p in os.listdir(out))


@pytest.fixture(scope="module")
def mh_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mh_data"))
    # one protein, K=7 -> 21 pairs -> 5 chunks of 4 -> 2 chunks per process
    make_synthetic_dataset(root, n_proteins=1, K=7, lengths=(16,), seqemb_dim=8,
                           seed=3)
    return os.path.join(root, "manifest_train.csv")


def test_sharded_epoch_batches_match_jax(mh_dataset):
    tds = TEnsembleDataset(mh_dataset, use_seqemb=True)
    jds = JEnsembleDataset(mh_dataset, use_seqemb=True)
    for shuffle in (True, False):
        for i in range(2):
            got = list(t_sharded_batches(tds, 4, (16,), shuffle, 7, process_index=i,
                                         process_count=2))
            want = list(j_sharded_batches(jds, 4, (16,), shuffle, 7, process_index=i,
                                          process_count=2))
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                for side in ("inp", "tgt"):
                    for k, v in getattr(w, side).as_dict().items():
                        np.testing.assert_array_equal(getattr(getattr(g, side), k), v,
                                                      err_msg=f"{side}.{k}")


MH_MODEL = dict(seqemb_dim=8, d_model=16, nhead=2, ff=32, nlayers=1, z_global=8,
                z_local=4, decoder_hidden=8, decoder_layers=1, max_neighbors=2)


def test_two_process_train_model_loop(mh_dataset, tmp_path):
    """Two ranks, each fed its own shard (``--multihost``'s data path), for
    2 epochs against ``train_model`` in one process over the global batches
    (the two shards of each step, in rank order)."""
    train = TTrainConfig(batch_size=4, epochs=2, lr=1e-4, seed=7, bucket_sizes=(16,),
                         kl_schedule="cyclical", dp=2, tp=1)
    cfg = TRunConfig(model=TModelConfig(**MH_MODEL), loss=TLossWeights(), train=train)
    spec = dict(run_config=cfg, manifests=(mh_dataset, mh_dataset), device="cpu",
                local_batches=True)
    hists = _launch(train_worker, 2, spec, tmp_path)

    def global_batches(ds, batch_size, buckets, shuffle, seed, drop_remainder=True):
        shards = [list(t_sharded_batches(ds, batch_size, buckets, shuffle, seed,
                                         process_index=i, process_count=2))
                  for i in range(2)]
        for a, b in zip(*shards):
            yield PairBatch(*(ConformerBatch(**{
                k: np.concatenate([getattr(getattr(a, s), k), getattr(getattr(b, s), k)])
                for k in getattr(a, s).as_dict()}) for s in ("inp", "tgt")))

    torch.manual_seed(0)
    model = THierCVAE(cfg.model)
    ds = TEnsembleDataset(mh_dataset, use_seqemb=True)
    _, ref = train_model(model, ds, ds, dataclasses.replace(
        cfg, train=dataclasses.replace(train, dp=1)), make_batches=global_batches)
    assert hists[0] == hists[1]
    for split in ("train", "val"):
        assert len(hists[0][split]["loss"]) == 2
        for k, vals in ref[split].items():
            np.testing.assert_allclose(hists[0][split][k], vals, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{split} {k}")


def test_dryrun_prints_parity_line(capsys):
    dryrun.main(["8", "--device", "cpu", "--timeout", str(WAIT_S)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.fullmatch(r"\[dryrun_multichip\] mesh dp=4 tp=2: one train step OK, "
                     r"sharded loss=([\d.]+) == single-device loss=([\d.]+) "
                     r"\(rtol 1e-5 parity\)", line)
    assert m, line
    np.testing.assert_allclose(float(m[1]), float(m[2]), rtol=1e-5)


def test_dryrun_runs_on_the_card_unless_asked(monkeypatch):
    """Like the CLIs, the dry run defaults to CUDA and raises without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["2"])


def test_dryrun_multichip_defaults_to_the_card(monkeypatch, tmp_path):
    """``dryrun_multichip`` (the JAX entry's counterpart) runs on the card
    unless asked for the CPU: without one it raises, and on the CPU it
    returns the parity line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)
    line = dryrun.dryrun_multichip(2, "cpu", WAIT_S, store_dir=str(tmp_path))
    assert line.startswith("[dryrun_multichip] mesh dp=2 tp=1: one train step OK"), line


def test_launch_takes_no_default_device():
    import inspect

    param = inspect.signature(launch).parameters["device"]
    assert param.default is inspect.Parameter.empty
    assert param.kind is inspect.Parameter.KEYWORD_ONLY


@pytest.mark.parametrize("case", ["rank_fails", "timeout"])
def test_launch_fails_fast(case, tmp_path):
    """A rank that raises (here: a 3 x 1 mesh asked of 2 ranks) or ranks
    that outlast the bound fail the launch, with every rank stopped."""
    import time

    if case == "rank_fails":
        spec = dict(model=DRYRUN_MODEL, dp=3, tp=1, device="cpu")
        with pytest.raises(RuntimeError, match="needs 3 ranks"):
            _launch(parity_step, 2, spec, tmp_path)
    else:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="did not finish within 2 s"):
            launch(time.sleep, 2, (60,), device="cpu", timeout_s=2,
                   store_dir=str(tmp_path))
        assert time.monotonic() - t0 < 30


def test_coordination_barrier(tmp_path):
    """A no-op in one process; across ranks, a store barrier every rank
    passes."""
    coordination_barrier("single-process-noop", timeout_s=1)
    assert launch(coordination_barrier, 3, ("ranks-meet", WAIT_S), device="cpu",
                  timeout_s=WAIT_S, store_dir=str(tmp_path)) == [None] * 3


def _session_processes(sid: int) -> list[int]:
    """The live processes of session ``sid`` (zombies are already ended)."""
    found = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] != "Z" and int(fields[3]) == sid:
            found.append(int(name))
    return found


@pytest.mark.skipif(not os.path.isdir("/proc"), reason="reads the process table in /proc")
def test_launching_program_leaves_no_process(tmp_path):
    """A program that launched ranks leaves no process of its own behind
    when it exits: the rank server and the resource tracker are stopped.
    (Its output goes to a file: a pipe would wait for every process that
    holds it, not for the program.)"""
    import subprocess
    import sys

    code = ("import os; from protein_ensemble_vae_torch.parallel.mesh import launch; "
            f"print(len(set(launch(os.getpid, 2, device='cpu', timeout_s={WAIT_S}))))")
    with open(tmp_path / "out.txt", "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", code], stdout=f,
                                start_new_session=True)
        proc.wait(timeout=WAIT_S)
    left = _session_processes(proc.pid)
    out = (tmp_path / "out.txt").read_text()
    for pid in left:
        os.kill(pid, 9)
    assert proc.returncode == 0 and out.strip() == "2", out
    assert not left, f"processes left after the program ended: {left}"
