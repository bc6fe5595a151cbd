"""Grad-watch dumps of the port (``protein_ensemble_vae_torch.utils.watch``,
``pev-train --watch_every``) against the JAX package's ``utils/watch.py``,
on the CPU at the small widths of tests/test_torch_training.py (dropout 0,
injected reparameterisation noise, weights through ``params_from_flax``):

(a) ``histogram_summaries`` / ``dump_watch_npz`` of the bridged parameters
    equal JAX's on JAX's parameters, key for key under the name map
    (``models.bridge.port_name``), with the same dtypes: statistics rtol
    1e-6, counts and edges equal. The gradient statistics of the port's
    ``make_param_grad_fn`` against JAX's gradient of the same loss, at the
    gradient tolerance of tests/test_torch_training.py (rtol 1e-3, atol
    1e-5 * max|g| floored at 1e-6, per element), carried to each statistic
    (min / max: rtol max|g| + atol; mean / std: rtol l2 / sqrt(n) + atol;
    l2: rtol l2 + atol sqrt(n)); every bin's count within 1 % of the
    leaf's size, rounded up, except where the whole gradient lies within
    the atol floor of zero (the attention key biases: softmax is
    shift-invariant), whose histograms are of round-off;
(b) ``cli.train --watch_every 1`` writes one dump per epoch, each with a
    ``param/`` and a ``grad/`` entry for every parameter, and a run with
    the flag equals the same run without it, bit for bit (history,
    parameters, optimizer state);
(c) a ``--dp 2 --tp 2`` run's dump equals the single-process run's, at
    the bounds tests/test_torch_parallel.py holds a sharded step to,
    carried to each statistic as above: parameters atol 1e-4; gradients
    rtol 1e-3, atol 1e-5 * the largest |g| of the whole gradient (its bound
    on Adam's mu: tp sums the analytically zero key-bias gradients in
    another order, so their round-off differs on the gradient's scale).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from protein_ensemble_vae_torch.cli import train as train_cli  # noqa: E402
from protein_ensemble_vae_torch.config import LossWeights as TLossWeights  # noqa: E402
from protein_ensemble_vae_torch.config import ModelConfig as TModelConfig  # noqa: E402
from protein_ensemble_vae_torch.data import make_synthetic_dataset  # noqa: E402
from protein_ensemble_vae_torch.models import HierCVAE as THierCVAE  # noqa: E402
from protein_ensemble_vae_torch.models.bridge import params_from_flax, port_name  # noqa: E402
from protein_ensemble_vae_torch.train.training import make_param_grad_fn  # noqa: E402
from protein_ensemble_vae_torch.utils import watch as TW  # noqa: E402
from protein_ensemble_vae_tpu.config import LossWeights, ModelConfig  # noqa: E402
from protein_ensemble_vae_tpu.models import HierCVAE  # noqa: E402
from protein_ensemble_vae_tpu.utils import watch as JW  # noqa: E402

from test_torch_training import KLW, SMALL, _batch, _eps, _jax_loss, _to_torch  # noqa: E402

STATS = ("mean", "std", "min", "max", "l2")


def _leaves(npz, prefix):
    """{name: {stat: value}} of one prefix of a loaded dump."""
    out = {}
    for k in npz.files:
        p, rest = k.split("/", 1)
        if p == prefix:
            name, stat = rest.rsplit("/", 1)
            out.setdefault(name, {})[stat] = npz[k]
    return out


def _close(got: dict, want: dict, name: str, rtol: float, atol: float) -> bool:
    """Summaries of two tensors whose elements agree to ``rtol * |w| +
    atol``, each statistic held to the bound that carries to it, and the
    counts bin by bin within 1 % of the size, rounded up, unless the whole
    tensor lies within ``atol`` of zero (then its histogram is of
    round-off, and False is returned)."""
    n = int(want["counts"].sum())
    maxabs = max(abs(float(want["min"])), abs(float(want["max"])))
    rms = float(want["l2"]) / np.sqrt(n)
    bound = {"min": rtol * maxabs + atol, "max": rtol * maxabs + atol,
             "mean": rtol * rms + atol, "std": rtol * rms + atol,
             "l2": rtol * float(want["l2"]) + atol * np.sqrt(n)}
    for s in STATS:
        assert abs(float(got[s]) - float(want[s])) <= bound[s] * (1 + 1e-6), (name, s)
    assert int(got["nonfinite"]) == int(want["nonfinite"]) == 0, name
    assert int(got["counts"].sum()) == n, name
    if maxabs <= atol:
        return False
    tol = int(np.ceil(0.01 * n))
    assert np.abs(got["counts"] - want["counts"]).max() <= tol, (name, tol)
    return True


def _grad_atol(w: dict) -> float:
    """tests/test_torch_training.py's atol: 1e-5 max|g|, floored at 1e-6."""
    return max(1e-5 * max(abs(float(w["min"])), abs(float(w["max"]))), 1e-6)


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's parameters, their bridged torch model and JAX's gradient of the
    train step's loss on one batch with injected noise (one compile)."""
    batch = _batch()
    jmodel = HierCVAE(ModelConfig(**SMALL))
    inp = batch["inp"]
    variables = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)},
        inp["seq_emb"], inp["n"], inp["ca"], inp["c"], inp["dihedrals"],
        batch["tgt"]["mask"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    eps = _eps()
    jgrads = jax.jit(jax.grad(_jax_loss(jmodel, LossWeights()), has_aux=True))(
        variables["params"], batch, *eps)[0]
    model = THierCVAE(TModelConfig(**SMALL))
    model.load_state_dict(params_from_flax(params, model))
    return params, jax.tree_util.tree_map(np.asarray, jgrads), model, batch, eps


def test_param_summaries_and_dump_match_jax(jax_reference, tmp_path):
    params, _, model, _, _ = jax_reference
    want = JW.histogram_summaries(params)
    got = TW.histogram_summaries(model)
    assert {port_name(k) for k in want} == set(got) == set(model.state_dict())
    for jname, w in want.items():
        g = got[port_name(jname)]
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["counts"], w["counts"], err_msg=jname)
        np.testing.assert_array_equal(g["edges"], w["edges"], err_msg=jname)
        for s in STATS:
            np.testing.assert_allclose(g[s], w[s], rtol=1e-6, err_msg=f"{jname} {s}")
        assert g["nonfinite"] == w["nonfinite"] == 0
    # the files: the same keys under the name map, the same dtypes
    jpath = JW.dump_watch_npz(str(tmp_path / "jax.npz"), params, params)
    tpath = TW.dump_watch_npz(str(tmp_path / "port.npz"), model.state_dict(),
                              dict(model.named_parameters()))
    jz, tz = np.load(jpath), np.load(tpath)

    def mapped(key):
        prefix, rest = key.split("/", 1)
        path, stat = rest.rsplit("/", 1)
        return f"{prefix}/{port_name(path)}/{stat}"

    assert {mapped(k) for k in jz.files} == set(tz.files)
    for k in jz.files:
        assert tz[mapped(k)].dtype == jz[k].dtype, k


def test_grad_summaries_match_jax(jax_reference):
    params, jgrads, model, batch, eps = jax_reference
    model.train()
    grads = make_param_grad_fn(model, TLossWeights())(
        _to_torch(batch), 3, *KLW, eps=tuple(torch.from_numpy(e) for e in eps))
    assert all(p.grad is None for p in model.parameters())   # nothing written
    got = TW.histogram_summaries(grads)
    want = JW.histogram_summaries(jgrads)
    assert {port_name(k) for k in want} == set(got)
    noise = [port_name(jname) for jname, w in want.items()
             if not _close(got[port_name(jname)], w, jname, 1e-3, _grad_atol(w))]
    assert noise and all(n.endswith("key.bias") for n in noise), noise


def test_grad_fn_leaves_the_module_as_it_was(jax_reference):
    """Mode restored, no ``.grad`` written, the global generator untouched,
    and the same seed gives the same gradient (dropout on)."""
    _, _, model, batch, _ = jax_reference
    m = THierCVAE(TModelConfig(**dict(SMALL, dropout=0.1)))
    m.load_state_dict(model.state_dict())
    m.eval()
    fn = make_param_grad_fn(m, TLossWeights())
    rng_state = torch.random.get_rng_state()
    a = fn(_to_torch(batch), 11, *KLW)
    b = fn(_to_torch(batch), 11, *KLW)
    c = fn(_to_torch(batch), 12, *KLW)
    assert not m.training
    assert all(p.grad is None for p in m.parameters())
    assert torch.equal(torch.random.get_rng_state(), rng_state)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)      # dropout drew anew


CLI_TINY = ["--use_seqemb", "--batch_size", "2", "--lr", "1e-5", "--d_model", "32",
            "--nhead", "4", "--ff", "64", "--nlayers", "1", "--z_global", "16",
            "--z_local", "8", "--decoder_hidden", "16", "--decoder_layers", "2",
            "--max_neighbors", "4", "--device", "cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same 2-epoch run with and without ``--watch_every 1``."""
    root = tmp_path_factory.mktemp("watch_cli")
    tr, va = make_synthetic_dataset(str(root / "data"), n_proteins=2, K=3,
                                    lengths=(24,), seqemb_dim=16, seed=7)
    base = ["--manifest_train", tr, "--manifest_val", va, *CLI_TINY]
    for save, extra in (("watched", ["--watch_every", "1"]), ("plain", [])):
        train_cli.main(base + ["--epochs", "2", "--save", str(root / save)] + extra)
    return root, base


def test_cli_watch_writes_dumps_and_leaves_the_run_as_it_was(runs):
    root, _ = runs
    watch = root / "watched" / "watch"
    assert sorted(os.listdir(watch)) == ["epoch_00001.npz", "epoch_00002.npz"]
    assert not (root / "plain" / "watch").exists()
    state = torch.load(root / "watched" / "final" / "state.pt", weights_only=True)
    names = {k for k in state["model"]}
    for f in os.listdir(watch):
        z = np.load(watch / f)
        for prefix in ("param", "grad"):
            leaves = _leaves(z, prefix)
            assert set(leaves) == names, (f, prefix)
            assert all(int(v["nonfinite"]) == 0 for v in leaves.values())
            assert all(int(v["counts"].sum()) > 0 for v in leaves.values())
    other = torch.load(root / "plain" / "final" / "state.pt", weights_only=True)
    for k, v in state["model"].items():
        assert torch.equal(v, other["model"][k]), k
    for k, v in state["train"].items():
        assert (torch.equal(v, other["train"][k]) if isinstance(v, torch.Tensor)
                else v == other["train"][k]), k
    for tag in ("final", "best"):
        a = json.loads((root / "watched" / tag / "history.json").read_text())
        b = json.loads((root / "plain" / tag / "history.json").read_text())
        assert a == b, tag


def test_cli_dp2_tp2_dump_matches_single_process(runs, tmp_path):
    root, base = runs
    save = tmp_path / "dp2tp2"
    assert train_cli.main(base + ["--epochs", "1", "--save", str(save), "--watch_every",
                                  "1", "--dp", "2", "--tp", "2"]) is None
    assert os.listdir(save / "watch") == ["epoch_00001.npz"]
    got = np.load(save / "watch" / "epoch_00001.npz")
    want = np.load(root / "watched" / "watch" / "epoch_00001.npz")
    assert set(got.files) == set(want.files)
    got_p, got_g = _leaves(got, "param"), _leaves(got, "grad")
    for name, w in _leaves(want, "param").items():
        _close(got_p[name], w, name, 0.0, 1e-4)
    want_g = _leaves(want, "grad")
    atol = 1e-5 * max(max(abs(float(w["min"])), abs(float(w["max"]))) for w in want_g.values())
    assert sum(_close(got_g[name], w, name, 1e-3, atol) for name, w in want_g.items()) \
        > len(want_g) // 2
