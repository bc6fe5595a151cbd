"""Visualization of the port (``protein_ensemble_vae_torch.viz``,
``train.kl_schedulers.plot_schedules``) against the JAX package's ``viz/``:

- JAX's tests/test_viz.py cases on the port, its fixture in the port's
  layout (dotted names, ``weight [out, in]``);
- ``parameter_stats`` and ``write_parameter_summary`` on bridged weights
  against JAX's on JAX's: rows equal under the name map
  (``models.bridge.port_name``): counts, sizes, min / max equal, the
  other statistics to float32 summation order (1e-5 of the row's mean
  |value|); the summary's module block and totals equal, each tensor's
  block within the printed precision;
- ``training_curves`` on a port ``history.json`` (the JAX functions read
  the same file to the same text), ``dataset_stats`` on a port synthetic
  H5 manifest against JAX's rows, ``parameters.main`` on a port
  checkpoint, ``plot_schedules``;
- every plot returns None without matplotlib. The cases that draw skip
  without matplotlib, as JAX's module does.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from protein_ensemble_vae_torch.config import ModelConfig as TModelConfig  # noqa: E402
from protein_ensemble_vae_torch.models import HierCVAE as THierCVAE  # noqa: E402
from protein_ensemble_vae_torch.models.bridge import params_from_flax, port_name  # noqa: E402
from protein_ensemble_vae_torch.viz import parameters as TV  # noqa: E402
from protein_ensemble_vae_torch.viz import training_curves as TC  # noqa: E402
from protein_ensemble_vae_tpu.config import ModelConfig  # noqa: E402
from protein_ensemble_vae_tpu.models import HierCVAE  # noqa: E402
from protein_ensemble_vae_tpu.viz import parameters as JV  # noqa: E402
from protein_ensemble_vae_tpu.viz import training_curves as JC  # noqa: E402

try:
    import matplotlib  # noqa: F401
    HAVE_MPL = True
except ImportError:
    HAVE_MPL = False
draws = pytest.mark.skipif(not HAVE_MPL, reason="matplotlib is not installed")

SMALL = dict(seqemb_dim=12, d_model=32, nhead=4, ff=64, nlayers=1, z_global=16,
             z_local=8, decoder_hidden=16, decoder_layers=2, max_neighbors=4)
STATS = ("mean", "std", "abs_mean", "frac_zero")


@pytest.fixture(scope="module")
def params():
    """JAX's test fixture in the port's layout."""
    rng = np.random.default_rng(0)
    return {
        "encoder": {
            "seq_proj": {"weight": rng.normal(0, 0.02, (256, 640)).astype(np.float32),
                         "bias": np.zeros(256, np.float32)},
            "norm": {"weight": np.ones(256, np.float32),
                     "bias": np.zeros(256, np.float32)},
            "attn": {"query": {"weight": rng.normal(0, 0.02, (256, 256)).astype(np.float32)}},
        },
        "decoder": {
            "phi_e": {"weight": rng.normal(0, 0.1, (128, 128)).astype(np.float32),
                      "bias": rng.normal(0, 0.01, 128).astype(np.float32)},
        },
    }


def test_parameter_stats_rows(params):
    rows = TV.parameter_stats(params)
    names = {r["name"] for r in rows}
    assert "encoder.seq_proj.weight" in names and "decoder.phi_e.bias" in names
    total = sum(r["count"] for r in rows)
    assert total == 640 * 256 + 256 + 256 + 256 + 256 * 4 * 64 + 128 * 128 + 128
    for r in rows:
        assert np.isfinite([r["mean"], r["std"], r["min"], r["max"]]).all()


def test_summary_file(params, tmp_path):
    path = TV.write_parameter_summary(params, str(tmp_path / "summary.txt"), epoch=7)
    text = open(path).read()
    assert "MODEL PARAMETER SUMMARY" in text and "Checkpoint epoch: 7" in text
    assert "Parameters by module" in text
    assert "encoder" in text and "decoder" in text
    assert text.index("encoder.seq_proj.weight") < text.index("decoder.phi_e.bias")


@draws
def test_full_battery_produces_all_artifacts(params, tmp_path):
    artifacts = TV.visualize_parameters(params, str(tmp_path / "viz"), epoch=3)
    assert set(artifacts) == {
        "weight_distributions", "bias_distributions", "weight_heatmaps",
        "layer_statistics", "parameter_magnitudes", "parameter_summary"}
    for kind, path in artifacts.items():
        assert path is not None and os.path.getsize(path) > 0, kind


@draws
def test_individual_plots(params, tmp_path):
    assert TV.plot_weight_distributions(params, str(tmp_path / "w.png"))
    assert TV.plot_bias_distributions(params, str(tmp_path / "b.png"))
    assert TV.plot_weight_heatmaps(params, str(tmp_path / "h.png"))
    assert TV.plot_layer_statistics(params, str(tmp_path / "l.png"))
    assert TV.plot_parameter_magnitudes(params, str(tmp_path / "m.png"))


def test_heatmaps_none_without_2d_weights(tmp_path):
    assert TV.plot_weight_heatmaps({"m": {"bias": np.zeros(4, np.float32)}},
                                   str(tmp_path / "h.png")) is None


def test_heatmaps_show_jax_orientation():
    """A [out, in] weight is drawn [in, out], as JAX draws its kernel."""
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    (name, shown), = [(n, a.T) for n, a in TV._flat_params({"m": {"weight": w}})]
    assert name == "m.weight" and shown.shape == (3, 2)


def test_plots_are_none_without_matplotlib(params, tmp_path, monkeypatch, capsys):
    from protein_ensemble_vae_torch.train.kl_schedulers import plot_schedules

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    out = TV.visualize_parameters(params, str(tmp_path / "viz"))
    assert {k for k, v in out.items() if v is None} == set(out) - {"parameter_summary"}
    assert plot_schedules(10, str(tmp_path / "kl.png")) is None
    assert "[kl] matplotlib unavailable" in capsys.readouterr().out


@pytest.fixture(scope="module")
def bridged():
    """Random weights at init scale in JAX's tree (no JAX compile) and the
    same weights in a port model."""
    rng = np.random.default_rng(3)
    L = 16
    f32 = np.float32
    jmodel = HierCVAE(ModelConfig(**SMALL))
    shapes = jax.eval_shape(
        jmodel.init, {"params": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)},
        np.zeros((1, L, SMALL["seqemb_dim"]), f32), np.zeros((1, L, 3), f32),
        np.zeros((1, L, 3), f32), np.zeros((1, L, 3), f32), np.zeros((1, L, 6), f32),
        np.ones((1, L), f32))["params"]
    tree = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.05, s.shape).astype(f32) * (rng.random(s.shape) > 0.1),
        shapes)
    model = THierCVAE(TModelConfig(**SMALL))
    model.load_state_dict(params_from_flax(tree, model))
    return tree, model


def test_parameter_stats_match_jax_on_bridged_weights(bridged):
    tree, model = bridged
    want = {port_name(r["name"]): r for r in JV.parameter_stats(tree)}
    got = {r["name"]: r for r in TV.parameter_stats(model)}
    assert set(got) == set(want) == set(model.state_dict())
    for name, w in want.items():
        g = got[name]
        assert g["count"] == w["count"] == int(np.prod(g["shape"])), name
        assert (g["min"], g["max"]) == (w["min"], w["max"]), name
        for s in STATS:
            assert abs(g[s] - w[s]) <= 1e-5 * w["abs_mean"] + 1e-12, (name, s)
    assert TV.parameter_stats(model.state_dict()) == TV.parameter_stats(model)


def _summary_blocks(text: str, rename=lambda n: n):
    """(head lines, {tensor: {field: value}}) of a parameter summary."""
    head, _, detail = text.partition("DETAILED LAYER STATISTICS")
    blocks = {}
    for block in detail.strip("=\n").split("\n\n"):
        lines = block.strip().splitlines()
        if not lines:
            continue
        fields = dict(line.split(":", 1) for line in lines[1:])
        blocks[rename(lines[0].strip())] = {k.strip(): float(v.replace(",", ""))
                                            for k, v in fields.items() if k.strip() != "Shape"}
    return head, blocks


def test_parameter_summary_matches_jax_on_bridged_weights(bridged, tmp_path):
    tree, model = bridged
    want = open(JV.write_parameter_summary(tree, str(tmp_path / "j.txt"), epoch=4)).read()
    got = open(TV.write_parameter_summary(model, str(tmp_path / "t.txt"), epoch=4)).read()
    ghead, gblocks = _summary_blocks(got)
    whead, wblocks = _summary_blocks(want, port_name)
    assert ghead == whead                  # totals and the per-module block
    assert set(gblocks) == set(wblocks) == set(model.state_dict())
    for name, w in wblocks.items():
        for k, v in w.items():
            assert abs(gblocks[name][k] - v) <= 1.5e-6, (name, k)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A one-epoch port checkpoint at tiny widths (CPU)."""
    from protein_ensemble_vae_torch.cli import train as train_cli
    from protein_ensemble_vae_torch.data import make_synthetic_dataset

    root = tmp_path_factory.mktemp("viz_run")
    tr, va = make_synthetic_dataset(str(root / "data"), n_proteins=2, K=3,
                                    lengths=(24,), seqemb_dim=16, seed=7)
    train_cli.main(["--manifest_train", tr, "--manifest_val", va, "--use_seqemb",
                    "--batch_size", "4", "--d_model", "32", "--nhead", "4", "--ff", "64",
                    "--nlayers", "1", "--z_global", "16", "--z_local", "8",
                    "--decoder_hidden", "16", "--decoder_layers", "2",
                    "--max_neighbors", "4", "--epochs", "2", "--device", "cpu",
                    "--save", str(root / "ckpt")])
    return root


def test_training_curves_read_a_port_history(trained, tmp_path, capsys):
    final = trained / "ckpt" / "final"
    hist = TC.load_history_any(str(final))
    assert hist == json.loads((final / "history.json").read_text())
    assert hist == TC.load_history_any(str(final / "history.json"))
    assert TC.text_summary(hist) == JC.text_summary(hist)
    assert TC.text_summary(hist).startswith("epochs trained: 2")
    out = TC.plot_training_curves(str(final), str(tmp_path / "curves.png"))
    if HAVE_MPL:
        assert out == str(tmp_path / "curves.png") and os.path.getsize(out) > 0
    assert "epochs trained: 2" in capsys.readouterr().out


def test_parameters_main_reads_a_port_checkpoint(trained, tmp_path, monkeypatch, capsys):
    """The summary of a port checkpoint, as on the chip machine, which has no
    matplotlib (the plots are drawn by the cases above)."""
    final = str(trained / "ckpt" / "final")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    TV.main(["--checkpoint", final, "--output_dir", str(tmp_path / "p"), "--device", "cpu"])
    text = (tmp_path / "p" / "parameter_summary.txt").read_text()
    meta = json.loads((trained / "ckpt" / "final" / "meta.json").read_text())
    assert f"Checkpoint epoch: {meta['epoch']}" in text
    assert "decoder.egnn_0.phi_e2_kernel" in text
    out = capsys.readouterr().out
    assert "[params] parameter_summary:" in out
    assert "[params] weight_heatmaps: (matplotlib unavailable" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TV.main(["--checkpoint", final, "--output_dir", str(tmp_path / "q")])


def test_dataset_stats_match_jax(tmp_path):
    pytest.importorskip("h5py")
    from protein_ensemble_vae_torch.data import make_synthetic_dataset
    from protein_ensemble_vae_torch.viz import dataset_stats as TD
    from protein_ensemble_vae_tpu.viz import dataset_stats as JD

    tr, _ = make_synthetic_dataset(str(tmp_path / "data"), n_proteins=3, K=4,
                                   lengths=(24, 40), seqemb_dim=8, seed=5)
    got, want = TD.dataset_stats(tr, "cpu"), JD.dataset_stats(tr)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("h5_path", "chain", "n_conformers", "n_residues", "missing_frac"):
            assert g[k] == w[k], k
        for k in ("rmsf_mean", "rmsf_max"):
            assert abs(g[k] - w[k]) <= 1e-3 + 1e-9, k       # both rounded to 3 places
    path = TD.write_stats_csv(got, str(tmp_path / "stats.csv"))
    assert open(path).read().splitlines()[0].split(",") == list(got[0])
    TD.main(["--manifest", tr, "--output_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert (tmp_path / "out" / "chain_stats.csv").exists()


@draws
def test_plot_schedules(tmp_path, capsys):
    from protein_ensemble_vae_torch.train.kl_schedulers import plot_schedules

    out = plot_schedules(50, str(tmp_path / "kl.png"))
    assert out == str(tmp_path / "kl.png") and os.path.getsize(out) > 0
    assert f"[kl] saved {out}" in capsys.readouterr().out
