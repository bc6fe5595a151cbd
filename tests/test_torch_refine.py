"""Cartesian refinement of the PyTorch port (``infer/refine.py``) against
the JAX package's, on the CPU: the energy and its gradient, short Adam
trajectories, the refine CLI, and how ``generate_ensembles`` dispatches the
three refine modes.

Inputs are made with numpy from a seed and handed to both packages. Every
comparison is fp32 against fp32 with sums taken in another order; each
tolerance is stated where it is used.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from protein_ensemble_vae_torch.infer import generate as tgen  # noqa: E402
from protein_ensemble_vae_torch.infer import refine as trefine  # noqa: E402
from protein_ensemble_vae_torch.infer.pdb_io import \
    read_pdb_backbone as t_read  # noqa: E402
from protein_ensemble_vae_tpu.data.synthetic import nerf_ensemble  # noqa: E402
from protein_ensemble_vae_tpu.infer import refine as jrefine  # noqa: E402
from protein_ensemble_vae_tpu.infer.pdb_io import read_pdb_backbone  # noqa: E402
from protein_ensemble_vae_tpu.infer.pdb_io import write_multi_model_pdb  # noqa: E402

B, L, L_REAL = 2, 40, 34
# the polish pipeline's fixed Cartesian weights (JAX infer/generate.py:155)
POLISH = dict(anchor_weight=0.003, w_bond=4.0, bond_delta_scale=50.0,
              w_spacing=1.0, spacing_delta=3.0, w_angle=8.0, w_clash=5.0,
              w_rama=2.0, w_omega=2.0, w_clash_vdw=400.0)


@pytest.fixture(scope="module")
def noisy():
    """A NeRF fold, squeezed so that some pairs clash and noised so that
    bonds and torsions are broken, padded from L_REAL to L (masked tail,
    padding coordinates nonzero so that pinning is visible)."""
    n, ca, c = nerf_ensemble(L_REAL, B, seed=3)
    rng = np.random.default_rng(5)
    out = []
    for x in (n, ca, c):
        x = 0.85 * x + rng.normal(0, 0.3, x.shape)
        pad = rng.normal(0, 5.0, (B, L - L_REAL, 3))
        out.append(np.concatenate([x, pad], 1).astype(np.float32))
    mask = np.zeros((B, L), np.float32)
    mask[:, :L_REAL] = 1.0
    mask[1, L_REAL - 3:] = 0.0
    return (*out, mask)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


@pytest.mark.parametrize("rama_on,vdw_on", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_energy_and_gradient_match_jax(noisy, rama_on, vdw_on):
    """One energy and its gradient: rtol 1e-5, atol 1e-6 (fp32 against
    fp32; the clash term is the dense plain version on both sides)."""
    n, ca, c, mask = noisy
    w = {k: (v if (rama_on or k not in ("w_rama", "w_omega"))
             and (vdw_on or k != "w_clash_vdw") else 0.0)
         for k, v in POLISH.items()}
    ref = {k: jnp.asarray(v) for k, v in zip(("n", "ca", "c"), (n, ca, c))}
    coords = {k: v + 0.05 for k, v in ref.items()}

    def jax_e(co):
        return jrefine._energy(co, ref, jnp.asarray(mask),
                               {k: jnp.float32(v) for k, v in w.items()},
                               rama_on=rama_on, vdw_on=vdw_on)

    je, jg = jax.value_and_grad(jax_e)(coords)
    tco = {k: _t(np.asarray(v), grad=True) for k, v in coords.items()}
    te = trefine._energy(tco, {k: _t(v) for k, v in ref.items()}, _t(mask),
                         {k: torch.tensor(v, dtype=torch.float32) for k, v in w.items()},
                         rama_on=rama_on, vdw_on=vdw_on)
    te.backward()
    np.testing.assert_allclose(float(te.detach()), float(je), rtol=1e-5, atol=1e-6)
    for k in ("n", "ca", "c"):
        np.testing.assert_allclose(tco[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("lr_decay", [False, True])
def test_refine_backbone_20_steps_match_jax(noisy, lr_decay):
    """20 optax-adam steps with every term on: coordinates within 1e-4 A
    of the JAX package's; padded rows equal the input exactly."""
    n, ca, c, mask = noisy
    kw = dict(POLISH, steps=20, lr=0.05, lr_decay=lr_decay)
    want = [np.asarray(x) for x in jrefine.refine_backbone(n, ca, c, mask, **kw)]
    got = [x.numpy() for x in
           trefine.refine_backbone(_t(n), _t(ca), _t(c), _t(mask), **kw)]
    for name, g, w, x in zip(("n", "ca", "c"), got, want, (n, ca, c)):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=name)
        np.testing.assert_array_equal(g[mask == 0], x[mask == 0])
    # the refinement moved the valid rows
    assert np.abs(got[1] - ca)[mask > 0].max() > 1e-2


def test_adam_descent_matches_optax():
    """The loop alone on a quadratic, against optax.adam with the cosine
    schedule: the bias correction, eps outside the square root and the
    learning rate read before the count's increment."""
    import optax

    target = np.linspace(-2, 3, 12).astype(np.float32).reshape(3, 4)
    x0 = np.zeros_like(target)
    for lr_decay in (False, True):
        sched = optax.cosine_decay_schedule(0.1, 7) if lr_decay else 0.1
        tx = optax.adam(sched)
        p, st = jnp.asarray(x0), tx.init(jnp.asarray(x0))
        for _ in range(7):
            g = jax.grad(lambda q: jnp.sum((q - target) ** 4))(p)
            u, st = tx.update(g, st, p)
            p = optax.apply_updates(p, u)
        got = trefine.adam_descent(
            lambda x, k: torch.sum((x - k["t"]) ** 4), torch.tensor(x0),
            {"t": torch.tensor(target)}, 0.1, steps=7, lr_decay=lr_decay,
            key=("quartic",))
        np.testing.assert_allclose(got.numpy(), np.asarray(p), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="CUDA"):
        trefine.adam_descent(lambda x, k: x.sum(), torch.zeros(2), {}, 0.1,
                             steps=1, lr_decay=False, key=("x",), graph=True)


@pytest.mark.parametrize("torsion", [False, True])
def test_refine_cli_matches_jax(noisy, tmp_path, capsys, monkeypatch, torsion):
    """``cli.refine --device cpu`` against the JAX package's ``cli.refine``
    on a heterogeneous two-model file: the same report lines, the same
    title, coordinates within 1e-3 A (the precision of a PDB file)."""
    from protein_ensemble_vae_torch.cli.refine import main as tmain
    from protein_ensemble_vae_tpu.cli.refine import main as jmain

    monkeypatch.setenv("PEV_COMPILE_CACHE", "off")
    n, ca, c, mask = noisy
    mask_k = mask[:, :L_REAL].copy()
    mask_k[1, -2:] = 0.0             # model 2 lacks the last two residues
    src = str(tmp_path / "in.pdb")
    write_multi_model_pdb(n[:, :L_REAL], ca[:, :L_REAL], c[:, :L_REAL], mask_k,
                          src, sequence="ACDEFGHIKLMNPQRSTVWY" * 2)
    extra = ["--steps", "12", "--w_clash_vdw", "50"] + (["--torsion"] if torsion
                                                          else ["--lr_decay"])
    outs = {}
    for tag, main, argv in (("jax", jmain, []), ("torch", tmain, ["--device", "cpu"])):
        out = str(tmp_path / f"{tag}.pdb")
        main(["--input", src, "--output", out] + extra + argv)
        lines = capsys.readouterr().out.splitlines()
        outs[tag] = (read_pdb_backbone(out), [l for l in lines if l.startswith("[refine]")],
                     open(out).read().splitlines()[:3])
    (j, jl, jh), (t, tl, th) = outs["jax"], outs["torch"]
    assert [l.replace("jax.pdb", "X") for l in jl] == [l.replace("torch.pdb", "X") for l in tl]
    assert th == jh and "REFINED ENSEMBLE (2 MODELS)" in th[1]
    np.testing.assert_array_equal(t["model_mask"], j["model_mask"])
    for k in ("n", "ca", "c"):
        np.testing.assert_allclose(t[k], j[k], atol=1.01e-3, rtol=0, err_msg=k)


def test_refine_cli_needs_a_gpu_without_device_cpu(tmp_path):
    from protein_ensemble_vae_torch.cli.refine import main as tmain

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain(["--input", str(tmp_path / "x.pdb"), "--output", str(tmp_path / "y.pdb")])


# ---------------------------------------------------------------------------
# generate_ensembles: the refine dispatch against the JAX package's
# ---------------------------------------------------------------------------

SMALL = dict(seqemb_dim=8, d_model=32, nhead=4, ff=64, nlayers=1,
             z_global=16, z_local=8, decoder_hidden=16, decoder_layers=2,
             max_neighbors=4)
# what cli.generate hands over by default (its --refine_* flags)
CLI_KWARGS = dict(w_angle=0.5, w_bond=1.0, w_clash_vdw=0.0, lr_decay=False)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from protein_ensemble_vae_torch.config import ModelConfig as TModelConfig
    from protein_ensemble_vae_torch.data import (EnsembleDataset,
                                                 SingleConformerView,
                                                 make_synthetic_dataset)
    from protein_ensemble_vae_torch.models import HierCVAE as THierCVAE
    from protein_ensemble_vae_torch.models.bridge import params_from_flax
    from protein_ensemble_vae_tpu.config import ModelConfig
    from protein_ensemble_vae_tpu.models import HierCVAE

    root = tmp_path_factory.mktemp("refine_gen")
    make_synthetic_dataset(str(root / "data"), n_proteins=1, K=2, lengths=(20,),
                           seqemb_dim=8, seed=4, fold="nerf")
    view = SingleConformerView(EnsembleDataset(str(root / "data" / "manifest_train.csv"),
                                               use_seqemb=True))
    item = view[0]
    jmodel = HierCVAE(ModelConfig(**SMALL))
    variables = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)},
        item["seq_emb"][None], item["n"][None], item["ca"][None],
        item["c"][None], item["dihedrals"][None], item["mask"][None])
    tmodel = THierCVAE(TModelConfig(**SMALL))
    tmodel.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]), tmodel))
    return dict(view=view, jmodel=jmodel, variables=variables, tmodel=tmodel,
                root=root)


def _recorder(calls, name):
    def record(n, ca, c, mask, **kw):
        calls.append((name, tuple(np.shape(a) for a in (n, ca, c, mask)), kw))
        return n, ca, c
    return record


@pytest.mark.parametrize("mode", ["cartesian", "torsion", "polish"])
def test_generate_calls_the_refiners_as_jax_does(models, monkeypatch, tmp_path, mode):
    """The port's ``generate_ensembles`` calls the refiners with the same
    arguments as the JAX package's, in the same order, for every mode.

    This includes the ``ADVICE.md`` medium finding at the JAX package's
    ``infer/generate.py:160``, kept as the reference has it: in the torsion
    and polish modes ``refine_kwargs`` is filtered to ``w_clash_vdw`` and
    ``lr_decay``, so the generate CLI's defaults 0.0 and False reach
    ``refine_torsions`` and replace its own 25.0 and True."""
    import protein_ensemble_vae_tpu.infer.refine as jr
    import protein_ensemble_vae_tpu.infer.torsion_refine as jt
    from protein_ensemble_vae_tpu.infer.generate import \
        generate_ensembles as jgenerate

    calls = {"jax": [], "torch": []}
    monkeypatch.setattr(jr, "refine_backbone", _recorder(calls["jax"], "backbone"))
    monkeypatch.setattr(jt, "refine_torsions", _recorder(calls["jax"], "torsions"))
    monkeypatch.setattr(tgen, "refine_backbone", _recorder(calls["torch"], "backbone"))
    monkeypatch.setattr(tgen, "refine_torsions", _recorder(calls["torch"], "torsions"))
    kw = dict(num_samples=3, seed=0, max_structures=1, buckets=(32,), refine_steps=7, refine_lr=0.01,
              refine_anchor=0.02, refine_w_rama=1.5, refine_kwargs=CLI_KWARGS,
              refine_mode=mode, verbose=False)
    jgenerate(models["jmodel"], models["variables"], models["view"],
              str(tmp_path / "j"), **kw)
    out = tgen.generate_ensembles(models["tmodel"], models["view"],
                                  str(tmp_path / "t"), **kw)
    assert calls["torch"] == calls["jax"]
    want = {"cartesian": ["backbone"], "torsion": ["torsions"],
            "polish": ["backbone", "torsions"]}[mode]
    assert [name for name, _, _ in calls["torch"]] == want
    assert calls["torch"][-1][1] == ((3, 32, 3),) * 3 + ((3, 32),)
    if mode != "cartesian":
        assert calls["torch"][-1][2]["w_clash_vdw"] == 0.0
        assert calls["torch"][-1][2]["lr_decay"] is False
    stages = {"cartesian": {"cartesian"}, "torsion": {"torsion"},
              "polish": {"cartesian", "torsion"}}[mode]
    assert set(out["results"][0]["refine_seconds"]) == stages


def test_generate_refines_before_the_gate(models, tmp_path):
    """A real cartesian refinement inside ``generate_ensembles`` on the
    CPU: finite coordinates, the ensemble file written, stage seconds
    recorded; with refine_steps = 0 no stage runs."""
    out = tgen.generate_ensembles(models["tmodel"], models["view"], str(tmp_path),
                                  num_samples=2, max_structures=1, buckets=(32,),
                                  refine_steps=5,
                                  refine_kwargs=dict(w_clash_vdw=10.0), verbose=False)
    r = out["results"][0]
    assert set(r["refine_seconds"]) == {"cartesian"} and r["refine_seconds"]["cartesian"] > 0
    ens = t_read(str(tmp_path / f"{r['structure']}_ensemble.pdb"))
    assert np.isfinite(ens["ca"]).all() and ens["ca"].shape[1] == 20
    plain = tgen.generate_ensembles(models["tmodel"], models["view"], str(tmp_path / "p"),
                                    num_samples=2, max_structures=1, buckets=(32,),
                                    verbose=False)
    assert plain["results"][0]["refine_seconds"] == {}
