"""Generation slice of the PyTorch port, end to end on the CPU: synthetic
H5 data written by the port, a port checkpoint carried over from JAX
parameters, the generate CLI, and the files it writes held against the JAX
package's own writer."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from protein_ensemble_vae_torch.cli import generate as tcli  # noqa: E402
from protein_ensemble_vae_torch.config import RunConfig as TRunConfig  # noqa: E402
from protein_ensemble_vae_torch.config import ModelConfig as TModelConfig  # noqa: E402
from protein_ensemble_vae_torch.config import TrainConfig as TTrainConfig  # noqa: E402
from protein_ensemble_vae_torch.data import (EnsembleDataset,  # noqa: E402
                                             SingleConformerView,
                                             make_synthetic_dataset)
from protein_ensemble_vae_torch.infer import generate as tgen  # noqa: E402
from protein_ensemble_vae_torch.models import HierCVAE as THierCVAE  # noqa: E402
from protein_ensemble_vae_torch.models.bridge import params_from_flax  # noqa: E402
from protein_ensemble_vae_torch.train.checkpoint import save_checkpoint  # noqa: E402
from protein_ensemble_vae_tpu.config import ModelConfig  # noqa: E402
from protein_ensemble_vae_tpu.infer.pdb_io import write_multi_model_pdb as jax_write_multi  # noqa: E402
from protein_ensemble_vae_tpu.infer.pdb_io import write_pdb as jax_write_pdb  # noqa: E402
from protein_ensemble_vae_tpu.models import HierCVAE  # noqa: E402
from protein_ensemble_vae_tpu.ops.geometry import dihedrals_from_coords  # noqa: E402

SMALL = dict(seqemb_dim=8, d_model=32, nhead=4, ff=64, nlayers=1,
             z_global=16, z_local=8, decoder_hidden=16, decoder_layers=2,
             max_neighbors=4)
BUCKETS = (16, 32)
NUM_SAMPLES = 3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_gen")
    make_synthetic_dataset(str(root / "data"), n_proteins=2, K=2,
                           lengths=(14, 27), seqemb_dim=8, seed=4,
                           fold="nerf")
    manifest = str(root / "data" / "manifest_train.csv")
    view = SingleConformerView(EnsembleDataset(manifest, use_seqemb=True))
    item = view[0]
    jmodel = HierCVAE(ModelConfig(**SMALL))
    variables = jax.jit(jmodel.init)(   # one compile, not one per op
        {"params": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)},
        item["seq_emb"][None], item["n"][None], item["ca"][None],
        item["c"][None], item["dihedrals"][None], item["mask"][None])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    cfg = TRunConfig(model=TModelConfig(**SMALL),
                     train=TTrainConfig(bucket_sizes=BUCKETS))
    tmodel = THierCVAE(cfg.model)
    tmodel.load_state_dict(params_from_flax(params, tmodel))
    ckpt = save_checkpoint(str(root / "ckpt"), tmodel, cfg)
    return dict(root=root, manifest=manifest, view=view, ckpt=ckpt)


def _argv(setup, out, *extra):
    return ["--checkpoint", setup["ckpt"], "--manifest", setup["manifest"],
            "--output_dir", str(out), "--num_samples", str(NUM_SAMPLES),
            *extra]


def test_synthetic_dihedrals_match_jax(setup):
    """The port's write_synthetic_h5 computes its torsions with the port's
    geometry; they equal the JAX package's for the same coordinates."""
    view = setup["view"]
    for idx in range(len(view)):
        conf = view.conformer(idx)
        want = dihedrals_from_coords(*(jnp.array(v[None]) for v in
                                       (conf.n, conf.ca, conf.c, conf.mask)))
        np.testing.assert_allclose(conf.dihedrals, np.asarray(want[0]),
                                   atol=1e-5)


def test_generate_cli_writes_the_file_set(setup, tmp_path, monkeypatch):
    written = {}
    real_write_pdb = tgen.write_pdb

    def recording_write_pdb(n, ca, c, mask, path, **kw):
        written[os.path.basename(path)] = (n, ca, c, mask, kw)
        return real_write_pdb(n, ca, c, mask, path, **kw)

    monkeypatch.setattr(tgen, "write_pdb", recording_write_pdb)
    out = tmp_path / "gen"
    tcli.main(_argv(setup, out, "--device", "cpu"))

    view = setup["view"]
    summary = (out / "generation_summary.txt").read_text()
    assert summary.startswith("ENSEMBLE GENERATION SUMMARY")
    assert len(view) == 4
    for idx in range(len(view)):
        sid = f"{view.conformer(idx).protein_id}_{idx:04d}"
        assert sid in summary
        for suffix in ("true", "reconstruction", "ensemble"):
            assert (out / f"{sid}_{suffix}.pdb").exists()
        ens = (out / f"{sid}_ensemble.pdb").read_text()
        n_models = ens.count("\nMODEL ")
        # one MODEL per sample the gate kept (all of them when it kept none)
        line = next(l for l in summary.splitlines() if l.startswith(sid))
        n_valid = int(line.split("valid=")[1].split("/")[0])
        assert n_models == (n_valid if n_valid else NUM_SAMPLES)
        assert f"GENERATED ENSEMBLE ({n_models} MODELS)" in ens
        xyz = np.array([[float(l[30:38]), float(l[38:46]), float(l[46:54])]
                        for l in ens.splitlines() if l.startswith("ATOM  ")])
        assert xyz.size and np.isfinite(xyz).all()
        # true and reconstruction files: the JAX writer, given the same
        # arrays, writes the same bytes
        for suffix in ("true", "reconstruction"):
            name = f"{sid}_{suffix}.pdb"
            n, ca, c, mask, kw = written[name]
            ref = tmp_path / f"jax_{name}"
            jax_write_pdb(np.asarray(n), np.asarray(ca), np.asarray(c),
                          np.asarray(mask), str(ref), **kw)
            assert (out / name).read_bytes() == ref.read_bytes()
    for line in summary.splitlines():
        if line.startswith("mean"):
            assert np.isfinite(float(line.split(":")[1].strip().rstrip("A")))


def test_pdb_writer_bytes_match_jax(tmp_path):
    from protein_ensemble_vae_torch.infer.pdb_io import write_multi_model_pdb

    rng = np.random.default_rng(2)
    K, L = 3, 11
    n, ca, c = (rng.normal(0, 5, (K, L, 3)).astype(np.float32)
                for _ in range(3))
    mask = np.ones(L, np.float32)
    mask[[0, 6]] = 0.0
    kw = dict(sequence="ACDEFGHIKLX", pdb_id="1abc", title="T")
    write_multi_model_pdb(n, ca, c, mask, str(tmp_path / "t.pdb"), **kw)
    jax_write_multi(n, ca, c, mask, str(tmp_path / "j.pdb"), **kw)
    assert (tmp_path / "t.pdb").read_bytes() == (tmp_path / "j.pdb").read_bytes()


@pytest.mark.parametrize("mode", ["cartesian", "torsion", "polish"])
def test_generate_cli_refines_in_each_mode(setup, tmp_path, mode):
    """``--refine_steps 5`` in each ``--refine_mode`` runs on the CPU and
    writes the whole file set with finite coordinates."""
    out = tmp_path / mode
    tcli.main(_argv(setup, out, "--device", "cpu", "--max_structures", "1",
                    "--refine_steps", "5", "--refine_mode", mode))
    sid = f"{setup['view'].conformer(0).protein_id}_0000"
    assert (out / "generation_summary.txt").exists()
    for suffix in ("true", "reconstruction", "ensemble"):
        text = (out / f"{sid}_{suffix}.pdb").read_text()
        xyz = np.array([[float(l[30:38]), float(l[38:46]), float(l[46:54])]
                        for l in text.splitlines() if l.startswith("ATOM  ")])
        assert xyz.size and np.isfinite(xyz).all(), suffix


def test_cli_without_device_needs_a_gpu(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    out = tmp_path / "nodev"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(_argv(setup, out))
    assert not out.exists()


def test_prior_sampling_and_sequence_modes(setup, tmp_path):
    cfg = TRunConfig(model=TModelConfig(**SMALL))
    torch.manual_seed(0)
    model = THierCVAE(cfg.model)
    res = tgen.generate_ensembles(model, setup["view"], str(tmp_path / "p"),
                                  num_samples=NUM_SAMPLES, seed=1,
                                  max_structures=1, buckets=BUCKETS,
                                  latent_source="prior", seq_decode="sample",
                                  temperature=0.0, verbose=False)
    r = res["results"][0]
    # T = 0 prior draws decode z = 0 for every sample: zero diversity
    assert r["diversity"] == pytest.approx(0.0, abs=1e-5)
    with pytest.raises(ValueError, match="latent_source"):
        tgen.generate_ensembles(model, setup["view"], str(tmp_path / "x"),
                                latent_source="bogus", verbose=False)
