"""Data-preparation parity: the port's ``dataprep`` against the JAX
package's, on the CPU.

The same mmCIF files (the real-format messy fixture, the synthetic text of
``test_dataprep._fake_mmcif``) and the same seeded numpy ensembles go
through both packages. The host-side numpy steps must agree exactly; the
torsions (JAX's ``dihedrals_from_coords`` against the port's, in torch)
within 1e-5; the H5 files and manifests in layout, attributes and values.
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_dataprep import (_STRUCT_REF_KV, _STRUCT_REF_LOOP,  # noqa: E402
                           _fake_mmcif)

from protein_ensemble_vae_torch import dataprep as tdp  # noqa: E402
from protein_ensemble_vae_torch.dataprep import align as talign  # noqa: E402
from protein_ensemble_vae_torch.dataprep import esm as tesm_prep  # noqa: E402
from protein_ensemble_vae_torch.dataprep import mmcif as tmmcif  # noqa: E402
from protein_ensemble_vae_torch.dataprep import pair_features as tpf  # noqa: E402
from protein_ensemble_vae_torch.dataprep import pipeline as tpl  # noqa: E402
from protein_ensemble_vae_tpu import dataprep as jdp  # noqa: E402
from protein_ensemble_vae_tpu.dataprep import align as jalign  # noqa: E402
from protein_ensemble_vae_tpu.dataprep import mmcif as jmmcif  # noqa: E402
from protein_ensemble_vae_tpu.dataprep import pair_features as jpf  # noqa: E402
from protein_ensemble_vae_tpu.dataprep import pipeline as jpl  # noqa: E402
from protein_ensemble_vae_tpu.data.synthetic import helix_backbone  # noqa: E402

MESSY_CIF = os.path.join(os.path.dirname(__file__), "fixtures", "messy_9xyz.cif")
# torsions: torch against XLA, fp32 sin/cos of the same coordinates
TORSION_ATOL = 1e-5
# numpy steps copied as they are: alignment, RMSF, pair features
NUMPY_ATOL = 1e-6
# H5 arrays: the torsions differ as above, all else is bitwise
H5_ATOL = 1e-5


def _same(a, b, path="", atol=0.0):
    """Nested dicts / lists / arrays / scalars equal (NaN equals NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a.keys(), b)
        for k in a:
            _same(a[k], b[k], f"{path}/{k}", atol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]", atol)
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=path)
    elif isinstance(a, float):
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= atol, (path, a, b)
    else:
        assert a == b, (path, a, b)


def _write(tmp_path, name, text):
    p = str(tmp_path / name)
    with open(p, "w") as f:
        f.write(text)
    return p


@pytest.fixture(scope="module")
def fake_text():
    return _fake_mmcif(K=3, L=60, seed=0)[0]


# ---------------------------------------------------------------------------
# mmCIF parsing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["messy", "fake"])
def test_parse_and_arrays_match_jax(source, fake_text):
    kw = (dict(path_or_text=MESSY_CIF) if source == "messy"
          else dict(path_or_text=fake_text, is_text=True))
    chains = tmmcif.parse_mmcif_backbone(**kw)
    _same(chains, jmmcif.parse_mmcif_backbone(**kw))
    shapes = {}
    for cid, chain in chains.items():
        got = tmmcif.chain_to_arrays(chain)
        _same(got, jmmcif.chain_to_arrays(chain), cid)
        _same(tmmcif.chain_to_arrays(chain, min_models=4),
              jmmcif.chain_to_arrays(chain, min_models=4), cid)
        shapes[cid] = got["mask"].shape
    if source == "messy":
        # chain AA passes the gates at K = 3, L = 58; decoy B is L = 10
        assert shapes == {"AA": (3, 58), "B": (3, 10)}
    else:
        assert shapes == {"A": (3, 60)}


@pytest.mark.parametrize("source", ["messy", "kv", "loop", "metadata"])
def test_categories_accessions_metadata_match_jax(source):
    meta_text = ("data_test\n#\n_exptl.method 'X-RAY DIFFRACTION'\n"
                 "_refine.ls_d_res_high 1.85\n_exptl_crystal.pH 7.4\n#\nloop_\n"
                 "_chem_comp.id\n_chem_comp.type\nALA 'L-peptide linking'\n"
                 "HOH non-polymer\nATP non-polymer\n#\n")
    kw = {"messy": dict(path_or_text=MESSY_CIF),
          "kv": dict(path_or_text="data_test\n#\n" + _STRUCT_REF_KV, is_text=True),
          "loop": dict(path_or_text="data_test\n#\n" + _STRUCT_REF_LOOP, is_text=True),
          "metadata": dict(path_or_text=meta_text, is_text=True)}[source]
    prefixes = ("_struct_ref.", "_exptl.", "_refine.", "_chem_comp.", "_atom_site.")
    _same(tmmcif.parse_mmcif_categories(prefixes=prefixes, **kw),
          jmmcif.parse_mmcif_categories(prefixes=prefixes, **kw))
    _same(tdp.uniprot_accessions(**kw), jdp.uniprot_accessions(**kw))
    _same(tdp.extract_metadata(**kw), jdp.extract_metadata(**kw))
    if source == "messy":
        assert tdp.uniprot_accessions(**kw) == ["P0A9X9"]


def test_gzip_cif_parses_as_plain(tmp_path):
    import gzip

    gz = str(tmp_path / "9xyz.cif.gz")
    with open(MESSY_CIF, "rb") as src, gzip.open(gz, "wb") as dst:
        shutil.copyfileobj(src, dst)
    _same(tmmcif.parse_mmcif_backbone(gz), jmmcif.parse_mmcif_backbone(MESSY_CIF))


def test_exports_match_jax():
    def exports(pkg):
        return sorted(n for n in dir(pkg)
                      if not n.startswith("_") and callable(getattr(pkg, n)))

    assert exports(tdp) == exports(jdp) and len(exports(tdp)) == 7
    assert tmmcif.AA_3TO1_EXT == jmmcif.AA_3TO1_EXT


# ---------------------------------------------------------------------------
# alignment, pair features
# ---------------------------------------------------------------------------

def _ensemble(seed, K=5, L=70):
    rng = np.random.default_rng(seed)
    n0, ca0, c0 = helix_backbone(L)
    out = []
    for base in (n0, ca0, c0):
        out.append(np.stack([base + rng.normal(0, 0.5, base.shape) for _ in range(K)]
                            ).astype(np.float32))
    for k in range(1, K):          # rigid motions, so alignment does work
        th = rng.uniform(0, 2 * np.pi)
        R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                      [0, 0, 1.0]], np.float32)
        shift = rng.normal(0, 5, 3).astype(np.float32)
        for a in out:
            a[k] = a[k] @ R.T + shift
    mask = np.ones((K, L), np.float32)
    mask[1, :6] = 0.0
    mask[3, 40:52] = 0.0
    return (*out, mask)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alignment_matches_jax(seed):
    n, ca, c, mask = _ensemble(seed)
    assert talign.medoid_index(ca, mask) == jalign.medoid_index(ca, mask)
    np.testing.assert_allclose(talign.pairwise_rmsd_matrix(ca, mask),
                               jalign.pairwise_rmsd_matrix(ca, mask), atol=NUMPY_ATOL)
    got = tdp.core_fit_align(n, ca, c, mask)
    want = jdp.core_fit_align(n, ca, c, mask)
    assert got[3] == want[3]
    for g, w in zip(got[:3] + got[4:], want[:3] + want[4:]):
        np.testing.assert_allclose(g, w, atol=NUMPY_ATOL, rtol=0)
    np.testing.assert_allclose(talign.compute_rmsf_ensemble(got[1], mask),
                               jalign.compute_rmsf_ensemble(want[1], mask),
                               atol=NUMPY_ATOL, rtol=0)
    pf = tpf.compute_pair_features(n[0], ca[0], c[0], mask[1])
    _same(pf, jpf.compute_pair_features(n[0], ca[0], c[0], mask[1]), atol=NUMPY_ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_needleman_wunsch_matches_jax(seed):
    rng = np.random.default_rng(seed)
    aa = list("ACDEFGHIKLMNPQRSTVWYX")
    a = "".join(rng.choice(aa, 40))
    b = list(a)
    for _ in range(6):                         # substitutions, indels
        i = int(rng.integers(len(b)))
        op = rng.integers(3)
        if op == 0:
            b[i] = str(rng.choice(aa))
        elif op == 1:
            del b[i]
        else:
            b.insert(i, str(rng.choice(aa)))
    b = "".join(b)
    got, want = tdp.needleman_wunsch(a, b), jdp.needleman_wunsch(a, b)
    _same(got, want)
    _same(talign.alignment_identity_coverage(a, b, got[1]),
          jalign.alignment_identity_coverage(a, b, want[1]))


# ---------------------------------------------------------------------------
# process_chain, cross-PDB, H5 build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair_features", [True, False])
def test_process_chain_matches_jax(pair_features, fake_text):
    arrays = tmmcif.chain_to_arrays(tmmcif.parse_mmcif_backbone(fake_text, True)["A"])
    got = tpl.process_chain(arrays, min_len=50, with_pair_features=pair_features,
                            device="cpu")
    want = jpl.process_chain(arrays, min_len=50, with_pair_features=pair_features)
    assert got.keys() == want.keys()
    for k in got:
        atol = TORSION_ATOL if k.startswith("torsion_") else 0.0
        _same(got[k], want[k], k, atol=atol)
    assert got["torsion_phi_sincos"].shape == (3, 60, 2)
    # the gates are the JAX package's
    assert tpl.process_chain(arrays, min_len=61, device="cpu") is None


def test_process_chain_cuda_raises_without_gpu(fake_text):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    arrays = tmmcif.chain_to_arrays(tmmcif.parse_mmcif_backbone(fake_text, True)["A"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpl.process_chain(arrays)


def test_crosspdb_augmentation_matches_jax():
    text, _ = _fake_mmcif(K=2, L=60, seed=0)
    base = tmmcif.chain_to_arrays(tmmcif.parse_mmcif_backbone(text, True)["A"])
    base = tpl.process_chain(base, with_pair_features=False, device="cpu")
    th = 0.5
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1.0]], np.float32)
    cands = [dict(coords_n=base["coords_n"] @ R.T + 5.0,
                  coords_ca=base["coords_ca"] @ R.T + 5.0,
                  coords_c=base["coords_c"] @ R.T + 5.0, mask=base["mask"],
                  sequence=base["sequence"], source="cand:A",
                  meta={"ligands": "ATP"}),
             dict(base, sequence="W" * 60, source="other:A")]   # fails identity
    got = tpl.append_crosspdb_conformers(base, cands, device="cpu")
    want = jpl.append_crosspdb_conformers(base, cands)
    assert got.keys() == want.keys() and len(got["sources"]) == 2
    for k in got:
        _same(got[k], want[k], k, atol=TORSION_ATOL if k.startswith("torsion_") else 0.0)
    assert got["sources"][0]["state"] == "holo-ATP"


def _h5_tree(path):
    """{name: (kind, dtype, shape, compression, value, attrs)} of an H5."""
    import h5py

    out = {}
    with h5py.File(path, "r") as fh:
        out["/"] = ("group", dict(fh.attrs))

        def visit(name, obj):
            attrs = {k: v for k, v in obj.attrs.items()}
            if isinstance(obj, h5py.Dataset):
                out[name] = ("dataset", obj.dtype, obj.shape, obj.compression,
                             obj[()], attrs)
            else:
                out[name] = ("group", attrs)
        fh.visititems(visit)
    return out


def _assert_same_h5(got_path, want_path):
    got, want = _h5_tree(got_path), _h5_tree(want_path)
    assert got.keys() == want.keys()
    for name in got:
        g, w = got[name], want[name]
        assert g[0] == w[0], name
        if g[0] == "group":
            _same(g[1], w[1], name)
            continue
        assert g[1:4] == w[1:4], (name, g[1:4], w[1:4])
        if isinstance(w[4], np.ndarray) and w[4].dtype.kind == "f":
            atol = H5_ATOL if "torsion" in name else 0.0
            np.testing.assert_allclose(g[4], w[4], atol=atol, rtol=0, err_msg=name)
        else:
            _same(g[4], w[4], name)
        _same(g[5], w[5], name)


def _manifests(paths, root):
    out = {}
    for split, p in paths.items():
        with open(p) as f:
            out[split] = f.read().replace(root, "<out>")
    return out


@pytest.mark.parametrize("crosspdb", [False, True])
def test_build_from_files_matches_jax(tmp_path, crosspdb):
    pytest.importorskip("h5py")
    cross = None
    if crosspdb:   # the fixture again, as a candidate entry of its own
        cand = str(tmp_path / "cand1.cif")
        shutil.copy(MESSY_CIF, cand)
        cross = {"messy_9xyz": [cand]}
    outs = {}
    for name, build, extra in (("port", tpl.build_from_files, dict(device="cpu")),
                               ("jax", jpl.build_from_files, {})):
        root = str(tmp_path / name)
        outs[name] = (root, build([MESSY_CIF], root, min_models=2, verbose=False,
                                  crosspdb_cifs=cross, **extra))
    (troot, tman), (jroot, jman) = outs["port"], outs["jax"]
    assert _manifests(tman, troot) == _manifests(jman, jroot)
    files = sorted(os.listdir(os.path.join(troot, "h5")))
    assert files == sorted(os.listdir(os.path.join(jroot, "h5"))) == ["messy_9xyz_AA_nmr.h5"]
    _assert_same_h5(os.path.join(troot, "h5", files[0]), os.path.join(jroot, "h5", files[0]))
    tree = _h5_tree(os.path.join(troot, "h5", files[0]))
    assert ("crosspdb/coords_ca" in tree) == crosspdb
    if crosspdb:
        sources = json.loads(tree["crosspdb"][1]["sources"])
        assert [s["source"] for s in sources] == ["cand1:AA"] * 3


def test_write_manifests_matches_jax(tmp_path):
    paths = [f"/data/h5/p{i}_A_nmr.h5" for i in range(23)]
    for seed in (1, 13):
        got = tpl.write_manifests(paths, str(tmp_path / "t"), seed=seed)
        want = jpl.write_manifests(paths, str(tmp_path / "j"), seed=seed)
        assert (_manifests(got, str(tmp_path / "t"))
                == _manifests(want, str(tmp_path / "j")))


def test_discover_crosspdb_mocked(tmp_path, monkeypatch):
    base_text, _ = _fake_mmcif(K=2, L=60, seed=5)
    base_cif = _write(tmp_path, "base.cif", base_text + "\n" + _STRUCT_REF_KV)
    cand_text, _ = _fake_mmcif(K=1, L=60, seed=5, jitter=0.0)
    results = {}
    for name, mod in (("port", tpl), ("jax", jpl)):
        client = mod.RCSBClient()
        requests = []

        def fake_request(url, payload=None, requests=requests):
            requests.append((url, payload))
            return json.dumps({"result_set": [
                {"identifier": "BASE"}, {"identifier": "CAN1"},
                {"identifier": "CAN1"}]}).encode()

        def fake_download(pdb_id, dest_dir):
            os.makedirs(dest_dir, exist_ok=True)
            return _write(tmp_path, f"{pdb_id}.cif", cand_text)

        monkeypatch.setattr(client, "_request", fake_request)
        monkeypatch.setattr(client, "download_mmcif", fake_download)
        results[name] = (mod.discover_crosspdb("base", base_cif, client,
                                               str(tmp_path / "raw")), requests)
    (got, got_req), (want, want_req) = results["port"], results["jax"]
    assert got_req == want_req and got_req[0][1]["query"]["nodes"][1][
        "parameters"]["value"] == ["P0A9X9"]
    _same(got, want)
    assert [c["source"] for c in got] == ["can1:A"]


def test_pipeline_main_cpu(tmp_path, capsys):
    pytest.importorskip("h5py")
    out = str(tmp_path / "cli")
    tpl.main(["--output", out, "--cif_files", MESSY_CIF, "--min_models", "2",
              "--device", "cpu"])
    assert "[dataprep] manifests:" in capsys.readouterr().out
    assert os.path.exists(os.path.join(out, "h5", "messy_9xyz_AA_nmr.h5"))
    if not torch.cuda.is_available():      # the default device is cuda
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpl.main(["--output", out, "--cif_files", MESSY_CIF])


# ---------------------------------------------------------------------------
# ESM-2 embeddings into the H5, then the port's dataset reads them
# ---------------------------------------------------------------------------

def test_add_embeddings_matches_jax_and_feeds_training(tmp_path, monkeypatch):
    h5py = pytest.importorskip("h5py")
    from test_torch_esm2 import SMALL, _params

    from protein_ensemble_vae_torch.data import EnsembleDataset, make_epoch_batches
    from protein_ensemble_vae_torch.models.bridge import esm2_params_from_jax
    from protein_ensemble_vae_torch.models.esm2 import ESM2, ESM2Config, ESM2Embedder
    from protein_ensemble_vae_tpu.dataprep import esm as jesm_prep
    from protein_ensemble_vae_tpu.models import esm2 as jesm

    jcfg = jesm.ESM2Config(**SMALL)
    params = _params(jcfg, seed=3)
    tcfg = ESM2Config(**SMALL)
    sd = esm2_params_from_jax(params, ESM2(tcfg))
    port_emb = ESM2Embedder(sd, tcfg, device="cpu")

    paths, mans = {}, {}
    for name in ("port", "jax"):
        out = str(tmp_path / name)
        mans[name] = tpl.build_from_files([MESSY_CIF], out, min_models=2, verbose=False,
                                          with_pair_features=False, device="cpu")
        paths[name] = os.path.join(out, "h5", "messy_9xyz_AA_nmr.h5")
    assert tesm_prep.add_embeddings_to_h5(paths["port"], port_emb, verbose=False)
    assert jesm_prep.add_embeddings_to_h5(paths["jax"], jesm.ESM2Embedder(params, jcfg),
                                          verbose=False)
    assert tesm_prep.GROUP == jesm_prep.GROUP and tesm_prep.MODEL_NAME == jesm_prep.MODEL_NAME

    with h5py.File(paths["port"], "r") as t, h5py.File(paths["jax"], "r") as j:
        g, w = t[tesm_prep.GROUP], j[jesm_prep.GROUP]
        assert g.shape == w.shape == (58, SMALL["hidden"]) and g.dtype == w.dtype
        assert g.compression == w.compression == "gzip"
        _same(dict(g.attrs), dict(w.attrs))
        np.testing.assert_allclose(g[()], w[()], atol=1e-5, rtol=0)
    # skip and overwrite rules
    assert not tesm_prep.add_embeddings_to_h5(paths["port"], port_emb, verbose=False)
    assert tesm_prep.add_embeddings_to_h5(paths["port"], port_emb, overwrite=True,
                                          verbose=False)
    man = mans["port"]["test"]         # one entry lands in the test split
    monkeypatch.setattr(tesm_prep, "ESMEmbedder", lambda device: port_emb)
    assert tesm_prep.embed_manifests([man, man], device="cpu") == 0
    assert tesm_prep.embed_manifests([man, man], device="cpu", overwrite=True) == 1

    ds = EnsembleDataset(man, use_seqemb=True)
    assert ds.seqemb_dim == SMALL["hidden"] and len(ds) == 3
    batch = next(iter(make_epoch_batches(ds, 2, (64,), False, 0)))
    assert batch.inp.seq_emb.shape == (2, 64, SMALL["hidden"])
    assert batch.inp.ca.shape == (2, 64, 3) and batch.inp.mask.sum() == 2 * 58
    assert np.isfinite(batch.inp.seq_emb).all()


def test_esm_main_cpu_and_default_device(tmp_path, monkeypatch, capsys):
    pytest.importorskip("h5py")
    from test_torch_esm2 import SMALL

    from protein_ensemble_vae_torch.models.esm2 import ESM2, ESM2Config, ESM2Embedder, init_hf_

    man = tpl.build_from_files([MESSY_CIF], str(tmp_path), min_models=2, verbose=False,
                               with_pair_features=False, device="cpu")["test"]
    cfg = ESM2Config(**SMALL)
    model = init_hf_(ESM2(cfg), torch.Generator().manual_seed(0))
    devices = []

    def fake_embedder(device):
        devices.append(device)
        return ESM2Embedder(model.state_dict(), cfg, device=device)

    monkeypatch.setattr(tesm_prep, "ESMEmbedder", fake_embedder)
    tesm_prep.main(["--manifest_test", man, "--device", "cpu"])
    assert devices == ["cpu"]
    assert "[esm] embedded 1 H5 files" in capsys.readouterr().out
    with pytest.raises(SystemExit):                  # no manifest given
        tesm_prep.main(["--device", "cpu"])
    monkeypatch.undo()
    if not torch.cuda.is_available():              # the default device is cuda
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tesm_prep.main(["--manifest_test", man])
