"""The port's HDF5 module (``data/h5file.py``, pure Python, no h5py) against
h5py, both ways, on the repository's H5 schema.

- Files the JAX package writes with h5py (``write_synthetic_h5``: a NeRF
  fold, gzip-chunked sequence embeddings, mask holes; ``write_chain_h5``:
  the ``pair_features`` and ``crosspdb`` groups, the ``medoid`` and
  ``sources`` attributes) read through h5file exactly as h5py reads them:
  every dataset and attribute, bit for bit, of the same type.
- Files the port writes read back through h5py bit for bit, and through
  the JAX package's ``EnsembleDataset`` as through the port's.
- ``dataprep.esm``'s append rewrites a file, keeping what it held.
- Chunked datasets h5py writes with a multi-level chunk index and
  partial edge chunks, or with chunks never written, read as h5py reads
  them.
- A feature outside the module's scope raises and names it; the writer
  refuses storage options it does not honour; a failed write leaves the
  old file.
"""

import json

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
torch = pytest.importorskip("torch")

from protein_ensemble_vae_torch.data import h5file  # noqa: E402
from protein_ensemble_vae_torch.data.dataset import EnsembleDataset  # noqa: E402
from protein_ensemble_vae_torch.data.synthetic import (  # noqa: E402
    make_synthetic_dataset, write_synthetic_h5)
from protein_ensemble_vae_torch.dataprep import pipeline as port_pipeline  # noqa: E402
from protein_ensemble_vae_tpu.data.dataset import (  # noqa: E402
    EnsembleDataset as JaxEnsembleDataset)
from protein_ensemble_vae_tpu.data.synthetic import (  # noqa: E402
    write_synthetic_h5 as jax_write_synthetic_h5)
from protein_ensemble_vae_tpu.dataprep import pipeline as jax_pipeline  # noqa: E402


def _h5py_tree(path):
    """{path: (value, {attr: value})} of every dataset and group, as h5py
    reads them."""
    out = {}
    with h5py.File(path, "r") as f:
        out["/"] = (None, {k: f.attrs[k] for k in f.attrs})

        def visit(name, obj):
            attrs = {k: obj.attrs[k] for k in obj.attrs}
            out[name] = (obj[()] if isinstance(obj, h5py.Dataset) else None, attrs)

        f.visititems(visit)
    return out


def _h5file_tree(path):
    out = {}
    with h5file.File(path, "r") as f:
        out["/"] = (None, dict(f.attrs.items()))

        def visit(group, prefix):
            for name, obj in group.items():
                key = prefix + name
                attrs = dict(obj.attrs.items())
                if isinstance(obj, h5file.Group):
                    out[key] = (None, attrs)
                    visit(obj, key + "/")
                else:
                    out[key] = (obj[()], attrs)

        visit(f, "")
    return out


def _same(a, b, where):
    """Bitwise equal and of one type (numpy arrays: dtype and shape)."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, np.generic):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), where
    else:
        assert a == b, where


def _assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, (value, attrs) in want.items():
        gvalue, gattrs = got[key]
        if value is None:
            assert gvalue is None, key
        else:
            _same(gvalue, value, key)
        assert sorted(gattrs) == sorted(attrs), key
        for a in attrs:
            _same(gattrs[a], attrs[a], f"{key}@{a}")


def _chain(seed=0, K=3, L=20):
    """A processed chain as ``dataprep.pipeline.process_chain`` returns it."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    mask = np.ones((K, L), np.float32)
    mask[1, 4:6] = 0.0
    chain = dict(coords_n=f(K, L, 3), coords_ca=f(K, L, 3), coords_c=f(K, L, 3),
                 mask=mask, sequence="ACDEFGHIKLMNPQRSTVWY"[:L],
                 resseqs=np.arange(1, L + 1, dtype=np.int32), rmsf=f(L),
                 core_mask=(rng.random(L) > 0.3).astype(np.float32), medoid=1,
                 torsion_phi_sincos=f(K, L, 2), torsion_psi_sincos=f(K, L, 2),
                 torsion_omega_sincos=f(K, L, 2),
                 pair_features={k: f(L, L) for k in ("dist", "omega", "theta", "phi")})
    cross = dict(coords_n=f(2, L, 3), coords_ca=f(2, L, 3), coords_c=f(2, L, 3),
                 mask=np.ones((2, L), np.float32), torsion_phi_sincos=f(2, L, 2),
                 torsion_psi_sincos=f(2, L, 2), torsion_omega_sincos=f(2, L, 2),
                 sources=[{"pdb": "1abc", "chain": "A", "model": 1, "identity": 0.97},
                          {"pdb": "2xyz", "chain": "B", "model": 3, "identity": 1.0}])
    return chain, cross


def test_reads_the_jax_synthetic_file_as_h5py_does(tmp_path):
    path = str(tmp_path / "syn000_nmr.h5")
    jax_write_synthetic_h5(path, K=4, L=48, seed=3, noise=0.105, seqemb_dim=64,
                           mask_holes=(5, 17, 18), fold="nerf")
    with h5py.File(path, "r") as f:   # the embeddings are gzip-chunked there
        esm = f["seq_embed/esm2_t33_650M_UR50D/layer_33"]
        assert esm.compression == "gzip" and esm.chunks is not None
        assert isinstance(f["sequence"][()], bytes)
    _assert_trees_equal(_h5file_tree(path), _h5py_tree(path))


def test_reads_the_jax_dataprep_file_as_h5py_does(tmp_path):
    chain, cross = _chain()
    path = str(tmp_path / "1abc_A_nmr.h5")
    jax_pipeline.write_chain_h5(path, chain, crosspdb=cross)
    want = _h5py_tree(path)
    assert isinstance(want["/"][1]["medoid"], np.int64)
    assert isinstance(want["crosspdb"][1]["sources"], str)
    got = _h5file_tree(path)
    _assert_trees_equal(got, want)
    assert json.loads(got["crosspdb"][1]["sources"]) == cross["sources"]


@pytest.mark.parametrize("writer", ["synthetic", "dataprep"])
def test_port_written_files_read_back_through_h5py(tmp_path, writer):
    """h5py reads the port's file bit for bit as h5file does, and as it
    reads the JAX package's file of the same data, the gzip datasets gzip
    in both (one chunk in the port's). The synthetic torsions are computed by each
    package's own geometry, so there they agree to atol 1e-5, as
    tests/test_torch_generate.py::test_synthetic_dihedrals_match_jax holds
    them; every other array is bitwise the JAX one."""
    port, jaxp = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    if writer == "synthetic":
        kw = dict(K=3, L=32, seed=5, noise=0.105, seqemb_dim=16, mask_holes=(2,), fold="nerf")
        write_synthetic_h5(port, **kw)
        jax_write_synthetic_h5(jaxp, **kw)
    else:
        chain, cross = _chain(seed=4)
        port_pipeline.write_chain_h5(port, chain, crosspdb=cross)
        jax_pipeline.write_chain_h5(jaxp, chain, crosspdb=cross)
    got, want = _h5py_tree(port), _h5py_tree(jaxp)
    if writer == "synthetic":
        for k in [k for k in want if k.startswith("torsion_")]:
            np.testing.assert_allclose(got[k][0], want[k][0], atol=1e-5, err_msg=k)
            want[k] = got[k]
    _assert_trees_equal(got, want)
    _assert_trees_equal(_h5file_tree(port), _h5py_tree(port))
    with h5py.File(port, "r") as p, h5py.File(jaxp, "r") as j:
        for k in want:
            if k != "/" and isinstance(j[k], h5py.Dataset):
                assert p[k].compression == j[k].compression, k


def test_port_dataset_reads_as_the_jax_dataset(tmp_path):
    """A dataset the port writes is the same through the JAX package's
    ``EnsembleDataset`` (h5py) and the port's (h5file): every conformer's
    arrays, sequence and embedding, and the pairs."""
    train, _ = make_synthetic_dataset(str(tmp_path / "d"), n_proteins=2, K=3,
                                      lengths=(24, 32), seqemb_dim=16, seed=7, fold="nerf")
    mine = EnsembleDataset(train, use_seqemb=True, verbose=False)
    ref = JaxEnsembleDataset(train, use_seqemb=True, verbose=False)
    assert mine.pairs == ref.pairs and len(mine.conformers) == len(ref.conformers)
    for a, b in zip(mine.conformers, ref.conformers):
        assert a.sequence == b.sequence and a.protein_id == b.protein_id
        for k in ("n", "ca", "c", "mask", "dihedrals", "seq_emb"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k


def test_esm_append_keeps_the_file(tmp_path):
    """``add_embeddings_to_h5`` on a file h5py wrote: the embedding group
    and its attributes join, everything else reads as before; a second call
    skips, ``overwrite`` replaces."""
    from protein_ensemble_vae_torch.dataprep.esm import GROUP, MODEL_NAME, add_embeddings_to_h5

    chain, cross = _chain(seed=2)
    path = str(tmp_path / "2abc_A_nmr.h5")
    jax_pipeline.write_chain_h5(path, chain, crosspdb=cross)
    before = _h5py_tree(path)

    class Embedder:
        def __init__(self, value):
            self.value = value

        def embed(self, seq):
            return np.full((len(seq), 8), self.value, np.float32)

    assert add_embeddings_to_h5(path, Embedder(0.5), verbose=False)
    after = _h5py_tree(path)
    added = {k: v for k, v in after.items() if k not in before}
    assert sorted(added) == ["seq_embed", "seq_embed/esm2_t33_650M_UR50D", GROUP]
    _assert_trees_equal({k: after[k] for k in before}, before)
    value, attrs = after[GROUP]
    assert value.shape == (20, 8) and np.all(value == 0.5)
    assert attrs["model"] == MODEL_NAME and attrs["layer"] == 33 and attrs["dim"] == 8
    assert not add_embeddings_to_h5(path, Embedder(1.5), verbose=False)
    assert add_embeddings_to_h5(path, Embedder(1.5), overwrite=True, verbose=False)
    with h5py.File(path, "r") as f:
        assert np.all(f[GROUP][()] == 1.5)


def test_groups_of_many_members_and_scalars(tmp_path):
    """A group wider than one symbol node (8 entries), nested paths, scalar
    datasets and attributes of every kind the writer takes."""
    path = str(tmp_path / "many.h5")
    with h5file.File(path, "w") as f:
        for k in range(40):
            f.create_dataset(f"g/d{k:02d}", data=np.full((2, 3), k, np.int16))
        f.create_dataset("scalar_f", data=np.float64(2.5))
        f.create_dataset("empty", data=np.zeros((0, 3), np.float32))
        f.create_dataset("text", data="résumé ü")
        f.attrs["i"] = 7
        f.attrs["f32"] = np.float32(1.25)
        f.attrs["vec"] = np.arange(3, dtype=np.uint8)
        f["g"].attrs["s"] = "x" * 5000     # longer than one 4 KB heap collection
    with h5py.File(path, "r") as f:
        assert sorted(f["g"]) == [f"d{k:02d}" for k in range(40)]
        assert all(np.array_equal(f[f"g/d{k:02d}"][()], np.full((2, 3), k, np.int16))
                   for k in range(40))
        assert f["scalar_f"][()] == 2.5 and f["scalar_f"].shape == ()
        assert f["empty"].shape == (0, 3)
        assert f["text"][()].decode() == "résumé ü"
        assert f.attrs["i"] == 7 and isinstance(f.attrs["i"], np.int64)
        assert f.attrs["f32"] == np.float32(1.25) and f.attrs["vec"].dtype == np.uint8
        assert f["g"].attrs["s"] == "x" * 5000
    _assert_trees_equal(_h5file_tree(path), _h5py_tree(path))


@pytest.mark.parametrize("case", ["multi_level_edges", "plain_chunks", "missing_chunks"])
def test_reads_chunked_datasets_as_h5py_does(tmp_path, case):
    """Chunk layouts beyond the repository's schema: a (641, 1283) gzip
    dataset in 16 x 40 chunks (1,353 chunks: a chunk B-tree of more than
    one level, partial chunks on both edges), chunks without a filter, and
    a chunked dataset with most chunks never written (zero fill)."""
    path = str(tmp_path / f"{case}.h5")
    rng = np.random.default_rng(11)
    with h5py.File(path, "w") as f:
        if case == "multi_level_edges":
            f.create_dataset("x", data=rng.normal(size=(641, 1283)).astype(np.float32),
                             chunks=(16, 40), compression="gzip")
        elif case == "plain_chunks":
            f.create_dataset("x", data=rng.integers(-9, 9, size=(37, 5)).astype(np.int64),
                             chunks=(8, 2))
        else:
            f.create_dataset("x", shape=(30, 7), dtype=np.float64, chunks=(4, 3))
            f["x"][5:9, 1:4] = rng.normal(size=(4, 3))
    with h5py.File(path, "r") as f:
        x = f["x"]
        assert x.chunks is not None
        if case == "multi_level_edges":
            assert x.id.get_num_chunks() == 41 * 33
        if case == "missing_chunks":
            assert x.id.get_num_chunks() < 8 * 3
    _assert_trees_equal(_h5file_tree(path), _h5py_tree(path))


@pytest.mark.parametrize("case,match", [
    ("bool", "enum"),
    ("shuffle", "shuffle"),
    ("fixed_string", "fixed-length string"),
    ("libver_latest", "superblock version 3"),
    ("fletcher32", "fletcher32"),
    ("big_endian", "big-endian"),
    ("compound", "compound"),
    ("external", "external data file"),
    ("fill_unallocated", "nonzero fill"),
    ("fill_missing_chunks", "nonzero fill"),
])
def test_unsupported_features_raise_and_name_themselves(tmp_path, case, match):
    path = str(tmp_path / f"{case}.h5")
    libver = "latest" if case == "libver_latest" else None
    with h5py.File(path, "w", libver=libver) as f:
        if case == "bool":
            f.create_dataset("x", data=np.array([True, False]))
        elif case == "shuffle":
            f.create_dataset("x", data=np.arange(10.0), compression="gzip", shuffle=True)
        elif case == "fixed_string":
            f.create_dataset("x", data=np.array([b"ab", b"cd"]))
        elif case == "fletcher32":
            f.create_dataset("x", data=np.arange(10.0), chunks=(5,), fletcher32=True)
        elif case == "big_endian":
            f.create_dataset("x", data=np.arange(4, dtype=">f4"))
        elif case == "compound":
            f.create_dataset("x", data=np.zeros(2, dtype=[("a", "<f4"), ("b", "<i4")]))
        elif case == "external":
            np.arange(4, dtype="<f4").tofile(str(tmp_path / "raw.bin"))
            f.create_dataset("x", shape=(4,), dtype="<f4",
                             external=[(str(tmp_path / "raw.bin"), 0, 16)])
        elif case == "fill_unallocated":
            f.create_dataset("x", shape=(5,), dtype=np.float32, fillvalue=3.0)
        elif case == "fill_missing_chunks":
            f.create_dataset("x", shape=(10,), dtype=np.float32, chunks=(2,), fillvalue=2.0)
            f["x"][0:2] = 1.0
        else:
            f.create_dataset("x", data=np.arange(3.0))
    with pytest.raises(h5file.UnsupportedH5, match=match):
        with h5file.File(path, "r") as f:
            f["x"][()]


def test_modes_and_writes_checked(tmp_path):
    path = str(tmp_path / "m.h5")
    with pytest.raises(ValueError, match="'r', 'w' or 'a'"):
        h5file.File(path, "r+")
    with h5file.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(3.0))
        with pytest.raises(ValueError, match="exists"):
            f.create_dataset("x", data=np.arange(3.0))
        with pytest.raises(TypeError, match="bool"):
            f.create_dataset("b", data=np.array([True]))
        for option in (dict(chunks=(1,)), dict(shuffle=True), dict(fletcher32=True),
                       dict(compression_opts=9)):   # storage it would not honour
            with pytest.raises(TypeError, match=next(iter(option))):
                f.create_dataset("c", data=np.arange(3.0), compression="gzip", **option)
            assert "c" not in f
    with h5file.File(path, "r") as f:
        with pytest.raises(ValueError, match="read-only"):
            f.create_dataset("y", data=np.arange(2.0))
        assert "x" in f and "y" not in f and list(f) == ["x"]
    with h5file.File(path, "a") as f:   # an append that adds nothing keeps the data
        pass
    with h5py.File(path, "r") as f:
        assert np.array_equal(f["x"][()], np.arange(3.0))


@pytest.mark.parametrize("mode", ["w", "a"])
def test_failed_write_leaves_the_old_file(tmp_path, mode):
    """An error inside the ``with`` block of a writing mode leaves the file
    as it was before it was opened (``"w"`` truncates nothing until close)
    and no temporary file behind."""
    path = str(tmp_path / "old.h5")
    with h5file.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(4.0))
    before = open(path, "rb").read()
    with pytest.raises(RuntimeError, match="midway"):
        with h5file.File(path, mode) as f:
            f.create_dataset("y", data=np.ones(2))
            raise RuntimeError("midway")
    assert open(path, "rb").read() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["old.h5"]
    with h5file.File(str(tmp_path / "new.h5"), "w"):
        pass
    with h5py.File(str(tmp_path / "new.h5"), "r") as f:
        assert list(f) == []
