"""The analysis layer of the PyTorch port (``eval/``, the PDB reader and the
analyze / validate CLIs) against the JAX package's, on the CPU.

The port's copies are host numpy except the torsions and the batched
Kabsch battery, which run on ``device`` (``cpu`` here). Files are written
with the JAX package's writer; each tolerance is stated where it is used.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from protein_ensemble_vae_torch import eval as teval  # noqa: E402
from protein_ensemble_vae_torch.eval import analyze as tan  # noqa: E402
from protein_ensemble_vae_torch.eval import metrics as tm  # noqa: E402
from protein_ensemble_vae_torch.eval import ramachandran as tr  # noqa: E402
from protein_ensemble_vae_torch.eval import report as trep  # noqa: E402
from protein_ensemble_vae_torch.infer.pdb_io import \
    read_pdb_backbone as t_read  # noqa: E402
from protein_ensemble_vae_tpu import eval as jeval  # noqa: E402
from protein_ensemble_vae_tpu.data.synthetic import nerf_ensemble  # noqa: E402
from protein_ensemble_vae_tpu.eval import analyze as jan  # noqa: E402
from protein_ensemble_vae_tpu.eval import metrics as jm  # noqa: E402
from protein_ensemble_vae_tpu.eval import ramachandran as jr  # noqa: E402
from protein_ensemble_vae_tpu.eval import report as jrep  # noqa: E402
from protein_ensemble_vae_tpu.infer.pdb_io import read_pdb_backbone as j_read  # noqa: E402
from protein_ensemble_vae_tpu.infer.pdb_io import write_multi_model_pdb, write_pdb  # noqa: E402

K, L = 4, 30
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def ensemble():
    """K noised NeRF conformers of one fold (some clashes, broken bonds)
    with a masked residue, and the fold itself as ground truth."""
    n, ca, c = nerf_ensemble(L, K, seed=6)
    rng = np.random.default_rng(8)
    noisy = [(0.92 * x + rng.normal(0, 0.3, x.shape)).astype(np.float32)
             for x in (n, ca, c)]
    mask = np.ones(L, np.float32)
    mask[12] = 0.0
    return noisy, (n[0], ca[0], c[0]), mask


@pytest.fixture(scope="module")
def pdb_dir(tmp_path_factory, ensemble):
    """A generate-style directory: two structures' ensemble, true and
    reconstruction files."""
    (n, ca, c), (tn, tca, tc), mask = ensemble
    root = tmp_path_factory.mktemp("eval")
    seq = "MKTAYIAKQRQISFVKSHFSRQLEERLGLI"
    for s, sl in (("p1_0000", slice(None)), ("p2_0001", slice(1, None))):
        write_multi_model_pdb(n[sl], ca[sl], c[sl], mask, str(root / f"{s}_ensemble.pdb"),
                              sequence=seq, pdb_id=s[:2])
        write_pdb(tn, tca, tc, np.ones(L, np.float32), str(root / f"{s}_true.pdb"),
                  sequence=seq)
        write_pdb(n[0] + 0.5, ca[0] + 0.5, c[0] + 0.5, np.ones(L, np.float32),
                  str(root / f"{s}_reconstruction.pdb"), sequence=seq)
    return root


def _same(a, b, atol=0.0, path="result"):
    """Nested dict / list / array equality, floats within ``atol``."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], atol, f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, atol, f"{path}[{i}]")
    elif isinstance(a, (str, bool, type(None))):
        assert a == b, path
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   atol=atol, rtol=0, err_msg=path)


def test_eval_exports_match():
    names = {n for n in dir(jeval) if not n.startswith("_")} - {
        "metrics", "ramachandran", "analyze", "report"}
    assert names <= set(dir(teval)), names - set(dir(teval))


def test_read_pdb_backbone_matches_jax(tmp_path, ensemble):
    """Files the JAX writer wrote, single- and multi-model, with a shared
    and a per-model (heterogeneous) mask, and a hand-written file with a
    start offset, a gap, an insertion code, an altloc duplicate and a
    second chain: every array and the sequence equal."""
    (n, ca, c), _, mask = ensemble
    mask_k = np.tile(mask, (K, 1))
    mask_k[1, :3] = 0.0
    mask_k[3, -2:] = 0.0
    files = []
    for name, m in (("shared", mask), ("hetero", mask_k)):
        files.append(str(tmp_path / f"{name}.pdb"))
        write_multi_model_pdb(n, ca, c, m, files[-1], sequence="ACDEFGHIKLMNPQRSTVWY")
    files.append(str(tmp_path / "single.pdb"))
    write_pdb(n[0], ca[0], c[0], mask, files[-1])
    lines = []
    for chain, resseq, icode, name, resn in (
            ("A", -2, " ", "N", "GLY"), ("A", -2, " ", "CA", "GLY"), ("A", -2, " ", "CA", "GLY"),
            ("A", -2, " ", "C", "GLY"), ("A", 1, " ", "CA", "TRP"), ("A", 1, "A", "CA", "SER"),
            ("A", 1, "A", "O", "SER"), ("B", 5, " ", "CA", "LYS"), ("B", 6, " ", "N", "LYS")):
        x = 1.5 * len(lines)
        lines.append(f"ATOM  {len(lines) + 1:5d} {name:<4s} {resn} {chain}{resseq:4d}{icode}   "
                     f"{x:8.3f}{-x:8.3f}{2 * x:8.3f}  1.00  0.00           {name[0]}\n")
    files.append(str(tmp_path / "odd.pdb"))
    with open(files[-1], "w") as f:
        f.writelines(lines + ["END\n"])
    for path in files:
        want, got = j_read(path), t_read(path)
        assert got["sequence"] == want["sequence"], path
        for k in ("n", "ca", "c", "o", "mask", "model_mask"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{path} {k}")
    assert t_read(files[1])["model_mask"].sum(1).tolist() == mask_k.sum(1).tolist()


def test_metrics_match_jax(ensemble):
    """Host numpy metrics equal; the batched Kabsch (RMSF, diversity)
    within 1e-5 A (fp32 SVDs of other libraries)."""
    (n, ca, c), (tn, tca, tc), mask = ensemble
    pred, true, m = ca[1], tca.astype(np.float32), mask > 0.5
    np.testing.assert_array_equal(tm.kabsch_align_np(pred, true), jm.kabsch_align_np(pred, true))
    assert tm.compute_tm_score(pred, true) == jm.compute_tm_score(pred, true)
    _same(tm.compute_lddt(pred, true, m), jm.compute_lddt(pred, true, m))
    _same(tm.compute_gdt(pred, true, m), jm.compute_gdt(pred, true, m))
    assert tm.compute_radius_of_gyration(pred, m) == jm.compute_radius_of_gyration(pred, m)
    assert tm.expected_rg(L) == jm.expected_rg(L)
    cp, ct = tm.compute_contact_map(pred), tm.compute_contact_map(true)
    np.testing.assert_array_equal(cp, jm.compute_contact_map(pred))
    assert tm.contact_map_overlap(cp, ct) == jm.contact_map_overlap(cp, ct)
    np.testing.assert_allclose(tm.compute_rmsf(ca, **CPU), jm.compute_rmsf(ca), atol=1e-5)
    assert tm.compute_rmsf(ca[:1], **CPU).tolist() == [0.0] * L
    d_t, M_t = tm.compute_ensemble_diversity(ca, **CPU)
    d_j, M_j = jm.compute_ensemble_diversity(ca)
    assert d_t == pytest.approx(d_j, abs=1e-5)
    np.testing.assert_allclose(M_t, M_j, atol=1e-5)
    assert np.all(np.diag(M_t) == 0.0) and np.array_equal(M_t, M_t.T)


def test_ramachandran_matches_jax(ensemble):
    """phi / psi within 1e-5 rad; the classifications equal."""
    (n, ca, c), _, mask = ensemble
    for k in range(K):
        got = tr.phi_psi_from_backbone(n[k], ca[k], c[k], mask, **CPU)
        want = jr.phi_psi_from_backbone(n[k], ca[k], c[k], mask)
        np.testing.assert_array_equal(got[2], want[2])
        for g, w in zip(got[:2], want[:2]):
            d = g - w
            assert np.abs(np.arctan2(np.sin(d), np.cos(d))).max() < 1e-5
        for fn in ("classify_ramachandran", "classify_ramachandran_elliptical"):
            assert getattr(tr, fn)(*want) == getattr(jr, fn)(*want)


def test_structure_scores_match_jax(ensemble):
    """clash_score, molprobity_clashscore (with and without O, H-bond
    allowance as the reference has it) and bond_length_stats: equal."""
    from protein_ensemble_vae_tpu.infer.pdb_io import compute_backbone_oxygen

    (n, ca, c), _, mask = ensemble
    for k in range(K):
        o = compute_backbone_oxygen(n[k], ca[k], c[k], mask)
        args = (n[k], ca[k], c[k], mask)
        assert tan.clash_score(*args) == jan.clash_score(*args)
        assert tan.bond_length_stats(*args) == jan.bond_length_stats(*args)
        for oo in (o, None):
            assert (tan.molprobity_clashscore(n[k], ca[k], c[k], oo, mask)
                    == jan.molprobity_clashscore(n[k], ca[k], c[k], oo, mask))


def test_analyze_directory_matches_jax(pdb_dir, tmp_path):
    """The whole analysis of a directory: every number within 1e-5 (the
    torsions and the Kabsch battery), the report's text equal."""
    got = tan.analyze_directory(str(pdb_dir), str(tmp_path / "t.txt"), verbose=False,
                                plots=False, **CPU)
    want = jan.analyze_directory(str(pdb_dir), str(tmp_path / "j.txt"), verbose=False,
                                 plots=False)
    _same(got, want, atol=1e-5)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert got["aggregate"]["n_structures"] == 2
    one = tan.analyze_structure(str(pdb_dir / "p1_0000_ensemble.pdb"), **CPU)
    assert "ensemble_to_gt_rmsd" not in one and one["n_models"] == K


def test_validate_files_match_jax(pdb_dir, tmp_path):
    """validate_files in both modes: within 1e-5, reports equal."""
    kw = dict(pred_pdb=str(pdb_dir / "p1_0000_reconstruction.pdb"),
              true_pdb=str(pdb_dir / "p1_0000_true.pdb"),
              ensemble_pdb=str(pdb_dir / "p1_0000_ensemble.pdb"))
    got = trep.validate_files(output=str(tmp_path / "t.txt"), **kw, **CPU)
    want = jrep.validate_files(output=str(tmp_path / "j.txt"), **kw)
    _same(got, want, atol=1e-5)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()


@pytest.mark.parametrize("cli", ["analyze", "validate"])
def test_clis_print_what_jax_prints(pdb_dir, tmp_path, capsys, cli):
    """``cli.analyze`` / ``cli.validate --device cpu`` against the JAX
    package's CLIs: the same printed lines and reports."""
    import importlib

    tmain = importlib.import_module(f"protein_ensemble_vae_torch.cli.{cli}").main
    jmain = importlib.import_module(f"protein_ensemble_vae_tpu.cli.{cli}").main
    printed = {}
    for tag, main, extra in (("jax", jmain, []), ("torch", tmain, ["--device", "cpu"])):
        out = str(tmp_path / f"{tag}.txt")
        if cli == "analyze":
            argv = ["--pdb_dir", str(pdb_dir), "--output", out]
        else:
            argv = ["--pred", str(pdb_dir / "p2_0001_reconstruction.pdb"),
                    "--true", str(pdb_dir / "p2_0001_true.pdb"),
                    "--ensemble", str(pdb_dir / "p2_0001_ensemble.pdb"), "--output", out]
        main(argv + extra)
        lines = capsys.readouterr().out.replace(out, "REPORT").splitlines()
        printed[tag] = ([l for l in lines if not l.startswith("[analyze] p")],
                        open(out).read())
    assert printed["torch"] == printed["jax"]
    for png in pdb_dir.glob("*.png"):
        os.remove(png)


@pytest.mark.parametrize("cli", ["analyze", "validate"])
def test_clis_need_a_gpu_without_device_cpu(pdb_dir, cli):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    main = importlib.import_module(f"protein_ensemble_vae_torch.cli.{cli}").main
    argv = (["--pdb_dir", str(pdb_dir)] if cli == "analyze"
            else ["--ensemble", str(pdb_dir / "p1_0000_ensemble.pdb")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
