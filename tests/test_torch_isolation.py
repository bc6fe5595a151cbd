"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, at run time or in its sources (chip_smoke.py included); and
importing it pulls in neither matplotlib nor h5py (the chip machine has
neither: matplotlib is imported inside the functions that draw, and the
port's H5 files go through its own ``data/h5file.py``, so nothing of the
port imports h5py at all)."""

import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "protein_ensemble_vae_torch")

_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|orbax|"
    r"protein_ensemble_vae_tpu)\b", re.MULTILINE)


# the port's own scripts beside the package
PORT_SCRIPTS = ("scripts/flagship_run_torch.py", "scripts/generate_and_analyze_torch.sh",
                "scripts/battery_paths.py")


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    for f in PORT_SCRIPTS:
        yield os.path.join(ROOT, f)


def test_importing_every_module_pulls_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import protein_ensemble_vae_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "              'protein_ensemble_vae_tpu'))\n"
        "need = {'losses', 'ops.kernels.clash', 'ops.kernels.egnn_band',\n"
        "        'train.training', 'train.checkpoint', 'train.kl_schedulers',\n"
        "        'train.lr_schedule', 'data.collate', 'data.prefetch',\n"
        "        'utils.logging', 'cli.train', 'cli.generate',\n"
        "        'models.esm2', 'dataprep.esm', 'dataprep.pipeline',\n"
        "        'parallel.mesh', 'parallel.shard', 'parallel.dryrun',\n"
        "        'utils.watch', 'utils.profiling', 'utils.seeding',\n"
        "        'utils.compile_cache', 'viz.training_curves', 'viz.parameters',\n"
        "        'viz.dataset_stats'}\n"
        "missing = {n for n in need if p.__name__ + '.' + n not in mods}\n"
        "assert len(mods) >= 30 and not missing, (mods, missing)\n"
        "heavy = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "               ('matplotlib', 'h5py'))\n"
        "print(len(mods), bad, heavy)\n"
        "sys.exit(1 if bad or heavy else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax():
    offenders = []
    for path in _sources():
        with open(path) as f:
            for m in _IMPORT.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}")
    assert not offenders, offenders


_H5PY = re.compile(r"^\s*(?:import|from)\s+h5py\b|\bimport h5py\b", re.MULTILINE)


def test_sources_import_no_h5py():
    """The port reads and writes its H5 files with ``data/h5file.py``: no
    source of the package, chip_smoke.py or the port's scripts imports
    h5py (the card's machine has none)."""
    offenders = []
    for path in _sources():
        with open(path) as f:
            for m in _H5PY.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_data_dataprep_and_cli_paths_pull_no_h5py(tmp_path):
    """In one process: synthetic data written and read (``EnsembleDataset``),
    a dataprep chain written and given an embedding (``esm`` append), the
    dataset statistics, one ``cli.train`` epoch and ``cli.generate`` on the
    CPU; h5py is then absent from sys.modules."""
    code = f"""
import sys
import numpy as np
from protein_ensemble_vae_torch.data import EnsembleDataset, make_synthetic_dataset
from protein_ensemble_vae_torch.dataprep.pipeline import write_chain_h5
from protein_ensemble_vae_torch.dataprep.esm import add_embeddings_to_h5
from protein_ensemble_vae_torch.viz.dataset_stats import dataset_stats
from protein_ensemble_vae_torch.cli import train, generate
root = {str(tmp_path)!r}
tr, va = make_synthetic_dataset(root + "/data", n_proteins=2, K=3, lengths=(24,),
                                seqemb_dim=16, seed=7)
assert len(EnsembleDataset(tr, use_seqemb=True, verbose=False).pairs) == 6
f = lambda *s: np.zeros(s, np.float32)
chain = dict(coords_n=f(2, 8, 3), coords_ca=f(2, 8, 3), coords_c=f(2, 8, 3), mask=f(2, 8) + 1,
             sequence="ACDEFGHI", resseqs=np.arange(8, dtype=np.int32), rmsf=f(8),
             core_mask=f(8), medoid=0, torsion_phi_sincos=f(2, 8, 2),
             torsion_psi_sincos=f(2, 8, 2), torsion_omega_sincos=f(2, 8, 2))
path = write_chain_h5(root + "/prep/x_A_nmr.h5", chain)
class E:
    def embed(self, seq):
        return np.ones((len(seq), 4), np.float32)
assert add_embeddings_to_h5(path, E(), verbose=False)
assert len(dataset_stats(tr, device="cpu")) == 2
small = ["--d_model", "32", "--nhead", "4", "--ff", "64", "--nlayers", "1", "--z_global",
         "16", "--z_local", "8", "--decoder_hidden", "16", "--decoder_layers", "2",
         "--max_neighbors", "4"]
train.main(["--manifest_train", tr, "--manifest_val", va, "--use_seqemb", "--epochs", "1",
            "--batch_size", "4", "--device", "cpu", "--save", root + "/ckpt"] + small)
generate.main(["--checkpoint", root + "/ckpt/final", "--manifest", va, "--output_dir",
               root + "/gen", "--num_samples", "2", "--max_structures", "1", "--device", "cpu"])
print(sorted(m for m in sys.modules if m.split(".")[0] == "h5py"))
sys.exit(1 if any(m.split(".")[0] == "h5py" for m in sys.modules) else 0)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
