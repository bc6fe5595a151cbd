"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, at run time or in its sources (chip_smoke.py included)."""

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


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


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
        "        'parallel.mesh', 'parallel.shard', 'parallel.dryrun'}\n"
        "missing = {n for n in need if p.__name__ + '.' + n not in mods}\n"
        "assert len(mods) >= 30 and not missing, (mods, missing)\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
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
