"""The port's kernel build cache (``protein_ensemble_vae_torch.utils
.compile_cache``, the counterpart of the JAX package's compilation cache):
``PEV_COMPILE_CACHE`` moves the build directory to ``<dir>/<fingerprint>``,
``off`` builds into a temporary directory, unset keeps the package's
``_build/``; the toolchain fingerprint (nvcc release + target) enters every
library's path, so a new toolkit rebuilds; without nvcc nothing raises.
Runs on the CPU: nothing is compiled."""

import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from protein_ensemble_vae_torch.ops.kernels import build  # noqa: E402
from protein_ensemble_vae_torch.utils import compile_cache as cc  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def build_dir(monkeypatch):
    """``build.BUILD_DIR`` restored after the test; the fingerprint re-read."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    cc._nvcc_release.cache_clear()
    yield
    cc._nvcc_release.cache_clear()


def test_directory_relocates_the_build(build_dir, monkeypatch, tmp_path):
    monkeypatch.setenv("PEV_COMPILE_CACHE", str(tmp_path / "cache"))
    got = cc.enable_compilation_cache()
    assert got == build.BUILD_DIR == str(tmp_path / "cache" / cc.host_fingerprint())
    assert os.path.isdir(got)
    assert os.path.dirname(build.library_path("clash")) == got
    # an explicit path wins over the environment
    assert cc.enable_compilation_cache(str(tmp_path / "other")).startswith(
        str(tmp_path / "other"))


def test_off_builds_into_a_temporary_directory(build_dir, monkeypatch):
    monkeypatch.setenv("PEV_COMPILE_CACHE", "off")
    assert cc.enable_compilation_cache() is None
    assert os.path.isdir(build.BUILD_DIR)
    assert build.BUILD_DIR != build.DEFAULT_BUILD_DIR
    assert not build.BUILD_DIR.startswith(os.path.join(ROOT, "protein_ensemble_vae_torch"))


def test_unset_keeps_the_package_build_dir(build_dir, monkeypatch, tmp_path):
    monkeypatch.setenv("PEV_COMPILE_CACHE", str(tmp_path))
    cc.enable_compilation_cache()
    monkeypatch.delenv("PEV_COMPILE_CACHE")
    assert cc.enable_compilation_cache() == build.BUILD_DIR == build.DEFAULT_BUILD_DIR
    assert build.DEFAULT_BUILD_DIR == os.path.join(ROOT, "protein_ensemble_vae_torch",
                                                   "_build")


def test_fingerprint_enters_the_library_path(build_dir, monkeypatch, tmp_path):
    before = build.library_path("egnn_band_fwd")
    fake = tmp_path / "cuda" / "bin"
    fake.mkdir(parents=True)
    nvcc = fake / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'Cuda compilation tools, release 12.4, V12.4.131'\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    cc._nvcc_release.cache_clear()
    assert cc.host_fingerprint() == "nvcc-12.4.131-sm_90a"
    after = build.library_path("egnn_band_fwd")
    assert after != before
    assert os.path.basename(after).startswith("libegnn_band_fwd-")


def test_no_nvcc_gives_a_fixed_tag_and_import_does_not_raise(tmp_path):
    code = ("from protein_ensemble_vae_torch.utils.compile_cache import host_fingerprint; "
            "from protein_ensemble_vae_torch.ops.kernels.build import library_path; "
            "print(host_fingerprint()); library_path('clash')")
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "PYTHONPATH")}
    env["PATH"] = str(tmp_path)          # no nvcc on it
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at its default location")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "nvcc-none-sm_90a"


@pytest.mark.parametrize("cli", ["train", "generate", "refine"])
def test_clis_enable_the_cache_at_start(cli):
    """As the JAX package's train / generate / refine CLIs do."""
    path = os.path.join(ROOT, "protein_ensemble_vae_torch", "cli", f"{cli}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    calls = [n.func.id for n in ast.walk(main)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    assert "enable_compilation_cache" in calls
