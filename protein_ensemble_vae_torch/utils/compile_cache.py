"""The port's kernel build cache (counterpart of the JAX package's
``utils/compile_cache.py``).

The JAX package keeps XLA's persistent compilation cache; the port compiles
nothing at run time but its CUDA sources, which ``ops/kernels/build.py``
builds with ``nvcc`` at first use into a directory of libraries keyed by a
hash of the source, the headers, the flags and ``host_fingerprint()`` (the
nvcc release and the ``-gencode`` target), so a toolkit change rebuilds.

``enable_compilation_cache`` reads ``PEV_COMPILE_CACHE`` as the JAX
package does: a directory moves the build directory to
``<dir>/<fingerprint>``; ``off`` (or ``0``) builds into a temporary
directory for this process, removed at exit; unset keeps the package's own
``_build/`` (which ``.gitignore`` lists). The CLIs call it at start.

JAX's legacy-entry adoption and its host-marker quarantine guard XLA:CPU
code compiled on another machine's ISA from being replayed. No
counterpart is owed: an sm_90a library is device code keyed by its flags
and toolkit, and its host side is the same for every x86-64 machine that
runs the toolkit.
"""

from __future__ import annotations

import atexit
import functools
import os
import re
import shutil
import subprocess
import tempfile
from typing import Optional

NO_NVCC = "nvcc-none"


@functools.lru_cache(maxsize=None)
def _nvcc_release() -> str:
    """``nvcc-<version>`` from ``nvcc --version`` (read once), or NO_NVCC
    where there is no nvcc."""
    from protein_ensemble_vae_torch.ops.kernels.build import nvcc_path

    try:
        out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return NO_NVCC
    m = re.search(r"release [\d.]+, V([\d.]+)", out) or re.search(r"release ([\d.]+)", out)
    return f"nvcc-{m.group(1)}" if m else NO_NVCC


def host_fingerprint() -> str:
    """Short stable tag of the toolchain the libraries are built with: the
    nvcc release and the ``-gencode`` target, e.g. ``nvcc-12.4.131-sm_90a``
    (``nvcc-none-sm_90a`` without nvcc; it never raises)."""
    from protein_ensemble_vae_torch.ops.kernels.build import NVCC_FLAGS

    target = next((f.split("code=", 1)[1] for f in NVCC_FLAGS if "code=" in f), "")
    return f"{_nvcc_release()}-{target}"


def enable_compilation_cache(path: Optional[str] = None) -> Optional[str]:
    """Point the kernel builds at ``path`` or ``PEV_COMPILE_CACHE``; returns
    the build directory, or None when the cache is off."""
    from protein_ensemble_vae_torch.ops.kernels import build

    path = path or os.environ.get("PEV_COMPILE_CACHE", "")
    if not path:
        build.BUILD_DIR = build.DEFAULT_BUILD_DIR
        return build.BUILD_DIR
    if path in ("0", "off"):
        tmp = tempfile.mkdtemp(prefix="pev-kernels-")
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        build.BUILD_DIR = tmp
        return None
    build.BUILD_DIR = os.path.join(os.path.abspath(os.path.expanduser(path)),
                                   host_fingerprint())
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    return build.BUILD_DIR
