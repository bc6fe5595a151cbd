"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles, on its
own (with the shared ``csrc/*.cuh`` headers), into
``_build/lib<name>-<hash>.so`` inside the package (a directory that
``.gitignore`` lists). The hash covers the source, the headers and the
flags, so an edited source rebuilds and a stale library is never loaded. The build runs
at first use, from the repository's sources alone; ``build`` starts one
``nvcc`` per source, all together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the CUDA
    toolkit's default location. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def library_path(name: str) -> str:
    """The library's path; its hash covers the source, every shared header
    in ``csrc/`` and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Sequence[str], verbose: bool = False) -> dict[str, dict]:
    """Compile every source in ``names`` that has no current library, one
    ``nvcc`` process each, all started together. Returns, per name, the
    seconds its build took (0.0 when it was already built) and ``nvcc``'s
    output (register, shared-memory and spill counts from ``-Xptxas -v``).
    Raises on the first failed build, with the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        nvcc = nvcc or nvcc_path()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {name: dict(seconds=0.0, log="") for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = dict(seconds=time.perf_counter() - t0, log=log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a reader never sees a partial file
        if verbose:
            print(f"[build] {name}: {report[name]['seconds']:.1f}s\n{log}",
                  flush=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _LIBS[name] = lib
    return lib
