"""The port does what the JAX package does, name for name.

Every JAX module is read with ``ast`` (JAX is not imported): each public
top-level ``def`` / ``class`` and every name its ``__init__.py`` exports
must exist in the port's counterpart module (``ops/pallas/X`` ->
``ops/kernels/X``, every other path as it is), or stand in ``DIFFERENCES``
with its reason. A JAX name with neither fails, and so does an entry of
``DIFFERENCES`` that the port has come to define (the list stays the
record of what is not ported and why).
"""

import ast
import importlib
import os

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "protein_ensemble_vae_tpu"
PORT_PKG = "protein_ensemble_vae_torch"

# "<JAX module path>:<name>" -> why the port has no counterpart of that name
DIFFERENCES = {
    "parallel/mesh.py:ensure_cpu_devices":
        "virtual CPU devices for a JAX mesh; a torch rank is a process on any device",
    "parallel/mesh.py:make_parallel_jit":
        "jit with shardings; the port wraps the step instead: make_parallel_step",
    "parallel/__init__.py:make_parallel_jit": "see parallel/mesh.py: make_parallel_step",
    "parallel/mesh.py:tp_param_pspecs":
        "PartitionSpecs of the Flax tree; the port's tp_param_specs gives each "
        "parameter's sharded dim by its torch name",
    "parallel/__init__.py:tp_param_pspecs": "see parallel/mesh.py: tp_param_specs",
    "ops/routing.py:pallas_supported":
        "a backend-wide TPU check; the port decides per tensor (pallas_policy: "
        "a CUDA tensor runs the kernel)",
    "models/decoder.py:band_gather":
        "lives beside the kernels' plain version: ops/kernels/egnn_band.py "
        "(band_gather, band_indices)",
    "models/init.py:TorchLinear":
        "a Flax Dense with torch's init; the port's models/init.Linear is a torch Linear",
    "models/init.py:torch_kernel_init": "torch's own nn.Linear init (models/init.py)",
    "models/init.py:torch_bias_init": "torch's own nn.Linear init (models/init.py)",
    "models/init.py:torch_logvar_bias_init": "models/init.py sets it on the Linear",
    "models/esm2.py:esm2_forward": "the forward of the nn.Module models/esm2.ESM2",
    "ops/pallas/clash.py:clash_loss_pallas":
        "the CUDA kernels' entry: ops/kernels/clash.clash_loss_kernel",
    "ops/pallas/__init__.py:clash_loss_pallas":
        "the CUDA kernels' entry: ops/kernels/clash.clash_loss_kernel",
}


def _jax_modules():
    base = os.path.join(ROOT, JAX_PKG)
    for dirpath, _, files in os.walk(base):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), base)


def _public_names(path: str) -> set:
    with open(path) as fh:
        tree = ast.parse(fh.read())
    init = path.endswith("__init__.py")
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                names.add(node.name)
        elif init and isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif init and isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return names


def _port_module(rel: str) -> str:
    rel = rel.replace("ops/pallas/", "ops/kernels/")
    parts = rel[:-len(".py")].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([PORT_PKG] + parts)


MODULES = sorted(_jax_modules())


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_has_a_counterpart(rel):
    names = _public_names(os.path.join(ROOT, JAX_PKG, rel))
    try:
        mod = importlib.import_module(_port_module(rel))
    except ModuleNotFoundError:
        mod = None
    missing = sorted(n for n in names
                     if (mod is None or not hasattr(mod, n)) and f"{rel}:{n}" not in DIFFERENCES)
    assert not missing, f"{rel} -> {_port_module(rel)} lacks {missing}"


def test_differences_name_only_what_is_missing():
    for key in DIFFERENCES:
        rel, name = key.split(":")
        assert rel in MODULES, key
        assert name in _public_names(os.path.join(ROOT, JAX_PKG, rel)), key
        try:
            mod = importlib.import_module(_port_module(rel))
        except ModuleNotFoundError:
            continue
        assert not hasattr(mod, name), f"{key}: the port has it now"


def test_the_scan_covers_the_jax_package():
    assert len(MODULES) >= 50
    for rel in ("utils/watch.py", "utils/profiling.py", "utils/seeding.py",
                "utils/compile_cache.py", "viz/parameters.py", "infer/sequence.py",
                "train/training.py", "__init__.py"):
        assert rel in MODULES, rel
    assert {"make_param_grad_fn", "make_optimizer", "create_train_state"} <= \
        _public_names(os.path.join(ROOT, JAX_PKG, "train", "training.py"))
