"""The port does what the JAX package does, name for name and argument for
argument.

Every JAX module is read with ``ast`` (JAX is not imported): each public
top-level ``def`` / ``class`` and every name its ``__init__.py`` exports
must exist in the port's counterpart module (``ops/pallas/X`` ->
``ops/kernels/X``, every other path as it is), or stand in ``DIFFERENCES``
with its reason. A JAX name with neither fails, and so does an entry of
``DIFFERENCES`` that the port has come to define (the list stays the
record of what is not ported and why).

Every public top-level function the port has must also take the JAX
function's parameters: the same names in the same order, the same kinds
(positional or keyword-only) and the same defaults (a JAX dtype default
equals the torch dtype of its name; a default that names a constant
equals the port's constant of that name). A function whose signature
departs stands in ``DIFFERENCES`` as ``"<module>:<name>()"`` with its
reason, and such an entry fails once the signatures agree.
"""

import ast
import importlib
import inspect
import os

import pytest

torch = pytest.importorskip("torch")

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
    # signatures that depart from the JAX function's (torch idiom, or what
    # a torch process needs that a JAX one does not)
    "cli/train.py:main()":
        "datasets (in-memory stand-ins for the manifests' EnsembleDataset) and "
        "timeout_s (a bound on launched dp / tp ranks) after JAX's argv",
    "data/prefetch.py:prefetch_to_device()":
        "a torch device for a JAX sharding: each dp rank prefetches to its own card",
    "dataprep/pipeline.py:process_chain()": "device=: torsions on the given torch device",
    "dataprep/pipeline.py:append_crosspdb_conformers()":
        "device=: torsions on the given torch device",
    "dataprep/pipeline.py:build_from_files()": "device=: torsions on the given torch device",
    "dataprep/esm.py:embed_manifests()":
        "device defaults to the card: the port's entry points run on the card unless "
        "the caller asks for the CPU",
    "eval/analyze.py:analyze_structure()": "device=: the torch device of its torsions and fits",
    "eval/analyze.py:plot_structure_diagnostics()":
        "device=: the torch device of its torsions and fits",
    "eval/analyze.py:analyze_directory()": "device=: the torch device of its torsions and fits",
    "eval/metrics.py:compute_rmsf()": "device=: the torch device of its Kabsch fits",
    "eval/metrics.py:compute_ensemble_diversity()": "device=: the torch device of its fits",
    "eval/ramachandran.py:phi_psi_from_backbone()": "device=: the torch device of its torsions",
    "eval/report.py:validate_ensemble()": "device=: the torch device of its fits",
    "eval/report.py:validate_files()": "device=: the torch device of its fits",
    "viz/dataset_stats.py:dataset_stats()": "device=: the torch device of its torsions",
    "models/decoder.py:band_indices()": "device=: where torch builds the index tensors",
    "models/encoder.py:sinusoidal_pe()": "device=: where torch builds the table (before dtype)",
    "infer/generate.py:generate_ensembles()":
        "no variables: an nn.Module holds its parameters, Flax passes them beside it",
    "infer/sequence.py:logits_to_labels()": "generator (a torch.Generator) for rng (a JAX key)",
    "infer/sequence.py:tensor_to_sequence()": "generator (a torch.Generator) for rng (a JAX key)",
    "losses.py:rmsd_loss()": "rows: the global batch's rows under dp (make_loss_fn's dp_sum)",
    "losses.py:kl_global()": "rows: the global batch's rows under dp (make_loss_fn's dp_sum)",
    "losses.py:clash_loss()": "rows: the global batch's rows under dp (make_loss_fn's dp_sum)",
    "losses.py:vdw_clash_loss()":
        "tables (vdw_pair_tables, built once per length: a refiner's CUDA graph must "
        "not build them per step) and rows (the global batch's rows under dp)",
    "losses.py:pair_distance_loss()": "den: the global batch's denominator under dp",
    "losses.py:kl_local()": "den: the global batch's denominator under dp",
    "losses.py:dihedral_consistency_loss()": "den: the global batch's denominator under dp",
    "losses.py:ramachandran_loss()": "den: the global batch's denominator under dp",
    "losses.py:omega_trans_loss()": "den: the global batch's denominator under dp",
    "losses.py:bond_length_loss()": "den: the global batch's denominator under dp",
    "losses.py:ca_spacing_loss()": "den: the global batch's denominator under dp",
    "losses.py:bond_angle_loss()": "den: the global batch's denominator under dp",
    "losses.py:sequence_classification_loss()": "den: the global batch's denominator under dp",
    "losses.py:sequence_accuracy()": "den: the global batch's denominator under dp",
    "losses.py:compute_total_loss()":
        "den: the global batch's denominators under dp (JAX's GSPMD takes global "
        "means itself; a torch rank sees its rows only)",
    "ops/geometry.py:safe_norm()": "dim / keepdim, torch's names for axis / keepdims",
    "ops/geometry.py:safe_normalize()": "dim, torch's name for axis",
    "ops/geometry.py:masked_mean()": "dim, torch's name for axis",
    "ops/pallas/egnn_band.py:egnn_band_fused()":
        "use_pallas, the port's routing knob (ModelConfig.use_pallas_egnn), "
        "keyword-only after JAX's arguments: JAX routes in the decoder before the call",
    "ops/routing.py:pallas_policy()":
        "decides per tensor (a CUDA tensor runs the kernel), so it takes the tensor "
        "where JAX takes L, the backend and B",
    "parallel/mesh.py:initialize_multihost()":
        "device (NCCL or gloo) and timeout_s, which torch.distributed needs and "
        "jax.distributed.initialize does not",
    "parallel/mesh.py:make_mesh()":
        "no devices: a rank is a process with its own device (current_device)",
    "parallel/mesh.py:coordination_barrier()":
        "timeout_s defaults to DEFAULT_TIMEOUT_S, the process group's own timeout "
        "(torch.distributed's 30 minutes)",
    "train/checkpoint.py:save_checkpoint()":
        "model (an nn.Module) where JAX has its TrainState, the optimizer state apart "
        "(train_state)",
    "train/checkpoint.py:load_checkpoint()": "model to load into, for JAX's state template",
    "train/training.py:create_train_state()":
        "rng and sample_batch are accepted and unused (default None): a torch model "
        "holds its parameters from construction",
    "train/training.py:make_loss_fn()":
        "dp_sum for train: the module's mode (train / eval) is the model's own; "
        "dp_sum normalises by the global batch under dp",
    "train/training.py:make_train_step()":
        "mesh (the dp / tp groups) for jit_wrapper: eager torch has no jit",
    "train/training.py:train_model()":
        "no jit_wrapper (eager torch); mesh and local_batches for dp / tp",
    "utils/watch.py:histogram_summaries()": "named (name, tensor) pairs for a pytree",
    "utils/profiling.py:step_timer":
        "timed the enqueue of a block, not its work, and nothing read it; the port's "
        "host timing is utils/profiling.span, on the profiler's clock",
    "utils/profiling.py:trace()":
        "logdir defaults to a directory under the temporary directory, not a fixed /tmp path",
    # Not a name or a signature, so no entry: the port's H5 files go through
    # its own data/h5file.py (no h5py), whose writer stores a dataset
    # contiguous, or with compression="gzip" as one deflated chunk of its
    # whole shape (level 4), where h5py picks smaller chunks; h5py and the
    # JAX package's EnsembleDataset read the port's files as the arrays they
    # hold (tests/test_torch_h5file.py).
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
        if key.endswith("()"):
            continue   # a signature entry: test_signature_differences_name_departures
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


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

DTYPE_NAMES = ("float16", "bfloat16", "float32", "float64", "int32", "int64")


def _jax_functions(rel: str) -> list:
    """The public top-level functions of the JAX module ``rel`` (AST nodes)."""
    with open(os.path.join(ROOT, JAX_PKG, rel)) as fh:
        tree = ast.parse(fh.read())
    return [n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and not n.name.startswith("_")]


def _jax_default(node, port_mod):
    """A JAX default, comparable with ``_port_default``: a literal's value,
    ("dtype", name) for a dtype, the port's object of the same dotted name
    for a constant, else ("expr", its source)."""
    if node is None:
        return ("required",)
    try:
        return ("value", ast.literal_eval(node))
    except ValueError:
        pass
    text = ast.unparse(node)
    if text.split(".")[-1] in DTYPE_NAMES:
        return ("dtype", text.split(".")[-1])
    obj = port_mod
    for part in text.split("."):
        if not hasattr(obj, part):
            return ("expr", text)
        obj = getattr(obj, part)
    return ("value", obj)


def _port_default(value):
    if value is inspect.Parameter.empty:
        return ("required",)
    if isinstance(value, torch.dtype):
        return ("dtype", str(value).replace("torch.", ""))
    return ("value", value)


def jax_signature(node, port_mod) -> list:
    """[(name, kind, default)] of a JAX function: kind "pos", "*", "kw" or "**"."""
    a = node.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    sig = [(p.arg, "pos", _jax_default(d, port_mod)) for p, d in zip(pos, defaults)]
    if a.vararg:
        sig.append((a.vararg.arg, "*", ("required",)))
    sig += [(p.arg, "kw", _jax_default(d, port_mod)) for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    if a.kwarg:
        sig.append((a.kwarg.arg, "**", ("required",)))
    return sig


def port_signature(fn) -> list:
    """[(name, kind, default)] of a port function, as ``jax_signature``."""
    kinds = {inspect.Parameter.VAR_POSITIONAL: "*", inspect.Parameter.KEYWORD_ONLY: "kw",
             inspect.Parameter.VAR_KEYWORD: "**"}
    return [(p.name, kinds.get(p.kind, "pos"), _port_default(p.default))
            for p in inspect.signature(fn).parameters.values()]


def _departures(rel: str) -> dict:
    """{name: (jax signature, port signature)} of the module's public
    functions whose port counterpart's signature departs from JAX's."""
    try:
        mod = importlib.import_module(_port_module(rel))
    except ModuleNotFoundError:
        return {}
    out = {}
    for node in _jax_functions(rel):
        fn = getattr(mod, node.name, None)
        if not callable(fn) or inspect.isclass(fn):
            continue
        want, got = jax_signature(node, mod), port_signature(fn)
        if want != got:
            out[node.name] = (want, got)
    return out


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_function_takes_the_jax_parameters(rel):
    bad = {n: d for n, d in _departures(rel).items() if f"{rel}:{n}()" not in DIFFERENCES}
    assert not bad, f"{rel}: signatures depart from JAX's without a DIFFERENCES entry: {bad}"


def test_signature_differences_name_departures():
    for key, why in DIFFERENCES.items():
        if not key.endswith("()"):
            continue
        rel, name = key[:-2].split(":")
        assert rel in MODULES and why, key
        assert name in _departures(rel), f"{key}: the port takes JAX's parameters now"


def test_signature_check_sees_a_departure():
    """A reordered, renamed or re-defaulted parameter each counts."""
    node = ast.parse("def f(a, b=1, *, c=jnp.float32): pass").body[0]
    want = jax_signature(node, None)
    assert want == [("a", "pos", ("required",)), ("b", "pos", ("value", 1)),
                    ("c", "kw", ("dtype", "float32"))]
    assert port_signature(lambda a, b=1, *, c=torch.float32: None) == want
    for fn in (lambda b=1, a=None, *, c=torch.float32: None,
               lambda a, b=2, *, c=torch.float32: None,
               lambda a, b=1, c=torch.float32: None,
               lambda a, b=1, *, c=torch.bfloat16: None,
               lambda a, b=1, *, c=torch.float32, d=0: None):
        assert port_signature(fn) != want
