"""Data and tensor parallelism on ``torch.distributed`` (counterpart of the
JAX package's ``parallel/mesh.py``).

Ranks form a (dp, tp) grid laid out as ``np.arange(dp * tp).reshape(dp,
tp)``, as JAX lays out its mesh: rank r is dp shard ``r // tp`` and tp
shard ``r % tp``. XLA's SPMD makes the JAX package's sharded step compute
the single-device step; here each rank is a process and the step is made
equal by hand:

- dp: every rank holds the whole model and its rows of the batch. The
  losses' batch normalisers are summed over the dp group
  (``losses.batch_denominators``), so each rank's loss is its share of the
  global loss; the flat gradient and the metrics are then summed over the
  dp group in one all-reduce (``train/training.py:make_train_step``).
- tp: Megatron over the encoder's attention heads and FFN and the
  decoder's EGNN MLPs (``parallel/shard.py``), on the plain band path.
- Random draws are made at the global shape from the step's seed and each
  rank keeps its rows and columns, so a sharded step draws the
  single-process step's dropout masks and noise.

Launching (``launch``): one process per rank, forked from a
``forkserver`` that imported the port once, joined over a ``FileStore``
(single host); ``initialize_multihost`` joins over a ``TCPStore``. The
server lives on between launches and is stopped, with multiprocessing's
resource tracker, when the program exits (``stop_rank_servers``), so a
program that launched ranks leaves no process behind. The
backend rule (``rank_device``): the CUDA ranks of a host each take their
own card, in the order of their ranks, when the host has a card for each;
otherwise they share its one card. The backend is NCCL when every rank of
the world has its own card, else gloo, which carries CUDA tensors through
the host (NCCL refuses two ranks on one device); CPU ranks use gloo. The
tensors stay on the card either way, and a failed init raises.

The JAX module's ``ensure_cpu_devices`` (virtual CPU devices) and
``compile_only`` (AOT compile before a multi-host barrier) have no
counterpart: eager PyTorch has neither virtual devices nor a compile step,
and a rank is a process on any device.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import json
import os
import queue as queue_mod
import socket
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from protein_ensemble_vae_torch.parallel.shard import TP, tp_param_dim

DEFAULT_TIMEOUT_S = 1800.0
_STOP_AT_EXIT = False   # stop_rank_servers registered with atexit


def validate_mesh_config(dp: int, tp: int, batch_size: int,
                         model_cfg=None, n_devices: Optional[int] = None) -> None:
    """Fail fast on a dp / tp combination the layout cannot take: the
    number of ranks, ``batch_size % dp == 0`` (each dp shard takes an equal
    slice of the batch), and that tp divides every head count and hidden
    dim the tp layout shards (encoder heads, geometric heads nhead // 2,
    the 4-head global pool, ff, the decoder's EGNN hidden dim)."""
    errors = []
    if dp < 1 or tp < 1:
        errors.append(f"dp={dp} and tp={tp} must be >= 1")
    if n_devices is not None and dp * tp > n_devices:
        errors.append(f"mesh dp={dp} x tp={tp} needs {dp * tp} devices, "
                      f"but only {n_devices} are available")
    if dp > 1 and batch_size % dp != 0:
        errors.append(
            f"batch_size={batch_size} is not divisible by dp={dp}: every "
            "dp shard must take an equal slice of the batch (pick "
            f"batch_size a multiple of {dp})")
    if tp > 1 and model_cfg is not None:
        geo = max(model_cfg.nhead // 2, 1)
        for what, dim in ((f"encoder attention heads (nhead={model_cfg.nhead})",
                           model_cfg.nhead),
                          (f"geometric attention heads (nhead//2={geo})", geo),
                          ("global latent-pool heads (4)", 4),
                          (f"FFN hidden dim (ff={model_cfg.ff})", model_cfg.ff),
                          ("decoder EGNN hidden dim (decoder_hidden="
                           f"{model_cfg.decoder_hidden})", model_cfg.decoder_hidden)):
            if dim % tp != 0:
                errors.append(f"tp={tp} does not divide the {what}, which the "
                              "Megatron TP layout shards")
    if errors:
        raise ValueError("invalid mesh configuration:\n  - " + "\n  - ".join(errors))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (dp, tp) grid and its two process groups
    (None outside an initialised process group)."""

    dp: int
    tp: int
    rank: int = 0
    dp_group: object = None
    tp_group: object = None

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    def tp_info(self) -> Optional[TP]:
        """The tp layout's ``TP``; None when tp = 1 (nothing is sharded)."""
        return TP(self.tp_rank, self.tp, self.tp_group) if self.tp > 1 else None

    def without_dp(self) -> "Mesh":
        """The same tp group, with no dp reduction: a step that runs the
        whole batch on every dp rank."""
        return dataclasses.replace(self, dp_group=None)

    def dp_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the dp group, in place."""
        dist.all_reduce(t, group=self.dp_group)
        return t

    def tp_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the tp group, in place."""
        dist.all_reduce(t, group=self.tp_group)
        return t


def make_mesh(dp: int = 1, tp: int = 1) -> Mesh:
    """The (dp, tp) mesh of this process. With an initialised process group
    of ``dp * tp`` ranks it creates every dp and tp group (each rank takes
    part in creating all of them); a group of one rank still runs its
    collectives. Without one, dp = tp = 1 gives a mesh with no groups."""
    n = dp * tp
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"mesh {dp}x{tp} needs {n} ranks: initialise the "
                             "process group first (launch / initialize_multihost)")
        return Mesh(dp, tp)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"mesh {dp}x{tp} needs {n} ranks, the process group has {world}")
    grid = np.arange(n).reshape(dp, tp)
    dp_group = tp_group = None
    for t in range(tp):
        g = dist.new_group(grid[:, t].tolist())
        if rank in grid[:, t]:
            dp_group = g
    for d in range(dp):
        g = dist.new_group(grid[d].tolist())
        if rank in grid[d]:
            tp_group = g
    return Mesh(dp, tp, rank, dp_group, tp_group)


def tp_param_specs(model: torch.nn.Module) -> dict[str, Optional[int]]:
    """Parameter name -> the dim tp shards (None: whole on every rank), the
    JAX package's ``tp_param_pspecs`` by the port's names and layouts."""
    return {name: tp_param_dim(name, p.ndim) for name, p in model.named_parameters()}


def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Keep this rank's tp shard of every sharded parameter of ``model`` (a
    ``HierCVAE`` with its full weights) and set each module's tp role. With
    tp = 1 the model is unchanged. The band kernels are single-device, so a
    tp-sharded decoder must run the plain band path."""
    from protein_ensemble_vae_torch.models.bridge import shard_params
    from protein_ensemble_vae_torch.models.decoder import EGNNBandLayer
    from protein_ensemble_vae_torch.models.encoder import MultiHeadDotProductAttention
    from protein_ensemble_vae_torch.models.init import Linear

    tp = mesh.tp_info()
    if tp is None:
        return model
    if model.config.use_pallas_egnn is not False:
        raise ValueError("tp > 1 needs use_pallas_egnn=False: the EGNN band "
                         "and clash kernels are single-device")
    params = dict(model.named_parameters())
    local = shard_params({k: p.detach() for k, p in params.items()}, tp.rank, tp.size)
    for name, p in params.items():
        p.data = local[name].clone()
    for name, m in model.named_modules():
        if isinstance(m, Linear):
            m.tp_mode = {0: "column", 1: "row"}.get(tp_param_dim(f"{name}.weight", 2))
            m.tp = tp if m.tp_mode else None
        elif isinstance(m, (MultiHeadDotProductAttention, EGNNBandLayer)):
            m.tp = tp
    model.tp = tp
    return model


def shard_batch(batch, mesh: Mesh):
    """This dp shard's rows of a host or device batch (a nested dict of
    arrays or tensors with the batch on the leading axis)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if mesh.dp == 1:
        return batch
    b = batch.shape[0] // mesh.dp
    return batch[mesh.dp_rank * b:(mesh.dp_rank + 1) * b]


def make_parallel_step(mesh: Mesh) -> Callable:
    """The counterpart of ``make_parallel_jit``: a wrapper for a step made
    by ``make_train_step(..., mesh=mesh)`` that takes the global batch and
    passes this rank its rows (each single-host rank builds the same global
    batches; a multi-host rank is fed its own shard and needs no wrapper)."""
    def wrapper(step_fn):
        def call(state, batch, *args, **kw):
            return step_fn(state, shard_batch(batch, mesh), *args, **kw)
        return call
    return wrapper


# ---------------------------------------------------------------------------
# Process groups and launching
# ---------------------------------------------------------------------------

def rank_device(device: str, local_rank: int, local_world: int,
                cards_everywhere: Optional[bool] = None) -> tuple[torch.device, str]:
    """A rank's device and backend (the module docstring's rule), from its
    index ``local_rank`` among the ``local_world`` ranks on its host:
    ``cuda:local_rank`` when the host has a card for each of its ranks,
    else the host's one card ``device`` names, shared. The backend is NCCL
    when ``cards_everywhere`` (every host of the world has a card for each
    of its ranks; None: this host is the whole world), else gloo."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev, "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is available")
    own = torch.cuda.device_count() >= local_world
    if cards_everywhere is None:
        cards_everywhere = own
    card = torch.device("cuda", local_rank) if own else torch.device("cuda", dev.index or 0)
    return card, "nccl" if cards_everywhere else "gloo"


def host_layout(posts: Sequence[tuple[str, int]], rank: int) -> tuple[int, int, bool]:
    """From every rank's (host name, CUDA card count), in rank order: rank
    ``rank``'s index among the ranks on its host, their number, and whether
    every host has a card for each of its ranks (``rank_device``'s
    arguments)."""
    hosts = [h for h, _ in posts]
    local = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    return local.index(rank), len(local), all(n >= hosts.count(h) for h, n in posts)


def current_device(device: str) -> torch.device:
    """This rank's device in an initialised process group: the card that
    ``init_process_group`` set (``rank_device``'s choice), or ``device``
    off CUDA."""
    dev = torch.device(device)
    return torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" else dev


def init_process_group(store, rank: int, world: int, backend: str,
                       device: torch.device, timeout_s: float) -> None:
    """Join the world over ``store``; every collective then waits at most
    ``timeout_s``."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: str = "cuda",
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Multi-host entry: this process becomes rank ``process_id`` of
    ``num_processes``, meeting at ``coordinator_address`` (host:port, served
    by rank 0). Absent arguments come from the ``torchrun`` environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). Every rank posts its host
    name and card count on the store, so each finds its place among the
    ranks of its host (``host_layout``) and all agree on the backend.
    Returns the rank's device."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = int(num_processes if num_processes is not None else env["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else env["RANK"])
    host, port = coordinator_address.rsplit(":", 1)
    wait = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=wait)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    store.set(f"pev-host/{rank}", json.dumps([socket.gethostname(), cards]))
    keys = [f"pev-host/{r}" for r in range(world)]
    store.wait(keys, wait)
    posts = [tuple(json.loads(store.get(k))) for k in keys]
    dev, backend = rank_device(device, *host_layout(posts, rank))
    init_process_group(store, rank, world, backend, dev, timeout_s)
    return dev


def coordination_barrier(name: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Block until every rank reaches the barrier ``name`` (each name once),
    through the process group's store, not a device collective; raises
    after ``timeout_s``. A no-op with one process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    store = dist.distributed_c10d._get_default_store()
    key = f"pev-barrier/{name}"
    if store.add(key, 1) == dist.get_world_size():
        store.set(key + "/open", "1")
    store.wait([key + "/open"], datetime.timedelta(seconds=timeout_s))


def build_kernels_first(timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Rank 0 builds every CUDA source; the other ranks wait for it, then
    load the libraries it wrote (``ops/kernels/build.py`` writes each one
    atomically), so N ranks do not run N builds at once."""
    from protein_ensemble_vae_torch.ops.kernels import SOURCES
    from protein_ensemble_vae_torch.ops.kernels.build import build

    if not dist.is_initialized() or dist.get_rank() == 0:
        build(sorted(set(SOURCES.values())))
    coordination_barrier("kernels-built", timeout_s)


def _rank_entry(fn, rank: int, world: int, store_path: str, device: str,
                timeout_s: float, args: tuple, results) -> None:
    """A launched rank: join the world, run ``fn(*args)``, report its result
    (or its traceback) on ``results``."""
    try:
        torch.set_num_threads(1)
        dev, backend = rank_device(device, rank, world)   # one host
        store = dist.FileStore(store_path, world)
        init_process_group(store, rank, world, backend, dev, timeout_s)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def stop_rank_servers() -> None:
    """Stop the forkserver that ``launch`` forks ranks from, then
    multiprocessing's resource tracker, and wait for each to exit. Left
    alone, each exits only after the program that started it has ended, so
    it would outlive that program for a moment. Both start again at the
    next ``launch``."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def launch(fn: Callable, world: int, args: Sequence = (), *, device: str,
           timeout_s: Optional[float] = None, store_dir: Optional[str] = None,
           collective_timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(*args)`` in ``world`` new processes, one rank each, joined
    over a ``FileStore`` in ``store_dir`` (a new temporary directory when
    None); ``fn`` and ``args`` must pickle (``fn`` by its import path).
    ``device`` ("cuda" or "cpu") has no default, so no caller falls to the
    CPU unnoticed. Returns the ranks' results in rank order. Raises, after
    stopping every rank, when a rank fails or exits without a result, or
    when ``timeout_s`` passes (None: no limit; the collectives' own limit is
    ``collective_timeout_s``)."""
    import multiprocessing as mp

    # Ranks fork from one server process that imported torch and the port
    # once (a fresh interpreter: no threads, no CUDA context), rather than
    # each importing them anew as under "spawn".
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["protein_ensemble_vae_torch.train.training"])
    global _STOP_AT_EXIT
    if not _STOP_AT_EXIT:
        atexit.register(stop_rank_servers)
        _STOP_AT_EXIT = True
    with tempfile.TemporaryDirectory(prefix="pev-ranks-", dir=store_dir) as tmp:
        store_path = os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_entry, daemon=True,
                             args=(fn, r, world, store_path, device,
                                   collective_timeout_s, tuple(args), results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        got: dict[int, object] = {}
        try:
            while len(got) < world:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and not p.is_alive()]
                    if dead:
                        # a rank may exit just after putting its result
                        try:
                            rank, ok, out = results.get(timeout=5.0)
                        except queue_mod.Empty:
                            raise RuntimeError(
                                f"rank(s) {dead} of {world} exited without a result "
                                f"(exit codes {[procs[r].exitcode for r in dead]})")
                    elif deadline is not None and time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world} ranks did not finish within {timeout_s:.0f} s "
                            f"({sorted(got)} did)")
                    else:
                        continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
                got[rank] = out
            for p in procs:
                p.join(timeout=30)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        return [got[r] for r in range(world)]
