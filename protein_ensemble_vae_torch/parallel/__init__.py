"""Data and tensor parallelism on ``torch.distributed`` (counterpart of the
JAX package's ``parallel/``)."""

from protein_ensemble_vae_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    coordination_barrier,
    initialize_multihost,
    launch,
    make_mesh,
    make_parallel_step,
    shard_batch,
    shard_model,
    stop_rank_servers,
    tp_param_specs,
    validate_mesh_config,
)
