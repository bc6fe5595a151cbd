from protein_ensemble_vae_torch.utils.compile_cache import (  # noqa: F401
    enable_compilation_cache,
)
from protein_ensemble_vae_torch.utils.logging import MetricLogger  # noqa: F401
from protein_ensemble_vae_torch.utils.seeding import set_seed  # noqa: F401
