"""PyTorch + CUDA port of protein_ensemble_vae (hierarchical conditional VAE
for protein conformational ensembles), for NVIDIA Hopper GPUs.

Imports ``torch`` and never JAX. The JAX package beside it is the
reference this package is held against in the tests.
"""

__version__ = "0.1.0"

from protein_ensemble_vae_torch.config import (  # noqa: F401, E402
    ModelConfig,
    LossWeights,
    TrainConfig,
)
