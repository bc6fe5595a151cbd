"""PyTorch + CUDA port of protein_ensemble_vae (hierarchical conditional VAE
for protein conformational ensembles), for NVIDIA Hopper GPUs.

Imports ``torch`` and never JAX. The JAX package beside it is the
reference this package is held against in the tests.
"""
