from protein_ensemble_vae_torch.utils.logging import MetricLogger  # noqa: F401
