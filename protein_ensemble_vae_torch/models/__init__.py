from protein_ensemble_vae_torch.models.vae import HierCVAE  # noqa: F401
