from protein_ensemble_vae_torch.models.encoder import (  # noqa: F401
    SinusoidalPE,
    DihedralAwareEncoder,
    HierLatent,
    ProteinEncoder,
)
from protein_ensemble_vae_torch.models.decoder import (  # noqa: F401
    EGNNBandLayer,
    EGNNDecoder,
)
from protein_ensemble_vae_torch.models.vae import HierCVAE  # noqa: F401
