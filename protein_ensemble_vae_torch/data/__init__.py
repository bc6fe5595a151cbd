from protein_ensemble_vae_torch.data.dataset import (  # noqa: F401
    Conformer,
    EnsembleDataset,
    SingleConformerView,
)
from protein_ensemble_vae_torch.data.collate import (  # noqa: F401
    ConformerBatch,
    PairBatch,
    bucket_for,
    make_epoch_batches,
    make_prepadded_factory,
    make_sharded_epoch_batches,
    pad_conformers,
)
from protein_ensemble_vae_torch.data.synthetic import (  # noqa: F401
    make_synthetic_dataset,
    nerf_ensemble,
    write_synthetic_h5,
)
