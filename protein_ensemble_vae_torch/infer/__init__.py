from protein_ensemble_vae_torch.infer.gate import validate_protein_geometry  # noqa: F401
from protein_ensemble_vae_torch.infer.generate import generate_ensembles  # noqa: F401
from protein_ensemble_vae_torch.infer.pdb_io import (  # noqa: F401
    compute_backbone_oxygen,
    read_pdb_backbone,
    write_multi_model_pdb,
    write_pdb,
)
from protein_ensemble_vae_torch.infer.sequence import (  # noqa: F401
    logits_to_labels,
    sequence_accuracy_vs_string,
    sequence_to_onehot,
    tensor_to_sequence,
    to_3letter,
)
