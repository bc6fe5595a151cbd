from protein_ensemble_vae_torch.dataprep.mmcif import (  # noqa: F401
    extract_metadata,
    parse_mmcif_backbone,
    parse_mmcif_categories,
    uniprot_accessions,
)
from protein_ensemble_vae_torch.dataprep.align import (  # noqa: F401
    core_fit_align,
    medoid_index,
    needleman_wunsch,
)
