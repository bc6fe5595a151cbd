from protein_ensemble_vae_torch.eval.metrics import (  # noqa: F401
    compute_contact_map,
    compute_ensemble_diversity,
    compute_gdt,
    compute_lddt,
    compute_radius_of_gyration,
    compute_rmsf,
    compute_tm_score,
    contact_map_overlap,
    expected_rg,
    kabsch_align_np,
)
from protein_ensemble_vae_torch.eval.ramachandran import (  # noqa: F401
    classify_ramachandran,
    phi_psi_from_backbone,
)
