from protein_ensemble_vae_torch.ops.geometry import (  # noqa: F401
    safe_norm,
    masked_mean,
    dihedral_from_four,
    dihedrals_from_coords,
    angle_cos,
    kabsch_align,
    kabsch_rmsd,
    pairwise_distances,
    compact_valid,
    scatter_compact,
)
