from protein_ensemble_vae_torch.viz.training_curves import plot_training_curves  # noqa: F401
from protein_ensemble_vae_torch.viz.parameters import (  # noqa: F401
    parameter_stats,
    plot_bias_distributions,
    plot_layer_statistics,
    plot_parameter_magnitudes,
    plot_weight_distributions,
    plot_weight_heatmaps,
    visualize_parameters,
    write_parameter_summary,
)
