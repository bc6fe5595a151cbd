from protein_ensemble_vae_torch.train.kl_schedulers import (  # noqa: F401
    AdaptiveKLScheduler,
    BaseKLScheduler,
    CyclicalKLScheduler,
    ExponentialKLScheduler,
    MonotonicKLScheduler,
    create_kl_scheduler,
)
from protein_ensemble_vae_torch.train.lr_schedule import ReduceLROnPlateau  # noqa: F401
from protein_ensemble_vae_torch.train.training import (  # noqa: F401
    TrainState,
    create_train_state,
    make_train_step,
    run_epoch,
    train_model,
)
