from .evaluate import evaluate, generation_metrics, reconstruction_metrics
from .loop import (
    PosteriorCollapseError,
    TrainState,
    effective_config,
    ema_eval_state,
    init_state,
    make_eval_step,
    make_optimizer,
    make_train_chunk,
    make_train_step,
    train,
)
from .loss import gaussian_kl, recon_accuracy, recon_bce, recon_ce, vae_loss
from .schedules import beta_at

__all__ = [
    "PosteriorCollapseError",
    "evaluate",
    "generation_metrics",
    "reconstruction_metrics",
    "train",
    "TrainState",
    "effective_config",
    "ema_eval_state",
    "init_state",
    "make_eval_step",
    "make_optimizer",
    "make_train_chunk",
    "make_train_step",
    "gaussian_kl",
    "recon_accuracy",
    "recon_bce",
    "recon_ce",
    "vae_loss",
    "beta_at",
]
