"""Training of the port's LM stack: AdamW and the microbatched train step,
as in the JAX package's ``train/``."""
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update, adamw_update_
from repro_torch.train.train_loop import TrainState, make_train_step, train_state_specs

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "adamw_update_",
    "TrainState",
    "make_train_step",
    "train_state_specs",
]
