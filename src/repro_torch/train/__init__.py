"""Training on one device: the train step and the trainer."""
from .step import TrainState, init_train_state, make_train_step
from .trainer import (TrainResult, Trainer, TrainerConfig,
                      hopaas_objective)

__all__ = ["TrainState", "init_train_state", "make_train_step",
           "Trainer", "TrainerConfig", "TrainResult", "hopaas_objective"]
