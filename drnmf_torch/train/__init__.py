"""Training: the loop (Keras-style Adam, early stopping, best-only
checkpoints, elastic resume, the loss history), its losses, checkpoints, and the
SNMF dictionary recipe that initialises the model."""

from .checkpoint import load_checkpoint, save_checkpoint
from .history import LossHistory
from .loop import (KerasAdam, TrainConfig, TrainingDeadline, evaluate,
                   make_optimizer, make_train_step, train_model,
                   train_state_incomplete)
from .losses import masked_mse_signal_approx, snmf_pretrain_loss
from .snmf_recipe import train_snmf

__all__ = ["KerasAdam", "LossHistory", "TrainConfig", "TrainingDeadline",
           "evaluate",
           "load_checkpoint", "make_optimizer", "make_train_step",
           "masked_mse_signal_approx", "save_checkpoint",
           "snmf_pretrain_loss", "train_model", "train_snmf",
           "train_state_incomplete"]
