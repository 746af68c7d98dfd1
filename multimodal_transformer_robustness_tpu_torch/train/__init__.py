"""Training: configuration sampling, optimizers and the Trainer."""

from .loop import ReduceLROnPlateau, TrainHParams, Trainer, make_criterion
from .optim import TORCH_DEFAULT_OPTIMIZERS, make_optimizer
from .sampling import sample_train_config

__all__ = [
    "ReduceLROnPlateau",
    "TrainHParams",
    "Trainer",
    "make_criterion",
    "TORCH_DEFAULT_OPTIMIZERS",
    "make_optimizer",
    "sample_train_config",
]
