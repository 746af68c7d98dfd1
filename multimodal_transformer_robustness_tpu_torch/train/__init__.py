"""Training and evaluation: configuration sampling, optimizers, the
Trainer (train step, epoch, evaluate, fit), the auxiliary loss and the
missing-modality sweep."""

from .losses import cmd
from .loop import ReduceLROnPlateau, TrainHParams, Trainer, make_criterion
from .optim import TORCH_DEFAULT_OPTIMIZERS, make_optimizer
from .sampling import sample_train_config
from .sweep import masking_inputs_sweep, missing_modality_sweep

__all__ = [
    "ReduceLROnPlateau",
    "TrainHParams",
    "Trainer",
    "make_criterion",
    "cmd",
    "TORCH_DEFAULT_OPTIMIZERS",
    "make_optimizer",
    "sample_train_config",
    "masking_inputs_sweep",
    "missing_modality_sweep",
]
