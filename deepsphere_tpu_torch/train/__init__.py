"""Training of the PyTorch port: the Keras-style trainer, losses and
metrics, epoch callbacks and full-state checkpoints."""

from .callbacks import Callback, EarlyStopping, LambdaCallback, ModelCheckpoint
from .checkpoint import restore_checkpoint, save_checkpoint
from .losses import resolve_loss, resolve_metric
from .trainer import Trainer, TrainState

__all__ = [
    "Trainer",
    "TrainState",
    "Callback",
    "EarlyStopping",
    "ModelCheckpoint",
    "LambdaCallback",
    "resolve_loss",
    "resolve_metric",
    "save_checkpoint",
    "restore_checkpoint",
]
