"""Training of the PyTorch port: the Keras-style trainer, losses and
metrics, epoch callbacks, full-state checkpoints, and the import of the
TF2 reference's ``.weights.h5`` checkpoints."""

from .callbacks import Callback, EarlyStopping, LambdaCallback, ModelCheckpoint
from .checkpoint import restore_checkpoint, save_checkpoint
from .import_ref import import_keras_h5
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
    "import_keras_h5",
]
