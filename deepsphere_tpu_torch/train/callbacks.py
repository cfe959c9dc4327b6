"""Keras-style training callbacks for :meth:`~.trainer.Trainer.fit`.

Counterpart of the JAX package's ``deepsphere_tpu.train.callbacks``: only
the epoch-granular hooks exist, so the training loop never waits on the
card between batches.
"""

from __future__ import annotations

from .._logger import logger

__all__ = ["Callback", "EarlyStopping", "ModelCheckpoint", "LambdaCallback"]


class Callback:
    """Base: ``set_trainer`` is called by fit; override the hooks."""

    trainer = None

    def set_trainer(self, trainer):
        self.trainer = trainer

    def on_train_begin(self, logs=None):
        pass

    def on_epoch_end(self, epoch, logs):
        pass

    def on_train_end(self, logs=None):
        pass


def _monitor_improved(mode, monitor, best, current, min_delta):
    if mode == "auto":
        mode = "max" if ("acc" in monitor or monitor.endswith("auc")) else "min"
    if best is None:
        return True
    if mode == "max":
        return current > best + min_delta
    return current < best - min_delta


class EarlyStopping(Callback):
    """Stop when ``monitor`` hasn't improved for ``patience`` epochs.

    ``restore_best_weights=True`` snapshots params/batch_stats at the
    best epoch (host copies) and restores them when training stops.
    """

    def __init__(self, monitor="val_loss", min_delta=0.0, patience=0,
                 mode="auto", restore_best_weights=False, verbose=0):
        self.monitor = monitor
        self.min_delta = float(min_delta)
        self.patience = int(patience)
        self.mode = mode
        self.restore_best_weights = restore_best_weights
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.best = None
        self.wait = 0
        self.best_epoch = -1
        self._best_state = None

    def on_epoch_end(self, epoch, logs):
        current = logs.get(self.monitor)
        if current is None:
            logger.info(
                f"EarlyStopping: monitor '{self.monitor}' not in logs "
                f"{sorted(logs)} — skipping"
            )
            return
        if _monitor_improved(self.mode, self.monitor, self.best, current,
                             self.min_delta):
            self.best, self.wait, self.best_epoch = current, 0, epoch
            if self.restore_best_weights:
                s = self.trainer.state
                self._best_state = (
                    {k: v.detach().cpu().clone() for k, v in s.params.items()},
                    {k: v.detach().cpu().clone()
                     for k, v in s.batch_stats.items()},
                )
            return
        self.wait += 1
        if self.wait > self.patience:
            self.trainer.stop_training = True
            if self.verbose:
                logger.info(
                    f"EarlyStopping: stopping at epoch {epoch + 1} (best "
                    f"{self.monitor}={self.best:.6g} @ epoch "
                    f"{self.best_epoch + 1})"
                )

    def on_train_end(self, logs=None):
        if self.restore_best_weights and self._best_state is not None:
            params, stats = self._best_state
            self.trainer.load_state_arrays(params, stats)


class ModelCheckpoint(Callback):
    """Write model weights after each epoch (optionally best-only).

    ``filepath`` may contain ``{epoch}`` / metric fields like Keras
    (``"w-{epoch:02d}-{val_loss:.3f}.pt"``).
    """

    def __init__(self, filepath, monitor="val_loss", save_best_only=False,
                 mode="auto", verbose=0):
        self.filepath = str(filepath)
        self.monitor = monitor
        self.save_best_only = save_best_only
        self.mode = mode
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.best = None

    def on_epoch_end(self, epoch, logs):
        if self.save_best_only:
            current = logs.get(self.monitor)
            if current is None or not _monitor_improved(
                self.mode, self.monitor, self.best, current, 0.0
            ):
                return
            self.best = current
        path = self.filepath.format(epoch=epoch + 1, **logs)
        self.trainer.model.save_weights(path)
        if self.verbose:
            logger.info(f"ModelCheckpoint: saved {path}")


class LambdaCallback(Callback):
    """Ad-hoc hooks: ``LambdaCallback(on_epoch_end=lambda ep, logs: ...)``."""

    def __init__(self, on_train_begin=None, on_epoch_end=None,
                 on_train_end=None):
        self._b, self._e, self._t = on_train_begin, on_epoch_end, on_train_end

    def on_train_begin(self, logs=None):
        if self._b:
            self._b(logs)

    def on_epoch_end(self, epoch, logs):
        if self._e:
            self._e(epoch, logs)

    def on_train_end(self, logs=None):
        if self._t:
            self._t(logs)
