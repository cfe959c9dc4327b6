"""The training loop over a HealpyGCNN.

Counterpart of the JAX package's ``deepsphere_tpu.train.trainer``: the
Keras ``compile``/``fit`` surface (``train_on_batch``, ``test_on_batch``,
``fit``, ``evaluate``, ``predict``) over an optimizer step.  The model's
parameters and batch-norm statistics live in its modules, on the model's
device; a float optimizer is ``torch.optim.Adam(lr)``, whose defaults
(beta 0.9 / 0.999, eps 1e-8) are ``optax.adam``'s.  Batch-norm statistics
update in ``model.train()`` mode, as flax's mutable ``batch_stats`` do.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .._logger import logger
from .losses import resolve_loss, resolve_metric

__all__ = ["Trainer", "TrainState"]


@dataclass
class TrainState:
    """A view of the live training state: parameters and batch statistics
    by ``state_dict`` name (the model's own tensors), the optimizer's
    ``state_dict()`` and the step count."""

    params: Any
    batch_stats: Any
    opt_state: Any
    step: int = 0


def _batch(a, dev):
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    if t.is_floating_point():
        t = t.float()
    return t.to(dev)


class Trainer:
    """Drives the train/eval steps of a model.

    :param model: a built :class:`~deepsphere_tpu_torch.models.HealpyGCNN`
        (or any module with ``_built_input_shape`` and ``_predict``)
    :param optimizer: a learning rate (-> Adam), a ``torch.optim.Optimizer``
        over the model's parameters, or a callable ``params -> Optimizer``;
        it is created at the first step, once the parameters exist
    :param loss: loss name or callable ``loss(y_true, y_pred)``
    :param metrics: list of metric names / callables
    :param data_sharding: not ported yet; anything but None raises
    """

    def __init__(self, model, optimizer=1e-3,
                 loss="sparse_categorical_crossentropy", metrics=(),
                 data_sharding=None):
        if data_sharding is not None:
            raise NotImplementedError(
                "data_sharding: data-parallel training is not ported yet "
                "(ROADMAP.md, queue 1, step 17)")
        self.model = model
        self._optimizer_spec = optimizer
        self.optimizer = None
        self.loss_fn = resolve_loss(loss)
        self.metric_fns = {
            (m if isinstance(m, str) else getattr(m, "__name__", f"metric_{i}")): resolve_metric(m)
            for i, m in enumerate(metrics)
        }
        self.step = 0
        self.stop_training = False

    # ------------------------------------------------------------------

    def init_state(self):
        """Create the optimizer over the (built) model's parameters."""
        if getattr(self.model, "_built_input_shape", None) is None:
            raise ValueError("Build the model first (model.build(input_shape)).")
        params = list(self.model.parameters())
        spec = self._optimizer_spec
        if isinstance(spec, (int, float)):
            self.optimizer = torch.optim.Adam(params, lr=float(spec))
        elif isinstance(spec, torch.optim.Optimizer):
            self.optimizer = spec
        else:
            self.optimizer = spec(params)
        self.step = 0
        return self.state

    @property
    def state(self):
        """The live :class:`TrainState`, or None before the first step."""
        if self.optimizer is None:
            return None
        params = dict(self.model.named_parameters())
        stats = {k: v for k, v in self.model.state_dict().items()
                 if k not in params}
        return TrainState(params, stats, self.optimizer.state_dict(),
                          self.step)

    def _device(self):
        return next(self.model.parameters()).device

    def _logs(self, yb, y_pred, loss):
        logs = {"loss": loss.detach()}
        with torch.no_grad():
            for name, fn in self.metric_fns.items():
                logs[name] = fn(yb, y_pred.detach())
        return {k: float(v) for k, v in logs.items()}

    def train_on_batch(self, x, y):
        if self.optimizer is None:
            self.init_state()
        dev = self._device()
        xb, yb = _batch(x, dev), _batch(y, dev)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        y_pred = self.model(xb)
        loss = self.loss_fn(yb, y_pred)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return self._logs(yb, y_pred, loss)

    def test_on_batch(self, x, y):
        if self.optimizer is None:
            self.init_state()
        dev = self._device()
        xb, yb = _batch(x, dev), _batch(y, dev)
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                y_pred = self.model(xb)
                loss = self.loss_fn(yb, y_pred)
        finally:
            self.model.train(was_training)
        return self._logs(yb, y_pred, loss)

    def load_state_arrays(self, params, batch_stats):
        """Copy ``params``/``batch_stats`` (by ``state_dict`` name) into the
        live model (e.g. restoring an EarlyStopping snapshot); the optimizer
        state is kept."""
        self.model.load_state_dict({**params, **batch_stats}, strict=True)

    def fit(self, x, y, batch_size=16, epochs=1, validation_data=None, shuffle=True,
            verbose=1, seed=0, callbacks=None):
        """Mini-batch epoch loop; returns a Keras-like history dict.

        The trailing partial batch is trained on; epoch means weight each
        batch by its size; the order is a seeded numpy permutation.

        :param callbacks: list of :mod:`~.callbacks` objects (epoch hooks)
        """
        x = np.asarray(x)
        y = np.asarray(y)
        n = x.shape[0]
        if n == 0:
            raise ValueError(f"no trainable batches: {n} samples")
        rng = np.random.RandomState(seed)
        history = {}
        if self.optimizer is None:
            self.init_state()
        callbacks = list(callbacks or [])
        self.stop_training = False
        for cb in callbacks:
            cb.set_trainer(self)
            cb.on_train_begin()

        for epoch in range(epochs):
            order = rng.permutation(n) if shuffle else np.arange(n)
            t0 = time.time()
            epoch_logs = []
            sizes = []
            for start in range(0, n, batch_size):
                sel = order[start:start + batch_size]
                epoch_logs.append(self.train_on_batch(x[sel], y[sel]))
                sizes.append(len(sel))
            w = np.asarray(sizes, dtype=np.float64)
            means = {
                k: float(np.average([l[k] for l in epoch_logs], weights=w))
                for k in epoch_logs[0]
            }
            if validation_data is not None:
                vx, vy = validation_data
                val = self.evaluate(vx, vy, batch_size=batch_size, verbose=0)
                means.update({f"val_{k}": v for k, v in val.items()})
            for k, v in means.items():
                history.setdefault(k, []).append(v)
            if verbose:
                msg = " - ".join(f"{k}: {v:.4f}" for k, v in means.items())
                logger.info(f"Epoch {epoch + 1}/{epochs} [{time.time() - t0:.2f}s] {msg}")
            for cb in callbacks:
                cb.on_epoch_end(epoch, means)
            if self.stop_training:
                break

        for cb in callbacks:
            cb.on_train_end()
        return history

    def evaluate(self, x, y, batch_size=16, verbose=1):
        x = np.asarray(x)
        y = np.asarray(y)
        n = x.shape[0]
        if n == 0:
            raise ValueError("evaluate() needs at least one sample, got 0")
        logs = []
        sizes = []
        for start in range(0, n, batch_size):
            xb = x[start:start + batch_size]
            yb = y[start:start + batch_size]
            logs.append(self.test_on_batch(xb, yb))
            sizes.append(len(xb))
        # per-sample averaging (Keras semantics): a trailing partial batch
        # contributes proportionally to its size, not as a full batch
        w = np.asarray(sizes, dtype=np.float64)
        means = {
            k: float(np.average([l[k] for l in logs], weights=w))
            for k in logs[0]
        }
        if verbose:
            logger.info(" - ".join(f"{k}: {v:.4f}" for k, v in means.items()))
        return means

    def predict(self, x, batch_size=16):
        return self.model._predict(x, batch_size=batch_size)
