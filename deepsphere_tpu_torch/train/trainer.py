"""The training loop over a HealpyGCNN.

Counterpart of the JAX package's ``deepsphere_tpu.train.trainer``: the
Keras ``compile``/``fit`` surface (``train_on_batch``, ``test_on_batch``,
``fit``, ``evaluate``, ``predict``) over an optimizer step.  The model's
parameters and batch-norm statistics live in its modules, on the model's
device; a float optimizer is ``torch.optim.Adam(lr)``, whose defaults
(beta 0.9 / 0.999, eps 1e-8) are ``optax.adam``'s.  Batch-norm statistics
update in ``model.train()`` mode, as flax's mutable ``batch_stats`` do.

Data-parallel training (``data_sharding=parallel.batch_sharding(mesh)``):
every rank runs this trainer on its rows of each global batch.  Its loss is
its rows' mean over the number of data ranks (its local sum over the global
batch size), and after the backward every gradient is summed over the data
group, so every rank takes the global batch's step; the sharded convs have
already summed their kernel gradients over the pixel group.  The optimizer
state and the batch-norm statistics (global-batch moments) stay identical
on every rank.  The logged loss and metrics are the global batch's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .._logger import logger
from ..parallel.data import data_iterator
from ..parallel.mesh import BatchSharding
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
    :param data_sharding: optional
        :func:`~deepsphere_tpu_torch.parallel.batch_sharding` of the model's
        mesh: ``train_on_batch`` and ``test_on_batch`` then take this rank's
        rows, and ``fit``/``evaluate`` draw them through
        :func:`~deepsphere_tpu_torch.parallel.data_iterator`
    """

    def __init__(self, model, optimizer=1e-3,
                 loss="sparse_categorical_crossentropy", metrics=(),
                 data_sharding=None):
        if data_sharding is not None and not isinstance(data_sharding,
                                                        BatchSharding):
            raise TypeError(
                "data_sharding: expected parallel.batch_sharding(mesh), got "
                f"{type(data_sharding).__name__}")
        self.data_sharding = data_sharding
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
        """Loss and metrics as floats: under data sharding the means over
        the global batch, from each rank's means over its rows (a rank with
        no rows contributes nothing)."""
        logs = {"loss": loss.detach()}
        with torch.no_grad():
            for name, fn in self.metric_fns.items():
                logs[name] = fn(yb, y_pred.detach())
        n = float(yb.shape[0])
        if n == 0:
            logs = {k: 0.0 for k in logs}
        if self.data_sharding is not None:
            f64 = dict(dtype=torch.float64, device=yb.device)
            t = torch.stack([torch.as_tensor(v, **f64) * n
                             for v in logs.values()]
                            + [torch.tensor(n, **f64)])
            dist.all_reduce(t, group=self.data_sharding.group)
            logs = dict(zip(logs, (t[:-1] / t[-1]).tolist()))
        return {k: float(v) for k, v in logs.items()}

    def _sum_grads(self):
        """Sum every parameter gradient over the data group (one
        all-reduce of the concatenated gradients)."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.data_sharding.group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def train_on_batch(self, x, y):
        if self.optimizer is None:
            self.init_state()
        dev = self._device()
        xb, yb = _batch(x, dev), _batch(y, dev)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        y_pred = self.model(xb)
        loss = self.loss_fn(yb, y_pred)
        if self.data_sharding is None:
            loss.backward()
        else:
            # this rank's rows' sum over the global batch size; the ranks'
            # gradients then sum to the global batch's
            (loss / self.data_sharding.n_shards).backward()
            self._sum_grads()
        self.optimizer.step()
        self.step += 1
        return self._logs(yb, y_pred, loss)

    def test_on_batch(self, x, y, mask=None):
        """Eval-mode loss and metrics of a batch; ``mask`` (bool per row,
        as :func:`~deepsphere_tpu_torch.parallel.data_iterator` yields for a
        padded batch) keeps only its True rows."""
        if self.optimizer is None:
            self.init_state()
        dev = self._device()
        xb, yb = _batch(x, dev), _batch(y, dev)
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                y_pred = self.model(xb)
                if mask is not None:
                    keep = torch.as_tensor(np.asarray(mask, dtype=bool),
                                           device=dev)
                    yb, y_pred = yb[keep], y_pred[keep]
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
        batch by its size; the order is a seeded numpy permutation.  Under
        data sharding every rank passes the same ``x``/``y`` and trains on
        its rows of each global batch of ``batch_size``, drawn by
        :func:`~deepsphere_tpu_torch.parallel.data_iterator` (the same
        permutations); a trailing partial batch is dropped there.

        :param callbacks: list of :mod:`~.callbacks` objects (epoch hooks)
        """
        x = np.asarray(x)
        y = np.asarray(y)
        n = x.shape[0]
        ds = self.data_sharding
        if n == 0 or (ds is not None and n < batch_size):
            raise ValueError(f"no trainable batches: {n} samples with "
                             f"batch_size {batch_size}")
        if ds is None:
            rng = np.random.RandomState(seed)

            def epoch_batches():
                order = rng.permutation(n) if shuffle else np.arange(n)
                for start in range(0, n, batch_size):
                    sel = order[start:start + batch_size]
                    yield x[sel], y[sel]
        else:
            if n % batch_size:
                logger.info(f"WARNING: dropping the trailing partial batch "
                            f"of {n % batch_size} samples under data sharding")
            it = data_iterator(ds.mesh, x, y, batch_size, shuffle=shuffle,
                               seed=seed, data_axis=ds.data_axis,
                               epochs=epochs)

            def epoch_batches():
                for _ in range(n // batch_size):
                    yield next(it)
        history = {}
        if self.optimizer is None:
            self.init_state()
        callbacks = list(callbacks or [])
        self.stop_training = False
        for cb in callbacks:
            cb.set_trainer(self)
            cb.on_train_begin()

        for epoch in range(epochs):
            t0 = time.time()
            epoch_logs = []
            sizes = []
            for xb, yb in epoch_batches():
                epoch_logs.append(self.train_on_batch(xb, yb))
                sizes.append(len(xb))
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
        # batches in order: the same slices on every rank, or under data
        # sharding each rank's rows of them (a padded trailing batch masked)
        if self.data_sharding is None:
            batches = ((x[s:s + batch_size], y[s:s + batch_size])
                       for s in range(0, n, batch_size))
        else:
            batches = data_iterator(self.data_sharding.mesh, x, y, batch_size,
                                    shuffle=False, drop_remainder=False,
                                    data_axis=self.data_sharding.data_axis)
        logs = []
        sizes = []
        for start, batch in zip(range(0, n, batch_size), batches):
            logs.append(self.test_on_batch(*batch))
            sizes.append(min(batch_size, n - start))
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
