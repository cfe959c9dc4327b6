"""Loss and metric functions (Keras-name compatible).

Counterpart of the JAX package's ``deepsphere_tpu.train.losses``: the same
names, the same reductions and the same ``_EPS`` clip of probabilities,
as plain torch functions of ``(y_true, y_pred)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["resolve_loss", "resolve_metric"]

_EPS = 1e-7


def sparse_categorical_crossentropy(y_true, y_pred, from_logits=False):
    if from_logits:
        logp = F.log_softmax(y_pred, dim=-1)
    else:
        logp = torch.log(torch.clamp(y_pred, _EPS, 1.0))
    y_true = y_true.long().reshape(y_pred.shape[:-1])
    picked = torch.gather(logp, -1, y_true[..., None])[..., 0]
    return -picked.mean()


def categorical_crossentropy(y_true, y_pred, from_logits=False):
    if from_logits:
        logp = F.log_softmax(y_pred, dim=-1)
    else:
        logp = torch.log(torch.clamp(y_pred, _EPS, 1.0))
    return -(y_true * logp).sum(-1).mean()


def mean_squared_error(y_true, y_pred):
    return ((y_pred - y_true) ** 2).mean()


def mean_absolute_error(y_true, y_pred):
    return (y_pred - y_true).abs().mean()


def binary_crossentropy(y_true, y_pred, from_logits=False):
    if from_logits:
        return (torch.clamp_min(y_pred, 0) - y_pred * y_true
                + torch.log1p(torch.exp(-y_pred.abs()))).mean()
    p = torch.clamp(y_pred, _EPS, 1 - _EPS)
    return -(y_true * torch.log(p) + (1 - y_true) * torch.log(1 - p)).mean()


def _from_logits(fn):
    def wrapped(y_true, y_pred):
        return fn(y_true, y_pred, from_logits=True)

    wrapped.__name__ = fn.__name__ + "_from_logits"
    return wrapped


_LOSSES = {
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "sparse_categorical_crossentropy_from_logits": _from_logits(
        sparse_categorical_crossentropy
    ),
    "categorical_crossentropy": categorical_crossentropy,
    "categorical_crossentropy_from_logits": _from_logits(categorical_crossentropy),
    "binary_crossentropy_from_logits": _from_logits(binary_crossentropy),
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "binary_crossentropy": binary_crossentropy,
}


def sparse_categorical_accuracy(y_true, y_pred):
    pred = torch.argmax(y_pred, dim=-1)
    return (pred == y_true.to(pred.dtype).reshape(pred.shape)).float().mean()


_METRICS = {
    "accuracy": sparse_categorical_accuracy,
    "sparse_categorical_accuracy": sparse_categorical_accuracy,
    "mse": mean_squared_error,
    "mae": mean_absolute_error,
}


def resolve_loss(loss):
    if callable(loss):
        return loss
    if isinstance(loss, str) and loss in _LOSSES:
        return _LOSSES[loss]
    raise ValueError(f"Unknown loss: {loss}")


def resolve_metric(metric):
    if callable(metric):
        return metric
    if isinstance(metric, str) and metric in _METRICS:
        return _METRICS[metric]
    raise ValueError(f"Unknown metric: {metric}")
