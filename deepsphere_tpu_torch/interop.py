"""Load the JAX package's model variables into the PyTorch port.

:func:`load_jax_variables` takes a JAX ``HealpyGCNN``'s (or a single flax
layer's) ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
arrays and copies them into the matching port modules:

* a conv's ``kernel`` (Fin*K, Fout), Fin-major and term-minor, and its
  ``bias`` (1, 1, Fout) load as they are; so do the batch-norm ``mean`` /
  ``var`` under ``batch_stats[...]["bn"]``;
* a ``Dense`` kernel (in, out) is transposed into ``nn.Linear.weight``;
* model-level keys ``layers_layer_{i}`` name the port's ``layer_{i}``.

The port's parameters must exist first (``HealpyGCNN.build`` or one
forward).  Any missing, unexpected or mis-shaped entry raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import HealpyGCNN
from .nn.layers import Dense, _GraphPolyConv

__all__ = ["load_jax_variables"]


def _copy(dst, src, what):
    if dst is None:
        raise ValueError(f"{what}: the port has no such parameter yet; build "
                         "the model (or run one forward) first")
    src = np.array(src, dtype=np.float32, order="C", copy=True)
    if tuple(dst.shape) != src.shape:
        raise ValueError(f"{what}: shape {src.shape} does not match the "
                         f"port's {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(src))


def _expect(tree, keys, what):
    extra = set(tree) - set(keys)
    if extra:
        raise KeyError(f"{what}: unexpected entries {sorted(extra)}")


def _load_layer(module, params, stats, what):
    if isinstance(module, _GraphPolyConv):
        _expect(params, ("kernel", "bias"), what)
        _copy(module.kernel, params["kernel"], f"{what}.kernel")
        if module.use_bias:
            _copy(module.bias, params["bias"], f"{what}.bias")
        elif "bias" in params:
            raise KeyError(f"{what}: bias given but the layer has none")
        if module.use_bn:
            bn = stats["bn"]
            _expect(bn, ("mean", "var"), f"{what}.bn")
            _copy(module.bn.mean, bn["mean"], f"{what}.bn.mean")
            _copy(module.bn.var, bn["var"], f"{what}.bn.var")
        else:
            _expect(stats, (), what)
    elif isinstance(module, Dense):
        _expect(params, ("dense",), what)
        _expect(stats, (), what)
        d = params["dense"]
        _expect(d, ("kernel", "bias"), f"{what}.dense")
        if module.dense is None:
            raise ValueError(f"{what}: build the model (or run one forward) first")
        _copy(module.dense.weight, np.asarray(d["kernel"]).T,
              f"{what}.dense.kernel")
        if module.use_bias:
            _copy(module.dense.bias, d["bias"], f"{what}.dense.bias")
    elif params or stats:
        raise KeyError(f"{what}: {type(module).__name__} has no parameters")


def load_jax_variables(model, variables):
    """Copy a JAX model's (or flax layer's) variables into ``model``.

    :param model: a built :class:`HealpyGCNN`, or one port layer
    :param variables: ``{"params": ..., "batch_stats": ...}`` as nested
        dicts of numpy arrays (``graph_tables`` is ignored: the port builds
        its own)
    :return: ``model``
    """
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    if not isinstance(model, HealpyGCNN):
        _load_layer(model, params, stats, type(model).__name__)
        return model
    for key in sorted(set(params) | set(stats)):
        name = key[len("layers_"):] if key.startswith("layers_layer_") else None
        if name not in model.layers:
            raise KeyError(f"{key}: no such layer in the port model")
        _load_layer(model.layers[name], params.get(key, {}),
                    stats.get(key, {}), key)
    for name, module in model.layers.items():
        key = f"layers_{name}"
        if (isinstance(module, (_GraphPolyConv, Dense))
                and key not in params):
            raise KeyError(f"{key}: missing from the JAX variables")
    return model
