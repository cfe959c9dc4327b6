"""Move model variables between the JAX package and the PyTorch port.

:func:`load_jax_variables` takes a JAX ``HealpyGCNN``'s (or a single flax
layer's) ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
arrays and copies them into the matching port modules:

* a conv's ``kernel`` (Fin*K, Fout), Fin-major and term-minor (Chebyshev,
  monomial, Bernstein), and its ``bias`` (1, 1, Fout) load as they are; so
  do the batch-norm ``mean`` / ``var`` under ``batch_stats[...]["bn"]``;
* a ``ResidualLayer``'s sublayers ``layer1`` / ``layer2`` load as convs,
  its norms ``bn1`` / ``bn2`` as ``scale`` / ``bias`` parameters and, for
  batch norm, ``mean`` / ``var`` statistics;
* a pseudo-conv's ``kernel`` ((4^p*Fin, Fout), or (4^p, Fin, Fout) for the
  transpose, NEST tap order in every layout) and ``bias`` (Fout,);
* a ``Dense`` kernel (in, out) is transposed into ``nn.Linear.weight``;
* the attention layers (``GraphViT``, ``GraphTransformer``,
  ``MultiHeadAttention``, ``AddPositionEmbs``) name their parameters as the
  flax modules do (``wq``/``wk``/``wv``/``dense`` kernels (in, out) and
  biases, ``layer_norm1``/``layer_norm2`` scales and biases,
  ``pos_encoder.pos_embedding``, ``embed_kernel``/``embed_bias``,
  ``embed``, ``mha_{i}``), so their trees map onto ``named_parameters``
  one to one;
* smoothing has no parameters (its tables stay out of ``state_dict``, as
  the convs' do);
* model-level keys ``layers_layer_{i}`` name the port's ``layer_{i}``.

The port's parameters must exist first (``HealpyGCNN.build`` or one
forward).  Any missing, unexpected or mis-shaped entry raises.  A sharded
model (``shard_cfg``) has the unsharded model's tree, so both functions
work on it unchanged; the JAX package's ``graph_tables`` (``stencil``,
``sharded``) are never read, since the port builds its own.

:func:`export_jax_variables` is the reverse: the port's parameters and
batch statistics (or the parameters' gradients) as the JAX tree of numpy
arrays, so tests compare whole trees.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import HealpyGCNN
from .nn.layers import (
    Dense,
    ResidualLayer,
    _BatchNorm,
    _GraphPolyConv,
    _PseudoConvBase,
)
from .nn.transformers import (
    AddPositionEmbs,
    GraphTransformer,
    GraphViT,
    MultiHeadAttention,
)

# layers whose parameters map onto the flax tree by name
_NAMED_LAYERS = (GraphViT, GraphTransformer, MultiHeadAttention,
                 AddPositionEmbs)
# the layers that hold parameters
_PARAM_LAYERS = (_GraphPolyConv, ResidualLayer, _PseudoConvBase, Dense,
                 *_NAMED_LAYERS)

__all__ = ["load_jax_variables", "export_jax_variables"]


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


def _norm_keys(bn):
    return tuple(k for k in ("scale", "bias") if getattr(bn, k) is not None)


def _load_norm(bn, params, stats, what):
    if bn is None:
        raise ValueError(f"{what}: build the model (or run one forward) first")
    keys = _norm_keys(bn)
    _expect(params, keys, what)
    for k in keys:
        _copy(getattr(bn, k), params[k], f"{what}.{k}")
    if isinstance(bn, _BatchNorm):
        _expect(stats, ("mean", "var"), what)
        _copy(bn.mean, stats["mean"], f"{what}.mean")
        _copy(bn.var, stats["var"], f"{what}.var")
    else:
        _expect(stats, (), what)


def _flat_tree(tree, pre=""):
    """Nested dict -> {"a.b.c": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{pre}{k}."))
        else:
            out[pre + k] = v
    return out


def _nested(flat):
    """{"a.b.c": leaf} -> nested dict."""
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def _named(module, what):
    """``named_parameters`` of a layer whose parameters all exist."""
    if any(p is None for m in module.modules()
           for p in m._parameters.values()):
        raise ValueError(f"{what}: build the model (or run one forward) first")
    return dict(module.named_parameters())


def _load_named(module, params, stats, what):
    """A layer whose ``named_parameters`` are the flax tree's paths."""
    _expect(stats, (), what)
    flat = _flat_tree(params)
    named = _named(module, what)
    missing, extra = set(named) - set(flat), set(flat) - set(named)
    if missing or extra:
        raise KeyError(f"{what}: missing {sorted(missing)}, unexpected "
                       f"{sorted(extra)}")
    for k, p in named.items():
        _copy(p, flat[k], f"{what}.{k}")


def _load_layer(module, params, stats, what):
    if isinstance(module, _NAMED_LAYERS):
        _load_named(module, params, stats, what)
    elif isinstance(module, ResidualLayer):
        names = ("layer1", "layer2") + (("bn1", "bn2") if module.use_bn
                                        else ())
        _expect(params, names, what)
        _expect(stats, names, what)
        for nm in ("layer1", "layer2"):
            _load_layer(getattr(module, nm), params[nm], stats.get(nm, {}),
                        f"{what}.{nm}")
        for nm in names[2:]:
            _load_norm(getattr(module, nm), params.get(nm, {}),
                       stats.get(nm, {}), f"{what}.{nm}")
    elif isinstance(module, _PseudoConvBase):
        _expect(params, ("kernel", "bias"), what)
        _expect(stats, (), what)
        _copy(module.kernel, params["kernel"], f"{what}.kernel")
        if module.use_bias:
            _copy(module.bias, params["bias"], f"{what}.bias")
        elif "bias" in params:
            raise KeyError(f"{what}: bias given but the layer has none")
    elif isinstance(module, _GraphPolyConv):
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
        if isinstance(module, _PARAM_LAYERS) and key not in params:
            raise KeyError(f"{key}: missing from the JAX variables")
    return model


def _np(t, grads):
    if grads:
        t = t.grad
        if t is None:
            raise ValueError("a parameter has no gradient; run a backward "
                             "(e.g. one train_on_batch) first")
    return t.detach().cpu().numpy().copy()


def _export_layer(module, grads):
    """(params, batch_stats) of one port layer, JAX keys, numpy."""
    params, stats = {}, {}
    if isinstance(module, _NAMED_LAYERS):
        named = _named(module, type(module).__name__)
        params = _nested({k: _np(p, grads) for k, p in named.items()})
    elif isinstance(module, ResidualLayer):
        for nm in ("layer1", "layer2"):
            p, st = _export_layer(getattr(module, nm), grads)
            params[nm] = p
            if st:
                stats[nm] = st
        for nm in (("bn1", "bn2") if module.use_bn else ()):
            bn = getattr(module, nm)
            if bn is None:
                raise ValueError("build the model (or run one forward) first")
            p = {k: _np(getattr(bn, k), grads) for k in _norm_keys(bn)}
            if p:
                params[nm] = p
            if isinstance(bn, _BatchNorm):
                stats[nm] = {"mean": bn.mean.cpu().numpy().copy(),
                             "var": bn.var.cpu().numpy().copy()}
    elif isinstance(module, _PseudoConvBase):
        if module.kernel is None:
            raise ValueError("build the model (or run one forward) first")
        params["kernel"] = _np(module.kernel, grads)
        if module.use_bias:
            params["bias"] = _np(module.bias, grads)
    elif isinstance(module, _GraphPolyConv):
        if module.kernel is None:
            raise ValueError("build the model (or run one forward) first")
        params["kernel"] = _np(module.kernel, grads)
        if module.use_bias:
            params["bias"] = _np(module.bias, grads)
        if module.use_bn:
            stats["bn"] = {"mean": module.bn.mean.cpu().numpy().copy(),
                           "var": module.bn.var.cpu().numpy().copy()}
    elif isinstance(module, Dense):
        if module.dense is None:
            raise ValueError("build the model (or run one forward) first")
        d = {"kernel": _np(module.dense.weight, grads).T.copy()}
        if module.use_bias:
            d["bias"] = _np(module.dense.bias, grads)
        params["dense"] = d
    return params, stats


def export_jax_variables(model, grads=False):
    """The port model's variables as the JAX package's tree of numpy arrays.

    :param model: a built :class:`HealpyGCNN`, or one port layer
    :param grads: False: ``{"params": ..., "batch_stats": ...}`` (the tree
        :func:`load_jax_variables` takes); True: the parameters' ``.grad``
        in the ``params`` structure (what ``jax.grad`` of a loss over the
        params returns)
    """
    if not isinstance(model, HealpyGCNN):
        params, stats = _export_layer(model, grads)
    else:
        params, stats = {}, {}
        for name, module in model.layers.items():
            p, st = _export_layer(module, grads)
            if p:
                params[f"layers_{name}"] = p
            if st:
                stats[f"layers_{name}"] = st
    if grads:
        return params
    return {"params": params, "batch_stats": stats}
