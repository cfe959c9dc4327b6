"""HEALPix-aware layer API: concrete layers + deferred graph-layer factories.

Counterpart of the JAX package's ``deepsphere_tpu.nn.healpy_layers`` (its
graph conv family; attention and smoothing are not ported yet).  The
concrete resolution layers (``HealpyPool``, ``HealpyPseudoConv``,
``HealpyPseudoConv_Transpose``) change the nside; the deferred factories
(``HealpyChebyshev``, ``HealpyMonomial``, ``HealpyBernstein``,
``Healpy_ResidualLayer``) hold hyperparameters and are instantiated by the
model assembler once the graph for the current resolution is built,
through ``_get_layer(graph)``.
"""

from __future__ import annotations

from .layers import (
    BernsteinConv,
    ChebyshevConv,
    Dense,
    Flatten,
    HealpyPool,
    HealpyPseudoConv,
    HealpyPseudoConv_Transpose,
    MonomialConv,
    ResidualLayer,
)

__all__ = [
    "HealpyPool",
    "HealpyPseudoConv",
    "HealpyPseudoConv_Transpose",
    "HealpyChebyshev",
    "HealpyMonomial",
    "HealpyBernstein",
    "Healpy_ResidualLayer",
    "Flatten",
    "Dense",
]


class _DeferredLayer:
    """Holds hyperparameters until the assembler provides the graph."""

    needs = "L"

    def _get_layer(self, graph):
        raise NotImplementedError


class _DeferredPolyConv(_DeferredLayer):
    _conv = None

    def __init__(self, K, Fout=None, initializer=None, activation=None,
                 use_bias=False, use_bn=False, **kwargs):
        self.K = K
        self.Fout = Fout
        self.initializer = initializer
        self.activation = activation
        self.use_bias = use_bias
        self.use_bn = use_bn
        self.kwargs = kwargs

    def _get_layer(self, graph, **extra):
        return self._conv(
            graph=graph, K=self.K, Fout=self.Fout, initializer=self.initializer,
            activation=self.activation, use_bias=self.use_bias, use_bn=self.use_bn,
            **self.kwargs, **extra,
        )


class HealpyChebyshev(_DeferredPolyConv):
    _conv = ChebyshevConv


class HealpyMonomial(_DeferredPolyConv):
    _conv = MonomialConv


class HealpyBernstein(_DeferredPolyConv):
    _conv = BernsteinConv


class Healpy_ResidualLayer(_DeferredLayer):
    def __init__(self, layer_type, layer_kwargs, activation=None, act_before=False,
                 use_bn=False, norm_type="batch_norm", bn_kwargs=None, alpha=1.0):
        self.layer_type = layer_type
        self.layer_kwargs = layer_kwargs
        self.activation = activation
        self.act_before = act_before
        self.use_bn = use_bn
        self.norm_type = norm_type
        self.bn_kwargs = bn_kwargs
        self.alpha = alpha

    def _get_layer(self, graph, **extra):
        return ResidualLayer(
            graph=graph, layer_type=self.layer_type, layer_kwargs=self.layer_kwargs,
            activation=self.activation, act_before=self.act_before, use_bn=self.use_bn,
            norm_type=self.norm_type, bn_kwargs=self.bn_kwargs, alpha=self.alpha,
            **extra,
        )
