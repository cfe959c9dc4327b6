"""HEALPix-aware layer API: concrete layers + deferred graph-layer factories.

Counterpart of the JAX package's ``deepsphere_tpu.nn.healpy_layers`` (the
subset the quick_start classifier needs).  The deferred factories
(``HealpyChebyshev``, ``HealpyMonomial``) hold hyperparameters and are
instantiated by the model assembler once the graph for the current
resolution is built, through ``_get_layer(graph)``.
"""

from __future__ import annotations

from .layers import ChebyshevConv, Dense, Flatten, HealpyPool, MonomialConv

__all__ = [
    "HealpyPool",
    "HealpyChebyshev",
    "HealpyMonomial",
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
