"""HEALPix-aware layer API: concrete layers + deferred graph-layer factories.

Counterpart of the JAX package's ``deepsphere_tpu.nn.healpy_layers``.  The
concrete resolution layers (``HealpyPool``, ``HealpyPseudoConv``,
``HealpyPseudoConv_Transpose``, ``Healpy_ViT``) change the nside; the
deferred factories (``HealpyChebyshev``, ``HealpyMonomial``,
``HealpyBernstein``, ``Healpy_ResidualLayer``, ``Healpy_Transformer``) hold
hyperparameters and are instantiated by the model assembler once the graph
for the current resolution is built, through ``_get_layer(graph)``;
``HealpySmoothing`` builds its operator at once, or, given no pixels, at
the assembler's resolution (``_get_layer_res``).
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
from .smoothing import HealpySmoothing as _ConcreteHealpySmoothing
from .smoothing import SmoothingOperator
from .transformers import GraphTransformer, GraphViT

__all__ = [
    "HealpyPool",
    "HealpyPseudoConv",
    "HealpyPseudoConv_Transpose",
    "HealpySmoothing",
    "SmoothingOperator",
    "Healpy_ViT",
    "HealpyChebyshev",
    "HealpyMonomial",
    "HealpyBernstein",
    "Healpy_ResidualLayer",
    "Healpy_Transformer",
    "Flatten",
    "Dense",
]


class Healpy_ViT(GraphViT):
    """:class:`GraphViT` under the reference's name; it needs no graph
    (``healpy_layers.py:381-414``)."""


class _DeferredLayer:
    """Holds hyperparameters until the assembler provides the graph."""

    needs = "L"  # or "A" (the transformer needs only the adjacency edges)

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


class _DeferredSmoothing(_DeferredLayer):
    """A smoothing spec without pixels: the assembler supplies the nside
    and indices at the layer's position in the model.  Only the resolution
    is needed, no graph Laplacian."""

    needs = "res"

    def __init__(self, mask=None, data_path=None, **smoothing_kwargs):
        self.mask = mask
        self.data_path = data_path
        self.smoothing_kwargs = smoothing_kwargs

    def _get_layer_res(self, nside, indices, cache_dir=None):
        op = SmoothingOperator(
            nside=nside, indices=indices,
            data_path=self.data_path if self.data_path is not None
            else cache_dir,
            **self.smoothing_kwargs,
        )
        return _ConcreteHealpySmoothing(operator=op, mask=self.mask)


def HealpySmoothing(operator=None, mask=None, nside=None, indices=None,
                    **smoothing_kwargs):
    """The smoothing layer, in the three call styles of the JAX package:

    * ``HealpySmoothing(operator=op)``: a prebuilt
      :class:`~deepsphere_tpu_torch.nn.smoothing.SmoothingOperator`;
    * ``HealpySmoothing(nside=..., indices=..., sigma=...)``: the
      reference's constructor surface; the operator is built at once;
    * ``HealpySmoothing(sigma=...)``: deferred; inside a ``HealpyGCNN``
      layer list the assembler supplies the nside and indices of the
      current resolution (and its ``graph_cache_dir`` as the disk cache).
    """
    if operator is not None:
        if smoothing_kwargs or nside is not None or indices is not None:
            raise ValueError(
                "operator= already fixes the smoothing; pass either an "
                "operator or smoothing parameters, not both"
            )
        return _ConcreteHealpySmoothing(operator=operator, mask=mask)
    if nside is not None or indices is not None:
        if nside is None or indices is None:
            raise ValueError("nside and indices must be given together")
        op = SmoothingOperator(nside=nside, indices=indices,
                               **smoothing_kwargs)
        return _ConcreteHealpySmoothing(operator=op, mask=mask)
    return _DeferredSmoothing(mask=mask, **smoothing_kwargs)


class Healpy_Transformer(_DeferredLayer):
    needs = "A"

    def __init__(self, key_dim, num_heads, positional_encoding=True, n_layers=1,
                 activation="relu", layer_norm=True):
        self.key_dim = key_dim
        self.num_heads = num_heads
        self.positional_encoding = positional_encoding
        self.n_layers = n_layers
        self.activation = activation
        self.layer_norm = layer_norm

    def _get_layer(self, graph, **extra):
        return GraphTransformer.from_graph(
            graph, key_dim=self.key_dim, num_heads=self.num_heads,
            positional_encoding=self.positional_encoding, n_layers=self.n_layers,
            activation=self.activation, layer_norm=self.layer_norm, **extra,
        )
