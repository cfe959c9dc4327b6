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
from .smoothing import HealpySmoothing, SmoothingOperator
from .transformers import AddPositionEmbs, GraphTransformer, GraphViT, MultiHeadAttention
from .healpy_layers import (
    Healpy_ResidualLayer,
    Healpy_Transformer,
    Healpy_ViT,
    HealpyBernstein,
    HealpyChebyshev,
    HealpyMonomial,
)

__all__ = [
    "ChebyshevConv",
    "MonomialConv",
    "BernsteinConv",
    "ResidualLayer",
    "HealpyPool",
    "HealpyPseudoConv",
    "HealpyPseudoConv_Transpose",
    "HealpySmoothing",
    "SmoothingOperator",
    "AddPositionEmbs",
    "MultiHeadAttention",
    "GraphViT",
    "GraphTransformer",
    "Healpy_ViT",
    "HealpyChebyshev",
    "HealpyMonomial",
    "HealpyBernstein",
    "Healpy_ResidualLayer",
    "Healpy_Transformer",
    "Flatten",
    "Dense",
]
