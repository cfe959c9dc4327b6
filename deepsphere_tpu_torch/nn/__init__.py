from .healpy_layers import HealpyChebyshev, HealpyMonomial
from .layers import ChebyshevConv, Dense, Flatten, HealpyPool, MonomialConv

__all__ = [
    "ChebyshevConv",
    "MonomialConv",
    "HealpyPool",
    "HealpyChebyshev",
    "HealpyMonomial",
    "Flatten",
    "Dense",
]
