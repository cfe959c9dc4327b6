from . import attention, layout, smoothing, spmv, stencil
from . import library  # registers the kernels' custom ops (deepsphere::*)
from .spmv import (
    bernstein_basis,
    chebyshev_basis,
    ellpack_spmv,
    graph_conv,
    monomial_basis,
)

__all__ = [
    "attention",
    "library",
    "smoothing",
    "layout",
    "spmv",
    "stencil",
    "ellpack_spmv",
    "chebyshev_basis",
    "monomial_basis",
    "bernstein_basis",
    "graph_conv",
]
