from . import layout, spmv, stencil
from .spmv import chebyshev_basis, ellpack_spmv, graph_conv, monomial_basis

__all__ = [
    "layout",
    "spmv",
    "stencil",
    "ellpack_spmv",
    "chebyshev_basis",
    "monomial_basis",
    "graph_conv",
]
