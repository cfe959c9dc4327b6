from .laplacian import (
    SphereGraph,
    build_sphere_graph,
    graph_from_laplacian,
    lmax_bound,
    rescale_laplacian,
)

__all__ = [
    "SphereGraph",
    "build_sphere_graph",
    "graph_from_laplacian",
    "rescale_laplacian",
    "lmax_bound",
]
