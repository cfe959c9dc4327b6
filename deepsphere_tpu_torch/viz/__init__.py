"""Visualization: map projections and filter plots.

The PyTorch port's replacement for the reference visualization layer
(``deepsphere-cosmo-tf2 src/deepsphere/plot.py`` and the plotting methods of
``healpy_networks.py:190-385``) with no healpy/pygsp dependency — the
projections are computed from this package's own HEALPix geometry, the
filters' impulse responses with torch on the layer's own graph.  matplotlib
is imported by the plotting functions only.
"""

from .projections import gnomview, mollview, gnomonic_pixels, mollweide_pixels
from .filters import (
    SphericalFilterBank,
    get_index_equator,
    plot_filters_gnomonic,
    plot_filters_section,
)

__all__ = [
    "gnomview",
    "mollview",
    "gnomonic_pixels",
    "mollweide_pixels",
    "SphericalFilterBank",
    "get_index_equator",
    "plot_filters_gnomonic",
    "plot_filters_section",
]
