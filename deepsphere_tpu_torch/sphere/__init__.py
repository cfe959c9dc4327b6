from . import healpix
from .indexing import extend_indices, transform_indices

__all__ = ["healpix", "extend_indices", "transform_indices"]
