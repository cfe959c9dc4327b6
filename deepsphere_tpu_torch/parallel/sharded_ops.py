"""DP x pixel-sharded polynomial graph conv on the halo-sharded ELLPACK.

Counterpart of the JAX package's ``deepsphere_tpu.parallel.sharded_ops``.
Batch rides the ``data`` mesh axis, the pixel axis M the ``pixel`` axis:
each pixel rank computes the conv's rows of its contiguous NEST chunk, and
every Laplacian application does one boundary-halo all-gather
(:mod:`.halo`) instead of gathering the whole activation.

Under a mesh, a NEST activation (B, M, F) holds this data rank's rows and
the whole map on every pixel rank; :func:`sharded_poly_conv` takes its own
chunk of it, convolves, and all-gathers the chunks back, so its output is
again whole on every pixel rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.spmv import chebyshev_terms, monomial_terms
from ..ops.stencil import as_tensors
from .collectives import shard, sum_grad, unshard
from .halo import ShardedEllpack

__all__ = ["ShardConfig", "sharded_poly_conv"]


@dataclass(frozen=True, eq=False)
class ShardConfig:
    """Mesh and axis names for DP x pixel sharding."""

    mesh: object
    data_axis: str = "data"
    pixel_axis: str = "pixel"

    def __deepcopy__(self, memo):
        return self  # the mesh and its process groups are shared, not state

    def _dim(self, axis):
        return self.mesh.mesh_dim_names.index(axis)

    @property
    def n_pixel_shards(self):
        return self.mesh.size(self._dim(self.pixel_axis))

    @property
    def n_data_shards(self):
        return self.mesh.size(self._dim(self.data_axis))

    @property
    def pixel_rank(self):
        return self.mesh.get_local_rank(self.pixel_axis)

    @property
    def pixel_group(self):
        return self.mesh.get_group(self.pixel_axis)

    @property
    def data_group(self):
        return self.mesh.get_group(self.data_axis)


def _basis_stack(kind, spmv, x2d, n_terms):
    """Polynomial basis recursions on the local (m, C) block; each L
    application does one halo exchange."""
    if kind == "cheby":
        return list(chebyshev_terms(spmv, x2d, n_terms))
    if kind == "mono":
        return list(monomial_terms(spmv, x2d, n_terms))
    raise ValueError(f"unknown basis kind {kind}")


def sharded_poly_conv(kind, op: ShardedEllpack, x, kernel, n_terms,
                      cfg: ShardConfig, tables=None):
    """Pixel-sharded polynomial graph conv: x (B, M, Fin) -> (B, M, Fout).

    ``x`` is this data rank's rows, the whole map on every pixel rank; so is
    the result.  ``tables``: this pixel rank's tables
    (:meth:`ShardedEllpack.shard_tables`, as tensors on the device of
    ``x``), else built here.  The kernel's gradient is summed over the
    pixel group (each rank contracts only its rows).
    """
    group = cfg.pixel_group
    if tables is None:
        tables = as_tensors(op.shard_tables(cfg.pixel_rank), x.device)
    B, M, Fin = x.shape
    Fout = kernel.shape[-1]
    x_local = shard(x, 1, group)
    m = x_local.shape[1]
    x2d = x_local.permute(1, 0, 2).reshape(m, B * Fin)
    spmv = lambda t: ShardedEllpack.spmv(t, group, tables)
    tx = torch.stack(_basis_stack(kind, spmv, x2d, n_terms), dim=0)
    tx = tx.reshape(n_terms, m, B, Fin).permute(2, 1, 3, 0)
    y = tx.reshape(B * m, Fin * n_terms) @ sum_grad(kernel, group).to(tx.dtype)
    return unshard(y.reshape(B, m, Fout), 1, group).to(x.dtype)
