"""Device mesh and the batch-sharding descriptors.

Counterpart of the JAX package's ``deepsphere_tpu.parallel.mesh``: a mesh
with a ``data`` axis (batch parallelism: each data rank trains on its rows
of the global batch, gradients summed over the axis) and a ``pixel`` axis
(the face-sharded convs split the 12 HEALPix faces over it).  The mesh is
``torch.distributed.device_mesh.init_device_mesh`` over the process group
that the caller has started (``torch.distributed.init_process_group``, one
process per device); this module never starts one.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch.distributed as dist

__all__ = ["make_mesh", "batch_sharding", "replicated", "BatchSharding",
           "Replicated"]


def make_mesh(shape=None, axis_names=("data", "pixel"), device_type="cuda"):
    """A ``DeviceMesh`` over every rank of the initialised process group.

    :param shape: tuple matching ``axis_names``; defaults to all ranks on
        the first axis
    :param device_type: "cuda" (one card per rank, NCCL) unless the caller
        asks for "cpu" (gloo), as the tests do
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; call "
            "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not match {n} ranks")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


@dataclass(frozen=True, eq=False)
class BatchSharding:
    """Batches of (B, M, F) split over the mesh's ``data_axis``: each rank
    holds its contiguous rows of the global batch."""

    mesh: object
    data_axis: str = "data"

    def __deepcopy__(self, memo):
        return self  # the mesh and its process groups are shared, not state

    @property
    def n_shards(self):
        return self.mesh.size(self.mesh.mesh_dim_names.index(self.data_axis))

    @property
    def rank(self):
        return self.mesh.get_local_rank(self.data_axis)

    @property
    def group(self):
        return self.mesh.get_group(self.data_axis)


@dataclass(frozen=True, eq=False)
class Replicated:
    """Every rank holds the whole array."""

    mesh: object


def batch_sharding(mesh, data_axis="data"):
    """Sharding for (B, M, F) batches: batch split over the data axis."""
    return BatchSharding(mesh, data_axis)


def replicated(mesh):
    return Replicated(mesh)
