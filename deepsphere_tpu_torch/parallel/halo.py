"""Pixel-axis (sequence-parallel) sharding of the graph Laplacian SpMV.

Counterpart of the JAX package's ``deepsphere_tpu.parallel.halo``; the host
tables are the same numpy arrays, bit for bit.  The pixel axis M = 12
nside^2 is sharded into S contiguous NEST chunks; NEST locality makes a
chunk a set of subfaces, so the 8-neighbour graph references only a thin
boundary outside each chunk.

1.  Every shard owns rows ``[s*m, (s+1)*m)`` of the ELLPACK Laplacian.
2.  ``boundary[s]`` = the rows of shard s that any *other* shard references,
    padded to the largest count ``H``.
3.  Each SpMV does ``buf = all_gather(x[boundary_local])`` (S*H rows), then
    computes with a remapped ELLPACK whose column ids point either into the
    local chunk or into the gathered boundary buffer.  No whole-activation
    all-gather ever happens.

The Chebyshev/monomial recursions re-exchange the boundary each step, the
halo-exchange pattern of stencil codes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import SphereGraph
from .collectives import exchange_gather

__all__ = ["ShardedEllpack", "shard_ellpack", "shard_ellpack_cached"]


class ShardedEllpack:
    """Host-precomputed sharded ELLPACK operator for ``n_shards`` ranks.

    Attributes (all numpy, stacked over the shard axis s):
      local_idx  (S, m, W) int32 — remapped column ids: ``< m`` means local
                 row, ``>= m`` means position ``id - m`` in the gathered
                 boundary buffer (size S*H)
      val        (S, m, W) float32
      boundary   (S, H) int32 — local row ids each shard contributes to the
                 all-gather (padded with 0)
    """

    def __init__(self, local_idx, val, boundary, n_shards, shard_rows):
        self.local_idx = local_idx
        self.val = val
        self.boundary = boundary
        self.n_shards = n_shards
        self.shard_rows = shard_rows

    def tables(self):
        """The arrays of every shard, as a dict of host numpy arrays."""
        return {
            "local_idx": self.local_idx,
            "val": self.val,
            "boundary": self.boundary,
        }

    def shard_tables(self, s):
        """Shard ``s``'s slices of :meth:`tables`: local_idx (m, W), val
        (m, W), boundary (H,)."""
        return {k: v[s] for k, v in self.tables().items()}

    @staticmethod
    def spmv(x_local, group, tables):
        """Local rows of L @ x given the sharded x (one halo exchange over
        the process group ``group``).

        ``tables`` holds this shard's slices (:meth:`shard_tables`) as
        tensors on the device of ``x_local`` (m, C).
        """
        send = x_local[tables["boundary"]]  # (H, C)
        buf = exchange_gather(send, group)  # (S*H, C)
        x_aug = torch.cat([x_local, buf], dim=0)  # (m + S*H, C)
        idx = tables["local_idx"]
        val = tables["val"].to(x_local.dtype)
        W = idx.shape[1]
        y = val[:, 0:1] * x_aug[idx[:, 0]]
        for w in range(1, W):
            y = y + val[:, w : w + 1] * x_aug[idx[:, w]]
        return y


def shard_ellpack_cached(graph: SphereGraph, n_shards: int, scale: float) -> ShardedEllpack:
    """Per-graph memoized :func:`shard_ellpack`."""
    cache = getattr(graph, "_sharded_cache", None)
    if cache is None:
        cache = graph._sharded_cache = {}
    key = (n_shards, round(float(scale), 12))
    if key not in cache:
        cache[key] = shard_ellpack(graph, n_shards, scale)
    return cache[key]


def shard_ellpack(graph: SphereGraph, n_shards: int, scale: float) -> ShardedEllpack:
    """Split a graph's rescaled ELLPACK Laplacian into ``n_shards``
    contiguous row chunks with halo metadata (host-side precompute)."""
    idx, val = graph.ellpack(scale)
    M, W = idx.shape
    if M % n_shards != 0:
        raise ValueError(f"{M} pixels not divisible into {n_shards} shards")
    m = M // n_shards

    owner = idx // m  # owning shard of every referenced column
    # per-shard external needs and per-shard boundary (rows others need)
    needed_from = [set() for _ in range(n_shards)]  # global row ids per owner
    for s in range(n_shards):
        rows = slice(s * m, (s + 1) * m)
        cols = idx[rows]
        ext = cols[owner[rows] != s]
        for c in np.unique(ext):
            needed_from[int(c) // m].add(int(c))

    H = max((len(b) for b in needed_from), default=0)
    H = max(H, 1)
    boundary = np.zeros((n_shards, H), dtype=np.int32)
    # map global row id -> position in the gathered buffer
    buf_pos = {}
    for t in range(n_shards):
        ids = np.sort(np.fromiter(needed_from[t], dtype=np.int64, count=len(needed_from[t])))
        boundary[t, : len(ids)] = (ids - t * m).astype(np.int32)
        for p, g in enumerate(ids):
            buf_pos[int(g)] = t * H + p

    local_idx = np.zeros((n_shards, m, W), dtype=np.int32)
    val_s = np.zeros((n_shards, m, W), dtype=np.float32)
    for s in range(n_shards):
        rows = slice(s * m, (s + 1) * m)
        cols = idx[rows]
        local = owner[rows] == s
        remapped = np.where(
            local,
            cols - s * m,
            m + np.vectorize(lambda g: buf_pos.get(int(g), 0))(cols),
        )
        local_idx[s] = remapped.astype(np.int32)
        val_s[s] = val[rows]

    return ShardedEllpack(local_idx, val_s, boundary, n_shards, m)
