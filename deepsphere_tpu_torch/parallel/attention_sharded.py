"""Pixel-sharded edge-sparse attention.

Counterpart of the JAX package's ``deepsphere_tpu.parallel.attention_sharded``
(there a ``shard_map``), over a process group:

* The edge list is sorted by destination pixel, so cutting the pixel axis
  into contiguous shards cuts the edges cleanly: each edge belongs to the
  shard that owns its destination (:func:`partition_edges_by_dst`).  Every
  softmax reduction is over destinations, so each shard's reductions are
  exact on their own.
* A destination's sources reach into other shards.  Every pixel rank
  holds the whole map, so it computes the whole of k and v itself and
  indexes them by global source: no collective in the forward (where the
  JAX package all-gathers its k and v shards).  Each rank's gradient of k
  and v covers only its own edges, so it is summed over the pixel group
  (:func:`..collectives.sum_grad`, one all-reduce in the backward).  q,
  the per-edge arrays and the output stay sharded.
* The shards' edge counts differ by a few, so each chunk is padded to the
  largest with masked edges, which add exactly 0 to both sums.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.attention import segment_softmax_attention
from .collectives import sum_grad

__all__ = ["partition_edges_by_dst", "sharded_edge_attention"]


def partition_edges_by_dst(edge_idx, num_nodes, n_shards):
    """Split a dst-sorted (E, 2) edge list into per-pixel-shard chunks.

    :param edge_idx: (E, 2) integer (dst, src) rows, sorted by dst
    :param num_nodes: the pixel count M (a multiple of ``n_shards``)
    :param n_shards: the number of pixel shards
    :return: (parts (n_shards, Emax, 2) int32 with LOCAL dst and GLOBAL
        src, mask (n_shards, Emax, 1) float32, 1 for a real edge and 0 for
        padding)
    """
    edge_idx = np.asarray(edge_idx)
    if num_nodes % n_shards:
        raise ValueError(
            f"num_nodes={num_nodes} not divisible by n_shards={n_shards}"
        )
    m = num_nodes // n_shards
    dst = edge_idx[:, 0]
    if len(dst) > 1 and np.any(np.diff(dst) < 0):
        raise ValueError("edge_idx must be sorted by destination")
    bounds = np.searchsorted(dst, np.arange(0, num_nodes + 1, m))
    counts = np.diff(bounds)
    e_max = max(int(counts.max()) if counts.size else 0, 1)
    parts = np.zeros((n_shards, e_max, 2), np.int32)
    mask = np.zeros((n_shards, e_max, 1), np.float32)
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        c = hi - lo
        parts[s, :c, 0] = dst[lo:hi] - s * m  # local dst
        parts[s, :c, 1] = edge_idx[lo:hi, 1]  # global src
        mask[s, :c, 0] = 1.0
    return parts, mask


def sharded_edge_attention(q, k, v, parts, mask, group, stabilized=True):
    """Edge-sparse attention on this rank's pixel shard.

    :param q: (B, H, m, D), this rank's m = M / S pixels
    :param k, v: (B, H, M, D), the whole map's, the same on every rank
    :param parts: (Emax, 2) this rank's chunk of :func:`partition_edges_by_dst`
        (local dst, global src), as an integer tensor
    :param mask: (Emax, 1) its edge mask
    :param group: the pixel process group (S ranks, in pixel order)
    :return: (B, H, m, D), this rank's rows of the attention
    """
    m = q.shape[2]
    # k and v together, node axis first: (M, 2, B, H, D)
    kv = sum_grad(torch.stack([k, v]).permute(3, 0, 1, 2, 4), group)
    parts = parts.long()
    dst, src = parts[:, 0], parts[:, 1]
    kv_e = kv[src]
    out = segment_softmax_attention(q.permute(2, 0, 1, 3)[dst], kv_e[:, 0],
                                    kv_e[:, 1], dst, m, stabilized,
                                    keep=mask.reshape(-1))
    return out.permute(1, 2, 0, 3)
