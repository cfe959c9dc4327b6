"""Dense and edge-sparse attention, plain PyTorch ops.

Counterpart of the JAX package's ``deepsphere_tpu.ops.attention``, which
computes attention in plain XLA ops (no Pallas kernel):

* :func:`scaled_dot_product_attention` — softmax(q k^T / sqrt(d) - 1e9 mask)
  v, returning the weights too (``F.scaled_dot_product_attention`` returns
  none, so it is not used);
* :func:`edge_sparse_attention` — attention restricted to graph edges:
  edgewise dot products, then a softmax over each destination's edges by
  segment reductions (``scatter_reduce`` "amax" for the per-destination
  max, ``index_add`` for the sums).  The softmax subtracts each
  destination's max by default (``stabilized=True``); ``stabilized=False``
  exponentiates the raw logits, as the reference does.

The edge list is (E, 2) (dst, src) rows, sorted by destination
(``SphereGraph.edge_idx``).
"""

from __future__ import annotations

import math

import torch

__all__ = ["scaled_dot_product_attention", "edge_sparse_attention",
           "segment_softmax_attention"]


def scaled_dot_product_attention(q, k, v, mask=None):
    """SDPA over the last two axes; ``mask`` is 0/1 with 1 = masked (-1e9
    added to the logit).

    :param q: (..., Sq, D), k: (..., Sk, D), v: (..., Sk, Dv)
    :param mask: broadcastable to (..., Sq, Sk)
    :return: (output (..., Sq, Dv), attention weights (..., Sq, Sk))
    """
    logits = torch.einsum("...qd,...kd->...qk", q, k) / math.sqrt(k.shape[-1])
    if mask is not None:
        logits = logits + torch.as_tensor(mask, device=q.device).to(
            logits.dtype) * -1e9
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("...qk,...kv->...qv", weights, v)
    return out.to(q.dtype), weights


def segment_softmax_attention(q_e, k_e, v_e, dst, num_segments,
                              stabilized=True, keep=None):
    """The softmax over each destination's edges, from the edges' gathered
    operands: q_e, k_e, v_e (E, B, H, D), ``dst`` (E,) in [0, num_segments).
    ``keep`` (E,) 0/1 drops the edges marked 0 (padding) from both sums.

    :return: (num_segments, B, H, D); a destination with no edge gets 0
    """
    logits = (q_e * k_e).sum(-1, keepdim=True) / math.sqrt(k_e.shape[-1])
    if keep is not None:
        keep = keep.reshape(-1, 1, 1, 1).to(logits.dtype)
        # a padded edge can never win its destination's max
        logits = torch.where(keep > 0, logits, logits.new_tensor(-1e30))
    seg_shape = (num_segments,) + tuple(logits.shape[1:])
    if stabilized:
        # a shift of each destination's logits leaves its softmax as it is,
        # so the max is taken without a gradient
        with torch.no_grad():
            seg_max = logits.new_full(seg_shape, -math.inf).scatter_reduce(
                0, dst.reshape(-1, 1, 1, 1).expand_as(logits), logits, "amax")
            # isolated destinations (and those with only padded edges)
            seg_max = torch.where(torch.isfinite(seg_max) & (seg_max > -1e29),
                                  seg_max, seg_max.new_zeros(()))
        logits = logits - seg_max[dst]
    unnorm = torch.exp(logits)
    if keep is not None:
        unnorm = unnorm * keep
    denom = unnorm.new_zeros(seg_shape).index_add(0, dst, unnorm)
    numer = v_e.new_zeros((num_segments,) + tuple(v_e.shape[1:])).index_add(
        0, dst, v_e * unnorm)
    return numer / torch.where(denom == 0.0, denom.new_ones(()), denom)


def edge_sparse_attention(q, k, v, edge_idx, num_nodes, stabilized=True):
    """Graph-edge-masked attention by gathers and segment reductions.

    :param q, k, v: (B, H, M, D) — batch, heads, nodes, head dim
    :param edge_idx: (E, 2) integer (dst, src) edges, sorted by dst
    :param num_nodes: M, the number of segments
    :param stabilized: subtract each destination's max logit before exp
    :return: (B, H, M, D)
    """
    edge_idx = torch.as_tensor(edge_idx, device=q.device).long()
    dst, src = edge_idx[:, 0], edge_idx[:, 1]
    # node axis first for the gathers: (M, B, H, D)
    qn, kn, vn = (t.permute(2, 0, 1, 3) for t in (q, k, v))
    out = segment_softmax_attention(qn[dst], kn[src], vn[src], dst, num_nodes,
                                    stabilized)
    return out.permute(1, 2, 0, 3)
