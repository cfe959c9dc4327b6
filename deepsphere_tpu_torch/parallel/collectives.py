"""Collectives over a process group, with the gradients the sharded model
needs.

The JAX package gets these from ``shard_map``, whose transpose rules insert
the adjoint collective of each one.  Here each is a
``torch.autograd.Function``, and the backward is chosen by what the data
downstream of the collective is:

* :func:`shard` takes this rank's slice of a tensor that every rank of the
  group holds whole (replicated).  Every rank's slice gradient is its own
  part of the whole gradient, so the backward all-gathers them.
* :func:`unshard` all-gathers the ranks' slices into the whole tensor, and
  what follows runs replicated: every rank computes the same whole
  gradient, so the backward takes this rank's slice of it, with no sum.
* :func:`exchange_gather` all-gathers a halo that each rank then uses
  differently: each rank's gradient of the gathered buffer is a partial
  sum, so the backward sums over the ranks and takes this rank's slice (a
  reduce-scatter on NCCL; all-reduce and slice on gloo).
* :func:`all_reduce_sum` sums a statistic over the ranks, and each rank's
  result feeds its own part of the loss: the backward is an all-reduce too.
* :func:`sum_grad` is the identity on a replicated parameter whose uses
  differ per rank: its backward all-reduces the partial gradients.

The plain helpers :func:`all_gather_tensor` and :func:`all_reduce_` are for
code that has no gradient through the collective (inside another autograd
function's forward or backward).  This module never calls
``torch.distributed.nn.functional``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = [
    "all_gather_tensor",
    "all_reduce_",
    "shard",
    "unshard",
    "exchange_gather",
    "all_reduce_sum",
    "sum_grad",
]


# torch >= 2.13 names the single-tensor collectives ``*_single`` and
# deprecates the older ``*_tensor`` names, which are all that older
# releases have
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)


def _size_rank(group):
    return dist.get_world_size(group), dist.get_rank(group)


def all_gather_tensor(t, group, dim=0):
    """The ranks' ``t`` concatenated along ``dim`` in rank order (no
    gradient)."""
    S, _ = _size_rank(group)
    t = t.contiguous()
    out = t.new_empty((S * t.shape[0],) + tuple(t.shape[1:]))
    _all_gather_single(out, t, group=group)
    if dim == 0:
        return out
    return torch.cat(out.chunk(S, 0), dim=dim)


def all_reduce_(t, group):
    """In-place sum of ``t`` over the ranks of ``group`` (no gradient)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _own_slice(t, dim, group):
    S, r = _size_rank(group)
    m = t.shape[dim] // S
    return t.narrow(dim, r * m, m).contiguous()


def _reduce_scatter(t, group):
    """Sum of the ranks' ``t`` (S*m, ...), this rank's rows [r*m, (r+1)*m)."""
    S, _ = _size_rank(group)
    t = t.contiguous()
    if dist.get_backend(group) == "nccl":
        out = t.new_empty((t.shape[0] // S,) + tuple(t.shape[1:]))
        _reduce_scatter_single(out, t, op=dist.ReduceOp.SUM, group=group)
        return out
    # gloo: all-reduce, then the own slice
    return _own_slice(all_reduce_(t.clone(), group), 0, group)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        S, _ = _size_rank(group)
        if x.shape[dim] % S:
            raise ValueError(f"shard: axis {dim} of {tuple(x.shape)} does not "
                             f"divide over {S} ranks")
        ctx.dim, ctx.group = dim, group
        return _own_slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_tensor(g, ctx.group, ctx.dim), None, None


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_tensor(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.dim, ctx.group), None, None


class _ExchangeGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_tensor(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def shard(x, dim, group):
    """This rank's contiguous slice of ``x`` along ``dim`` (replicated ->
    local).  Backward: all-gather."""
    return _Shard.apply(x, dim, group)


def unshard(x, dim, group):
    """The ranks' slices concatenated along ``dim`` (local -> replicated).
    Backward: this rank's slice of the gradient, no sum."""
    return _Unshard.apply(x, dim, group)


def exchange_gather(x, group):
    """The ranks' ``x`` concatenated along dim 0, for a halo each rank uses
    differently.  Backward: sum over the ranks, then this rank's rows."""
    return _ExchangeGather.apply(x, group)


def all_reduce_sum(x, group):
    """Sum of ``x`` over the ranks.  Backward: all-reduce."""
    return _AllReduceSum.apply(x, group)


def sum_grad(x, group):
    """``x`` itself; its gradient is summed over the ranks (a replicated
    parameter that each rank applies to its own shard)."""
    return _SumGrad.apply(x, group)
