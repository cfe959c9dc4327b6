"""Layers of the PyTorch port: graph convolutions, pooling, layout converters.

Counterpart of the JAX package's ``deepsphere_tpu.nn.layers`` (attention
lives in :mod:`.transformers`, smoothing in :mod:`.smoothing`):

* ``ChebyshevConv`` / ``MonomialConv`` / ``BernsteinConv`` — graph
  polynomial convolutions over a
  :class:`~deepsphere_tpu_torch.graph.SphereGraph`, in the ``nest``,
  ``face`` or (Chebyshev, monomial) ``cface`` layout, with the reference's
  initializer / batch-norm / bias / activation semantics;
* ``ResidualLayer`` — two conv sublayers with optional Keras-default norms
  and the ``act(out + alpha * in)`` coupling;
* ``HealpyPool`` — NEST-hierarchy max/avg pooling in all three layouts;
* ``HealpyPseudoConv`` / ``HealpyPseudoConv_Transpose`` — learnable 4^p
  down/up-sampling (blocked matmuls) in all three layouts;
* ``Flatten`` and ``Dense`` heads;
* the parameter-free layout converters the model assembler inserts.

All layers keep the JAX package's tensor layouts: ``(batch, nodes,
channels)`` in nest/face order, ``(batch, channels, 12, n, P_l)`` in cface.

Under a mesh (``shard_cfg``, :class:`~deepsphere_tpu_torch.parallel.ShardConfig`)
every rank holds its data rank's rows; a NEST activation is the whole map
on every pixel rank, a cface activation only the rank's faces
``(batch, channels, 12 / n_pixel_shards, n, P_l)``.  The layout converters
shard and unshard the face axis, the cface convs run face-sharded, the nest
convs on the halo-sharded ELLPACK, and the batch-norm statistics are those
of the global batch (summed over the data and, in cface, the pixel ranks).
Parameters are created at the first forward (their input width is known
only then), like flax's ``@nn.compact``; :meth:`HealpyGCNN.build` runs that
forward.  Parameter shapes follow the flax modules, so JAX checkpoints load
through :func:`deepsphere_tpu_torch.interop.load_jax_variables`.
"""

from __future__ import annotations

import contextlib
from typing import ClassVar

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import config
from ..ops import spmv
from ..ops.layout import face_to_nest, nest_to_face, nside_of_axis
from ..ops.fused_stencil import cface_route
from ..ops.stencil import (
    as_tensors,
    cface_embed,
    cface_extract,
    check_lap_chain,
    conv_route,
    stencil_graph_conv,
    stencil_graph_conv_cface,
    stencil_tables,
)
from ..parallel.cface_sharded import cface_model_conv, face_shard_tables
from ..parallel.collectives import all_reduce_sum, shard, unshard
from ..parallel.halo import shard_ellpack_cached
from ..parallel.sharded_ops import sharded_poly_conv
from ..sphere.healpix import _spread_bits
from ..utils import resolve_activation

__all__ = [
    "ChebyshevConv",
    "MonomialConv",
    "BernsteinConv",
    "ResidualLayer",
    "HealpyPool",
    "HealpyPseudoConv",
    "HealpyPseudoConv_Transpose",
    "Flatten",
    "Dense",
    "NestToFace",
    "FaceToNest",
    "NestToCface",
    "CfaceToNest",
    "CfaceReEmbed",
]


class _Layer(nn.Module):
    """Records its constructor arguments so the model assembler can
    :meth:`clone` it with another layout, like a flax dataclass.
    ``_init_generator`` (set by ``HealpyGCNN.build``) seeds lazily created
    parameters."""

    def __init__(self, **cfg):
        super().__init__()
        self._cfg = cfg
        self._init_generator = None

    def clone(self, **overrides):
        return type(self)(**{**self._cfg, **overrides})


def _raster_to_morton_taps(p):
    """Tap permutation between the two orderings of a 2^p x 2^p NEST parent
    block: entry j (raster dx*2^p + dy) gives the NEST child index (Morton
    interleave).  Reordering kernel taps with it makes the face-layout
    pseudo-convs equal to their NEST form, so checkpoints are
    layout-independent."""
    sp = 2**p
    j = np.arange(sp * sp, dtype=np.int64)
    dx, dy = j // sp, j % sp
    return torch.from_numpy(np.asarray(
        _spread_bits(dx) | (_spread_bits(dy) << 1), dtype=np.int64))


def _pad_lanes(y, off, P_out):
    """(..., n) interior -> (..., P_out) with the interior at lane off."""
    n = y.shape[-1]
    return nn.functional.pad(y, (off, P_out - n - off))


class NestToFace(_Layer):
    """Reorder the pixel axis from NEST to face-flat [f, x, y]."""

    def forward(self, x):
        return nest_to_face(x)


class FaceToNest(_Layer):
    """Inverse of :class:`NestToFace`."""

    def forward(self, x):
        return face_to_nest(x)


class NestToCface(_Layer):
    """NEST (B, M, F) -> the cface layout (B, F, 12, n, P_l) with face col y
    at lane ``y + off``; under ``shard_cfg``, this pixel rank's faces of the
    whole map (backward: all-gather)."""

    def __init__(self, off, shard_cfg=None):
        super().__init__(off=off, shard_cfg=shard_cfg)
        self.off = off
        self.shard_cfg = shard_cfg

    def forward(self, x):
        n = nside_of_axis(x.shape[1])
        xf = nest_to_face(x)
        if self.shard_cfg is not None:
            xf = shard(xf, 1, self.shard_cfg.pixel_group)
        return cface_embed(xf, n, self.off)


class CfaceToNest(_Layer):
    """Inverse of :class:`NestToCface`; under ``shard_cfg`` it all-gathers
    the faces, so the map is whole on every pixel rank again (backward:
    this rank's faces of the gradient)."""

    def __init__(self, off, shard_cfg=None):
        super().__init__(off=off, shard_cfg=shard_cfg)
        self.off = off
        self.shard_cfg = shard_cfg

    def forward(self, x):
        xf = cface_extract(x, self.off)
        if self.shard_cfg is not None:
            xf = unshard(xf, 1, self.shard_cfg.pixel_group)
        return face_to_nest(xf)


class CfaceReEmbed(_Layer):
    """Shift the lane embedding between two cface geometries."""

    def __init__(self, off_in, off_out):
        super().__init__(off_in=off_in, off_out=off_out)
        self.off_in = off_in
        self.off_out = off_out

    def forward(self, x):
        from ..ops.fused_stencil import cfp_geometry

        if self.off_in == self.off_out:
            return x
        n = x.shape[3]
        _, P_out = cfp_geometry(n, self.off_out)
        xi = x[:, :, :, :, self.off_in : self.off_in + n]
        return _pad_lanes(xi, self.off_out, P_out)


def _stat_dtype(x):
    """Batch statistics in float32 (float64 for a float64 input)."""
    return x if x.dtype == torch.float64 else x.float()


def _affine(module, num_features, use_scale, use_bias):
    """flax's ``scale`` (ones) and ``bias`` (zeros) of a norm, or None."""
    module.scale = (nn.Parameter(torch.ones(num_features)) if use_scale
                    else None)
    module.bias = (nn.Parameter(torch.zeros(num_features)) if use_bias
                   else None)


def _normalize(module, x, mean, var, shape):
    """flax's ``_normalize``: (x - mean) * (rsqrt(var + eps) * scale) +
    bias, with ``mean`` and ``var`` broadcastable to x and the affine
    parameters reshaped to ``shape``."""
    mul = torch.rsqrt(var.to(x.dtype) + module.epsilon)
    if module.scale is not None:
        mul = mul * module.scale.reshape(shape).to(x.dtype)
    y = (x - mean.to(x.dtype)) * mul
    if module.bias is not None:
        y = y + module.bias.reshape(shape).to(x.dtype)
    return y


# >0 while checkpointed layers recompute their forward in the backward
_RECOMPUTING = [0]


@contextlib.contextmanager
def frozen_running_stats():
    """Batch norms normalise with the batch's statistics as in training but
    leave their running statistics alone: the recompute of a checkpointed
    layer (``HealpyGCNN(remat=True)``), whose forward updated them once,
    as flax's ``nn.remat`` does."""
    _RECOMPUTING[0] += 1
    try:
        yield
    finally:
        _RECOMPUTING[0] -= 1


class _BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` semantics on (..., F): running = momentum x
    running + (1 - momentum) x batch, biased batch variance E[x^2] - E[x]^2
    clipped at 0; eval uses the running averages.  The conv layers' BN has
    momentum 0.9, epsilon 1e-5 and no affine parameters; the residual
    layer's Keras-default BN momentum 0.99, epsilon 1e-3, a ``scale`` and a
    ``bias``.  State ``mean``/``var`` matches flax's ``batch_stats``.

    ``shard_cfg``/``shard_axes``: the mesh axes over which the batch
    moments are averaged (set by a sharded conv: every rank holds an equal
    share of the global batch), so every rank normalizes with, and keeps,
    the global batch's statistics."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 use_scale=False, use_bias=False):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.shard_cfg = None
        self.shard_axes = ()
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        _affine(self, num_features, use_scale, use_bias)

    def _moments(self, xf, axes):
        """E[x] and E[x^2] over ``axes``, and over the ranks of the
        ``shard_axes``."""
        m = torch.stack([xf.mean(axes), (xf * xf).mean(axes)])
        if self.shard_axes:
            ranks = 1
            for axis in self.shard_axes:
                g = self.shard_cfg.mesh.get_group(axis)
                m = all_reduce_sum(m, g)
                ranks *= dist.get_world_size(g)
            m = m / ranks
        return m[0], m[1]

    def _stats(self, x):
        mean, mean2 = self._moments(_stat_dtype(x), tuple(range(x.ndim - 1)))
        return mean, (mean2 - mean * mean).clamp_min(0.0)

    def _shape(self, x):
        return (1,) * (x.ndim - 1) + (-1,)

    def forward(self, x):
        if self.training:
            mean, var = self._stats(x)
            if not _RECOMPUTING[0]:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.mul_(m).add_((1 - m) * mean)
                    self.var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.mean, self.var
        shape = self._shape(x)
        return _normalize(self, x, mean.reshape(shape), var.reshape(shape),
                          shape)


class _CfaceBatchNorm(_BatchNorm):
    """:class:`_BatchNorm` on the cface layout with interior-only batch
    statistics (the halo/pad lanes must not pollute them); the whole array
    is normalized.  Like the JAX module, the variance is not clipped."""

    def __init__(self, off, num_features, momentum=0.9, epsilon=1e-5,
                 use_scale=False, use_bias=False):
        super().__init__(num_features, momentum, epsilon, use_scale,
                         use_bias)
        self.off = off

    def _stats(self, x):
        n = x.shape[3]
        xi = _stat_dtype(x[:, :, :, :, self.off : self.off + n])
        mean, mean2 = self._moments(xi, (0, 2, 3, 4))
        return mean, mean2 - mean * mean

    def _shape(self, x):
        return (1, -1, 1, 1, 1)


class _LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the feature axis ``axis`` (-1 on (B, M, F),
    1 on the cface layout: each pixel's channels): mean and the variance
    E[x^2] - E[x]^2 clipped at 0 (flax's fast variance), then
    :func:`_normalize` with a ``scale`` and a ``bias``."""

    def __init__(self, num_features, epsilon=1e-6, use_scale=True,
                 use_bias=True, axis=-1):
        super().__init__()
        self.epsilon = epsilon
        self.axis = axis
        _affine(self, num_features, use_scale, use_bias)

    def forward(self, x):
        xs = _stat_dtype(x)
        mean = xs.mean(self.axis, keepdim=True)
        var = ((xs * xs).mean(self.axis, keepdim=True)
               - mean * mean).clamp_min(0.0)
        shape = [1] * x.ndim
        shape[self.axis] = -1
        return _normalize(self, x, mean, var, tuple(shape))


def _batch_norm(num_features):
    """The reference conv-layer BN config: momentum 0.9, eps 1e-5, no
    affine."""
    return _BatchNorm(num_features, momentum=0.9, epsilon=1e-5)


def _truncated_normal(shape, std, generator):
    """flax ``initializers.truncated_normal(std, lower=-2, upper=2)``: a
    standard normal cut at +-2, times ``std`` (no variance rescale)."""
    w = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w * std


class _GraphPolyConv(_Layer):
    """Shared skeleton of the polynomial graph convolutions.

    The graph tables (stencil or ELLPACK arrays) are registered at the
    first forward as non-persistent buffers: they move with ``.to(device)``
    and stay out of ``state_dict()`` (deterministic precompute, like the
    JAX package's ``graph_tables`` collection).  Under ``shard_cfg`` they
    are this rank's share: its faces' stencil tables (cface) or its rows of
    the halo-sharded ELLPACK (nest).
    """

    _scale: ClassVar[float] = 1.0
    _basis: ClassVar = None
    _basis_kind: ClassVar[str] = ""
    _n_terms_offset: ClassVar[int] = 0

    def __init__(self, graph, K, Fout=None, initializer=None, activation=None,
                 use_bias=False, use_bn=False, conv_method="auto",
                 layout="nest", shard_cfg=None, ref_quirks=False):
        super().__init__(graph=graph, K=K, Fout=Fout, initializer=initializer,
                         activation=activation, use_bias=use_bias,
                         use_bn=use_bn, conv_method=conv_method, layout=layout,
                         shard_cfg=shard_cfg, ref_quirks=ref_quirks)
        self.graph = graph
        self.K = K
        self.Fout = Fout
        self.initializer = initializer
        self.activation = activation
        self.use_bias = use_bias
        self.use_bn = use_bn
        self.conv_method = conv_method
        self.layout = layout
        self.shard_cfg = shard_cfg
        # Bernstein only: the reference's stale-buffer i = K term
        # (spmv.bernstein_basis_ref)
        self.ref_quirks = ref_quirks
        self.register_parameter("kernel", None)
        self.register_parameter("bias", None)
        self.bn = None
        self._table_keys = ()
        self._chain_keys = ()
        # the route an exported forward holds (``serve.export``), checked
        # for every batch it serves before tracing; None: chosen per call
        self._held_route = None

    def _default_std(self, Fin, Fout):
        raise NotImplementedError

    @property
    def basis_kind(self):
        if self.ref_quirks and self._basis_kind == "bern":
            return "bern_ref"
        return self._basis_kind

    def _basis_fn(self):
        if self.basis_kind == "bern_ref":
            return spmv.bernstein_basis_ref
        return type(self)._basis

    @property
    def n_terms(self):
        return self.K + self._n_terms_offset

    def _stencil(self):
        """The stencil this conv runs on, or None (ELLPACK path)."""
        if self.layout == "cface":
            st = self.graph.deep_stencil(self._scale, self.n_terms)
            if st is None:
                raise ValueError("layout='cface' requires the deep stencil path")
            return st
        st = None
        if self.conv_method in ("auto", "stencil"):
            if self._basis_kind in ("cheby", "mono") and self.n_terms >= 2:
                r = self.graph.stencil_radius
                if r is not None and r >= 3 and self.n_terms > 2:
                    st = self.graph.face_stencil(self._scale)
                else:
                    st = self.graph.deep_stencil(self._scale, self.n_terms)
            if st is None:
                st = self.graph.face_stencil(self._scale)
            if st is None and self.conv_method == "stencil":
                raise ValueError(
                    "conv_method='stencil' requires a stencil-capturable "
                    "full-sphere graph (grid/ring construction, or a kNN "
                    "graph whose edges fit the capture window)"
                )
        if st is None and self.layout == "face":
            raise ValueError(
                "layout='face' requires the stencil path (full-sphere "
                "grid graph)"
            )
        if st is not None and self.graph.n_pixels != 12 * st.nside ** 2:
            # masked sky: the stencil conv's embed is not ported yet; the
            # ELLPACK conv computes the same operator
            if self.layout == "face":
                raise ValueError("layout='face' requires a full-sphere graph")
            st = None
        return st

    def _tables(self):
        return {k: getattr(self, f"tab_{k}") for k in self._table_keys}

    def _chain(self):
        """The shallow stencil (``n_steps`` == its radius) and its tables on
        the layer's device, for the lap-chain route of the cface conv.
        Built at the route's first use (at nside 1024 a table set is on
        the order of a GB), as non-persistent buffers: out of
        ``state_dict``, moved by ``.to``."""
        st = self.graph.face_stencil(self._scale)
        if not self._chain_keys:
            tables = stencil_tables(
                st, bf16_io=config.conv_dtype == "bfloat16_io")
            for k, v in as_tensors(tables, self.kernel.device).items():
                self.register_buffer(f"chain_{k}", v, persistent=False)
            self._chain_keys = tuple(tables)
        return st, {k: getattr(self, f"chain_{k}") for k in self._chain_keys}

    def _materialize(self, Fin, Fout, st, device):
        if self.kernel is not None:
            return
        n_terms = self.n_terms
        shape = (Fin * n_terms, Fout)
        if self.initializer is None:
            w = _truncated_normal(shape, self._default_std(Fin, Fout),
                                  self._init_generator)
        else:
            w = self.initializer(shape, self._init_generator)
        self.kernel = nn.Parameter(w.to(device))
        if self.use_bias:
            self.bias = nn.Parameter(torch.zeros((1, 1, Fout), device=device))
        cfg = self.shard_cfg
        if self.use_bn:
            # in the mode of the forward that creates it (build's is eval,
            # which must leave the running statistics at 0 and 1)
            self.bn = (_CfaceBatchNorm(st.n_steps, Fout) if self.layout == "cface"
                       else _batch_norm(Fout)).to(device).train(self.training)
            if cfg is not None:
                # cface: this rank's faces of its rows; nest: its rows of
                # the whole map
                self.bn.shard_cfg = cfg
                self.bn.shard_axes = ((cfg.data_axis, cfg.pixel_axis)
                                      if self.layout == "cface"
                                      else (cfg.data_axis,))
        if cfg is not None and self.layout == "cface":
            tables = face_shard_tables(st, cfg.pixel_rank, cfg.n_pixel_shards)
        elif cfg is not None:
            tables = self._sharded_ellpack().shard_tables(cfg.pixel_rank)
        elif st is not None:
            # bf16 I/O reads the bfloat16 weight planes built once here:
            # set config.set_conv_dtype before the model is built
            tables = stencil_tables(
                st, bf16_io=config.conv_dtype == "bfloat16_io")
        else:
            idx, val = self.graph.ellpack(self._scale)
            tables = {"idx": idx, "val": val}
        for k, v in as_tensors(tables, device).items():
            self.register_buffer(f"tab_{k}", v, persistent=False)
        self._table_keys = tuple(tables)

    def batch_route(self, x_shape, sms):
        """The route this conv's forward takes for a CUDA input of
        ``x_shape`` (batch first) on a card of ``sms`` SMs, in inference,
        from the shape alone (pure Python): the cface conv's
        :func:`..ops.fused_stencil.cface_route`, or a nest/face conv's
        :func:`..ops.stencil.conv_route` (the lap chain checked against the
        kernels' plans); None where no route depends on the batch (the
        ELLPACK and sharded convs).  Raises where no route takes the
        shape."""
        if self.shard_cfg is not None:
            return None
        B, n_terms = x_shape[0], self.n_terms
        Fin, Fout = self.kernel.shape[0] // n_terms, self.kernel.shape[1]
        st = self._stencil()
        if self.layout == "cface":
            return cface_route(st, self.basis_kind, n_terms, B, Fin, Fout,
                               sms, grad=False)
        if st is None:
            return None
        route = conv_route(st, self.basis_kind, n_terms, True)
        if route == "chain":
            check_lap_chain(st, B, Fin, sms, grad=False)
        return route

    def _sharded_ellpack(self):
        return shard_ellpack_cached(self.graph, self.shard_cfg.n_pixel_shards,
                                    self._scale)

    def forward(self, x):
        if self.layout == "cface":
            return self._forward_cface(x)
        B, M, Fin = x.shape
        if M != self.graph.n_pixels:
            raise ValueError(
                f"Input has {M} nodes but the graph has {self.graph.n_pixels}"
            )
        Fout = Fin if self.Fout is None else self.Fout
        n_terms = self.n_terms
        # under a mesh the halo-sharded ELLPACK, as the JAX package
        st = self._stencil() if self.shard_cfg is None else None
        self._materialize(Fin, Fout, st, x.device)
        tables = self._tables()
        if self.shard_cfg is not None:
            y = sharded_poly_conv(self.basis_kind, self._sharded_ellpack(), x,
                                  self.kernel, n_terms, self.shard_cfg,
                                  tables=tables)
        elif st is not None:
            y = stencil_graph_conv(st, x, self.kernel, n_terms,
                                   self.basis_kind, tables=tables,
                                   layout=self.layout,
                                   route=self._held_route)
        else:
            basis_impl = self._basis_fn()
            basis = lambda x2d, nt: basis_impl(tables["idx"], tables["val"],
                                               x2d, nt)
            y = spmv.graph_conv(basis, x, self.kernel, n_terms)
        if self.use_bn:
            y = self.bn(y)
        if self.use_bias:
            y = y + self.bias
        act = resolve_activation(self.activation)
        return act(y) if act is not None else y

    def _forward_cface(self, x):
        B, Fin, _, n, P_l = x.shape
        Fout = Fin if self.Fout is None else self.Fout
        st = self._stencil()
        self._materialize(Fin, Fout, st, x.device)
        if self.shard_cfg is not None:
            y = cface_model_conv(st, self._tables(), x, self.kernel,
                                 self.n_terms, self.basis_kind, self.shard_cfg)
        else:
            y = stencil_graph_conv_cface(st, x, self.kernel, self.n_terms,
                                         self.basis_kind,
                                         tables=self._tables(),
                                         chain=self._chain,
                                         route=self._held_route)
        if self.use_bn:
            y = self.bn(y)
        if self.use_bias:
            y = y + self.bias.reshape(1, Fout, 1, 1, 1)
        act = resolve_activation(self.activation)
        return act(y) if act is not None else y


class ChebyshevConv(_GraphPolyConv):
    """Chebyshev graph conv; spectrum rescale 0.75."""

    _scale: ClassVar[float] = 0.75
    _basis: ClassVar = staticmethod(spmv.chebyshev_basis)
    _basis_kind: ClassVar[str] = "cheby"

    def _default_std(self, Fin, Fout):
        return 1.0 / np.sqrt(Fin * (self.K + 0.5) / 2.0)


class MonomialConv(_GraphPolyConv):
    """Monomial graph conv; rescale 1.0."""

    _scale: ClassVar[float] = 1.0
    _basis: ClassVar = staticmethod(spmv.monomial_basis)
    _basis_kind: ClassVar[str] = "mono"

    def _default_std(self, Fin, Fout):
        return 0.1


class BernsteinConv(_GraphPolyConv):
    """Bernstein graph conv (arXiv:2106.10994); rescale 0.75, K+1 terms,
    kernel (Fin*(K+1), Fout).  ``ref_quirks=True`` reproduces the
    reference's last term (``basis_kind`` ``"bern_ref"``)."""

    _scale: ClassVar[float] = 0.75
    _basis: ClassVar = staticmethod(spmv.bernstein_basis)
    _basis_kind: ClassVar[str] = "bern"
    _n_terms_offset: ClassVar[int] = 1

    def _default_std(self, Fin, Fout):
        return np.sqrt(6.0 / (Fin + Fout))


_CONV_TYPES = {"CHEBY": ChebyshevConv, "MONO": MonomialConv}


class ResidualLayer(_Layer):
    """``out = act(layer2(norm1(layer1(x))) + alpha * x)`` (or, with
    ``act_before``, ``act(...) + alpha * x``; without an activation
    ``y + x``): two CHEBY or MONO sublayers ``layer1``/``layer2`` built from
    ``layer_kwargs``, and with ``use_bn`` the norms ``bn1``/``bn2``.

    The norms are Keras-default layers, as the reference instantiates
    them: batch norm with epsilon 1e-3, momentum 0.99 and a ``scale`` and a
    ``bias`` (in cface over the interior lanes, at the sublayers' own
    halo depth), or layer norm with epsilon 1e-3 (in cface over each
    pixel's channels); ``bn_kwargs`` (epsilon, momentum, use_scale,
    use_bias) override them, ``axis`` is ignored."""

    def __init__(self, graph, layer_type, layer_kwargs, activation=None,
                 act_before=False, use_bn=False, norm_type="batch_norm",
                 bn_kwargs=None, alpha=1.0, shard_cfg=None, layout="nest"):
        super().__init__(graph=graph, layer_type=layer_type,
                         layer_kwargs=layer_kwargs, activation=activation,
                         act_before=act_before, use_bn=use_bn,
                         norm_type=norm_type, bn_kwargs=bn_kwargs,
                         alpha=alpha, shard_cfg=shard_cfg, layout=layout)
        if layer_type not in _CONV_TYPES:
            raise IOError(f"Layertype not understood: {layer_type}")
        if use_bn and norm_type not in ("batch_norm", "layer_norm"):
            raise ValueError(f"norm_type <{norm_type}> not understood!")
        resolve_activation(activation)
        self.graph = graph
        self.layer_type = layer_type
        self.layer_kwargs = layer_kwargs
        self.activation = activation
        self.act_before = act_before
        self.use_bn = use_bn
        self.norm_type = norm_type
        self.bn_kwargs = bn_kwargs
        self.alpha = alpha
        self.shard_cfg = shard_cfg
        self.layout = layout
        kwargs = dict(layer_kwargs or {})
        kwargs.pop("L", None)
        kwargs.pop("n_matmul_splits", None)
        conv_cls = _CONV_TYPES[layer_type]
        self.layer1 = conv_cls(graph=graph, shard_cfg=shard_cfg,
                               layout=layout, **kwargs)
        self.layer2 = conv_cls(graph=graph, shard_cfg=shard_cfg,
                               layout=layout, **kwargs)
        self.bn1 = None
        self.bn2 = None

    def _norm(self, F, device):
        kw = dict(self.bn_kwargs or {})
        kw.pop("axis", None)  # always the feature axis
        kw.setdefault("epsilon", 1e-3)
        cface = self.layout == "cface"
        if self.norm_type == "layer_norm":
            return _LayerNorm(F, axis=1 if cface else -1, **kw).to(device)
        # a BN in the mode of the forward that creates it (see
        # _GraphPolyConv._materialize)
        kw.setdefault("momentum", 0.99)
        kw.setdefault("use_bias", True)
        kw.setdefault("use_scale", True)
        if cface:
            # statistics over the interior lanes of the sublayers' geometry
            bn = _CfaceBatchNorm(self.layer1._stencil().n_steps, F, **kw)
        else:
            bn = _BatchNorm(F, **kw)
        cfg = self.shard_cfg
        if cfg is not None:
            bn.shard_cfg = cfg
            bn.shard_axes = ((cfg.data_axis, cfg.pixel_axis) if cface
                             else (cfg.data_axis,))
        return bn.to(device).train(self.training)

    def forward(self, x):
        y = self.layer1(x)
        F = y.shape[1] if self.layout == "cface" else y.shape[-1]
        if self.use_bn and self.bn1 is None:
            self.bn1 = self._norm(F, x.device)
            self.bn2 = self._norm(F, x.device)
        if self.use_bn:
            y = self.bn1(y)
        y = self.layer2(y)
        if self.use_bn:
            y = self.bn2(y)
        act = resolve_activation(self.activation)
        if act is None:
            return y + x
        if self.act_before:
            return act(y) + self.alpha * x
        return act(y + self.alpha * x)


class HealpyPool(_Layer):
    """NEST-hierarchy pooling by 4^p: reshape + max/mean over child blocks
    (a 2^p x 2^p spatial tile in the face and cface layouts)."""

    def __init__(self, p, pool_type="MAX", layout="nest", cface_off=0,
                 cface_off_out=0):
        super().__init__(p=p, pool_type=pool_type, layout=layout,
                         cface_off=cface_off, cface_off_out=cface_off_out)
        if not p >= 1:
            raise IOError("The reduction factors has to be at least 1!")
        if pool_type not in ("MAX", "AVG"):
            raise IOError(f"Pooling type not understood: {pool_type}")
        self.p = p
        self.pool_type = pool_type
        self.layout = layout
        self.cface_off = cface_off
        self.cface_off_out = cface_off_out

    @property
    def filter_size(self):
        return int(4**self.p)

    def _reduce(self, x, dims):
        return x.amax(dim=dims) if self.pool_type == "MAX" else x.mean(dim=dims)

    def forward(self, x):
        sp = 2**self.p
        if self.layout == "cface":
            from ..ops.fused_stencil import cfp_geometry

            B, F, faces, n, _ = x.shape  # faces: 12, or a face shard's
            xi = x[:, :, :, :, self.cface_off : self.cface_off + n]
            blocks = xi.reshape(B, F, faces, n // sp, sp, n // sp, sp)
            y = self._reduce(blocks, (4, 6))  # (B, F, faces, n/sp, n/sp)
            _, P_out = cfp_geometry(n // sp, self.cface_off_out)
            return _pad_lanes(y, self.cface_off_out, P_out)
        B, M, F = x.shape
        fs = self.filter_size
        if M % fs != 0:
            raise IOError(f"Input shape {tuple(x.shape)} not compatible with the filter size {fs}")
        if self.layout == "face":
            n = nside_of_axis(M)
            blocks = x.reshape(B, 12, n // sp, sp, n // sp, sp, F)
            return self._reduce(blocks, (3, 5)).reshape(B, M // fs, F)
        return self._reduce(x.reshape(B, M // fs, fs, F), (2,))


def _glorot_uniform(shape, generator, receptive=1):
    """flax ``glorot_uniform`` of a kernel (..., in, out) whose leading
    axes (``receptive`` elements) are its receptive field: uniform in
    +-sqrt(6 / (fan_in + fan_out)), the fans counted over it."""
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    w = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (2.0 * w - 1.0) * limit


class _PseudoConvBase(_Layer):
    """Shared skeleton of the pseudo-convs: the (NEST tap order) kernel and
    the bias, created at the first forward from the layer's generator."""

    _grow_msg: ClassVar[str] = ""

    def __init__(self, p, Fout, kernel_initializer=None, use_bias=True,
                 layout="nest", cface_off=0, cface_off_out=0):
        super().__init__(p=p, Fout=Fout, kernel_initializer=kernel_initializer,
                         use_bias=use_bias, layout=layout, cface_off=cface_off,
                         cface_off_out=cface_off_out)
        if not p >= 1:
            raise IOError(self._grow_msg)
        self.p = p
        self.Fout = Fout
        self.kernel_initializer = kernel_initializer
        self.use_bias = use_bias
        self.layout = layout
        self.cface_off = cface_off
        self.cface_off_out = cface_off_out
        self.register_parameter("kernel", None)
        self.register_parameter("bias", None)

    @property
    def filter_size(self):
        return int(4**self.p)

    def _materialize(self, shape, receptive, device):
        if self.kernel is not None:
            return
        if self.kernel_initializer is None:
            w = _glorot_uniform(shape, self._init_generator, receptive)
        else:
            w = self.kernel_initializer(shape, self._init_generator)
        self.kernel = nn.Parameter(w.to(device))
        if self.use_bias:
            self.bias = nn.Parameter(torch.zeros(self.Fout, device=device))

    def _face_taps(self):
        """The kernel's taps in raster order of the 2^p x 2^p block."""
        fs = self.filter_size
        Fin = self.kernel.numel() // (fs * self.Fout)
        perm = _raster_to_morton_taps(self.p).to(self.kernel.device)
        return self.kernel.reshape(fs, Fin, self.Fout)[perm]

    def _embed(self, y):
        """(B, Fout, faces, n2, n2) -> the cface layout at ``cface_off_out``."""
        from ..ops.fused_stencil import cfp_geometry

        if self.use_bias:
            y = y + self.bias.reshape(1, self.Fout, 1, 1, 1).to(y.dtype)
        _, P_out = cfp_geometry(y.shape[3], self.cface_off_out)
        return _pad_lanes(y, self.cface_off_out, P_out)


class HealpyPseudoConv(_PseudoConvBase):
    """Learnable 4^p -> 1 downsampling: a Conv1D with kernel == stride, the
    blocked matmul (B, M/4^p, 4^p*Fin) @ (4^p*Fin, Fout), plus a bias; a
    glorot-uniform kernel and a zero bias.  In the face layouts a NEST
    parent block is a 2^p x 2^p tile of its face."""

    _grow_msg: ClassVar[str] = "The reduction factors has to be at least 1!"

    def forward(self, x):
        fs = self.filter_size
        sp = 2**self.p
        if self.layout == "cface":
            B, Fin, faces, n, _ = x.shape
            self._materialize((fs * Fin, self.Fout), 1, x.device)
            xi = x[:, :, :, :, self.cface_off : self.cface_off + n]
            blocks = xi.reshape(B, Fin, faces, n // sp, sp, n // sp, sp)
            k = self._face_taps().reshape(sp, sp, Fin, self.Fout)
            y = torch.einsum("bfgxpyq,pqfo->bogxy", blocks, k.to(x.dtype))
            return self._embed(y)
        B, M, Fin = x.shape
        if M % fs != 0:
            raise IOError(f"Input shape {tuple(x.shape)} not compatible with the filter size {fs}")
        self._materialize((fs * Fin, self.Fout), 1, x.device)
        if self.layout == "face":
            n = nside_of_axis(M)
            blocks = x.reshape(B, 12, n // sp, sp, n // sp, sp, Fin)
            x3d = blocks.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, M // fs,
                                                               fs * Fin)
            k = self._face_taps().reshape(fs * Fin, self.Fout)
        else:
            x3d = x.reshape(B, M // fs, fs * Fin)
            k = self.kernel
        y = x3d @ k.to(x.dtype)
        return y + self.bias.to(y.dtype) if self.use_bias else y


class HealpyPseudoConv_Transpose(_PseudoConvBase):
    """Learnable 1 -> 4^p upsampling, the transpose of the pseudo-conv:
    ``y[b, m*4^p + j, o] = sum_f x[b, m, f] W[j, f, o] + b[o]``, the kernel
    (4^p, Fin, Fout); a glorot-uniform kernel (fans over the 4^p taps) and
    a zero bias.  In the face layouts each coarse pixel emits a 2^p x 2^p
    tile of its face."""

    _grow_msg: ClassVar[str] = "The boost factors has to be at least 1!"

    def forward(self, x):
        fs = self.filter_size
        sp = 2**self.p
        if self.layout == "cface":
            B, Fin, faces, n, _ = x.shape
            self._materialize((fs, Fin, self.Fout), fs, x.device)
            xi = x[:, :, :, :, self.cface_off : self.cface_off + n]
            k = self._face_taps().reshape(sp, sp, Fin, self.Fout)
            y = torch.einsum("bfgxy,pqfo->bogxpyq", xi, k.to(x.dtype))
            return self._embed(y.reshape(B, self.Fout, faces, n * sp, n * sp))
        B, M, Fin = x.shape
        self._materialize((fs, Fin, self.Fout), fs, x.device)
        if self.layout == "face":
            n = nside_of_axis(M)
            y = torch.einsum("bmf,jfo->bmjo", x, self._face_taps().to(x.dtype))
            y = y.reshape(B, 12, n, n, sp, sp, self.Fout)
            y = y.permute(0, 1, 2, 4, 3, 5, 6)
        else:
            y = torch.einsum("bmf,jfo->bmjo", x, self.kernel.to(x.dtype))
        y = y.reshape(B, M * fs, self.Fout)
        return y + self.bias.to(y.dtype) if self.use_bias else y


class Flatten(_Layer):
    """(B, M, F) -> (B, M*F), pixel-major and channel-minor."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Dense(_Layer):
    """Dense head with optional activation (flax ``nn.Dense``: lecun-normal
    kernel, zero bias).  The weight is ``nn.Linear``'s (out, in), the
    transpose of the flax kernel."""

    def __init__(self, features, activation=None, use_bias=True):
        super().__init__(features=features, activation=activation,
                         use_bias=use_bias)
        self.features = features
        self.activation = activation
        self.use_bias = use_bias
        self.dense = None

    def forward(self, x):
        if self.dense is None:
            fan_in = x.shape[-1]
            lin = nn.Linear(fan_in, self.features, bias=self.use_bias)
            with torch.no_grad():
                # lecun_normal: variance 1/fan_in, truncated at +-2 sigma of
                # the untruncated normal (flax's variance_scaling rescale)
                std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
                lin.weight.copy_(_truncated_normal(
                    (self.features, fan_in), std, self._init_generator))
                if self.use_bias:
                    lin.bias.zero_()
            self.dense = lin.to(x.device)
        y = self.dense(x)
        act = resolve_activation(self.activation)
        return act(y) if act is not None else y
