"""Layers of the PyTorch port: graph convolutions, pooling, layout converters.

Counterpart of the JAX package's ``deepsphere_tpu.nn.layers`` (the subset
the quick_start classifier runs):

* ``ChebyshevConv`` / ``MonomialConv`` — graph polynomial convolutions over
  a :class:`~deepsphere_tpu_torch.graph.SphereGraph`, in the ``nest``,
  ``face`` or ``cface`` layout, with the reference's initializer /
  batch-norm / bias / activation semantics;
* ``HealpyPool`` — NEST-hierarchy max/avg pooling in all three layouts;
* ``Flatten`` and ``Dense`` heads;
* the parameter-free layout converters the model assembler inserts.

All layers keep the JAX package's tensor layouts: ``(batch, nodes,
channels)`` in nest/face order, ``(batch, channels, 12, n, P_l)`` in cface.
Parameters are created at the first forward (their input width is known
only then), like flax's ``@nn.compact``; :meth:`HealpyGCNN.build` runs that
forward.  Parameter shapes follow the flax modules, so JAX checkpoints load
through :func:`deepsphere_tpu_torch.interop.load_jax_variables`.
"""

from __future__ import annotations

from typing import ClassVar

import numpy as np
import torch
from torch import nn

from ..ops import spmv
from ..ops.layout import face_to_nest, nest_to_face, nside_of_axis
from ..ops.stencil import (
    as_tensors,
    cface_embed,
    cface_extract,
    stencil_graph_conv,
    stencil_graph_conv_cface,
    stencil_tables,
)
from ..utils import resolve_activation

__all__ = [
    "ChebyshevConv",
    "MonomialConv",
    "HealpyPool",
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
    at lane ``y + off``."""

    def __init__(self, off):
        super().__init__(off=off)
        self.off = off

    def forward(self, x):
        n = nside_of_axis(x.shape[1])
        return cface_embed(nest_to_face(x), n, self.off)


class CfaceToNest(_Layer):
    """Inverse of :class:`NestToCface`."""

    def __init__(self, off):
        super().__init__(off=off)
        self.off = off

    def forward(self, x):
        return face_to_nest(cface_extract(x, self.off))


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


class _BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` semantics on (..., F): momentum 0.9 (running =
    0.9 running + 0.1 batch), biased batch variance E[x^2] - E[x]^2 clipped
    at 0, epsilon 1e-5, no affine parameters; eval uses the running
    averages.  State ``mean``/``var`` matches flax's ``batch_stats``."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def _stats(self, x):
        axes = tuple(range(x.ndim - 1))
        xf = x.float()
        mean = xf.mean(axes)
        var = ((xf * xf).mean(axes) - mean * mean).clamp_min(0.0)
        return mean, var

    def _shape(self, x):
        return (1,) * (x.ndim - 1) + (-1,)

    def forward(self, x):
        if self.training:
            mean, var = self._stats(x)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_((1 - m) * mean)
                self.var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.mean, self.var
        shape = self._shape(x)
        return (x - mean.reshape(shape).to(x.dtype)) * torch.rsqrt(
            var.reshape(shape).to(x.dtype) + self.epsilon)


class _CfaceBatchNorm(_BatchNorm):
    """:class:`_BatchNorm` on the cface layout with interior-only batch
    statistics (the halo/pad lanes must not pollute them); the whole array
    is normalized.  Like the JAX module, the variance is not clipped."""

    def __init__(self, off, num_features, momentum=0.9, epsilon=1e-5):
        super().__init__(num_features, momentum, epsilon)
        self.off = off

    def _stats(self, x):
        n = x.shape[3]
        xi = x[:, :, :, :, self.off : self.off + n].float()
        mean = xi.mean((0, 2, 3, 4))
        var = (xi * xi).mean((0, 2, 3, 4)) - mean * mean
        return mean, var

    def _shape(self, x):
        return (1, -1, 1, 1, 1)


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
    JAX package's ``graph_tables`` collection).
    """

    _scale: ClassVar[float] = 1.0
    _basis: ClassVar = None
    _basis_kind: ClassVar[str] = ""
    _n_terms_offset: ClassVar[int] = 0

    def __init__(self, graph, K, Fout=None, initializer=None, activation=None,
                 use_bias=False, use_bn=False, conv_method="auto",
                 layout="nest"):
        super().__init__(graph=graph, K=K, Fout=Fout, initializer=initializer,
                         activation=activation, use_bias=use_bias,
                         use_bn=use_bn, conv_method=conv_method, layout=layout)
        self.graph = graph
        self.K = K
        self.Fout = Fout
        self.initializer = initializer
        self.activation = activation
        self.use_bias = use_bias
        self.use_bn = use_bn
        self.conv_method = conv_method
        self.layout = layout
        self.register_parameter("kernel", None)
        self.register_parameter("bias", None)
        self.bn = None
        self._table_keys = ()

    def _default_std(self, Fin, Fout):
        raise NotImplementedError

    @property
    def basis_kind(self):
        return self._basis_kind

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
        if self.use_bn:
            self.bn = (_CfaceBatchNorm(st.n_steps, Fout) if self.layout == "cface"
                       else _batch_norm(Fout)).to(device)
        if st is not None:
            tables = stencil_tables(st)
        else:
            idx, val = self.graph.ellpack(self._scale)
            tables = {"idx": idx, "val": val}
        for k, v in as_tensors(tables, device).items():
            self.register_buffer(f"tab_{k}", v, persistent=False)
        self._table_keys = tuple(tables)

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
        st = self._stencil()
        self._materialize(Fin, Fout, st, x.device)
        tables = self._tables()
        if st is not None:
            y = stencil_graph_conv(st, x, self.kernel, n_terms,
                                   self.basis_kind, tables=tables,
                                   layout=self.layout)
        else:
            basis_impl = type(self)._basis
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
        y = stencil_graph_conv_cface(st, x, self.kernel, self.n_terms,
                                     self.basis_kind, tables=self._tables())
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

            B, F, _, n, _ = x.shape
            xi = x[:, :, :, :, self.cface_off : self.cface_off + n]
            blocks = xi.reshape(B, F, 12, n // sp, sp, n // sp, sp)
            y = self._reduce(blocks, (4, 6))  # (B, F, 12, n/sp, n/sp)
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
