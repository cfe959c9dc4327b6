"""The fused conv's halo-strip arrays: CUDA gather kernel and plain version.

Counterpart of the JAX package's ``deepsphere_tpu.ops.pallas_strips``
(the TPU builder kernel ``_builder_kernel``) and of ``_strip_arrays`` in
``deepsphere_tpu.ops.pallas_stencil``.  Each strip is a copy of a
neighbour face's edge rectangle, flipped or transposed per
:func:`..sphere.faces.edge_descriptor`; the 3-way polar corners stay 0.

Layout (the JAX package's, bit for bit), for C channels and
R = roundup(h, 8), P_l = roundup(n + 2h, 128):

* ``top`` (C, 12, R, P_l): the h halo rows above the face at rows
  [R-h, R), full padded width (corners included), zeros elsewhere;
* ``bot`` (C, 12, R, P_l): the h rows below the face at rows [0, h);
* ``ls`` (C, 12, n, 128): the west lane strip at lanes [0, h), the east
  one at [h, 2h), zeros elsewhere.

On the TPU the builder was a DMA/flip program; on a GPU the whole
assembly is one gather through a host-built int32 source map
(:func:`strip_index_map`), which runs at memory bandwidth.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .stencil import edge_strips

__all__ = ["strip_arrays", "strip_index_map", "build_strips"]


def _geometry(st):
    from .fused_stencil import cfp_geometry

    return cfp_geometry(st.nside, st.n_steps)


def strip_arrays(st, xc):
    """Plain version: (top, bot, ls) from slices and flips of the interior
    of ``xc`` (C, 12, n, P_l) (lanes [h, h+n); the rest is not read)."""
    n, h = st.nside, st.n_steps
    R, P_l = _geometry(st)
    C = xc.shape[0]
    west, east, south, north = edge_strips(n, h, xc, embedded=True)

    def zer(*s):
        return xc.new_zeros((C, 12) + s)

    P0 = n + 2 * h
    wp = torch.cat([west, zer(h, P_l - P0)], dim=3)
    ep = torch.cat([east, zer(h, P_l - P0)], dim=3)
    top = torch.cat([zer(R - h, P_l), wp], dim=2)
    bot = torch.cat([ep, zer(R - h, P_l)], dim=2)
    ls = torch.cat([south, north, zer(n, 128 - 2 * h)], dim=3)
    return top, bot, ls


def strip_index_map(st):
    """Host int32 source map of the strips: for every element of one
    channel's ``top``, ``bot`` and ``ls`` (concatenated, flattened in that
    order), its flat index into one channel (12, n, P_l) of ``xc``, or -1
    for a zero.  Derived by running :func:`strip_arrays` on an image of
    flat indices, so it follows ``edge_descriptor`` exactly.  Cached on
    ``st``."""
    cached = getattr(st, "_strip_idx_cache", None)
    if cached is None:
        n = st.nside
        _, P_l = _geometry(st)
        ids = torch.arange(1, 12 * n * P_l + 1, dtype=torch.int64)
        parts = strip_arrays(st, ids.reshape(1, 12, n, P_l))
        cached = (torch.cat([p.reshape(-1) for p in parts]) - 1).numpy()
        cached = cached.astype(np.int32)
        st._strip_idx_cache = cached
    return cached


def _strips_cuda(st, xc, index):
    """Launch the strip gather kernel (``csrc/strips.cu``)."""
    n = st.nside
    R, P_l = _geometry(st)
    C = xc.shape[0]
    if xc.dtype != torch.float32 or not xc.is_contiguous():
        raise ValueError("strips kernel needs a contiguous float32 xc")
    if tuple(xc.shape) != (C, 12, n, P_l):
        raise ValueError(f"xc shape {tuple(xc.shape)} != {(C, 12, n, P_l)}")
    if not 1 <= C <= 65535:
        raise ValueError(f"strips kernel takes 1..65535 channels, got {C}")
    e_tb, e_ls = 12 * R * P_l, 12 * n * 128
    if index is None:
        index = torch.from_numpy(strip_index_map(st)).to(xc.device)
    if (index.dtype != torch.int32 or index.device != xc.device
            or index.numel() != 2 * e_tb + e_ls or not index.is_contiguous()):
        raise ValueError("strip index map does not match this conv")
    top = torch.empty((C, 12, R, P_l), dtype=xc.dtype, device=xc.device)
    bot = torch.empty_like(top)
    ls = torch.empty((C, 12, n, 128), dtype=xc.dtype, device=xc.device)
    lib = _cuda.lib()
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ds_strips(
            xc.data_ptr(), index.data_ptr(), top.data_ptr(), bot.data_ptr(),
            ls.data_ptr(), C, 12 * n * P_l, e_tb, e_ls, stream,
        )
    _cuda.check(rc, "ds_strips")
    _cuda.launch_counts["strips"] += 1
    return top, bot, ls


def build_strips(st, xc, index=None):
    """(top, bot, ls) of ``xc`` (C, 12, n, P_l): the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor.  ``index``: the device copy
    of :func:`strip_index_map` (``tables["strip_idx"]``), else built here."""
    if xc.is_cuda:
        return _strips_cuda(st, xc, index)
    if xc.device.type != "cpu":
        raise ValueError(f"no strips implementation for device {xc.device}")
    return strip_arrays(st, xc)
