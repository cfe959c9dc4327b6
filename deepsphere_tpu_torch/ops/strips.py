"""The fused conv's halo-strip arrays: the plain version, the gather
kernel's source maps, and the wrappers of the ``strips`` op (K4,
:mod:`.library`).

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

The strips of bfloat16 activations (the ``"bfloat16_io"`` conv) have R =
roundup(h, 16) rows, as the JAX package's ``_strip_arrays`` builds them
for bf16 (its builder kernel takes float32 only); the gather kernel copies
their 2-byte elements with its own source map (``strip_index_map(st,
torch.bfloat16)``), bit-identical to the plain version.

On the TPU the builder was a DMA/flip program; on a GPU the whole
assembly is one gather through a host-built int32 source map
(:func:`strip_index_map`), which runs at memory bandwidth: each thread
writes one 16-byte group of every channel of a chunk, reading its map
entries once, and the zero padding (most of ``ls``) without the map.  The
three arrays are views of one allocation.

The face-sharded conv builds the strips of its local faces from the
all-gathered edge bands (:func:`.stencil.pack_edge_bands`) with the same
gather kernel and another map (:func:`band_strip_index_map`), as the JAX
package does with ``_strip_arrays(st, xc, faces, bands)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .stencil import edge_strips, unpack_edge_bands

__all__ = ["strip_arrays", "strip_index_map", "build_strips",
           "band_strip_index_map", "band_source_map", "build_band_strips"]


def _geometry(st, dtype=torch.float32):
    """(R, P_l) of the strips of arrays of ``dtype``."""
    from .fused_stencil import cfp_geometry, strip_rows

    return strip_rows(st.n_steps, dtype), cfp_geometry(st.nside, st.n_steps)[1]


def strip_arrays(st, xc, faces=None, bands=None, R=None):
    """Plain version: (top, bot, ls) from slices and flips of the interior
    of ``xc`` (C, 12, n, P_l) (lanes [h, h+n); the rest is not read), with
    R rows in ``top`` and ``bot`` (default: those of its dtype,
    :func:`.fused_stencil.strip_rows`).

    ``faces``/``bands``: the strips of ``faces`` only (F of them, in that
    order, (C, F, ...) each), with the neighbour data read from the four
    full-sphere edge bands ``bands`` (:func:`.stencil.extract_edge_bands`
    or :func:`.stencil.unpack_edge_bands`); ``xc`` may then be None."""
    n, h = st.nside, st.n_steps
    ref = xc if bands is None else bands[0]
    R_dt, P_l = _geometry(st, ref.dtype)
    R = R_dt if R is None else R
    C = ref.shape[0]
    west, east, south, north = edge_strips(n, h, xc, embedded=True,
                                           faces=faces, bands=bands)
    F = west.shape[1]

    def zer(*s):
        return ref.new_zeros((C, F) + s)

    P0 = n + 2 * h
    wp = torch.cat([west, zer(h, P_l - P0)], dim=3)
    ep = torch.cat([east, zer(h, P_l - P0)], dim=3)
    top = torch.cat([zer(R - h, P_l), wp], dim=2)
    bot = torch.cat([ep, zer(R - h, P_l)], dim=2)
    ls = torch.cat([south, north, zer(n, 128 - 2 * h)], dim=3)
    return top, bot, ls


def strip_index_map(st, dtype=torch.float32):
    """Host int32 source map of the strips of arrays of ``dtype`` (float32,
    or bfloat16: R16 strips): for every element of one channel's ``top``,
    ``bot`` and ``ls`` (concatenated, flattened in that order), its flat
    index into one channel (12, n, P_l) of ``xc``, or -1 for a zero.
    Derived by running :func:`strip_arrays` on an image of flat indices,
    so it follows ``edge_descriptor`` exactly.  Cached on ``st``."""
    R, P_l = _geometry(st, dtype)
    cache = st.__dict__.setdefault("_strip_idx_cache", {})
    if R not in cache:
        n = st.nside
        ids = torch.arange(1, 12 * n * P_l + 1, dtype=torch.int64)
        parts = strip_arrays(st, ids.reshape(1, 12, n, P_l), R=R)
        m = (torch.cat([p.reshape(-1) for p in parts]) - 1).numpy()
        cache[R] = m.astype(np.int32)
    return cache[R]


def band_strip_index_map(st, faces):
    """Host int32 source map of the strips of ``faces`` read from the
    packed all-gathered band buffer of one channel, (12, 1, 4*h*n): for
    every element of one channel's ``top``, ``bot`` and ``ls`` of those
    faces (concatenated, flattened in that order), its flat index into that
    buffer, or -1 for a zero.  Derived, as :func:`strip_index_map`, by
    running :func:`strip_arrays` on an image of flat indices.  For C
    channels, the element of face f and band offset j lies at
    ``f*C*4hn + j`` (:func:`build_band_strips` rescales).  Cached on ``st``
    per face tuple."""
    faces = tuple(int(f) for f in faces)
    cache = st.__dict__.setdefault("_band_strip_idx_cache", {})
    if faces not in cache:
        n, h = st.nside, st.n_steps
        L = 4 * h * n
        ids = torch.arange(1, 12 * L + 1, dtype=torch.int64).reshape(12, 1, L)
        parts = strip_arrays(st, None, faces, unpack_edge_bands(ids, n, h))
        m = torch.cat([p.reshape(-1) for p in parts]) - 1
        cache[faces] = m.numpy().astype(np.int32)
    return cache[faces]


def _strip_views(st, flat, C, F):
    """(top, bot, ls) views of the flat strip buffer of :func:`..library.strips`
    (one allocation: top and bot (C, F, R, P_l), then ls (C, F, n, 128))."""
    n = st.nside
    R, P_l = _geometry(st, flat.dtype)
    e_tb = C * F * R * P_l
    return (flat[:e_tb].view(C, F, R, P_l),
            flat[e_tb:2 * e_tb].view(C, F, R, P_l),
            flat[2 * e_tb:].view(C, F, n, 128))


def build_strips(st, xc, index=None):
    """(top, bot, ls) of ``xc`` (C, 12, n, P_l), float32 or bfloat16,
    through the ``strips`` op: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor.  ``index``: the device copy of
    :func:`strip_index_map` for ``xc``'s dtype (``tables["strip_idx"]`` or
    ``["strip_idx_bf16"]``), else built here."""
    from .library import check_device

    check_device("strips", xc)
    if index is None:
        index = torch.from_numpy(strip_index_map(st, xc.dtype)).to(xc.device)
    flat = torch.ops.deepsphere.strips(xc, index, st.nside, st.n_steps,
                                       list(range(12)))
    return _strip_views(st, flat, xc.shape[0], 12)


def band_source_map(m, C, L):
    """One channel's band strip map ``m`` (:func:`band_strip_index_map`,
    any integer type) -> the int32 map into C channels' packed bands
    (12, C, L), where face f's bands start at f*C*L."""
    m = m.to(torch.int64)
    return torch.where(m >= 0, (m // L) * (C * L) + m % L, m).to(torch.int32)


def _band_source_map(st, faces, C, device, index=None):
    """:func:`band_source_map` of ``faces`` for C channels on ``device``,
    cached on ``st`` per (faces, C, device): the sharded forward would
    otherwise rescale the map on every call.  ``index``: the device copy of
    :func:`band_strip_index_map` for these faces, else built here."""
    faces = tuple(int(f) for f in faces)
    cache = st.__dict__.setdefault("_band_source_map_cache", {})
    key = (faces, C, str(device))
    if key not in cache:
        if index is None:
            index = torch.from_numpy(band_strip_index_map(st, faces))
        cache[key] = band_source_map(index.to(device), C,
                                     4 * st.n_steps * st.nside)
    return cache[key]


def build_band_strips(st, bands, faces, index=None):
    """(top, bot, ls) of ``faces`` (C, F, ...) from the packed all-gathered
    edge bands ``bands`` (12, C, 4*h*n) through the ``strips`` op: the
    gather kernel (K4's) for a CUDA tensor, the plain version for a CPU
    tensor.  ``index``: the device copy of :func:`band_strip_index_map` for
    these faces (any integer type), else built here."""
    from .library import check_device

    n, h = st.nside, st.n_steps
    C = bands.shape[1]
    if tuple(bands.shape) != (12, C, 4 * h * n):
        raise ValueError(f"bands {tuple(bands.shape)} != (12, C, {4 * h * n})")
    check_device("strips", bands)
    faces = [int(f) for f in faces]
    m = _band_source_map(st, faces, C, bands.device, index)
    flat = torch.ops.deepsphere.strips(bands, m, n, h, faces)
    return _strip_views(st, flat, C, len(faces))
