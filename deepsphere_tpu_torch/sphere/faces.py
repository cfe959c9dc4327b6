"""HEALPix 12-face (x, y) layout with cross-face halos.

The TPU-native representation of a HEALPix map.  In NEST ordering every pixel
index is the bit-interleave (Morton / z-order) of its (x, y) position within
one of 12 square base faces, so a NEST map of npix = 12 nside^2 values *is* a
(12, nside, nside) image up to a fixed permutation.  On this layout the
8-neighbor sphere graph used by DeepSphere (reference graph backend:
``SphereHealpix(..., k=8)`` consumed at
``deepsphere-cosmo-tf2 src/deepsphere/healpy_networks.py:110-118``) becomes a plain
3x3 stencil with per-pixel weights, and NEST pooling by 4^p
(``healpy_layers.py:20-84``) becomes 2^p x 2^p spatial pooling.  Graph
convolution therefore needs **no gather at all** on the hot path — only
vector shifts (VPU) and matmuls (MXU) — provided each face is padded with a
halo copied from its neighboring faces.

This module computes the static (host-side, cached) index maps:

* :func:`face_coords_to_pix` — global NEST pixel living at (possibly
  out-of-face) face coordinates, handling the cross-face coordinate
  transforms (the same face-transition tables as the neighbor walk in
  :mod:`.healpix`).
* :func:`halo_map` — (12, nside+2h, nside+2h) map of global NEST pixel ids
  for faces extended by an h-deep halo; -1 marks the 8 polar corner regions
  where no pixel exists (faces meet 3-way there).
* :func:`nest2face` / :func:`face2nest` — the Morton permutations between a
  NEST-ordered axis and the (12, nside, nside) face layout.
"""

from __future__ import annotations

import numpy as np

from . import healpix as hp
from .healpix import (
    _NB_FACEARRAY,
    _NB_SWAPARRAY,
    _nest2xyf,
    _xyf2nest,
)

__all__ = [
    "face_coords_to_pix",
    "halo_map",
    "edge_descriptor",
    "nest2face_index",
    "face2nest_index",
    "nest2face",
    "face2nest",
]


def edge_descriptor(face, xs, ys):
    """How the (xs, ys) halo region of ``face`` maps onto a neighbor face.

    The cross-face transform is *uniform over a whole side/corner region*
    (one row of the healpix_base face-transition tables), so halo strips
    are never true gathers — they are neighbor-face edge bands under an
    affine flip/transpose.  This is what makes a gather-free halo refresh
    possible on TPU.

    :param xs: -1 (x < 0 side), 0 (x interior), +1 (x >= nside side)
    :param ys: same for y; (0, 0) is invalid
    :return: ``None`` when the region has no pixels (the 8 polar 3-way
        corners), else ``(nbf, flip_x, flip_y, swap)``: the halo value at
        local in-neighbor coords ``(xw, yw)`` (``xw = x mod nside`` etc.)
        is neighbor face ``nbf`` at ``(xf, yf)`` where
        ``xw2 = nside-1-xw if flip_x else xw`` (same for y) and
        ``(xf, yf) = (yw2, xw2) if swap else (xw2, yw2)``
        (matches :func:`face_coords_to_pix`).
    """
    if xs == 0 and ys == 0:
        raise ValueError("(0, 0) is the face interior, not a halo region")
    nbnum = 4 + xs + 3 * ys
    nbf = int(_NB_FACEARRAY[nbnum, face])
    if nbf < 0:
        return None
    bits = int(_NB_SWAPARRAY[nbnum, face >> 2])
    return nbf, bool(bits & 1), bool(bits & 2), bool(bits & 4)


def face_coords_to_pix(nside, x, y, face):
    """Global NEST pixel id at face coordinates (x, y) on ``face``.

    Coordinates may overhang the face by up to ``nside - 1`` on either side
    (a single face crossing); the cross-face transform (translation /
    reflection / transposition per the healpix_base face-transition tables)
    is applied.  Returns -1 where no pixel exists (beyond the 8 polar
    corners of the sphere).
    """
    nside = int(nside)
    x = np.asarray(x, dtype=np.int64)
    y = np.asarray(y, dtype=np.int64)
    face = np.asarray(face, dtype=np.int64)
    x, y, face = np.broadcast_arrays(x, y, face)
    nsm1 = nside - 1

    xs = np.where(x < 0, -1, np.where(x > nsm1, 1, 0))
    ys = np.where(y < 0, -1, np.where(y > nsm1, 1, 0))
    inside = (xs == 0) & (ys == 0)

    out = np.full(x.shape, -1, dtype=np.int64)
    if np.any(inside):
        out[inside] = _xyf2nest(nside, x[inside], y[inside], face[inside])

    cross = ~inside
    if np.any(cross):
        xc, yc, fc = x[cross], y[cross], face[cross]
        nbnum = 4 + xs[cross] + 3 * ys[cross]
        nbf = _NB_FACEARRAY[nbnum, fc]
        bits = _NB_SWAPARRAY[nbnum, fc >> 2]
        # position within the neighbor face (mod nside works for negatives
        # because nside is a power of two)
        xw = xc & nsm1
        yw = yc & nsm1
        xw2 = np.where(bits & 1, nsm1 - xw, xw)
        yw2 = np.where(bits & 2, nsm1 - yw, yw)
        xf = np.where(bits & 4, yw2, xw2)
        yf = np.where(bits & 4, xw2, yw2)
        valid = nbf >= 0
        sub = np.full(xc.shape, -1, dtype=np.int64)
        if np.any(valid):
            sub[valid] = _xyf2nest(nside, xf[valid], yf[valid], nbf[valid])
        out[cross] = sub
    return out


def halo_map(nside, h):
    """(12, nside+2h, nside+2h) int64 array of global NEST pixel ids for
    each face extended by an h-deep halo; -1 where no pixel exists.

    ``out[f, h + x, h + y]`` is the pixel at face coordinates (x, y) of face
    f, for x, y in [-h, nside + h).  Requires ``h < nside`` (single face
    crossing).
    """
    nside = int(nside)
    if not 0 <= h < nside:
        raise ValueError(f"halo depth must satisfy 0 <= h < nside, got {h}")
    P = nside + 2 * h
    coords = np.arange(-h, nside + h, dtype=np.int64)
    xg = coords[None, :, None]
    yg = coords[None, None, :]
    fg = np.arange(12, dtype=np.int64)[:, None, None]
    return face_coords_to_pix(nside, np.broadcast_to(xg, (12, P, P)),
                              np.broadcast_to(yg, (12, P, P)), fg)


def nest2face_index(nside):
    """(12, nside, nside) int64: NEST pixel id living at [face, x, y]."""
    return halo_map(nside, 0)


def face2nest_index(nside):
    """(npix,) int64: flat index into a flattened (12, nside, nside) face
    array giving, for each NEST pixel, its face-layout position."""
    npix = hp.nside2npix(nside)
    ix, iy, face = _nest2xyf(nside, np.arange(npix, dtype=np.int64))
    return (face * nside + ix) * nside + iy


def nest2face(m, nside, axis=-1):
    """Reorder a NEST-indexed axis of length npix into face layout; the axis
    becomes three axes (12, nside, nside)."""
    m = np.asarray(m)
    idx = nest2face_index(nside).reshape(-1)
    out = np.take(m, idx, axis=axis)
    ax = axis if axis >= 0 else m.ndim + axis
    return out.reshape(m.shape[:ax] + (12, nside, nside) + m.shape[ax + 1 :])


def face2nest(m, nside, axis=0):
    """Inverse of :func:`nest2face`: collapse (12, nside, nside) axes at
    ``axis`` back into a single NEST-ordered axis."""
    m = np.asarray(m)
    ax = axis if axis >= 0 else m.ndim + axis
    flat = m.reshape(m.shape[:ax] + (12 * nside * nside,) + m.shape[ax + 3 :])
    idx = face2nest_index(nside)
    return np.take(flat, idx, axis=ax)
