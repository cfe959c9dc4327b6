"""NEST <-> face-layout activation conversion, gather-free.

Within a HEALPix base face, NEST ordering is the Morton (z-order) curve of
the (x, y) face coordinates, so converting a NEST-ordered pixel axis to the
raster (12, n, n) face layout is a structured permutation: log2(nside)
rank-7 reshape/permute passes, each a dense copy.

Face-flat contract used across the port: axis ordering [face, x, y]
row-major, i.e. position = (face * nside + x) * nside + y, identical to
``sphere.faces.face2nest_index``.
"""

from __future__ import annotations

__all__ = ["nest_to_face", "face_to_nest", "nside_of_axis"]


def nside_of_axis(M):
    """nside implied by a pixel axis of length M = 12 nside^2."""
    n = int(round((M / 12) ** 0.5))
    if 12 * n * n != M or (n & (n - 1)) != 0:
        raise ValueError(f"axis length {M} is not 12 * nside^2 for a power-of-2 nside")
    return n


def nest_to_face(x):
    """(..., M, C) with a NEST pixel axis -> same shape, face-flat ordering.

    Runs as log2(nside) dense permutes — no gather.  The inverse is
    :func:`face_to_nest`.
    """
    lead = tuple(x.shape[:-2])
    M, C = x.shape[-2], x.shape[-1]
    n = nside_of_axis(M)
    k = n.bit_length() - 1
    nd = len(lead)
    side = 1
    T = x.reshape(lead + (12, n * n, 1, 1, C))
    for _ in range(k):
        q = T.shape[nd + 1] // 4
        # Morton LSBs are the finest level: consecutive 4 = (y_j, x_j) block
        T = T.reshape(lead + (12, q, 2, 2, side, side, C))
        # (..., 12, q, y_j, x_j, X, Y, C) -> (..., 12, q, x_j, X, y_j, Y, C)
        perm = tuple(range(nd)) + (nd, nd + 1, nd + 3, nd + 4, nd + 2, nd + 5, nd + 6)
        T = T.permute(perm)
        side *= 2
        T = T.reshape(lead + (12, q, side, side, C))
    return T.reshape(lead + (M, C))


def face_to_nest(x):
    """Inverse of :func:`nest_to_face`: (..., M, C) face-flat -> NEST."""
    lead = tuple(x.shape[:-2])
    M, C = x.shape[-2], x.shape[-1]
    n = nside_of_axis(M)
    k = n.bit_length() - 1
    nd = len(lead)
    side = n
    q = 1
    T = x.reshape(lead + (12, 1, n, n, C))
    for _ in range(k):
        half = side // 2
        T = T.reshape(lead + (12, q, 2, half, 2, half, C))
        # (..., 12, q, x_j, X, y_j, Y, C) -> (..., 12, q, y_j, x_j, X, Y, C)
        perm = tuple(range(nd)) + (nd, nd + 1, nd + 4, nd + 2, nd + 3, nd + 5, nd + 6)
        T = T.permute(perm)
        q *= 4
        side = half
        T = T.reshape(lead + (12, q, side, side, C))
    return T.reshape(lead + (M, C))
