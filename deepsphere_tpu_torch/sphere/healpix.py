"""Pure-numpy HEALPix geometry core.

A from-scratch, vectorized implementation of the HEALPix pixelization math
(Gorski et al. 2005) used by the framework: nside/npix bookkeeping, NEST/RING
pixel orderings and conversions, pixel centers (``pix2ang`` / ``pix2vec``) and
resolution changes (``ud_grade``).  It replaces the external ``healpy`` C++
dependency of the reference implementation (see
``deepsphere-cosmo-tf2 src/deepsphere/utils.py:3`` and
``deepsphere-cosmo-tf2 src/deepsphere/healpy_networks.py:1``) with host-side numpy
precompute; nothing here runs inside the TPU compute path.

All functions accept scalars or numpy arrays and are fully vectorized.  The
conversion hub is the (face, x, y) coordinate system: every ordering converts
through ``_nest2xyf`` / ``_ring2xyf`` and back, mirroring the classic
``healpix_base`` algorithm structure.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "isnsideok",
    "nside2npix",
    "npix2nside",
    "nside2order",
    "nside2resol",
    "nside2pixarea",
    "nest2ring",
    "ring2nest",
    "reorder",
    "pix2ang",
    "ang2pix",
    "pix2vec",
    "vec2pix",
    "ud_grade",
    "neighbors_nest",
]

# Ring offsets of the 12 base faces: jr = jrll*nside - x - y - 1 is the ring
# index counted from the north pole, jp ~ jpll locates the face in azimuth.
_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4], dtype=np.int64)
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7], dtype=np.int64)


# ---------------------------------------------------------------------------
# bookkeeping
# ---------------------------------------------------------------------------

def isnsideok(nside, nest=True):
    """True when ``nside`` is a valid resolution (power of two for NEST)."""
    nside = np.asarray(nside)
    ok = nside > 0
    if nest:
        n = nside.astype(np.int64)
        ok = ok & ((n & (n - 1)) == 0)
    return bool(np.all(ok))


def nside2npix(nside):
    return 12 * int(nside) * int(nside)


def npix2nside(npix):
    nside = int(round(np.sqrt(npix / 12.0)))
    if 12 * nside * nside != npix:
        raise ValueError(f"{npix} is not a valid HEALPix map size")
    return nside


def nside2order(nside):
    if not isnsideok(nside, nest=True):
        raise ValueError(f"nside {nside} is not a power of two")
    return int(nside).bit_length() - 1


def nside2resol(nside, arcmin=False):
    """Approximate pixel resolution: sqrt of the pixel area."""
    resol = np.sqrt(nside2pixarea(nside))
    if arcmin:
        resol = np.degrees(resol) * 60.0
    return resol


def nside2pixarea(nside, degrees=False):
    area = 4.0 * np.pi / nside2npix(nside)
    if degrees:
        area = np.degrees(np.degrees(area))
    return area


def _isqrt(x):
    """Exact vectorized integer sqrt for int64 inputs."""
    x = np.asarray(x, dtype=np.int64)
    s = np.floor(np.sqrt(x.astype(np.float64) + 0.5)).astype(np.int64)
    # float rounding can be off by one in either direction at large x
    s = np.where(s * s > x, s - 1, s)
    s = np.where((s + 1) * (s + 1) <= x, s + 1, s)
    return s


# ---------------------------------------------------------------------------
# (face, x, y) <-> NEST: z-order bit interleaving
# ---------------------------------------------------------------------------

def _compress_bits(v):
    """Keep even-position bits of int64 v and pack them densely (vectorized)."""
    v = v & 0x5555555555555555
    v = (v | (v >> 1)) & 0x3333333333333333
    v = (v | (v >> 2)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF0000FFFF
    v = (v | (v >> 16)) & 0x00000000FFFFFFFF
    return v


def _spread_bits(v):
    """Inverse of _compress_bits: spread low 32 bits to even positions."""
    v = v & 0x00000000FFFFFFFF
    v = (v | (v << 16)) & 0x0000FFFF0000FFFF
    v = (v | (v << 8)) & 0x00FF00FF00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v << 2)) & 0x3333333333333333
    v = (v | (v << 1)) & 0x5555555555555555
    return v


def _nest2xyf(nside, pix):
    pix = np.asarray(pix, dtype=np.int64)
    order = nside2order(nside)
    face = pix >> (2 * order)
    within = pix & (nside * nside - 1)
    ix = _compress_bits(within)
    iy = _compress_bits(within >> 1)
    return ix, iy, face


def _xyf2nest(nside, ix, iy, face):
    order = nside2order(nside)
    within = _spread_bits(np.asarray(ix, dtype=np.int64)) | (
        _spread_bits(np.asarray(iy, dtype=np.int64)) << 1
    )
    return (np.asarray(face, dtype=np.int64) << (2 * order)) + within


# ---------------------------------------------------------------------------
# (face, x, y) <-> RING
# ---------------------------------------------------------------------------

def _xyf2ring(nside, ix, iy, face):
    nside = int(nside)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    nl4 = 4 * nside
    ix = np.asarray(ix, dtype=np.int64)
    iy = np.asarray(iy, dtype=np.int64)
    face = np.asarray(face, dtype=np.int64)

    jr = _JRLL[face] * nside - ix - iy - 1  # ring index from north, 1..4n-1

    north = jr < nside
    south = jr > 3 * nside

    nr = np.where(north, jr, np.where(south, nl4 - jr, nside))
    kshift = np.where(north | south, 0, (jr - nside) & 1)
    n_before = np.where(
        north,
        2 * nr * (nr - 1),
        np.where(south, npix - 2 * (nr + 1) * nr, ncap + (jr - nside) * nl4),
    )

    jp = (_JPLL[face] * nr + ix - iy + 1 + kshift) // 2
    jp = np.where(jp > nl4, jp - nl4, jp)
    jp = np.where(jp < 1, jp + nl4, jp)
    return n_before + jp - 1


def _ring2xyf(nside, pix):
    nside = int(nside)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    nl2 = 2 * nside
    nl4 = 4 * nside
    order = nside2order(nside)
    pix = np.asarray(pix, dtype=np.int64)

    iring = np.empty_like(pix)
    iphi = np.empty_like(pix)
    kshift = np.zeros_like(pix)
    nr = np.empty_like(pix)
    face = np.empty_like(pix)

    north = pix < ncap
    south = pix >= npix - ncap
    equat = ~(north | south)

    # North polar cap
    pn = pix[north]
    ir = (1 + _isqrt(1 + 2 * pn)) >> 1
    iring[north] = ir
    iphi[north] = (pn + 1) - 2 * ir * (ir - 1)
    nr[north] = ir
    face[north] = (iphi[north] - 1) // np.maximum(ir, 1)

    # Equatorial belt
    pe = pix[equat] - ncap
    tmp = pe >> (order + 2)
    ir = tmp + nside
    ip = pe - tmp * nl4 + 1
    iring[equat] = ir
    iphi[equat] = ip
    kshift[equat] = (ir + nside) & 1
    nr[equat] = nside
    ire = ir - nside + 1
    irm = nl2 + 2 - ire
    ifm = (ip - ire // 2 + nside - 1) >> order
    ifp = (ip - irm // 2 + nside - 1) >> order
    face[equat] = np.where(ifp == ifm, ifp | 4, np.where(ifp < ifm, ifp, ifm + 8))

    # South polar cap
    ps = npix - pix[south]
    ir = (1 + _isqrt(2 * ps - 1)) >> 1
    ipx = 4 * ir + 1 - (ps - 2 * ir * (ir - 1))
    iphi[south] = ipx
    nr[south] = ir
    face[south] = 8 + (ipx - 1) // np.maximum(ir, 1)
    iring[south] = 2 * nl2 - ir

    irt = iring - _JRLL[face] * nside + 1
    ipt = 2 * iphi - _JPLL[face] * nr - kshift - 1
    ipt = np.where(ipt >= nl2, ipt - 8 * nside, ipt)

    ix = (ipt - irt) >> 1
    iy = (-(ipt + irt)) >> 1
    return ix, iy, face


def nest2ring(nside, pix):
    ix, iy, face = _nest2xyf(nside, pix)
    return _xyf2ring(nside, ix, iy, face)


def ring2nest(nside, pix):
    ix, iy, face = _ring2xyf(nside, pix)
    return _xyf2nest(nside, ix, iy, face)


def reorder(map_in, n2r=False, r2n=False):
    """Reorder a full map between NEST and RING (parity with hp.reorder)."""
    map_in = np.asarray(map_in)
    npix = map_in.shape[-1]
    nside = npix2nside(npix)
    pix = np.arange(npix, dtype=np.int64)
    if n2r == r2n:
        raise ValueError("exactly one of n2r / r2n must be True")
    if n2r:
        # out[ring_index] = in[nest_index]: out[i] = in[ring2nest(i)]
        return map_in[..., ring2nest(nside, pix)]
    return map_in[..., nest2ring(nside, pix)]


# ---------------------------------------------------------------------------
# angles / vectors
# ---------------------------------------------------------------------------

def _xyf2loc(nside, ix, iy, face):
    """(face,x,y) -> (z, phi) of pixel centers."""
    nside = int(nside)
    npix = nside2npix(nside)
    nl4 = 4 * nside
    jr = _JRLL[np.asarray(face, dtype=np.int64)] * nside - ix - iy - 1

    north = jr < nside
    south = jr > 3 * nside
    nr = np.where(north, jr, np.where(south, nl4 - jr, nside))

    fact2 = 4.0 / npix
    fact1 = (nside * 2) * fact2
    z = np.where(
        north,
        1.0 - nr * nr * fact2,
        np.where(south, -1.0 + nr * nr * fact2, (2 * nside - jr) * fact1),
    )
    kshift = np.where(north | south, 0, (jr - nside) & 1)

    jp = (_JPLL[np.asarray(face, dtype=np.int64)] * nr + ix - iy + 1 + kshift) // 2
    jp = np.where(jp > nl4, jp - nl4, jp)
    jp = np.where(jp < 1, jp + nl4, jp)

    phi = (jp - (kshift + 1) * 0.5) * (np.pi / 2.0) / nr
    return z, phi


def pix2ang(nside, ipix, nest=False, lonlat=False):
    """Pixel center angles. Returns (theta, phi) in radians, or (lon, lat)
    in degrees when ``lonlat`` (parity with healpy's convention)."""
    ipix = np.asarray(ipix, dtype=np.int64)
    if nest:
        ix, iy, face = _nest2xyf(nside, ipix)
    else:
        ix, iy, face = _ring2xyf(nside, ipix)
    z, phi = _xyf2loc(nside, ix, iy, face)
    theta = np.arccos(np.clip(z, -1.0, 1.0))
    if lonlat:
        lon = np.degrees(phi)
        lat = 90.0 - np.degrees(theta)
        return lon, lat
    return theta, phi


def pix2vec(nside, ipix, nest=False):
    """Pixel center unit vectors, shape (..., 3)."""
    theta, phi = pix2ang(nside, ipix, nest=nest)
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)], axis=-1)


def ang2pix(nside, theta, phi, nest=False):
    """Angles -> pixel index containing that direction."""
    nside = int(nside)
    theta = np.asarray(theta, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi, 2 * np.pi) * (2.0 / np.pi)  # in [0,4)

    # equatorial belt |z| <= 2/3
    temp1 = nside * (0.5 + tt)
    temp2 = nside * (z * 0.75)
    jp_e = np.floor(temp1 - temp2).astype(np.int64)  # ascending edge line
    jm_e = np.floor(temp1 + temp2).astype(np.int64)  # descending edge line
    ifp = jp_e >> nside2order(nside)
    ifm = jm_e >> nside2order(nside)
    face_e = np.where(ifp == ifm, ifp | 4, np.where(ifp < ifm, ifp, ifm + 8))
    ix_e = jm_e & (nside - 1)
    iy_e = nside - (jp_e & (nside - 1)) - 1

    # polar caps
    ntt = np.minimum(np.floor(tt).astype(np.int64), 3)
    tp = tt - ntt
    with np.errstate(invalid="ignore"):
        tmp = nside * np.sqrt(3.0 * (1.0 - za))
    jp_p = np.floor(tp * tmp).astype(np.int64)
    jm_p = np.floor((1.0 - tp) * tmp).astype(np.int64)
    jp_p = np.minimum(jp_p, nside - 1)
    jm_p = np.minimum(jm_p, nside - 1)
    north = z >= 0
    face_p = np.where(north, ntt, ntt + 8)
    ix_p = np.where(north, nside - jm_p - 1, jp_p)
    iy_p = np.where(north, nside - jp_p - 1, jm_p)

    polar = za > 2.0 / 3.0
    ix = np.where(polar, ix_p, ix_e)
    iy = np.where(polar, iy_p, iy_e)
    face = np.where(polar, face_p, face_e)

    if nest:
        return _xyf2nest(nside, ix, iy, face)
    return _xyf2ring(nside, ix, iy, face)


def vec2pix(nside, x, y, z, nest=False):
    theta = np.arccos(np.clip(z / np.sqrt(x * x + y * y + z * z), -1, 1))
    phi = np.arctan2(y, x)
    return ang2pix(nside, theta, phi, nest=nest)


# ---------------------------------------------------------------------------
# ud_grade
# ---------------------------------------------------------------------------

def ud_grade(map_in, nside_out, order_in="RING", order_out=None, power=None):
    """Up/downgrade the resolution of a map (parity with hp.ud_grade for the
    modes the reference uses: averaging downgrade, replicating upgrade,
    optional spectral ``power`` scaling).  Used by the index bookkeeping in
    the model assembler (``deepsphere-cosmo-tf2 src/deepsphere/healpy_networks.py:73-88``).
    """
    map_in = np.asarray(map_in, dtype=np.float64)
    npix_in = map_in.shape[-1]
    nside_in = npix2nside(npix_in)
    if order_out is None:
        order_out = order_in
    nest_in = order_in.upper().startswith("N")
    nest_out = order_out.upper().startswith("N")

    m = map_in if nest_in else reorder(map_in, r2n=True)

    if nside_out < nside_in:
        rat = (nside_in // nside_out) ** 2
        m = m.reshape(m.shape[:-1] + (nside2npix(nside_out), rat)).mean(axis=-1)
    elif nside_out > nside_in:
        rat = (nside_out // nside_in) ** 2
        m = np.repeat(m, rat, axis=-1)

    if power is not None and power != 0:
        m = m * (nside_in / nside_out) ** power

    if not nest_out:
        m = reorder(m, n2r=True)
    return m


# ---------------------------------------------------------------------------
# NEST grid neighbors
# ---------------------------------------------------------------------------

# Face adjacency tables for crossing face borders, following the classic
# healpix_base neighbor algorithm.  Rows are indexed by the border-crossing
# region nbnum = 4 + xstatus + 3*ystatus (status in {-1,0,+1}); columns of
# _NB_FACEARRAY by the source face, columns of _NB_SWAPARRAY by face>>2
# (north/equatorial/south face group).
_NB_XOFFSET = np.array([-1, -1, 0, 1, 1, 1, 0, -1], dtype=np.int64)
_NB_YOFFSET = np.array([0, 1, 1, 1, 0, -1, -1, -1], dtype=np.int64)
_NB_FACEARRAY = np.array(
    [
        [8, 9, 10, 11, -1, -1, -1, -1, 10, 11, 8, 9],
        [5, 6, 7, 4, 8, 9, 10, 11, 9, 10, 11, 8],
        [-1, -1, -1, -1, 5, 6, 7, 4, -1, -1, -1, -1],
        [4, 5, 6, 7, 11, 8, 9, 10, 11, 8, 9, 10],
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],
        [1, 2, 3, 0, 0, 1, 2, 3, 5, 6, 7, 4],
        [-1, -1, -1, -1, 7, 4, 5, 6, -1, -1, -1, -1],
        [3, 0, 1, 2, 3, 0, 1, 2, 4, 5, 6, 7],
        [2, 3, 0, 1, -1, -1, -1, -1, 0, 1, 2, 3],
    ],
    dtype=np.int64,
)
# bits: 1 -> invert x, 2 -> invert y, 4 -> swap x/y (inversions first)
_NB_SWAPARRAY = np.array(
    [
        [0, 0, 3],
        [0, 0, 6],
        [0, 0, 0],
        [0, 0, 5],
        [0, 0, 0],
        [5, 0, 0],
        [0, 0, 0],
        [6, 0, 0],
        [3, 0, 0],
    ],
    dtype=np.int64,
)


def neighbors_nest(nside, ipix):
    """Grid neighbors (SW, W, NW, N, NE, E, SE, S) of NEST pixels.

    Vectorized port of the healpix_base neighbor algorithm.  Returns an array
    of shape ``ipix.shape + (8,)``; entries are -1 where a neighbor does not
    exist (the 24 pixels touching a face corner with no diagonal partner).
    """
    nside = int(nside)
    ipix = np.asarray(ipix, dtype=np.int64)
    ix, iy, face = _nest2xyf(nside, ipix)

    out = np.empty(ipix.shape + (8,), dtype=np.int64)
    nsm1 = nside - 1
    for d in range(8):
        x = ix + _NB_XOFFSET[d]
        y = iy + _NB_YOFFSET[d]
        inside = (x >= 0) & (x <= nsm1) & (y >= 0) & (y <= nsm1)
        res = np.full(ipix.shape, -1, dtype=np.int64)
        if np.any(inside):
            res[inside] = _xyf2nest(nside, x[inside], y[inside], face[inside])
        cross = ~inside
        if np.any(cross):
            xc = x[cross]
            yc = y[cross]
            fc = face[cross]
            xs = np.where(xc < 0, -1, np.where(xc > nsm1, 1, 0))
            ys = np.where(yc < 0, -1, np.where(yc > nsm1, 1, 0))
            nbnum = 4 + xs + 3 * ys
            nbf = _NB_FACEARRAY[nbnum, fc]
            bits = _NB_SWAPARRAY[nbnum, fc >> 2]
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
            res[cross] = sub
        out[..., d] = res
    return out
