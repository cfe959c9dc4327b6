"""Map projections for HEALPix maps (gnomonic + Mollweide), healpy-free.

Self-contained replacements for the ``hp.gnomview`` / ``hp.mollview`` calls
the reference makes in its plotting layer (``deepsphere-cosmo-tf2
src/deepsphere/plot.py:47-60``): build a grid of sky directions for the
projection, convert to pixel indices with this package's own
``ang2pix``/``vec2pix`` (:mod:`..sphere.healpix`, numpy), and render with
matplotlib, which the view functions import (the pixel maps need none).
"""

from __future__ import annotations

import numpy as np

from ..sphere import healpix as hp

__all__ = ["gnomonic_pixels", "mollweide_pixels", "gnomview", "mollview"]


def _lonlat_basis(lon_deg, lat_deg):
    """Center direction + local (east, north) tangent basis."""
    lon = np.deg2rad(lon_deg)
    lat = np.deg2rad(lat_deg)
    c = np.array([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)])
    east = np.array([-np.sin(lon), np.cos(lon), 0.0])
    north = np.array(
        [-np.sin(lat) * np.cos(lon), -np.sin(lat) * np.sin(lon), np.cos(lat)]
    )
    return c, east, north


def gnomonic_pixels(nside, rot=(0.0, 0.0), reso=1.5, xsize=200, nest=True):
    """Pixel-index grid of a gnomonic (tangent-plane) projection.

    :param rot: (lon, lat) center, degrees
    :param reso: resolution, arcmin / projected pixel
    :param xsize: output grid side length
    :return: (xsize, xsize) int64 HEALPix pixel indices (row 0 = north)
    """
    c, east, north = _lonlat_basis(*rot)
    step = np.deg2rad(reso / 60.0)
    r = (np.arange(xsize) - (xsize - 1) / 2.0) * step
    xx, yy = np.meshgrid(r, r)
    # tangent-plane point P = c + x*east + y*north; row 0 (yy = -max) maps to
    # +north so the image is north-up with origin="upper"
    vec = (
        c[None, None, :]
        + xx[..., None] * east[None, None, :]
        - yy[..., None] * north[None, None, :]
    )
    vec /= np.linalg.norm(vec, axis=-1, keepdims=True)
    return hp.vec2pix(nside, vec[..., 0], vec[..., 1], vec[..., 2], nest=nest)


def mollweide_pixels(nside, xsize=800, nest=True):
    """Pixel-index grid of a Mollweide projection of the full sky.

    :return: ((ysize, xsize) int64 pixel indices, (ysize, xsize) bool mask)
        with ysize = xsize // 2; mask is False outside the ellipse.
    """
    ysize = xsize // 2
    x = np.linspace(-2.0, 2.0, xsize)
    y = np.linspace(-1.0, 1.0, ysize)
    xx, yy = np.meshgrid(x, -y)  # north up
    inside = (xx / 2.0) ** 2 + yy**2 <= 1.0
    theta_aux = np.arcsin(np.clip(yy, -1.0, 1.0))
    lat = np.arcsin(np.clip((2 * theta_aux + np.sin(2 * theta_aux)) / np.pi, -1, 1))
    with np.errstate(invalid="ignore", divide="ignore"):
        lon = np.pi * xx / (2 * np.cos(theta_aux))
    lon = np.where(np.abs(lon) > np.pi, np.nan, lon)
    ok = inside & np.isfinite(lon)
    theta = np.pi / 2 - lat  # colatitude
    pix = np.zeros(xx.shape, dtype=np.int64)
    # healpy convention: longitude increases eastward; wrap to [0, 2pi)
    phi = np.mod(lon, 2 * np.pi)
    pix[ok] = hp.ang2pix(nside, theta[ok], phi[ok], nest=nest)
    return pix, ok


def _gnomonic_forward(v, c, east, north):
    """Project unit direction(s) v onto the tangent plane at c.

    Returns (x_deg, y_deg) plane offsets matching :func:`gnomonic_pixels`'s
    axes (x along east, y along north), NaN behind the tangent point."""
    v = np.asarray(v, dtype=np.float64)
    d = v @ c
    with np.errstate(invalid="ignore", divide="ignore"):
        t = v / d[..., None]
        x = np.where(d > 0.05, t @ east, np.nan)
        y = np.where(d > 0.05, t @ north, np.nan)
    return np.rad2deg(x), np.rad2deg(y)


def _draw_graticule(ax, rot, half):
    """Overlay meridians/parallels on a gnomonic axes (the reference calls
    ``hp.graticule(verbose=False)`` per subplot, plot.py:65-66)."""
    c, east, north = _lonlat_basis(*rot)
    # nice spacing: ~3 lines across the field of view
    span = 2.0 * half
    spacing = 30.0
    for s in (30.0, 10.0, 5.0, 2.0, 1.0, 0.5, 0.25):
        if s <= span / 3.0:
            spacing = s
            break
    lon0, lat0 = rot
    s = np.linspace(-1.5 * half, 1.5 * half, 181)
    lats = spacing * np.arange(
        np.floor((lat0 - 1.5 * half) / spacing),
        np.ceil((lat0 + 1.5 * half) / spacing) + 1,
    )
    lons = spacing * np.arange(
        np.floor((lon0 - 3 * half) / spacing),
        np.ceil((lon0 + 3 * half) / spacing) + 1,
    )
    for lat in lats[np.abs(lats) <= 90]:
        lon = np.deg2rad(lon0 + s / np.maximum(np.cos(np.deg2rad(lat)), 1e-6))
        la = np.full_like(lon, np.deg2rad(lat))
        v = np.stack([np.cos(la) * np.cos(lon), np.cos(la) * np.sin(lon),
                      np.sin(la)], axis=-1)
        x, y = _gnomonic_forward(v, c, east, north)
        ax.plot(x, y, color="k", lw=0.4, alpha=0.6)
    for lon in lons:
        la = np.deg2rad(np.clip(lat0 + s, -90, 90))
        lo = np.full_like(la, np.deg2rad(lon))
        v = np.stack([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo),
                      np.sin(la)], axis=-1)
        x, y = _gnomonic_forward(v, c, east, north)
        ax.plot(x, y, color="k", lw=0.4, alpha=0.6)
    ax.set_xlim(-half, half)
    ax.set_ylim(-half, half)


def gnomview(
    m,
    rot=(0.0, 0.0),
    reso=1.5,
    xsize=200,
    nest=True,
    title=None,
    fig=None,
    sub=None,
    min=None,
    max=None,
    cbar=True,
    cmap="viridis",
    notext=False,
    margins=None,
    graticule=False,
):
    """Render a gnomonic view of a HEALPix map — drop-in for the
    ``hp.gnomview`` usage in the reference plot layer."""
    import matplotlib.pyplot as plt

    m = np.asarray(m).reshape(-1)
    nside = hp.npix2nside(m.shape[0])
    grid = gnomonic_pixels(nside, rot=rot, reso=reso, xsize=xsize, nest=nest)
    img = m[grid]

    if fig is None:
        fig = plt.gcf()
    ax = fig.add_subplot(*sub) if sub is not None else fig.add_subplot(111)
    half = reso / 60.0 * xsize / 2.0
    im = ax.imshow(
        img, origin="upper", cmap=cmap, vmin=min, vmax=max,
        extent=(-half, half, -half, half),
    )
    ax.set_axis_off()
    if graticule:
        _draw_graticule(ax, rot, half)
    if title and not notext:
        ax.set_title(title)
    if cbar:
        fig.colorbar(im, ax=ax, shrink=0.7)
    return ax


def mollview(
    m,
    nest=True,
    title=None,
    xsize=800,
    min=None,
    max=None,
    cbar=True,
    cmap="viridis",
    fig=None,
    sub=None,
):
    """Render a Mollweide view of a full-sky HEALPix map (``hp.mollview``
    analogue).  Partial maps can be passed as full-length arrays with NaN
    outside the observed region."""
    import matplotlib.pyplot as plt

    m = np.asarray(m, dtype=np.float64).reshape(-1)
    nside = hp.npix2nside(m.shape[0])
    grid, ok = mollweide_pixels(nside, xsize=xsize, nest=nest)
    img = np.full(grid.shape, np.nan)
    img[ok] = m[grid[ok]]

    if fig is None:
        fig = plt.gcf()
    ax = fig.add_subplot(*sub) if sub is not None else fig.add_subplot(111)
    im = ax.imshow(img, origin="upper", cmap=cmap, vmin=min, vmax=max)
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    if cbar:
        fig.colorbar(im, ax=ax, orientation="horizontal", shrink=0.6, pad=0.03)
    return ax
