"""Filter extraction and visualization for graph polynomial convolutions.

Replaces the reference's pygsp-based filter tooling: ``filters.Chebyshev`` +
``.localize`` (consumed at ``deepsphere-cosmo-tf2 src/deepsphere/
healpy_networks.py:276-289``) and the plot functions of ``plot.py``.

A :class:`SphericalFilterBank` holds the trained coefficients of one conv
layer (shape (K, Fout, Fin), the layout produced by ``_get_filter_coeffs``,
``healpy_networks.py:190-212``) together with the layer's own
:class:`~deepsphere_tpu_torch.graph.SphereGraph`; localization is computed
by running the actual conv basis (stencil or ELLPACK path) on delta
impulses, with the layer's true spectrum rescale — unlike the reference,
which re-builds a pygsp graph with a default rescale for plotting.  The
basis runs with torch on the bank's ``device`` (the card unless the caller
asks for the CPU); the results come back as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.laplacian import SphereGraph
from ..sphere import healpix as hp

__all__ = [
    "SphericalFilterBank",
    "get_index_equator",
    "plot_filters_gnomonic",
    "plot_filters_section",
]

_KIND_SCALE = {"cheby": 0.75, "mono": 1.0, "bern": 0.75}


class SphericalFilterBank:
    """A bank of Fin x Fout polynomial graph filters.

    :param graph: the conv layer's graph
    :param coeffs: (K, Fout, Fin) polynomial coefficients
    :param kind: "cheby" (default), "mono" or "bern"
    :param scale: spectrum rescale; defaults to the layer convention
    :param device: where the basis of :meth:`localize` runs (default
        ``"cuda"``; pass ``"cpu"`` for the CPU); raises when the card is
        asked for and there is none
    """

    def __init__(self, graph: SphereGraph, coeffs, kind="cheby", scale=None,
                 device=None):
        self.graph = graph
        self.coeffs = np.asarray(coeffs)
        if self.coeffs.ndim != 3:
            raise ValueError("coeffs must have shape (K, Fout, Fin)")
        self.kind = kind
        self.scale = _KIND_SCALE[kind] if scale is None else float(scale)
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SphericalFilterBank: no CUDA card; pass device='cpu' to "
                "run on the CPU")

    @property
    def n_features_in(self):
        return self.coeffs.shape[2]

    @property
    def n_features_out(self):
        return self.coeffs.shape[1]

    @property
    def n_filters(self):
        return self.n_features_in * self.n_features_out

    @property
    def K(self):
        return self.coeffs.shape[0]

    def _basis_stack(self, x2d):
        """(n_terms, M, C) polynomial basis of the layer's Laplacian."""
        from ..ops import spmv
        from ..ops.stencil import stencil_basis_stack

        n_terms = self.K
        st = self.graph.face_stencil(self.scale)
        x2d = torch.as_tensor(x2d, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            if st is not None:
                out = stencil_basis_stack(st, self.kind, x2d, n_terms)
            else:
                idx, val = self.graph.ellpack(self.scale)
                basis = {
                    "cheby": spmv.chebyshev_basis,
                    "mono": spmv.monomial_basis,
                    "bern": spmv.bernstein_basis,
                }[self.kind]
                out = basis(torch.as_tensor(idx, device=self.device).long(),
                            torch.as_tensor(val, device=self.device), x2d,
                            n_terms)
        return out.cpu().numpy()

    def localize(self, ind, order=None):
        """Impulse responses of all filters at pixel(s) ``ind``.

        :param ind: pixel id or list of pixel ids
        :param order: unused (kept for pygsp API parity; locality is K)
        :return: (Fin, Fout, M) for scalar ``ind``; (len(ind), Fin, Fout, M)
            for a list
        """
        scalar = np.ndim(ind) == 0
        ind = np.atleast_1d(np.asarray(ind, dtype=np.int64))
        M = self.graph.n_pixels
        deltas = np.zeros((M, len(ind)), dtype=np.float32)
        deltas[ind, np.arange(len(ind))] = 1.0
        tx = self._basis_stack(deltas)  # (K, M, n_ind)
        # maps[i, fin, fout, :] = sum_k coeffs[k, fout, fin] * T_k(L) delta_i
        maps = np.einsum("kmi,kof->ifom", tx, self.coeffs)
        return maps[0] if scalar else maps

    def evaluate(self, x):
        """Spectral response of each filter at (rescaled-domain) points
        ``x`` in [-scale, scale]: (Fout, Fin, len(x))."""
        x = np.asarray(x, dtype=np.float64)
        n_terms = self.K
        if self.kind == "cheby":
            terms = [np.ones_like(x)]
            if n_terms > 1:
                terms.append(x)
            for _ in range(2, n_terms):
                terms.append(2 * x * terms[-1] - terms[-2])
        elif self.kind == "mono":
            terms = [x**k for k in range(n_terms)]
        else:  # bern over n_terms = K+1 points of (2I - L)^... basis
            from scipy.special import comb

            Kb = n_terms - 1
            terms = [
                float(comb(Kb, i)) / 2.0**Kb * (2 - x) ** (Kb - i) * x**i
                for i in range(n_terms)
            ]
        tx = np.stack(terms, axis=0)  # (K, n_x)
        return np.einsum("kof,kx->ofx", self.coeffs, tx)


def get_index_equator(nside, radius):
    """NEST ids of ``2*radius + 1`` pixels around the equator plus the center
    id — parity with ``plot.py:126-140`` (ring-ordered equator walk)."""
    npix = hp.nside2npix(nside)
    ring_ids = np.arange(npix // 2 - radius, npix // 2 + radius + 1, dtype=np.int64)
    index_equator = hp.ring2nest(nside, ring_ids)
    center = hp.ring2nest(nside, np.int64(npix // 2))
    return index_equator, int(center)


def _localized_grid(filters: SphericalFilterBank, ind, order):
    """(Fin, Fout, M) localized maps, shaped like the reference expects."""
    maps = filters.localize(ind, order=order)
    if maps.ndim == 2:  # single in/out feature edge cases
        maps = maps.reshape(filters.n_features_in, filters.n_features_out, -1)
    return maps


def plot_filters_gnomonic(filters, order=10, ind=0, title="Filter {}->{}", graticule=False):
    """Gnomonic-projection grid of all localized filters in a bank —
    behavioral parity with ``plot.py:8-68``."""
    import matplotlib.pyplot as plt

    from .projections import gnomview

    graph = filters.graph
    nside = graph.nside
    reso = hp.nside2resol(nside, arcmin=True) * order / 100
    theta, phi = hp.pix2ang(nside, np.int64(ind), nest=True)
    rot = (np.rad2deg(phi), 90.0 - np.rad2deg(theta))

    maps = _localized_grid(filters, ind, order)
    nrows, ncols = filters.n_features_in, filters.n_features_out

    fig, axes = plt.subplots(
        nrows, ncols, figsize=(8, 8 / ncols * nrows), squeeze=False
    )
    for axi in axes.ravel():
        axi.set_axis_off()

    a = max(abs(maps.min()), maps.max())
    for row in range(nrows):
        for col in range(ncols):
            gnomview(
                maps[row, col],
                fig=fig,
                nest=True,
                rot=rot,
                reso=reso,
                sub=(nrows, ncols, col + row * ncols + 1),
                title=(title.format(row, col) if title else None),
                notext=title is None,
                min=-a,
                max=a,
                cbar=False,
                cmap="seismic",
                graticule=graticule,
            )
    fig.suptitle(
        f"Gnomonic view of the {filters.n_filters} filters in the filterbank",
        fontsize=25,
    )
    return fig


def plot_filters_section(
    filters,
    order=10,
    xlabel="out map {}",
    ylabel="in map {}",
    title="Sections of the {} filters in the filterbank",
    figsize=None,
    **kwargs,
):
    """Equator cross-sections of all localized filters — behavioral parity
    with ``plot.py:71-123``."""
    import matplotlib.pyplot as plt

    nside = filters.graph.nside
    index_equator, ind = get_index_equator(nside, order)
    nrows, ncols = filters.n_features_in, filters.n_features_out

    maps = _localized_grid(filters, ind, order)

    angle = hp.pix2ang(nside, index_equator, nest=True)[1]
    angle -= abs(angle[-1] + angle[0]) / 2
    angle = angle / (2 * np.pi) * 360

    if figsize is None:
        figsize = (12, 12 / ncols * nrows)
    fig, axes = plt.subplots(nrows, ncols, figsize=figsize, squeeze=False,
                             sharex="col", sharey="row")
    ymin, ymax = 1.05 * maps.min(), 1.05 * maps.max()
    for row in range(nrows):
        for col in range(ncols):
            axes[row, col].plot(angle, maps[row, col, index_equator], **kwargs)
            axes[row, col].set_ylim(ymin, ymax)
            if row == nrows - 1:
                axes[row, col].set_xlabel(xlabel.format(col))
            if col == 0:
                axes[row, col].set_ylabel(ylabel.format(row))
    fig.suptitle(title.format(filters.n_filters))
    return fig
