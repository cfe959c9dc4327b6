"""Sphere graph construction: kNN graph -> normalized Laplacian -> ELLPACK.

TPU-native replacement for the reference's external graph backend, the pygsp
fork's ``SphereHealpix(subdivisions, indexes, nest, k, lap_type)`` consumed at
``deepsphere-cosmo-tf2 src/deepsphere/healpy_networks.py:110-118``.  All of this is
host-side precompute (numpy/scipy/sklearn); the result is a set of static,
TPU-friendly padded arrays:

* ``ell_idx`` (M, W) int32 and ``ell_val`` (M, W) float32 — the rescaled
  Laplacian in padded ELLPACK layout.  The kNN graph has bounded degree
  (k in {8, 20, 40, 60} per ``healpy_networks.py:39-42``), so W = max row
  nnz is small and the SpMV becomes a fixed-width gather + weighted sum.
* ``edge_idx`` (nnz, 2) int64 — row-major sorted adjacency edge list for the
  edge-sparse graph transformer (parity with the csc ``nonzero`` edge list at
  ``gnn_transformers.py:397-399``).

Notes on parity: the exact edge weights of the pinned pygsp fork
(``setup.cfg:20``) are not observable in this environment.  We follow the
DeepSphere construction: k nearest neighbors by chord distance of the pixel
center unit vectors, Gaussian weights ``exp(-d^2 / (2 sigma^2))``,
symmetrized, and the symmetric-normalized Laplacian
``I - D^-1/2 W D^-1/2``.  ``sigma`` defaults to the HARMONIC width table
(``HARMONIC_WIDTH_RATIO``): per-(nside, k) widths re-derived with the
construction the pygsp fork's tables came from (arXiv:2012.15000 §3 —
pick the width whose Laplacian spectrum best aligns with the spherical
harmonic multiplets; see ``tools/derive_widths.py`` for the derivation and
its error numbers).  ``kernel_width`` is exposed so users can reproduce any
specific width table, and ``kernel_width="mean"`` restores the legacy
mean-neighbor-distance default.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field

import numpy as np
from scipy import sparse

from ..sphere import healpix as hp
from .._logger import logger

__all__ = [
    "SphereGraph",
    "build_sphere_graph",
    "graph_from_laplacian",
    "rescale_laplacian",
    "lmax_bound",
    "HARMONIC_WIDTH_RATIO",
    "harmonic_width_ratio",
]

#: Gaussian kernel width as a multiple of the mean neighbor distance,
#: derived by ``tools/derive_widths.py``: golden-section search minimizing
#: the within-multiplet dispersion of the Laplacian spectrum vs the
#: spherical-harmonic plateaus (the equivariance-optimality construction of
#: arXiv:2012.15000 §3, the same objective behind the pygsp fork's tuned
#: width tables pinned by the reference at ``setup.cfg:20``).  The ratio is
#: scale-free and converges as nside grows (pixel spacing ~ 1/nside), so
#: nsides above the table reuse the largest tabulated entry.
#:
#: nside <= 16 entries use the dense-eigh objective (lmax_fit = 3*nside/2);
#: nside = 32 entries use shift-invert Lanczos over the lowest multiplets
#: (lmax_fit = 16 — the regime smoothing/conv kernels actually live in).
#: Residual within-multiplet dispersion at the nside=32 optimum:
#: k=20 4.2e-3, k=40 9.1e-4, k=60 5.4e-4 (vs 3.8e-2 / 2.8e-2 / 1.6e-2 at
#: ratio 1.0), so production nsides extrapolate from a measured optimum
#: rather than the nside=16 assumption flagged in round 3.
HARMONIC_WIDTH_RATIO = {
    8: {4: 0.5879, 8: 0.5166, 16: 0.5054, 32: 0.5029},
    20: {8: 0.4368, 16: 0.4036, 32: 0.3845},
    40: {8: 0.4632, 16: 0.4005, 32: 0.3269},
    60: {8: 0.5004, 16: 0.4005, 32: 0.3152},
}


def harmonic_width_ratio(k, nside):
    """Width/mean-distance ratio from :data:`HARMONIC_WIDTH_RATIO`, or
    ``None`` when no table exists for this ``k``.  Uses the largest
    tabulated nside at or below ``nside`` (the ratio converges from above as
    nside grows), else the smallest tabulated entry."""
    tab = HARMONIC_WIDTH_RATIO.get(k)
    if not tab:
        return None
    below = [s for s in tab if s <= nside]
    return tab[max(below)] if below else tab[min(tab)]


def _grid_adjacency(nside, indices, kernel_width=None, width_ratio=None):
    """Gaussian-weighted adjacency from the NEST grid 8-neighbor structure
    (vectorized; O(M) — no tree queries).  This is the construction of the
    original DeepSphere (healpy ``get_all_neighbours``); it differs from the
    kNN graph only along face boundaries.

    Partial skies are supported: edges to out-of-mask pixels are dropped
    (mask-boundary rows keep < 8 neighbors), which keeps the graph
    grid-structured INSIDE the mask — the property the stencil / fused
    Pallas conv path needs (the kNN construction instead rewires boundary
    pixels to 2nd-ring neighbors, breaking the stencil form)."""
    n = len(indices)
    npix = hp.nside2npix(nside)
    coords = hp.pix2vec(nside, indices, nest=True)
    nb = hp.neighbors_nest(nside, indices)  # (M, 8) GLOBAL ids, -1 padded
    if n != npix:
        glob2loc = np.full(npix, -1, dtype=np.int64)
        glob2loc[np.asarray(indices, dtype=np.int64)] = np.arange(n)
        nb = np.where(nb >= 0, glob2loc[np.clip(nb, 0, npix - 1)], -1)
    # nb is now in LOCAL ids; -1 where the neighbor is absent/out of mask.
    # per-direction distance computation keeps temporaries at O(M), not O(8M)
    d2 = np.zeros((n, 8), dtype=np.float64)
    for j in range(8):
        cj = np.clip(nb[:, j], 0, n - 1)
        diff = coords - coords[cj]
        d2[:, j] = np.einsum("ij,ij->i", diff, diff)
    valid = nb >= 0
    if kernel_width is None:
        kernel_width = float(np.mean(np.sqrt(d2[valid]))) * (width_ratio or 1.0)
    w = np.where(valid, np.exp(-d2 / (2.0 * kernel_width**2)), 0.0)

    rows = np.repeat(np.arange(n, dtype=np.int64), 8)[valid.reshape(-1)]
    cols = nb.reshape(-1)[valid.reshape(-1)]
    W = sparse.csr_matrix((w[valid], (rows, cols)), shape=(n, n))
    # the grid-neighbor relation and the chord weights are symmetric already;
    # no symmetrization pass needed
    return W, kernel_width


#: template radius per supported neighbor count for the ring ("grid")
#: construction: k nearest pixels are selected WITHIN the Chebyshev-radius-r
#: face-coordinate ring template, so the operator stays a (2r+1)^2 stencil
#: — the structured form the fused TPU conv path requires.  The template
#: sizes (24, 48, 80) bound the reference's k in {20, 40, 60}
#: (healpy_networks.py:39-42).
GRID_RADIUS = {8: 1, 20: 2, 40: 3, 60: 4}

#: capture radius for EXACT kNN graphs (``method="knn"``, the reference's
#: pygsp-SphereHealpix semantics): the k nearest neighbors are spatially
#: local, so almost every row's edges fit a Chebyshev window one ring wider
#: than the matching grid template; the O(1) rows that don't (polar-corner
#: anisotropy) are handled by the stencil extraction's corrupt-row exact
#: recompute.  This is what lets ``method="knn"`` ride the fused Pallas
#: conv path instead of the serialized-gather ELLPACK path.
KNN_CAPTURE_RADIUS = {8: 2, 20: 3, 40: 4, 60: 5}


def _grid_ring_adjacency(nside, indices, k, kernel_width=None,
                         width_ratio=None):
    """Gaussian-weighted adjacency with neighbors = the k nearest pixels
    inside the radius-r face-grid ring template (r = GRID_RADIUS[k]).

    TPU-native analogue of the reference's k in {20, 40, 60} kNN graphs:
    per row, the k nearest template pixels are kept (ties at the template
    corners are the farthest and drop out naturally) and the edge set is
    symmetrized by INTERSECTION, so every edge is representable in both
    endpoints' stencils.  Unselected / cross-template edges differ from
    the true kNN graph the same way the r=1 grid differs from kNN at k=8
    — use method="knn" for strict reference-graph semantics (slow conv
    path).  Supports partial skies (out-of-mask edges dropped).
    """
    from ..sphere.faces import face2nest_index, halo_map

    r = GRID_RADIUS[k]
    n_loc = len(indices)
    npix = hp.nside2npix(nside)
    hm = halo_map(nside, r)  # (12, n+2r, n+2r) global ids, -1 pad
    offsets = [(dx, dy)
               for dx in range(-r, r + 1) for dy in range(-r, r + 1)
               if (dx, dy) != (0, 0)]
    T = len(offsets)

    # neighbor table in face-flat order -> NEST order
    nb_face = np.empty((12 * nside * nside, T), dtype=np.int64)
    for t, (dx, dy) in enumerate(offsets):
        nb_face[:, t] = hm[:, r + dx : r + dx + nside,
                           r + dy : r + dy + nside].reshape(-1)
    f2n = face2nest_index(nside)
    nb = nb_face[f2n]  # (npix, T) global neighbor ids per NEST pixel

    glob = np.asarray(indices, dtype=np.int64)
    nb = nb[glob]
    if n_loc != npix:
        glob2loc = np.full(npix, -1, dtype=np.int64)
        glob2loc[glob] = np.arange(n_loc)
        nb = np.where(nb >= 0, glob2loc[np.clip(nb, 0, npix - 1)], -1)

    coords = hp.pix2vec(nside, glob, nest=True)
    d2 = np.full((n_loc, T), np.inf)
    for t in range(T):
        cj = np.clip(nb[:, t], 0, n_loc - 1)
        diff = coords - coords[cj]
        d = np.einsum("ij,ij->i", diff, diff)
        d2[:, t] = np.where(nb[:, t] >= 0, d, np.inf)

    # per-row k nearest within the template
    k_eff = min(k, T)
    part = np.argpartition(d2, k_eff - 1, axis=1)[:, :k_eff]
    sel = np.zeros((n_loc, T), dtype=bool)
    np.put_along_axis(sel, part, True, axis=1)
    sel &= np.isfinite(d2)

    rows = np.repeat(np.arange(n_loc, dtype=np.int64), T).reshape(n_loc, T)
    rr, cc, dd = rows[sel], nb[sel], np.sqrt(d2[sel])
    S = sparse.csr_matrix((dd + 1e-300, (rr, cc)), shape=(n_loc, n_loc))
    # symmetrize by intersection: min keeps only edges selected by BOTH
    # endpoints (distances are symmetric, so values agree)
    S = S.minimum(S.T)
    S.eliminate_zeros()
    dist = S.data
    if kernel_width is None:
        kernel_width = (float(dist.mean()) if dist.size else 1.0) \
            * (width_ratio or 1.0)
    W = S.copy()
    W.data = np.exp(-(dist**2) / (2.0 * kernel_width**2))
    return W, kernel_width


def _knn_adjacency(coords, k, kernel_width=None, width_ratio=None):
    """Gaussian-weighted symmetric kNN adjacency from 3D unit vectors."""
    from sklearn.neighbors import NearestNeighbors

    n = coords.shape[0]
    k_eff = min(k, n - 1)
    if k_eff < k:
        logger.info(
            f"WARNING: graph has only {n} vertices; kNN degree reduced "
            f"from k={k} to {k_eff} (check nside/indices if unexpected)"
        )
    nn = NearestNeighbors(n_neighbors=k_eff + 1).fit(coords)
    dist, idx = nn.kneighbors(coords)
    dist = dist[:, 1:]  # drop self
    idx = idx[:, 1:]

    if kernel_width is None:
        kernel_width = float(np.mean(dist)) * (width_ratio or 1.0)
    w = np.exp(-(dist**2) / (2.0 * kernel_width**2))

    rows = np.repeat(np.arange(n, dtype=np.int64), k_eff)
    cols = idx.reshape(-1).astype(np.int64)
    W = sparse.csr_matrix((w.reshape(-1), (rows, cols)), shape=(n, n))
    # symmetrize by averaging (one-directional kNN edges get half weight)
    W = (W + W.T) / 2.0
    W.setdiag(0.0)
    W.eliminate_zeros()
    return W, kernel_width


def _normalized_laplacian(W):
    d = np.asarray(W.sum(axis=1)).ravel()
    with np.errstate(divide="ignore"):
        dinv = 1.0 / np.sqrt(d)
    dinv[~np.isfinite(dinv)] = 0.0
    Dinv = sparse.diags(dinv)
    n = W.shape[0]
    return (sparse.identity(n, format="csr") - Dinv @ W @ Dinv).tocsr()


def _combinatorial_laplacian(W):
    d = np.asarray(W.sum(axis=1)).ravel()
    return (sparse.diags(d) - W).tocsr()


def lmax_bound(L):
    """1.02 * largest eigenvalue, matching the reference's safety margin
    (``gnn_layers.py:66``).  Uses ARPACK with a power-iteration fallback."""
    try:
        from scipy.sparse.linalg import eigsh

        # tol must be tight: a relative error eps in lmax perturbs every
        # entry of the rescaled Laplacian by O(eps), which breaks the
        # <1e-5 per-layer parity vs the reference (which runs ARPACK at
        # machine precision, gnn_layers.py:66).  The start vector must be
        # deterministic: ARPACK's random v0 would make lmax — and
        # therefore every conv output — differ between two graph builds
        # of the same sphere.
        v0 = np.full(L.shape[0], 1.0 / np.sqrt(L.shape[0]))
        lmax = float(
            eigsh(L, k=1, which="LM", return_eigenvectors=False, tol=1e-9, v0=v0)[0]
        )
    except Exception:  # pragma: no cover - tiny graphs / ARPACK breakdown
        x = np.random.RandomState(0).normal(size=L.shape[0])
        x /= np.linalg.norm(x)
        lmax = 0.0
        for _ in range(200):
            x = L @ x
            nrm = np.linalg.norm(x)
            if nrm == 0:
                break
            lmax, x = nrm, x / nrm
    return 1.02 * lmax


def rescale_laplacian(L, lmax, scale=1.0):
    """Map the spectrum into [-scale, scale]: L <- (2 scale / lmax) L - I.
    Parity with ``utils.rescale_L`` (``deepsphere-cosmo-tf2 src/deepsphere/utils.py:40-46``)."""
    n = L.shape[0]
    return (L * (2.0 * scale / lmax) - sparse.identity(n, format="csr", dtype=L.dtype)).tocsr()


def _ellpack_from_neighbors(nb, w):
    """(npix, 8) neighbor table + Gaussian weights -> direction-aligned
    unscaled normalized-Laplacian ELLPACK (slot 8 = unit diagonal) —
    vectorized reconstruction of the native builder's layout."""
    M = nb.shape[0]
    deg = w.sum(axis=1)
    with np.errstate(divide="ignore"):
        dinv = 1.0 / np.sqrt(deg)
    dinv[~np.isfinite(dinv)] = 0.0
    own = np.arange(M, dtype=np.int64)[:, None]
    valid = nb >= 0
    cols = np.where(valid, nb, own)
    vals = np.where(valid, -w * dinv[:, None] * dinv[np.clip(nb, 0, M - 1)], 0.0)
    ell_idx = np.concatenate([cols, own], axis=1).astype(np.int32)
    ell_val = np.concatenate([vals, np.ones((M, 1))], axis=1)
    return ell_idx, ell_val


def _to_ellpack(L, dtype=np.float32):
    """CSR -> padded ELLPACK (idx, val). Padded entries point at the own row
    with value 0, so the gather stays in-bounds and contributes nothing."""
    L = sparse.csr_matrix(L)
    M = L.shape[0]
    nnz_per_row = np.diff(L.indptr)
    width = int(nnz_per_row.max()) if M else 0
    idx = np.tile(np.arange(M, dtype=np.int32)[:, None], (1, width))
    val = np.zeros((M, width), dtype=dtype)
    for off in range(width):
        has = nnz_per_row > off
        pos = L.indptr[:-1][has] + off
        idx[has, off] = L.indices[pos]
        val[has, off] = L.data[pos]
    return idx, val


@dataclass(eq=False)
class SphereGraph:
    """Static graph structure for one (nside, indices, k) resolution level.

    Hashable by content key so it can be carried as a static attribute of
    Flax modules without retracing issues.
    """

    nside: int
    indices: np.ndarray  # pixel ids (NEST) covered by this graph
    k: int
    lap_type: str
    kernel_width: float
    L: sparse.csr_matrix = field(repr=False)  # un-rescaled Laplacian
    A: sparse.csr_matrix = field(repr=False)  # adjacency
    lmax: float = 0.0
    method: str = "custom"  # construction: "grid" | "knn" | "custom"

    def __post_init__(self):
        self._ellpack_cache = {}
        self._ell_L = None  # native direction-aligned unscaled-L ELLPACK
        self._nb_w = None  # native (neighbors, weights) for lazy A
        ind = np.ascontiguousarray(np.asarray(self.indices, dtype=np.int64))
        h = hashlib.sha1(ind.tobytes()).hexdigest()[:16]
        self._key = (self.nside, h, self.k, self.lap_type,
                     round(self.kernel_width, 12), self.method)

    # identity by content key -> stable hashing inside jit-static contexts
    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, SphereGraph) and self._key == other._key

    @property
    def n_pixels(self):
        return len(self.indices)

    def _materialize(self):
        """Build the csr matrices lazily from the native direction-aligned
        ELLPACK (the native grid builder skips csr construction — most
        consumers never need it)."""
        if self.L is None:
            idx, val = self._ell_L
            M = self.n_pixels
            rows = np.repeat(np.arange(M, dtype=np.int64), idx.shape[1])
            mask = val.reshape(-1) != 0.0
            self.L = sparse.csr_matrix(
                (val.reshape(-1)[mask], (rows[mask], idx.reshape(-1)[mask])),
                shape=(M, M),
            )
        if self.A is None:
            nb, w = self._nb_w
            M = self.n_pixels
            rows = np.repeat(np.arange(M, dtype=np.int64), nb.shape[1])
            cols = nb.reshape(-1)
            mask = cols >= 0
            self.A = sparse.csr_matrix(
                (w.reshape(-1)[mask], (rows[mask], cols[mask])), shape=(M, M)
            )

    def rescaled(self, scale):
        """Rescaled Laplacian (spectrum in [-scale, scale]) as csr."""
        self._materialize()
        return rescale_laplacian(self.L, self.lmax, scale=scale)

    def ellpack(self, scale):
        """Padded ELLPACK (idx int32 (M,W), val float32 (M,W)) of the
        rescaled Laplacian; cached per scale."""
        key = round(float(scale), 12)
        if key not in self._ellpack_cache:
            if getattr(self, "_ell_L", None) is not None:
                # direction-aligned unscaled-L ELLPACK from the native
                # builder: rescale in place (diag lives in slot 8)
                idx, val = self._ell_L
                val_s = (2.0 * scale / self.lmax) * val
                val_s[:, 8] -= 1.0
                self._ellpack_cache[key] = (idx, val_s.astype(np.float32))
            else:
                self._ellpack_cache[key] = _to_ellpack(self.rescaled(scale))
        return self._ellpack_cache[key]

    @property
    def stencil_radius(self):
        """Candidate stencil capture radius for this graph's k, or None if
        no template applies.  Grid/ring graphs use the exact template
        radius (:data:`GRID_RADIUS`); exact-kNN graphs use the one-ring-
        wider capture window (:data:`KNN_CAPTURE_RADIUS`) with corrupt-row
        recompute for the rare out-of-window edges.  Extraction verifies
        the edges actually fit and falls back to ELLPACK otherwise."""
        if self.method == "knn":
            return KNN_CAPTURE_RADIUS.get(int(self.k))
        return GRID_RADIUS.get(int(self.k))

    def deep_stencil(self, scale, n_terms):
        """The stencil sized for a FUSED (n_terms - 1)-application conv:
        halo depth == radius * (n_terms - 1).  None when unavailable.

        The depth is exact: a deeper halo only widens the set of corner
        rows the fused conv must recompute from the correction ball (at
        nside 64, K=10: 4,968 rows at h=9 against 16,896 at h=16).
        """
        r = self.stencil_radius
        if r is None:
            return None
        return self.face_stencil(scale, n_steps=r * max(int(n_terms) - 1, 1))

    def face_stencil(self, scale, n_steps=None):
        """Stencil form of the rescaled Laplacian on the 12-face layout
        (see :mod:`.stencil`), or ``None`` if this graph is not
        grid-structured (partial sky / kNN edges beyond the template).
        ``n_steps`` is the halo depth (default: one application = the
        template radius).  Memoized per (scale, n_steps) and disk-cached
        next to the graph cache when one is configured."""
        if n_steps is None:
            n_steps = self.stencil_radius
            if n_steps is None:
                return None
        key = ("stencil", round(float(scale), 12), int(n_steps))
        if key not in self._ellpack_cache:
            from .stencil import face_stencil, load_stencil_cache, save_stencil_cache

            cache_dir = getattr(self, "_cache_dir", None)
            st = load_stencil_cache(self, scale, n_steps, cache_dir)
            if st is None:
                try:
                    st = face_stencil(self, scale, n_steps)
                    save_stencil_cache(st, self, cache_dir)
                except ValueError:
                    st = None
            self._ellpack_cache[key] = st
        return self._ellpack_cache[key]

    @property
    def edge_idx(self):
        """Row-major sorted (nnz, 2) adjacency edge list (row, col), the
        analogue of ``sparse_A_indices`` at ``gnn_transformers.py:397-399``."""
        self._materialize()
        coo = self.A.tocoo()
        order = np.lexsort((coo.col, coo.row))
        return np.stack([coo.row[order], coo.col[order]], axis=1).astype(np.int64)


def graph_from_laplacian(L, A=None, lmax=None, nside=0, indices=None, k=0):
    """Wrap an explicit (sparse or dense) Laplacian into a
    :class:`SphereGraph` — the analogue of constructing the reference conv
    layers from a raw ``L`` array (``gnn_layers.py:31,64-66``); used for
    tests and custom graphs."""
    L = sparse.csr_matrix(np.asarray(L) if not sparse.issparse(L) else L)
    if lmax is None:
        lmax = lmax_bound(L)
    if A is None:
        A = sparse.csr_matrix(L.shape)
    if indices is None:
        indices = np.arange(L.shape[0], dtype=np.int64)
    return SphereGraph(
        nside=nside, indices=np.asarray(indices, dtype=np.int64), k=k,
        lap_type="custom", kernel_width=0.0, L=L, A=sparse.csr_matrix(A), lmax=lmax,
    )


def build_sphere_graph(
    nside,
    indices=None,
    k=8,
    lap_type="normalized",
    kernel_width=None,
    cache_dir=None,
    method="knn",
):
    """Build the sphere graph for a (sub)set of HEALPix NEST pixels.

    Mirrors the role of ``SphereHealpix(subdivisions, indexes, nest=True, k,
    lap_type)`` in the reference assembler (``healpy_networks.py:110-118``).

    :param nside: HEALPix nside of the level.
    :param indices: 1d array of NEST pixel ids; defaults to the full sphere.
    :param k: number of neighbors (8, 20, 40 or 60 supported upstream).
    :param lap_type: "normalized" (default, parity) or "combinatorial".
    :param kernel_width: Gaussian kernel width (chord distance).  Default
        (``None``): the harmonic width table when one exists for this ``k``
        (:data:`HARMONIC_WIDTH_RATIO` — the re-derivation of the pygsp
        fork's tuned widths; ratio x mean neighbor distance), else the mean
        neighbor distance.  Pass ``"mean"`` to force the mean-distance
        width, or a float for an explicit width.
    :param cache_dir: optional directory to cache the built graph (npz),
        keyed by (nside, indices, k, lap_type, kernel_width) like the disk
        cache of the reference smoothing layer (``healpy_layers.py:652-662``).
    :param method: "knn" (pygsp-SphereHealpix semantics, default) or "grid"
        (NEST 8-neighbor structure, vectorized O(M) build — the original
        DeepSphere-TF1 construction; requires k=8.  Supports partial skies
        by dropping out-of-mask edges, which keeps the graph
        stencil-representable — the fast conv path on TPU).
    """
    if indices is None:
        indices = np.arange(hp.nside2npix(nside), dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)

    width_ratio = None
    if kernel_width is None:
        width_ratio = harmonic_width_ratio(k, nside)
    elif isinstance(kernel_width, str):
        if kernel_width != "mean":
            raise ValueError(f"Unknown kernel_width mode: {kernel_width!r}")
        kernel_width = None

    cache_path = None
    if cache_dir is not None:
        ih = hashlib.sha1(np.ascontiguousarray(indices).tobytes()).hexdigest()[:16]
        kw = (f"harm{width_ratio:.4g}" if width_ratio is not None
              else "auto" if kernel_width is None
              else f"{kernel_width:.8g}")
        cache_path = os.path.join(
            cache_dir,
            # v2: lmax now converged to machine precision (parity target)
            f"sphere_graph-v2-nside{nside}-{ih}-k{k}-{lap_type}-{kw}-{method}.npz",
        )
        if os.path.exists(cache_path):
            z = np.load(cache_path)
            if "nb" in z:  # native-builder cache: csr stays lazy
                g = SphereGraph(
                    nside=nside, indices=indices, k=k, lap_type=lap_type,
                    kernel_width=float(z["kernel_width"]),
                    L=None, A=None, lmax=float(z["lmax"]),
                    method=method,
                )
                nb = z["nb"].astype(np.int64)
                w = z["w"].astype(np.float64)
                g._ell_L = _ellpack_from_neighbors(nb, w)
                g._nb_w = (nb, w)
            else:
                W = sparse.csr_matrix(
                    (z["w_data"], z["w_indices"], z["w_indptr"]),
                    shape=tuple(z["shape"]),
                )
                L = sparse.csr_matrix(
                    (z["l_data"], z["l_indices"], z["l_indptr"]),
                    shape=tuple(z["shape"]),
                )
                g = SphereGraph(
                    nside=nside, indices=indices, k=k, lap_type=lap_type,
                    kernel_width=float(z["kernel_width"]),
                    L=L, A=W, lmax=float(z["lmax"]),
                    method=method,
                )
            logger.info(f"Loaded cached sphere graph from {cache_path}")
            g._cache_dir = cache_dir
            return g

    if method == "grid":
        if k not in GRID_RADIUS:
            raise ValueError(
                f"method='grid' supports k in {sorted(GRID_RADIUS)}, got {k}"
            )
        full_sphere = len(indices) == hp.nside2npix(nside)
        if k != 8:
            # radius-r ring template construction (stencil-structured
            # analogue of the reference's k in {20,40,60} kNN graphs)
            W, kw_used = _grid_ring_adjacency(nside, indices, k, kernel_width,
                                              width_ratio)
            L = (_normalized_laplacian(W) if lap_type == "normalized"
                 else _combinatorial_laplacian(W))
            graph = SphereGraph(
                nside=nside, indices=indices, k=k, lap_type=lap_type,
                kernel_width=kw_used, L=L, A=W, lmax=lmax_bound(L),
                method=method,
            )
            graph._cache_dir = cache_dir
            if cache_path is not None:
                os.makedirs(cache_dir, exist_ok=True)
                tmp_path = cache_path + f".{os.getpid()}.tmp.npz"
                np.savez(
                    tmp_path,
                    w_data=W.data, w_indices=W.indices, w_indptr=W.indptr,
                    l_data=L.data, l_indices=L.indices, l_indptr=L.indptr,
                    shape=np.array(W.shape),
                    kernel_width=kw_used, lmax=graph.lmax,
                )
                os.replace(tmp_path, cache_path)
                logger.info(f"Cached sphere graph to {cache_path}")
            return graph

        from .. import native

        if full_sphere and lap_type == "normalized" and native.available():
            # one-pass native build: neighbors + weights + normalized-L
            # ELLPACK + Lanczos lmax; csr matrices stay lazy
            res = native.grid_laplacian(
                nside,
                -width_ratio if (kernel_width is None
                                 and width_ratio is not None)
                else kernel_width,
            )
            graph = SphereGraph(
                nside=nside, indices=indices, k=k, lap_type=lap_type,
                kernel_width=res["kernel_width"],
                L=None, A=None, lmax=res["lmax"],
                method=method,
            )
            graph._ell_L = (res["ell_idx"], res["ell_val"])
            graph._nb_w = (res["nb"], res["w"])
            graph._cache_dir = cache_dir
            if cache_path is not None:
                # compact cache: the ELLPACK is reconstructable from (nb, w)
                os.makedirs(cache_dir, exist_ok=True)
                tmp_path = cache_path + f".{os.getpid()}.tmp.npz"
                np.savez(
                    tmp_path,
                    nb=res["nb"].astype(np.int32),
                    w=res["w"].astype(np.float32),
                    kernel_width=res["kernel_width"], lmax=res["lmax"],
                )
                os.replace(tmp_path, cache_path)
                logger.info(f"Cached sphere graph to {cache_path}")
            return graph
        W, kw_used = _grid_adjacency(nside, indices, kernel_width,
                                     width_ratio)
    elif method == "knn":
        coords = hp.pix2vec(nside, indices, nest=True)
        W, kw_used = _knn_adjacency(coords, k, kernel_width, width_ratio)
    else:
        raise ValueError(f"Unknown graph method: {method}")
    if lap_type == "normalized":
        L = _normalized_laplacian(W)
    elif lap_type == "combinatorial":
        L = _combinatorial_laplacian(W)
    else:
        raise ValueError(f"Unknown lap_type: {lap_type}")
    lmax = lmax_bound(L)

    graph = SphereGraph(
        nside=nside,
        indices=indices,
        k=k,
        lap_type=lap_type,
        kernel_width=kw_used,
        L=L,
        A=W,
        lmax=lmax,
        method=method,
    )
    graph._cache_dir = cache_dir

    if cache_path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        # atomic write: a killed process must not leave a torn cache file
        tmp_path = cache_path + f".{os.getpid()}.tmp.npz"
        np.savez(
            tmp_path,
            w_data=W.data,
            w_indices=W.indices,
            w_indptr=W.indptr,
            l_data=L.data,
            l_indices=L.indices,
            l_indptr=L.indptr,
            shape=np.array(W.shape),
            kernel_width=kw_used,
            lmax=lmax,
        )
        os.replace(tmp_path, cache_path)
        logger.info(f"Cached sphere graph to {cache_path}")
    return graph
