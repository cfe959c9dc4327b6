"""Gaussian smoothing layer on (possibly partial) HEALPix maps.

Counterpart of the JAX package's ``deepsphere_tpu.nn.smoothing``.  The
Gaussian kernel is precomputed on the host, in one of two forms:

* ``"ellpack"`` — the reference-shaped kernel: every pixel's neighbours
  within ``n_sigma_support * sigma`` (k = the largest such count, the
  nearest k for every row), Gaussian weights, rows normalised; applied as
  an ELLPACK matvec per channel, with the repetition trick for multi-scale
  channels (Gaussian closure under convolution).  The neighbours come from
  ``scipy.spatial.cKDTree`` on unit vectors (the JAX package uses sklearn's
  haversine ``BallTree``; chord and angle are monotonic, so the order is
  the same), the chord turned into an angle, 2 arcsin(c / 2), before the
  Gaussian.  A tie at the k-th distance is cut by pixel index.
* ``"stencil"`` — the Gaussian decomposed into m repetitions of a narrow
  sigma / sqrt(m) template whose support fits a radius <= 4 face-grid
  stencil; S^j x then runs as a monomial graph conv on the template's
  stencil (:mod:`..ops.smoothing`): on a CUDA tensor K4 + K1 a pass, with
  the exact transpose S^T as its backward.

``"auto"`` takes the stencil where the support is wide (> 32 neighbours),
unless ``stencil_rel_tol`` is set and :func:`estimate_stencil_error`
predicts more error than it.
"""

from __future__ import annotations

import copy
import hashlib
import os

import numpy as np
import torch
from torch import nn

from .._logger import logger
from ..graph.kdtree import candidates
from ..ops.smoothing import smooth_chain, smooth_route
from ..ops.spmv import ellpack_spmv
from ..ops.stencil import as_tensors, stencil_tables
from ..sphere import healpix as hp

__all__ = ["SmoothingOperator", "HealpySmoothing", "estimate_stencil_error"]

# template applications a pass of the fused conv runs: one lap of the
# radius-r template at h = r, which moves the fewest bytes at radius 4
# (PERF.md: two a pass measured slower; the whole chain has no K1 plan at
# nside 1024)
_APPS = 1


def _rad_to_arcmin(theta):
    return theta / np.pi * (180 * 60)


def _arcmin_to_rad(theta):
    return theta * np.pi / (60 * 180)


def _template_ellpack(nside, sig, r, n_sigma_support, indices=None):
    """Row-normalised ELLPACK of ONE narrow-template repetition of the
    stencil decomposition.  ``indices``: the observed pixels (None = full
    sphere); edges to unobserved pixels are dropped and unobserved rows
    zeroed, as the reference's masked smoothing.

    The native core builds it in one C++ pass; the numpy body is the
    portable version (80 full-map passes, ~25 min at nside 1024)."""
    from .. import native

    if native.available():
        return native.gauss_template(nside, r, sig, n_sigma_support, indices)
    return _template_ellpack_numpy(nside, sig, r, n_sigma_support, indices)


def _template_ellpack_numpy(nside, sig, r, n_sigma_support, indices=None):
    from ..sphere.faces import face2nest_index, halo_map

    npix = hp.nside2npix(nside)
    if indices is None:
        indices = np.arange(npix)
    hm = halo_map(nside, r)
    offsets = [(dx, dy)
               for dx in range(-r, r + 1) for dy in range(-r, r + 1)
               if (dx, dy) != (0, 0)]
    T = len(offsets)
    nb_face = np.empty((npix, T), dtype=np.int64)
    for t, (dx, dy) in enumerate(offsets):
        nb_face[:, t] = hm[:, r + dx : r + dx + nside,
                           r + dy : r + dy + nside].reshape(-1)
    f2n = face2nest_index(nside)
    nb = nb_face[f2n]  # NEST order

    in_mask = np.zeros(npix, dtype=bool)
    in_mask[indices] = True
    valid = (nb >= 0) & in_mask[np.clip(nb, 0, npix - 1)]
    valid &= in_mask[:, None]  # zero rows outside the mask

    vec = hp.pix2vec(nside, np.arange(npix), nest=True)
    w = np.zeros((npix, T), dtype=np.float64)
    for t in range(T):
        cj = np.clip(nb[:, t], 0, npix - 1)
        chord2 = np.einsum("ij,ij->i", vec - vec[cj], vec - vec[cj])
        ang = 2.0 * np.arcsin(np.sqrt(np.clip(chord2, 0, 4)) / 2.0)
        wt = np.exp(-0.5 * (ang / sig) ** 2)
        # reference truncation: keep support within n_sigma * sigma
        wt = np.where(ang <= n_sigma_support * sig, wt, 0.0)
        w[:, t] = np.where(valid[:, t], wt, 0.0)

    # center tap (distance 0) + row normalization
    own = np.arange(npix, dtype=np.int64)
    center = in_mask.astype(np.float64)
    rowsum = w.sum(axis=1) + center
    rowsum[rowsum == 0.0] = 1.0
    ell_idx = np.concatenate(
        [np.where(valid, nb, own[:, None]), own[:, None]], axis=1
    ).astype(np.int32)
    ell_val = (
        np.concatenate([w, center[:, None]], axis=1) / rowsum[:, None]
    ).astype(np.float64)
    return ell_idx, ell_val


def _stencil_decomposition(sigma_rad, spacing, n_sigma_support):
    """(m, per-rep sigma, template radius) of the stencil decomposition:
    m repetitions of a sigma/sqrt(m) Gaussian whose n_sigma support fits a
    radius-<=4 face-grid ring template (Gaussian closure, the reference's
    own multi-scale trick at healpy_layers.py:592-621)."""
    r_max = 4
    m = max(1, int(np.ceil(
        (n_sigma_support * sigma_rad / (r_max * spacing)) ** 2
    )))
    sig = sigma_rad / np.sqrt(m)
    r = min(r_max, max(1, int(np.ceil(n_sigma_support * sig / spacing))))
    return m, sig, r


def _gauss_neighbours(nside, pix, nest, radius):
    """The neighbours of the reference kernel: k = the largest number of
    pixels of ``pix`` within angle ``radius`` of one of them, and every
    row's k nearest, sorted by (angle, index).

    :return: (angles (N, k) float64, indices into ``pix`` (N, k) int64)
    """
    from scipy.spatial import cKDTree

    vec = np.asarray(hp.pix2vec(nside, np.asarray(pix, dtype=np.int64),
                                nest=nest), dtype=np.float64)
    N = vec.shape[0]
    tree = cKDTree(vec)
    chord = 2.0 * np.sin(min(radius, np.pi) / 2.0)
    counts = tree.query_ball_point(vec, r=chord, return_length=True)
    k = min(int(np.max(counts)), N)
    logger.info(f"The maximal number of neighbors within that radius is {k}")
    # candidates past the k-th, so that a tie at the k-th angle is cut by
    # pixel index
    d, inds = candidates(vec, k, tree=tree)
    ang = 2.0 * np.arcsin(np.clip(d / 2.0, 0.0, 1.0))
    # HEALPix's symmetries make many pixels equidistant (the k-th often
    # ties); angles equal to 1e-12 rad count as equal
    order = np.lexsort((inds, np.round(ang * 1e12)), axis=1)[:, :k]
    return (np.take_along_axis(ang, order, axis=1),
            np.take_along_axis(inds, order, axis=1))


def estimate_stencil_error(sigma_rad, nside, n_sigma_support=3,
                           nside_proxy=16, seed=0):
    """Predicted relative L2 deviation of the stencil decomposition from
    the exact (reference) kernel for a (sigma, nside) configuration,
    measured at a small proxy nside with the SAME sigma / pixel-spacing
    ratio (the error is a function of that ratio).  Full-sky: a masked
    operator's boundary adds error that this does not see."""
    spacing_t = hp.nside2resol(nside)
    spacing_p = hp.nside2resol(nside_proxy)
    sig_p = sigma_rad * spacing_p / spacing_t
    m, sig_each, r = _stencil_decomposition(sig_p, spacing_p,
                                            n_sigma_support)
    npix = hp.nside2npix(nside_proxy)
    idx_t, val_t = _template_ellpack(nside_proxy, sig_each, r,
                                     n_sigma_support)

    # the reference-shaped kernel at the proxy scale
    dist, inds = _gauss_neighbours(nside_proxy, np.arange(npix), True,
                                   sig_p * n_sigma_support)
    val_b = np.exp(-0.5 / sig_p**2 * dist**2)

    x = np.random.RandomState(seed).normal(size=npix)
    ys = x
    for _ in range(m):
        ys = (val_t * ys[idx_t]).sum(axis=1)
    yb = (val_b * x[inds]).sum(axis=1) / val_b.sum(axis=1)
    return float(np.linalg.norm(ys - yb) / np.linalg.norm(yb))


class _EllGraph:
    """Duck-typed graph carrying a prebuilt full-sphere template ELLPACK
    into ``face_stencil`` (the row-normalised smoothing matrix is not a
    Laplacian; the scale is ignored)."""

    def __init__(self, nside, k, ell):
        self.nside = nside
        self.k = k
        self.indices = np.arange(12 * nside * nside)
        self.n_pixels = 12 * nside * nside
        self._ell = ell
        # template columns follow the raster tap order (center last): the
        # native plane extractor may copy full-interior rows without the
        # per-entry search
        self._ell_raster_ordered = True

    def ellpack(self, scale):
        return self._ell


class SmoothingOperator:
    """Host-side precompute of the sparse Gaussian smoothing kernel: the
    constructor logic of the reference layer (fwhm/sigma handling,
    per-channel repetitions, disk cache).

    ``method``: ``"stencil"`` (m repetitions of a narrow template on the
    face-grid stencil), ``"ellpack"`` (the reference-shaped exact kernel)
    or ``"auto"`` (the stencil where the support exceeds 32 neighbours,
    unless ``stencil_rel_tol`` is set and the predicted error of the
    stencil exceeds it).  The stencil method runs one template application
    a pass of the fused conv.
    """

    def __init__(
        self,
        nside,
        indices,
        nest=True,
        fwhm=None,
        sigma=None,
        n_sigma_support=3,
        arcmin=True,
        per_channel_repetitions=None,
        data_path=None,
        method="auto",
        stencil_rel_tol=None,
    ):
        self.method = method
        self.stencil_rel_tol = stencil_rel_tol
        self.stencil = None
        # set only on the method='auto' + stencil_rel_tol path
        self.stencil_rel_err_est = None
        self.stencil_reps = 1
        self.stencil_apps = 1
        assert fwhm is not None or sigma is not None, "One of fwhm and sigma has to be specified"
        assert fwhm is None or sigma is None, "Only one of fwhm and sigma can be specified"

        self.nside = int(nside)
        self.indices = np.asarray(indices, dtype=np.int64)
        self.nest = nest
        self.n_sigma_support = n_sigma_support
        self.per_channel_repetitions = per_channel_repetitions
        self.data_path = data_path

        self.do_smoothing = not (fwhm == 0.0 or sigma == 0.0)
        if not self.do_smoothing:
            logger.info("The layer implements the identity, smoothing is disabled")
            self._key = ("identity",)
            return

        # multi-scale channels: smallest scale is the base kernel, larger
        # scales are integer repetitions (variances add)
        if isinstance(fwhm, (list, np.ndarray)):
            assert per_channel_repetitions is None
            fwhm = np.asarray(fwhm, dtype=np.float64)
            fwhm_min = float(np.min(fwhm))
            self.per_channel_repetitions = np.ceil((fwhm / fwhm_min) ** 2).astype(int)
            fwhm = fwhm_min
        elif isinstance(sigma, (list, np.ndarray)):
            assert per_channel_repetitions is None
            sigma = np.asarray(sigma, dtype=np.float64)
            sigma_min = float(np.min(sigma))
            self.per_channel_repetitions = np.ceil((sigma / sigma_min) ** 2).astype(int)
            sigma = sigma_min
        elif isinstance(per_channel_repetitions, list):
            self.per_channel_repetitions = np.asarray(per_channel_repetitions, dtype=int)

        if sigma is None:
            sigma = fwhm / np.sqrt(8 * np.log(2))
        if arcmin:
            self.sigma_arcmin = float(sigma)
            self.sigma_rad = _arcmin_to_rad(self.sigma_arcmin)
        else:
            self.sigma_rad = float(sigma)
            self.sigma_arcmin = _rad_to_arcmin(self.sigma_rad)
        self.fwhm_arcmin = self.sigma_arcmin * np.sqrt(8 * np.log(2))

        self.n_indices = len(self.indices)
        self._idx_hash = hashlib.sha1(
            np.ascontiguousarray(self.indices).tobytes()).hexdigest()[:16]

        if self.method in ("auto", "stencil"):
            # estimated exact-kernel support: pixel density x kernel disc
            # area (the ellpack path gathers once per neighbour)
            est_support = (
                3.0 * self.nside**2
                * (self.n_sigma_support * self.sigma_rad) ** 2
            )
            use_stencil = self.method == "stencil" or est_support > 32
            if (use_stencil and self.method == "auto"
                    and stencil_rel_tol is not None):
                # the predicted deviation of the decomposition from the
                # exact kernel, at a small proxy nside; the exact ELLPACK
                # kernel is kept when it exceeds the ask
                err = estimate_stencil_error(
                    self.sigma_rad, self.nside, self.n_sigma_support
                )
                self.stencil_rel_err_est = err
                if err > stencil_rel_tol:
                    logger.info(
                        f"Stencil decomposition predicted rel L2 error "
                        f"{err:.4f} > stencil_rel_tol={stencil_rel_tol}: "
                        f"using the exact (BallTree/ELLPACK) kernel"
                    )
                    use_stencil = False
                else:
                    logger.info(
                        f"Stencil decomposition predicted rel L2 error "
                        f"{err:.4f} <= stencil_rel_tol={stencil_rel_tol}"
                    )
            if use_stencil:
                self._build_stencil(_APPS)
        if self.stencil is not None:
            logger.info(
                f"Smoothing runs as {self.stencil_reps} repetition(s) of a "
                f"radius-{self.stencil.radius} stencil"
            )
            return

        file_label = f"-nside{self.nside}-sigma{self.sigma_arcmin:4.2f}-n_sigma{n_sigma_support}"

        idx = val = None
        if data_path is not None:
            try:
                idx = np.load(os.path.join(data_path, f"ell_idx{file_label}.npy"))
                val = np.load(os.path.join(data_path, f"ell_val{file_label}.npy"))
                logger.info(f"Loaded cached smoothing kernel from {data_path}")
            except FileNotFoundError:
                idx = val = None
        if idx is None:
            idx, val = self._build_kernel()
            if data_path is not None:
                os.makedirs(data_path, exist_ok=True)
                np.save(os.path.join(data_path, f"ell_idx{file_label}.npy"), idx)
                np.save(os.path.join(data_path, f"ell_val{file_label}.npy"), val)
                logger.info(f"Cached smoothing kernel to {data_path}")

        # row-normalize: smoothing preserves the mean (healpy_layers.py:841-842)
        rowsum = val.sum(axis=1, keepdims=True)
        rowsum[rowsum == 0.0] = 1.0
        self.ell_idx = idx.astype(np.int32)
        self.ell_val = (val / rowsum).astype(np.float32)

        self._key = (
            self.nside,
            self.n_indices,
            round(self.sigma_arcmin, 10),
            n_sigma_support,
            self._idx_hash,
        )
        logger.info("Successfully created the smoothing kernel operator")

    def _build_stencil(self, apps):
        """Decompose the Gaussian into ``m`` repetitions of a narrow
        template kernel and extract it as a :class:`FaceStencil` of depth
        radius * apps; smoothing then runs as monomial stencil convs,
        ``apps`` applications a pass."""
        from ..graph.stencil import (
            face_stencil,
            load_stencil_cache,
            save_stencil_cache,
        )

        nside = self.nside
        spacing = hp.nside2resol(nside)  # radians, mean pixel scale
        m, sig, r = _stencil_decomposition(self.sigma_rad, spacing,
                                           self.n_sigma_support)

        # the template build and its extraction take minutes of host time
        # at nside >= 512: the extracted stencil is cached on disk, keyed by
        # the whole smoothing identity (as the reference's kernel cache)
        k_of_r = {1: 8, 2: 20, 3: 40, 4: 60}
        g = _EllGraph(nside, k_of_r[r], None)
        g._key = (
            "smoothstencil", nside, self.n_indices, self._idx_hash,
            round(self.sigma_arcmin, 10), self.n_sigma_support, m, r,
        )
        st = load_stencil_cache(g, 0.0, r * apps, self.data_path)
        if st is not None:
            logger.info(f"Loaded cached smoothing stencil from {self.data_path}")
        else:
            g._ell = _template_ellpack(nside, sig, r, self.n_sigma_support,
                                       self.indices)
            st = face_stencil(g, 0.0, n_steps=r * apps)
            save_stencil_cache(st, g, self.data_path)
        self.stencil = st
        self.stencil_reps = m
        self.stencil_apps = apps
        self._key = (
            "stencil", self.nside, self.n_indices,
            round(self.sigma_arcmin, 10), self.n_sigma_support,
            self.stencil_reps, self.stencil_apps, self._idx_hash,
        )

    def _build_kernel(self):
        """Neighbours within n_sigma_support * sigma (the reference's
        BallTree query, here ``cKDTree``), with the Gaussian kernel
        (``healpy_layers.py:766-829``)."""
        dist, inds = _gauss_neighbours(self.nside, self.indices, self.nest,
                                       self.sigma_rad * self.n_sigma_support)
        val = np.exp(-0.5 / self.sigma_rad**2 * dist**2).astype(np.float32)
        return inds, val

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, SmoothingOperator) and self._key == other._key


def _with_apps(op, apps):
    """A copy of the stencil operator ``op`` whose passes fuse ``apps``
    template applications (its stencil extracted at depth radius * apps,
    the same decomposition): the deeper form of the chain, held to the
    JAX package's chain by the tests and timed on the card."""
    new = copy.copy(op)
    new._build_stencil(apps)
    return new


class HealpySmoothing(nn.Module):
    """The smoothing layer: ``operator`` is a precomputed
    :class:`SmoothingOperator`; ``mask`` optionally multiplies the output
    (``healpy_layers.py:758-759``).

    Its tables (the ELLPACK kernel, or the template's stencil and the
    masked sky's embedding) are made at the first forward, as
    non-persistent buffers on the device of the input: out of
    ``state_dict``, moved by ``.to``.  It has no parameters."""

    def __init__(self, operator, mask=None):
        super().__init__()
        self.operator = operator
        self.mask = mask
        self._table_keys = ()
        # the route an exported forward holds (``serve.export``), checked
        # for every batch it serves before tracing; None: chosen per call
        self._held_route = None

    def batch_route(self, x_shape, sms):
        """The route of the stencil chain for a CUDA input of ``x_shape``
        (B, M, C) on a card of ``sms`` SMs, from the shape alone
        (:func:`..ops.smoothing.smooth_route`); None for the ELLPACK
        method, which has no route.  Raises where K1 has no plan."""
        op = self.operator
        if not op.do_smoothing or op.stencil is None:
            return None
        B, _, C = x_shape
        return smooth_route(op.stencil, B, C, int(op.stencil_apps), "cuda",
                            sms=sms)

    def _tables(self, device):
        if not self._table_keys:
            op = self.operator
            if op.stencil is not None:
                st = op.stencil
                tables = {**stencil_tables(st), "n2f": st.n2f, "f2n": st.f2n}
                npix = 12 * st.nside ** 2
                if op.n_indices != npix:
                    ind = np.asarray(op.indices, dtype=np.int64)
                    inv = np.full(npix, op.n_indices, dtype=np.int64)
                    inv[ind] = np.arange(op.n_indices)
                    tables["mask_ind"] = ind
                    tables["mask_inv"] = inv
            else:
                tables = {"idx": op.ell_idx, "val": op.ell_val}
            for k, v in as_tensors(tables, device).items():
                self.register_buffer(f"tab_{k}", v, persistent=False)
            self._table_keys = tuple(tables)
        return {k: getattr(self, f"tab_{k}") for k in self._table_keys}

    def forward(self, x):
        op = self.operator
        if not op.do_smoothing:
            return x
        B, M, C = x.shape
        if M != op.n_indices:
            raise ValueError(f"Input has {M} pixels, operator expects {op.n_indices}")

        reps = op.per_channel_repetitions
        if reps is not None:
            assert len(reps) == C, f"per_channel_repetitions has to have length {C}"

        tables = self._tables(x.device)
        if op.stencil is not None:
            y = self._apply_stencil(op, x, reps, tables, self._held_route)
        else:
            idx = tables["idx"]
            val = tables["val"].to(x.dtype)
            x2d = x.permute(1, 0, 2)  # (M, B, C)
            if reps is None:
                y2d = ellpack_spmv(idx, val, x2d.reshape(M, B * C)).reshape(
                    M, B, C)
            else:
                chans = []
                for c in range(C):
                    xc = x2d[:, :, c]
                    for _ in range(int(reps[c])):
                        xc = ellpack_spmv(idx, val, xc)
                    chans.append(xc)
                y2d = torch.stack(chans, dim=2)
            y = y2d.permute(1, 0, 2)
        if self.mask is not None:
            mask = torch.as_tensor(np.asarray(self.mask), dtype=x.dtype,
                                   device=x.device)
            if mask.ndim == 1:
                mask = mask[None, :, None]
            elif mask.ndim == 2:
                mask = mask[None]
            y = y * mask
        return y

    @staticmethod
    def _apply_stencil(op, x, reps, tables, route=None):
        """m (x per-channel) repetitions of the template in face layout:
        the masked sky embedded by a gather (zero rows outside), the power
        chain on the fused conv (:func:`..ops.smoothing.smooth_chain`),
        then back to NEST and the observed rows."""
        st = op.stencil
        n = st.nside
        npix = 12 * n * n
        B, M, C = x.shape
        x2d = x.permute(1, 0, 2).reshape(M, B * C)
        if M != npix:
            xpad = torch.cat([x2d, x2d.new_zeros((1, B * C))], dim=0)
            x2d = xpad[tables["mask_inv"]]
        base = int(op.stencil_reps)
        remaining = (base * np.asarray(reps, dtype=int) if reps is not None
                     else np.full(C, base, dtype=int))
        conv_tables = {k: v for k, v in tables.items()
                       if k not in ("mask_ind", "mask_inv", "n2f", "f2n")}
        xf = x2d[tables["n2f"]].reshape(npix, B, C).permute(1, 0, 2)
        yf = smooth_chain(st, conv_tables, xf, remaining,
                          int(op.stencil_apps), route=route)
        y2d = yf.permute(1, 0, 2).reshape(npix, B * C)[tables["f2n"]]
        if M != npix:
            y2d = y2d[tables["mask_ind"]]
        return y2d.reshape(M, B, C).permute(1, 0, 2)
