"""ctypes bindings for the native host-precompute core.

The C++ library is the JAX package's ``deepsphere_tpu/native/healpix_core.cpp``,
read by path (the port does not duplicate it and does not import the JAX
package).  It is compiled on first use with the system g++ into the port's
build directory, under a name keyed on a hash of the source and the host;
every entry point has a pure-numpy fallback in :mod:`..sphere` /
:mod:`..graph`.

Disable with ``DEEPSPHERE_NO_NATIVE=1``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

import numpy as np

from .._logger import logger

__all__ = ["available", "ellpack_stencil_planes", "gauss_template",
           "grid_laplacian", "neighbors_nest", "pix2vec_nest",
           "stencil_weights"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                    "deepsphere_tpu", "native", "healpix_core.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("DEEPSPHERE_NO_NATIVE") == "1":
        return None
    try:
        # -march=native: the library is only valid on the host that built
        # it, so the host name is part of the key
        with open(_SRC, "rb") as fh:
            key = hashlib.sha256(
                fh.read() + platform.node().encode()).hexdigest()[:16]
        so = os.path.join(_BUILD, f"libhealpix_core-{key}.so")
        if not os.path.exists(so):
            os.makedirs(_BUILD, exist_ok=True)
            tmp = so + f".{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-o", tmp, _SRC],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, so)
            logger.info(f"Built native healpix core -> {so}")
        lib = ctypes.CDLL(so)
        i64 = ctypes.c_int64
        dbl = ctypes.c_double
        ptr = np.ctypeslib.ndpointer
        lib.ds_pix2vec_nest.argtypes = [i64, ptr(np.float64, flags="C")]
        lib.ds_neighbors_nest.argtypes = [i64, ptr(np.int64, flags="C")]
        lib.ds_grid_laplacian.argtypes = [
            i64, dbl, ctypes.c_int,
            ptr(np.int64, flags="C"), ptr(np.float64, flags="C"),
            ptr(np.int32, flags="C"), ptr(np.float64, flags="C"),
            ptr(np.float64, flags="C"),
        ]
        lib.ds_stencil_weights.argtypes = [
            i64, i64,
            ptr(np.int32, flags="C"), ptr(np.float32, flags="C"),
            ptr(np.float32, flags="C"),
        ]
        lib.ds_gauss_template.argtypes = [
            i64, i64, dbl, dbl,
            ptr(np.uint8, flags="C"),
            ptr(np.int32, flags="C"), ptr(np.float64, flags="C"),
        ]
        lib.ds_ellpack_stencil_planes.argtypes = [
            i64, i64, i64, i64, ctypes.c_int,
            ptr(np.int32, flags="C"), ptr(np.float64, flags="C"),
            ptr(np.float32, flags="C"), ptr(np.float64, flags="C"),
        ]
        _lib = lib
    except Exception as e:  # pragma: no cover - toolchain-dependent
        logger.info(f"native healpix core unavailable ({e}); using numpy")
        _lib = None
    return _lib


def available():
    return _load() is not None


def pix2vec_nest(nside):
    """(npix, 3) float64 pixel center unit vectors, NEST order."""
    lib = _load()
    npix = 12 * nside * nside
    out = np.empty((npix, 3), np.float64)
    lib.ds_pix2vec_nest(nside, out)
    return out


def neighbors_nest(nside):
    """(npix, 8) int64 NEST grid neighbors, -1 padded."""
    lib = _load()
    npix = 12 * nside * nside
    out = np.empty((npix, 8), np.int64)
    lib.ds_neighbors_nest(nside, out)
    return out


def grid_laplacian(nside, kernel_width=None, lanczos_iters=512):
    """One-pass grid-graph build.

    :param kernel_width: Gaussian width; ``None`` selects the mean neighbor
        distance, a NEGATIVE value selects ``|kernel_width|`` times the mean
        neighbor distance (ratio mode — see
        ``graph.laplacian.HARMONIC_WIDTH_RATIO``).
    :return: dict with ``nb`` (npix, 8) i64, ``w`` (npix, 8) f64 Gaussian
        adjacency, ``ell_idx``/``ell_val`` (npix, 9) direction-aligned
        UNSCALED normalized-Laplacian ELLPACK (slot 8 = unit diagonal),
        ``kernel_width``, ``lmax`` (already x1.02).
    """
    lib = _load()
    npix = 12 * nside * nside
    nb = np.empty((npix, 8), np.int64)
    w = np.empty((npix, 8), np.float64)
    ell_idx = np.empty((npix, 9), np.int32)
    ell_val = np.empty((npix, 9), np.float64)
    params = np.empty(2, np.float64)
    lib.ds_grid_laplacian(
        nside, 0.0 if kernel_width is None else float(kernel_width),
        int(lanczos_iters), nb, w, ell_idx, ell_val, params,
    )
    return {
        "nb": nb, "w": w, "ell_idx": ell_idx, "ell_val": ell_val,
        "kernel_width": float(params[0]), "lmax": float(params[1]),
    }


def gauss_template(nside, radius, sig, n_sigma_support, indices=None):
    """Row-normalized Gaussian smoothing-template ELLPACK (the JAX
    package's ``nn.smoothing._template_ellpack`` numpy oracle, in one
    native pass).

    :return: ``(ell_idx (npix, T+1) i32, ell_val (npix, T+1) f64)`` with
        T = (2 radius + 1)^2 - 1 raster taps, center last.
    """
    lib = _load()
    npix = 12 * nside * nside
    mask = np.zeros(npix, np.uint8)
    if indices is None:
        mask[:] = 1
    else:
        mask[np.asarray(indices, dtype=np.int64)] = 1
    T = (2 * radius + 1) ** 2 - 1
    ell_idx = np.empty((npix, T + 1), np.int32)
    ell_val = np.empty((npix, T + 1), np.float64)
    lib.ds_gauss_template(
        nside, int(radius), float(sig), float(n_sigma_support),
        mask, ell_idx, ell_val,
    )
    return ell_idx, ell_val


def ellpack_stencil_planes(nside, n_steps, radius, ell_idx, ell_val,
                           raster_ordered=False):
    """Generic radius-r stencil weight planes from a full-sphere ELLPACK
    (the ``graph.stencil._lookup_entries`` loop in one native pass).

    :return: ``(w_emb (nplanes, 12, P_r, P_l) f32, captured (12, Pw, Pw)
        f64)`` — the wide-embedded plane layout of ``face_stencil`` plus
        the per-position absolute captured mass for the conservation check.
    """
    lib = _load()
    h = n_steps - radius
    Pw = nside + 2 * h
    P_r = nside + -(-2 * n_steps // 8) * 8
    P_l = -(-(nside + 2 * n_steps) // 128) * 128
    nplanes = (2 * radius + 1) ** 2
    out = np.zeros((nplanes, 12, P_r, P_l), np.float32)
    captured = np.empty((12, Pw, Pw), np.float64)
    lib.ds_ellpack_stencil_planes(
        nside, int(n_steps), int(radius), int(ell_idx.shape[1]),
        1 if raster_ordered else 0,
        np.ascontiguousarray(ell_idx, np.int32),
        np.ascontiguousarray(ell_val, np.float64),
        out, captured,
    )
    return out, captured


def stencil_weights(nside, n_steps, ell_idx, ell_val_scaled):
    """(9, 12, P_r, P_l) stencil weight planes of a rescaled grid Laplacian
    in padded-activation coordinates (see graph/stencil.py)."""
    lib = _load()
    P_r = nside + -(-2 * n_steps // 8) * 8
    P_l = -(-(nside + 2 * n_steps) // 128) * 128
    out = np.zeros((9, 12, P_r, P_l), np.float32)
    lib.ds_stencil_weights(
        nside, n_steps,
        np.ascontiguousarray(ell_idx, np.int32),
        np.ascontiguousarray(ell_val_scaled, np.float32),
        out,
    )
    return out
