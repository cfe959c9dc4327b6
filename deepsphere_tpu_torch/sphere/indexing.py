"""Partial-sky pixel index bookkeeping.

TPU-native re-implementation of the index utilities the reference model
assembler relies on:

* ``extend_indices`` — parity with
  ``deepsphere-cosmo-tf2 src/deepsphere/utils.py:9-37``: minimally extend an index
  set so it reduces cleanly to ``nside_out`` through the NEST hierarchy.
* ``transform_indices`` — parity with
  ``HealpyGCNN._transform_indices`` (``healpy_networks.py:169-188``):
  map an index set to a different nside via a binary-mask ud_grade.
"""

from __future__ import annotations

import numpy as np

from . import healpix as hp

__all__ = ["extend_indices", "transform_indices", "check_indices_consistent"]


def extend_indices(indices, nside_in, nside_out, nest=True):
    """Minimally extend ``indices`` so the set reduces exactly to
    ``nside_out``: every coarse pixel touched by the set gets all of its
    fine-pixel children included."""
    order = "NEST" if nest else "RING"
    m_in = np.zeros(hp.nside2npix(nside_in))
    m_in[np.asarray(indices, dtype=np.int64)] = 1.0
    m_in = hp.ud_grade(m_in, nside_out=nside_out, order_in=order, order_out=order)
    m_in = hp.ud_grade(m_in, nside_out=nside_in, order_in=order, order_out=order)
    return np.arange(hp.nside2npix(nside_in), dtype=np.int64)[m_in > 1e-12]


def transform_indices(nside_in, nside_out, indices):
    """Map a NEST index set to a new nside by down/up-grading a binary mask
    (assumes the reduction is sensible, like the reference)."""
    if nside_in == nside_out:
        return np.asarray(indices, dtype=np.int64)
    mask_in = np.zeros(hp.nside2npix(nside_in))
    mask_in[np.asarray(indices, dtype=np.int64)] = 1.0
    mask_out = hp.ud_grade(mask_in, nside_out=nside_out, order_in="NEST", order_out="NEST")
    return np.arange(hp.nside2npix(nside_out), dtype=np.int64)[mask_out > 1e-12]


def check_indices_consistent(indices, nside_in, nside_out):
    """True when the index set round-trips through ``nside_out`` unchanged —
    the consistency check of ``healpy_networks.py:73-88``."""
    mask_in = np.zeros(hp.nside2npix(nside_in))
    mask_in[np.asarray(indices, dtype=np.int64)] = 1.0
    mask_out = hp.ud_grade(mask_in, nside_out=nside_out, order_in="NEST", order_out="NEST")
    mask_out[mask_out > 1e-12] = 1.0
    mask_back = hp.ud_grade(mask_out, nside_out=nside_in, order_in="NEST", order_out="NEST")
    transformed = np.arange(hp.nside2npix(nside_in), dtype=np.int64)[mask_back > 1e-12]
    ind = np.sort(np.asarray(indices, dtype=np.int64))
    return transformed.shape == ind.shape and np.all(np.sort(transformed) == ind)
