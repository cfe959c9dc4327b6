"""PyTorch port, host precompute: the port's copy of the sphere/graph code
must produce exactly the JAX package's arrays.

Both packages run here side by side; everything compared is numpy, so the
checks are exact (bit-for-bit), including ``lmax`` — a drift there would
move every conv of the port.
"""

import dataclasses

import numpy as np
import pytest

import deepsphere_tpu.graph as jgraph
import deepsphere_tpu_torch.graph as tgraph
from deepsphere_tpu import native as jnative
from deepsphere_tpu.sphere import faces as jfaces
from deepsphere_tpu.sphere import indexing as jindexing
from deepsphere_tpu_torch import native as tnative
from deepsphere_tpu_torch.sphere import faces as tfaces
from deepsphere_tpu_torch.sphere import indexing as tindexing

_GRAPHS = {}


def _graphs(n):
    if n not in _GRAPHS:
        _GRAPHS[n] = (
            jgraph.build_sphere_graph(n, k=8, method="grid"),
            tgraph.build_sphere_graph(n, k=8, method="grid"),
        )
    return _GRAPHS[n]


def _assert_stencils_equal(sj, st):
    assert (sj is None) == (st is None)
    if sj is None:
        return
    for f in dataclasses.fields(sj):
        a, b = getattr(sj, f.name), getattr(st, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("n", [8, 16])
def test_sphere_graph_matches_jax(n):
    gj, gt = _graphs(n)
    assert gt.lmax == gj.lmax
    assert gt.kernel_width == gj.kernel_width
    for scale in (0.75, 1.0):
        for a, b in zip(gj.ellpack(scale), gt.ellpack(scale)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,n_steps", [(8, 1), (8, 4), (8, 9), (16, 1),
                                       (16, 4), (16, 9)])
def test_face_stencil_matches_jax(n, n_steps):
    gj, gt = _graphs(n)
    sj = gj.face_stencil(0.75, n_steps=n_steps)
    st = gt.face_stencil(0.75, n_steps=n_steps)
    if n_steps >= n:  # halo deeper than the face: no stencil in either
        assert sj is None and st is None
    else:
        assert st.corr_src.shape[0] > 0 or n_steps == 1
        _assert_stencils_equal(sj, st)


@pytest.mark.parametrize("n,K,want_h", [(16, 10, 9), (16, 5, 4), (8, 10, None)])
def test_deep_stencil_is_exact_depth(n, K, want_h):
    """The port's deep stencil has h = r (K-1) exactly (the JAX package
    rounds deep halos up to 8-row multiples for the TPU)."""
    gj, gt = _graphs(n)
    st = gt.deep_stencil(0.75, K)
    if want_h is None:
        assert st is None
        return
    assert st.n_steps == want_h
    _assert_stencils_equal(gj.face_stencil(0.75, n_steps=want_h), st)


def test_exact_depth_shrinks_the_correction():
    """At nside 32, K=10 the exact h=9 recomputes far fewer rows than the
    TPU's h=16 (the JAX deep stencil)."""
    gj = jgraph.build_sphere_graph(32, k=8, method="grid")
    gt = tgraph.build_sphere_graph(32, k=8, method="grid")
    sj, st = gj.deep_stencil(0.75, 10), gt.deep_stencil(0.75, 10)
    assert (sj.n_steps, st.n_steps) == (16, 9)
    assert st.corr_out_face.shape[0] == 4968
    assert sj.corr_out_face.shape[0] == 12192


@pytest.mark.parametrize("n,h", [(4, 0), (8, 3)])
def test_face_maps_match_jax(n, h):
    np.testing.assert_array_equal(tfaces.halo_map(n, h), jfaces.halo_map(n, h))
    np.testing.assert_array_equal(tfaces.face2nest_index(n),
                                  jfaces.face2nest_index(n))
    for f in range(12):
        for xs, ys in [(-1, -1), (-1, 0), (1, 1), (0, 1)]:
            assert (tfaces.edge_descriptor(f, xs, ys)
                    == jfaces.edge_descriptor(f, xs, ys))


def test_index_helpers_match_jax():
    ind = np.arange(3 * 16 * 16, dtype=np.int64)[::3]
    np.testing.assert_array_equal(tindexing.extend_indices(ind, 16, 4),
                                  jindexing.extend_indices(ind, 16, 4))
    np.testing.assert_array_equal(tindexing.transform_indices(16, 8, ind),
                                  jindexing.transform_indices(16, 8, ind))
    assert (tindexing.check_indices_consistent(ind, 16, 8)
            == jindexing.check_indices_consistent(ind, 16, 8))


def test_native_core_builds_from_the_jax_source():
    """The port compiles its own copy of the JAX package's C++ file into
    its own build directory, and it computes the same graph."""
    if not jnative.available():
        pytest.skip("no C++ toolchain: both packages use the numpy fallback")
    assert tnative.available()
    assert tnative._SRC.endswith("deepsphere_tpu_torch/native/healpix_core.cpp")
    assert tnative._lib._name.startswith(tnative._BUILD)
    a, b = jnative.grid_laplacian(8, -0.5166), tnative.grid_laplacian(8, -0.5166)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
