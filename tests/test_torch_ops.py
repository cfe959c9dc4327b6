"""PyTorch port, plain ops: layout permutations, ELLPACK bases and the
per-step stencil conv against the JAX package's functions.

The same seeded numpy inputs go through both; layout moves are exact, the
arithmetic is float32 on both sides and held to rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepsphere_tpu.graph as jgraph
import deepsphere_tpu.ops.layout as jlayout
import deepsphere_tpu.ops.spmv as jspmv
import deepsphere_tpu.ops.stencil as jstencil
import deepsphere_tpu_torch.graph as tgraph
import deepsphere_tpu_torch.ops.layout as tlayout
import deepsphere_tpu_torch.ops.spmv as tspmv
import deepsphere_tpu_torch.ops.stencil as tstencil

_GRAPHS = {}


def _graphs(n):
    if n not in _GRAPHS:
        _GRAPHS[n] = (
            jgraph.build_sphere_graph(n, k=8, method="grid"),
            tgraph.build_sphere_graph(n, k=8, method="grid"),
        )
    return _GRAPHS[n]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


@pytest.mark.parametrize("n,lead", [(1, ()), (2, (3,)), (8, (2,)), (16, (2, 3))])
def test_layout_permutations_match_jax(rng, n, lead):
    x = rng.normal(size=lead + (12 * n * n, 5)).astype(np.float32)
    f_t = tlayout.nest_to_face(_t(x)).numpy()
    np.testing.assert_array_equal(f_t, np.asarray(jlayout.nest_to_face(jnp.asarray(x))))
    np.testing.assert_array_equal(tlayout.face_to_nest(_t(f_t)).numpy(), x)
    np.testing.assert_array_equal(
        tlayout.face_to_nest(_t(x)).numpy(),
        np.asarray(jlayout.face_to_nest(jnp.asarray(x))))


def test_nside_of_axis_rejects_bad_lengths():
    assert tlayout.nside_of_axis(12 * 64) == 8
    with pytest.raises(ValueError):
        tlayout.nside_of_axis(12 * 9)


@pytest.mark.parametrize("n,h", [(8, 4), (16, 9)])
def test_cface_embed_extract_match_jax(rng, n, h):
    x = rng.normal(size=(2, 12 * n * n, 3)).astype(np.float32)
    e_t = tstencil.cface_embed(_t(x), n, h)
    e_j = jstencil.cface_embed(jnp.asarray(x), n, h)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_array_equal(tstencil.cface_extract(e_t, h).numpy(), x)
    np.testing.assert_array_equal(
        tstencil.cface_extract(e_t, h).numpy(),
        np.asarray(jstencil.cface_extract(e_j, h)))


@pytest.mark.parametrize("kind,scale,K", [("cheby", 0.75, 5), ("mono", 1.0, 3)])
def test_ellpack_basis_matches_jax(rng, kind, scale, K):
    gj, gt = _graphs(8)
    idx, val = gt.ellpack(scale)
    x = rng.normal(size=(gt.n_pixels, 4)).astype(np.float32)
    tb = {"cheby": tspmv.chebyshev_basis, "mono": tspmv.monomial_basis}[kind]
    jb = {"cheby": jspmv.chebyshev_basis, "mono": jspmv.monomial_basis}[kind]
    got = tb(_t(idx.astype(np.int64)), _t(val), _t(x), K)
    want = jb(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(x), K)
    _close(got, want)


def test_edge_strips_match_jax(rng):
    n, h = 16, 9
    x = rng.normal(size=(3, 12, n, n)).astype(np.float32)
    got = tstencil.edge_strips(n, h, _t(x))
    want = jstencil.edge_strips(n, h, jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize(
    "n,kind,scale,K,n_steps,layout",
    [
        (8, "cheby", 0.75, 5, 1, "nest"),
        (8, "cheby", 0.75, 5, 4, "face"),
        (16, "mono", 1.0, 3, 2, "nest"),
        (16, "cheby", 0.75, 10, 9, "face"),
    ],
)
def test_per_step_conv_matches_jax_and_ellpack(rng, n, kind, scale, K, n_steps,
                                               layout):
    gj, gt = _graphs(n)
    sj = gj.face_stencil(scale, n_steps=n_steps)
    st = gt.face_stencil(scale, n_steps=n_steps)
    B, Fin, Fout = 2, 3, 4
    x = rng.normal(size=(B, gt.n_pixels, Fin)).astype(np.float32)
    kern = rng.normal(size=(Fin * K, Fout)).astype(np.float32)
    got = tstencil.stencil_graph_conv(st, _t(x), _t(kern), K, kind,
                                      layout=layout)
    want = jstencil.stencil_graph_conv(
        sj, jnp.asarray(x), jnp.asarray(kern), K, kind, layout=layout,
        fused="never")
    _close(got, want)

    # the port's own oracle: the ELLPACK gather conv
    idx, val = gt.ellpack(scale)
    basis = {"cheby": tspmv.chebyshev_basis, "mono": tspmv.monomial_basis}[kind]
    xn = x if layout == "nest" else tlayout.face_to_nest(_t(x)).numpy()
    y_ell = tspmv.graph_conv(
        lambda z, nt: basis(_t(idx.astype(np.int64)), _t(val), z, nt),
        _t(xn), _t(kern), K)
    if layout == "face":
        y_ell = tlayout.nest_to_face(y_ell)
    _close(got, y_ell)


def test_stencil_tables_carry_the_kernel_maps():
    _, gt = _graphs(16)
    st = gt.deep_stencil(0.75, 5)
    tab = tstencil.as_tensors(tstencil.stencil_tables(st))
    assert tab["strip_idx"].dtype == torch.int32
    assert tab["offsets"].dtype == torch.int32
    assert tab["offsets"].shape == (9, 2)
    assert tab["corr_idx"].dtype == torch.int64
    assert tab["weights"].dtype == torch.float32
    n, h = st.nside, st.n_steps
    flat = tab["corr_rows_cfp"].numpy()
    f, rest = flat // (n * 128), flat % (n * 128)
    ids = (f * n + rest // 128) * n + rest % 128 - h
    np.testing.assert_array_equal(ids, st.corr_out_face)


def test_per_step_conv_rejects_partial_maps():
    _, gt = _graphs(8)
    st = gt.face_stencil(0.75)
    with pytest.raises(ValueError, match="full sphere"):
        tstencil.stencil_graph_conv(st, torch.zeros(1, 10, 1),
                                    torch.zeros(2, 1), 2, "cheby")
