"""PyTorch port, plain ops: layout permutations, ELLPACK bases and the
per-step stencil conv against the JAX package's functions.

The same seeded numpy inputs go through both; layout moves are exact, the
arithmetic is float32 on both sides and held to rtol 1e-5.
"""

from types import SimpleNamespace

import jax
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
from deepsphere_tpu_torch.graph.stencil import stencil_offsets
from deepsphere_tpu_torch.ops import _cuda
from deepsphere_tpu_torch.ops import fused_stencil as tfs

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


# the cface conv's route.  The JAX package runs no kernel at radius >= 3
# with K > 2 on a TPU, and K1, K2 and K3 take no radius-4 conv at h = 16
# (its weight window alone outgrows a block's shared memory), so the conv of
# a k=60 grid graph at K=5 takes the per-step path on the card; a radius-3
# conv the kernels take stays on them; at radius <= 2, where the JAX
# package runs its kernel, a refused plan takes the lap chain (one L~
# application per launch at h = radius), and raises only where the chain's
# plans refuse it too (2048 channels: K2's and K3's dW cells outgrow shared
# memory at every tile)
_H100_SMS = 132  # an H100 SXM's SMs

# (label, nside, k, K, B, Fin, Fout, route)
_ROUTES = [
    ("k=60 K=5 nside 32, 2 -> 3", 32, 60, 5, 2, 2, 3, "per_step"),
    ("k=60 K=5 nside 32, 16 -> 32", 32, 60, 5, 16, 16, 32, "per_step"),
    ("k=40 K=5 nside 32, 16 -> 32", 32, 40, 5, 16, 16, 32, "fused"),
    ("quick_start conv 1", 64, 8, 10, 16, 1, 8, "fused"),
    ("quick_start conv 2", 32, 8, 10, 16, 8, 16, "fused"),
    ("quick_start conv 3", 16, 8, 10, 16, 16, 32, "fused"),
    ("k=20 K=11 nside 32, 8 -> 16", 32, 20, 11, 16, 8, 16, "chain"),
    ("k=20 K=11 nside 32, 2048 -> 2048", 32, 20, 11, 1, 2048, 2048, "raises"),
]

_TGRAPHS = {}


def _deep_stencil(n, k, K):
    if (n, k) not in _TGRAPHS:
        _TGRAPHS[n, k] = tgraph.build_sphere_graph(n, k=k, method="grid")
    return _TGRAPHS[n, k].deep_stencil(0.75, K)


@pytest.mark.parametrize("label,n,k,K,B,Fin,Fout,route", _ROUTES,
                         ids=[c[0] for c in _ROUTES])
def test_cface_route_follows_the_plans(label, n, k, K, B, Fin, Fout, route):
    """The route is "fused" where K1 (forward and, channels swapped, the dx
    conv on dy), K2 and K3 all have a plan on an H100; "per_step" where
    one is refused at radius >= 3 and K > 2 (the JAX package's own
    decline); "chain" where one is refused at radius <= 2 and the lap
    chain's plans take the shape; elsewhere it raises, naming the kernels.
    An inference conv needs only K1's plan."""
    st = _deep_stencil(n, k, K)
    assert tfs.cfp_structural_available(st, "cheby", K), label
    if route == "raises":
        with pytest.raises(ValueError, match="no plan of K2.*lap chain"):
            tfs.cface_route(st, "cheby", K, B, Fin, Fout, _H100_SMS)
        assert tfs.cface_route(st, "cheby", K, B, Fin, Fout, _H100_SMS,
                               grad=False) == "fused"
    else:
        assert tfs.cface_route(st, "cheby", K, B, Fin, Fout,
                               _H100_SMS) == route


def test_cface_route_takes_the_headline_fused():
    """The headline conv (nside 1024, K=5 on the 8-neighbour grid: radius
    1, h=4, B=4, 4 -> 4).  The route reads only the stencil's nside, depth
    and radius, so a stand-in of those spares the nside-1024 graph build
    (``test_torch_kernels.py`` holds each plan at these numbers)."""
    st = SimpleNamespace(nside=1024, n_steps=4, radius=1,
                         offsets=stencil_offsets(1))
    assert tfs.cface_route(st, "cheby", 5, 4, 4, 4, _H100_SMS) == "fused"
    # the same shape at a halo the tiles cannot hold takes the per-step path
    deep = SimpleNamespace(nside=1024, n_steps=16, radius=4,
                           offsets=stencil_offsets(4))
    assert tfs.cface_route(deep, "cheby", 5, 4, 4, 4, _H100_SMS) == "per_step"


def test_cface_per_step_route_matches_jax():
    """At a shape the kernels refuse (k=60 grid, K=5, nside 32, batch 2,
    2 -> 3 channels) the port's cface conv on its per-step route matches
    the JAX package's ``stencil_graph_conv_cface`` on the CPU, which takes
    its per-step fallback there (no Pallas backend): forward, and the
    gradients of a fixed cotangent with respect to x and to the kernel, to
    1e-5 of each max (float32 on both sides, sums in another order).  The
    route is counted, and launches nothing."""
    n, K, B, Fin, Fout = 32, 5, 2, 2, 3
    sj = jgraph.build_sphere_graph(n, k=60, method="grid").deep_stencil(0.75, K)
    st = _deep_stencil(n, 60, K)
    h = st.n_steps
    assert sj.n_steps == h == 16
    _, P_l = tfs.cfp_geometry(n, h)
    rng = np.random.RandomState(5)
    x = rng.normal(size=(B, Fin, 12, n, P_l)).astype(np.float32)
    x[..., :h] = 0.0
    x[..., h + n:] = 0.0
    kern = (rng.normal(size=(Fin * K, Fout)) / np.sqrt(Fin * K)).astype(np.float32)
    cot = rng.normal(size=(B, Fout, 12, n, P_l)).astype(np.float32)

    y_j, vjp = jax.vjp(
        lambda a, w: jstencil.stencil_graph_conv_cface(sj, a, w, K, "cheby"),
        jnp.asarray(x), jnp.asarray(kern))
    dx_j, dk_j = vjp(jnp.asarray(cot))

    _cuda.reset_launch_counts()
    xt = _t(x).requires_grad_()
    kt = _t(kern).requires_grad_()
    y = tstencil._cface_per_step(st, xt, kt, K, "cheby")
    dx, dk = torch.autograd.grad(y, (xt, kt), _t(cot))
    assert _cuda.route_counts == {"per_step_cface": 1, "chain_cface": 0,
                                  "lap_chain": 0, "smooth_fused": 0,
                                  "smooth_per_step": 0}
    assert all(v == 0 for v in _cuda.launch_counts.values())
    y = y.detach()
    assert (y[..., :h] == 0).all() and (y[..., h + n:] == 0).all()
    _close(y, y_j)
    _close(dx, dx_j)
    _close(dk, dk_j)


def test_cface_conv_on_the_cpu_keeps_the_fused_plain_route():
    """A CPU input runs the kernels' plain versions, whatever its shape,
    and agrees with the per-step route."""
    n, K, B, Fin, Fout = 32, 5, 2, 2, 3
    st = _deep_stencil(n, 60, K)
    h = st.n_steps
    _, P_l = tfs.cfp_geometry(n, h)
    rng = np.random.RandomState(6)
    x = _t(rng.normal(size=(B, Fin, 12, n, P_l)).astype(np.float32))
    kern = _t(rng.normal(size=(Fin * K, Fout)).astype(np.float32))
    _cuda.reset_launch_counts()
    y = tstencil.stencil_graph_conv_cface(st, x, kern, K, "cheby")
    assert _cuda.route_counts["per_step_cface"] == 0
    _close(y, tstencil._cface_per_step(st, x, kern, K, "cheby"))
