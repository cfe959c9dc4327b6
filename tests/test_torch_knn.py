"""PyTorch port, kNN graphs (the reference's own graph construction)
against the JAX package on the CPU.

* The graph.  The JAX package finds each pixel's k nearest neighbours with
  sklearn's ``NearestNeighbors`` (a ``KDTree``); the port, which has no
  sklearn on the card's machine, with ``scipy.spatial.cKDTree`` candidates
  and, in the rows where HEALPix's symmetries make the k-th and (k+1)-th
  distances tie exactly, a replay of sklearn's tree, its partition and its
  heap (``graph/kdtree.py``).  The port's graphs are built in a fresh
  interpreter where sklearn cannot be imported; they equal the JAX builds
  bit for bit (W, L, kernel width, lmax), tied rows included, and the
  tied-row count is printed.  The replayed tree equals sklearn's own, and
  its picks equal sklearn's on data made of ties.
* The kNN convs and a kNN model against the JAX package on the same
  graphs: the k=8 nside-32 K=5 deep stencil (radius-2 capture, corner
  rows recomputed from the ball) on the per-step path and on the fused
  cface route with its corner correction; the k=60 nside-16 single-step
  stencil, whose 32 rows with edges outside the capture window take the
  exact ELLPACK row (``ops/stencil.py::stencil_matvec``'s fix rows);
  forward to 2e-5, gradients to 1e-4, of each output's max.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import sklearn.neighbors
import torch

import deepsphere_tpu as ds
import deepsphere_tpu.graph as jgraph
import deepsphere_tpu.ops.stencil as jstencil
import deepsphere_tpu_torch as dt
import deepsphere_tpu_torch.graph as tgraph
from deepsphere_tpu_torch.graph import kdtree
import deepsphere_tpu_torch.ops.stencil as tstencil
from deepsphere_tpu.nn import healpy_layers as jhp
from deepsphere_tpu.ops.spmv import chebyshev_basis, graph_conv
from deepsphere_tpu_torch.interop import export_jax_variables, load_jax_variables
from deepsphere_tpu_torch.nn import healpy_layers as thp
from deepsphere_tpu_torch.ops.fused_stencil import cfp_structural_available
from deepsphere_tpu_torch.sphere import healpix as hp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = 2e-5
GRAD_TOL = 1e-4

# (nside, k) of the graph cases: the degrees the reference supports at
# sizes a CPU builds in seconds
CASES = [(2, 8), (4, 8), (8, 8), (16, 8), (32, 8), (4, 20), (8, 20),
         (16, 20), (32, 20), (4, 60), (8, 60), (16, 60)]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _coords(nside):
    return hp.pix2vec(nside, np.arange(12 * nside * nside), nest=True)


def _sklearn_sets(coords, k):
    """The JAX package's neighbours: sklearn's ``NearestNeighbors``, self
    dropped."""
    nn = sklearn.neighbors.NearestNeighbors(n_neighbors=k + 1).fit(coords)
    d, i = nn.kneighbors(coords)
    return d[:, 1:], i[:, 1:]


@pytest.fixture(scope="module")
def port_graphs(tmp_path_factory):
    """The port's kNN graphs of :data:`CASES`, built in a fresh interpreter
    where sklearn, jax and the JAX package cannot be imported."""
    out = tmp_path_factory.mktemp("knn")
    code = textwrap.dedent(f"""
        import sys
        for name in ("sklearn", "jax", "flax", "deepsphere_tpu"):
            sys.modules[name] = None
        import numpy as np
        from deepsphere_tpu_torch.graph import build_sphere_graph
        for nside, k in {CASES!r}:
            g = build_sphere_graph(nside, k=k, method="knn")
            W, L = g.A.tocsr(), g.L.tocsr()
            np.savez(f"{out}/{{nside}}_{{k}}.npz", w=W.data,
                     w_ind=W.indices, w_ptr=W.indptr, l=L.data,
                     l_ind=L.indices, l_ptr=L.indptr,
                     kernel_width=g.kernel_width, lmax=g.lmax)
        assert not any(k.split(".")[0] in ("sklearn", "jax", "deepsphere_tpu")
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), \
        res.stderr[-3000:]
    graphs = {}
    for nside, k in CASES:
        z = np.load(out / f"{nside}_{k}.npz")
        n = 12 * nside * nside
        graphs[nside, k] = (
            sp.csr_matrix((z["w"], z["w_ind"], z["w_ptr"]), shape=(n, n)),
            sp.csr_matrix((z["l"], z["l_ind"], z["l_ptr"]), shape=(n, n)),
            float(z["kernel_width"]), float(z["lmax"]))
    return graphs


def _bit_equal(a, b):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    return (np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


@pytest.mark.parametrize("nside,k", CASES)
def test_knn_graph_matches_jax(port_graphs, nside, k):
    """The port's kNN graph (built with sklearn blocked) equals the JAX
    build bit for bit, in the rows where the k-th distance ties too."""
    W_t, L_t, kw_t, lmax_t = port_graphs[nside, k]
    coords = _coords(nside)
    d_s, i_s = _sklearn_sets(coords, k)
    d_t, i_t, n_tied = kdtree.knn(coords, k)
    assert np.array_equal(d_s, d_t)
    assert all(set(a) == set(b) for a, b in zip(i_s, i_t))
    print(f"nside {nside} k {k}: {n_tied} of {len(coords)} rows tie at the "
          "k-th distance and take sklearn's pick from the replayed tree")
    gj = jgraph.build_sphere_graph(nside, k=k, method="knn")
    assert _bit_equal(W_t, gj.A) and _bit_equal(L_t, gj.L)
    assert gj.kernel_width == kw_t and gj.lmax == lmax_t


def _tie_data(kind):
    rs = np.random.RandomState(0)
    if kind == "grid":  # integer points: most rows tie at the k-th
        g = np.meshgrid(*[np.arange(9.0)] * 3, indexing="ij")
        return np.stack(g, -1).reshape(-1, 3)
    if kind == "normal":
        return rs.normal(size=(1000, 3))
    n = 12 * 16 * 16
    if kind == "ring":
        return hp.pix2vec(16, np.arange(n), nest=False)
    return _coords(16)[np.sort(rs.choice(n, n // 3, replace=False))]


@pytest.mark.parametrize("kind", ["grid", "normal", "ring", "partial"])
def test_kdtree_replays_sklearns_tree(kind):
    """The replayed tree holds sklearn's ``KDTree`` point order (the
    libstdc++ ``nth_element`` partitions) and node bounds, and its
    neighbour sets are sklearn's, on data whose ties the HEALPix graphs
    above meet only in a few rows."""
    data = np.ascontiguousarray(_tie_data(kind), dtype=np.float64)
    idx, lower, upper, _, _ = kdtree.build_tree(data)
    _, want_idx, _, bounds = sklearn.neighbors.KDTree(
        data, leaf_size=kdtree.LEAF_SIZE).get_arrays()
    assert np.array_equal(idx, want_idx)
    assert np.array_equal(lower, bounds[0]) and np.array_equal(upper, bounds[1])
    for k in (6, 8, 20):
        d_s, i_s = _sklearn_sets(data, k)
        d_t, i_t, n_tied = kdtree.knn(data, k)
        assert np.array_equal(d_s, d_t)
        assert all(set(a) == set(b) for a, b in zip(i_s, i_t))
        if kind == "grid":
            assert n_tied > len(data) // 2


def test_nth_element_takes_libstdcpp_heap_select():
    """Past its depth limit libstdc++'s introselect selects by a heap;
    Musser's median-of-3 killer drives it there, and the result is still
    a partition around the n-th key."""
    n = 512
    a = [0] * n
    for i in range(1, n // 2 + 1):
        if i % 2:
            a[i - 1], a[i] = i, n // 2 + i
        a[n // 2 + i - 1] = 2 * i
    calls = []
    orig = kdtree._heap_select
    try:
        kdtree._heap_select = lambda *args: calls.append(1) or orig(*args)
        for nth in (0, n // 3, n // 2, n - 1):
            v = list(a)
            kdtree._nth_element(v, 0, nth, n)
            s = sorted(a)
            assert v[nth] == s[nth]
            assert max(v[:nth], default=-1) < v[nth] < min(v[nth + 1:],
                                                            default=n * 9)
    finally:
        kdtree._heap_select = orig
    assert calls


def test_knn_neighbours_take_every_tie_into_account():
    """Ties past the first margin of candidates widen it: with a margin of
    1 every point as near as a row's k-th is among its candidates."""
    coords = _coords(8)
    k = 21
    d, idx = kdtree.candidates(coords, k, margin=1)
    full = np.linalg.norm(coords[:, None] - coords[None], axis=-1)
    kth = np.sort(full, axis=1)[:, k - 1]
    for r in range(len(coords)):
        near = set(np.flatnonzero(full[r] <= kth[r] + 1e-12))
        assert near <= set(idx[r])


def test_knn_graph_on_few_vertices_reduces_k():
    """A graph of fewer than k + 1 vertices keeps every other vertex, as
    the JAX build does.  sklearn takes its brute-force search on so few
    points, whose distances (from |x|^2 + |y|^2 - 2 x.y) differ from the
    tree's in the last bits: W and L agree to float64 rounding."""
    ind = np.arange(16)
    gt = tgraph.build_sphere_graph(2, ind, k=20, method="knn")
    gj = jgraph.build_sphere_graph(2, ind, k=20, method="knn")
    assert gt.A.nnz == gj.A.nnz == 16 * 15
    for a, b in ((gt.A, gj.A), (gt.L, gj.L)):
        assert _rel(a.toarray(), b.toarray()) <= 1e-12
    assert abs(gt.kernel_width - gj.kernel_width) <= 1e-12 * gj.kernel_width


# ---------------------------------------------------------------------------
# the kNN convs through the stencil path
# ---------------------------------------------------------------------------


def _gather_conv(g, x, kern, K):
    idx, val = g.ellpack(0.75)
    idx, val = jnp.asarray(idx), jnp.asarray(val)
    return graph_conv(lambda x2d, nt: chebyshev_basis(idx, val, x2d, nt),
                      x, kern, K)


def _jax_conv_and_grads(st, g, x, kern, dy, K):
    """The JAX stencil conv (NEST layout, its per-step XLA path: the plain
    reference of its Pallas routes), its VJP at ``dy``, and the ELLPACK
    gather conv."""
    tables = {k: jnp.asarray(v) for k, v in jstencil.stencil_tables(st).items()}
    f = lambda xx, kk: jstencil.stencil_graph_conv(
        st, xx, kk, K, "cheby", tables=tables, layout="nest", fused="never")
    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(kern))
    gx, gk = vjp(jnp.asarray(dy))
    y_gather = _gather_conv(g, jnp.asarray(x), jnp.asarray(kern), K)
    return (np.asarray(y), np.asarray(gx), np.asarray(gk),
            np.asarray(y_gather))


def _port_grads(fn, x, kern, dy):
    xt = torch.from_numpy(x).requires_grad_(True)
    kt = torch.from_numpy(kern).requires_grad_(True)
    y = fn(xt, kt)
    y.backward(torch.from_numpy(dy))
    return y.detach().numpy(), xt.grad.numpy(), kt.grad.numpy()


def test_knn_deep_stencil_conv_matches_jax():
    """nside 32, k=8, Chebyshev K=5: the deep stencil (radius-2 capture,
    h=8) with its corner rows, on the per-step path and on the fused cface
    route (corner correction from the ball), against the JAX stencil conv
    and its gather conv."""
    nside, K, B, Fin, Fout = 32, 5, 2, 2, 3
    gj = jgraph.build_sphere_graph(nside, k=8, method="knn")
    gt = tgraph.build_sphere_graph(nside, k=8, method="knn")
    st_j, st_t = gj.deep_stencil(0.75, K), gt.deep_stencil(0.75, K)
    assert st_t.radius == 2 and st_t.n_steps == st_j.n_steps == 8
    assert np.array_equal(st_t.corrupt_rows, st_j.corrupt_rows)
    assert st_t.corrupt_rows.shape[0] > 0
    assert np.array_equal(st_t.corr_out_face, st_j.corr_out_face)
    assert cfp_structural_available(st_t, "cheby", K)
    rng = np.random.RandomState(7)
    M = gt.n_pixels
    x = rng.normal(size=(B, M, Fin)).astype(np.float32)
    kern = rng.normal(size=(Fin * K, Fout)).astype(np.float32)
    dy = rng.normal(size=(B, M, Fout)).astype(np.float32)
    y_j, gx_j, gk_j, y_g = _jax_conv_and_grads(st_j, gj, x, kern, dy, K)
    assert _rel(y_j, y_g) <= FWD_TOL

    # the per-step path on the deep stencil
    per_step = lambda xx, kk: tstencil.stencil_graph_conv(
        st_t, xx, kk, K, "cheby", layout="nest")
    y, gx, gk = _port_grads(per_step, x, kern, dy)
    assert _rel(y, y_j) <= FWD_TOL
    assert _rel(gx, gx_j) <= GRAD_TOL and _rel(gk, gk_j) <= GRAD_TOL

    # the fused cface route (the kernels' plain versions on the CPU), from
    # the face layout and back
    from deepsphere_tpu_torch.ops.layout import face_to_nest, nest_to_face

    h = st_t.n_steps

    def cface(xx, kk):
        x5 = tstencil.cface_embed(nest_to_face(xx), nside, h)
        y5 = tstencil.stencil_graph_conv_cface(st_t, x5, kk, K, "cheby")
        return face_to_nest(tstencil.cface_extract(y5, h))

    y, gx, gk = _port_grads(cface, x, kern, dy)
    assert _rel(y, y_j) <= FWD_TOL
    assert _rel(gx, gx_j) <= GRAD_TOL and _rel(gk, gk_j) <= GRAD_TOL


def test_knn_single_step_fix_rows_match_jax():
    """nside 16, k=60: the single-application stencil (radius-5 capture)
    leaves 32 rows whose edges escape the window; they take the exact
    ELLPACK row (fix rows).  Chebyshev K=3 per step, forward and
    gradients, against the JAX stencil conv and its gather conv."""
    nside, K, B, Fin, Fout = 16, 3, 2, 2, 3
    gj = jgraph.build_sphere_graph(nside, k=60, method="knn")
    gt = tgraph.build_sphere_graph(nside, k=60, method="knn")
    st_j, st_t = gj.face_stencil(0.75), gt.face_stencil(0.75)
    assert st_t.radius == st_t.n_steps == 5
    tab_t = tstencil.stencil_tables(st_t)
    tab_j = jstencil.stencil_tables(st_j)
    assert tab_t["fix_src"].shape[0] == 32
    for key in ("fix_src", "fix_idx", "fix_val"):
        assert np.array_equal(np.asarray(tab_t[key]), np.asarray(tab_j[key]))
    rng = np.random.RandomState(3)
    M = gt.n_pixels
    x = rng.normal(size=(B, M, Fin)).astype(np.float32)
    kern = rng.normal(size=(Fin * K, Fout)).astype(np.float32)
    dy = rng.normal(size=(B, M, Fout)).astype(np.float32)
    y_j, gx_j, gk_j, y_g = _jax_conv_and_grads(st_j, gj, x, kern, dy, K)
    assert _rel(y_j, y_g) <= FWD_TOL
    conv = lambda xx, kk: tstencil.stencil_graph_conv(
        st_t, xx, kk, K, "cheby", layout="nest")
    y, gx, gk = _port_grads(conv, x, kern, dy)
    assert _rel(y, y_j) <= FWD_TOL
    assert _rel(gx, gx_j) <= GRAD_TOL and _rel(gk, gk_j) <= GRAD_TOL
    # the fix rows are live: the stencil alone misses the escaped edges
    # (far, so of small weight) on those rows
    rows = np.asarray(tab_t["fix_src"])
    bare = {key: v for key, v in tab_t.items() if not key.startswith("fix_")}
    y_bare = tstencil.stencil_graph_conv(
        st_t, torch.from_numpy(x), torch.from_numpy(kern), K, "cheby",
        tables=tstencil.as_tensors(bare), layout="nest").numpy()
    from deepsphere_tpu_torch.ops.layout import face_to_nest

    face = np.zeros(M, bool)
    face[rows] = True
    wrong = face_to_nest(torch.from_numpy(face[None, :, None]))[0, :, 0]
    wrong = wrong.numpy()
    e_fix = np.abs(y - y_g)[:, wrong].max()
    e_bare = np.abs(y_bare - y_g)[:, wrong].max()
    print(f"fix rows: {rows.size}; max error on them {e_fix:.2e} with the "
          f"exact rows, {e_bare:.2e} without")
    assert e_bare > 10 * e_fix


def test_knn_lap_chain_matches_jax():
    """nside 16, k=20, Chebyshev K=4: the radius-3 capture window, the
    conv the card runs as a lap chain (one L~ application a fused launch,
    ``conv_route`` "chain" for a CUDA input); on the CPU the chain's plain
    versions, forward and gradients, against the JAX stencil conv."""
    nside, K, B, Fin, Fout = 16, 4, 2, 2, 3
    gj = jgraph.build_sphere_graph(nside, k=20, method="knn")
    gt = tgraph.build_sphere_graph(nside, k=20, method="knn")
    st_j, st_t = gj.face_stencil(0.75), gt.face_stencil(0.75)
    assert (st_t.radius, st_t.n_steps) == (3, 3)
    assert tstencil.conv_route(st_t, "cheby", K, True) == "chain"
    assert tstencil.conv_route(st_t, "cheby", K, False) == "per_step"
    rng = np.random.RandomState(5)
    M = gt.n_pixels
    x = rng.normal(size=(B, M, Fin)).astype(np.float32)
    kern = rng.normal(size=(Fin * K, Fout)).astype(np.float32)
    dy = rng.normal(size=(B, M, Fout)).astype(np.float32)
    y_j, gx_j, gk_j, y_g = _jax_conv_and_grads(st_j, gj, x, kern, dy, K)
    assert _rel(y_j, y_g) <= FWD_TOL
    chain = lambda xx, kk: tstencil.lap_chain_conv(st_t, xx, kk, K, "cheby",
                                                   layout="nest")
    y, gx, gk = _port_grads(chain, x, kern, dy)
    assert _rel(y, y_j) <= FWD_TOL
    assert _rel(gx, gx_j) <= GRAD_TOL and _rel(gk, gk_j) <= GRAD_TOL


def _knn_layers(m, K):
    return [
        m.HealpyChebyshev(K=K, Fout=4, activation="relu", use_bn=True),
        m.HealpyPool(p=1),
        m.HealpyChebyshev(K=K, Fout=6, activation="relu", use_bn=True),
        m.HealpyPool(p=1),
        m.Flatten(),
        m.Dense(3),
    ]


@pytest.mark.parametrize("nside,k,K", [(16, 8, 3), (16, 20, 4)])
def test_knn_model_matches_jax(rng, nside, k, K):
    """A ``HealpyGCNN(graph_method="knn")``: the same layout plan as the
    JAX model, logits of an eval forward (2e-5), and the loss and the
    gradient tree of a training forward (1e-4) against the JAX model with
    the same variables.  At k=8, nside 16, K=3 conv 1 runs in cface on the
    deep stencil (h=4) with its corner correction (360 rows); at k=20 the
    convs run
    per step on the radius-3 capture window.  The loss of the training
    forward is held to 1e-4, as the gradients: batch norm on the batch
    statistics of two maps moves it more than a conv does."""
    npix = 12 * nside * nside
    jm = ds.HealpyGCNN(nside, np.arange(npix), _knn_layers(jhp, K),
                       n_neighbors=k, graph_method="knn")
    tm = dt.HealpyGCNN(nside, np.arange(npix), _knn_layers(thp, K),
                       n_neighbors=k, graph_method="knn")
    plan = [type(m).__name__ for m in tm._module_layers]
    assert plan == [type(m).__name__ for m in jm._module_layers]
    assert ("NestToCface" in plan) == (k == 8)
    for m in (jm, tm):
        assert all(g.method == "knn" for g in m.graphs.values())
    x = rng.normal(size=(2, npix, 1)).astype(np.float32)
    v = jm.init(0, jnp.asarray(x))
    vv = jax.tree_util.tree_map(
        np.array, {key: v[key] for key in ("params", "batch_stats")})
    for sub in jax.tree_util.tree_leaves(vv["batch_stats"],
                                         is_leaf=lambda d: "mean" in d):
        sub["mean"] = rng.normal(scale=0.3, size=sub["mean"].shape).astype(np.float32)
        sub["var"] = rng.uniform(0.5, 2.0, size=sub["var"].shape).astype(np.float32)
    static = {key: v[key] for key in v if key not in ("params", "batch_stats")}
    want = np.asarray(jm.module.apply({**static, **vv}, jnp.asarray(x)))
    tm.build(x.shape, device="cpu")
    load_jax_variables(tm, vv)
    assert _rel(tm.predict(x, batch_size=2), want) <= FWD_TOL

    def jloss(p):
        out = jm.module.apply({**static, "params": p,
                               "batch_stats": vv["batch_stats"]},
                              jnp.asarray(x), training=True,
                              mutable=["batch_stats"])[0]
        return jnp.sum(out ** 2)

    l_j, g_j = jax.value_and_grad(jloss)(vv["params"])
    tm.train()
    l_t = (tm(torch.from_numpy(x)) ** 2).sum()
    l_t.backward()
    # batch norm on batch statistics (float32 one-pass variance over two
    # maps) moves a training forward by more than a conv: 1e-4, as the
    # gradients
    assert _rel(float(l_t.detach()), float(l_j)) <= GRAD_TOL
    g_t = export_jax_variables(tm, grads=True)
    flat_t = jax.tree_util.tree_leaves_with_path(g_t)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, g_j)))
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_t:
        assert _rel(leaf, flat_j[path]) <= GRAD_TOL, path


@pytest.mark.parametrize("k", [8, 20, 40, 60])
def test_auto_takes_the_grid_for_every_supported_k(k):
    """``graph_method="auto"`` takes the grid graph where a template exists
    (every k the model accepts), as the JAX model does; ``"knn"`` the
    reference's kNN graph."""
    from deepsphere_tpu.graph.laplacian import GRID_RADIUS as J_GRID
    from deepsphere_tpu_torch.graph.laplacian import GRID_RADIUS

    assert GRID_RADIUS == J_GRID and k in GRID_RADIUS
    npix = 12 * 8 * 8
    layers = lambda m: [m.HealpyChebyshev(K=2, Fout=2), m.Flatten(),
                        m.Dense(2)]
    for method, want in (("auto", "grid"), ("knn", "knn")):
        tm = dt.HealpyGCNN(8, np.arange(npix), layers(thp), n_neighbors=k,
                           graph_method=method)
        assert [g.method for g in tm.graphs.values()] == [want]
