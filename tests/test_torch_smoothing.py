"""PyTorch port, Gaussian smoothing, against the JAX package on the CPU.

* The host half: the template ELLPACK of the stencil decomposition
  (bit-equal, native and numpy), the decomposition itself, and the exact
  kernel built with ``scipy.spatial.cKDTree`` against the JAX package's
  sklearn ``BallTree`` build.  HEALPix's symmetries make many pixels
  equidistant, and a row's k-th neighbour often ties with the (k+1)-th:
  there the two builds may keep different, equally distant pixels
  (BallTree's pick follows its tree traversal; the port takes the lowest
  pixel index).  The test names those rows and checks that every pixel
  in which the two sets differ lies at the k-th distance; all other rows
  agree to 1e-6.  Where the JAX side's result depends on the neighbour
  sets (``estimate_stencil_error``, the ELLPACK layer), it is also run
  with the port's sets in place of BallTree's and held to 1e-6 / 1e-5.
* ``HealpySmoothing``: both methods, full sphere and masked, per-channel
  repetitions, one pass per application (the operator's) and the whole
  chain in one pass (``_with_apps``, m_total), outputs to 1e-5 of their max
  and gradients against ``jax.grad`` of the JAX layer to 1e-5; the
  gradient is S^T dy (a symmetric backward would give S dy).
* the three constructor styles and their errors, a deferred smoothing
  inside a model, and the port's modules importing without jax, flax,
  sklearn or the JAX package.
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
import deepsphere_tpu.nn.smoothing as jsm
import deepsphere_tpu_torch as dt
import deepsphere_tpu_torch.nn.smoothing as tsm
from deepsphere_tpu.nn import healpy_layers as jhp
from deepsphere_tpu_torch.nn import healpy_layers as thp
from deepsphere_tpu_torch.ops import _cuda
from deepsphere_tpu_torch.sphere import healpix as hp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _res_arcmin(nside):
    return np.degrees(hp.nside2resol(nside)) * 60


def _cap(nside, z=0.3):
    """A polar cap of NEST pixels (a contiguous masked sky)."""
    vec = np.asarray(hp.pix2vec(nside, np.arange(12 * nside * nside),
                                nest=True))
    return np.where(vec[:, 2] > z)[0]


def _port_sets_balltree(nside, pix, nest=True):
    """A stand-in for sklearn's ``BallTree`` that returns the port's
    neighbour sets (:func:`tsm._gauss_neighbours`) for ``pix``: the JAX
    package's builds then see the same neighbours as the port's."""

    class PortSets:
        def __init__(self, theta, metric):
            assert metric == "haversine" and len(theta) == len(pix)

        def query_radius(self, theta, r, count_only):
            self.nb = tsm._gauss_neighbours(nside, pix, nest, r)
            return np.full(len(pix), self.nb[0].shape[1])

        def query(self, theta, k, sort_results=True):
            assert k == self.nb[0].shape[1]
            return self.nb

    return PortSets


# ---------------------------------------------------------------------------
# the host half
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nside,mult,masked", [(8, 2.0, False), (16, 1.5, True),
                                               (16, 4.0, False)])
def test_template_ellpack_is_bit_equal(nside, mult, masked):
    """The template of one repetition, from the native core and from numpy,
    bit-equal to the JAX package's."""
    sig_rad = np.radians(_res_arcmin(nside) * mult / 60)
    m, sig, r = tsm._stencil_decomposition(sig_rad, hp.nside2resol(nside), 3)
    assert (m, sig, r) == jsm._stencil_decomposition(
        sig_rad, hp.nside2resol(nside), 3)
    ind = _cap(nside) if masked else None
    for port, ref in ((tsm._template_ellpack, jsm._template_ellpack),
                      (tsm._template_ellpack_numpy,
                       jsm._template_ellpack_numpy)):
        ti, tv = port(nside, sig, r, 3, ind)
        ji, jv = ref(nside, sig, r, 3, ind)
        assert np.array_equal(ti, ji) and np.array_equal(tv, jv)


def _balltree_kernel(nside, pix, sigma_rad):
    """The JAX package's exact-kernel neighbours (sklearn BallTree)."""
    lon, lat = hp.pix2ang(nside, pix, nest=True, lonlat=True)
    theta = np.stack([np.radians(lat), np.radians(lon)], axis=1)
    tree = sklearn.neighbors.BallTree(theta, metric="haversine")
    k = int(np.max(tree.query_radius(theta, r=3 * sigma_rad,
                                     count_only=True)))
    return tree.query(theta, k=min(k, len(pix)), sort_results=True)


# (nside, sigma in pixel scales, masked): 9 to 60 neighbours
_KERNELS = [(8, 0.7, False), (8, 1.0, True), (16, 1.0, False),
            (16, 1.4, False)]


@pytest.mark.parametrize("nside,mult,masked", _KERNELS)
def test_exact_kernel_matches_balltree(nside, mult, masked):
    """The cKDTree operator against the BallTree one, as scipy sparse
    matrices: k equal, every row that keeps the same neighbours within
    1e-6, and every row that does not a tie at its k-th distance."""
    pix = _cap(nside, -0.2) if masked else np.arange(12 * nside * nside)
    sigma = _res_arcmin(nside) * mult
    op = tsm.SmoothingOperator(nside=nside, indices=pix, sigma=sigma,
                               method="ellpack")
    jop = jsm.SmoothingOperator(nside=nside, indices=pix, sigma=sigma,
                                method="ellpack")
    N, k = jop.ell_idx.shape
    assert op.ell_idx.shape == (N, k) and 8 <= k <= 60

    def mat(o):
        rows = np.repeat(np.arange(N), k)
        return sp.csr_matrix((o.ell_val.ravel().astype(np.float64),
                              (rows, o.ell_idx.ravel())), shape=(N, N))

    A, J = mat(op), mat(jop)
    dist, _ = _balltree_kernel(nside, pix, np.radians(sigma / 60))
    ang, inds = tsm._gauss_neighbours(nside, pix, True,
                                      3 * np.radians(sigma / 60))
    same = np.array([set(a) == set(b) for a, b in zip(op.ell_idx,
                                                      jop.ell_idx)])
    tied = np.flatnonzero(~same)
    # every differing row: the symmetric difference of its two sets lies at
    # the row's k-th distance (equal to 1e-12 rad), and the port kept the
    # lowest pixel indices among the tied candidates
    for r in tied:
        kth = dist[r, -1]
        diff = set(op.ell_idx[r]) ^ set(jop.ell_idx[r])
        full = np.sort(np.arccos(np.clip(
            np.asarray(hp.pix2vec(nside, pix[list(diff)], nest=True))
            @ np.asarray(hp.pix2vec(nside, pix[r], nest=True)), -1, 1)))
        assert np.all(np.abs(full - kth) < 1e-6), (r, full, kth)
        at_k = np.abs(ang[r] - ang[r, -1]) < 1e-12
        ours = set(inds[r][at_k])
        theirs_pool = ours | diff
        assert ours == set(sorted(theirs_pool)[:len(ours)]), r
    print(f"nside {nside}, k={k}: {len(tied)} of {N} rows tie at the k-th "
          f"distance and keep other, equally distant pixels: rows "
          f"{tied[:12].tolist()}{' ...' if len(tied) > 12 else ''}")
    assert len(tied) < N // 2
    Ad, Jd = A[same].toarray(), J[same].toarray()
    assert np.abs(Ad - Jd).max() <= 1e-6
    # a tie row's weights are the same numbers, on other columns
    np.testing.assert_allclose(np.sort(op.ell_val[tied], 1),
                               np.sort(jop.ell_val[tied], 1), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("nside,mult", [(16, 2.0), (64, 4.0)])
def test_estimate_stencil_error_matches_jax(nside, mult, monkeypatch):
    """The proxy estimate, to 1e-6 of the JAX package's on the same
    neighbour sets; with BallTree's own (other pixels at tied distances)
    within 1% of it."""
    sig = np.radians(_res_arcmin(nside) * mult / 60)
    got = tsm.estimate_stencil_error(sig, nside)
    own = jsm.estimate_stencil_error(sig, nside)
    assert abs(got - own) <= 1e-2 * own
    monkeypatch.setattr(sklearn.neighbors, "BallTree",
                        _port_sets_balltree(16, np.arange(12 * 16 * 16)))
    want = jsm.estimate_stencil_error(sig, nside)
    assert abs(got - want) <= 1e-6 * want, (got, want)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

# (label, nside, sigma in pixel scales (a list: per-channel scales), method,
# masked)
_LAYERS = [
    ("stencil", 16, 2.0, "stencil", False),
    ("stencil masked", 16, 2.0, "stencil", True),
    ("stencil per-channel", 16, [1.0, 1.5, 2.0], "stencil", False),
    ("stencil per step (nside 4)", 4, 0.5, "stencil", False),
    ("ellpack", 16, 1.0, "ellpack", False),
    ("ellpack masked per-channel", 16, [0.7, 1.0], "ellpack", True),
]


def _jax_layer(nside, pix, sigma, method, x, monkeypatch):
    """The JAX layer's output and jax.grad of sum(sin(y)) * w."""
    if method == "ellpack":
        monkeypatch.setattr(sklearn.neighbors, "BallTree",
                            _port_sets_balltree(nside, pix))
    jop = jsm.SmoothingOperator(nside=nside, indices=pix, sigma=sigma,
                                method=method)
    monkeypatch.undo()
    lay = jsm.HealpySmoothing(operator=jop)
    v = lay.init(jax.random.PRNGKey(0), jnp.asarray(x))
    w = jnp.asarray(np.random.RandomState(2).normal(size=x.shape), jnp.float32)

    def loss(a):
        return jnp.sum(jnp.sin(lay.apply(v, a)) * w)

    y = lay.apply(v, jnp.asarray(x))
    return jop, np.asarray(y), np.asarray(jax.grad(loss)(jnp.asarray(x))), w


@pytest.mark.parametrize("label,nside,mult,method,masked", _LAYERS,
                         ids=[c[0] for c in _LAYERS])
def test_layer_matches_jax(label, nside, mult, method, masked, monkeypatch):
    pix = _cap(nside) if masked else np.arange(12 * nside * nside)
    sigma = ([_res_arcmin(nside) * m for m in mult] if isinstance(mult, list)
             else _res_arcmin(nside) * mult)
    C = len(mult) if isinstance(mult, list) else 2
    x = np.random.RandomState(1).normal(size=(2, len(pix), C)).astype(np.float32)
    jop, y_j, g_j, w = _jax_layer(nside, pix, sigma, method, x, monkeypatch)
    op1 = tsm.SmoothingOperator(nside=nside, indices=pix, sigma=sigma,
                                method=method)
    ops = [op1]
    if method == "stencil":
        assert op1.stencil_apps == 1
        reps = jop.per_channel_repetitions
        m_total = jop.stencil_reps * (1 if reps is None else int(max(reps)))
        if m_total > 1:
            ops.append(tsm._with_apps(op1, m_total))
    for op in ops:
        assert (op.stencil is None) == (jop.stencil is None)
        if op.stencil is not None:
            assert op.stencil_reps == jop.stencil_reps
            assert op.stencil.radius == jop.stencil.radius
            assert op.stencil.n_steps == op.stencil.radius * op.stencil_apps
        else:
            assert np.array_equal(op.ell_idx, jop.ell_idx)
        layer = thp.HealpySmoothing(operator=op)
        xt = torch.from_numpy(x).requires_grad_()
        _cuda.reset_launch_counts()
        y = layer(xt)
        (torch.sin(y) * torch.from_numpy(np.array(w))).sum().backward()
        if method == "stencil":
            route = "smooth_per_step" if nside < 8 else "smooth_fused"
            assert _cuda.route_counts[route] == 1, _cuda.route_counts
        assert not any(_cuda.launch_counts.values())
        assert list(layer.state_dict()) == []
        _close(y.detach(), y_j)
        _close(xt.grad, g_j)


def test_gradient_is_the_transpose():
    """S is row-normalised, not symmetric: the gradient of <w, S^m x> is
    (S^m)^T w, held to S^m built in float64 from the template's ELLPACK
    (scipy sparse) at 1e-5; S^m w, what a symmetric backward (the fused
    conv's) would give, is far from it."""
    nside = 8
    npix = 12 * nside * nside
    sigma = _res_arcmin(nside) * 2.0
    op = tsm.SmoothingOperator(nside=nside, indices=np.arange(npix),
                               sigma=sigma, method="stencil")
    m, sig, r = tsm._stencil_decomposition(
        np.radians(sigma / 60), hp.nside2resol(nside), 3)
    assert op.stencil_reps == m > 1
    idx, val = tsm._template_ellpack(nside, sig, r, 3)
    T = sp.csr_matrix((val.ravel(), (np.repeat(np.arange(npix), idx.shape[1]),
                                     idx.ravel())), shape=(npix, npix))
    S = np.linalg.matrix_power(T.toarray(), m)  # y = S x, NEST rows
    assert np.abs(S - S.T).max() > 1e-3 * np.abs(S).max()
    w = np.random.RandomState(4).normal(size=npix)
    layer = thp.HealpySmoothing(operator=op)
    x = torch.from_numpy(np.random.RandomState(5).normal(
        size=(1, npix, 1)).astype(np.float32)).requires_grad_()
    y = layer(x)
    _close(y.detach()[0, :, 0].double(), S @ x.detach()[0, :, 0].double().numpy())
    (y[0, :, 0] * torch.from_numpy(w).float()).sum().backward()
    g = x.grad[0, :, 0].double().numpy()
    _close(g, S.T @ w)
    sym = S @ w
    assert np.abs(g - sym).max() > 1e-3 * np.abs(sym).max()


def test_constant_map_stays_constant_and_identity():
    nside = 16
    npix = 12 * nside * nside
    op = tsm.SmoothingOperator(nside=nside, indices=np.arange(npix),
                               sigma=_res_arcmin(nside) * 2.0,
                               method="stencil")
    y = thp.HealpySmoothing(operator=op)(torch.full((1, npix, 1), 3.0))
    assert torch.allclose(y, torch.full_like(y, 3.0), rtol=0, atol=3e-6)
    ident = thp.HealpySmoothing(nside=nside, indices=np.arange(npix),
                                sigma=0.0)
    x = torch.randn(2, npix, 1)
    assert ident(x) is x


def test_constructor_styles_and_errors():
    """The factory's three styles and its errors, word for word the JAX
    package's; a wrong pixel count and per-channel length raise."""
    nside = 8
    npix = 12 * nside * nside

    def err(mod, **kw):
        with pytest.raises(Exception) as e:
            mod.HealpySmoothing(**kw)
        return type(e.value).__name__, str(e.value)

    op = tsm.SmoothingOperator(nside=nside, indices=np.arange(npix),
                               sigma=200.0)
    jop = jsm.SmoothingOperator(nside=nside, indices=np.arange(npix),
                                sigma=200.0)
    for kw_t, kw_j in (({"operator": op, "sigma": 1.0},
                        {"operator": jop, "sigma": 1.0}),
                       ({"nside": nside, "sigma": 1.0},
                        {"nside": nside, "sigma": 1.0})):
        assert err(thp, **kw_t) == err(jhp, **kw_j)
    assert isinstance(thp.HealpySmoothing(sigma=200.0), thp._DeferredSmoothing)
    assert thp.HealpySmoothing(sigma=200.0).needs == "res"
    layer = thp.HealpySmoothing(operator=op)
    with pytest.raises(ValueError, match="operator expects 768"):
        layer(torch.zeros(1, 700, 1))
    op3 = tsm.SmoothingOperator(nside=nside, indices=np.arange(npix),
                                sigma=200.0, per_channel_repetitions=[1, 2])
    with pytest.raises(AssertionError, match="has to have length 3"):
        thp.HealpySmoothing(operator=op3)(torch.zeros(1, npix, 3))


def test_deferred_smoothing_in_a_model_matches_jax():
    """A deferred ``HealpySmoothing`` after a pool takes the pool's nside
    (no graph), before a conv; the model's output against the JAX model
    with the same weights."""
    from deepsphere_tpu_torch.interop import load_jax_variables

    nside = 16
    npix = 12 * nside * nside

    def layers(m):
        return [m.HealpyPool(p=1),
                m.HealpySmoothing(sigma=_res_arcmin(8) * 1.5, method="stencil"),
                m.HealpyChebyshev(K=3, Fout=3), m.Flatten(), m.Dense(2)]

    x = np.random.RandomState(6).normal(size=(2, npix, 1)).astype(np.float32)
    jm = ds.HealpyGCNN(nside, np.arange(npix), layers(jhp))
    v = jm.init(0, jnp.asarray(x))
    y_j = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = dt.HealpyGCNN(nside, np.arange(npix), layers(thp))
    tm.build(x.shape, device="cpu")
    sm = tm.layers_use[1]
    assert isinstance(sm, tsm.HealpySmoothing) and sm.operator.nside == 8
    assert tm.layer_names[1] == "healpy_smoothing"
    load_jax_variables(tm, jax.tree_util.tree_map(
        np.asarray, {"params": v["params"]}))
    _close(tm.predict(x, batch_size=2), y_j)


def test_port_imports_no_jax_flax_or_sklearn():
    """In a fresh interpreter where jax, flax, sklearn and the JAX package
    cannot be imported, every module of the port imports, and a smoothing
    layer (both methods) and a model with both attention layers run on
    the CPU."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "flax", "sklearn", "deepsphere_tpu"):
            sys.modules[name] = None
        import numpy as np, torch
        import deepsphere_tpu_torch as dt
        for m in pkgutil.walk_packages(dt.__path__, "deepsphere_tpu_torch."):
            importlib.import_module(m.name)
        from deepsphere_tpu_torch.nn import healpy_layers as hp
        npix = 12 * 8 * 8
        x = torch.randn(2, npix, 1)
        for method in ("stencil", "ellpack"):
            y = hp.HealpySmoothing(nside=8, indices=np.arange(npix),
                                   sigma=800.0, method=method)(x)
            assert y.shape == x.shape and torch.isfinite(y).all()
        m = dt.HealpyGCNN(8, np.arange(npix), [
            hp.Healpy_ViT(p=2, key_dim=4, num_heads=2),
            hp.HealpyPseudoConv_Transpose(p=2, Fout=2),
            hp.Healpy_Transformer(key_dim=4, num_heads=2),
            hp.Flatten(), hp.Dense(3)]).build((2, npix, 1), device="cpu")
        assert m.predict(x.numpy()).shape == (2, 3)
        assert not any(k.split(".")[0] in ("jax", "flax", "sklearn",
                                           "deepsphere_tpu")
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
