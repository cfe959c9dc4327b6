"""PyTorch port, visualization: projections, filter banks and the model's
filter methods, against the JAX package on the CPU.

Mirrors ``tests/test_viz.py`` case for case (every projection, view and
plot executed under matplotlib's Agg backend and saved, the numeric
checks of the projection grids and of the localized filters), and holds
the port to the JAX package: the projections' pixel maps exactly, a
filter bank's ``localize`` and ``evaluate`` on the same coefficients to
1e-5 of their max (stencil and ELLPACK bases, the three kinds), and a
model's ``get_filters`` on variables carried over from the JAX model.
"""

import matplotlib

matplotlib.use("Agg")

import jax
import numpy as np
import pytest
import torch

import deepsphere_tpu as ds
import deepsphere_tpu.viz as jviz
from deepsphere_tpu.graph import build_sphere_graph as j_build
from deepsphere_tpu.nn import healpy_layers as jhp
from deepsphere_tpu_torch import HealpyGCNN
from deepsphere_tpu_torch.graph import build_sphere_graph
from deepsphere_tpu_torch.interop import load_jax_variables
from deepsphere_tpu_torch.nn import healpy_layers as hp_nn
from deepsphere_tpu_torch.ops import spmv
from deepsphere_tpu_torch.sphere import healpix as hp
from deepsphere_tpu_torch.viz import (
    SphericalFilterBank,
    get_index_equator,
    gnomonic_pixels,
    gnomview,
    mollview,
    mollweide_pixels,
    plot_filters_gnomonic,
    plot_filters_section,
)

TOL = 1e-5


def _save(fig, tmp_path, name):
    import matplotlib.pyplot as plt

    fig.savefig(tmp_path / name)
    plt.close("all")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def test_gnomonic_center_pixel():
    nside = 16
    resol = hp.nside2resol(nside)
    reso = hp.nside2resol(nside, arcmin=True) / 2  # grid spans ~5 pixels
    for lon, lat in [(0.0, 0.0), (45.0, 30.0), (180.0, -60.0)]:
        grid = gnomonic_pixels(nside, rot=(lon, lat), reso=reso, xsize=21)
        vec_c = np.array([
            np.cos(np.deg2rad(lat)) * np.cos(np.deg2rad(lon)),
            np.cos(np.deg2rad(lat)) * np.sin(np.deg2rad(lon)),
            np.sin(np.deg2rad(lat)),
        ])
        vec_p = hp.pix2vec(nside, grid[10, 10], nest=True)
        ang = np.arccos(np.clip(vec_p @ vec_c, -1, 1))
        assert ang < 1.5 * resol
        assert len(np.unique(grid)) >= 9


def test_mollweide_covers_sphere():
    nside = 8
    grid, ok = mollweide_pixels(nside, xsize=400)
    assert ok.sum() > 0.7 * ok.size * 0.78  # ellipse area fraction ~ pi/4
    seen = np.unique(grid[ok])
    assert len(seen) == hp.nside2npix(nside)  # every pixel rendered


@pytest.mark.parametrize("nside,rot,reso,xsize,nest", [
    (16, (0.0, 0.0), 10.0, 41, True),
    (16, (45.0, 30.0), 3.0, 64, True),
    (8, (180.0, -60.0), 25.0, 33, False),
    (32, (300.0, 89.0), 5.0, 50, True),
])
def test_projection_pixels_match_jax(nside, rot, reso, xsize, nest):
    """The gnomonic and Mollweide pixel maps equal the JAX package's."""
    got = gnomonic_pixels(nside, rot=rot, reso=reso, xsize=xsize, nest=nest)
    want = jviz.gnomonic_pixels(nside, rot=rot, reso=reso, xsize=xsize,
                                nest=nest)
    assert np.array_equal(got, want)
    for a, b in zip(mollweide_pixels(nside, xsize=4 * xsize, nest=nest),
                    jviz.mollweide_pixels(nside, xsize=4 * xsize, nest=nest)):
        assert np.array_equal(a, b)


def test_view_functions_smoke(rng, tmp_path):
    nside = 8
    m = rng.normal(size=hp.nside2npix(nside))
    import matplotlib.pyplot as plt

    fig = plt.figure()
    mollview(m, fig=fig, title="mollview")
    _save(fig, tmp_path, "mollview.png")
    fig = plt.figure()
    gnomview(m, fig=fig, rot=(10, 20), title="gnomview", graticule=True)
    _save(fig, tmp_path, "gnomview.png")


# ---------------------------------------------------------------------------
# equator indices (parity with plot.py:126-140)
# ---------------------------------------------------------------------------

def test_get_index_equator():
    nside = 8
    radius = 5
    idx, center = get_index_equator(nside, radius)
    assert len(idx) == 2 * radius + 1
    assert center == idx[radius]
    theta = hp.pix2ang(nside, idx, nest=True)[0]
    assert np.all(np.abs(theta - np.pi / 2) < 0.2)
    j_idx, j_center = jviz.get_index_equator(nside, radius)
    assert np.array_equal(idx, j_idx) and center == j_center


# ---------------------------------------------------------------------------
# filter banks
# ---------------------------------------------------------------------------

def test_localize_matches_basis(rng):
    nside = 8
    g = build_sphere_graph(nside, k=8, method="grid")
    K, Fin, Fout = 4, 2, 3
    coeffs = rng.normal(size=(K, Fout, Fin)).astype(np.float32)
    bank = SphericalFilterBank(g, coeffs, kind="cheby", device="cpu")
    ind = 37
    maps = bank.localize(ind)
    assert maps.shape == (Fin, Fout, g.n_pixels)

    # direct check: sum_k c_k T_k(L) delta
    delta = np.zeros((g.n_pixels, 1), np.float32)
    delta[ind] = 1.0
    idx, val = g.ellpack(0.75)
    tx = spmv.chebyshev_basis(torch.from_numpy(idx).long(),
                              torch.from_numpy(val),
                              torch.from_numpy(delta), K)[:, :, 0].numpy()
    for fi in range(Fin):
        for fo in range(Fout):
            expect = np.einsum("k,km->m", coeffs[:, fo, fi], tx)
            np.testing.assert_allclose(maps[fi, fo], expect, atol=1e-5)


def test_evaluate_chebyshev():
    g = build_sphere_graph(4, k=8, method="grid")
    coeffs = np.zeros((3, 1, 1), np.float32)
    coeffs[2] = 1.0
    bank = SphericalFilterBank(g, coeffs, kind="cheby", device="cpu")
    x = np.linspace(-0.75, 0.75, 7)
    resp = bank.evaluate(x / 0.75)
    np.testing.assert_allclose(resp[0, 0], 2 * (x / 0.75) ** 2 - 1, atol=1e-6)


@pytest.mark.parametrize("kind,custom", [("cheby", False), ("mono", False),
                                         ("bern", False), ("cheby", True)])
def test_bank_matches_jax(rng, kind, custom):
    """``localize`` (a list of pixels and one pixel) and ``evaluate`` on the
    same coefficients as the JAX bank: the stencil basis of a grid graph,
    and the ELLPACK basis of a graph given by its Laplacian (the port's
    kNN Laplacian, the same matrix on both sides; no stencil)."""
    nside = 8
    g = build_sphere_graph(nside, k=8, method="grid")
    gj = j_build(nside, k=8, method="grid")
    if custom:
        from deepsphere_tpu.graph import graph_from_laplacian as j_from
        from deepsphere_tpu_torch.graph import graph_from_laplacian

        knn = build_sphere_graph(nside, k=8, method="knn")
        g = graph_from_laplacian(knn.L, lmax=knn.lmax, nside=nside)
        gj = j_from(knn.L, lmax=knn.lmax, nside=nside)
    assert (g.face_stencil(0.75) is None) == custom
    coeffs = rng.normal(size=(4, 3, 2)).astype(np.float32)
    bank = SphericalFilterBank(g, coeffs, kind=kind, device="cpu")
    jbank = jviz.SphericalFilterBank(gj, coeffs, kind=kind)
    assert (bank.K, bank.n_filters, bank.n_features_in,
            bank.n_features_out, bank.scale) == (
        jbank.K, jbank.n_filters, jbank.n_features_in,
        jbank.n_features_out, jbank.scale)
    pix = [0, 100, 200]
    assert _rel(bank.localize(pix), jbank.localize(pix)) <= TOL
    assert _rel(bank.localize(37), jbank.localize(37)) <= TOL
    x = np.linspace(-1, 1, 9)
    assert _rel(bank.evaluate(x), jbank.evaluate(x)) <= TOL


def test_bank_without_a_card_raises():
    g = build_sphere_graph(4, k=8, method="grid")
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SphericalFilterBank(g, np.zeros((2, 1, 1)))


def test_filter_plots_smoke(rng, tmp_path):
    g = build_sphere_graph(8, k=8, method="grid")
    coeffs = rng.normal(size=(4, 2, 2)).astype(np.float32)
    bank = SphericalFilterBank(g, coeffs, device="cpu")
    _save(plot_filters_gnomonic(bank, order=4, ind=100), tmp_path,
          "filters_gnomonic.png")
    _save(plot_filters_section(bank, order=4), tmp_path,
          "filters_section.png")


# ---------------------------------------------------------------------------
# model filter and plot methods (parity with tests/test_healpy_networks.py)
# ---------------------------------------------------------------------------

def _model_layers(m):
    return [
        m.HealpyChebyshev(K=4, Fout=3, activation="relu"),
        m.Healpy_ResidualLayer("CHEBY", {"K": 3}, activation="relu"),
        m.HealpyPool(p=1),
        m.Flatten(),
        m.Dense(2),
    ]


@pytest.fixture(scope="module")
def built_models():
    """The JAX model and the port model of the same layers, the port's
    variables carried over from the JAX model's."""
    nside = 8
    npix = hp.nside2npix(nside)
    jm = ds.HealpyGCNN(nside=nside, indices=np.arange(npix),
                       layers=_model_layers(jhp))
    jm.build((2, npix, 1))
    tm = HealpyGCNN(nside=nside, indices=np.arange(npix),
                    layers=_model_layers(hp_nn))
    tm.build((2, npix, 1), device="cpu")
    load_jax_variables(tm, jax.tree_util.tree_map(
        np.asarray, {k: jm.variables[k] for k in ("params", "batch_stats")
                     if k in jm.variables}))
    return jm, tm


def test_model_get_filters(built_models):
    jm, model = built_models
    banks = model.get_filters(0)
    assert len(banks) == 1 and banks[0].coeffs.shape == (4, 3, 1)
    assert banks[0].device == torch.device("cpu")
    banks = model.get_filters(1)  # residual -> two banks
    assert len(banks) == 2 and banks[0].coeffs.shape == (3, 3, 3)
    weights = model.get_filters(0, return_weights=True)
    assert weights[0].shape == (4, 3, 1)
    with pytest.raises(ValueError):
        model.get_filters(2)  # pool layer
    assert model.get_gsp_filters(0)[0].coeffs.shape == (4, 3, 1)


@pytest.mark.parametrize("layer,ind_in,ind_out", [
    (0, None, None), ("chebyshev", None, [0, 2]), (1, 1, None)])
def test_model_filters_match_jax(built_models, layer, ind_in, ind_out):
    """Coefficients, impulse responses and spectra of the port model's
    filters against the JAX model's, and the error strings of a bad
    layer spec."""
    jm, tm = built_models
    got = tm.get_filters(layer, ind_in, ind_out)
    want = jm.get_filters(layer, ind_in, ind_out)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a.coeffs, b.coeffs)
        assert _rel(a.localize([0, 100, 500]), b.localize([0, 100, 500])) <= TOL
        x = np.linspace(-0.75, 0.75, 11)
        assert _rel(a.evaluate(x), b.evaluate(x)) <= TOL
    for bad in (2, "nope", 1.5):
        with pytest.raises(ValueError) as e_t:
            tm.get_filters(bad)
        with pytest.raises(ValueError) as e_j:
            jm.get_filters(bad)
        assert str(e_t.value) == str(e_j.value)


def test_model_plot_methods(built_models, tmp_path):
    _, model = built_models
    ax = model.plot_chebyshev_coeffs(0)
    _save(ax.figure, tmp_path, "model_cheby_coeffs.png")
    ax = model.plot_filters_spectral(0)
    _save(ax.figure, tmp_path, "model_filters_spectral.png")
    figs = model.plot_filters_section(0)
    _save(figs[0], tmp_path, "model_filters_section.png")
    figs = model.plot_filters_gnomonic(1)  # residual: two figures
    assert len(figs) == 2
    _save(figs[0], tmp_path, "model_filters_gnomonic.png")


def test_model_filters_need_a_build():
    npix = hp.nside2npix(4)
    m = HealpyGCNN(nside=4, indices=np.arange(npix), layers=[
        hp_nn.HealpyChebyshev(K=3, Fout=2), hp_nn.Flatten(), hp_nn.Dense(2)])
    with pytest.raises(ValueError, match="Build the model first"):
        m.get_filters(0)
