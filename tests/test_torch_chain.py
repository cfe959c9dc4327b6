"""PyTorch port, the lap chain: a polynomial graph conv as one fused L~
application per launch on the shallow stencil (h = radius), the recursion
and the channel contraction between the launches.

The same seeded numpy inputs go through the JAX package's functions (its
Pallas kernels in interpret mode, as ``tests/test_pallas.py`` runs them)
and the port's (the kernels' plain versions on the CPU).  Tolerance: 1e-5
of the JAX result's max, forward and gradients (float32 on both sides,
sums in another order).  The routes are pure Python, checked against an
H100's 132 SMs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepsphere_tpu.config as jcfg
import deepsphere_tpu.graph as jgraph
import deepsphere_tpu.ops.stencil as jstencil
import deepsphere_tpu_torch as dt
import deepsphere_tpu_torch.graph as tgraph
import deepsphere_tpu_torch.nn.layers as tl
import deepsphere_tpu_torch.ops.stencil as tstencil
from deepsphere_tpu_torch import config
from deepsphere_tpu_torch.nn import healpy_layers as thp
from deepsphere_tpu_torch.ops import _cuda
from deepsphere_tpu_torch.ops import fused_stencil as tfs

TOL = 1e-5
_H100_SMS = 132

_GRAPHS = {}
_JAX = {}


@pytest.fixture(autouse=True)
def _pallas_on():
    """The JAX package's fused conv in interpret mode, and the port's
    defaults restored after each test."""
    jcfg.set_use_pallas("on")
    _cuda.reset_launch_counts()
    yield
    jcfg.set_use_pallas("auto")
    config.set_fused_dw(True)


def _graphs(n, k):
    if (n, k) not in _GRAPHS:
        _GRAPHS[n, k] = (jgraph.build_sphere_graph(n, k=k, method="grid"),
                         tgraph.build_sphere_graph(n, k=k, method="grid"))
    return _GRAPHS[n, k]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


# (kind, K, layout) of the k=40 (radius 3) chain at nside 16
_CHAIN_CASES = [("cheby", 3, "nest"), ("cheby", 4, "face"), ("mono", 4, "nest")]


def _chain_case(kind, K, layout):
    """Inputs, and the JAX package's lap chain: y and the gradients of a
    fixed cotangent with respect to x and the kernel."""
    key = (kind, K, layout)
    if key not in _JAX:
        gj, gt = _graphs(16, 40)
        sj, st = gj.face_stencil(0.75), gt.face_stencil(0.75)
        assert st.radius == st.n_steps == 3
        assert jstencil.lap_chain_available(sj, kind, K)
        rng = np.random.RandomState(7)
        B, Fin, Fout = 2, 2, 3
        x = rng.normal(size=(B, 12 * 16 * 16, Fin)).astype(np.float32)
        kern = (rng.normal(size=(Fin * K, Fout)) * 0.3).astype(np.float32)
        cot = rng.normal(size=(B, 12 * 16 * 16, Fout)).astype(np.float32)
        y, vjp = jax.vjp(
            lambda a, w: jstencil.lap_chain_conv(sj, a, w, K, kind,
                                                 layout=layout),
            jnp.asarray(x), jnp.asarray(kern))
        dx, dk = vjp(jnp.asarray(cot))
        _JAX[key] = (st, x, kern, cot,
                     (np.asarray(y), np.asarray(dx), np.asarray(dk)))
    return _JAX[key]


@pytest.mark.parametrize("fused_dw", [True, False])
@pytest.mark.parametrize("case", _CHAIN_CASES,
                         ids=["-".join(map(str, c)) for c in _CHAIN_CASES])
def test_lap_chain_matches_jax(case, fused_dw):
    """The port's ``lap_chain_conv`` on the k=40 grid graph at nside 16,
    forward and the gradients of a fixed cotangent on either backward
    route, against the JAX package's ``lap_chain_conv``."""
    kind, K, layout = case
    st, x, kern, cot, (y_j, dx_j, dk_j) = _chain_case(*case)
    assert tstencil.lap_chain_available(st, kind, K)
    config.set_fused_dw(fused_dw)
    xt = _t(x).requires_grad_()
    kt = _t(kern).requires_grad_()
    y = tstencil.lap_chain_conv(st, xt, kt, K, kind, layout=layout)
    dx, dk = torch.autograd.grad(y, (xt, kt), _t(cot))
    assert all(v == 0 for v in _cuda.launch_counts.values())
    _close(y.detach(), y_j)
    _close(dx, dx_j)
    _close(dk, dk_j)


def test_stencil_conv_takes_the_chain_only_on_the_card():
    """``conv_route``: the chain for a CUDA input of a radius >= 3 conv of
    K > 2 on its shallow stencil, as the JAX package chains its kernel on
    a TPU; the per-step path on the CPU, at K = 2, on a deep stencil, at
    radius < 3 and for Bernstein.  A CPU conv stays per step and matches
    the JAX package's per-step path."""
    gj, gt = _graphs(16, 40)
    st = gt.face_stencil(0.75)
    assert tstencil.conv_route(st, "cheby", 5, True) == "chain"
    assert tstencil.conv_route(st, "mono", 3, True) == "chain"
    assert tstencil.conv_route(st, "cheby", 5, False) == "per_step"
    assert tstencil.conv_route(st, "cheby", 2, True) == "per_step"
    assert tstencil.conv_route(st, "bern", 5, True) == "per_step"
    assert tstencil.conv_route(gt.deep_stencil(0.75, 3), "cheby", 3,
                               True) == "per_step"
    st8 = _graphs(16, 8)[1].face_stencil(0.75)
    assert tstencil.conv_route(st8, "cheby", 5, True) == "per_step"

    jcfg.set_use_pallas("off")
    rng = np.random.RandomState(3)
    x = rng.normal(size=(2, 12 * 16 * 16, 2)).astype(np.float32)
    kern = (rng.normal(size=(2 * 5, 3)) * 0.3).astype(np.float32)
    want = jstencil.stencil_graph_conv(gj.face_stencil(0.75), jnp.asarray(x),
                                       jnp.asarray(kern), 5, "cheby")
    got = tstencil.stencil_graph_conv(st, _t(x), _t(kern), 5, "cheby")
    assert _cuda.route_counts["lap_chain"] == 0
    _close(got, want)


# (label, nside, k, K, B, Fin, Fout, grad, route) on an H100: ROADMAP
# fault 3.2's shapes (radius 2 from h = 20 in training, h = 22 at all;
# radius 1, 16 -> 32, from K = 29 in training) take the chain; the
# per-step route stays where the JAX package runs no kernel (radius >= 3,
# K > 2); 2048 channels outgrow K2's and K3's dW cells in the chain too
_FAULT_ROUTES = [
    ("k=20 K=11 nside 32 8->16 train", 32, 20, 11, 16, 8, 16, True, "chain"),
    ("k=20 K=11 nside 64 8->16 train", 64, 20, 11, 16, 8, 16, True, "chain"),
    ("k=20 K=11 nside 64 1->8 train", 64, 20, 11, 16, 1, 8, True, "fused"),
    ("k=20 K=12 nside 32 8->16 forward", 32, 20, 12, 16, 8, 16, False,
     "chain"),
    ("k=8 K=29 nside 32 16->32 train", 32, 8, 29, 16, 16, 32, True, "chain"),
    ("k=8 K=29 nside 32 16->32 forward", 32, 8, 29, 16, 16, 32, False,
     "fused"),
    ("k=60 K=5 nside 32 2->3 train", 32, 60, 5, 2, 2, 3, True, "per_step"),
    ("k=20 K=11 nside 32 2048->2048 train", 32, 20, 11, 1, 2048, 2048, True,
     "raises"),
]


@pytest.mark.parametrize("label,n,k,K,B,Fin,Fout,grad,route", _FAULT_ROUTES,
                         ids=[c[0] for c in _FAULT_ROUTES])
def test_cface_route_takes_the_chain_where_one_shot_plans_fail(
        label, n, k, K, B, Fin, Fout, grad, route):
    """``cface_route`` names the lap chain at radius <= 2 where a one-shot
    plan is refused and the chain's plans (h = radius, K = 2, Fin -> Fin)
    all take the shape, and raises only where both are refused."""
    st = _graphs(n, k)[1].deep_stencil(0.75, K)
    assert tfs.cfp_structural_available(st, "cheby", K), label
    if route == "raises":
        assert tfs.chain_refused(n, st.radius, len(st.offsets), B, Fin,
                                 _H100_SMS, grad) == ["K2", "K3"]
        with pytest.raises(ValueError, match="lap chain"):
            tfs.cface_route(st, "cheby", K, B, Fin, Fout, _H100_SMS, grad)
    else:
        assert tfs.cface_route(st, "cheby", K, B, Fin, Fout, _H100_SMS,
                               grad) == route


@pytest.mark.parametrize("fused_dw", [True, False])
def test_chain_cface_conv_matches_jax_cface_conv(fused_dw):
    """Fault 3.2's math: a k=20 (radius 2) Chebyshev K=5 conv in the cface
    layout at nside 16 (h = 8), through the port's chain route on the
    shallow stencil, against the JAX package's one-shot cface conv
    (interpret mode, with its corner correction): forward, and the
    gradients of a fixed cotangent with respect to x and to the kernel."""
    n, K, B, Fin, Fout = 16, 5, 2, 3, 2
    key = ("cface", n, K)
    gj, gt = _graphs(n, 20)
    st = gt.deep_stencil(0.75, K)
    h = st.n_steps
    assert h == 8 and st.radius == 2
    _, P_l = tfs.cfp_geometry(n, h)
    if key not in _JAX:
        sj = gj.deep_stencil(0.75, K)
        rng = np.random.RandomState(9)
        x = rng.normal(size=(B, Fin, 12, n, P_l)).astype(np.float32)
        x[..., :h] = 0.0
        x[..., h + n:] = 0.0
        kern = (rng.normal(size=(Fin * K, Fout)) * 0.3).astype(np.float32)
        cot = rng.normal(size=(B, Fout, 12, n, P_l)).astype(np.float32)
        cot[..., :h] = 0.0
        cot[..., h + n:] = 0.0
        y, vjp = jax.vjp(
            lambda a, w: jstencil.stencil_graph_conv_cface(sj, a, w, K,
                                                           "cheby"),
            jnp.asarray(x), jnp.asarray(kern))
        dx, dk = vjp(jnp.asarray(cot))
        _JAX[key] = (x, kern, cot, tuple(np.asarray(a) for a in (y, dx, dk)))
    x, kern, cot, (y_j, dx_j, dk_j) = _JAX[key]
    config.set_fused_dw(fused_dw)
    shallow = gt.face_stencil(0.75)
    xt = _t(x).requires_grad_()
    kt = _t(kern).requires_grad_()
    y = tstencil._cface_chain(shallow, None, xt, kt, K, "cheby", h)
    dx, dk = torch.autograd.grad(y, (xt, kt), _t(cot))
    assert _cuda.route_counts["chain_cface"] == 1
    assert all(v == 0 for v in _cuda.launch_counts.values())
    y = y.detach()
    assert (y[..., :h] == 0).all() and (y[..., h + n:] == 0).all()
    inner = (Ellipsis, slice(h, h + n))
    _close(y[inner], y_j[inner])
    _close(dx[inner], dx_j[inner])
    _close(dk, dk_j)


def _fault_layers(hp):
    """Chebyshev K=11 convs on the k=20 graph, 1 -> 4 -> 8, a pool and a
    Dense head (fault 3.2's shape, narrowed)."""
    return [hp.HealpyChebyshev(K=11, Fout=4, activation="relu"),
            hp.HealpyChebyshev(K=11, Fout=8, activation="relu"),
            hp.HealpyPool(p=1), hp.Flatten(), hp.Dense(3)]


def test_fault_shape_model_chain_route_matches_the_fused_route(rng,
                                                               monkeypatch):
    """A model of fault 3.2's shape (k=20, K=11, h=20 at nside 32) plans
    both convs in the cface layout.  Forced onto the chain route (as a
    card takes it), its logits and every gradient of a fixed cotangent
    match the fused route's plain versions; the shallow tables are built
    at the route's first use, on the layer's device, out of the
    checkpoint state, and the chain is counted once a conv."""
    nside = 32
    npix = 12 * nside * nside
    model = dt.HealpyGCNN(nside, np.arange(npix), _fault_layers(thp),
                          n_neighbors=20).build((2, npix, 1), seed=4,
                                                device="cpu")
    convs = [m for m in model.layers.values()
             if isinstance(m, tl.ChebyshevConv)]
    assert [c.layout for c in convs] == ["cface", "cface"]
    assert [c._stencil().n_steps for c in convs] == [20, 20]
    x = torch.from_numpy(rng.normal(size=(2, npix, 1)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))

    def run():
        model.zero_grad()
        y = model(x)
        y.backward(cot)
        return y.detach(), {n: p.grad.clone()
                            for n, p in model.named_parameters()}

    y_f, g_f = run()
    assert not any(n.startswith("chain_") for c in convs
                   for n, _ in c.named_buffers())

    def chain_route(st, x5, kernel, n_terms, kind, tables=None, chain=None,
                    route=None):
        return tstencil._cface_chain(*chain(), x5, kernel, n_terms, kind,
                                     st.n_steps)

    monkeypatch.setattr(tl, "stencil_graph_conv_cface", chain_route)
    _cuda.reset_launch_counts()
    y_c, g_c = run()
    assert _cuda.route_counts["chain_cface"] == 2
    assert all(v == 0 for v in _cuda.launch_counts.values())
    for c in convs:
        names = [n for n, _ in c.named_buffers() if n.startswith("chain_")]
        assert "chain_weights" in names
        assert c.chain_weights.device == c.kernel.device
    assert not any("chain_" in k for k in model.state_dict())
    _close(y_c, y_f)
    assert g_c.keys() == g_f.keys()
    for name in g_f:
        _close(g_c[name], g_f[name])
