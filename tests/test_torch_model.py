"""PyTorch port, layers and the model: each ported layer against its flax
module, and the quick_start classifier against the JAX ``HealpyGCNN``,
with the JAX parameters copied through ``load_jax_variables``.

Random batch-norm statistics (not 0 and 1) make the normalisation count;
tolerances are float32 ones (layers 1e-5, logits 1e-4 relative).
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepsphere_tpu as ds
import deepsphere_tpu.graph as jgraph
import deepsphere_tpu.nn.layers as jl
import deepsphere_tpu.ops.stencil as jstencil
import deepsphere_tpu_torch as dt
import deepsphere_tpu_torch.graph as tgraph
import deepsphere_tpu_torch.nn.layers as tl
from deepsphere_tpu.nn import healpy_layers as jhp
from deepsphere_tpu_torch.interop import load_jax_variables
from deepsphere_tpu_torch.nn import healpy_layers as thp
from deepsphere_tpu_torch.ops import _cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GRAPHS = {}


def _graphs(n):
    if n not in _GRAPHS:
        _GRAPHS[n] = (
            jgraph.build_sphere_graph(n, k=8, method="grid"),
            tgraph.build_sphere_graph(n, k=8, method="grid"),
        )
    return _GRAPHS[n]


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _random_stats(variables, rng):
    for sub in jax.tree_util.tree_leaves(
            variables.get("batch_stats", {}), is_leaf=lambda d: "mean" in d):
        sub["mean"] = rng.normal(scale=0.3, size=sub["mean"].shape).astype(np.float32)
        sub["var"] = rng.uniform(0.5, 2.0, size=sub["var"].shape).astype(np.float32)
    return variables


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, err


def _run_pair(jmod, tmod, x_np, rng, training=False):
    """Init the flax module, copy its variables into the port module, run
    both; returns (torch out, jax out, jax updated stats, torch module)."""
    xj = jnp.asarray(x_np)
    v = _np_tree(jmod.init(jax.random.key(0), xj))
    v = _random_stats(v, rng)
    with torch.no_grad():
        tmod.eval()(torch.from_numpy(x_np))  # materialize parameters
    load_jax_variables(tmod, v)
    if training:
        yj, upd = jmod.apply(v, xj, training=True, mutable=["batch_stats"])
        tmod.train()
    else:
        yj, upd = jmod.apply(v, xj), None
        tmod.eval()
    with torch.no_grad():
        yt = tmod(torch.from_numpy(x_np))
    return yt.numpy(), np.asarray(yj), upd, tmod


def _cface(x, n, h):
    return np.array(jstencil.cface_embed(jnp.asarray(x), n, h))


@pytest.mark.parametrize(
    "cls,K,layout,n",
    [
        ("ChebyshevConv", 5, "nest", 8),
        ("ChebyshevConv", 10, "face", 8),
        ("ChebyshevConv", 5, "cface", 16),
        ("ChebyshevConv", 10, "cface", 16),
        ("MonomialConv", 3, "nest", 8),
        ("MonomialConv", 3, "cface", 8),
    ],
)
def test_conv_layer_matches_flax(rng, cls, K, layout, n):
    gj, gt = _graphs(n)
    kw = dict(K=K, Fout=4, activation="relu", use_bn=True, use_bias=True,
              layout=layout)
    jm = getattr(jl, cls)(graph=gj, **kw)
    tm = getattr(tl, cls)(graph=gt, **kw)
    x = rng.normal(size=(2, 12 * n * n, 3)).astype(np.float32)
    if layout == "cface":
        h = tm._stencil().n_steps
        x = _cface(x, n, h)
    yt, yj, _, _ = _run_pair(jm, tm, x, rng)
    if layout == "cface":  # only the interior lanes are defined
        yt, yj = yt[..., h:h + n], yj[..., h:h + n]
    _close(yt, yj)


def test_masked_sky_conv_matches_flax(rng):
    """A partial-sky graph: the JAX layer embeds it into the full-sphere
    stencil, the port runs the ELLPACK conv (same operator)."""
    n = 8
    ind = np.arange(4 * n * n)  # the first four base faces
    gj = jgraph.build_sphere_graph(n, ind, k=8, method="grid")
    gt = tgraph.build_sphere_graph(n, ind, k=8, method="grid")
    kw = dict(K=5, Fout=3, use_bn=True, activation="relu")
    x = rng.normal(size=(2, ind.size, 2)).astype(np.float32)
    yt, yj, _, tm = _run_pair(jl.ChebyshevConv(graph=gj, **kw),
                              tl.ChebyshevConv(graph=gt, **kw), x, rng)
    assert tm._stencil() is None
    _close(yt, yj)


@pytest.mark.parametrize("layout", ["nest", "cface"])
def test_batch_norm_training_matches_flax(rng, layout):
    """Training-mode batch statistics (interior lanes only in cface) and
    the running-average update follow flax."""
    n = 8
    gj, gt = _graphs(n)
    kw = dict(K=3, Fout=4, use_bn=True, layout=layout)
    jm, tm = jl.MonomialConv(graph=gj, **kw), tl.MonomialConv(graph=gt, **kw)
    x = rng.normal(loc=0.5, size=(2, 12 * n * n, 2)).astype(np.float32)
    if layout == "cface":
        x = _cface(x, n, 2)
    yt, yj, upd, tm = _run_pair(jm, tm, x, rng, training=True)
    if layout == "cface":
        yt, yj = yt[..., 2:2 + n], yj[..., 2:2 + n]
    _close(yt, yj)
    _close(tm.bn.mean.numpy(), upd["batch_stats"]["bn"]["mean"])
    _close(tm.bn.var.numpy(), upd["batch_stats"]["bn"]["var"])


@pytest.mark.parametrize("layout,pool", [("nest", "MAX"), ("face", "AVG"),
                                         ("cface", "MAX"), ("cface", "AVG")])
def test_pool_matches_flax(rng, layout, pool):
    n = 8
    x = rng.normal(size=(2, 12 * n * n, 3)).astype(np.float32)
    kw = dict(p=1, pool_type=pool, layout=layout)
    if layout == "cface":
        x = _cface(x, n, 4)
        kw.update(cface_off=4, cface_off_out=2)
    yt, yj, _, _ = _run_pair(jl.HealpyPool(**kw), tl.HealpyPool(**kw), x, rng)
    if pool == "MAX":
        np.testing.assert_array_equal(yt, yj)
    else:  # a mean of 4, summed in another order
        _close(yt, yj)


@pytest.mark.parametrize("name", ["NestToFace", "FaceToNest", "NestToCface",
                                  "CfaceToNest", "CfaceReEmbed", "Flatten"])
def test_layout_layers_match_flax(rng, name):
    n = 8
    x = rng.normal(size=(2, 12 * n * n, 3)).astype(np.float32)
    kw = {}
    if name in ("NestToCface", "CfaceToNest"):
        kw = dict(off=4)
    if name == "CfaceReEmbed":
        kw = dict(off_in=4, off_out=2)
    if name in ("CfaceToNest", "CfaceReEmbed"):
        x = _cface(x, n, 4)
    yt, yj, _, _ = _run_pair(getattr(jl, name)(**kw), getattr(tl, name)(**kw),
                             x, rng)
    np.testing.assert_array_equal(yt, yj)


def test_dense_matches_flax(rng):
    x = rng.normal(size=(3, 40)).astype(np.float32)
    yt, yj, _, _ = _run_pair(jl.Dense(5, activation="tanh"),
                             tl.Dense(5, activation="tanh"), x, rng)
    _close(yt, yj)


def _quick_start(m):
    return [
        m.HealpyChebyshev(K=10, Fout=8, activation="relu", use_bn=True),
        m.HealpyPool(p=1),
        m.HealpyChebyshev(K=10, Fout=16, activation="relu", use_bn=True),
        m.HealpyPool(p=1),
        m.HealpyChebyshev(K=10, Fout=32, activation="relu", use_bn=True),
        m.HealpyPool(p=1),
        m.HealpyChebyshev(K=10, Fout=32, activation="relu"),
        m.Flatten(),
        m.Dense(4),
    ]


def test_quick_start_model_matches_jax(rng):
    """The quick_start classifier at nside 16: same layout plan, and logits
    within 1e-4 of the JAX model with the same (copied) variables."""
    nside = 16
    npix = 12 * nside * nside
    jm = ds.HealpyGCNN(nside, np.arange(npix), _quick_start(jhp))
    tm = dt.HealpyGCNN(nside, np.arange(npix), _quick_start(thp))
    assert ([type(l).__name__ for l in tm._module_layers]
            == [type(l).__name__ for l in jm._module_layers])
    assert list(tm.layers) == list(jm.module.order)
    x = rng.normal(size=(2, npix, 1)).astype(np.float32)
    v = jm.init(0, jnp.asarray(x))
    vv = _random_stats(_np_tree({k: v[k] for k in ("params", "batch_stats")}),
                       rng)
    want = np.asarray(jm.apply({**v, **vv}, jnp.asarray(x)))
    tm.build(x.shape)
    load_jax_variables(tm, vv)
    _cuda.reset_launch_counts()
    got = tm.predict(x, batch_size=1)
    _close(got, want, rtol=1e-4)
    assert _cuda.launch_counts == {"strips": 0, "stencil_conv": 0}
    # graph tables are buffers but stay out of the checkpoint state
    keys = list(tm.state_dict())
    assert "layers.layer_0.kernel" in keys and "layers.layer_0.bn.var" in keys
    assert not any(".tab_" in k for k in keys)
    assert any(n.endswith("tab_weights") for n, _ in tm.named_buffers())


def test_build_is_seeded_and_load_checks_shapes():
    nside = 8
    npix = 12 * nside * nside
    layers = lambda: [thp.HealpyChebyshev(K=3, Fout=2, use_bn=True),
                      thp.HealpyPool(p=1), thp.Flatten(), thp.Dense(3)]
    a = dt.HealpyGCNN(nside, np.arange(npix), layers()).build((1, npix, 1), seed=3)
    b = dt.HealpyGCNN(nside, np.arange(npix), layers()).build((1, npix, 1), seed=3)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    good = {"params": {"layers_layer_0": {"kernel": np.zeros((3, 2))},
                       "layers_layer_3": {"dense": {
                           "kernel": np.zeros((2 * 12 * 16, 3)),
                           "bias": np.zeros(3)}}},
            "batch_stats": {"layers_layer_0": {"bn": {"mean": np.zeros(2),
                                                      "var": np.ones(2)}}}}
    load_jax_variables(a, good)
    assert float(a.layers["layer_0"].kernel.detach().abs().sum()) == 0.0
    bad = {**good, "params": {**good["params"],
                              "layers_layer_0": {"kernel": np.zeros((4, 2))}}}
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(a, bad)
    missing = {**good, "params": {"layers_layer_0": good["params"]["layers_layer_0"]}}
    with pytest.raises(KeyError, match="missing"):
        load_jax_variables(a, missing)


def test_error_strings_match_jax():
    nside = 8
    npix = 12 * nside * nside

    def err(mod, hp_mod, **kw):
        with pytest.raises(Exception) as e:
            mod.HealpyGCNN(**kw)
        return type(e.value).__name__, str(e.value)

    kw = dict(nside=nside, indices=np.arange(npix), n_neighbors=7)
    assert err(dt, thp, layers=[], **kw) == err(ds, jhp, layers=[], **kw)
    assert err(dt, thp, layers=[], **kw)[0] == "NotImplementedError"
    # an index set that does not reduce cleanly through one pooling
    kw = dict(nside=nside, indices=np.arange(npix)[1:])
    t = err(dt, thp, layers=[thp.HealpyPool(p=1)], **kw)
    j = err(ds, jhp, layers=[jhp.HealpyPool(p=1)], **kw)
    assert t == j and t[0] == "ValueError"
    with pytest.raises(OSError, match="Pooling type not understood: HUHU"):
        thp.HealpyPool(p=1, pool_type="HUHU")


def test_port_imports_no_jax():
    """In a fresh interpreter where jax and flax cannot be imported, the
    port imports, builds the quick_start model at nside 8 and runs one
    CPU forward."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        import numpy as np, torch
        import deepsphere_tpu_torch as dt
        import deepsphere_tpu_torch.interop, deepsphere_tpu_torch.ops.fused_stencil
        from deepsphere_tpu_torch.nn import healpy_layers as hp
        npix = 12 * 8 * 8
        m = dt.HealpyGCNN(8, np.arange(npix), [
            hp.HealpyChebyshev(K=10, Fout=8, activation="relu", use_bn=True),
            hp.HealpyPool(p=1),
            hp.HealpyChebyshev(K=10, Fout=16, activation="relu", use_bn=True),
            hp.HealpyPool(p=1),
            hp.HealpyChebyshev(K=10, Fout=32, activation="relu", use_bn=True),
            hp.HealpyPool(p=1),
            hp.HealpyChebyshev(K=10, Fout=32, activation="relu"),
            hp.Flatten(), hp.Dense(4)]).build((2, npix, 1))
        y = m.predict(np.random.RandomState(0).normal(size=(2, npix, 1)))
        assert y.shape == (2, 4) and np.isfinite(y).all()
        assert not any(k.split(".")[0] in ("jax", "flax", "deepsphere_tpu")
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
