"""PyTorch port, the rest of the conv family: Bernstein convs, residual
layers, the pseudo-convs, the model planner that threads them through the
cface layout, the autoencoder of ``examples/autoencoder.py`` and the
``interop`` trees of these layers.

Each layer takes the same seeded numpy inputs as its flax module, with the
flax module's variables copied in through ``load_jax_variables`` (random
batch-norm statistics and norm parameters, so they count).  Tolerance:
1e-5 of the JAX result's max (float32 on both sides, sums in another
order).  The JAX convs run their plain path (no Pallas backend on the
CPU), the port's the kernels' plain versions.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepsphere_tpu as ds
import deepsphere_tpu.config as jcfg
import deepsphere_tpu.graph as jgraph
import deepsphere_tpu.nn.layers as jl
import deepsphere_tpu.ops.spmv as jspmv
import deepsphere_tpu.ops.stencil as jstencil
import deepsphere_tpu.train.losses as jlosses
import deepsphere_tpu_torch as dt
import deepsphere_tpu_torch.graph as tgraph
import deepsphere_tpu_torch.nn.layers as tl
import deepsphere_tpu_torch.ops.spmv as tspmv
import deepsphere_tpu_torch.train.losses as tlosses
from deepsphere_tpu.nn import healpy_layers as jhp
from deepsphere_tpu_torch.interop import export_jax_variables, load_jax_variables
from deepsphere_tpu_torch.nn import healpy_layers as thp
from deepsphere_tpu_torch.ops import _cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5

_GRAPHS = {}


@pytest.fixture(autouse=True)
def _plain_jax():
    jcfg.set_use_pallas("off")
    _cuda.reset_launch_counts()
    yield
    jcfg.set_use_pallas("auto")


def _graphs(n, k=8):
    if (n, k) not in _GRAPHS:
        _GRAPHS[n, k] = (jgraph.build_sphere_graph(n, k=k, method="grid"),
                         tgraph.build_sphere_graph(n, k=k, method="grid"))
    return _GRAPHS[n, k]


def _jit_init(jm, x):
    """``jm.init(0, x)``'s variables through a jitted ``module.init`` (the
    same values, in a fraction of the eager init's time on the CPU)."""
    return jax.jit(jm.module.init)(jax.random.key(0), jnp.asarray(x))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _close_trees(got, want, tol=TOL, path=""):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _close_trees(got[k], want[k], tol, f"{path}/{k}")
        else:
            got_k, want_k = np.asarray(got[k]), np.asarray(want[k])
            assert got_k.shape == want_k.shape, f"{path}/{k}"
            err = (np.abs(got_k - want_k).max()
                   / max(np.abs(want_k).max(), 1e-30))
            assert err <= tol, (f"{path}/{k}", err)


def _randomize(v, rng):
    """Random batch statistics and norm scales / biases in a flax variable
    tree (in place), so the normalisation counts."""
    def walk(d, path):
        for k, sub in d.items():
            if isinstance(sub, dict):
                walk(sub, path + (k,))
            elif path and path[-1].startswith("bn") and k in ("scale", "bias"):
                d[k] = rng.normal(1.0 if k == "scale" else 0.0, 0.3,
                                  size=sub.shape).astype(np.float32)
            elif k == "mean":
                d[k] = rng.normal(scale=0.3, size=sub.shape).astype(np.float32)
            elif k == "var":
                d[k] = rng.uniform(0.5, 2.0, size=sub.shape).astype(np.float32)
    walk(v, ())
    return v


def _run_pair(jmod, tmod, x_np, rng, training=False):
    """Init the flax module, copy its variables into the port module, run
    both; returns (torch out, jax out, jax variables, jax updated stats)."""
    xj = jnp.asarray(x_np)
    v = _randomize(_np_tree(jmod.init(jax.random.key(0), xj)), rng)
    with torch.no_grad():
        tmod.eval()(_t(x_np))  # materialize parameters
    load_jax_variables(tmod, v)
    if training:
        yj, upd = jmod.apply(v, xj, training=True, mutable=["batch_stats"])
        tmod.train()
    else:
        yj, upd = jmod.apply(v, xj), None
        tmod.eval()
    with torch.no_grad():
        yt = tmod(_t(x_np))
    return yt.numpy(), np.asarray(yj), v, upd


def _cface(x, n, h):
    return np.array(jstencil.cface_embed(jnp.asarray(x), n, h))


# ---------------------------------------------------------------------------
# Bernstein
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quirk", [False, True])
def test_bernstein_basis_matches_jax(rng, quirk):
    gj, gt = _graphs(8)
    idx, val = gt.ellpack(0.75)
    x = rng.normal(size=(12 * 64, 3)).astype(np.float32)
    jf = jspmv.bernstein_basis_ref if quirk else jspmv.bernstein_basis
    tf = tspmv.bernstein_basis_ref if quirk else tspmv.bernstein_basis
    want = jf(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(x), 4)
    got = tf(_t(idx).long(), _t(val), _t(x), 4)
    _close(got, want)


def test_bernstein_quirk_at_k0_raises_the_jax_error():
    mv = lambda t: t
    with pytest.raises(ValueError) as je:
        list(jspmv.bernstein_terms(mv, jnp.ones((3, 1)), 1, quirk=True))
    with pytest.raises(ValueError) as te:
        list(tspmv.bernstein_terms(mv, torch.ones(3, 1), 1, quirk=True))
    assert str(te.value) == str(je.value)
    # the layer raises it at its first forward
    _, gt = _graphs(8)
    layer = tl.BernsteinConv(graph=gt, K=0, Fout=2, ref_quirks=True)
    with pytest.raises(ValueError, match="ref_quirks Bernstein needs K >= 1"):
        layer(torch.zeros(1, 12 * 64, 1))
    # without the quirk K=0 is the one term x
    assert tl.BernsteinConv(graph=gt, K=0, Fout=2).n_terms == 1


@pytest.mark.parametrize("layout,quirk,method", [
    ("nest", False, "auto"), ("nest", True, "auto"), ("face", False, "auto"),
    ("face", True, "auto"), ("nest", True, "ellpack"),
])
def test_bernstein_layer_matches_flax(rng, layout, quirk, method):
    """Bernstein K=3 (4 terms), bias, BN, relu: per step on the face
    stencil (nest and face layouts) and on the ELLPACK, with and without
    the reference quirk."""
    gj, gt = _graphs(8)
    kw = dict(K=3, Fout=4, activation="relu", use_bn=True, use_bias=True,
              layout=layout, conv_method=method, ref_quirks=quirk)
    tm = tl.BernsteinConv(graph=gt, **kw)
    assert tm.basis_kind == ("bern_ref" if quirk else "bern")
    x = rng.normal(size=(2, 12 * 64, 3)).astype(np.float32)
    yt, yj, _, _ = _run_pair(jl.BernsteinConv(graph=gj, **kw), tm, x, rng)
    _close(yt, yj)


def test_bernstein_default_init():
    """The flax default: truncated normal of std sqrt(6/(Fin+Fout)) cut at
    +-2 std, (K+1)*Fin rows."""
    _, gt = _graphs(8)
    layer = tl.BernsteinConv(graph=gt, K=4, Fout=30)
    layer._init_generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        layer(torch.zeros(1, 12 * 64, 20))
    w = layer.kernel.detach().numpy()
    std = np.sqrt(6.0 / 50)
    assert w.shape == (100, 30)
    assert np.abs(w).max() <= 2 * std + 1e-6
    assert 0.7 * std < w.std() < 1.0 * std


# ---------------------------------------------------------------------------
# residual layers
# ---------------------------------------------------------------------------

_RES_CASES = [(norm, before, layout)
              for norm in ("batch_norm", "layer_norm")
              for before in (False, True)
              for layout in ("nest", "face", "cface")]


@pytest.mark.parametrize("norm,act_before,layout", _RES_CASES,
                         ids=["-".join(map(str, c)) for c in _RES_CASES])
def test_residual_layer_matches_flax(rng, norm, act_before, layout):
    """A CHEBY K=3 residual layer with Keras-default norms at nside 8, in
    eval and in training mode; after the training forward the running
    statistics (momentum 0.99) match flax's updated ``batch_stats``."""
    n = 8
    gj, gt = _graphs(n)
    kw = dict(layer_type="CHEBY", layer_kwargs={"K": 3, "use_bias": True},
              activation="relu", act_before=act_before, use_bn=True,
              norm_type=norm, alpha=0.7, layout=layout)
    x = rng.normal(size=(2, 12 * n * n, 4)).astype(np.float32)
    h = 0
    if layout == "cface":
        h = tl.ChebyshevConv(graph=gt, K=3, layout="cface")._stencil().n_steps
        assert h == 2
        x = _cface(x, n, h)
    elif layout == "face":
        x = np.asarray(jax.jit(ds.ops.layout.nest_to_face)(jnp.asarray(x)))
    for training in (False, True):
        tm = tl.ResidualLayer(graph=gt, **kw)
        yt, yj, _, upd = _run_pair(jl.ResidualLayer(graph=gj, **kw), tm, x,
                                   rng, training=training)
        if layout == "cface":  # only the interior lanes are defined
            yt, yj = yt[..., h:h + n], yj[..., h:h + n]
        _close(yt, yj)
        if training and norm == "batch_norm":
            _close_trees(export_jax_variables(tm)["batch_stats"],
                         _np_tree(upd["batch_stats"]))


def test_residual_layer_defaults_and_errors_match_flax():
    """Keras-default norms (batch norm: epsilon 1e-3, momentum 0.99, a
    scale and a bias; layer norm: epsilon 1e-3), ``bn_kwargs`` overrides,
    and the reference's error strings."""
    _, gt = _graphs(8)
    r = tl.ResidualLayer(graph=gt, layer_type="MONO", layer_kwargs={"K": 2},
                         use_bn=True)
    with torch.no_grad():
        r.eval()(torch.zeros(1, 12 * 64, 3))
    assert (r.bn1.epsilon, r.bn1.momentum) == (1e-3, 0.99)
    assert r.bn1.scale.shape == (3,) and r.bn1.bias.shape == (3,)
    assert torch.equal(r.bn1.var, torch.ones(3))  # build leaves it at 1
    r = tl.ResidualLayer(graph=gt, layer_type="MONO", layer_kwargs={"K": 2},
                         use_bn=True, norm_type="layer_norm",
                         bn_kwargs={"epsilon": 1e-2, "axis": 1,
                                    "use_bias": False})
    with torch.no_grad():
        r(torch.zeros(1, 12 * 64, 3))
    assert r.bn2.epsilon == 1e-2 and r.bn2.bias is None
    for kw in (dict(layer_type="BERN"), dict(layer_type="CHEBY", use_bn=True,
                                             norm_type="group_norm"),
               dict(layer_type="CHEBY", activation="nope")):
        full = dict(layer_kwargs={"K": 2}, **kw)
        with pytest.raises(Exception) as je:
            jl.ResidualLayer(graph=_graphs(8)[0], **full)
        with pytest.raises(Exception) as te:
            tl.ResidualLayer(graph=gt, **full)
        assert (type(te.value), str(te.value)) == (type(je.value),
                                                   str(je.value))


# ---------------------------------------------------------------------------
# pseudo-convs
# ---------------------------------------------------------------------------

_PSEUDO_CASES = [(cls, layout, p) for cls in ("HealpyPseudoConv",
                                             "HealpyPseudoConv_Transpose")
                 for layout, p in (("nest", 1), ("nest", 2), ("face", 1),
                                   ("cface", 1))]


@pytest.mark.parametrize("cls,layout,p", _PSEUDO_CASES,
                         ids=["-".join(map(str, c)) for c in _PSEUDO_CASES])
def test_pseudo_conv_matches_flax(rng, cls, layout, p):
    """Both pseudo-convs in every layout against flax, the parameters in
    NEST tap order in each; the cface form re-embeds at ``cface_off_out``
    with zero pad lanes, as the JAX module does."""
    n = 8
    kw = dict(p=p, Fout=5)
    if layout == "cface":
        kw.update(cface_off=3, cface_off_out=2)
    x = rng.normal(size=(2, 12 * n * n, 3)).astype(np.float32)
    if layout == "face":
        x = np.asarray(ds.ops.layout.nest_to_face(jnp.asarray(x)))
    elif layout == "cface":
        x = _cface(x, n, 3)
    jm = getattr(jl, cls)(layout=layout, **kw)
    tm = getattr(tl, cls)(layout=layout, **kw)
    yt, yj, v, _ = _run_pair(jm, tm, x, rng)
    _close(yt, yj)
    if layout == "cface":
        assert (yt[..., :2] == 0).all()
        n2 = yt.shape[3]
        assert (yt[..., 2 + n2:] == 0).all()
    # the same variables give the NEST layer's output in every layout
    assert v["params"]["kernel"].shape == tuple(tm.kernel.shape)


def test_pseudo_conv_init_and_errors():
    """glorot-uniform kernels (the transpose's fans over its 4^p taps) and
    zero biases from the layer's generator; the reference's errors."""
    for cls, shape, limit in ((tl.HealpyPseudoConv, (4 * 6, 10),
                               np.sqrt(6.0 / (24 + 10))),
                              (tl.HealpyPseudoConv_Transpose, (4, 6, 10),
                               np.sqrt(6.0 / (4 * (6 + 10))))):
        m = cls(p=1, Fout=10)
        m._init_generator = torch.Generator().manual_seed(1)
        with torch.no_grad():
            m(torch.zeros(1, 48, 6))
        w = m.kernel.detach().numpy()
        assert w.shape == shape and np.abs(w).max() <= limit
        assert np.abs(w).max() > 0.8 * limit
        assert not m.bias.detach().abs().sum()
    for cls in ("HealpyPseudoConv", "HealpyPseudoConv_Transpose"):
        with pytest.raises(OSError) as je:
            getattr(jl, cls)(p=0, Fout=2)
        with pytest.raises(OSError) as te:
            getattr(tl, cls)(p=0, Fout=2)
        assert str(te.value) == str(je.value)
    with pytest.raises(OSError, match="not compatible with the filter size"):
        tl.HealpyPseudoConv(p=1, Fout=2)(torch.zeros(1, 10, 1))


# ---------------------------------------------------------------------------
# the model planner and the autoencoder
# ---------------------------------------------------------------------------


def _masked_stack(m, norm):
    """``examples/advanced_masked.py``'s layer stack."""
    return [
        m.HealpyChebyshev(K=5, Fout=8, activation="relu", use_bn=True),
        m.HealpyPool(p=1),
        m.Healpy_ResidualLayer("CHEBY", {"K": 5}, activation="relu",
                               use_bn=True, norm_type=norm),
        m.HealpyPool(p=1),
        m.HealpyMonomial(K=3, Fout=16, activation="relu"),
        m.Flatten(),
        m.Dense(2),
    ]


@pytest.mark.parametrize("norm", ["batch_norm", "layer_norm"])
def test_masked_stack_on_the_full_sphere_matches_jax(rng, norm):
    """``advanced_masked.py``'s layers on the full sphere at nside 32: the
    residual layer plans into the cface segment (its norms over the
    interior lanes at the sublayers' h); the same module list, layer names
    and logits (1e-4) as the JAX model, and one training forward's loss
    (1e-5) and gradient tree.  The gradients are held to 1e-3 of each
    leaf's max, as ``chip_smoke.py`` holds a train step's: the residual's
    ``bn1`` bias shifts each channel into a conv whose output ``bn2``
    centres again, so its gradient is a cancellation that float32 resolves
    only to ~3e-4 in either summation order."""
    nside = 32
    npix = 12 * nside * nside
    jm = ds.HealpyGCNN(nside, np.arange(npix), _masked_stack(jhp, norm))
    tm = dt.HealpyGCNN(nside, np.arange(npix), _masked_stack(thp, norm))
    assert ([type(l).__name__ for l in tm._module_layers]
            == [type(l).__name__ for l in jm._module_layers])
    assert tm.layers["layer_2"].layout == "cface"
    assert tm.layer_names == jm.layer_names
    assert list(tm.layers) == list(jm.module.order)
    x = rng.normal(size=(2, npix, 1)).astype(np.float32)
    y = rng.randint(0, 2, size=2)
    v = _jit_init(jm, x)
    vv = _randomize(_np_tree({k: v[k] for k in ("params", "batch_stats")}),
                    rng)
    static = {k: v[k] for k in v if k not in ("params", "batch_stats")}
    want = np.asarray(jm.apply({**v, **vv}, jnp.asarray(x)))
    tm.build(x.shape, device="cpu")
    load_jax_variables(tm, vv)
    _close(tm.predict(x, batch_size=2), want, 1e-4)

    loss = jlosses.resolve_loss("sparse_categorical_crossentropy_from_logits")

    def jloss(p):
        out = jm.module.apply({**static, "params": p,
                               "batch_stats": vv["batch_stats"]},
                              jnp.asarray(x), training=True,
                              mutable=["batch_stats"])[0]
        return loss(jnp.asarray(y), out)

    l_j, g_j = jax.value_and_grad(jloss)(vv["params"])
    tm.train()
    tm.zero_grad()
    l_t = tlosses.resolve_loss(
        "sparse_categorical_crossentropy_from_logits")(_t(y), tm(_t(x)))
    l_t.backward()
    _close(l_t.item(), float(l_j))
    _close_trees(export_jax_variables(tm, grads=True), _np_tree(g_j), 1e-3)


def test_pseudo_conv_nside_bookkeeping_matches_jax():
    """Pseudo-convs lower the nside like a pool, transposes raise it; the
    same plan (pseudo-convs stay in cface and in face), names, and errors
    as the JAX assembler."""
    nside, npix = 16, 12 * 16 * 16
    mk = lambda m: [m.HealpyChebyshev(K=3, Fout=2), m.HealpyPseudoConv(p=2, Fout=3),
                    m.HealpyPseudoConv_Transpose(p=1, Fout=2),
                    m.HealpyBernstein(K=2, Fout=2),
                    m.HealpyPseudoConv_Transpose(p=1, Fout=2),
                    m.HealpyChebyshev(K=2, Fout=1)]
    jm = ds.HealpyGCNN(nside, np.arange(npix), mk(jhp))
    tm = dt.HealpyGCNN(nside, np.arange(npix), mk(thp))
    assert tm.nside_out == jm.nside_out == 16
    assert ([(type(l).__name__, getattr(l, "layout", None))
             for l in tm._module_layers]
            == [(type(l).__name__, getattr(l, "layout", None))
                for l in jm._module_layers])
    assert tm.layer_names == jm.layer_names
    assert tm.layers_use[3].graph.nside == 8
    for layers in ([jhp.HealpyPseudoConv(p=5, Fout=1)],
                   [jhp.HealpyPseudoConv_Transpose(p=1, Fout=1),
                    jhp.HealpyPseudoConv(p=6, Fout=1)]):
        tl_ = [getattr(thp, type(l).__name__)(p=l.p, Fout=l.Fout)
               for l in layers]
        with pytest.raises(Exception) as je:
            ds.HealpyGCNN(nside, np.arange(npix), layers)
        with pytest.raises(Exception) as te:
            dt.HealpyGCNN(nside, np.arange(npix), tl_)
        assert (type(te.value), str(te.value)) == (type(je.value),
                                                   str(je.value))


def _example_autoencoder():
    spec = importlib.util.spec_from_file_location(
        "_autoencoder_example", os.path.join(REPO, "examples",
                                             "autoencoder.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def autoencoder_layers(m, nside, bottleneck):
    """``examples/autoencoder.py``'s encoder and decoder layers as one
    list (the decoder starts where the encoder ends)."""
    steps = int(np.log2(nside // bottleneck))
    layers = []
    for i in range(steps):
        layers += [m.HealpyChebyshev(K=5, Fout=8 * 2**i, activation="relu"),
                   m.HealpyPseudoConv(p=1, Fout=8 * 2**i)]
    for i in reversed(range(steps)):
        layers += [m.HealpyPseudoConv_Transpose(p=1, Fout=8 * 2**i),
                   m.HealpyChebyshev(K=5, Fout=8 * 2**i, activation="relu")]
    layers.append(m.HealpyChebyshev(K=5, Fout=1))
    return layers, 2 * steps


def test_autoencoder_matches_the_example(rng):
    """The autoencoder of ``examples/autoencoder.py`` at nside 16
    (bottleneck 4), built on the port as one model of the encoder's and the
    decoder's layers, with the example's parameters: its reconstruction,
    then one ``train_on_batch`` of MSE with Adam (1e-3): loss, gradients
    and the updated parameters against ``jax.value_and_grad`` and
    ``optax.adam`` over the example's ``AutoEncoder``."""
    ex = _example_autoencoder()
    nside, bottleneck = 16, 4
    npix = 12 * nside * nside
    ae = ex.AutoEncoder(nside, bottleneck)
    x = ex.make_maps(nside, 2, seed=5)
    # jitted: the example's init and apply, in a fraction of their eager time
    params, static = jax.jit(lambda xx: ae.init(0, xx))(jnp.asarray(x))
    want = np.asarray(jax.jit(ae.apply)(params, static, jnp.asarray(x)))

    layers, n_enc = autoencoder_layers(thp, nside, bottleneck)
    tm = dt.HealpyGCNN(nside, np.arange(npix), layers)
    # one cface segment from the input to the output: no layout change
    # around the pseudo-convs
    names = [type(l).__name__ for l in tm._module_layers]
    assert names.count("NestToCface") == names.count("CfaceToNest") == 1
    assert all(getattr(l, "layout", "cface") == "cface"
               for l in tm._module_layers[1:-1])
    tm.build(x.shape, device="cpu")

    def to_port(tree_enc, tree_dec):
        out = dict(tree_enc)
        out.update({f"layers_layer_{int(k.rsplit('_', 1)[1]) + n_enc}": v
                    for k, v in tree_dec.items()})
        return out

    p_np = _np_tree(params)
    load_jax_variables(tm, {"params": to_port(p_np["enc"], p_np["dec"])})
    _close(tm.predict(x, batch_size=2), want)

    def loss_of(p):
        return jnp.mean((ae.apply(p, static, jnp.asarray(x), training=True)
                         - jnp.asarray(x)) ** 2)

    l_j, g_j = jax.jit(jax.value_and_grad(loss_of))(params)
    tx = optax.adam(1e-3)
    upd, _ = tx.update(g_j, tx.init(params), params)
    p_new = _np_tree(optax.apply_updates(params, upd))
    g_j = _np_tree(g_j)

    tm.compile(optimizer=1e-3, loss="mse")
    logs = tm._trainer.train_on_batch(x, x)
    _close(logs["loss"], float(l_j))
    _close_trees(export_jax_variables(tm, grads=True),
                 to_port(g_j["enc"], g_j["dec"]))
    _close_trees(export_jax_variables(tm)["params"],
                 to_port(p_new["enc"], p_new["dec"]))


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------


def _family_stack(m):
    return [
        m.HealpyChebyshev(K=3, Fout=4, use_bn=True, use_bias=True),
        m.Healpy_ResidualLayer("CHEBY", {"K": 3, "use_bn": True},
                               activation="relu", use_bn=True),
        m.HealpyPseudoConv(p=1, Fout=6),
        m.Healpy_ResidualLayer("MONO", {"K": 2}, use_bn=True,
                               norm_type="layer_norm"),
        m.HealpyBernstein(K=2, Fout=3, use_bias=True, ref_quirks=True),
        m.HealpyPseudoConv_Transpose(p=1, Fout=2, use_bias=False),
        m.Flatten(),
        m.Dense(3),
    ]


def test_interop_round_trips_the_new_trees(rng):
    """The JAX model's variable tree (residual layers with both norms, both
    pseudo-convs, a Bernstein conv) loads into the port and exports back
    unchanged; a second port model takes the export and predicts the same;
    a missing or mis-shaped entry raises."""
    nside, npix = 8, 12 * 64
    jm = ds.HealpyGCNN(nside, np.arange(npix), _family_stack(jhp))
    x = rng.normal(size=(2, npix, 1)).astype(np.float32)
    v = _jit_init(jm, x)
    vv = _randomize(_np_tree({k: v[k] for k in ("params", "batch_stats")}),
                    rng)
    want = np.asarray(jm.apply({**v, **vv}, jnp.asarray(x)))
    a = dt.HealpyGCNN(nside, np.arange(npix), _family_stack(thp)).build(
        x.shape, seed=1, device="cpu")
    load_jax_variables(a, vv)
    out = export_jax_variables(a)
    jax.tree_util.tree_map(np.testing.assert_array_equal, out, vv)
    _close(a.predict(x, batch_size=2), want, 1e-4)
    b = dt.HealpyGCNN(nside, np.arange(npix), _family_stack(thp)).build(
        x.shape, seed=2, device="cpu")
    load_jax_variables(b, out)
    np.testing.assert_array_equal(b.predict(x, batch_size=2),
                                  a.predict(x, batch_size=2))

    def edit(tree, path, value):
        t = jax.tree_util.tree_map(lambda z: z, tree)
        d = t
        for k in path[:-1]:
            d = d[k]
        if value is None:
            del d[path[-1]]
        else:
            d[path[-1]] = value
        return t

    bad = edit(out, ("params", "layers_layer_2", "kernel"), np.zeros((3, 6)))
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(b, bad)
    bad = edit(out, ("params", "layers_layer_5", "kernel"),
               np.zeros((4, 6, 2)))
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(b, bad)
    for path in (("params", "layers_layer_1", "bn1"),
                 ("batch_stats", "layers_layer_1", "bn2"),
                 ("params", "layers_layer_3", "layer2"),
                 ("params", "layers_layer_2")):
        with pytest.raises(KeyError):
            load_jax_variables(b, edit(out, path, None))
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_variables(b, edit(out, ("params", "layers_layer_3", "bn1",
                                         "mean"), np.zeros(6)))
