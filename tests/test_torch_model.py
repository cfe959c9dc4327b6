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
import deepsphere_tpu_torch.ops.stencil as tstencil
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
    # jitted: ``jm.init(0, x)``'s variables in a fraction of its eager time
    v = jax.jit(jm.module.init)(jax.random.key(0), jnp.asarray(x))
    vv = _random_stats(_np_tree({k: v[k] for k in ("params", "batch_stats")}),
                       rng)
    want = np.asarray(jm.apply({**v, **vv}, jnp.asarray(x)))
    tm.build(x.shape, device="cpu")
    load_jax_variables(tm, vv)
    _cuda.reset_launch_counts()
    got = tm.predict(x, batch_size=1)
    _close(got, want, rtol=1e-4)
    assert all(v == 0 for v in _cuda.launch_counts.values())
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
    a = dt.HealpyGCNN(nside, np.arange(npix), layers()).build(
        (1, npix, 1), seed=3, device="cpu")
    b = dt.HealpyGCNN(nside, np.arange(npix), layers()).build(
        (1, npix, 1), seed=3, device="cpu")
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
    port imports, builds the quick_start model and a model of the conv
    family (Bernstein, pseudo-convs, a residual layer) at nside 8 and runs
    one CPU forward of each."""
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
            hp.Flatten(), hp.Dense(4)]).build((2, npix, 1), device="cpu")
        y = m.predict(np.random.RandomState(0).normal(size=(2, npix, 1)))
        assert y.shape == (2, 4) and np.isfinite(y).all()
        # the conv family: Bernstein, residual layers, pseudo-convs
        from deepsphere_tpu_torch.ops.stencil import lap_chain_conv
        m = dt.HealpyGCNN(8, np.arange(npix), [
            hp.HealpyBernstein(K=2, Fout=4, ref_quirks=True),
            hp.HealpyPseudoConv(p=1, Fout=4),
            hp.Healpy_ResidualLayer("CHEBY", {"K": 3}, activation="relu",
                                    use_bn=True, norm_type="layer_norm"),
            hp.HealpyPseudoConv_Transpose(p=1, Fout=1),
            hp.Flatten(), hp.Dense(4)]).build((2, npix, 1), device="cpu")
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


def _k60_layers(hp):
    """A Chebyshev K=5 conv on the k=60 grid graph (radius 4, h=16: a
    shape the card's kernels refuse), then a pool and a Dense head."""
    return [hp.HealpyChebyshev(K=5, Fout=4, activation="relu"),
            hp.HealpyPool(p=1), hp.Flatten(), hp.Dense(3)]


def test_k60_model_per_step_route_matches_the_fused_route(rng, monkeypatch):
    """``HealpyGCNN(n_neighbors=60)`` plans its K=5 conv in the cface
    layout.  On the card that conv takes the per-step route; forced onto
    it here, the model's logits and every gradient of a fixed cotangent
    match the fused route's plain versions (1e-5 of each max), and only
    the route is counted."""
    nside = 32
    npix = 12 * nside * nside
    model = dt.HealpyGCNN(nside, np.arange(npix), _k60_layers(thp),
                          n_neighbors=60).build((2, npix, 1), seed=3,
                                                device="cpu")
    assert [getattr(m, "layout", None) for m in model.layers.values()
            if isinstance(m, tl.ChebyshevConv)] == ["cface"]
    x = torch.from_numpy(rng.normal(size=(2, npix, 1)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))

    def run():
        model.zero_grad()
        y = model(x)
        y.backward(cot)
        return y.detach(), {n: p.grad.clone()
                            for n, p in model.named_parameters()}

    _cuda.reset_launch_counts()
    y_f, g_f = run()
    assert _cuda.route_counts["per_step_cface"] == 0
    def per_step(st, x5, kernel, n_terms, kind, tables=None, chain=None,
                 route=None):
        return tstencil._cface_per_step(st, x5, kernel, n_terms, kind, tables)

    monkeypatch.setattr(tl, "stencil_graph_conv_cface", per_step)
    y_s, g_s = run()
    assert _cuda.route_counts["per_step_cface"] == 1
    assert all(v == 0 for v in _cuda.launch_counts.values())
    _close(y_s, y_f)
    assert g_s.keys() == g_f.keys()
    for name in g_f:
        _close(g_s[name], g_f[name])


def _quick_start_narrow(m):
    """The quick_start classifier at nside 16, narrowed (K=5, 4/8 channels),
    its two convs in one cface segment."""
    return [
        m.HealpyChebyshev(K=5, Fout=4, activation="relu", use_bn=True),
        m.HealpyPool(p=1),
        m.HealpyChebyshev(K=5, Fout=8, activation="relu", use_bn=True),
        m.HealpyPool(p=1),
        m.Flatten(),
        m.Dense(4),
    ]


def _kitchen_sink(m):
    """Every layer family (``tests/test_networks.py:28-43``)."""
    return [
        m.HealpyPseudoConv(p=1, Fout=4),
        m.HealpyPool(p=1),
        m.HealpyChebyshev(K=5, Fout=8),
        m.Healpy_ViT(p=2, key_dim=8, num_heads=2, n_layers=2),
        m.HealpyPseudoConv_Transpose(p=2, Fout=16),
        m.HealpyPseudoConv(p=2, Fout=16),
        m.HealpyMonomial(K=5, Fout=32),
        m.HealpyBernstein(K=5, Fout=32),
        m.Healpy_Transformer(key_dim=8, num_heads=4),
        m.Healpy_ResidualLayer("CHEBY", layer_kwargs={"K": 5}),
        m.Flatten(),
        m.Dense(4),
    ]


@pytest.mark.parametrize("layers", [_quick_start_narrow, _kitchen_sink],
                         ids=["quick_start", "kitchen_sink"])
def test_summary_matches_jax(layers):
    """At the JAX suite's nside 16: ``summary()`` prints the JAX model's
    table line for line (display names, types, output shapes in the
    planned layouts, per-layer parameter counts, and the total of
    parameters and batch statistics without the graph tables), built or
    (through ``input_shape``) not."""
    n = 16
    npix = 12 * n * n
    shape = (2, npix, 1)
    jm = ds.HealpyGCNN(n, np.arange(npix), layers(jhp))
    jm.build(shape)
    want = []
    jm.summary(print_fn=want.append)
    got = []
    tm = dt.HealpyGCNN(n, np.arange(npix), layers(thp))
    tm.summary(input_shape=shape, print_fn=got.append)
    assert got[0].splitlines() == want[0].splitlines()
    assert tm._built_input_shape is None  # summarised through a copy
    tm.build(shape, device="cpu")
    got = []
    tm.summary(print_fn=got.append)
    assert got[0].splitlines() == want[0].splitlines()


def test_get_layer_and_param_key_match_jax():
    n = 8
    npix = 12 * n * n
    layers = lambda m: [m.HealpyChebyshev(K=3, Fout=2, use_bn=True),
                        m.HealpyPool(p=1), m.Flatten(), m.Dense(3)]
    jm = ds.HealpyGCNN(n, np.arange(npix), layers(jhp))
    tm = dt.HealpyGCNN(n, np.arange(npix), layers(thp)).build(
        (1, npix, 1), device="cpu")
    for i, name in enumerate(jm.layer_names):
        assert tm.get_layer(name=name) is tm.get_layer(index=i)
        assert (type(tm.get_layer(name=name)).__name__
                == type(jm.get_layer(name=name)).__name__)
        # the JAX key without its "layers_" prefix, the user layer's
        # module in the (cface-planned) module dict
        assert "layers_" + tm.param_key(i) == jm.param_key(i)
        assert tm.layers[tm.param_key(i)] is tm.get_layer(index=i)
    assert tm.get_layer(name="chebyshev").layout == "cface"
    assert "layers." + tm.param_key(0) + ".kernel" in tm.state_dict()

    def err(m, **kw):
        with pytest.raises(ValueError) as e:
            m.get_layer(**kw)
        return str(e.value)

    assert err(tm, name="conv") == err(jm, name="conv")
    assert err(tm) == err(jm) == "Provide a layer name or index."


def test_profiler_trace_holds_each_layer_scope(tmp_path):
    """``utils.profiling.trace`` writes a Chrome trace in which every layer
    of the model's loop has its scope, named ``{class}_{key}`` as the JAX
    package's ``named_scope``s; outside a profiler no scope is opened."""
    import json

    from deepsphere_tpu_torch.utils import timed_block, trace

    n = 8
    npix = 12 * n * n
    tm = dt.HealpyGCNN(n, np.arange(npix), [
        thp.HealpyChebyshev(K=3, Fout=2, use_bn=True), thp.HealpyPool(p=1),
        thp.HealpyMonomial(K=2, Fout=3), thp.Flatten(), thp.Dense(3)]).build(
        (2, npix, 1), device="cpu")
    x = torch.randn(2, npix, 1)
    with trace(str(tmp_path)) as prof:
        with timed_block("forward", sync=x):
            tm(x)
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    scopes = [f"{type(m).__name__}_{key}" for key, m in tm.layers.items()]
    assert "NestToCface_nesttocface_0" in scopes
    assert all(s in names for s in scopes), set(scopes) - names
    assert os.path.dirname(prof.trace_path) == str(tmp_path)


def test_export_keeps_its_kernel_nodes_with_the_scopes(tmp_path):
    """The quick_start classifier exported while a profiler records has the
    same graph as exported without one: the layer scopes stay out of the
    artifact, and its ``stencil_conv`` and ``strips`` nodes are one each
    per cface conv (conv 1 at nside 16)."""
    from deepsphere_tpu_torch.serve.export import ExportedModel
    from deepsphere_tpu_torch.utils import trace

    n = 16
    npix = 12 * n * n
    tm = dt.HealpyGCNN(n, np.arange(npix), _quick_start(thp)).build(
        (2, npix, 1), device="cpu")
    n_cface = sum(getattr(m, "layout", None) == "cface" and hasattr(m, "graph")
                  for m in tm.layers.values())
    plain = tm.export_inference(batch_size=2)
    with trace(str(tmp_path)):
        scoped = tm.export_inference(batch_size=2)
    counts = [ExportedModel(p).op_counts() for p in (plain, scoped)]
    assert counts[0] == counts[1] == {"strips": n_cface,
                                      "stencil_conv": n_cface}
    assert n_cface >= 1
    targets = [[str(nd.target) for nd in p.graph.nodes] for p in (plain, scoped)]
    assert targets[0] == targets[1]
    assert not any("profiler" in t for t in targets[1])
