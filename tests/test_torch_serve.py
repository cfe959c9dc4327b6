"""PyTorch port, serving export: ``torch.export`` inference artifacts
(``deepsphere_tpu_torch/serve/export.py``), on the CPU.

Case for case as ``tests/test_serve.py`` pins the JAX package's artifacts:

* roundtrip equality against the live model (save -> load -> call), with
  a polymorphic batch serving several batch sizes, and chunked ``predict``;
* a fixed-batch artifact, and ``predict``'s divisibility error on it;
* the build-first error contract;
* an artifact that replays in a fresh process whose graph builders raise
  (the counterpart of the JAX artifact's framework-free replay: here the
  process needs torch and the port's op registration, no graph build).

Beyond it: the port's artifact of a model carried over from the JAX one
(``interop.load_jax_variables``) gives the JAX artifact's logits
(``deepsphere_tpu.serve.export_inference(...).call``) to 1e-5 relative on
the same numpy inputs, and its graph holds one ``stencil_conv`` and one
``strips`` op node per cface conv; and a model whose routes differ across
the batch range refuses to export, naming ``batch_size=``, before it
traces (pure-Python plans with a patched SM count).
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
import deepsphere_tpu_torch as dt
from deepsphere_tpu import serve as jserve
from deepsphere_tpu.nn import healpy_layers as jhp
from deepsphere_tpu_torch import serve
from deepsphere_tpu_torch.interop import load_jax_variables
from deepsphere_tpu_torch.nn import healpy_layers as thp
from deepsphere_tpu_torch.serve import export as texport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_layers(hp):
    return [
        hp.HealpyChebyshev(K=5, Fout=8, activation="relu", use_bn=True),
        hp.HealpyPool(p=1),
        hp.Flatten(),
        hp.Dense(2, activation="softmax"),
    ]


@pytest.fixture(scope="module")
def tiny_model():
    """``tests/test_serve.py``'s model (nside 8, its one conv in cface at
    K=5: the corner rows are live), built on the CPU from a seed."""
    nside = 8
    npix = 12 * nside * nside
    model = dt.HealpyGCNN(nside=nside, indices=np.arange(npix),
                          layers=_tiny_layers(thp))
    model.build((16, npix, 1), seed=0, device="cpu")
    x = np.random.RandomState(0).normal(size=(5, npix, 1)).astype(np.float32)
    y = model.predict(x)
    return model, x, y


def test_roundtrip_polymorphic_batch(tiny_model, tmp_path):
    model, x, y = tiny_model
    path = tmp_path / "model.pt2"
    nbytes = model.save_exported(path, batch_size=None)
    assert nbytes > 0 and path.stat().st_size == nbytes

    em = serve.load_exported(path)
    # symbolic leading axis
    assert str(em.input_shape[0]) == "b"
    assert em.input_shape[1:] == (x.shape[1], 1)
    assert em.max_batch == serve.MAX_BATCH and em.device.type == "cpu"

    np.testing.assert_allclose(em(x).numpy(), y, atol=1e-5)
    # same artifact, different batch sizes (1 included)
    np.testing.assert_allclose(em(x[:3]).numpy(), y[:3], atol=1e-5)
    np.testing.assert_allclose(em(x[:1]).numpy(), y[:1], atol=1e-5)
    # chunked predict
    yp = em.predict(np.tile(x, (2, 1, 1)), batch_size=4)
    np.testing.assert_allclose(yp, np.tile(y, (2, 1)), atol=1e-5)


def test_fixed_batch_artifact(tiny_model, tmp_path):
    model, x, y = tiny_model
    path = tmp_path / "model5.pt2"
    model.save_exported(path, batch_size=5)
    em = serve.load_exported(path)
    assert em.input_shape == (5, x.shape[1], 1)
    np.testing.assert_allclose(em(x).numpy(), y, atol=1e-5)
    np.testing.assert_allclose(em.predict(np.tile(x, (2, 1, 1))),
                               np.tile(y, (2, 1)), atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        em.predict(x[:3])


def test_polymorphic_predict_chunks_to_max_batch(tiny_model):
    """``predict`` of a polymorphic artifact takes chunks of at most its
    ``max_batch``; the artifact holds copies of the weights: a later change
    to the live model does not reach it."""
    model, x, y = tiny_model
    em = serve.ExportedModel(serve.export_inference(model, max_batch=2))
    assert em.max_batch == 2 and em.input_shape[0] == "b"
    np.testing.assert_allclose(em.predict(x, batch_size=16), y, atol=1e-5)
    dense = model.layers["layer_3"].dense.weight
    saved = dense.detach().clone()
    with torch.no_grad():
        dense.add_(1.0)
    try:
        np.testing.assert_allclose(em.predict(x), y, atol=1e-5)
    finally:
        with torch.no_grad():
            dense.copy_(saved)


def test_export_bakes_the_given_variables(tiny_model):
    """``variables=`` (a ``state_dict``) goes into the artifact in place of
    the model's own weights, and the live model keeps its own; a
    ``state_dict`` that does not match the model is refused."""
    model, x, y = tiny_model
    npix = x.shape[1]
    other = dt.HealpyGCNN(nside=8, indices=np.arange(npix),
                          layers=_tiny_layers(thp))
    other.build((16, npix, 1), seed=1, device="cpu")
    want = other.predict(x)
    assert np.abs(want - y).max() > 1e-3
    em = serve.ExportedModel(serve.export_inference(
        model, other.state_dict(), batch_size=5))
    np.testing.assert_allclose(em(x).numpy(), want, atol=1e-5)
    np.testing.assert_allclose(model.predict(x), y, atol=0)
    bad = dict(other.state_dict())
    bad.pop("layers.layer_3.dense.bias")
    with pytest.raises(ValueError, match="missing"):
        serve.export_inference(model, bad)


def test_export_requires_build():
    nside = 8
    npix = 12 * nside * nside
    model = dt.HealpyGCNN(
        nside=nside, indices=np.arange(npix),
        layers=[thp.Flatten(), thp.Dense(2)],
    )
    with pytest.raises(ValueError, match="build"):
        model.export_inference()


def test_artifact_replays_without_graph_build(tiny_model, tmp_path):
    """The artifact replays in a fresh interpreter where every graph
    builder and stencil extraction raises and jax cannot be imported: the
    weights and graph tables are in the file."""
    model, x, y = tiny_model
    path = tmp_path / "model.pt2"
    model.save_exported(path, batch_size=None)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", y)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        import numpy as np
        import deepsphere_tpu_torch.graph as g
        import deepsphere_tpu_torch.graph.laplacian as lap
        import deepsphere_tpu_torch.graph.stencil as gst
        from deepsphere_tpu_torch import serve

        def refuse(*a, **k):
            raise AssertionError("the artifact built a graph")

        for mod in (g, lap):
            mod.build_sphere_graph = refuse
        gst.face_stencil = refuse
        lap.SphereGraph.face_stencil = refuse
        lap.SphereGraph.deep_stencil = refuse
        em = serve.load_exported({str(path)!r})
        x = np.load({str(tmp_path / "x.npy")!r})
        y = np.load({str(tmp_path / "y.npy")!r})
        np.testing.assert_allclose(em.predict(x, batch_size=5), y, atol=1e-5)
        np.testing.assert_allclose(em(x[:3]).numpy(), y[:3], atol=1e-5)
        assert em.op_counts() == {{"strips": 1, "stencil_conv": 1}}
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


def _two_conv_layers(hp):
    """Two Chebyshev K=5 convs in one cface segment (nside 16 -> 8), each
    with random BN statistics, then a Dense head (logits)."""
    return [
        hp.HealpyChebyshev(K=5, Fout=4, activation="relu", use_bn=True),
        hp.HealpyPool(p=1),
        hp.HealpyChebyshev(K=5, Fout=8, activation="relu", use_bn=True),
        hp.HealpyPool(p=1),
        hp.Flatten(),
        hp.Dense(3),
    ]


def test_artifact_matches_the_jax_artifact(tmp_path):
    """A JAX model's variables carried into the port: the port's artifact
    gives the JAX artifact's logits to 1e-5 relative, and the live port
    model's to 1e-5 absolute; its graph holds one K1 and one K4 node per
    cface conv."""
    nside = 16
    npix = 12 * nside * nside
    rng = np.random.RandomState(5)
    x = rng.normal(size=(4, npix, 1)).astype(np.float32)
    jm = ds.HealpyGCNN(nside, np.arange(npix), _two_conv_layers(jhp))
    jm.build((4, npix, 1))
    v = jax.tree_util.tree_map(np.array, {k: jm.variables[k]
                                          for k in ("params", "batch_stats")})
    for sub in v["batch_stats"].values():
        bn = sub["bn"]
        bn["mean"] = rng.normal(scale=0.3, size=bn["mean"].shape).astype(
            np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, size=bn["var"].shape).astype(
            np.float32)
    jexp = jserve.export_inference(jm, {**jm.variables, **v}, batch_size=None)
    want = np.asarray(jexp.call(jnp.asarray(x)))

    tm = dt.HealpyGCNN(nside, np.arange(npix), _two_conv_layers(thp))
    tm.build((4, npix, 1), device="cpu")
    load_jax_variables(tm, v)
    cface = [m for m in tm.layers.values()
             if getattr(m, "layout", None) == "cface" and hasattr(m, "graph")]
    assert len(cface) == 2
    path = tmp_path / "model.pt2"
    tm.save_exported(path)
    em = serve.load_exported(path)
    got = em(x).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, err
    np.testing.assert_allclose(got, tm.predict(x), rtol=0, atol=1e-5)
    assert em.op_counts() == {"strips": 2, "stencil_conv": 2}


def test_routes_differing_over_the_batch_range_refuse_to_export(monkeypatch):
    """On a card of (patched) 10^6 SMs, K1's plan for a 1 -> 1024 channel
    conv at nside 8 puts one batch index in each block, and its grid's z
    extent passes 65,535 at batch 2048: that batch takes the lap chain,
    every smaller one the fused conv.  A polymorphic export up to 2048
    raises, naming ``batch_size=``, before it traces; up to 2047 it exports
    with the fused route held on the conv."""
    nside = 8
    npix = 12 * nside * nside
    model = dt.HealpyGCNN(nside, np.arange(npix), [
        thp.HealpyChebyshev(K=3, Fout=1024), thp.HealpyPool(p=3),
        thp.Flatten(), thp.Dense(2)])
    model.build((1, npix, 1), device="cpu")
    conv = model.layers["layer_0"]
    assert conv.layout == "cface"
    monkeypatch.setattr(texport, "_sm_count", lambda dev: 10 ** 6)
    assert conv.batch_route((2047, 1, 12, 8, 128), 10 ** 6) == "fused"
    assert conv.batch_route((2048, 1, 12, 8, 128), 10 ** 6) == "chain"

    traced = []
    real = torch.export.export
    monkeypatch.setattr(torch.export, "export",
                        lambda *a, **k: traced.append(1) or real(*a, **k))
    with pytest.raises(ValueError, match="batch_size=") as e:
        serve.export_inference(model, max_batch=2048)
    assert "fused at batches 1..2047; chain at batches 2048..2048" in str(
        e.value)
    assert not traced and conv._held_route is None

    seen = []
    hook = conv.register_forward_pre_hook(
        lambda mod, args: seen.append(mod._held_route))
    try:
        program = serve.export_inference(model, max_batch=2047)
    finally:
        hook.remove()
    assert traced and seen[-1] == "fused" and conv._held_route is None
    x = np.random.RandomState(1).normal(size=(2, npix, 1)).astype(np.float32)
    em = serve.ExportedModel(program)
    assert em.max_batch == 2047
    np.testing.assert_allclose(em(x).numpy(), model.predict(x), atol=1e-5)
