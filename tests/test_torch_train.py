"""PyTorch port, training: the fused conv's backward, the losses, Adam, one
train step of a small classifier, the Keras-style loop, and the port's
independence from the JAX package's files.

Every comparison feeds the same numpy inputs to the JAX function and to
its port.  The JAX conv runs its Pallas kernels in interpret mode, as
``tests/test_pallas.py`` does.  Tolerances (max|d| / max|want|): 1e-5 for
one conv and its gradients, float32 on both sides; 1e-4 for whole-model
gradient trees, where batch norm's one-pass variance (E[x^2] - E[x]^2) in
float32 and two BN layers amplify the differences of summation order.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepsphere_tpu as ds
import deepsphere_tpu.graph as jgraph
import deepsphere_tpu.ops.pallas_stencil as jps
import deepsphere_tpu.ops.stencil as jstencil
import deepsphere_tpu.train.losses as jlosses
import deepsphere_tpu_torch as dt
import deepsphere_tpu_torch.graph as tgraph
import deepsphere_tpu_torch.train.losses as tlosses
from deepsphere_tpu.nn import healpy_layers as jhp
from deepsphere_tpu_torch import config
from deepsphere_tpu_torch.interop import export_jax_variables, load_jax_variables
from deepsphere_tpu_torch.nn import healpy_layers as thp
from deepsphere_tpu_torch.ops import _cuda
from deepsphere_tpu_torch.ops import fused_stencil as tfs
from deepsphere_tpu_torch.ops.stencil import as_tensors, stencil_tables
from deepsphere_tpu_torch.train import (
    EarlyStopping,
    LambdaCallback,
    ModelCheckpoint,
    Trainer,
    restore_checkpoint,
    save_checkpoint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
TREE_TOL = 1e-4

_GRAPHS = {}
_JAX_GRADS = {}


def _graphs(n, k=8):
    if (n, k) not in _GRAPHS:
        _GRAPHS[n, k] = (jgraph.build_sphere_graph(n, k=k, method="grid"),
                         tgraph.build_sphere_graph(n, k=k, method="grid"))
    return _GRAPHS[n, k]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _close_trees(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _close_trees(got[k], want[k], tol)
        else:
            _close(got[k], want[k], tol)


@pytest.fixture(autouse=True)
def _defaults():
    _cuda.reset_launch_counts()
    yield
    config.set_fused_dw(True)


# ---------------------------------------------------------------------------
# the fused conv's backward
# ---------------------------------------------------------------------------

# (nside, k, kind, scale, K): corrections live but small (K <= 5,
# nside >= 16), one radius-2 stencil (k=20)
_CONV_CASES = [(16, 8, "cheby", 0.75, 5), (16, 8, "mono", 1.0, 4),
               (16, 20, "cheby", 0.75, 3)]


def _conv_case(n, k, kind, scale, K):
    """Inputs (garbage in every halo lane, Fin != Fout) and the JAX
    package's (y, dx, dkernel) through its interpret-mode Pallas conv."""
    key = (n, k, kind, scale, K)
    if key not in _JAX_GRADS:
        r = 2 if k == 20 else 1
        h = r * (K - 1)
        gj, gt = _graphs(n, k)
        sj, st = gj.face_stencil(scale, n_steps=h), gt.face_stencil(scale, n_steps=h)
        assert st.corr_out_face.shape[0] > 0
        _, P_l = tfs.cfp_geometry(n, h)
        rng = np.random.RandomState(5)
        B, Fin, Fout = 2, 3, 2
        x = rng.normal(size=(B * Fin, 12, n, P_l)).astype(np.float32)
        kern = rng.normal(size=(Fin * K, Fout)).astype(np.float32)
        dy = rng.normal(size=(B * Fout, 12, n, P_l)).astype(np.float32)
        jt = {kk: jnp.asarray(v) for kk, v in jstencil.stencil_tables(sj).items()}
        y, vjp = jax.vjp(
            lambda xc, kk: jps.fused_stencil_conv_cfp(
                sj, jt, xc, kk, K, kind, B, interpret=True),
            jnp.asarray(x), jnp.asarray(kern))
        dx, dk = vjp(jnp.asarray(dy))
        _JAX_GRADS[key] = (st, h, B, x, kern, dy,
                           (np.asarray(y), np.asarray(dx), np.asarray(dk)))
    return _JAX_GRADS[key]


@pytest.mark.parametrize("fused_dw", [True, False])
@pytest.mark.parametrize("case", _CONV_CASES)
def test_conv_gradients_match_jax(case, fused_dw):
    """dx and dkernel of the port's autograd function, on either backward
    route, against ``jax.vjp`` through the JAX package's fused conv; the
    cotangent has garbage in its halo lanes, which neither reads."""
    n, k, kind, scale, K = case
    st, h, B, x, kern, dy, (y_j, dx_j, dk_j) = _conv_case(*case)
    config.set_fused_dw(fused_dw)
    tables = as_tensors(stencil_tables(st))
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(kern).requires_grad_()
    y = tfs.fused_stencil_conv_cfp(st, tables, xt, kt, K, kind, B)
    dx, dk = torch.autograd.grad(y, (xt, kt), torch.from_numpy(dy))
    inner = slice(h, h + n)
    _close(y.detach()[..., inner].numpy(), y_j[..., inner])
    _close(dx[..., inner].numpy(), dx_j[..., inner])
    _close(dk.numpy(), dk_j)
    assert dx[..., :h].abs().max() == 0 and dx[..., h + n:].abs().max() == 0
    assert all(v == 0 for v in _cuda.launch_counts.values())


@pytest.mark.parametrize("fused_dw", [True, False])
@pytest.mark.parametrize("kind", ["cheby", "mono"])
def test_conv_gradcheck_float64(kind, fused_dw):
    """``torch.autograd.gradcheck`` of the plain path in float64 at nside 8
    (K=3: the correction covers most rows), both backward routes."""
    n, K, B = 8, 3, 1
    _, gt = _graphs(n)
    st = gt.face_stencil(0.75 if kind == "cheby" else 1.0, n_steps=K - 1)
    tables = as_tensors(stencil_tables(st))
    config.set_fused_dw(fused_dw)
    _, P_l = tfs.cfp_geometry(n, K - 1)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.normal(size=(B * 2, 12, n, P_l))).requires_grad_()
    kern = torch.from_numpy(rng.normal(size=(2 * K, 3))).requires_grad_()
    f = lambda xc, kk: tfs.fused_stencil_conv_cfp(st, tables, xc, kk, K, kind, B)
    assert f(x, kern).dtype == torch.float64
    assert torch.autograd.gradcheck(f, (x, kern), fast_mode=True)


def test_two_routes_agree_and_skip_unneeded_dx(rng, monkeypatch):
    """Both backward routes give the same dkernel; without an input
    gradient the two-kernel route skips its dx conv."""
    calls = []
    conv = tfs.run_stencil_kernel
    monkeypatch.setattr(tfs, "run_stencil_kernel",
                        lambda *a, **kw: calls.append(1) or conv(*a, **kw))
    n, K, B = 16, 5, 2
    _, gt = _graphs(n)
    st = gt.face_stencil(0.75, n_steps=K - 1)
    tables = as_tensors(stencil_tables(st))
    _, P_l = tfs.cfp_geometry(n, K - 1)
    x = torch.from_numpy(rng.normal(size=(B * 2, 12, n, P_l)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(B * 4, 12, n, P_l)).astype(np.float32))
    kern = torch.from_numpy(rng.normal(size=(2 * K, 4)).astype(np.float32))
    dks = []
    for fused in (True, False):
        config.set_fused_dw(fused)
        kt = kern.clone().requires_grad_()
        y = tfs.fused_stencil_conv_cfp(st, tables, x, kt, K, "cheby", B)
        (dk,) = torch.autograd.grad(y, (kt,), dy)
        dks.append(dk)
        assert len(calls) == 1  # the forward's conv only
        calls.clear()
    _close(dks[1].numpy(), dks[0].numpy())


# ---------------------------------------------------------------------------
# losses, metrics, Adam
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jlosses._LOSSES))
def test_losses_match_jax(rng, name):
    logits = rng.normal(size=(6, 4)).astype(np.float32)
    if name.startswith("sparse"):
        y = rng.randint(0, 4, size=6)
    elif "binary" in name:
        y = rng.randint(0, 2, size=(6, 4)).astype(np.float32)
    else:
        y = rng.uniform(size=(6, 4)).astype(np.float32)
    pred = logits
    if "crossentropy" in name and "logits" not in name:
        pred = np.array(jax.nn.sigmoid(logits) if "binary" in name
                        else jax.nn.softmax(logits))
    want = jlosses.resolve_loss(name)(jnp.asarray(y), jnp.asarray(pred))
    got = tlosses.resolve_loss(name)(torch.from_numpy(y), torch.from_numpy(pred))
    _close(got.numpy(), np.asarray(want), 1e-6)


@pytest.mark.parametrize("name", sorted(jlosses._METRICS))
def test_metrics_match_jax(rng, name):
    pred = rng.normal(size=(9, 5)).astype(np.float32)
    y = (rng.randint(0, 5, size=9) if "acc" in name
         else rng.normal(size=(9, 5)).astype(np.float32))
    want = jlosses.resolve_metric(name)(jnp.asarray(y), jnp.asarray(pred))
    got = tlosses.resolve_metric(name)(torch.from_numpy(y), torch.from_numpy(pred))
    _close(got.numpy(), np.asarray(want), 1e-6)
    with pytest.raises(ValueError, match="Unknown"):
        tlosses.resolve_metric("nope")


def test_adam_matches_optax(rng):
    """torch.optim.Adam (the trainer's float optimizer) against optax.adam
    over 5 steps of identical gradients."""
    shapes = [(7, 3), (3,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    opt = optax.adam(1e-3)
    pj = [jnp.asarray(p) for p in p0]
    state = opt.init(pj)
    pt = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    topt = torch.optim.Adam(pt, lr=1e-3)
    for g in grads:
        upd, state = opt.update([jnp.asarray(a) for a in g], state, pj)
        pj = optax.apply_updates(pj, upd)
        for p, a in zip(pt, g):
            p.grad = torch.from_numpy(a)
        topt.step()
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# one train step of a small classifier, against the JAX trainer
# ---------------------------------------------------------------------------

_LOSS = "sparse_categorical_crossentropy_from_logits"


def _small(m):
    """quick_start-shaped: two cface Chebyshev convs with BN, pools, Dense."""
    return [m.HealpyChebyshev(K=5, Fout=4, activation="relu", use_bn=True),
            m.HealpyPool(p=1),
            m.HealpyChebyshev(K=5, Fout=6, activation="relu", use_bn=True),
            m.HealpyPool(p=1), m.Flatten(), m.Dense(3)]


def test_train_on_batch_matches_jax(rng):
    """Loss, the whole gradient tree and the updated BN statistics of one
    ``train_on_batch`` at nside 16 against the JAX trainer's step from the
    same variables (random BN statistics, so the update counts)."""
    n = 16
    npix = 12 * n * n
    x = rng.normal(size=(4, npix, 2)).astype(np.float32)
    y = rng.randint(0, 3, size=4)
    jm = ds.HealpyGCNN(n, np.arange(npix), _small(jhp))
    # jitted: ``jm.init(0, x)``'s variables in a fraction of its eager time
    v = jax.jit(jm.module.init)(jax.random.key(0), jnp.asarray(x))
    vv = jax.tree_util.tree_map(
        np.array, {k: v[k] for k in ("params", "batch_stats")})
    for sub in jax.tree_util.tree_leaves(vv["batch_stats"],
                                         is_leaf=lambda d: "mean" in d):
        sub["mean"] = rng.normal(scale=0.3, size=sub["mean"].shape).astype(np.float32)
        sub["var"] = rng.uniform(0.5, 2.0, size=sub["var"].shape).astype(np.float32)
    static = {k: v[k] for k in v if k not in ("params", "batch_stats")}
    loss_fn = jlosses.resolve_loss(_LOSS)

    def jloss(p):
        out = jm.module.apply({**static, "params": p,
                               "batch_stats": vv["batch_stats"]},
                              jnp.asarray(x), training=True,
                              mutable=["batch_stats"])[0]
        return loss_fn(jnp.asarray(y), out)

    g_j = jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(vv["params"]))
    jtr = jm.compile(optimizer=1e-3, loss=_LOSS, metrics=["accuracy"])
    jtr.init_state({**v, **jax.tree_util.tree_map(jnp.asarray, vv)})
    logs_j = jtr.train_on_batch(x, y)
    stats_j = jax.tree_util.tree_map(np.asarray, jtr.state.batch_stats)

    tm = dt.HealpyGCNN(n, np.arange(npix), _small(thp))
    tm.build(x.shape, device="cpu")
    load_jax_variables(tm, vv)
    tm.compile(optimizer=1e-3, loss=_LOSS, metrics=["accuracy"])
    logs_t = tm._trainer.train_on_batch(x, y)
    assert logs_t["accuracy"] == logs_j["accuracy"]
    _close(logs_t["loss"], logs_j["loss"], TOL)
    _close_trees(export_jax_variables(tm, grads=True), g_j, TREE_TOL)
    _close_trees(export_jax_variables(tm)["batch_stats"], stats_j, TOL)
    assert tm._trainer.step == 1 and tm.training


# ---------------------------------------------------------------------------
# the Keras-style loop, callbacks, checkpoints
# ---------------------------------------------------------------------------


def _tiny_model(seed=0):
    n = 8
    npix = 12 * n * n
    m = dt.HealpyGCNN(n, np.arange(npix), [
        thp.HealpyChebyshev(K=3, Fout=4, activation="relu", use_bn=True),
        thp.HealpyPool(p=1), thp.Flatten(), thp.Dense(2)])
    return m.build((4, npix, 1), seed=seed, device="cpu"), npix


def _bump_data(npix, n_maps, seed):
    """Two classes: class 1 carries a smooth polar bump."""
    from deepsphere_tpu_torch.sphere import healpix as hp

    r = np.random.RandomState(seed)
    labels = r.randint(0, 2, size=n_maps)
    x = r.normal(size=(n_maps, npix, 1)).astype(np.float32)
    v = hp.pix2vec(8, np.arange(npix), nest=True)
    bump = np.exp(-((v - np.array([0, 0, 1.0])) ** 2).sum(1) * 4)
    x[labels == 1, :, 0] += 2.0 * bump.astype(np.float32)
    return x, labels


def test_fit_with_callbacks_and_weights_roundtrip(tmp_path):
    """fit (trailing partial batch, validation, seeded shuffle) with
    EarlyStopping(restore_best_weights) and ModelCheckpoint; then
    save_weights/load_weights onto a model built from another seed gives
    identical predictions."""
    m, npix = _tiny_model()
    x, y = _bump_data(npix, 22, 1)
    vx, vy = _bump_data(npix, 8, 2)
    m.compile(optimizer=1e-2, loss=_LOSS, metrics=["accuracy"])
    seen = []
    es = EarlyStopping(monitor="val_loss", patience=1, restore_best_weights=True)
    ck = ModelCheckpoint(str(tmp_path / "w-{epoch:02d}.pt"))
    hist = m.fit(x, y, batch_size=8, epochs=6, validation_data=(vx, vy),
                 verbose=0, callbacks=[es, ck, LambdaCallback(
                     on_epoch_end=lambda e, logs: seen.append(e))])
    epochs = len(hist["loss"])
    assert seen == list(range(epochs))
    assert set(hist) == {"loss", "accuracy", "val_loss", "val_accuracy"}
    assert all(np.isfinite(v) for vals in hist.values() for v in vals)
    assert m._trainer.step == 3 * epochs  # 8 + 8 + 6 maps per epoch
    assert os.path.exists(tmp_path / f"w-{epochs:02d}.pt")
    best = min(hist["val_loss"])
    _close(m.evaluate(vx, vy, batch_size=8, verbose=0)["loss"], best, 1e-5)

    path = str(tmp_path / "weights.pt")
    m.save_weights(path)
    other, _ = _tiny_model(seed=9)
    other.load_weights(path)
    np.testing.assert_array_equal(other.predict(vx, batch_size=3),
                                  m.predict(vx, batch_size=3))


def test_checkpoint_keeps_the_newest_and_restores(tmp_path):
    m, npix = _tiny_model()
    x, y = _bump_data(npix, 8, 3)
    tr = m.compile(optimizer=1e-3, loss=_LOSS)
    for _ in range(4):
        tr.train_on_batch(x, y)
        save_checkpoint(tmp_path, tr.state, keep=3)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_2.pt", "ckpt_3.pt", "ckpt_4.pt"]
    want = m.predict(x)
    tr.train_on_batch(x, y)
    assert not np.array_equal(m.predict(x), want)
    payload = restore_checkpoint(tmp_path, target=tr)
    assert payload["step"] == 4 and tr.step == 4
    np.testing.assert_array_equal(m.predict(x), want)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "none")


def test_trainer_errors():
    m, npix = _tiny_model()
    with pytest.raises(ValueError, match="compile"):
        m.evaluate(np.zeros((1, npix, 1)), np.zeros(1))
    with pytest.raises(TypeError, match="batch_sharding"):
        Trainer(m, data_sharding=object())
    with pytest.raises(ValueError, match="Unknown loss"):
        m.compile(loss="hinge")
    fresh = dt.HealpyGCNN(8, np.arange(768), [thp.Flatten(), thp.Dense(2)])
    with pytest.raises(ValueError, match="Build the model"):
        Trainer(fresh).init_state()


def test_build_defaults_to_the_card():
    """Without a card, ``build`` raises unless the CPU is asked for."""
    m = dt.HealpyGCNN(8, np.arange(768), [thp.Flatten(), thp.Dense(2)])
    if torch.cuda.is_available():
        pytest.skip("a card is present: build would succeed on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.build((1, 768, 1))
    m.build((1, 768, 1), device="cpu")
    assert next(m.parameters()).device.type == "cpu"


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------


def test_native_source_copy_is_byte_equal():
    a = os.path.join(REPO, "deepsphere_tpu", "native", "healpix_core.cpp")
    b = os.path.join(REPO, "deepsphere_tpu_torch", "native", "healpix_core.cpp")
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_port_reads_no_path_under_the_jax_package():
    """No module of the port imports the JAX package, jax or flax, or names
    the JAX package's directory in a string it could open (docstrings
    aside)."""
    root = os.path.join(REPO, "deepsphere_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
             if f.endswith(".py")]
    assert len(files) > 20
    for path in files:
        tree = ast.parse(open(path).read())
        docs = {id(b[0].value) for b in
                [getattr(nd, "body", None) for nd in ast.walk(tree)]
                if isinstance(b, list) and b and isinstance(b[0], ast.Expr)
                and isinstance(b[0].value, ast.Constant)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                names = []
            for nm in names:
                assert nm.split(".")[0] not in ("jax", "flax", "deepsphere_tpu"), (path, nm)
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                s = node.value.replace("\\", "/")
                assert s != "deepsphere_tpu" and "deepsphere_tpu/" not in s, (path, s)


@pytest.mark.parametrize("fused_dw", [True, False])
def test_remat_step_matches_plain(rng, monkeypatch, fused_dw):
    """``remat=True`` (each layer checkpointed, its forward recomputed in
    the backward) is a pure memory/work trade, as in the JAX package
    (``tests/test_networks.py::test_remat_model_matches_plain``): after two
    ``train_on_batch`` steps the losses, the gradients, the parameters and
    the BN running statistics equal the plain model's, which holds only if
    the recompute leaves the statistics alone (flax's ``nn.remat`` updates
    them once a step).  The parameter trees are the same, and a cface conv
    runs its forward kernels' plain versions twice a step."""
    n = 8
    npix = 12 * n * n

    def layers():
        return [thp.HealpyChebyshev(K=5, Fout=6, activation="relu", use_bn=True),
                thp.HealpyPool(p=1, pool_type="AVG"),
                thp.HealpyMonomial(K=3, Fout=4, activation="elu", use_bn=True),
                thp.Flatten(), thp.Dense(3)]

    plain = dt.HealpyGCNN(n, np.arange(npix), layers()).build(
        (4, npix, 1), seed=2, device="cpu")
    remat = dt.HealpyGCNN(n, np.arange(npix), layers(), remat=True).build(
        (4, npix, 1), seed=2, device="cpu")
    assert remat.remat and not plain.remat
    assert list(plain.state_dict()) == list(remat.state_dict())
    x = rng.normal(size=(8, npix, 1)).astype(np.float32)
    y = rng.randint(0, 3, size=8)
    config.set_fused_dw(fused_dw)
    try:
        for m in (plain, remat):
            m.compile(optimizer=1e-3, loss=_LOSS)
        calls = {}
        orig = tfs.fused_stencil_conv_cfp
        for m in (plain, remat):
            def counting(*a, _key=m.remat, **kw):
                calls[_key] = calls.get(_key, 0) + 1
                return orig(*a, **kw)

            monkeypatch.setattr(tfs, "fused_stencil_conv_cfp", counting)
            m.logs = [m._trainer.train_on_batch(x[4 * i:4 * i + 4],
                                                y[4 * i:4 * i + 4])
                      for i in range(2)]
    finally:
        config.set_fused_dw(True)
    assert [lg["loss"] for lg in plain.logs] == [lg["loss"] for lg in remat.logs]
    for a, b in ((export_jax_variables(plain, grads=True),
                  export_jax_variables(remat, grads=True)),
                 (export_jax_variables(plain), export_jax_variables(remat))):
        for u, w in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            assert np.array_equal(u, w)
    # one cface conv: one forward a step, and one recompute with remat
    assert calls == {False: 2, True: 4}
    # in eval, and without autograd, nothing is checkpointed
    remat.eval()
    with torch.no_grad():
        a = remat(torch.from_numpy(x[:4]))
    plain.eval()
    with torch.no_grad():
        assert torch.equal(a, plain(torch.from_numpy(x[:4])))
