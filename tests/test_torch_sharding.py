"""PyTorch port, DP x face-sharded execution over a device mesh, against the
JAX package.

* The edge bands, the strips of a face shard built from gathered bands, and
  the halo-sharded ELLPACK tables: exact against the JAX functions.
* The multi-rank paths run on ``gloo`` CPU ranks started with
  ``torch.multiprocessing.spawn`` (one thread each, a file store under
  ``tmp_path``, a 60 s collective timeout and a deadline on the whole
  spawn): the face-sharded fused conv (y, dx, dW within 1e-5 of their max)
  against the JAX package's unsharded ``fused_stencil_conv_cfp`` in
  interpret mode, and one train step of a ``dryrun_multichip``-like model
  (face-sharded cface conv with batch norm, pool, a nest conv on the
  halo-sharded ELLPACK, Flatten, Dense; loss 1e-5, gradients 1e-4, BN
  statistics 1e-5) against the JAX package's unsharded step from the same
  weights, on (data 2 x pixel 2) and (1 x 4) meshes; ``data_iterator``'s
  rows and masks against the JAX iterator's global batches.

The rank workers are functions of this module that import only torch,
numpy and the port: a spawned rank never loads jax.
"""

import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import deepsphere_tpu_torch as dt
import deepsphere_tpu_torch.graph as tgraph
from deepsphere_tpu_torch.interop import export_jax_variables, load_jax_variables
from deepsphere_tpu_torch.nn import healpy_layers as thp
from deepsphere_tpu_torch.ops import _cuda
from deepsphere_tpu_torch.ops import fused_stencil as tfs
from deepsphere_tpu_torch.ops import stencil as tstencil
from deepsphere_tpu_torch.ops import strips as tstrips
from deepsphere_tpu_torch.parallel import (
    ShardConfig,
    batch_sharding,
    data_iterator,
    face_shard_tables,
    face_sharded_cfp_conv,
    global_batch,
    make_mesh,
    shard_ellpack,
)
from deepsphere_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    exchange_gather,
    shard,
    unshard,
)

TOL = 1e-5
TREE_TOL = 1e-4
_LOSS = "sparse_categorical_crossentropy_from_logits"
_SPAWN_DEADLINE = 180  # seconds for one multi-rank run, start-up included

# the sharded conv's case (the JAX package's own sharded-conv test's)
_CONV = dict(n=16, K=3, B=4, Fin=2, Fout=3)
# the train step's model and batch
_STEP = dict(n=8, B=4, F=2, classes=3)
# the data iterator's case (as the JAX package's iterator test)
_DATA = dict(n=22, batch=8, seed=1)

_GRAPHS = {}


def _tgraph(n):
    if n not in _GRAPHS:
        _GRAPHS[n] = tgraph.build_sphere_graph(n, k=8, method="grid")
    return _GRAPHS[n]


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


def _flat(tree, pre=""):
    """Nested dict of arrays -> {"a/b/c": array} (for npz files)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = np.asarray(v)
    return out


def _nest(flat):
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = np.asarray(v)
    return out


def _step_layers(m):
    """dryrun_multichip-like: a cface conv with BN (face-sharded under a
    mesh), a pool, a conv at nside 4 (the halo-sharded ELLPACK under a
    mesh), Flatten, Dense."""
    return [m.HealpyChebyshev(K=3, Fout=4, activation="relu", use_bn=True),
            m.HealpyPool(p=1),
            m.HealpyChebyshev(K=3, Fout=5, activation="relu", use_bn=True),
            m.Flatten(), m.Dense(_STEP["classes"])]


# ---------------------------------------------------------------------------
# the ranks' side (spawned processes: torch, numpy and the port only)
# ---------------------------------------------------------------------------


def _rank_conv(cfg, inp, out):
    """The face-sharded conv on this rank's rows and faces; its y, dx and
    the kernel gradient summed over the data group."""
    c = _CONV
    n, K, h = c["n"], c["K"], c["K"] - 1
    st = _tgraph(n).face_stencil(0.75, n_steps=h)
    D, S = cfg.n_data_shards, cfg.n_pixel_shards
    d, p = cfg.mesh.get_local_rank(cfg.data_axis), cfg.pixel_rank
    Bl, Fl = c["B"] // D, 12 // S
    x5 = inp["conv_x"].reshape(c["B"], c["Fin"], 12, n, -1)
    xl = x5[d * Bl:(d + 1) * Bl, :, p * Fl:(p + 1) * Fl]
    xl = torch.from_numpy(np.ascontiguousarray(
        xl.reshape(Bl * c["Fin"], Fl, n, -1))).requires_grad_()
    kern = torch.from_numpy(inp["conv_kernel"]).requires_grad_()
    tables = tstencil.as_tensors(face_shard_tables(st, p, S))
    y = face_sharded_cfp_conv(st, tables, xl, kern, K, "cheby", Bl,
                              cfg.pixel_group)
    torch.sin(y[..., h:h + n]).sum().backward()
    dk = kern.grad.clone()
    dist.all_reduce(dk, group=cfg.data_group)
    out.update(conv_y=y.detach().numpy(), conv_dx=xl.grad.numpy(),
               conv_dk=dk.numpy())


def _rank_step(cfg, inp, out):
    """One train_on_batch of the sharded model from the JAX weights, on
    this data rank's rows; then fit and evaluate on a small set."""
    s = _STEP
    n = s["n"]
    npix = 12 * n * n
    mesh = cfg.mesh
    m = dt.HealpyGCNN(n, np.arange(npix), _step_layers(thp), shard_cfg=cfg)
    m.build((s["B"], npix, s["F"]), seed=5, device="cpu")
    out["plan"] = np.array([
        type(l).__name__ + ("@" + l.layout if hasattr(l, "layout") else "")
        + ("*" if getattr(l, "shard_cfg", None) is not None else "")
        for l in m.layers.values()])
    load_jax_variables(m, _nest({k[2:]: v for k, v in inp.items()
                                 if k.startswith("v/")}))
    tr = m.compile(optimizer=1e-3, loss=_LOSS, metrics=["accuracy"],
                   data_sharding=batch_sharding(mesh))
    xb, yb = global_batch(mesh, (inp["step_x"], inp["step_y"]))
    logs = tr.train_on_batch(xb, yb)
    out["step_loss"] = np.array([logs["loss"], logs["accuracy"]])
    out.update({"g/" + k: v
                for k, v in _flat(export_jax_variables(m, grads=True)).items()})
    out.update({"s/" + k: v for k, v in
                _flat(export_jax_variables(m)["batch_stats"]).items()})
    hist = tr.fit(inp["fit_x"], inp["fit_y"], batch_size=4, epochs=2, seed=3,
                  verbose=0)
    ev = tr.evaluate(inp["fit_x"][:6], inp["fit_y"][:6], batch_size=4,
                    verbose=0)
    out["fit"] = np.array(hist["loss"] + hist["accuracy"]
                          + [ev["loss"], ev["accuracy"]])


def _rank_data(cfg, inp, out):
    """This rank's rows and masks of every batch of the JAX iterator test's
    case, and ``global_batch``'s rows."""
    c = _DATA
    x = np.random.RandomState(0).normal(size=(c["n"], 48, 1)).astype(np.float32)
    rows, masks = [], []
    for xb, yb, mask in data_iterator(cfg.mesh, x, np.arange(c["n"]),
                                      batch_size=c["batch"], seed=c["seed"],
                                      drop_remainder=False):
        assert np.array_equal(xb, x[yb])
        rows.append(yb)
        masks.append(mask)
    out["data_rows"] = np.stack(rows)
    out["data_masks"] = np.stack(masks)


def _rank_collectives(cfg, inp, out):
    """Each collective's backward against its expected gradient, over the
    pixel group: shard -> all-gather, unshard -> own slice (no sum),
    exchange_gather -> sum then own slice, all_reduce_sum -> all-reduce."""
    g = cfg.pixel_group
    S, r = dist.get_world_size(g), dist.get_rank(g)
    w = [np.random.RandomState(40 + q).normal(size=(2 * S, 3)) for q in range(S)]
    w_r = torch.from_numpy(w[r])
    ok = []

    x = torch.ones(2 * S, 3, dtype=torch.float64, requires_grad=True)
    (shard(x, 0, g) * w_r[:2]).sum().backward()
    ok.append(np.allclose(x.grad.numpy(), np.concatenate([v[:2] for v in w])))

    x = torch.ones(2, 3, dtype=torch.float64, requires_grad=True)
    (unshard(x, 0, g) * torch.from_numpy(w[0])).sum().backward()
    ok.append(np.allclose(x.grad.numpy(), w[0][2 * r:2 * r + 2]))

    x = torch.ones(2, 3, dtype=torch.float64, requires_grad=True)
    (exchange_gather(x, g) * w_r).sum().backward()
    ok.append(np.allclose(x.grad.numpy(),
                          sum(v[2 * r:2 * r + 2] for v in w)))

    x = torch.ones(2 * S, 3, dtype=torch.float64, requires_grad=True)
    (all_reduce_sum(x, g) * w_r).sum().backward()
    ok.append(np.allclose(x.grad.numpy(), sum(w)))
    out["collectives_ok"] = np.array(ok)


def _rank_main(rank, world, shape, store, workdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        cfg = ShardConfig(make_mesh(shape, ("data", "pixel"), device_type="cpu"))
        inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
        out = {}
        for part in (_rank_conv, _rank_step, _rank_data, _rank_collectives):
            part(cfg, inp, out)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _spawn(shape, workdir):
    """Run ``_rank_main`` on every rank of a ``shape`` mesh; a rank that
    raises, or a run past the deadline, fails the test."""
    world = shape[0] * shape[1]
    store = os.path.join(workdir, "store")
    ctx = mp.spawn(_rank_main, args=(world, shape, store, workdir),
                   nprocs=world, join=False)
    deadline = time.monotonic() + _SPAWN_DEADLINE
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{shape} ranks still running after "
                                   f"{_SPAWN_DEADLINE} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
            for r in range(world)]


# ---------------------------------------------------------------------------
# the JAX side (this process)
# ---------------------------------------------------------------------------

_JAX = {}


def _jax_refs():
    """Inputs from numpy seeds and the JAX package's unsharded results:
    the fused conv's y and gradients (interpret mode), the variables, loss,
    gradients and BN statistics of one train step, a data iterator run."""
    if _JAX:
        return _JAX
    import jax
    import jax.numpy as jnp

    import deepsphere_tpu as ds
    import deepsphere_tpu.graph as jgraph
    import deepsphere_tpu.ops.pallas_stencil as jps
    import deepsphere_tpu.ops.stencil as jstencil
    import deepsphere_tpu.train.losses as jlosses
    from deepsphere_tpu.nn import healpy_layers as jhp
    from deepsphere_tpu.parallel import data_iterator as jdata_iterator
    from deepsphere_tpu.parallel import make_mesh as jmake_mesh

    c = _CONV
    n, K, h = c["n"], c["K"], c["K"] - 1
    sj = jgraph.build_sphere_graph(n, k=8, method="grid").face_stencil(
        0.75, n_steps=h)
    assert sj.corr_src.shape[0] > 0  # the corner corrections are live
    _, P_l = tfs.cfp_geometry(n, h)
    rng = np.random.RandomState(7)
    x = rng.normal(size=(c["B"] * c["Fin"], 12, n, P_l)).astype(np.float32)
    kern = rng.normal(size=(c["Fin"] * K, c["Fout"])).astype(np.float32)
    jt = {k: jnp.asarray(v) for k, v in jstencil.stencil_tables(sj).items()}

    def loss(xc, kk):
        y = jps.fused_stencil_conv_cfp(sj, jt, xc, kk, K, "cheby", c["B"],
                                       interpret=True)
        return jnp.sum(jnp.sin(y[..., h:h + n])), y

    (_, y), (gx, gk) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(kern))
    _JAX["conv"] = (x, kern, np.asarray(y), np.asarray(gx), np.asarray(gk))

    s = _STEP
    npix = 12 * s["n"] ** 2
    rng = np.random.RandomState(8)
    xs = rng.normal(size=(s["B"], npix, s["F"])).astype(np.float32)
    ys = rng.randint(0, s["classes"], size=s["B"])
    jm = ds.HealpyGCNN(s["n"], np.arange(npix), _step_layers(jhp))
    v = jm.init(0, jnp.asarray(xs))
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
                              jnp.asarray(xs), training=True,
                              mutable=["batch_stats"])[0]
        return loss_fn(jnp.asarray(ys), out)

    grads = jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(vv["params"]))
    jtr = jm.compile(optimizer=1e-3, loss=_LOSS, metrics=["accuracy"])
    jtr.init_state({**v, **jax.tree_util.tree_map(jnp.asarray, vv)})
    logs = jtr.train_on_batch(xs, ys)
    stats = jax.tree_util.tree_map(np.asarray, jtr.state.batch_stats)
    _JAX["step"] = (xs, ys, vv, logs, grads, stats)

    d = _DATA
    xd = np.random.RandomState(0).normal(size=(d["n"], 48, 1)).astype(np.float32)
    jmesh = jmake_mesh(shape=(2, 4), axis_names=("data", "pixel"))
    _JAX["data"] = [
        (np.asarray(yb), np.asarray(mask)) for _, yb, mask in jdata_iterator(
            jmesh, xd, np.arange(d["n"]), batch_size=d["batch"],
            seed=d["seed"], drop_remainder=False)]
    return _JAX


_RUNS = {}


@pytest.fixture(scope="module", params=[(2, 2), (1, 4)],
                ids=["data2xpixel2", "data1xpixel4"])
def ranks(request, tmp_path_factory):
    """The rank outputs of one mesh shape (run once per module)."""
    shape = request.param
    if shape not in _RUNS:
        ref = _jax_refs()
        x, kern = ref["conv"][:2]
        xs, ys, vv = ref["step"][:3]
        fit = np.random.RandomState(9)
        npix = 12 * _STEP["n"] ** 2
        workdir = str(tmp_path_factory.mktemp(f"gloo{shape[0]}x{shape[1]}"))
        np.savez(os.path.join(workdir, "inputs.npz"), conv_x=x,
                 conv_kernel=kern, step_x=xs, step_y=ys,
                 fit_x=fit.normal(size=(8, npix, _STEP["F"])).astype(np.float32),
                 fit_y=fit.randint(0, _STEP["classes"], size=8),
                 **{"v/" + k: a for k, a in _flat(vv).items()})
        _RUNS[shape] = (shape, _spawn(shape, workdir))
    return _RUNS[shape]


def _assemble(parts, shape, B, C, n):
    """Rank outputs (B/D * C, 12/S, n, P) -> the whole (B*C, 12, n, P) in
    the unsharded order (rank = d * S + p)."""
    D, S = shape
    rows = []
    for d in range(D):
        faces = [parts[d * S + p].reshape(B // D, C, 12 // S, n, -1)
                 for p in range(S)]
        rows.append(np.concatenate(faces, axis=2))
    return np.concatenate(rows, axis=0).reshape(B * C, 12, n, -1)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_face_sharded_conv_matches_jax(ranks):
    """y, dx (interior lanes) and dW of the face-sharded conv, gathered
    over the ranks, against the JAX package's unsharded fused conv; the
    kernel gradient is the same on every rank."""
    shape, outs = ranks
    c = _CONV
    n, h = c["n"], c["K"] - 1
    _, _, y_j, dx_j, dk_j = _jax_refs()["conv"]
    inner = np.s_[..., h:h + n]
    y = _assemble([o["conv_y"] for o in outs], shape, c["B"], c["Fout"], n)
    dx = _assemble([o["conv_dx"] for o in outs], shape, c["B"], c["Fin"], n)
    _close(y[inner], y_j[inner])
    _close(dx[inner], dx_j[inner])
    assert np.abs(y[..., :h]).max() == 0 and np.abs(y[..., h + n:]).max() == 0
    for o in outs:
        _close(o["conv_dk"], dk_j)


def test_sharded_train_step_matches_jax(ranks):
    """One DP x face-sharded train_on_batch from the JAX weights: the
    global loss, every gradient and the updated BN statistics on every rank
    against the JAX package's unsharded step; the plan face-shards the
    cface conv and runs the nside-4 conv on the halo-sharded ELLPACK."""
    shape, outs = ranks
    _, _, _, logs_j, g_j, stats_j = _jax_refs()["step"]
    for o in outs:
        _close(o["step_loss"][0], logs_j["loss"], TOL)
        assert o["step_loss"][1] == logs_j["accuracy"]
        _close_trees(_nest({k[2:]: v for k, v in o.items()
                            if k.startswith("g/")}), g_j, TREE_TOL)
        _close_trees(_nest({k[2:]: v for k, v in o.items()
                            if k.startswith("s/")}), stats_j, TOL)
    assert list(outs[0]["plan"]) == [
        "NestToCface*", "ChebyshevConv@cface*", "HealpyPool@cface",
        "CfaceToNest*", "ChebyshevConv@nest*", "Flatten", "Dense"]


def test_sharded_fit_matches_unsharded(ranks):
    """fit (2 epochs, seeded shuffle, batches of 4 through data_iterator)
    and evaluate (a padded, masked trailing batch) under the mesh give the
    unsharded model's history from the same weights, on every rank."""
    shape, outs = ranks
    s = _STEP
    npix = 12 * s["n"] ** 2
    inp = np.random.RandomState(9)
    fx = inp.normal(size=(8, npix, s["F"])).astype(np.float32)
    fy = inp.randint(0, s["classes"], size=8)
    xs, ys, vv = _jax_refs()["step"][:3]
    m = dt.HealpyGCNN(s["n"], np.arange(npix), _step_layers(thp))
    m.build((s["B"], npix, s["F"]), device="cpu")
    load_jax_variables(m, vv)
    tr = m.compile(optimizer=1e-3, loss=_LOSS, metrics=["accuracy"])
    tr.train_on_batch(xs, ys)
    hist = tr.fit(fx, fy, batch_size=4, epochs=2, seed=3, verbose=0)
    ev = tr.evaluate(fx[:6], fy[:6], batch_size=4, verbose=0)
    want = np.array(hist["loss"] + hist["accuracy"] + [ev["loss"], ev["accuracy"]])
    for o in outs:
        np.testing.assert_allclose(o["fit"], want, rtol=TOL, atol=1e-6)


def test_data_iterator_rows_and_masks_match_jax(ranks):
    """Every rank's rows and mask of each global batch are its data rank's
    contiguous share of the JAX iterator's global batch (same shuffle from
    the seed, padded and masked trailing batch); the pixel ranks of one
    data rank get the same rows."""
    shape, outs = ranks
    D, S = shape
    want = _jax_refs()["data"]
    m = _DATA["batch"] // D
    for r, o in enumerate(outs):
        d = r // S
        assert o["data_rows"].shape == (len(want), m)
        for (rows_j, mask_j), rows, mask in zip(want, o["data_rows"],
                                                o["data_masks"]):
            assert np.array_equal(rows, rows_j[d * m:(d + 1) * m])
            assert np.array_equal(mask, mask_j[d * m:(d + 1) * m])


def test_collectives_have_their_adjoint_backward(ranks):
    shape, outs = ranks
    for o in outs:
        assert o["collectives_ok"].all(), o["collectives_ok"]


@pytest.mark.parametrize("n,h", [(16, 2), (8, 4), (16, 9)])
def test_edge_bands_match_jax(rng, n, h):
    """The four bands, and their face-major packing (the layout K5 writes
    and the all-gather concatenates), against the JAX package's
    ``extract_edge_bands`` on the cface layout, exactly."""
    import jax.numpy as jnp

    import deepsphere_tpu.ops.stencil as jstencil

    _, P_l = tfs.cfp_geometry(n, h)
    x = rng.normal(size=(3, 12, n, P_l)).astype(np.float32)
    want = jstencil.extract_edge_bands(jnp.asarray(x), n, h, embedded=True)
    got = tstencil.extract_edge_bands(torch.from_numpy(x), n, h, embedded=True)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    packed = tstencil.pack_edge_bands(torch.from_numpy(x), n, h)
    assert packed.shape == (12, 3, 4 * h * n)
    for g, w in zip(tstencil.unpack_edge_bands(packed, n, h), want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # a face shard's bands are its faces' rows of the whole map's
    part = tstencil.pack_edge_bands(torch.from_numpy(x[:, 4:8].copy()), n, h)
    assert torch.equal(part, packed[4:8])
    assert _cuda.launch_counts["bands"] == 0


@pytest.mark.parametrize("faces", [range(0, 3), range(4, 8), range(6, 12)])
def test_band_strips_match_jax_strip_arrays(rng, faces):
    """A face shard's halo strips from the gathered bands: ``edge_strips``
    with ``faces``/``bands`` and the plain band strips against the JAX
    package's ``edge_strips`` and ``_strip_arrays(st, xc, faces, bands)``;
    the band strips equal those faces' slice of the unsharded strips."""
    import jax.numpy as jnp

    import deepsphere_tpu.graph as jgraph
    import deepsphere_tpu.ops.pallas_stencil as jps
    import deepsphere_tpu.ops.stencil as jstencil

    n, h = 16, 4
    st = _tgraph(n).face_stencil(0.75, n_steps=h)
    sj = jgraph.build_sphere_graph(n, k=8, method="grid").face_stencil(
        0.75, n_steps=h)
    _, P_l = tfs.cfp_geometry(n, h)
    x = rng.normal(size=(2, 12, n, P_l)).astype(np.float32)
    xt = torch.from_numpy(x)
    bands_j = jstencil.extract_edge_bands(jnp.asarray(x), n, h, embedded=True)
    bands_t = tstencil.extract_edge_bands(xt, n, h, embedded=True)
    for g, w in zip(tstencil.edge_strips(n, h, None, embedded=True,
                                         faces=faces, bands=bands_t),
                    jstencil.edge_strips(n, h, None, embedded=True,
                                         faces=faces, bands=bands_j)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    want = jps._strip_arrays(sj, jnp.asarray(x), faces=faces, bands=bands_j)
    packed = tstencil.pack_edge_bands(xt, n, h)
    got = tstrips.build_band_strips(st, packed, faces)
    full = tstrips.strip_arrays(st, xt)
    for g, w, f in zip(got, want, full):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, f[:, faces.start:faces.stop])
    assert _cuda.launch_counts["strips"] == 0


@pytest.mark.parametrize("n,h,faces", [(16, 4, range(3, 6)), (8, 2, range(0, 12)),
                                       (16, 9, range(8, 12))])
def test_band_strip_index_map_is_the_gather_kernels_source(rng, n, h, faces):
    """The host map that the CUDA gather (K4's kernel) reads: gathering the
    packed band buffer through it, rescaled to C channels as the wrapper
    does, reproduces the plain band strips exactly."""
    st = _tgraph(n).face_stencil(0.75, n_steps=h)
    _, P_l = tfs.cfp_geometry(n, h)
    C = 3
    x = torch.from_numpy(rng.normal(size=(C, 12, n, P_l)).astype(np.float32))
    packed = tstencil.pack_edge_bands(x, n, h)
    L = packed.shape[2]
    idx = torch.from_numpy(tstrips.band_strip_index_map(st, faces)).long()
    idx = torch.where(idx >= 0, (idx // L) * (C * L) + idx % L, idx)
    want = tstrips.build_band_strips(st, packed, faces)
    sizes = [w[0].numel() for w in want]
    assert idx.numel() == sum(sizes)
    src = packed.reshape(-1)
    for c in range(C):  # the kernel: out[c, e] = src[c*L + idx[e]] or 0
        flat = torch.where(idx >= 0, src[(c * L + idx).clamp_min(0)],
                           torch.zeros(()))
        for w, part in zip(want, torch.split(flat, sizes)):
            assert torch.equal(part.reshape(w[c].shape), w[c])


@pytest.mark.parametrize("n_shards", [4, 8, 12])
def test_shard_ellpack_tables_bit_equal_to_jax(n_shards):
    """The halo-sharded ELLPACK's host tables (remapped columns, values,
    boundary rows) equal the JAX package's bit for bit."""
    import deepsphere_tpu.graph as jgraph
    from deepsphere_tpu.parallel import shard_ellpack as jshard_ellpack

    gj = jgraph.build_sphere_graph(4, k=8)
    gt = tgraph.build_sphere_graph(4, k=8)
    want = jshard_ellpack(gj, n_shards, 0.75)
    got = shard_ellpack(gt, n_shards, 0.75)
    assert got.shard_rows == want.shard_rows and got.n_shards == n_shards
    for k, v in want.tables().items():
        g = got.tables()[k]
        assert g.dtype == v.dtype and np.array_equal(g, v), k


def test_face_shard_tables_split_the_unsharded_tables():
    """A face shard's tables: its faces' weight planes and correction mask,
    the replicated ball, and exchange plans that gather every ball source
    row and patch every corrupt row exactly once over the shards."""
    n, h, S = 16, 2, 4
    st = _tgraph(n).face_stencil(0.75, n_steps=h)
    full = tstencil.stencil_tables(st)
    slab = n * tfs.cfp_geometry(n, h)[1]
    F = 12 // S
    tabs = [face_shard_tables(st, r, S) for r in range(S)]
    patched = []
    for r, t in enumerate(tabs):
        assert np.array_equal(t["weights"], full["weights"][:, r * F:(r + 1) * F])
        assert np.array_equal(t["corr_mask"], full["corr_mask"][r * F:(r + 1) * F])
        assert np.array_equal(t["corr_idx"], full["corr_idx"])
        patched.append(t["patch_rows"] + r * F * slab)
        assert np.array_equal(full["corr_rows_cfp"][t["patch_sel"]], patched[-1])
    # the all-gather of every shard's sent rows holds each ball source row
    # and each corrupt row at its planned position
    for rows, send, pos in ((full["corr_src_cfp"], "ball_send", "ball_pos"),
                            (full["corr_rows_cfp"], "rows_send", "rows_pos")):
        buf = np.concatenate([t[send] + r * F * slab for r, t in enumerate(tabs)])
        for t in tabs:
            assert np.array_equal(buf[t[pos]], rows)
    assert np.array_equal(np.sort(np.concatenate(patched)),
                          np.sort(full["corr_rows_cfp"]))
    with pytest.raises(ValueError, match="divide"):
        face_shard_tables(st, 0, 5)


def test_mesh_needs_a_process_group():
    """make_mesh never starts a process group of its own."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1, 1), device_type="cpu")
