"""PyTorch port, attention, against the JAX package on the CPU.

* ``ops.attention``: dense attention with and without a mask (output and
  weights), edge-sparse attention with ``stabilized`` True and False and
  an isolated node, outputs and input gradients;
* ``nn.transformers``: ``MultiHeadAttention`` dense and edge-sparse,
  ``GraphViT``, ``GraphTransformer`` (and ``GraphViT(p=1)``'s ``IOError``),
  the JAX weights carried across by ``interop``;
* the reference's every-layer network (``tests/test_networks.py``'s
  kitchen sink) at nside 16, batch 3: its plan, logits, one
  ``train_on_batch``'s loss and gradient tree;
* the pixel-sharded edge attention on 4 ``gloo`` CPU ranks (a 1 x 4
  mesh) against the unsharded one: a ``GraphTransformer``'s output and
  every gradient, and ``partition_edges_by_dst`` against the JAX
  package's.

Tolerance: 1e-5 of the reference's max for outputs and input gradients;
parameter gradients 1e-5 (1e-4 for the kitchen sink's tree) of the tree's
largest entry, since some leaves are 0 in exact arithmetic (a key bias
shifts every logit of a query alike, which the softmax cancels) and only
rounding is left of them.  The JAX modules are imported inside the tests:
a spawned rank imports this module and must not load jax.
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
from deepsphere_tpu_torch.nn import transformers as ttr
from deepsphere_tpu_torch.ops import attention as tatt
from deepsphere_tpu_torch.parallel import ShardConfig, make_mesh
from deepsphere_tpu_torch.parallel.attention_sharded import partition_edges_by_dst

TOL = 1e-5
TREE_TOL = 1e-4
_LOSS = "sparse_categorical_crossentropy_from_logits"
_SPAWN_DEADLINE = 180


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _leaves(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{pre}{k}/"))
        else:
            out[pre + k] = np.asarray(v)
    return out


def _close_tree(got, want, tol):
    """Every leaf within ``tol`` of the tree's largest entry."""
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    scale = max(np.abs(v).max() for v in w.values())
    for k in w:
        assert g[k].shape == w[k].shape, k
        err = np.abs(g[k] - w[k]).max() / scale
        assert err <= tol, (k, err)


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_dense_attention_matches_jax(masked):
    import jax
    import jax.numpy as jnp

    from deepsphere_tpu.ops import attention as jatt

    rng = np.random.RandomState(0)
    q, k, v = (rng.normal(size=(2, 3, 7, 4)).astype(np.float32)
               for _ in range(3))
    mask = (rng.uniform(size=(7, 7)) < 0.3).astype(np.float32) if masked else None
    cot = rng.normal(size=(2, 3, 7, 4)).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    (out_j, w_j), vjp = jax.vjp(
        lambda a, b, c: jatt.scaled_dot_product_attention(a, b, c, jm),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp((jnp.asarray(cot), jnp.zeros_like(w_j)))
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    out, w = tatt.scaled_dot_product_attention(
        qt, kt, vt, None if mask is None else torch.from_numpy(mask))
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(cot))
    _close(out, out_j)
    _close(w, w_j)
    for g, gj in zip(grads, grads_j):
        _close(g, gj)


def _edges_with_an_isolated_node(M, deg, rng):
    """A dst-sorted random edge list over M nodes; node 3 has no edge."""
    rows = []
    for d in range(M):
        if d == 3:
            continue
        src = rng.choice(M, size=deg, replace=False)
        rows += [(d, s) for s in sorted(src)]
    return np.asarray(rows, dtype=np.int64)


@pytest.mark.parametrize("stabilized", [True, False])
def test_edge_sparse_attention_matches_jax(stabilized):
    import jax
    import jax.numpy as jnp

    from deepsphere_tpu.ops import attention as jatt

    rng = np.random.RandomState(1)
    M = 12
    edges = _edges_with_an_isolated_node(M, 4, rng)
    q, k, v = (rng.normal(size=(2, 2, M, 3)).astype(np.float32)
               for _ in range(3))
    cot = rng.normal(size=(2, 2, M, 3)).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jatt.edge_sparse_attention(
            a, b, c, jnp.asarray(edges), M, stabilized=stabilized),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(cot))
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    out = tatt.edge_sparse_attention(qt, kt, vt, edges, M,
                                     stabilized=stabilized)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(cot))
    assert (out[:, :, 3] == 0).all()  # the isolated node
    _close(out, out_j)
    for g, gj in zip(grads, grads_j):
        _close(g, gj)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


def _layer_case(jmod, tmod, x, extra_inputs=()):
    """The JAX layer's output and gradients (input, params) of sum(sin(y) *
    w) against the port's, the JAX weights loaded through interop."""
    import jax
    import jax.numpy as jnp

    v = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), *extra_inputs)
    w = np.random.RandomState(9).normal(
        size=np.asarray(jmod.apply(v, jnp.asarray(x))).shape).astype(np.float32)

    def loss(p, a):
        return jnp.sum(jnp.sin(jmod.apply({**v, "params": p}, a)) * w)

    y_j = np.asarray(jmod.apply(v, jnp.asarray(x)))
    gp_j, gx_j = jax.grad(loss, (0, 1))(v["params"], jnp.asarray(x))
    with torch.no_grad():
        tmod(torch.from_numpy(x))  # creates the parameters
    load_jax_variables(tmod, {"params": _np_tree(v["params"])})
    xt = _t(x, True)
    y = tmod(xt)
    (torch.sin(y) * torch.from_numpy(w)).sum().backward()
    _close(y, y_j)
    _close(xt.grad, gx_j)
    _close_tree(export_jax_variables(tmod, grads=True), _np_tree(gp_j), TOL)
    # the edge tables are buffers out of state_dict
    assert not [k for k in tmod.state_dict() if "tab_" in k]


def _graphs(n):
    import deepsphere_tpu.graph as jgraph

    return (jgraph.build_sphere_graph(n, k=8, method="grid"),
            tgraph.build_sphere_graph(n, k=8, method="grid"))


@pytest.mark.parametrize("sparse", [False, True])
def test_multi_head_attention_matches_jax(sparse):
    from deepsphere_tpu.nn import transformers as jtr

    n = 4
    jg, tg = _graphs(n)
    x = np.random.RandomState(2).normal(size=(2, 12 * n * n, 8)).astype(np.float32)
    kw = dict(d_model=8, num_heads=2, activation="gelu")
    je = jtr._EdgeSet(jg.edge_idx, jg.n_pixels) if sparse else None
    te = ttr._EdgeSet(tg.edge_idx, tg.n_pixels) if sparse else None
    assert (not sparse) or np.array_equal(tg.edge_idx, jg.edge_idx)
    _layer_case(jtr.MultiHeadAttention(edges=je, **kw),
                ttr.MultiHeadAttention(edges=te, **kw), x)


@pytest.mark.parametrize("positional,layer_norm", [(True, True),
                                                   (False, False)])
def test_graph_vit_matches_jax(positional, layer_norm):
    from deepsphere_tpu.nn import transformers as jtr

    x = np.random.RandomState(3).normal(size=(2, 768, 3)).astype(np.float32)
    kw = dict(p=2, key_dim=4, num_heads=2, n_layers=2,
              positional_encoding=positional, layer_norm=layer_norm)
    _layer_case(jtr.GraphViT(**kw), ttr.GraphViT(**kw), x)


def test_graph_transformer_matches_jax():
    from deepsphere_tpu.nn import transformers as jtr

    jg, tg = _graphs(8)
    x = np.random.RandomState(4).normal(size=(2, 768, 3)).astype(np.float32)
    kw = dict(key_dim=4, num_heads=2, n_layers=2, activation="elu")
    _layer_case(jtr.GraphTransformer.from_graph(jg, **kw),
                ttr.GraphTransformer.from_graph(tg, **kw), x)


def test_vit_p1_raises_as_the_reference():
    from deepsphere_tpu.nn import healpy_layers as jhp

    msg = "The super pixel size factor p has to be at least 1!"
    with pytest.raises(IOError) as e:
        thp.Healpy_ViT(p=1, key_dim=4, num_heads=2)
    assert str(e.value) == msg
    with pytest.raises(IOError) as e:
        jhp.Healpy_ViT(p=1, key_dim=4, num_heads=2)
    assert str(e.value) == msg
    with pytest.raises(IOError, match="not compatible with the embedding"):
        ttr.GraphViT(p=2, key_dim=4, num_heads=2)(torch.zeros(1, 40, 1))


def _kitchen_sink(m):
    """Every layer family (``tests/test_networks.py``'s kitchen sink)."""
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


def test_kitchen_sink_matches_jax():
    """At nside 16, batch 3 (the JAX package's own size): the same plan
    and layer names, logits, and one ``train_on_batch``'s loss and
    gradient tree against jax.grad of the JAX model with the same
    weights."""
    import jax
    import jax.numpy as jnp

    import deepsphere_tpu as ds
    import deepsphere_tpu.train.losses as jlosses
    from deepsphere_tpu.nn import healpy_layers as jhp

    n = 16
    npix = 12 * n * n
    rng = np.random.RandomState(5)
    x = rng.normal(size=(3, npix, 1)).astype(np.float32)
    y = rng.randint(0, 4, size=3)
    jm = ds.HealpyGCNN(n, np.arange(npix), _kitchen_sink(jhp))
    v = jm.init(0, jnp.asarray(x))
    static = {k: v[k] for k in v if k != "params"}
    loss_fn = jlosses.resolve_loss(_LOSS)

    def jloss(p):
        # no layer here behaves differently in training (no batch norm)
        out = jm.module.apply({**static, "params": p}, jnp.asarray(x),
                              training=True)
        return loss_fn(jnp.asarray(y), out), out

    (loss_j, logits_j), g_j = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(v["params"])

    tm = dt.HealpyGCNN(n, np.arange(npix), _kitchen_sink(thp))
    tm.build(x.shape, device="cpu")
    assert tm.layer_names == jm.layer_names
    assert ([type(m).__name__ for m in tm.layers.values()]
            == [type(m).__name__ for m in jm._module_layers])
    load_jax_variables(tm, {"params": _np_tree(v["params"])})
    _close(tm.predict(x, batch_size=3), logits_j)
    tm.compile(optimizer=1e-3, loss=_LOSS)
    logs = tm._trainer.train_on_batch(x, y)
    assert abs(logs["loss"] - float(loss_j)) <= TOL * abs(float(loss_j))
    _close_tree(export_jax_variables(tm, grads=True), _np_tree(g_j), TREE_TOL)


def test_partition_edges_matches_jax():
    from deepsphere_tpu.parallel.attention_sharded import (
        partition_edges_by_dst as jpart,
    )

    _, tg = _graphs(4)
    for S in (1, 2, 4, 12):
        got = partition_edges_by_dst(tg.edge_idx, tg.n_pixels, S)
        want = jpart(tg.edge_idx, tg.n_pixels, S)
        assert all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(got, want))
    with pytest.raises(ValueError, match="not divisible"):
        partition_edges_by_dst(tg.edge_idx, tg.n_pixels, 5)
    with pytest.raises(ValueError, match="sorted by destination"):
        partition_edges_by_dst(tg.edge_idx[::-1], tg.n_pixels, 2)


# ---------------------------------------------------------------------------
# the sharded edge attention on 4 gloo ranks (spawned: torch and the port)
# ---------------------------------------------------------------------------

_SHARD = dict(n=8, B=2, F=3, key_dim=4, num_heads=2)


def _rank_attention(rank, world, store, workdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        c = _SHARD
        cfg = ShardConfig(make_mesh((1, world), ("data", "pixel"),
                                    device_type="cpu"))
        g = tgraph.build_sphere_graph(c["n"], k=8, method="grid")
        inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
        out = {}
        for name, shard_cfg in (("unsharded", None), ("sharded", cfg)):
            m = ttr.GraphTransformer.from_graph(
                g, key_dim=c["key_dim"], num_heads=c["num_heads"],
                n_layers=2, shard_cfg=shard_cfg)
            gen = torch.Generator().manual_seed(0)
            for mod in m.modules():
                mod._init_generator = gen
            xt = torch.from_numpy(inp["x"]).requires_grad_()
            y = m(xt)
            (torch.sin(y) * torch.from_numpy(inp["w"])).sum().backward()
            out[f"{name}_y"] = y.detach().numpy()
            out[f"{name}_dx"] = xt.grad.numpy()
            for k, p in m.named_parameters():
                out[f"{name}_g_{k}"] = p.grad.numpy()
        # inside a model: the assembler hands the transformer the mesh
        # (the pixel count divides over it) and builds it on every rank
        # from the same seed
        for name, shard_cfg in (("model_unsharded", None),
                                ("model_sharded", cfg)):
            mm = dt.HealpyGCNN(c["n"], np.arange(12 * c["n"] ** 2), [
                thp.Healpy_Transformer(key_dim=c["key_dim"],
                                       num_heads=c["num_heads"]),
                thp.Flatten(), thp.Dense(3)], shard_cfg=shard_cfg)
            assert mm.layers["layer_0"].shard_cfg is shard_cfg
            mm.build(inp["x"].shape, seed=4, device="cpu")
            out[f"{name}_logits"] = mm.predict(inp["x"])
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def test_sharded_edge_attention_on_four_ranks(tmp_path):
    """A two-block ``GraphTransformer`` with ``shard_cfg`` (each pixel rank
    its destination chunk of the edges and its rows of q; k and v whole,
    their gradient summed over the ranks) against the same weights
    unsharded: the output, the input gradient and every parameter
    gradient, on every rank; and a model holding a ``Healpy_Transformer``
    built under the mesh against the same model unsharded."""
    c = _SHARD
    npix = 12 * c["n"] ** 2
    rng = np.random.RandomState(6)
    x = rng.normal(size=(c["B"], npix, c["F"])).astype(np.float32)
    w = rng.normal(size=(c["B"], npix, c["key_dim"] * c["num_heads"])
                   ).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", x=x, w=w)
    world = 4
    ctx = mp.spawn(_rank_attention,
                   args=(world, str(tmp_path / "store"), str(tmp_path)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + _SPAWN_DEADLINE
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after "
                                   f"{_SPAWN_DEADLINE} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    for r in range(world):
        out = dict(np.load(tmp_path / f"rank{r}.npz"))
        _close(out["sharded_y"], out["unsharded_y"])
        _close(out["sharded_dx"], out["unsharded_dx"])
        grads = [k[len("unsharded_"):] for k in out
                 if k.startswith("unsharded_g_")]
        assert "g_mha_1.wk.kernel" in grads and len(grads) == 27
        _close_tree({k: out[f"sharded_{k}"] for k in grads},
                    {k: out[f"unsharded_{k}"] for k in grads}, TOL)
        _close(out["model_sharded_logits"], out["model_unsharded_logits"])
