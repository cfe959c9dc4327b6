"""PyTorch port, the import of TF2 reference checkpoints (``.weights.h5``)
against the JAX package's importer on the CPU.

A Keras-3 weights file is written with h5py from seeded numpy, with the
groups the JAX importer's docstring table names (``chebyshev`` with
``vars`` and ``bn/vars``, residual layers with batch and layer norms, a
pseudo-conv's ``filter`` and its transpose's, a ViT's and a graph
transformer's ``embed`` and ``layers/multi_head_attention*`` blocks, the
``dense`` head, and the empty groups Keras writes for stateless layers).
The models are built on the kNN graph, the reference's, which both
packages build bit for bit alike.  The same file goes into the JAX model
(``import_keras_h5``) and into the port model of the same layers
(``load_weights_from_reference``); their eval logits agree to 1e-5 of
their max.  Every error of the importer is raised with the JAX package's
string.
"""

import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepsphere_tpu as ds
import deepsphere_tpu_torch as dt
from deepsphere_tpu.nn import healpy_layers as jhp
from deepsphere_tpu.train.import_ref import import_keras_h5 as j_import
from deepsphere_tpu_torch.interop import export_jax_variables
from deepsphere_tpu_torch.nn import healpy_layers as thp
from deepsphere_tpu_torch.train import import_keras_h5 as t_import
from deepsphere_tpu_torch.train.import_ref import _BASE_NAME, _import_tree, _read_tree

TOL = 1e-5


def _conv_stack(m):
    """Every conv-family group: conv + BN, residual layers with each norm,
    a monomial conv, a pseudo-conv and its transpose, the dense head."""
    return [
        m.HealpyChebyshev(K=5, Fout=4, use_bias=True, use_bn=True,
                          activation="relu"),
        m.HealpyPool(p=1, pool_type="MAX"),
        m.Healpy_ResidualLayer("CHEBY", {"K": 3}, activation="relu",
                               use_bn=True, norm_type="batch_norm"),
        m.Healpy_ResidualLayer("CHEBY", {"K": 3}, activation="relu",
                               use_bn=True, norm_type="layer_norm"),
        m.HealpyMonomial(K=3, Fout=3, use_bias=True, activation="elu"),
        m.HealpyPseudoConv(p=1, Fout=6),
        m.HealpyPseudoConv_Transpose(p=1, Fout=2),
        m.Flatten(),
        m.Dense(2),
    ]


def _attention_stack(m):
    return [
        m.Healpy_Transformer(key_dim=3, num_heads=2, n_layers=1),
        m.Healpy_ViT(p=2, key_dim=4, num_heads=2, n_layers=2),
        m.Flatten(),
        m.Dense(2),
    ]


STACKS = {"conv_family": (8, _conv_stack), "attention": (8, _attention_stack)}

# Keras's group names of the stateless layers (written empty)
_STATELESS_GROUP = {"HealpyPool": "healpy_pool", "Flatten": "flatten"}


def _vars(group, arrays):
    g = group.create_group("vars")
    for i, a in enumerate(arrays):
        g.create_dataset(str(i), data=np.asarray(a, np.float32))


class _Writer:
    """Reference-format arrays of a JAX model's parameter shapes, from
    seeded numpy."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)

    def w(self, shape):
        return self.rng.normal(scale=0.5, size=shape).astype(np.float32)

    def var(self, shape):
        return self.rng.uniform(0.5, 2.0, size=shape).astype(np.float32)

    def norm(self, g, p, s):
        """A residual layer's norm: gamma, beta[, moving mean, variance]."""
        arrays = [1.0 + self.w(p["scale"].shape), self.w(p["bias"].shape)]
        if s:
            arrays += [self.w(s["mean"].shape), self.var(s["var"].shape)]
        _vars(g, arrays)

    def dense(self, g, p):
        _vars(g, [self.w(p["kernel"].shape), self.w(p["bias"].shape)])

    def mha(self, g, p):
        inner = g.create_group("layers")
        for ours, ref in (("wq", "dense"), ("wk", "dense_1"),
                          ("wv", "dense_2")):
            self.dense(inner.create_group(ref), p[ours])
        self.dense(g.create_group("dense"), p["dense"])
        for ln in ("layer_norm1", "layer_norm2"):
            if ln in p:
                _vars(g.create_group(ln), [1.0 + self.w(p[ln]["scale"].shape),
                                           self.w(p[ln]["bias"].shape)])

    def layer(self, g, layer, p, s):
        cls = type(layer).__name__
        if cls in ("ChebyshevConv", "MonomialConv", "BernsteinConv"):
            arrays = [self.w(p["kernel"].shape)]
            if "bias" in p:
                arrays.append(self.w(p["bias"].shape[-1:]))
            _vars(g, arrays)
            if s:
                _vars(g.create_group("bn"), [self.w(s["bn"]["mean"].shape),
                                             self.var(s["bn"]["var"].shape)])
        elif cls == "ResidualLayer":
            for nm in ("layer1", "layer2"):
                _vars(g.create_group(nm), [self.w(p[nm]["kernel"].shape)])
            for nm in ("bn1", "bn2"):
                self.norm(g.create_group(nm), p[nm], s.get(nm))
        elif cls == "HealpyPseudoConv":
            fs = 4 ** layer.p
            kin, fout = p["kernel"].shape
            _vars(g.create_group("filter"), [self.w((fs, kin // fs, fout)),
                                             self.w(p["bias"].shape)])
        elif cls == "HealpyPseudoConv_Transpose":
            fs, fin, fout = p["kernel"].shape
            _vars(g.create_group("filter"), [self.w((1, fs, fout, fin)),
                                             self.w(p["bias"].shape)])
        elif cls in ("GraphViT", "Healpy_ViT", "GraphTransformer"):
            blocks = g.create_group("layers")
            embed = g.create_group("embed")
            if "embed_kernel" in p:
                fs = 4 ** layer.p
                kin, emb = p["embed_kernel"].shape
                _vars(embed, [self.w((fs, kin // fs, emb)),
                              self.w(p["embed_bias"].shape)])
            else:
                self.dense(embed, p["embed"])
            if "pos_encoder" in p:
                _vars(blocks.create_group("add_position_embs"),
                      [self.w(p["pos_encoder"]["pos_embedding"].shape)])
            i = 0
            while f"mha_{i}" in p:
                name = ("multi_head_attention" if i == 0
                        else f"multi_head_attention_{i}")
                self.mha(blocks.create_group(name), p[f"mha_{i}"])
                i += 1
        elif cls == "Dense":
            self.dense(g, p["dense"])
        else:
            raise AssertionError(cls)


def _write_checkpoint(path, jm, variables, seed=0):
    """A Keras-3 ``.weights.h5`` for the JAX model ``jm``'s layers."""
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray,
                                   variables.get("batch_stats", {}))
    writer = _Writer(seed)
    seen = {}
    with h5py.File(path, "w") as f:
        top = f.create_group("layers")
        for i, layer in enumerate(jm.layers_use):
            cls = type(layer).__name__
            base = _BASE_NAME.get(cls, _STATELESS_GROUP.get(cls))
            n = seen.get(base, 0)
            seen[base] = n + 1
            g = top.create_group(base if n == 0 else f"{base}_{n}")
            if cls in _STATELESS_GROUP:
                g.create_group("vars")  # Keras writes these empty
                continue
            key = jm.param_key(i)
            writer.layer(g, layer, params[key], stats.get(key, {}))
        # RNG state Keras keeps for dropout-like layers carries no weight
        top.create_group("dropout").create_group(
            "seed_generator").create_group("vars").create_dataset(
                "0", data=np.zeros(2, np.uint32))


def _models(name, build=True):
    nside, stack = STACKS[name]
    npix = 12 * nside * nside
    jm = ds.HealpyGCNN(nside, np.arange(npix), stack(jhp), graph_method="knn")
    tm = dt.HealpyGCNN(nside, np.arange(npix), stack(thp), graph_method="knn")
    if build:
        jm.build((2, npix, 1))
        tm.build((2, npix, 1), device="cpu")
    return jm, tm, npix


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", sorted(STACKS))
def test_checkpoint_imports_as_in_the_jax_package(tmp_path, name):
    """One ``.weights.h5`` into the JAX model and into the port model of the
    same layers: eval logits to 1e-5, and the port's variable tree equal
    to the JAX importer's (bit for bit: both only copy and reshape)."""
    jm, tm, npix = _models(name)
    path = str(tmp_path / f"{name}.weights.h5")
    _write_checkpoint(path, jm, jm.variables)
    jvars = j_import(path, jm)
    x = np.random.RandomState(5).normal(size=(2, npix, 1)).astype(np.float32)
    want = np.asarray(jm.apply(jvars, jnp.asarray(x)))
    assert tm.load_weights_from_reference(path) is tm
    got = tm.predict(x, batch_size=2)
    assert _rel(got, want) <= TOL
    mine = export_jax_variables(tm)
    for coll in ("params", "batch_stats"):
        flat = jax.tree_util.tree_leaves_with_path(jvars.get(coll, {}))
        ours = dict(jax.tree_util.tree_leaves_with_path(mine[coll]))
        assert len(flat) == len(ours)
        for path_, leaf in flat:
            assert np.array_equal(np.asarray(leaf), ours[path_]), path_


def test_import_tree_needs_no_h5py(tmp_path, monkeypatch):
    """The group walk (``_import_tree``) on a tree held in memory, with h5py
    unimportable, loads what the file read loads."""
    jm, tm, npix = _models("conv_family")
    path = str(tmp_path / "a.weights.h5")
    _write_checkpoint(path, jm, jm.variables, seed=3)
    with h5py.File(path, "r") as f:
        tree = _read_tree(f["layers"])
    t_import(path, tm)
    want = export_jax_variables(tm)
    _, tm2, _ = _models("conv_family")
    monkeypatch.setitem(sys.modules, "h5py", None)
    _import_tree(tree, tm2)
    got = export_jax_variables(tm2)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert np.array_equal(a, b)


def _error(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


def _edit(path, fn):
    with h5py.File(path, "a") as f:
        fn(f["layers"] if "layers" in f else f)


@pytest.mark.parametrize("case", ["not_keras3", "not_built", "missing_group",
                                  "unconsumed_group", "misshaped_weight"])
def test_importer_errors_match_jax(tmp_path, case):
    """Each error of the importer, with the JAX package's type and string."""
    jm, tm, _ = _models("conv_family", build=case != "not_built")
    path = str(tmp_path / "c.weights.h5")
    if case == "not_built":
        jb, _, npix = _models("conv_family")
        _write_checkpoint(path, jb, jb.variables)
    elif case == "not_keras3":
        with h5py.File(path, "w") as f:
            f.create_group("model_weights")
    else:
        _write_checkpoint(path, jm, jm.variables)
    if case == "missing_group":
        _edit(path, lambda g: g.__delitem__("dense"))
    elif case == "unconsumed_group":
        _edit(path, lambda g: _vars(g.create_group("chebyshev_7"),
                                    [np.ones((3, 2))]))
    elif case == "misshaped_weight":
        def shrink(g):
            del g["chebyshev/vars/0"]
            g["chebyshev/vars"].create_dataset("0", data=np.ones((4, 4)))
        _edit(path, shrink)
    want = _error(lambda: j_import(path, jm))
    got = _error(lambda: t_import(path, tm))
    assert got == want
    assert got[0] == "ValueError"
