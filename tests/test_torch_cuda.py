"""PyTorch port on a CUDA card: each hand-written kernel against its plain
version on identical CUDA inputs, and a small model forward against the
CPU.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false.  The file imports neither jax nor the JAX package, so it also runs
on a machine that has only PyTorch (no conftest there, hence its own
fixtures):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerance: 2e-5 of the plain version's max (both float32 without TF32;
only the order of the sums differs); the strip gather must be exact.
"""

import numpy as np
import pytest
import torch

import deepsphere_tpu_torch as dt
from deepsphere_tpu_torch.graph import build_sphere_graph
from deepsphere_tpu_torch.nn import healpy_layers as hp_nn
from deepsphere_tpu_torch.ops import _cuda
from deepsphere_tpu_torch.ops import fused_stencil as fs
from deepsphere_tpu_torch.ops import strips as tstrips
from deepsphere_tpu_torch.ops.stencil import as_tensors, stencil_tables

pytestmark = pytest.mark.cuda

TOL = 2e-5

_GRAPHS = {}


def _stencil(n, scale, h, k=8):
    if (n, k) not in _GRAPHS:
        _GRAPHS[n, k] = build_sphere_graph(n, k=k, method="grid")
    return _GRAPHS[n, k].face_stencil(scale, n_steps=h)


@pytest.fixture
def rng():
    return np.random.RandomState(11)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    _cuda.reset_launch_counts()
    return torch.device("cuda")


def _xc(rng, dev, n, h, C):
    """(C, 12, n, P_l) with garbage in the halo lanes too."""
    _, P_l = fs.cfp_geometry(n, h)
    return torch.from_numpy(
        rng.normal(size=(C, 12, n, P_l)).astype(np.float32)).to(dev)


def _close(got, want, tol=TOL):
    err = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
    assert err <= tol, err


@pytest.mark.parametrize("n,h,C", [(16, 9, 3), (32, 4, 2), (64, 9, 1)])
def test_strips_kernel_matches_plain(rng, dev, n, h, C):
    st = _stencil(n, 0.75, h)
    x = _xc(rng, dev, n, h, C)
    got = tstrips.build_strips(st, x)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["strips"] == 1
    for g, w in zip(got, tstrips.strip_arrays(st, x)):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "n,k,kind,scale,K,B,Fin,Fout",
    [(16, 8, "cheby", 0.75, 10, 2, 3, 9), (32, 8, "cheby", 0.75, 5, 1, 2, 4),
     (64, 8, "mono", 1.0, 3, 2, 1, 8), (8, 8, "cheby", 0.75, 3, 3, 2, 2),
     (16, 20, "cheby", 0.75, 3, 2, 2, 3), (32, 20, "mono", 1.0, 10, 1, 2, 2)],
)
def test_conv_kernel_matches_plain(rng, dev, n, k, kind, scale, K, B, Fin,
                                   Fout):
    """Raw conv on every interior lane (corner rows included), zero halo
    lanes, then the corrected conv; radius 1 (k=8) and radius 2 (k=20, at
    h=18 on 8x8 tiles so the 25 weight planes fit shared memory)."""
    st = _stencil(n, scale, (K - 1) * (2 if k == 20 else 1), k)
    h = st.n_steps
    tables = as_tensors(stencil_tables(st), dev)
    x = _xc(rng, dev, n, h, B * Fin)
    kern = torch.from_numpy(
        rng.normal(size=(Fin * K, Fout)).astype(np.float32)).to(dev)
    wk3 = kern.reshape(Fin, K, Fout).permute(1, 0, 2).contiguous()
    s = tstrips.strip_arrays(st, x)
    args = (st, kind, K, x, tables["weights"], s, wk3, B)
    raw = fs.run_stencil_kernel(*args)
    raw_p = fs.run_stencil_plain(*args)
    _close(raw[..., h:h + n], raw_p[..., h:h + n])
    assert raw[..., :h].abs().max() == 0 and raw[..., h + n:].abs().max() == 0
    y = fs.fused_stencil_conv_cfp(st, tables, x, kern, K, kind, B)
    y_p = fs.fused_stencil_conv_cfp_plain(st, tables, x, kern, K, kind, B)
    torch.cuda.synchronize()
    _close(y[..., h:h + n], y_p[..., h:h + n])
    assert _cuda.launch_counts == {"strips": 1, "stencil_conv": 2}


def test_conv_raises_under_autograd(rng, dev):
    st = _stencil(16, 0.75, 4)
    tables = as_tensors(stencil_tables(st), dev)
    x = _xc(rng, dev, 16, 4, 1)
    kern = torch.ones(5, 1, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        fs.fused_stencil_conv_cfp(st, tables, x, kern, 5, "cheby", 1)


def test_wrappers_reject_what_the_kernels_do_not_take(rng, dev):
    st = _stencil(16, 0.75, 4)
    x = _xc(rng, dev, 16, 4, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tstrips.build_strips(st, x.transpose(2, 3))
    s = tstrips.build_strips(st, x)
    w = torch.from_numpy(st.weights).to(dev)
    with pytest.raises(ValueError, match="wk3"):
        fs.run_stencil_kernel(st, "cheby", 5, x, w, s,
                              torch.ones(5, 2, 1, dtype=torch.float64,
                                         device=dev), 1)


def test_model_forward_matches_cpu(rng, dev):
    """quick_start architecture at nside 16: the card's logits match the
    CPU plain path, and the one cface conv launched both kernels once per
    forward."""
    nside = 16
    npix = 12 * nside * nside
    layers = [
        hp_nn.HealpyChebyshev(K=10, Fout=8, activation="relu", use_bn=True),
        hp_nn.HealpyPool(p=1),
        hp_nn.HealpyChebyshev(K=10, Fout=16, activation="relu", use_bn=True),
        hp_nn.HealpyPool(p=1),
        hp_nn.Flatten(),
        hp_nn.Dense(4),
    ]
    model = dt.HealpyGCNN(nside, np.arange(npix), layers).build((2, npix, 1))
    x = rng.normal(size=(4, npix, 1)).astype(np.float32)
    want = model.predict(x, batch_size=2)
    _cuda.reset_launch_counts()
    got = model.to(dev).predict(x, batch_size=2)
    assert _cuda.launch_counts == {"strips": 2, "stencil_conv": 2}
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-4, err
