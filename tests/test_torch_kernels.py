"""PyTorch port, the two kernels of the slice and their plain versions.

* K4, the halo-strip builder (``csrc/strips.cu``): its plain version
  (``strip_arrays``) and its host source map must reproduce the JAX
  package's ``_strip_arrays`` bit for bit.
* K1, the fused stencil conv (``csrc/stencil_conv.cu``): its plain version
  is held RAW (before the corner correction — at small nside the correction
  overwrites most rows and would hide it) against the JAX Pallas kernel in
  interpret mode, and the corrected conv against the JAX cface conv.

On the CPU the wrappers run the plain versions and never launch; the
kernels themselves are compared with their plain versions on a card in
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepsphere_tpu.graph as jgraph
import deepsphere_tpu.ops.pallas_stencil as jps
import deepsphere_tpu.ops.stencil as jstencil
import deepsphere_tpu_torch.graph as tgraph
from deepsphere_tpu_torch.ops import _cuda
from deepsphere_tpu_torch.ops import fused_stencil as tfs
from deepsphere_tpu_torch.ops import strips as tstrips
from deepsphere_tpu_torch.ops.stencil import as_tensors, stencil_tables

TOL = 1e-5  # max|d| / max|want|, float32 on both sides

_GRAPHS = {}


def _graphs(n, k=8):
    if (n, k) not in _GRAPHS:
        _GRAPHS[n, k] = (
            jgraph.build_sphere_graph(n, k=k, method="grid"),
            tgraph.build_sphere_graph(n, k=k, method="grid"),
        )
    return _GRAPHS[n, k]


def _stencils(n, scale, n_steps, k=8):
    gj, gt = _graphs(n, k)
    return (gj.face_stencil(scale, n_steps=n_steps),
            gt.face_stencil(scale, n_steps=n_steps))


def _xc(rng, n, h, C, garbage=False):
    """(C, 12, n, P_l) cface activations; ``garbage`` fills the halo lanes
    too (no path may read them)."""
    _, P_l = tfs.cfp_geometry(n, h)
    x = rng.normal(size=(C, 12, n, P_l)).astype(np.float32)
    if not garbage:
        x[..., :h] = 0.0
        x[..., h + n:] = 0.0
    return x


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


@pytest.fixture(autouse=True)
def _counts():
    _cuda.reset_launch_counts()
    yield


# ---------------------------------------------------------------------------
# K4: strips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,h,C", [(8, 4, 3), (16, 1, 1), (16, 9, 2), (32, 2, 4)])
def test_strip_arrays_match_jax(rng, n, h, C):
    sj, st = _stencils(n, 0.75, h)
    x = _xc(rng, n, h, C, garbage=True)
    want = jps._strip_arrays(sj, jnp.asarray(x))
    got = tstrips.strip_arrays(st, torch.from_numpy(x))
    for name, g, w in zip(("top", "bot", "ls"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("n,h", [(8, 4), (16, 9), (32, 2)])
def test_strip_index_map_reproduces_the_strips(rng, n, h):
    """The kernel's host source map, applied with torch.take, gives the
    plain strips exactly (the CUDA kernel is this gather)."""
    _, st = _stencils(n, 0.75, h)
    C = 2
    x = torch.from_numpy(_xc(rng, n, h, C, garbage=True))
    idx = torch.from_numpy(tstrips.strip_index_map(st)).long()
    want = tstrips.strip_arrays(st, x)
    sizes = [w[0].numel() for w in want]
    assert idx.numel() == sum(sizes)
    slab = x[0].numel()
    for c in range(C):
        flat = torch.where(idx >= 0,
                           torch.take(x[c], idx.clamp_min(0)),
                           torch.zeros((), dtype=x.dtype))
        for w, part in zip(want, torch.split(flat, sizes)):
            assert torch.equal(part.reshape(w[c].shape), w[c])
    assert int(idx.max()) < slab


def test_build_strips_on_cpu_is_the_plain_version(rng):
    _, st = _stencils(8, 0.75, 4)
    x = torch.from_numpy(_xc(rng, 8, 4, 2))
    for g, w in zip(tstrips.build_strips(st, x), tstrips.strip_arrays(st, x)):
        assert torch.equal(g, w)
    assert _cuda.launch_counts == {"strips": 0, "stencil_conv": 0}


# ---------------------------------------------------------------------------
# K1: the raw fused conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,kind,scale,K", [(8, 8, "cheby", 0.75, 5),
                                              (8, 8, "mono", 1.0, 3),
                                              (16, 20, "cheby", 0.75, 3)])
def test_raw_conv_matches_jax_kernel(rng, n, k, kind, scale, K):
    """Plain raw conv against the JAX Pallas kernel (interpret mode) on
    every interior lane — corner rows included; radius 1 (k=8) at nside 8
    and radius 2 (k=20, 25 taps) at nside 16."""
    r = 2 if k == 20 else 1
    h = r * (K - 1)
    sj, st = _stencils(n, scale, h, k)
    assert st.radius == r
    B, Fin, Fout = 2, 2, 3
    x = _xc(rng, n, h, B * Fin)
    wk3 = rng.normal(size=(K, Fin, Fout)).astype(np.float32)
    strips_j = jps._strip_arrays(sj, jnp.asarray(x))
    want = jps._run_stencil_kernel(
        sj, kind, K, jnp.asarray(x), jnp.asarray(sj.weights), strips_j,
        jnp.asarray(wk3), B, interpret=True)
    xt = torch.from_numpy(x)
    got = tfs.run_stencil_kernel(
        st, kind, K, xt, torch.from_numpy(st.weights),
        tstrips.strip_arrays(st, xt), torch.from_numpy(wk3), B)
    assert got.shape == (B * Fout, 12, n, 128)
    _close(got[..., h:h + n].numpy(), np.asarray(want)[..., h:h + n])
    assert got[..., h:h + n].abs().max() > 0
    assert got[..., :h].abs().max() == 0 and got[..., h + n:].abs().max() == 0
    assert _cuda.launch_counts["stencil_conv"] == 0


@pytest.mark.parametrize("n,h,r,nplanes,T", [(64, 9, 1, 9, 32), (16, 9, 1, 9, 16),
                                             (8, 2, 1, 9, 8), (32, 18, 2, 25, 8),
                                             (64, 16, 4, 81, None)])
def test_conv_kernel_tile_fits_shared_memory(n, h, r, nplanes, T):
    """The CUDA conv picks the largest tile whose window fits a block's
    227 KB of shared memory (radius 4 at h=16 fits none)."""
    assert tfs._conv_tile(n, h, r, nplanes) == T
    if T is not None:
        assert tfs._conv_smem(T, h, r, nplanes) <= tfs._SMEM_MAX


def test_raw_conv_reads_only_the_interior(rng):
    """Garbage in the halo lanes of the input changes nothing."""
    n, h, K, B = 16, 4, 5, 1
    _, st = _stencils(n, 0.75, h)
    x = _xc(rng, n, h, B * 2)
    xg = x.copy()
    xg[..., :h] = 7.0
    xg[..., h + n:] = -3.0
    wk3 = torch.from_numpy(rng.normal(size=(K, 2, 2)).astype(np.float32))
    w = torch.from_numpy(st.weights)
    ys = [tfs.run_stencil_kernel(st, "cheby", K, xx, w,
                                 tstrips.strip_arrays(st, xx), wk3, B)
          for xx in (torch.from_numpy(x), torch.from_numpy(xg))]
    assert torch.equal(ys[0], ys[1])


def test_raw_conv_rejects_bad_kind_and_device(rng):
    _, st = _stencils(8, 0.75, 4)
    xt = torch.from_numpy(_xc(rng, 8, 4, 1))
    w = torch.from_numpy(st.weights)
    s = tstrips.strip_arrays(st, xt)
    wk3 = torch.ones(5, 1, 1)
    with pytest.raises(ValueError, match="basis kind"):
        tfs.run_stencil_kernel(st, "bern", 5, xt, w, s, wk3, 1)
    with pytest.raises(ValueError, match="terms"):
        tfs.run_stencil_kernel(st, "cheby", 4, xt, w, s, wk3, 1)
    with pytest.raises(ValueError, match="device"):
        tfs.run_stencil_kernel(st, "cheby", 5, xt.to("meta"), w, s, wk3, 1)


# ---------------------------------------------------------------------------
# K1 + correction: the fused conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,n_corr", [(5, 768), (10, 3072)])
def test_fused_conv_matches_jax(rng, K, n_corr):
    """Corrected conv against the JAX cface conv at nside 16: K=5 corrects
    768 of 3,072 rows, K=10 every row (the ball path alone)."""
    n, h = 16, K - 1
    sj, st = _stencils(n, 0.75, h)
    assert st.corr_out_face.shape[0] == n_corr
    B, Fin, Fout = 2, 3, 2
    x = _xc(rng, n, h, B * Fin)
    kern = rng.normal(size=(Fin * K, Fout)).astype(np.float32)
    want = jstencil.stencil_graph_conv_cface(
        sj, jnp.asarray(x.reshape(B, Fin, 12, n, -1)), jnp.asarray(kern), K,
        "cheby")
    tables = as_tensors(stencil_tables(st))
    got = tfs.fused_stencil_conv_cfp(st, tables, torch.from_numpy(x),
                                     torch.from_numpy(kern), K, "cheby", B)
    _close(got.reshape(B, Fout, 12, n, -1)[..., h:h + n].numpy(),
            np.asarray(want)[..., h:h + n])
    plain = tfs.fused_stencil_conv_cfp_plain(
        st, tables, torch.from_numpy(x), torch.from_numpy(kern), K, "cheby", B)
    assert torch.equal(got, plain)
    assert _cuda.launch_counts == {"strips": 0, "stencil_conv": 0}


def test_fused_conv_backward_runs_on_cpu(rng):
    """On the CPU the plain path is differentiable (the CUDA path raises
    under autograd until the backward kernels land)."""
    n, h, K, B = 8, 2, 3, 1
    _, st = _stencils(n, 1.0, h)
    tables = as_tensors(stencil_tables(st))
    x = torch.from_numpy(_xc(rng, n, h, 2)).requires_grad_()
    kern = torch.ones(2 * K, 2, requires_grad=True)
    tfs.fused_stencil_conv_cfp(st, tables, x, kern, K, "mono", B).sum().backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(kern.grad).all()
