"""PyTorch port, the hand-written kernels' plain versions.

* K4, the halo-strip builder (``csrc/strips.cu``): its plain version
  (``strip_arrays``) and its host source map must reproduce the JAX
  package's ``_strip_arrays`` bit for bit.
* K1, the fused stencil conv (``csrc/stencil_conv.cu``): its plain version
  is held RAW (before the corner correction — at small nside the correction
  overwrites most rows and would hide it) against the JAX Pallas kernel in
  interpret mode, and the corrected conv against the JAX cface conv.
* K2, the fused backward dx + dW (``csrc/stencil_dxdw.cu``), and K3, the
  dW of the two-kernel backward (``csrc/stencil_grad.cu``): their plain
  versions held RAW against the JAX Pallas kernels in interpret mode.

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
from deepsphere_tpu_torch import config
from deepsphere_tpu_torch.graph.stencil import stencil_offsets
from deepsphere_tpu_torch.ops import _cuda, library
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
    assert _cuda.launch_counts == {"strips": 0, "stencil_conv": 0, "dxdw": 0,
                                   "grad": 0, "bands": 0}


def _strip_parts(m, F, n, h):
    """One channel's strip map split as the kernel reads it."""
    R, P_l = tfs.cfp_geometry(n, h)
    e_tb = F * R * P_l
    return (m[:e_tb].reshape(F, R, P_l), m[e_tb:2 * e_tb].reshape(F, R, P_l),
            m[2 * e_tb:].reshape(F, n, 128))


@pytest.mark.parametrize("n,h", [(8, 4), (16, 9), (32, 2)])
def test_strip_maps_are_zero_outside_the_kernels_data_groups(n, h):
    """K4 writes 16-byte zeros without reading the map at top rows
    [0, R-h), bot rows [h, R), lanes past roundup(n+2h, 4) and ls lanes past
    roundup(2h, 4): both maps (all faces, and a shard's faces from the
    bands) hold -1 there."""
    _, st = _stencils(n, 0.75, h)
    R, P_l = tfs.cfp_geometry(n, h)
    D, Dl = -(-(n + 2 * h) // 4) * 4, -(-(2 * h) // 4) * 4
    for m, F in ((tstrips.strip_index_map(st), 12),
                 (tstrips.band_strip_index_map(st, range(3, 6)), 3)):
        top, bot, ls = _strip_parts(m, F, n, h)
        assert (top[:, :R - h] == -1).all() and (top[:, :, D:] == -1).all()
        assert (bot[:, h:] == -1).all() and (bot[:, :, D:] == -1).all()
        assert (ls[:, :, Dl:] == -1).all()
        assert (top[:, R - h:, :D] >= 0).any() and (ls[:, :, :Dl] >= 0).any()


def test_band_source_map_cached_equals_per_call(rng):
    """The rescaled band map that ``build_band_strips`` caches on the
    stencil per (faces, C, device) is the per-call rescale, and it gathers
    the plain band strips from the packed bands."""
    n, h, C = 16, 4, 5
    _, st = _stencils(n, 0.75, h)
    faces = range(3, 6)
    L = 4 * h * n
    m = torch.from_numpy(tstrips.band_strip_index_map(st, faces))
    want = tstrips.band_source_map(m, C, L)
    cpu = torch.device("cpu")
    got = tstrips._band_source_map(st, faces, C, cpu)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert tstrips._band_source_map(st, faces, C, cpu, m) is got
    assert not torch.equal(tstrips._band_source_map(st, faces, C + 1, cpu),
                           got)
    bands = torch.from_numpy(rng.normal(size=(12, C, L)).astype(np.float32))
    plain = tstrips.build_band_strips(st, bands, faces)
    flat, idx = bands.reshape(-1), got.long()
    for c in range(C):
        g = torch.where(idx >= 0, flat[c * L + idx.clamp_min(0)],
                        torch.zeros(()))
        for part, p in zip(_strip_parts(g, 3, n, h), plain):
            assert torch.equal(part, p[c])


def test_strip_gather_rejects_an_unaligned_map():
    """The gather kernel reads its source map 16 bytes at a time: a map
    that does not start 16-byte aligned is refused before any launch."""
    n, h = 16, 4
    _, st = _stencils(n, 0.75, h)
    m = torch.from_numpy(tstrips.strip_index_map(st))
    shifted = torch.empty(m.numel() + 1, dtype=torch.int32)[1:].copy_(m)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    _, P_l = tfs.cfp_geometry(n, h)
    x = torch.zeros(1, 12, n, P_l)
    with pytest.raises(ValueError, match="aligned"):
        library._gather_strips(n, h, x, shifted, 1, 12, 12 * n * P_l)
    assert _cuda.launch_counts["strips"] == 0


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
    """K1's plan picks the largest tile whose window fits a block's 227 KB
    of shared memory (radius 4 at h=16 fits none)."""
    K = h // r + 1
    plan = tfs._k1_plan(n, h, r, nplanes, K, 2, 12, 4, 4, _H100_SMS)
    assert (None if plan is None else plan.T) == T
    if T is not None:
        assert plan.smem == tfs._k1_smem(T, h, r, nplanes, K, plan.G,
                                         plan.FC) <= tfs._SMEM_MAX
        if T < 32 and n % (2 * T) == 0:  # the next larger tile does not
            # fit, even at its least
            assert tfs._k1_smem(2 * T, h, r, nplanes, K, 1, 4) > tfs._SMEM_MAX


_H100_SMS = 132  # an H100 SXM's SMs

# (label, n, h, r, nplanes, K, B, F, Fin, Fout): every shape the paths give K1
_K1_SHAPES = [
    ("quick_start conv 1", 64, 9, 1, 9, 10, 16, 12, 1, 8),
    ("quick_start conv 2", 32, 9, 1, 9, 10, 16, 12, 8, 16),
    ("quick_start conv 3", 16, 9, 1, 9, 10, 16, 12, 16, 32),
    ("headline", 1024, 4, 1, 9, 5, 4, 12, 4, 4),
    ("k=20 radius 2, h=18", 32, 18, 2, 25, 10, 2, 12, 2, 3),
    ("face shard of 3, headline", 1024, 4, 1, 9, 5, 4, 3, 4, 4),
    ("dx role of conv 3 (Fin > Fout)", 16, 9, 1, 9, 10, 16, 12, 32, 16),
    ("dx role of conv 2 (Fin > Fout)", 32, 9, 1, 9, 10, 16, 12, 16, 8),
]


@pytest.mark.parametrize("label,n,h,r,nplanes,K,B,F,Fin,Fout", _K1_SHAPES,
                         ids=[c[0] for c in _K1_SHAPES])
def test_k1_plan_at_the_paths_shapes(label, n, h, r, nplanes, K, B, F, Fin,
                                     Fout):
    """K1's launch plan at every shape the paths use: a tile, a batch group
    >= 1, at most 227 KB of shared memory, a grid within CUDA's limits that
    covers every (tile, face, batch index, output channel) once."""
    p = tfs._k1_plan(n, h, r, nplanes, K, B, F, Fin, Fout, _H100_SMS)
    assert p is not None, label
    assert p.T in (32, 16, 8) and n % p.T == 0
    assert 1 <= p.GB <= B and 1 <= p.G <= tfs._K1_GMAX[r] and Fin % p.G == 0
    assert p.FC in (4, 8, 16, 32)
    assert p.FC <= (16 if p.T == 32 else 32)
    assert p.smem == tfs._k1_smem(p.T, h, r, nplanes, K, p.G, p.FC)
    assert p.smem <= 227 * 1024
    chunks = -(-Fout // p.FC)
    assert p.grid == ((n // p.T) ** 2, F, -(-B // p.GB) * chunks)
    assert p.grid[0] < 2 ** 31 and p.grid[1] <= 65535 and p.grid[2] <= 65535
    # the batch leaves the grid only while the grid still fills the SMs twice
    if p.GB > 1:
        assert p.grid[0] * p.grid[1] * p.grid[2] >= 2 * _H100_SMS


def test_k1_plan_batch_group_follows_the_grid():
    """At the headline (face, tile) alone makes 12,288 blocks, so a block
    takes the whole batch; at quick_start conv 3 it makes 12, so the batch
    stays in the grid."""
    plan = lambda *shape, sms=_H100_SMS: tfs._k1_plan(*shape, sms)
    assert plan(1024, 4, 1, 9, 5, 4, 12, 4, 4).GB == 4
    assert plan(16, 9, 1, 9, 10, 16, 12, 16, 32).GB == 1
    # a card of fewer SMs is filled with more batch indices a block
    assert plan(16, 9, 1, 9, 10, 16, 12, 16, 32, sms=6).GB == 16
    # the lap group divides Fin, up to the radius's largest
    assert plan(32, 9, 1, 9, 10, 2, 12, 3, 3).G == 1
    assert plan(32, 9, 1, 9, 10, 2, 12, 4, 3).G == 4
    assert plan(32, 18, 2, 25, 10, 2, 12, 4, 3).G == 2


# (label, n, h, r, K, B, Fin, Fout, route in either bf16 mode (float32's),
# the bf16 K1's tile and lap group, the bytes it stages each value in):
# phase 15's convs (quick_start's three, their dx role on the K1+K3 route,
# the headline) and deep stencils of radius 2-4 at nside 256, 4 -> 4
_BF16_PLANS = [
    ("quick_start conv 1", 64, 9, 1, 10, 16, 1, 8, "fused", (32, 1), 4),
    ("quick_start conv 2", 32, 9, 1, 10, 16, 8, 16, "fused", (32, 4), 4),
    ("quick_start conv 3", 16, 9, 1, 10, 16, 16, 32, "fused", (16, 4), 4),
    ("dx role of conv 1", 64, 9, 1, 10, 16, 8, 1, "fused", (32, 4), 4),
    ("dx role of conv 2", 32, 9, 1, 10, 16, 16, 8, "fused", (32, 4), 4),
    ("dx role of conv 3", 16, 9, 1, 10, 16, 32, 16, "fused", (16, 4), 4),
    ("headline", 1024, 4, 1, 5, 4, 4, 4, "fused", (32, 4), 4),
    ("radius 2, h=8", 256, 8, 2, 5, 4, 4, 4, "fused", (32, 2), 2),
    ("radius 3, h=12", 256, 12, 3, 5, 4, 4, 4, "fused", (16, 1), 2),
    ("radius 4, h=16", 256, 16, 4, 5, 4, 4, 4, ("fused", "per_step"), (8, 1),
     2),
    ("radius 3 lap, h=3", 256, 3, 3, 2, 4, 4, 4, "fused", (16, 1), 4),
    ("radius 4 lap, h=4", 256, 4, 4, 2, 4, 4, 4, "fused", (16, 1), 4),
]


@pytest.mark.parametrize("label,n,h,r,K,B,Fin,Fout,route,TG,staged",
                         _BF16_PLANS, ids=[c[0] for c in _BF16_PLANS])
def test_bf16_k1_staging_keeps_the_route_and_plan(label, n, h, r, K, B, Fin,
                                                  Fout, route, TG, staged):
    """The bfloat16 K1 launches on the 2-byte plan (the plan and route of
    its 2-byte shared elements, under either bf16 mode) and holds its
    values in 4 bytes wherever the float32 kernel's shared bytes fit that
    plan's tile, lap group and output channels, else in 2: no route or
    plan changes with the staging, and where the 4-byte plan differs (a
    smaller tile or lap group, or none) the 2-byte staging is taken.
    Plans only: no graph, no launch."""
    nplanes = (2 * r + 1) ** 2
    bf16_route, f32_route = route if isinstance(route, tuple) else (route,
                                                                     route)
    try:
        for mode in ("bfloat16", "bfloat16_io"):
            config.set_conv_dtype(mode)
            assert tfs.staged_bytes() == 2
            assert tfs._cface_route(n, h, r, nplanes, K, B, Fin, Fout,
                                    _H100_SMS, True, tfs.staged_bytes()) \
                == bf16_route, label
    finally:
        config.set_conv_dtype("float32")
    assert tfs._cface_route(n, h, r, nplanes, K, B, Fin, Fout, _H100_SMS,
                            True) == f32_route
    p2 = tfs._k1_plan(n, h, r, nplanes, K, B, 12, Fin, Fout, _H100_SMS, 2)
    p4 = tfs._k1_plan(n, h, r, nplanes, K, B, 12, Fin, Fout, _H100_SMS, 4)
    assert (p2.T, p2.G) == TG
    assert tfs._k1_bf16_staging(p2, h, r, nplanes, K) == staged
    fits = tfs._k1_smem(p2.T, h, r, nplanes, K, p2.G, p2.FC, 4) <= \
        tfs._SMEM_MAX
    assert (staged == 4) == fits
    # where the float32 bytes fit at the 2-byte plan, the 4-byte plan is
    # that plan; else it is another one or none
    if staged == 4:
        assert p4[:4] == p2[:4] and p4.grid == p2.grid
    else:
        assert p4 is None or p4[:4] != p2[:4]


# the bf16 K2's and K3's 2-byte plans (T, G, FC) at _BF16_PLANS's shapes,
# and the bytes they stage each value in: K2 recurs over Fout and folds
# Fin, K3 the other way.  2 where the float32 bytes do not fit the plan
# (radius 2 at h = 8, radius 3 at h = 12, radius 4 at h = 16), or fit one
# block an SM where 2 bytes fit the two its registers allow (K2 at
# quick_start's conv 1, K3 in the dx roles of convs 1 and 2)
_BF16_BWD_PLANS = {
    "quick_start conv 1": {"K2": (32, 4, 4, 2), "K3": (32, 1, 8, 4)},
    "quick_start conv 2": {"K2": (32, 4, 8, 4), "K3": (16, 4, 16, 4)},
    "quick_start conv 3": {"K2": (16, 4, 16, 4), "K3": (16, 4, 32, 4)},
    "dx role of conv 1": {"K2": (32, 1, 8, 4), "K3": (32, 4, 4, 2)},
    "dx role of conv 2": {"K2": (16, 4, 16, 4), "K3": (32, 4, 8, 2)},
    "dx role of conv 3": {"K2": (16, 4, 32, 4), "K3": (16, 4, 16, 4)},
    "headline": {"K2": (32, 4, 4, 4), "K3": (32, 4, 4, 4)},
    "radius 2, h=8": {"K2": (32, 2, 4, 2), "K3": (32, 2, 4, 2)},
    "radius 3, h=12": {"K2": (16, 1, 4, 2), "K3": (16, 1, 4, 2)},
    "radius 4, h=16": {"K2": (8, 1, 4, 2), "K3": (8, 1, 4, 2)},
    "radius 3 lap, h=3": {"K2": (16, 1, 4, 4), "K3": (16, 1, 4, 4)},
    "radius 4 lap, h=4": {"K2": (16, 1, 4, 4), "K3": (16, 1, 4, 4)},
}


@pytest.mark.parametrize("role", ["K2", "K3"])
@pytest.mark.parametrize("label,n,h,r,K,B,Fin,Fout,route,TG,staged",
                         _BF16_PLANS, ids=[c[0] for c in _BF16_PLANS])
def test_bf16_bwd_staging_keeps_the_route_and_plan(label, n, h, r, K, B, Fin,
                                                   Fout, route, TG, staged,
                                                   role):
    """The bfloat16 K2 and K3 launch on their 2-byte plans, as K1 does,
    and hold their values in 4 bytes exactly where the float32 kernel's
    shared bytes fit that plan's tile, lap group and fold channels and
    keep the blocks an SM holds at 2 bytes, else in 2: the plan and the
    route do not change with the staging.  Plans only: no graph, no
    launch."""
    nplanes = (2 * r + 1) ** 2
    dx = role == "K2"
    Crec, Cch = (Fout, Fin) if dx else (Fin, Fout)
    p2 = tfs._bwd_plan(n, h, r, nplanes, K, B, 12, Crec, Cch, dx, _H100_SMS,
                       2)
    p4 = tfs._bwd_plan(n, h, r, nplanes, K, B, 12, Crec, Cch, dx, _H100_SMS,
                       4)
    T, G, FC, bwd_staged = _BF16_BWD_PLANS[label][role]
    assert (p2.T, p2.G, p2.FC) == (T, G, FC)
    assert tfs._bwd_bf16_staging(p2, h, r, nplanes, K, Crec, dx) == bwd_staged
    s2, s4 = (tfs._bwd_smem(T, h, r, nplanes, K, G, FC, Crec, dx, es)
              for es in (2, 4))
    assert p2.smem == s2
    fits = s4 <= tfs._SMEM_MAX
    keeps = tfs._bwd_blocks(p2, r, dx, s4) >= tfs._bwd_blocks(p2, r, dx, s2)
    assert (bwd_staged == 4) == (fits and keeps)
    # where the float32 bytes fit, the 4-byte plan is the 2-byte one; else
    # it is another one or none
    if fits:
        assert p4[:4] == p2[:4] and p4.grid == p2.grid
    else:
        assert p4 is None or p4[:4] != p2[:4]
    bf16_route = route[0] if isinstance(route, tuple) else route
    try:
        for mode in ("bfloat16", "bfloat16_io"):
            config.set_conv_dtype(mode)
            assert tfs._cface_route(n, h, r, nplanes, K, B, Fin, Fout,
                                    _H100_SMS, True, tfs.staged_bytes()) \
                == bf16_route, label
    finally:
        config.set_conv_dtype("float32")


@pytest.mark.parametrize("k,r", [(8, 1), (20, 2)])
def test_stencil_offsets_are_the_kernels_taps(k, r):
    """K1 compiles its taps in the order of ``stencil_offsets``: radius 1 in
    the healpix_base neighbour order, larger radii in raster order, the
    centre last (``plane_of`` in ``csrc/stencil_conv.cu``)."""
    _, st = _stencils(16, 0.75, 2 * r, k)
    assert st.radius == r
    assert list(st.offsets) == stencil_offsets(st.radius)
    assert stencil_offsets(1) == [(-1, 0), (-1, 1), (0, 1), (1, 1),
                                         (1, 0), (1, -1), (0, -1), (-1, -1),
                                         (0, 0)]
    for rr in (2, 3, 4):
        raster = [(dx, dy) for dx in range(-rr, rr + 1)
                  for dy in range(-rr, rr + 1) if (dx, dy) != (0, 0)]
        assert stencil_offsets(rr) == raster + [(0, 0)]


def test_k1_wrapper_rejects_other_tap_orders():
    """A stencil whose taps are not ``stencil_offsets(radius)`` is refused
    before any launch."""
    from types import SimpleNamespace

    offs = stencil_offsets(1)
    st = SimpleNamespace(nside=8, n_steps=2, radius=1,
                         offsets=offs[1:] + offs[:1])
    x = torch.zeros(1, 12, 8, 128)
    with pytest.raises(ValueError, match="stencil_offsets"):
        tfs.run_stencil_kernel(st, "cheby", 3, x, None, None,
                               torch.zeros(3, 1, 1), 1)


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
    assert _cuda.launch_counts == {"strips": 0, "stencil_conv": 0, "dxdw": 0,
                                   "grad": 0, "bands": 0}


def test_fused_conv_backward_runs_on_cpu(rng):
    """On the CPU the conv's backward runs the plain versions of its
    kernels (``tests/test_torch_train.py`` holds it to JAX)."""
    n, h, K, B = 8, 2, 3, 1
    _, st = _stencils(n, 1.0, h)
    tables = as_tensors(stencil_tables(st))
    x = torch.from_numpy(_xc(rng, n, h, 2)).requires_grad_()
    kern = torch.ones(2 * K, 2, requires_grad=True)
    tfs.fused_stencil_conv_cfp(st, tables, x, kern, K, "mono", B).sum().backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(kern.grad).all()


# ---------------------------------------------------------------------------
# K2 and K3: the raw backward kernels
# ---------------------------------------------------------------------------

# (nside, k, kind, scale, K): cheby and mono, one radius-2 stencil (k=20)
_BWD_CASES = [(8, 8, "cheby", 0.75, 5), (16, 8, "mono", 1.0, 3),
              (16, 20, "cheby", 0.75, 3)]


def _bwd_inputs(rng, n, k, scale, K):
    """Stencils and inputs with garbage in every halo lane; B=2, Fin=2,
    Fout=3 (Fin != Fout, so a transposed dW cannot pass)."""
    r = 2 if k == 20 else 1
    h = r * (K - 1)
    sj, st = _stencils(n, scale, h, k)
    assert st.radius == r
    B, Fin, Fout = 2, 2, 3
    x = _xc(rng, n, h, B * Fin, garbage=True)
    dy = _xc(rng, n, h, B * Fout, garbage=True)
    return sj, st, h, B, Fin, Fout, x, dy


@pytest.mark.parametrize("n,k,kind,scale,K", _BWD_CASES)
def test_raw_dxdw_matches_jax_kernel(rng, n, k, kind, scale, K):
    """Plain K2 against ``_run_dxdw_kernel`` (interpret mode): dx on every
    interior lane (corner rows included, before their patch) and dW with
    the corr_mask plane applied to x."""
    sj, st, h, B, Fin, Fout, x, dy = _bwd_inputs(rng, n, k, scale, K)
    wk3t = rng.normal(size=(K, Fout, Fin)).astype(np.float32)
    jt = {kk: jnp.asarray(v) for kk, v in jstencil.stencil_tables(sj).items()}
    dx_j, dw_j = jps._run_dxdw_kernel(
        sj, kind, K, jnp.asarray(dy), jnp.asarray(sj.weights),
        jps._strip_arrays(sj, jnp.asarray(dy)), jnp.asarray(wk3t),
        jnp.asarray(x), jps._dw_mask_graph(sj, jnp.float32, jt), B,
        interpret=True)
    tables = as_tensors(stencil_tables(st))
    dyt = torch.from_numpy(dy)
    dx, dw = tfs.run_dxdw_kernel(
        st, kind, K, dyt, torch.from_numpy(st.weights),
        tstrips.strip_arrays(st, dyt), torch.from_numpy(wk3t),
        torch.from_numpy(x), tables["corr_mask"], B)
    assert dx.shape == (B * Fin, 12, n, 128) and dw.shape == (K * Fin, Fout)
    _close(dx[..., h:h + n].numpy(), np.asarray(dx_j)[..., h:h + n])
    _close(dw.numpy(), np.asarray(dw_j))
    assert dx[..., :h].abs().max() == 0 and dx[..., h + n:].abs().max() == 0
    assert _cuda.launch_counts["dxdw"] == 0


@pytest.mark.parametrize("n,k,kind,scale,K", _BWD_CASES)
def test_raw_grad_matches_jax_kernel(rng, n, k, kind, scale, K):
    """Plain K3 against ``_run_grad_kernel`` (interpret mode); dy's halo
    lanes hold garbage that neither may read."""
    sj, st, h, B, Fin, Fout, x, dy = _bwd_inputs(rng, n, k, scale, K)
    want = jps._run_grad_kernel(
        sj, kind, K, jnp.asarray(x), jnp.asarray(sj.weights),
        jps._strip_arrays(sj, jnp.asarray(x)), jnp.asarray(dy), B, Fin,
        interpret=True)
    xt = torch.from_numpy(x)
    got = tfs.run_grad_kernel(st, kind, K, xt, torch.from_numpy(st.weights),
                              tstrips.strip_arrays(st, xt),
                              torch.from_numpy(dy), B)
    assert got.shape == (K * Fin, Fout)
    _close(got.numpy(), np.asarray(want))
    assert _cuda.launch_counts["grad"] == 0


def test_corr_mask_zeroes_exactly_the_corrupt_rows():
    n, h = 16, 4
    sj, st = _stencils(n, 0.75, h)
    cm = stencil_tables(st)["corr_mask"]
    np.testing.assert_array_equal(cm, jstencil.stencil_tables(sj)["corr_mask"])
    assert cm.shape == (12, n, 128) and (cm == 0).sum() == st.corr_out_face.shape[0]


# (label, n, h, r, nplanes, K, B, F, Fin, Fout): every shape the paths give
# the backward kernels, K2 with Crec = Fout and Cch = Fin, K3 the other way
_BWD_SHAPES = [
    ("quick_start conv 1", 64, 9, 1, 9, 10, 16, 12, 1, 8),
    ("quick_start conv 2", 32, 9, 1, 9, 10, 16, 12, 8, 16),
    ("quick_start conv 3", 16, 9, 1, 9, 10, 16, 12, 16, 32),
    ("headline", 1024, 4, 1, 9, 5, 4, 12, 4, 4),
    ("k=20 radius 2, h=18", 32, 18, 2, 25, 10, 2, 12, 2, 3),
    ("face shard of 3, headline", 1024, 4, 1, 9, 5, 4, 3, 4, 4),
]


@pytest.mark.parametrize("dx", [True, False], ids=["K2", "K3"])
@pytest.mark.parametrize("label,n,h,r,nplanes,K,B,F,Fin,Fout", _BWD_SHAPES,
                         ids=[c[0] for c in _BWD_SHAPES])
def test_bwd_plan_at_the_paths_shapes(label, n, h, r, nplanes, K, B, F, Fin,
                                      Fout, dx):
    """K2's and K3's launch plan at every shape the paths use: a tile, a lap
    group dividing the recursion channels, at most 227 KB of shared memory
    (the window, the buffers, the dW sums and cells), and a grid within
    CUDA's limits that covers every (tile, face, batch index, fold channel)
    once."""
    Crec, Cch = (Fout, Fin) if dx else (Fin, Fout)
    p = tfs._bwd_plan(n, h, r, nplanes, K, B, F, Crec, Cch, dx, _H100_SMS)
    assert p is not None, label
    assert p.T in (32, 16, 8) and n % p.T == 0
    assert 1 <= p.GB <= B and 1 <= p.G <= tfs._K1_GMAX[r] and Crec % p.G == 0
    assert p.FC in ((4, 8) if p.T == 32 else (4, 8, 16, 32))
    assert p.smem == tfs._bwd_smem(p.T, h, r, nplanes, K, p.G, p.FC, Crec, dx)
    assert p.smem <= 227 * 1024
    chunks = -(-Cch // p.FC)
    assert p.grid == ((n // p.T) ** 2, F, -(-B // p.GB) * chunks)
    assert p.grid[0] < 2 ** 31 and p.grid[1] <= 65535 and p.grid[2] <= 65535
    if p.GB > 1:
        assert p.grid[0] * p.grid[1] * p.grid[2] >= 2 * _H100_SMS


def test_bwd_plan_holds_every_fold_channel_once():
    """Where a tile's block holds all the fold channels, the plan takes it,
    so each lap runs once per block: K3 at quick_start conv 2 (16 dy
    channels) leaves the 32-tile (8 a block) for a 16-tile, and at conv 3
    holds all 32; only where no tile can does the plan cut the fold
    channels into chunks."""
    plan = lambda *shape, sms=_H100_SMS: tfs._bwd_plan(*shape, sms)
    p = plan(32, 9, 1, 9, 10, 16, 12, 8, 16, False)
    assert (p.T, p.FC) == (16, 16) and p.grid[2] == -(-16 // p.GB)
    assert plan(16, 9, 1, 9, 10, 16, 12, 16, 32, False).FC == 32
    # past 32 fold channels no block holds them all: two chunks of 32
    p = plan(16, 4, 1, 9, 5, 2, 12, 40, 40, True)
    assert (p.T, p.FC) == (16, 32) and p.grid[2] == 2 * -(-2 // p.GB)
    # a 32-face map at radius 3 takes no 32-tile
    assert plan(32, 9, 3, 49, 4, 2, 12, 2, 2, False).T == 16
    # the headline fills the card from (face, tile) alone: a block takes the
    # whole batch; K2 at conv 1 keeps the batch in the grid
    assert plan(1024, 4, 1, 9, 5, 4, 12, 4, 4, True).GB == 4
    assert plan(64, 9, 1, 9, 10, 16, 12, 8, 1, True, sms=6).GB == 16
    # 4 channels a lap group where they divide the recursion channels
    assert plan(32, 9, 1, 9, 10, 2, 12, 6, 3, False).G == 2
    assert plan(32, 18, 2, 25, 10, 2, 12, 4, 3, False).G == 2


def test_bwd_plan_refuses_what_the_kernels_do_not_take():
    """None where no tile fits shared memory (radius 4 at h=16), the grid's
    z extent passes 65535, or the stencil is not a radius's full square."""
    plan = lambda *shape: tfs._bwd_plan(*shape, _H100_SMS)
    assert plan(32, 16, 4, 81, 5, 2, 12, 2, 2, True) is None
    assert plan(16, 4, 1, 9, 3, 1, 12, 1, 32 * 65536, False) is None
    assert plan(16, 4, 1, 8, 5, 2, 12, 2, 2, False) is None
    assert plan(16, 4, 1, 9, 6, 2, 12, 2, 2, False) is None  # r (K-1) > h


@pytest.mark.parametrize("kernel", ["dxdw", "grad"])
def test_bwd_wrappers_reject_other_tap_orders(kernel):
    """K2 and K3 compile their taps as K1 does: a stencil whose taps are not
    ``stencil_offsets(radius)`` is refused before any launch."""
    from types import SimpleNamespace

    offs = stencil_offsets(1)
    st = SimpleNamespace(nside=8, n_steps=2, radius=1,
                         offsets=offs[1:] + offs[:1])
    x = torch.zeros(1, 12, 8, 128)
    with pytest.raises(ValueError, match="stencil_offsets"):
        if kernel == "dxdw":
            tfs.run_dxdw_kernel(st, "cheby", 3, x, None, (None,) * 3,
                                torch.zeros(3, 1, 1), x, None, 1)
        else:
            tfs.run_grad_kernel(st, "cheby", 3, x, None, (None,) * 3, x, 1)
