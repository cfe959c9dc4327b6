"""PyTorch port on a CUDA card: each hand-written kernel against its plain
version on identical CUDA inputs, and a small model's forward and train
step against the CPU.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false.  The file imports neither jax nor the JAX package, so it also runs
on a machine that has only PyTorch (no conftest there, hence its own
fixtures):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

The edge-band cut (K5) and the strips built from gathered bands must be
exact too.  Tolerance: 2e-5 of the plain version's max (both float32 without TF32;
only the order of the sums differs), 1e-4 for a dW, which sums a whole map
of products per entry; the strip gather must be exact, and a dW must be
bitwise-equal across two calls (no atomics).
"""

import copy

import numpy as np
import pytest
import torch

import deepsphere_tpu_torch as dt
from deepsphere_tpu_torch.graph import build_sphere_graph
from deepsphere_tpu_torch import config
from deepsphere_tpu_torch.interop import export_jax_variables
from deepsphere_tpu_torch.nn import healpy_layers as hp_nn
from deepsphere_tpu_torch.ops import _cuda
from deepsphere_tpu_torch.ops import fused_stencil as fs
from deepsphere_tpu_torch.ops import strips as tstrips
from deepsphere_tpu_torch.ops.stencil import (
    as_tensors,
    pack_edge_bands,
    pack_edge_bands_plain,
    stencil_tables,
)

pytestmark = pytest.mark.cuda

TOL = 2e-5
DW_TOL = 1e-4

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
    yield torch.device("cuda")
    config.set_fused_dw(True)


def _xc(rng, dev, n, h, C):
    """(C, 12, n, P_l) with garbage in the halo lanes too."""
    _, P_l = fs.cfp_geometry(n, h)
    return torch.from_numpy(
        rng.normal(size=(C, 12, n, P_l)).astype(np.float32)).to(dev)


def _close(got, want, tol=TOL):
    err = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
    assert err <= tol, err


@pytest.mark.parametrize("n,h,C", [(16, 9, 3), (32, 4, 2), (64, 9, 1),
                                   (32, 9, 64)])
def test_strips_kernel_matches_plain(rng, dev, n, h, C):
    st = _stencil(n, 0.75, h)
    x = _xc(rng, dev, n, h, C)
    got = tstrips.build_strips(st, x)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["strips"] == 1
    for g, w in zip(got, tstrips.strip_arrays(st, x)):
        assert torch.equal(g, w)


# (n, h, C, F): the quick_start depth, the headline depth, 2h > n (the
# bands overlap), h = 1, one face, more channels than a block has threads,
# a deep band (h = 16) on a wider face
_BANDS = [(16, 9, 3, 12), (64, 9, 2, 3), (32, 4, 5, 4), (8, 2, 1, 1),
          (8, 5, 2, 3), (16, 1, 3, 12), (16, 9, 300, 1), (32, 9, 257, 12),
          (64, 16, 3, 2)]


@pytest.mark.parametrize("n,h,C,F", _BANDS)
def test_bands_kernel_matches_plain(rng, dev, n, h, C, F):
    """K5: the four edge bands of F faces, packed face-major, are a copy:
    exactly the plain version's."""
    _, P_l = fs.cfp_geometry(n, h)
    x = torch.from_numpy(
        rng.normal(size=(C, F, n, P_l)).astype(np.float32)).to(dev)
    got = pack_edge_bands(x, n, h)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["bands"] == 1
    assert got.shape == (F, C, 4 * h * n)
    assert torch.equal(got, pack_edge_bands_plain(x, n, h))


@pytest.mark.parametrize("n,h", [(16, 9), (32, 4), (32, 9)])
def test_bands_kernel_takes_an_unaligned_input(rng, dev, n, h):
    """An xc that starts 4 bytes past a 16-byte boundary (a view into a
    larger buffer) reads its floats one by one: still exact."""
    _, P_l = fs.cfp_geometry(n, h)
    C, F = 3, 12
    buf = torch.from_numpy(
        rng.normal(size=C * F * n * P_l + 1).astype(np.float32)).to(dev)
    x = buf[1:].view(C, F, n, P_l)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    assert torch.equal(pack_edge_bands(x, n, h), pack_edge_bands_plain(x, n, h))


@pytest.mark.parametrize("n,h,S", [(16, 9, 4), (32, 4, 3), (64, 9, 12)])
def test_band_strips_match_the_unsharded_strips(rng, dev, n, h, S):
    """The shard data flow: K5 on each of S face slices, the buffers
    concatenated (what the all-gather returns), every shard's strips built
    from it by the gather kernel: exactly the unsharded K4 strips' slices
    and the plain band strips."""
    st = _stencil(n, 0.75, h)
    x = _xc(rng, dev, n, h, 3)
    F = 12 // S
    bands = torch.cat([pack_edge_bands(x[:, s * F:(s + 1) * F].contiguous(),
                                       n, h) for s in range(S)])
    full = tstrips.build_strips(st, x)
    for s in range(S):
        faces = range(s * F, (s + 1) * F)
        got = tstrips.build_band_strips(st, bands, faces)
        plain = tstrips.build_band_strips(st, bands.cpu(), faces)
        for g, f, p in zip(got, full, plain):
            assert torch.equal(g, f[:, s * F:(s + 1) * F])
            assert torch.equal(g.cpu(), p)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["bands"] == S
    assert _cuda.launch_counts["strips"] == 1 + S


@pytest.mark.parametrize(
    "n,k,kind,scale,K,B,Fin,Fout,F,role",
    [(16, 8, "cheby", 0.75, 10, 2, 3, 9, 12, "fwd"),
     (32, 8, "cheby", 0.75, 5, 1, 2, 4, 12, "fwd"),
     (64, 8, "mono", 1.0, 3, 2, 1, 8, 12, "fwd"),
     (8, 8, "cheby", 0.75, 3, 3, 2, 2, 12, "fwd"),
     (16, 20, "cheby", 0.75, 3, 2, 2, 3, 12, "fwd"),
     (32, 20, "mono", 1.0, 10, 1, 2, 2, 12, "fwd"),
     # Fout 32 at B=4: past the first version's 8-channel chunk, and on a
     # 32-tile past the 16 output channels a block holds
     (32, 8, "cheby", 0.75, 5, 4, 3, 32, 12, "fwd"),
     # the arrays of a face shard of 3
     (32, 8, "cheby", 0.75, 5, 2, 4, 4, 3, "fwd"),
     # the headline's channel widths
     (64, 8, "cheby", 0.75, 5, 4, 4, 4, 12, "fwd"),
     # the dx role: W^T, recursion over Fout = 16 channels into Fin = 8
     (32, 8, "cheby", 0.75, 10, 2, 8, 16, 12, "dx"),
     (16, 20, "mono", 1.0, 4, 2, 2, 3, 12, "fwd")],
)
def test_conv_kernel_matches_plain(rng, dev, n, k, kind, scale, K, B, Fin,
                                   Fout, F, role):
    """Raw conv on every interior lane (corner rows included), zero halo
    lanes, then the corrected conv; radius 1 (k=8) and radius 2 (k=20, at
    h=18 on 8x8 tiles so the 25 weight planes fit shared memory).  The dx
    role runs the conv with the transposed channel kernel, as the K1+K3
    backward does; a face shard's arrays (F < 12) hold the first F faces."""
    st = _stencil(n, scale, (K - 1) * (2 if k == 20 else 1), k)
    h = st.n_steps
    tables = as_tensors(stencil_tables(st), dev)
    kern = torch.from_numpy(
        rng.normal(size=(Fin * K, Fout)).astype(np.float32)).to(dev)
    if role == "dx":  # the conv of the backward: Fout -> Fin through W^T
        wk3 = fs._wk3t(kern, K)
        kern = wk3.permute(1, 0, 2).reshape(Fout * K, Fin).contiguous()
        Fin, Fout = Fout, Fin
    else:
        wk3 = fs._wk3(kern, K)
    x = _xc(rng, dev, n, h, B * Fin)
    s = tstrips.strip_arrays(st, x)
    if F < 12:
        xs = x[:, :F].contiguous()
        ss = tuple(a[:, :F].contiguous() for a in s)
        ws = tables["weights"][:, :F].contiguous()
    else:
        xs, ss, ws = x, s, tables["weights"]
    args = (st, kind, K, xs, ws, ss, wk3, B)
    raw = fs.run_stencil_kernel(*args)
    raw_p = fs.run_stencil_plain(*args)
    assert raw.shape == (B * Fout, F, n, xs.shape[-1])
    _close(raw[..., h:h + n], raw_p[..., h:h + n])
    assert raw[..., :h].abs().max() == 0 and raw[..., h + n:].abs().max() == 0
    y = fs.fused_stencil_conv_cfp(st, tables, x, kern, K, kind, B)
    y_p = fs.fused_stencil_conv_cfp_plain(st, tables, x, kern, K, kind, B)
    torch.cuda.synchronize()
    _close(y[..., h:h + n], y_p[..., h:h + n])
    assert _cuda.launch_counts == {"strips": 1, "stencil_conv": 2, "dxdw": 0,
                                   "grad": 0, "bands": 0}


def test_conv_kernel_takes_unaligned_inputs(rng, dev):
    """K1 copies its halo windows 16 bytes at a time where the sources are
    16-byte aligned; a contiguous input that starts one float into its
    storage takes the 4-byte copies and gives the same result."""
    n, K, B, Fin, Fout = 32, 5, 2, 4, 4
    st = _stencil(n, 0.75, K - 1)
    h = st.n_steps
    tables = as_tensors(stencil_tables(st), dev)
    x = _xc(rng, dev, n, h, B * Fin)
    xu = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape).copy_(x)
    assert xu.is_contiguous() and xu.data_ptr() % 16 != 0
    wk3 = torch.from_numpy(
        rng.normal(size=(K, Fin, Fout)).astype(np.float32)).to(dev)
    s = tstrips.strip_arrays(st, x)
    y = fs.run_stencil_kernel(st, "cheby", K, x, tables["weights"], s, wk3, B)
    yu = fs.run_stencil_kernel(st, "cheby", K, xu, tables["weights"], s, wk3,
                               B)
    torch.cuda.synchronize()
    assert torch.equal(y, yu)


def test_conv_kernel_on_two_cards(rng, dev):
    """K1 raises its dynamic shared-memory limit per device: the same
    instantiation, at more than the default 48 KB, launched on cuda:0 and
    then on cuda:1 (the current device left at cuda:0) gives the same
    result on both."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    n, K, B, Fin, Fout = 32, 5, 2, 4, 4
    st = _stencil(n, 0.75, K - 1)
    h = st.n_steps
    plan = fs._k1_plan(n, h, st.radius, len(st.offsets), K, B, 12, Fin, Fout,
                       torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.smem > 48 * 1024
    x = _xc(rng, dev, n, h, B * Fin)
    wk3 = torch.from_numpy(
        rng.normal(size=(K, Fin, Fout)).astype(np.float32)).to(dev)
    ys = []
    for d in (torch.device("cuda:0"), torch.device("cuda:1")):
        xd = x.to(d)
        w = torch.from_numpy(st.weights).to(d)
        ys.append(fs.run_stencil_kernel(st, "cheby", K, xd, w,
                                        tstrips.build_strips(st, xd),
                                        wk3.to(d), B))
        torch.cuda.synchronize(d)
    assert torch.equal(ys[0], ys[1].to(ys[0].device))


_BWD = [(16, 8, "cheby", 0.75, 10, 2, 3, 9, 12),
        (32, 8, "cheby", 0.75, 5, 1, 2, 4, 12),
        (64, 8, "mono", 1.0, 3, 2, 1, 8, 12),
        (8, 8, "cheby", 0.75, 3, 3, 2, 2, 12),
        (16, 20, "cheby", 0.75, 3, 2, 2, 3, 12),
        (32, 20, "mono", 1.0, 10, 1, 2, 2, 12),
        # Fout 32 at B=4: past one fold chunk of the first version, and past
        # the 8 fold channels a 32-tile's block holds in registers
        (32, 8, "cheby", 0.75, 5, 4, 3, 32, 12),
        # quick_start conv 3's widths, Fin 16 -> Fout 32 at nside 16
        (16, 8, "cheby", 0.75, 10, 2, 16, 32, 12),
        # the arrays of a face shard of 3
        (32, 8, "cheby", 0.75, 5, 2, 4, 4, 3),
        # the headline's widths
        (64, 8, "cheby", 0.75, 5, 4, 4, 4, 12),
        # a batch that the plan's batch group does not divide (5 = 4 + 1 on
        # an H100)
        (128, 8, "cheby", 0.75, 3, 5, 2, 3, 12),
        # 40 channels each way: past the 32 fold channels a block holds, so
        # K2 and K3 both cut the fold channels into two chunks
        (16, 8, "cheby", 0.75, 5, 2, 40, 40, 12)]


def _check_bwd_plan(dev, st, h, K, B, F, Crec, Cch, dx):
    """The plan's edge cases that a `_BWD` case is there to reach: a batch
    group that does not divide the batch (nside 128), fold channels in more
    than one chunk (past 32)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p = fs._bwd_plan(st.nside, h, st.radius, len(st.offsets), K, B, F, Crec,
                     Cch, dx, sms)
    if st.nside == 128:
        assert B % p.GB, p
    if Cch > 32:
        assert -(-Cch // p.FC) == 2, p


def _bwd_case(rng, dev, n, k, scale, K, B, Cx, Cdy, F):
    """Stencil, tables and the (B*Cx, F) / (B*Cdy, F) arrays of a raw
    backward test, the first F faces of 12 (a face shard's arrays), with
    garbage in every halo lane, and the strips of each."""
    st = _stencil(n, scale, (K - 1) * (2 if k == 20 else 1), k)
    h = st.n_steps
    tables = as_tensors(stencil_tables(st), dev)
    x = _xc(rng, dev, n, h, B * Cx)
    dy = _xc(rng, dev, n, h, B * Cdy)
    cut = lambda a: a[:, :F].contiguous()
    sx = tuple(cut(a) for a in tstrips.strip_arrays(st, x))
    sdy = tuple(cut(a) for a in tstrips.strip_arrays(st, dy))
    mask = tables.get("corr_mask")
    return (st, h, cut(tables["weights"]), None if mask is None else
            mask[:F].contiguous(), cut(x), sx, cut(dy), sdy)


@pytest.mark.parametrize("n,k,kind,scale,K,B,Fin,Fout,F", _BWD)
def test_dxdw_kernel_matches_plain(rng, dev, n, k, kind, scale, K, B, Fin,
                                   Fout, F):
    """K2 raw: dx on every interior lane, zero halo lanes, dW with the
    corr_mask plane; dW bitwise-equal across two calls."""
    st, h, w, mask, x, _, dy, s = _bwd_case(rng, dev, n, k, scale, K, B, Fin,
                                            Fout, F)
    _check_bwd_plan(dev, st, h, K, B, F, Fout, Fin, True)
    wk3t = torch.from_numpy(
        rng.normal(size=(K, Fout, Fin)).astype(np.float32)).to(dev)
    args = (st, kind, K, dy, w, s, wk3t, x, mask, B)
    dx, dw = fs.run_dxdw_kernel(*args)
    _, dw2 = fs.run_dxdw_kernel(*args)
    dx_p, dw_p = fs.run_dxdw_plain(*args)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["dxdw"] == 2
    _close(dx[..., h:h + n], dx_p[..., h:h + n])
    assert dx[..., :h].abs().max() == 0 and dx[..., h + n:].abs().max() == 0
    _close(dw, dw_p, DW_TOL)
    assert torch.equal(dw, dw2)


@pytest.mark.parametrize("n,k,kind,scale,K,B,Fin,Fout,F", _BWD)
def test_grad_kernel_matches_plain(rng, dev, n, k, kind, scale, K, B, Fin,
                                   Fout, F):
    """K3 raw against its plain version; dW bitwise-equal across calls."""
    st, h, w, _, x, s, dy, _ = _bwd_case(rng, dev, n, k, scale, K, B, Fin,
                                         Fout, F)
    _check_bwd_plan(dev, st, h, K, B, F, Fin, Fout, False)
    args = (st, kind, K, x, w, s, dy, B)
    dw = fs.run_grad_kernel(*args)
    dw2 = fs.run_grad_kernel(*args)
    dw_p = fs.run_grad_plain(*args)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["grad"] == 2
    _close(dw, dw_p, DW_TOL)
    assert torch.equal(dw, dw2)


# the bfloat16 instantiations of K1-K3 (config.conv_dtype "bfloat16", float32
# arrays, and "bfloat16_io", bfloat16 arrays): (n, k, kind, scale, K, B,
# Fin, Fout, F), at h = (K - 1) x the radius of the k-neighbour grid.
# h = 9 puts face column 0 at an odd lane; radius 2 (k=20); quick_start
# conv 3's widths; the arrays of a face shard of 3; quick_start conv 1
# (two tiles a face row: the first tile's window holds the lane pair
# h - 1 | h that straddles the west lane strip and the interior, the last
# one's h + n - 1 | h + n); radius 3 (k=40) and 4 (k=60) at K=5, where
# K1 holds 2-byte elements (its float32 bytes do not fit the plan's tile),
# and at K=2, where it holds float32 ones
_BF16 = [(16, 8, "cheby", 0.75, 10, 2, 3, 9, 12),
         (32, 8, "cheby", 0.75, 5, 2, 4, 4, 12),
         (32, 20, "mono", 1.0, 3, 1, 2, 3, 12),
         (16, 8, "cheby", 0.75, 10, 2, 16, 32, 12),
         (32, 8, "cheby", 0.75, 5, 2, 4, 4, 3),
         (64, 8, "cheby", 0.75, 10, 1, 1, 8, 12),
         (32, 40, "cheby", 0.75, 5, 2, 2, 3, 12),
         (32, 60, "cheby", 0.75, 5, 1, 2, 3, 12),
         (16, 40, "mono", 1.0, 2, 2, 2, 3, 12),
         (16, 60, "mono", 1.0, 2, 1, 2, 2, 12),
         # K1's 2-byte body with several window sets a lap (few tiles, so
         # a block takes GB = 6 batch indices, 4 a lap then 2), B no
         # multiple of GB (the last block holds 2 or 1) and Fin > G
         (16, 40, "cheby", 0.75, 5, 140, 2, 3, 12),
         (32, 60, "cheby", 0.75, 5, 7, 2, 3, 12),
         # K2's and K3's 2-byte kernel with window sets at an odd batch, so
         # that a lap runs fewer sets than the kernel holds: radius 3, B = 5
         # (blocks of 4 and 1 batch indices, 4 sets a lap); radius 4, B = 3
         # (one block, 2 sets a lap, then 1)
         (64, 40, "cheby", 0.75, 5, 5, 2, 3, 12),
         (64, 60, "cheby", 0.75, 5, 3, 2, 2, 12)]
_RADIUS = {8: 1, 20: 2, 40: 3, 60: 4}
# kernel against its plain version in the same mode: both round at the same
# points, but sum in other orders, so a bfloat16 term may differ by a step
# (y, dx); a dW sums a whole map of products in float32
BF_TOL = 1e-2
BF_DW_TOL = 1e-3
# the least distance of a bfloat16 result from the float32 kernels on the
# same values, of max|f32|: a kernel that skipped its rounding sits within
# TOL of them.  A dW moves less than y and dx where its inputs are
# bfloat16 already and K is small (T_0 x = x is exact), hence its own bound
BF_MOVED = 1e-3
BF_DW_MOVED = 1e-4


def _apart(got, f32, least=BF_MOVED):
    """``got`` farther than ``least`` of max|f32| from ``f32``, or zero
    where ``f32`` is (a dW whose rows the corner correction all takes)."""
    scale = f32.abs().max()
    if scale == 0:
        assert got.abs().max() == 0
        return
    err = ((got.float() - f32).abs().max() / scale).item()
    assert err > least, err


def _bf16_case(rng, dev, n, k, scale, K, B, Cx, Cdy, F, io):
    """``_bwd_case``'s arrays for a bfloat16 kernel: bfloat16 x, dy, strips
    (R16) and weight planes (``weights_bf16``) in the I/O mode, float32 in
    the band mode; and, for the float32 kernels on the same values, x, dy,
    their strips and the weight planes rounded to bfloat16, all float32."""
    st = _stencil(n, scale, (K - 1) * _RADIUS[k], k)
    assert st.radius == _RADIUS[k] and fs.cfp_io_available(st)
    h = st.n_steps
    tables = as_tensors(stencil_tables(st, bf16_io=True), dev)
    dt_ = torch.bfloat16 if io else torch.float32
    x = _xc(rng, dev, n, h, B * Cx).to(dt_)
    dy = _xc(rng, dev, n, h, B * Cdy).to(dt_)
    cut = lambda a: a[:, :F].contiguous()
    strips = lambda a: tuple(cut(s) for s in tstrips.strip_arrays(st, a))
    w = tables["weights_bf16" if io else "weights"]
    f32 = (cut(tables["weights"].to(torch.bfloat16).float()), cut(x.float()),
           strips(x.float()), cut(dy.float()), strips(dy.float()))
    mask = tables.get("corr_mask")  # none where no row needs correcting
    return (st, h, cut(w), None if mask is None else mask[:F].contiguous(),
            cut(x), strips(x), cut(dy), strips(dy), f32)


@pytest.mark.parametrize("io", [False, True], ids=["band", "io"])
@pytest.mark.parametrize("n,k,kind,scale,K,B,Fin,Fout,F", _BF16)
def test_bf16_kernels_match_plain(rng, dev, n, k, kind, scale, K, B, Fin,
                                  Fout, F, io):
    """K1, K2 (dx, dW) and K3 in each bfloat16 mode against their plain
    bfloat16 versions on identical CUDA inputs, to 1e-2 of the plain max
    (1e-3 for a dW), and apart from the float32 kernels on the same
    values; outputs in the arrays' dtype, pad lanes zero, dW float32 and
    bitwise-equal across two calls; each launch counted as the mode's (K1,
    K2 and K3 in 2-byte shared elements apart where their staging rules
    take them: radius 3 and 4 at K=5, and for K2 and K3 also where float32
    bytes would cost a block an SM)."""
    st, h, w, mask, x, sx, dy, sdy, f32 = _bf16_case(
        rng, dev, n, k, scale, K, B, Fin, Fout, F, io)
    kern = torch.from_numpy(
        rng.normal(size=(Fin * K, Fout)).astype(np.float32)).to(dev)
    sfx = "_bf16_io" if io else "_bf16"
    r, nplanes = st.radius, len(st.offsets)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = fs._k1_plan(n, h, r, nplanes, K, B, F, Fin, Fout, sms, 2)
    two = fs._k1_bf16_staging(plan, h, r, nplanes, K) == 2
    assert two == (r >= 3 and K == 5)
    # K2 recurs over Fout and folds Fin, K3 the other way (their stagings
    # at these shapes: tests/test_torch_kernels.py pins the rule)
    two_bwd = [fs._bwd_bf16_staging(
        fs._bwd_plan(n, h, r, nplanes, K, B, F, Crec, Cch, dx_, sms, 2), h, r,
        nplanes, K, Crec, dx_) == 2
        for Crec, Cch, dx_ in ((Fout, Fin, True), (Fin, Fout, False))]
    a1 = (st, kind, K, x, w, sx, fs._wk3(kern, K), B, "bfloat16")
    y, y_p = fs.run_stencil_kernel(*a1), fs.run_stencil_plain(*a1)
    a2 = (st, kind, K, dy, w, sdy, fs._wk3t(kern, K), x, mask, B, "bfloat16")
    (dx, dw), (_, dw2) = fs.run_dxdw_kernel(*a2), fs.run_dxdw_kernel(*a2)
    dx_p, dw_p = fs.run_dxdw_plain(*a2)
    a3 = (st, kind, K, x, w, sx, dy, B, "bfloat16")
    g, g2, g_p = (fs.run_grad_kernel(*a3), fs.run_grad_kernel(*a3),
                  fs.run_grad_plain(*a3))
    torch.cuda.synchronize()
    assert _cuda.bf16_launch_counts == {
        **{key: 0 for key in _cuda.bf16_launch_counts},
        "stencil_conv" + sfx + ("_s2" if two else ""): 1,
        "dxdw" + sfx + ("_s2" if two_bwd[0] else ""): 2,
        "grad" + sfx + ("_s2" if two_bwd[1] else ""): 2}
    assert all(v == 0 for v in _cuda.launch_counts.values())
    for got, plain in ((y, y_p), (dx, dx_p)):
        assert got.dtype == x.dtype == plain.dtype
        _close(got[..., h:h + n].float(), plain[..., h:h + n].float(), BF_TOL)
        assert got[..., :h].abs().max() == 0
        assert got[..., h + n:].abs().max() == 0
    for got, again, plain in ((dw, dw2, dw_p), (g, g2, g_p)):
        assert got.dtype == torch.float32
        _close(got, plain, BF_DW_TOL)
        assert torch.equal(got, again)
    wf, xf, sxf, dyf, sdyf = f32
    # the float32 kernels take no deep stencil past radius 2 (their plain
    # versions on the card are the same function to TOL)
    k1f, k2f, k3f = ((fs.run_stencil_kernel, fs.run_dxdw_kernel,
                      fs.run_grad_kernel) if r <= 2 else
                     (fs.run_stencil_plain, fs.run_dxdw_plain,
                      fs.run_grad_plain))
    yf = k1f(st, kind, K, xf, wf, sxf, fs._wk3(kern, K), B)
    dxf, dwf = k2f(st, kind, K, dyf, wf, sdyf, fs._wk3t(kern, K), xf, mask, B)
    gf = k3f(st, kind, K, xf, wf, sxf, dyf, B)
    for got, ref in ((y, yf), (dx, dxf)):
        _apart(got[..., h:h + n], ref[..., h:h + n])
    for got, ref in ((dw, dwf), (g, gf)):
        _apart(got, ref, BF_DW_MOVED)


def test_bf16_io_conv_kernel_takes_unaligned_inputs(rng, dev):
    """K1's I/O mode copies whole 4-byte words of its bfloat16 arrays, 16
    bytes where they are 16-byte aligned: an input that starts 4 bytes
    past a 16-byte boundary takes the word copies, one that starts 2 bytes
    past it a 4-byte-aligned copy of itself; all three give the same bits,
    at h = 9 (odd, words that straddle two arrays) and h = 4."""
    for n, K in ((16, 10), (32, 5)):
        st = _stencil(n, 0.75, K - 1)
        h = st.n_steps
        tables = as_tensors(stencil_tables(st, bf16_io=True), dev)
        w = tables["weights_bf16"]
        x = _xc(rng, dev, n, h, 2 * 3).to(torch.bfloat16)
        wk3 = torch.from_numpy(
            rng.normal(size=(K, 3, 4)).astype(np.float32)).to(dev)
        s = tstrips.strip_arrays(st, x)
        y = fs.run_stencil_kernel(st, "cheby", K, x, w, s, wk3, 2, "bfloat16")
        for skip in (2, 1):
            buf = torch.empty(x.numel() + skip, dtype=x.dtype, device=dev)
            xu = buf[skip:].view(x.shape).copy_(x)
            assert xu.is_contiguous() and xu.data_ptr() % 16 == 2 * skip
            yu = fs.run_stencil_kernel(st, "cheby", K, xu, w, s, wk3, 2,
                                       "bfloat16")
            assert torch.equal(y.view(torch.int16), yu.view(torch.int16))
    torch.cuda.synchronize()
    assert _cuda.bf16_launch_counts["stencil_conv_bf16_io"] == 6


def test_bf16_io_bwd_kernels_take_unaligned_inputs(rng, dev):
    """K2's and K3's I/O mode copy whole 4-byte words of their recursion
    input, its strips and the weight planes, 16 bytes where they are
    16-byte aligned: a recursion input that starts 4 bytes past a 16-byte
    boundary takes the word copies, one that starts 2 bytes past it a
    4-byte-aligned copy of itself; all three give the same dx and dW bits,
    at h = 9 (odd, words that straddle two arrays) and h = 4."""
    for n, K in ((16, 10), (32, 5)):
        st = _stencil(n, 0.75, K - 1)
        h = st.n_steps
        tables = as_tensors(stencil_tables(st, bf16_io=True), dev)
        w, mask = tables["weights_bf16"], tables.get("corr_mask")
        x = _xc(rng, dev, n, h, 2 * 3).to(torch.bfloat16)
        dy = _xc(rng, dev, n, h, 2 * 4).to(torch.bfloat16)
        wk3t = torch.from_numpy(
            rng.normal(size=(K, 4, 3)).astype(np.float32)).to(dev)
        k2 = lambda d: fs.run_dxdw_kernel(st, "cheby", K, d,
                                          w, tstrips.strip_arrays(st, d),
                                          wk3t, x, mask, 2, "bfloat16")
        k3 = lambda a: fs.run_grad_kernel(st, "cheby", K, a, w,
                                          tstrips.strip_arrays(st, a), dy, 2,
                                          "bfloat16")
        dx, dw = k2(dy)
        g = k3(x)
        for skip in (2, 1):
            moved = []
            for a in (dy, x):
                buf = torch.empty(a.numel() + skip, dtype=a.dtype, device=dev)
                moved.append(buf[skip:].view(a.shape).copy_(a))
                assert moved[-1].is_contiguous()
                assert moved[-1].data_ptr() % 16 == 2 * skip
            dxu, dwu = k2(moved[0])
            assert torch.equal(dx.view(torch.int16), dxu.view(torch.int16))
            assert torch.equal(dw, dwu)
            assert torch.equal(g, k3(moved[1]))
    torch.cuda.synchronize()
    assert _cuda.bf16_launch_counts["dxdw_bf16_io"] == 6
    assert _cuda.bf16_launch_counts["grad_bf16_io"] == 6


def test_bf16_strips_are_the_plain_strips(rng, dev):
    """K4 on bfloat16 activations (the I/O mode's R16 strips, 2-byte
    elements) equals the plain strips bit for bit, at h = 9 and 4."""
    for n, h in ((16, 9), (32, 4)):
        st = _stencil(n, 0.75, h)
        x = _xc(rng, dev, n, h, 3).to(torch.bfloat16)
        idx = as_tensors(stencil_tables(st, bf16_io=True), dev)[
            "strip_idx_bf16"]
        got = tstrips.build_strips(st, x, idx)
        assert got[0].shape[2] == got[1].shape[2] == 16
        for g, want in zip(got, tstrips.strip_arrays(st, x)):
            assert g.dtype == torch.bfloat16
            assert torch.equal(g.view(torch.int16), want.view(torch.int16))
    assert _cuda.bf16_launch_counts["strips_bf16"] == 2
    assert _cuda.launch_counts["strips"] == 0


@pytest.mark.parametrize("fused_dw", [True, False], ids=["K2", "K1+K3"])
@pytest.mark.parametrize("mode", ["bfloat16", "bfloat16_io"])
def test_bf16_conv_backward_matches_plain_autograd(rng, dev, mode, fused_dw):
    """The fused conv under each bfloat16 mode on the card (kernels) against
    autograd through its plain forward on the card in the same mode: y,
    dx and dW to 1e-2 (nside 32, K=5, corrections live); each apart from
    the float32 conv's."""
    config.set_fused_dw(fused_dw)
    config.set_conv_dtype(mode)
    try:
        n, K, B, Fin, Fout = 32, 5, 2, 3, 4
        st = _stencil(n, 0.75, K - 1)
        h = st.n_steps
        tables = as_tensors(stencil_tables(st, bf16_io=True), dev)
        x = _xc(rng, dev, n, h, B * Fin).requires_grad_()
        kern = torch.from_numpy(
            rng.normal(size=(Fin * K, Fout)).astype(np.float32)).to(dev)
        kern.requires_grad_()
        cot = _xc(rng, dev, n, h, B * Fout)
        outs = []
        for conv in (fs.fused_stencil_conv_cfp,
                     fs.fused_stencil_conv_cfp_plain):
            y = conv(st, tables, x, kern, K, "cheby", B)
            outs.append((y,) + torch.autograd.grad(y, (x, kern),
                                                   cot.to(y.dtype)))
        torch.cuda.synchronize()
    finally:
        config.set_conv_dtype("float32")
    io = mode == "bfloat16_io"
    assert outs[0][0].dtype == (torch.bfloat16 if io else torch.float32)
    for got, want in zip(outs[0], outs[1]):
        if got.dim() == 4:
            got, want = got[..., h:h + n], want[..., h:h + n]
        _close(got.float(), want.float(), BF_TOL)
    sfx = "_bf16_io" if io else "_bf16"
    assert _cuda.bf16_launch_counts["stencil_conv" + sfx] == 1 + (not fused_dw)
    assert _cuda.bf16_launch_counts[("dxdw" if fused_dw else "grad") + sfx] == 1
    assert _cuda.launch_counts["stencil_conv"] == 0
    y = fs.fused_stencil_conv_cfp(st, tables, x, kern, K, "cheby", B)
    f32 = (y,) + torch.autograd.grad(y, (x, kern), cot)
    for got, ref in zip(outs[0], f32):
        if got.dim() == 4:
            got, ref = got[..., h:h + n], ref[..., h:h + n]
        _apart(got, ref)


@pytest.mark.parametrize("fused_dw", [True, False])
def test_conv_backward_matches_plain_autograd(rng, dev, fused_dw):
    """The autograd function on the card (kernels) against autograd through
    the plain forward on the card, nside 32, K=5 (corrections live)."""
    config.set_fused_dw(fused_dw)
    n, K, B, Fin, Fout = 32, 5, 2, 3, 4
    st = _stencil(n, 0.75, K - 1)
    h = st.n_steps
    tables = as_tensors(stencil_tables(st), dev)
    x = _xc(rng, dev, n, h, B * Fin).requires_grad_()
    kern = torch.from_numpy(
        rng.normal(size=(Fin * K, Fout)).astype(np.float32)).to(dev)
    kern.requires_grad_()
    dy = _xc(rng, dev, n, h, B * Fout)
    grads = []
    for conv in (fs.fused_stencil_conv_cfp, fs.fused_stencil_conv_cfp_plain):
        y = conv(st, tables, x, kern, K, "cheby", B)
        grads.append(torch.autograd.grad(y, (x, kern), dy))
    (dx, dk), (dx_p, dk_p) = grads
    _close(dx[..., h:h + n], dx_p[..., h:h + n])
    _close(dk, dk_p, DW_TOL)
    assert dx[..., :h].abs().max() == 0
    want = ({"strips": 2, "stencil_conv": 1, "dxdw": 1, "grad": 0, "bands": 0}
            if fused_dw else
            {"strips": 2, "stencil_conv": 2, "dxdw": 0, "grad": 1, "bands": 0})
    assert _cuda.launch_counts == want


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


def _small_quick_start():
    return [
        hp_nn.HealpyChebyshev(K=10, Fout=8, activation="relu", use_bn=True),
        hp_nn.HealpyPool(p=1),
        hp_nn.HealpyChebyshev(K=10, Fout=16, activation="relu", use_bn=True),
        hp_nn.HealpyPool(p=1),
        hp_nn.Flatten(),
        hp_nn.Dense(4),
    ]


def test_k60_model_takes_the_per_step_route(rng, dev):
    """``HealpyGCNN(n_neighbors=60)`` with one Chebyshev K=5 conv at nside
    32: radius 4 at h=16 is a shape K1-K3 refuse, so on the card the cface
    conv takes the per-step route (counted once a forward) and launches no
    kernel; its logits and the gradients of a fixed cotangent match the
    same model on the CPU (the fused route's plain versions) to 1e-4."""
    nside = 32
    npix = 12 * nside * nside
    layers = [hp_nn.HealpyChebyshev(K=5, Fout=4, activation="relu"),
              hp_nn.HealpyPool(p=1), hp_nn.Flatten(), hp_nn.Dense(3)]
    cpu = dt.HealpyGCNN(nside, np.arange(npix), layers, n_neighbors=60).build(
        (2, npix, 1), seed=3, device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    x = torch.from_numpy(rng.normal(size=(2, npix, 1)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))
    out = {}
    for m, d in ((card, dev), (cpu, torch.device("cpu"))):
        _cuda.reset_launch_counts()
        y = m(x.to(d))
        y.backward(cot.to(d))
        out[d.type] = (y.detach().cpu(), {n: p.grad.cpu()
                                          for n, p in m.named_parameters()})
        if d.type == "cuda":
            assert all(v == 0 for v in _cuda.launch_counts.values())
            assert _cuda.route_counts == {"per_step_cface": 1,
                                          "chain_cface": 0, "lap_chain": 0,
                                          "smooth_fused": 0,
                                          "smooth_per_step": 0}
    (y_c, g_c), (y_p, g_p) = out["cuda"], out["cpu"]
    _close(y_c, y_p, 1e-4)
    for name in g_p:
        _close(g_c[name], g_p[name], 1e-4)


@pytest.mark.parametrize("fused_dw", [True, False])
def test_knn_model_matches_the_cpu(rng, dev, fused_dw):
    """``HealpyGCNN(graph_method="knn")`` at nside 32, k=8 (the reference's
    graph, built without sklearn): conv 1, Chebyshev K=5, runs in cface on
    the kNN deep stencil (radius-2 capture, h=8, corner rows recomputed
    from the ball) through K4 and K1 forward and K2 or K1 + K3 backward;
    logits and the gradients of a fixed cotangent match the same model on
    the CPU to 1e-4."""
    nside = 32
    npix = 12 * nside * nside
    layers = [hp_nn.HealpyChebyshev(K=5, Fout=4, activation="relu"),
              hp_nn.HealpyPool(p=1),
              hp_nn.HealpyChebyshev(K=5, Fout=6, activation="relu"),
              hp_nn.HealpyPool(p=1), hp_nn.Flatten(), hp_nn.Dense(3)]
    cpu = dt.HealpyGCNN(nside, np.arange(npix), layers, n_neighbors=8,
                        graph_method="knn").build((2, npix, 1), seed=4,
                                                  device="cpu")
    assert all(g.method == "knn" for g in cpu.graphs.values())
    card = copy.deepcopy(cpu).to(dev)
    x = torch.from_numpy(rng.normal(size=(2, npix, 1)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))
    config.set_fused_dw(fused_dw)
    out = {}
    for m, d in ((card, dev), (cpu, torch.device("cpu"))):
        _cuda.reset_launch_counts()
        y = m(x.to(d))
        y.backward(cot.to(d))
        out[d.type] = (y.detach().cpu(), {n: p.grad.cpu()
                                          for n, p in m.named_parameters()})
        if d.type == "cuda":
            torch.cuda.synchronize()
            c = dict(_cuda.launch_counts)
            # conv 1: K4 + K1 forward; backward K4 on dy + K2, or K3 on
            # x's strips (its input needs no dx)
            want = ({"strips": 2, "stencil_conv": 1, "dxdw": 1, "grad": 0}
                    if fused_dw else
                    {"strips": 1, "stencil_conv": 1, "dxdw": 0, "grad": 1})
            assert c == {**want, "bands": 0}, c
            assert not any(_cuda.route_counts.values())
    (y_c, g_c), (y_p, g_p) = out["cuda"], out["cpu"]
    _close(y_c, y_p, 1e-4)
    for name in g_p:
        _close(g_c[name], g_p[name], 1e-4)


def test_cface_conv_raises_before_launch_where_a_kernel_has_no_plan(rng,
                                                                    dev):
    """k=20 grid at K=11 (radius 2, h=20), batch 1, 2048 -> 2048 channels:
    K1 takes the forward, but no plan of K2 or K3 takes the backward, one
    shot or on the lap chain (their dW cells outgrow shared memory at
    every tile).  A conv that needs a gradient raises before any launch;
    one that needs none takes the one-shot K1."""
    from deepsphere_tpu_torch.ops.stencil import stencil_graph_conv_cface

    n, K, B, Fin, Fout = 32, 11, 1, 2048, 2048
    st = _stencil(n, 0.75, 20, k=20)
    assert st.radius == 2
    _, P_l = fs.cfp_geometry(n, st.n_steps)
    x = torch.zeros((B, Fin, 12, n, P_l), device=dev)
    kern = torch.zeros((Fin * K, Fout), device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="no plan of K2, K3 takes its lap "
                       "chain"):
        stencil_graph_conv_cface(st, x, kern, K, "cheby")
    assert all(v == 0 for v in _cuda.launch_counts.values())
    assert all(v == 0 for v in _cuda.route_counts.values())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert fs.cface_route(st, "cheby", K, B, Fin, Fout, sms,
                          grad=False) == "fused"


def test_exported_quick_start_replays_on_the_card(rng, dev, tmp_path):
    """The quick_start classifier at nside 32 (its convs at nside 32 and
    16 in cface; at nside 8 and 4 a K=10 halo is deeper than the face),
    exported on the card with a polymorphic batch, saved and loaded: its
    graph holds one K1 and one K4 op per cface conv, a replayed forward
    launches exactly those, and its logits match the live model's
    ``predict`` to 1e-5 of their max (the same kernels on the same
    plans)."""
    from deepsphere_tpu_torch import serve

    nside = 32
    npix = 12 * nside * nside
    layers = [
        hp_nn.HealpyChebyshev(K=10, Fout=8, activation="relu", use_bn=True),
        hp_nn.HealpyPool(p=1),
        hp_nn.HealpyChebyshev(K=10, Fout=16, activation="relu", use_bn=True),
        hp_nn.HealpyPool(p=1),
        hp_nn.HealpyChebyshev(K=10, Fout=32, activation="relu", use_bn=True),
        hp_nn.HealpyPool(p=1),
        hp_nn.HealpyChebyshev(K=10, Fout=32, activation="relu"),
        hp_nn.Flatten(),
        hp_nn.Dense(4),
    ]
    model = dt.HealpyGCNN(nside, np.arange(npix), layers).build(
        (16, npix, 1), seed=5)
    n_cf = sum(getattr(m, "layout", None) == "cface" and hasattr(m, "graph")
               for m in model.layers.values())
    assert n_cf == 2
    x = rng.normal(size=(6, npix, 1)).astype(np.float32)
    want = model.predict(x)
    path = tmp_path / "quick_start.pt2"
    assert model.save_exported(path) == path.stat().st_size
    em = serve.load_exported(path)
    assert em.device.type == "cuda" and em.input_shape == ("b", npix, 1)
    assert em.op_counts() == {"strips": n_cf, "stencil_conv": n_cf}
    _cuda.reset_launch_counts()
    got = em(x[:5]).cpu().numpy()
    torch.cuda.synchronize()
    assert _cuda.launch_counts == {"strips": n_cf, "stencil_conv": n_cf,
                                   "dxdw": 0, "grad": 0, "bands": 0}
    assert not any(_cuda.route_counts.values())
    assert np.abs(got - want[:5]).max() <= 1e-5 * np.abs(want).max()
    got = em.predict(x, batch_size=4)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _chain_launches(laps, fused_dw=None):
    """Launches of a lap chain of ``laps`` laps: the forward, and with
    ``fused_dw`` set its backward too (K2 a lap; or K1 on dy a lap, and no
    K3: the term selector needs no gradient)."""
    want = {"strips": laps, "stencil_conv": laps, "dxdw": 0, "grad": 0,
            "bands": 0}
    if fused_dw is True:
        want.update(strips=2 * laps, dxdw=laps)
    elif fused_dw is False:
        want.update(strips=2 * laps, stencil_conv=2 * laps)
    return want


@pytest.mark.parametrize("fused_dw", [True, False])
def test_lap_chain_matches_the_per_step_path(rng, dev, fused_dw):
    """A k=40 (radius 3) Chebyshev K=4 conv at nside 16 on its shallow
    stencil takes the lap chain on the card (counted once; K4 and K1 once
    a lap; backward K2, or K1 on dy, once a lap): y and the gradients of a
    fixed cotangent match the per-step path on the CPU."""
    from deepsphere_tpu_torch.ops.stencil import stencil_graph_conv

    config.set_fused_dw(fused_dw)
    n, K, B, Fin, Fout = 16, 4, 2, 3, 2
    st = _stencil(n, 0.75, 3, k=40)
    assert st.radius == 3
    x = torch.from_numpy(rng.normal(size=(B, 12 * n * n, Fin)).astype(
        np.float32))
    kern = torch.from_numpy((rng.normal(size=(Fin * K, Fout)) * 0.3).astype(
        np.float32))
    cot = torch.from_numpy(rng.normal(size=(B, 12 * n * n, Fout)).astype(
        np.float32))
    out = {}
    for d in (dev, torch.device("cpu")):
        _cuda.reset_launch_counts()
        xd = x.to(d).requires_grad_()
        kd = kern.to(d).requires_grad_()
        y = stencil_graph_conv(st, xd, kd, K, "cheby")
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert _cuda.route_counts["lap_chain"] == 1
            assert _cuda.launch_counts == _chain_launches(K - 1)
        dx, dk = torch.autograd.grad(y, (xd, kd), cot.to(d))
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert _cuda.launch_counts == _chain_launches(K - 1, fused_dw)
        else:
            assert _cuda.route_counts["lap_chain"] == 0
        out[d.type] = [t.detach().cpu() for t in (y, dx, dk)]
    for got, want, tol in zip(out["cuda"], out["cpu"], (TOL, TOL, DW_TOL)):
        _close(got, want, tol)


@pytest.mark.parametrize("fused_dw", [True, False])
def test_fault_shape_cface_conv_takes_the_chain(rng, dev, fused_dw):
    """The shape of ROADMAP fault 3.2 (k=20 at K=11, h=20, nside 32, batch
    16, 8 -> 16), which no one-shot K2 takes, runs in training on the lap
    chain instead of raising: counted once, 10 laps of K4 and K1, and
    their backward; y and the gradients of a fixed cotangent match the
    same conv on the CPU (the one-shot conv's plain versions)."""
    from deepsphere_tpu_torch.ops.stencil import stencil_graph_conv_cface

    config.set_fused_dw(fused_dw)
    n, K, B, Fin, Fout = 32, 11, 16, 8, 16
    st = _stencil(n, 0.75, 20, k=20)
    h = st.n_steps
    shallow = _stencil(n, 0.75, 2, k=20)
    tables_r = as_tensors(stencil_tables(shallow), dev)
    _, P_l = fs.cfp_geometry(n, h)
    x = torch.from_numpy(rng.normal(size=(B, Fin, 12, n, P_l)).astype(
        np.float32))
    x[..., :h] = 0.0
    x[..., h + n:] = 0.0
    kern = torch.from_numpy((rng.normal(size=(Fin * K, Fout))
                             / np.sqrt(Fin * K)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(B, Fout, 12, n, P_l)).astype(
        np.float32))
    out = {}
    for d in (dev, torch.device("cpu")):
        _cuda.reset_launch_counts()
        xd = x.to(d).requires_grad_()
        kd = kern.to(d).requires_grad_()
        y = stencil_graph_conv_cface(st, xd, kd, K, "cheby",
                                     chain=lambda: (shallow, tables_r))
        dx, dk = torch.autograd.grad(y, (xd, kd), cot.to(d))
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert _cuda.route_counts["chain_cface"] == 1
            assert _cuda.launch_counts == _chain_launches(K - 1, fused_dw)
        else:
            assert _cuda.route_counts["chain_cface"] == 0
        out[d.type] = [t.detach().cpu()[..., h:h + n] if t.ndim == 5
                       else t.detach().cpu() for t in (y, dx, dk)]
    for got, want, tol in zip(out["cuda"], out["cpu"], (TOL, TOL, DW_TOL)):
        _close(got, want, tol)


def test_model_forward_matches_cpu(rng, dev):
    """quick_start architecture at nside 16: the card's logits match the
    CPU plain path, and the one cface conv launched both kernels once per
    forward."""
    nside = 16
    npix = 12 * nside * nside
    model = dt.HealpyGCNN(nside, np.arange(npix), _small_quick_start()).build(
        (2, npix, 1), device="cpu")
    x = rng.normal(size=(4, npix, 1)).astype(np.float32)
    want = model.predict(x, batch_size=2)
    _cuda.reset_launch_counts()
    got = model.to(dev).predict(x, batch_size=2)
    assert _cuda.launch_counts == {"strips": 2, "stencil_conv": 2, "dxdw": 0,
                                   "grad": 0, "bands": 0}
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-4, err


@pytest.mark.parametrize("fused_dw", [True, False])
def test_train_step_matches_cpu(rng, dev, fused_dw):
    """One train_on_batch of the same quick_start-shaped model at nside 16
    built on the card and copied to the CPU: loss, every gradient and the
    BN statistics agree."""
    config.set_fused_dw(fused_dw)
    nside = 16
    npix = 12 * nside * nside
    model = dt.HealpyGCNN(nside, np.arange(npix), _small_quick_start()).build(
        (4, npix, 1), seed=2)
    cpu = copy.deepcopy(model).to("cpu")
    x = rng.normal(size=(4, npix, 1)).astype(np.float32)
    y = rng.randint(0, 4, size=4)
    logs = []
    for m in (model, cpu):
        m.compile(optimizer=1e-3,
                  loss="sparse_categorical_crossentropy_from_logits")
        _cuda.reset_launch_counts()
        logs.append(m._trainer.train_on_batch(x, y))
    assert abs(logs[0]["loss"] - logs[1]["loss"]) <= 1e-5 * abs(logs[1]["loss"])
    g, g_c = (export_jax_variables(m, grads=True) for m in (model, cpu))
    for key, sub in g_c.items():
        for name, want in sub.items():
            got = g[key][name]
            if isinstance(want, dict):
                for nm in want:
                    _close(torch.from_numpy(got[nm]), torch.from_numpy(want[nm]),
                           DW_TOL)
            else:
                _close(torch.from_numpy(got), torch.from_numpy(want), DW_TOL)
    s, s_c = (export_jax_variables(m)["batch_stats"] for m in (model, cpu))
    for key in s_c:
        for nm in ("mean", "var"):
            _close(torch.from_numpy(s[key]["bn"][nm]),
                   torch.from_numpy(s_c[key]["bn"][nm]), 1e-5)


def _smoothing_op(nside, mult, apps=1):
    from deepsphere_tpu_torch.nn.smoothing import SmoothingOperator, _with_apps
    from deepsphere_tpu_torch.sphere import healpix as hp

    sigma = np.degrees(hp.nside2resol(nside)) * 60 * mult
    op = SmoothingOperator(nside=nside, indices=np.arange(12 * nside * nside),
                           sigma=sigma, method="stencil")
    return op if apps == 1 else _with_apps(op, apps)


@pytest.mark.parametrize("nside,mult,C,apps", [(32, 3.0, 2, 1),
                                               (32, 3.0, 1, 2),
                                               (64, 2.0, 3, 1)])
def test_smoothing_chain_on_the_kernels_matches_plain(rng, dev, nside, mult,
                                                      C, apps):
    """The smoothing chain of a CUDA input on the kernels (K4, then K1,
    once a pass; no K2 or K3) against the plain per-step chain on the same
    CUDA input; its backward launches nothing and equals the plain chain's
    VJP (S^T)."""
    from deepsphere_tpu_torch.ops.smoothing import smooth_chain, smooth_chain_plain

    op = _smoothing_op(nside, mult, apps)
    st = op.stencil
    assert st.radius == 4 and op.stencil_reps > apps
    tables = as_tensors(stencil_tables(st), dev)
    npix = 12 * nside * nside
    xf = torch.from_numpy(rng.normal(size=(2, npix, C)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(2, npix, C)).astype(np.float32)).to(dev)
    rem = np.arange(C) + op.stencil_reps  # per-channel powers
    passes = -(-int(rem.max()) // apps)
    x1 = xf.clone().requires_grad_()
    _cuda.reset_launch_counts()
    y = smooth_chain(st, tables, x1, rem, apps)
    torch.cuda.synchronize()
    assert _cuda.launch_counts == {"strips": passes, "stencil_conv": passes,
                                   "dxdw": 0, "grad": 0, "bands": 0}
    assert _cuda.route_counts["smooth_fused"] == 1
    (g,) = torch.autograd.grad((y * w).sum(), x1)
    torch.cuda.synchronize()
    assert _cuda.launch_counts == {"strips": passes, "stencil_conv": passes,
                                   "dxdw": 0, "grad": 0, "bands": 0}
    x2 = xf.clone().requires_grad_()
    y_p = smooth_chain_plain(st, tables, x2, rem, apps)
    (g_p,) = torch.autograd.grad((y_p * w).sum(), x2)
    _close(y.detach(), y_p.detach())
    _close(g, g_p)


def test_smoothing_layer_on_the_card_matches_cpu(rng, dev):
    """A masked, per-channel smoothing layer (stencil and ELLPACK) built on
    the CPU, moved to the card: output and input gradient against the
    CPU."""
    from deepsphere_tpu_torch.nn.smoothing import HealpySmoothing, SmoothingOperator
    from deepsphere_tpu_torch.sphere import healpix as hp

    nside = 32
    vec = np.asarray(hp.pix2vec(nside, np.arange(12 * nside * nside),
                                nest=True))
    ind = np.where(vec[:, 2] > 0.2)[0]
    res = np.degrees(hp.nside2resol(nside)) * 60
    x = torch.from_numpy(rng.normal(size=(2, len(ind), 3)).astype(np.float32))
    for method, sigma in (("stencil", [res * 2, res * 2.5, res * 3]),
                          ("ellpack", [res, res * 1.3, res * 1.5])):
        op = SmoothingOperator(nside=nside, indices=ind, sigma=sigma,
                               method=method)
        out = {}
        for d in (torch.device("cpu"), dev):
            xd = x.to(d).requires_grad_()
            y = HealpySmoothing(op)(xd)
            (g,) = torch.autograd.grad(torch.sin(y).sum(), xd)
            out[d.type] = (y.detach().cpu(), g.cpu())
        for got, want in zip(out["cuda"], out["cpu"]):
            _close(got, want, 1e-5)


def test_smoothing_raises_before_launch_where_k1_has_no_plan(dev):
    """One application a pass at radius 4, nside 8, one map: K1 takes
    65,535 x 32 channels (its grid's z extent is 65,535 blocks of 32
    output channels) and not one more, so a CUDA input of 2,097,121
    channels raises before any launch."""
    from deepsphere_tpu_torch.nn.smoothing import HealpySmoothing

    op = _smoothing_op(8, 3.0)
    st = op.stencil
    assert (st.radius, st.n_steps, op.stencil_apps) == (4, 4, 1)
    C = 65535 * 32 + 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for c, ok in ((C - 1, True), (C, False)):
        plan = fs._k1_plan(8, 4, 4, len(st.offsets), 2, 1, 12, c, c, sms)
        assert (plan is not None) == ok, (c, plan)
    x = torch.zeros((1, 12 * 8 * 8, C), device=dev)
    _cuda.reset_launch_counts()
    with pytest.raises(ValueError, match="no K1 plan"):
        HealpySmoothing(op)(x)
    assert not any(_cuda.launch_counts.values())


def test_attention_model_on_the_card_matches_cpu(rng, dev):
    """A model with both attention layers (a ViT over 16-pixel patches and
    the edge-sparse transformer) built on the card, every parameter there:
    logits and one train step's loss and gradients against a CPU copy."""
    nside = 16
    npix = 12 * nside * nside
    model = dt.HealpyGCNN(nside, np.arange(npix), [
        hp_nn.HealpyChebyshev(K=3, Fout=4),
        hp_nn.Healpy_ViT(p=2, key_dim=4, num_heads=2, n_layers=2),
        hp_nn.HealpyPseudoConv_Transpose(p=2, Fout=4),
        hp_nn.Healpy_Transformer(key_dim=4, num_heads=2),
        hp_nn.Flatten(), hp_nn.Dense(3)]).build((2, npix, 1), seed=3,
                                                device=dev)
    assert all(p.device.type == "cuda" for p in model.parameters())
    cpu = copy.deepcopy(model).to("cpu")
    x = rng.normal(size=(2, npix, 1)).astype(np.float32)
    y = rng.randint(0, 3, size=2)
    _close(torch.from_numpy(model.predict(x)),
           torch.from_numpy(cpu.predict(x)), 1e-4)
    logs = []
    for m in (model, cpu):
        m.compile(optimizer=1e-3,
                  loss="sparse_categorical_crossentropy_from_logits")
        logs.append(m._trainer.train_on_batch(x, y))
    assert abs(logs[0]["loss"] - logs[1]["loss"]) <= 1e-5 * abs(logs[1]["loss"])
    g, g_c = (export_jax_variables(m, grads=True) for m in (model, cpu))
    scale = max(float(np.abs(v).max()) for sub in g_c.values()
                for v in _leaf_arrays(sub))
    for got, want in zip(_leaf_arrays(g), _leaf_arrays(g_c)):
        assert np.abs(got - want).max() <= 1e-4 * scale


def _leaf_arrays(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaf_arrays(tree[k])
        else:
            yield np.asarray(tree[k])
