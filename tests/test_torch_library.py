"""PyTorch port: the five kernels as ``torch.library`` custom ops
(``deepsphere_tpu_torch/ops/library.py``), on the CPU.

Each op is checked by ``torch.library.opcheck`` (its schema, its fake
implementation against its real one, autograd registration, and a trace
through AOT dispatch with dynamic shapes) at a radius-1 and a radius-2
stencil, K = 3-5, batch 2, and for the strips and bands at two face
counts; each op's CPU output must be its plain version's, bitwise (the CPU
implementation is that function); and an op called on the ``meta`` device
must give its fake implementation's shapes.  On the CPU every op runs its
plain version, so no kernel is launched.
"""

import numpy as np
import pytest
import torch

import deepsphere_tpu_torch.graph as tgraph
from deepsphere_tpu_torch.ops import _cuda
from deepsphere_tpu_torch.ops import fused_stencil as tfs
from deepsphere_tpu_torch.ops import strips as tstrips
from deepsphere_tpu_torch.ops.stencil import (
    as_tensors,
    pack_edge_bands,
    pack_edge_bands_plain,
    stencil_tables,
)

OPS = torch.ops.deepsphere

# (nside, graph degree k, K): a radius-1 stencil (k=8) and a radius-2 one
# (k=20), each at h = r (K - 1)
CASES = [(16, 8, 5), (8, 20, 3)]

_GRAPHS = {}


def _stencil(n, k, K):
    if (n, k) not in _GRAPHS:
        _GRAPHS[n, k] = tgraph.build_sphere_graph(n, k=k, method="grid")
    g = _GRAPHS[n, k]
    return g.face_stencil(0.75, n_steps=g.stencil_radius * (K - 1))


def _t(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _conv_args(rng, n, k, K, B=2, Fin=2, Fout=3):
    """A stencil and the K1-K3 operands of one conv: x, dy, their strips,
    the weight planes, the channel kernel and its transpose, the mask."""
    st = _stencil(n, k, K)
    h = st.n_steps
    _, P_l = tfs.cfp_geometry(n, h)
    tables = as_tensors(stencil_tables(st))
    x = _t(rng, B * Fin, 12, n, P_l)
    dy = _t(rng, B * Fout, 12, n, P_l)
    wk3 = _t(rng, K, Fin, Fout)
    return dict(st=st, B=B, x=x, dy=dy, w=tables["weights"], wk3=wk3,
                wk3t=wk3.permute(0, 2, 1).contiguous(),
                xs=tstrips.strip_arrays(st, x),
                dys=tstrips.strip_arrays(st, dy),
                mask=tables.get("corr_mask"), idx=tables["strip_idx"])


def _ints(a):
    st = a["st"]
    return st.nside, st.n_steps, st.radius


def _op_args(rng, name, n, k, K, faces=12):
    """(op, args, plain output) of one op at one shape, on the CPU."""
    a = _conv_args(rng, n, k, K)
    st, B = a["st"], a["B"]
    n_, h, r = _ints(a)
    if name == "strips" and faces == 12:
        return (OPS.strips, (a["x"], a["idx"], n_, h, list(range(12))),
                a["xs"])
    if name == "strips":
        bands = pack_edge_bands_plain(a["x"], n_, h).contiguous()
        sel = list(range(3, 3 + faces))
        m = tstrips._band_source_map(st, sel, bands.shape[1], "cpu")
        want = tstrips.strip_arrays(
            st, None, sel, tstrips.unpack_edge_bands(bands, n_, h))
        return OPS.strips, (bands, m, n_, h, sel), want
    if name == "stencil_conv":
        args = (a["x"], *a["xs"], a["w"], a["wk3"], n_, h, r, B, "cheby")
        return OPS.stencil_conv, args, tfs.run_stencil_plain(
            st, "cheby", K, a["x"], a["w"], a["xs"], a["wk3"], B)
    if name == "stencil_dxdw":
        args = (a["dy"], *a["dys"], a["w"], a["wk3t"], a["x"], a["mask"], n_,
                h, r, B, "mono")
        return OPS.stencil_dxdw, args, tfs.run_dxdw_plain(
            st, "mono", K, a["dy"], a["w"], a["dys"], a["wk3t"], a["x"],
            a["mask"], B)
    if name == "stencil_grad":
        args = (a["x"], *a["xs"], a["w"], a["dy"], n_, h, r, K, B, "cheby")
        return OPS.stencil_grad, args, tfs.run_grad_plain(
            st, "cheby", K, a["x"], a["w"], a["xs"], a["dy"], B)
    x = a["x"][:, :faces].contiguous()
    return OPS.bands, (x, n_, h), pack_edge_bands_plain(x, n_, h)


def _flat(out):
    """An op's output, or the plain strips' three arrays, as a tuple of
    flat tensors (the strips op returns one flat buffer)."""
    if isinstance(out, torch.Tensor):
        return (out.reshape(-1),)
    if len(out) == 3 and out[0].dim() == 4 and out[2].shape[-1] == 128:
        return (torch.cat([p.reshape(-1) for p in out]),)
    return tuple(o.reshape(-1) for o in out)


# every op at both stencils; strips and bands also on fewer faces
PARAMS = ([(nm, c, 12) for nm in ("strips", "stencil_conv", "stencil_dxdw",
                                  "stencil_grad", "bands") for c in CASES]
          + [("strips", CASES[0], 3), ("bands", CASES[1], 4)])
IDS = [f"{nm}-n{c[0]}k{c[1]}K{c[2]}-F{f}" for nm, c, f in PARAMS]


@pytest.fixture
def rng():
    return np.random.RandomState(17)


@pytest.mark.parametrize("name,case,faces", PARAMS, ids=IDS)
def test_opcheck(rng, name, case, faces):
    op, args, _ = _op_args(rng, name, *case, faces=faces)
    _cuda.reset_launch_counts()
    torch.library.opcheck(op, args)
    assert not any(_cuda.launch_counts.values())


@pytest.mark.parametrize("name,case,faces", PARAMS, ids=IDS)
def test_cpu_op_is_the_plain_version(rng, name, case, faces):
    op, args, want = _op_args(rng, name, *case, faces=faces)
    got = _flat(op(*args))
    want = _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("name,case,faces", PARAMS, ids=IDS)
def test_meta_call_gives_the_fake_shapes(rng, name, case, faces):
    op, args, want = _op_args(rng, name, *case, faces=faces)
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)
    got = op(*meta)
    got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
    want = _flat(want) if name == "strips" else (
        (want,) if isinstance(want, torch.Tensor) else tuple(want))
    assert all(g.device.type == "meta" for g in got)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]


def test_wrappers_call_the_ops(rng):
    """The wrappers give the ops' outputs (the strips as views of the one
    buffer), and keep their checks on the stencil and the device."""
    a = _conv_args(rng, 16, 8, 5)
    st, B = a["st"], a["B"]
    n, h, r = _ints(a)
    top, bot, ls = tstrips.build_strips(st, a["x"], a["idx"])
    assert top.data_ptr() < bot.data_ptr() < ls.data_ptr()
    for g, w in zip((top, bot, ls), a["xs"]):
        assert torch.equal(g, w)
    y = tfs.run_stencil_kernel(st, "cheby", 5, a["x"], a["w"], a["xs"],
                               a["wk3"], B)
    assert torch.equal(y, OPS.stencil_conv(a["x"], *a["xs"], a["w"], a["wk3"],
                                           n, h, r, B, "cheby"))
    assert torch.equal(pack_edge_bands(a["x"], n, h),
                       OPS.bands(a["x"], n, h))
    with pytest.raises(ValueError, match="device"):
        pack_edge_bands(a["x"].to("meta"), n, h)
    with pytest.raises(ValueError, match="basis kind"):
        tfs.run_grad_kernel(st, "bern", 5, a["x"], a["w"], a["xs"], a["dy"],
                            B)


def test_ops_have_no_implementation_for_other_devices():
    """Each op has a CUDA and a CPU implementation (and a fake one), no
    other: its kernel table names them."""
    for name in ("strips", "stencil_conv", "stencil_dxdw", "stencil_grad",
                 "bands"):
        op = getattr(OPS, name).default
        assert op.has_kernel_for_dispatch_key(torch._C.DispatchKey.CPU)
        assert op.has_kernel_for_dispatch_key(torch._C.DispatchKey.CUDA)
        assert not op.has_kernel_for_dispatch_key(torch._C.DispatchKey.XPU)
