"""PyTorch port, the fused conv's bfloat16 modes (``config.conv_dtype``
"bfloat16", the band mode, and "bfloat16_io") against the JAX package's.

The same numpy inputs go through the port's plain kernels (K1; K2's dx
and dW; K3), its ``fused_stencil_conv_cfp`` on both backward routes and a
small ``HealpyGCNN``, and through the JAX package's Pallas kernels in
interpret mode under the same mode.  The tolerance is the JAX package's
own for its bf16 modes: 3e-2 of max(|ref|, 1e-3) (``tests/test_pallas.py``).
Each bf16 result must also differ from the float32 one by more than 1e-4
of the reference's max: a mode that silently stayed float32 would pass
the first check.  Smoothing never reads the mode: its output under
"bfloat16_io" is the float32 output bit for bit.

At nside 16, K=5 (h=4: 768 of 3,072 rows corrected, so corner rows are
live), B=2, Fin=2, Fout=3; the I/O gate also at nside 8 and 32.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepsphere_tpu as ds
import deepsphere_tpu.config as jcfg
import deepsphere_tpu.graph as jgraph
import deepsphere_tpu.ops.pallas_stencil as jps
import deepsphere_tpu.ops.stencil as jstencil
import deepsphere_tpu_torch as dt
import deepsphere_tpu_torch.config as tcfg
import deepsphere_tpu_torch.graph as tgraph
from deepsphere_tpu.nn import healpy_layers as jhp
from deepsphere_tpu_torch.interop import load_jax_variables
from deepsphere_tpu_torch.nn import healpy_layers as thp
from deepsphere_tpu_torch.ops import _cuda
from deepsphere_tpu_torch.ops import fused_stencil as tfs
from deepsphere_tpu_torch.ops import strips as tstrips
from deepsphere_tpu_torch.ops.stencil import as_tensors, stencil_tables

MODES = ("bfloat16", "bfloat16_io")
N, K, B, FIN, FOUT = 16, 5, 2, 2, 3
H = K - 1


@contextlib.contextmanager
def conv_dtype(mode):
    """Both packages' ``conv_dtype`` set to ``mode`` inside the block."""
    assert jcfg.conv_dtype == "float32" and tcfg.conv_dtype == "float32"
    jcfg.set_conv_dtype(mode)
    tcfg.set_conv_dtype(mode)
    try:
        yield
    finally:
        jcfg.set_conv_dtype("float32")
        tcfg.set_conv_dtype("float32")


def _check(got, want, f32, what):
    """``got`` within 3e-2 of max(|want|, 1e-3) of ``want``, and farther
    than 1e-4 of max|want| from the float32 result ``f32``."""
    got, want, f32 = (np.asarray(a, dtype=np.float32) for a in (got, want, f32))
    assert got.shape == want.shape == f32.shape, what
    scale = max(np.abs(want).max(), 1e-3)
    err = np.abs(got - want).max()
    assert err <= 3e-2 * scale, (what, err / scale)
    moved = np.abs(got - f32).max()
    assert moved > 1e-4 * np.abs(want).max(), (what, moved)


@pytest.fixture(scope="module")
def case():
    """Graphs, stencils, tables and inputs shared by every test here."""
    rng = np.random.RandomState(5)
    gj = jgraph.build_sphere_graph(N, k=8, method="grid")
    gt = tgraph.build_sphere_graph(N, k=8, method="grid")
    sj = gj.face_stencil(0.75, n_steps=H)
    st = gt.face_stencil(0.75, n_steps=H)
    _, P_l = tfs.cfp_geometry(N, H)

    def xc(C):  # garbage in the halo lanes: no path may read them
        return rng.normal(size=(C, 12, N, P_l)).astype(np.float32)

    c = {"gj": gj, "gt": gt, "sj": sj, "st": st,
         "x": xc(B * FIN), "dy": xc(B * FOUT),
         "kern": (rng.normal(size=(FIN * K, FOUT)) / 3).astype(np.float32)}
    c["wk3"] = np.ascontiguousarray(
        c["kern"].reshape(FIN, K, FOUT).transpose(1, 0, 2))
    c["wk3t"] = np.ascontiguousarray(
        c["kern"].reshape(FIN, K, FOUT).transpose(1, 2, 0))
    c["jt"] = {k: jnp.asarray(v)
               for k, v in jstencil.stencil_tables(sj, bf16_io=True).items()}
    c["tt"] = as_tensors(stencil_tables(st, bf16_io=True))
    c["arrays"] = {}
    return c


def _arrays(c, mode):
    """The raw kernels' device arrays of ``mode`` for both packages: x and
    dy (bfloat16 in the I/O mode), the weight planes of that dtype and the
    strips of each; made once per mode."""
    if mode not in c["arrays"]:
        c["arrays"][mode] = _make_arrays(c, mode)
    return c["arrays"][mode]


def _make_arrays(c, mode):
    io = mode == "bfloat16_io"
    jdt = jnp.bfloat16 if io else jnp.float32
    tdt = torch.bfloat16 if io else torch.float32
    j = {"x": jnp.asarray(c["x"]).astype(jdt),
         "dy": jnp.asarray(c["dy"]).astype(jdt),
         "w": c["jt"]["weights_bf16"] if io else c["jt"]["weights"]}
    t = {"x": torch.from_numpy(c["x"]).to(tdt),
         "dy": torch.from_numpy(c["dy"]).to(tdt),
         "w": c["tt"]["weights_bf16"] if io else c["tt"]["weights"]}
    strips = jax.jit(lambda a: jps._strip_arrays(c["sj"], a))
    for k in ("x", "dy"):
        j[k + "_s"] = strips(j[k])
        t[k + "_s"] = tstrips.strip_arrays(c["st"], t[k])
    return j, t


def _raw(c, which, pkg, mode):
    """One raw kernel's outputs, interior lanes, as float32 numpy: the JAX
    Pallas kernel (interpret mode) under ``mode``, or the port's plain
    version in ``mode`` ("float32": the float32 reference)."""
    j, t = _arrays(c, "float32" if mode == "float32" else mode)
    bdt = "float32" if mode == "float32" else "bfloat16"
    inner = lambda a: (a.float().numpy() if isinstance(a, torch.Tensor)
                       else np.asarray(a, dtype=np.float32))[..., H:H + N]
    if pkg == "jax":
        sj, jt = c["sj"], c["jt"]
        if which == "k1":
            return [inner(jps._run_stencil_kernel(
                sj, "cheby", K, j["x"], j["w"], j["x_s"],
                jnp.asarray(c["wk3"]), B, interpret=True))]
        if which == "k2":
            mask = jps._dw_mask_graph(sj, j["dy"].dtype, jt)
            dx, dw = jps._run_dxdw_kernel(
                sj, "cheby", K, j["dy"], j["w"], j["dy_s"],
                jnp.asarray(c["wk3t"]), j["x"], mask, B, interpret=True)
            return [inner(dx), np.asarray(dw)]
        return [np.asarray(jps._run_grad_kernel(
            sj, "cheby", K, j["x"], j["w"], j["x_s"], j["dy"], B, FIN,
            interpret=True))]
    st = c["st"]
    if which == "k1":
        return [inner(tfs.run_stencil_kernel(
            st, "cheby", K, t["x"], t["w"], t["x_s"],
            torch.from_numpy(c["wk3"]), B, bdt))]
    if which == "k2":
        dx, dw = tfs.run_dxdw_kernel(
            st, "cheby", K, t["dy"], t["w"], t["dy_s"],
            torch.from_numpy(c["wk3t"]), t["x"], c["tt"]["corr_mask"], B, bdt)
        return [inner(dx), dw.numpy()]
    return [tfs.run_grad_kernel(st, "cheby", K, t["x"], t["w"], t["x_s"],
                                t["dy"], B, bdt).numpy()]


def test_conv_dtype_config_matches_jax():
    assert tcfg.conv_dtype == jcfg.conv_dtype == "float32"
    for mode, band, io in (("float32", torch.float32, torch.float32),
                           ("bfloat16", torch.bfloat16, torch.float32),
                           ("bfloat16_io", torch.bfloat16, torch.bfloat16)):
        with (conv_dtype(mode) if mode != "float32"
              else contextlib.nullcontext()):
            assert tcfg.conv_dtype == jcfg.conv_dtype == mode
            assert tcfg.band_dtype() == band
            assert tcfg.conv_io_dtype() == io
            assert jnp.dtype(jcfg.band_dtype()).name == str(band)[6:]
            assert jnp.dtype(jcfg.conv_io_dtype()).name == str(io)[6:]
    with pytest.raises(ValueError) as te:
        tcfg.set_conv_dtype("float16")
    with pytest.raises(ValueError) as je:
        jcfg.set_conv_dtype("float16")
    assert str(te.value) == str(je.value)
    assert tcfg.conv_dtype == "float32"


@pytest.mark.parametrize("n", [8, 16, 32])
def test_io_gate_and_bf16_planes_match_jax(n):
    """``cfp_io_available`` as JAX's at K = 3 and 5; ``weights_bf16`` bit
    for bit (int16 views) where JAX builds it, absent where it does not."""
    gj = jgraph.build_sphere_graph(n, k=8, method="grid")
    gt = tgraph.build_sphere_graph(n, k=8, method="grid")
    for k_terms in (3, 5):
        sj = gj.face_stencil(0.75, n_steps=k_terms - 1)
        st = gt.face_stencil(0.75, n_steps=k_terms - 1)
        gate = jps.cfp_io_available(sj)
        assert tfs.cfp_io_available(st) == gate
        want = jstencil.stencil_tables(sj, bf16_io=True).get("weights_bf16")
        got = stencil_tables(st, bf16_io=True).get("weights_bf16")
        assert (want is not None) == gate == (got is not None)
        if gate:
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          np.asarray(want).view(np.int16))
            # the repack of a table without them gives the same bits
            f32 = as_tensors(stencil_tables(st))
            assert torch.equal(tfs._io_weights(st, f32, torch.bfloat16)
                               .view(torch.int16), got.view(torch.int16))
            assert as_tensors({"w": got})["w"].dtype == torch.bfloat16
        assert "weights_bf16" not in stencil_tables(st)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("which", ["k1", "k2", "k3"])
def test_raw_kernels_match_jax(case, which, mode):
    """The plain K1, K2 (dx, dW) and K3 in each bf16 mode against the JAX
    Pallas kernels in interpret mode under the same mode (the R16 strips
    of JAX's bf16 layout equal to the port's in the I/O mode)."""
    if mode == "bfloat16_io":
        j, t = _arrays(case, mode)
        for a, b in zip(t["x_s"], j["x_s"]):
            assert a.shape[2] == 16
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          np.asarray(b).view(np.int16))
    with conv_dtype(mode):
        want = _raw(case, which, "jax", mode)
        got = _raw(case, which, "torch", mode)
    f32 = _raw(case, which, "torch", "float32")
    for nm, g, w, f in zip(("out", "dW"), got, want, f32):
        _check(g, w, f, f"{which} {mode} {nm}")
    assert all(v == 0 for v in _cuda.bf16_launch_counts.values())


_JAX_CONV = {}


def _jax_conv(c, mode):
    """JAX's fused_stencil_conv_cfp (interpret mode) under ``mode``: y and
    the VJP (dx, dW) of a fixed cotangent, cached per mode (jitted: half
    the time of its eager interpretation)."""
    if mode not in _JAX_CONV:

        def conv_vjp(x, kern, cot):
            y, vjp = jax.vjp(lambda a, k: jps.fused_stencil_conv_cfp(
                c["sj"], c["jt"], a, k, K, "cheby", B, interpret=True),
                x, kern)
            return (y,) + vjp(cot.astype(y.dtype))

        with conv_dtype(mode):
            out = jax.jit(conv_vjp)(jnp.asarray(c["x"]),
                                    jnp.asarray(c["kern"]),
                                    jnp.asarray(c["dy"]))
        _JAX_CONV[mode] = [np.asarray(a, dtype=np.float32) for a in out]
    return _JAX_CONV[mode]


def _port_conv(c, mode, fused_dw):
    tcfg.set_fused_dw(fused_dw)
    try:
        x = torch.from_numpy(c["x"]).requires_grad_()
        k = torch.from_numpy(c["kern"]).requires_grad_()
        y = tfs.fused_stencil_conv_cfp(c["st"], c["tt"], x, k, K, "cheby", B)
        dx, dk = torch.autograd.grad(
            y, (x, k), torch.from_numpy(c["dy"]).to(y.dtype))
    finally:
        tcfg.set_fused_dw(True)
    return y, dx, dk


@pytest.mark.parametrize("fused_dw", [True, False], ids=["K2", "K1+K3"])
@pytest.mark.parametrize("mode", MODES)
def test_fused_conv_matches_jax(case, mode, fused_dw):
    """y, dx and dW of the corrected conv in each mode, on both backward
    routes, against JAX's ``fused_stencil_conv_cfp`` (which takes its
    two-kernel backward under bf16): the port keeps its ``fused_dw``
    routing in bf16 too."""
    want = _jax_conv(case, mode)
    with conv_dtype(mode):
        y, dx, dk = _port_conv(case, mode, fused_dw)
    assert y.dtype == (torch.bfloat16 if mode == "bfloat16_io"
                       else torch.float32)
    assert dx.dtype == torch.float32 and dk.dtype == torch.float32
    f32 = [a.detach().float().numpy()
           for a in _port_conv(case, "float32", fused_dw)]
    inner = lambda a: a.reshape(B, -1, 12, N, a.shape[-1])[..., H:H + N]
    for nm, g, w, f in zip(("y", "dx", "dW"),
                           (y.detach().float().numpy(), dx.numpy(),
                            dk.numpy()), want, f32):
        if nm != "dW":
            g, w, f = inner(g), inner(w), inner(f)
        _check(g, w, f, f"{mode} fused_dw={fused_dw} {nm}")


def test_smoothing_ignores_the_mode():
    """HealpySmoothing's output under "bfloat16_io" is its float32 output
    bit for bit (the JAX package's smoothing never reads conv_dtype)."""
    nside = 16
    npix = 12 * nside * nside
    x = np.random.RandomState(2).normal(size=(2, npix, 2)).astype(np.float32)
    outs = []
    for mode in ("float32", "bfloat16_io"):
        with (conv_dtype(mode) if mode != "float32"
              else contextlib.nullcontext()):
            res = np.degrees(np.sqrt(4 * np.pi / npix)) * 60  # arcmin
            layer = thp.HealpySmoothing(nside=nside, indices=np.arange(npix),
                                        sigma=2.0 * res, method="stencil")
            outs.append(layer(torch.from_numpy(x)))
    assert torch.equal(outs[0], outs[1])


def _model_layers(m):
    return [m.HealpyChebyshev(K=5, Fout=4, activation="relu"),
            m.HealpyPool(p=1),
            m.HealpyChebyshev(K=5, Fout=3),
            m.Flatten(), m.Dense(2)]


_MODEL = {}


def _model_run(mode):
    """Logits and kernel gradients of sum(logits^2) of the port's model
    (built under ``mode``, the variables of a JAX model copied in), and
    the JAX model's in float32 (its per-step path: the interpret-mode JAX
    model takes about 40 s a run here), cached."""
    nside = 16
    npix = 12 * nside * nside
    x = np.random.RandomState(9).normal(size=(2, npix, 1)).astype(np.float32)
    if "jax" not in _MODEL:
        jm = ds.HealpyGCNN(nside, np.arange(npix), _model_layers(jhp))
        # jitted: ``jm.init(0, x)``'s variables, a few times faster here
        v = jax.jit(jm.module.init)(jax.random.key(0), jnp.asarray(x))
        loss = lambda p: jnp.sum(
            jm.apply({**v, "params": p}, jnp.asarray(x)) ** 2)
        lj, gj = jax.jit(jax.value_and_grad(loss))(v["params"])
        params = jax.tree_util.tree_map(np.asarray, v["params"])
        _MODEL["jax"] = (params, float(lj),
                         jax.tree_util.tree_map(np.asarray, gj))
    params = _MODEL["jax"][0]
    with (conv_dtype(mode) if mode != "float32"
          else contextlib.nullcontext()):
        tm = dt.HealpyGCNN(nside, np.arange(npix), _model_layers(thp))
        tm.build(x.shape, device="cpu")
        load_jax_variables(tm, {"params": params})
        tm.eval()
        lt = (tm(torch.from_numpy(x)) ** 2).sum()
        lt.backward()
        has16 = any(n.endswith("tab_weights_bf16")
                    for n, _ in tm.named_buffers())
    return (float(lt.detach()),
            {n: p.grad.numpy() for n, p in tm.named_parameters()}, has16)


@pytest.mark.parametrize("mode", MODES)
def test_model_matches_jax(mode):
    """Two Chebyshev K=5 convs with a pool at nside 16 (conv 1 in the mode;
    conv 2 at nside 8, where the I/O mode falls back to the band mode):
    the loss sum(logits^2) and each conv's kernel gradient against the JAX
    model (float32: its interpret-mode model costs more than this file's
    time budget), each also moved from the port's float32 model."""
    if "float32" not in _MODEL:
        _MODEL["float32"] = _model_run("float32")
    lt, gt, has16 = _model_run(mode)
    l32, g32, _ = _MODEL["float32"]
    _, lj, gj = _MODEL["jax"]
    assert has16 == (mode == "bfloat16_io")
    _check([lt], [lj], [l32], f"{mode} loss")
    for i in (0, 2):
        name = f"layers.layer_{i}.kernel"
        _check(gt[name], gj[f"layers_layer_{i}"]["kernel"], g32[name],
               f"{mode} conv {i} dW")
