"""The fused K-term polynomial stencil conv: CUDA kernel and plain version.

Counterpart of the JAX package's ``deepsphere_tpu.ops.pallas_stencil``
(TPU kernel ``_stencil_kernel``, launched by ``_run_stencil_kernel``).  The
per-step path (:func:`.stencil.stencil_graph_conv`) writes every Laplacian
application to device memory; the fused conv instead assembles each
tile's halo window on chip, runs all K-1 applications there and folds the
``[K*Fin, Fout]`` contraction in term by term, so the activation is read
about once per conv.

Layout ("cface"): activations are ``(C, 12, n, P_l)`` channels-first face
images, C = B*Fin batch-major, face column y at lane ``y + h`` (h the halo
depth, ``P_l = roundup(n + 2h, 128)``); input and output share it.  Cross-
face halos come from three strip arrays (:mod:`.strips`).

The rectangular face extension is incomplete at the 8 polar 3-way corners,
so under multi-step fusion a set of rows near them (``st.corr_out_face``)
comes out wrong; they are recomputed exactly from a precomputed ELLPACK
"ball" around them (:func:`_corrected_rows`) with one flat gather and one
flat scatter (``tables["corr_src_cfp"]`` / ``["corr_rows_cfp"]``).  At the
quick_start widths this is a large share of the map (K=10 at nside 16:
every row), so tests always check the raw conv as well.

No backward yet: on a CUDA tensor with autograd recording, the conv
raises (ROADMAP.md, queue 1: backward kernels K2 and K3).
"""

from __future__ import annotations

import torch

from ..graph.stencil import FaceStencil
from . import _cuda
from .strips import build_strips, strip_arrays

__all__ = [
    "cfp_geometry",
    "cfp_structural_available",
    "run_stencil_kernel",
    "run_stencil_plain",
    "fused_stencil_conv_cfp",
    "fused_stencil_conv_cfp_plain",
]

# the kernel's largest tile side and its dynamic shared-memory ceiling (an
# H100 block gets 227 KB; the kernel's static arrays take the rest)
_TILE = 32
_SMEM_MAX = 232448 - 1024


def _conv_smem(T, h, r, nplanes):
    """Bytes of dynamic shared memory of one block of the conv kernel:
    the weight window plus three term buffers."""
    W0 = T + 2 * h
    return 4 * (nplanes * (W0 - 2 * r) ** 2 + 3 * W0 * W0)


def _conv_tile(n, h, r, nplanes):
    """The largest tile side (32, 16 or 8, dividing n) whose window fits in
    shared memory, or None."""
    for T in (_TILE, 16, 8):
        if n % T == 0 and _conv_smem(T, h, r, nplanes) <= _SMEM_MAX:
            return T
    return None


def _round_up(x, m):
    return -(-x // m) * m


def cfp_structural_available(st: FaceStencil, kind, n_terms):
    """Whether this configuration fits the fused conv and the cface layout
    (platform-independent, so the model assembler plans with it)."""
    if st is None:  # graph not stencil-representable / halo too deep
        return False
    if kind not in ("cheby", "mono"):
        return False
    if n_terms < 2:
        return False
    h = st.n_steps
    if h < getattr(st, "radius", 1) * (n_terms - 1):
        return False
    # the strips' R = roundup(h, 8) rows must fit the face, and both lane
    # strips pack into one 128-lane array (west at [0,h), east at [h,2h))
    if st.nside % 8 or st.nside < _round_up(h, 8) or 2 * h > 128:
        return False
    return True


def cfp_geometry(n, h):
    """(R, P_l) of the cface layout: R = roundup(h, 8) rows of the row-halo
    strips, P_l = roundup(n + 2h, 128) lanes (face col y at lane y + h)."""
    return _round_up(h, 8), _round_up(n + 2 * h, 128)


def _window(st, xc, wext, strips):
    """The halo-extended maps of the plain version: activation (C, 12,
    n+2R, P_l) and weight planes (T2, 12, n+2R, P_l), window row w holding
    face row w - R."""
    n, h = st.nside, st.n_steps
    R, _ = cfp_geometry(n, h)
    top, bot, ls = strips
    mid = xc.clone()
    mid[..., 0:h] = ls[..., 0:h]
    mid[..., h + n : 2 * h + n] = ls[..., h : 2 * h]
    win = torch.cat([top, mid, bot], dim=2)
    ww = torch.cat([wext[:, :, n : n + R], wext[:, :, 0:n],
                    wext[:, :, n + R : n + 2 * R]], dim=2)
    return win, ww.to(xc.dtype)


def run_stencil_plain(st, kind, n_terms, xc, wext, strips, wk3, B):
    """Plain version of the raw fused conv (no corner correction).

    Same contract as :func:`run_stencil_kernel`: the padded-window
    recursion with ``torch.roll`` taps over each face's halo-extended map.
    Roll wrap-around only reaches the window border, r rows/lanes per
    step, never the interior lanes that are written out.
    """
    if kind not in ("cheby", "mono"):
        raise ValueError(f"unknown basis kind: {kind}")
    n, h = st.nside, st.n_steps
    R, P_l = cfp_geometry(n, h)
    K, Fin, Fout = wk3.shape
    win, ww = _window(st, xc, wext, strips)
    offs = st.offsets

    def lap(p):
        t = None
        for d, (dx, dy) in enumerate(offs):
            c = ww[d] * torch.roll(p, shifts=(-dx, -dy), dims=(2, 3))
            t = c if t is None else t + c
        return t

    y = xc.new_zeros((B, Fout, 12, n, P_l))
    prev2, prev1 = None, win
    for k in range(K):
        if k == 0:
            t = win
        elif k == 1 or kind == "mono":
            t = lap(prev1)
        else:
            t = 2.0 * lap(prev1) - prev2
        if k:
            prev2, prev1 = prev1, t
        ctr = t[:, :, R : R + n].reshape(B, Fin, 12, n, P_l)
        y = y + torch.einsum("bfgxp,fo->bogxp", ctr, wk3[k])
    y[..., :h] = 0.0
    y[..., h + n :] = 0.0
    return y.reshape(B * Fout, 12, n, P_l)


def _stencil_cuda(st, kind, xc, wext, strips, wk3, B, offsets):
    """Launch the fused conv kernel (``csrc/stencil_conv.cu``)."""
    n, h = st.nside, st.n_steps
    R, P_l = cfp_geometry(n, h)
    r = st.radius
    K, Fin, Fout = wk3.shape
    C = xc.shape[0]
    nplanes = len(st.offsets)
    top, bot, ls = strips
    dev = xc.device
    want = {
        "xc": (xc, (B * Fin, 12, n, P_l)),
        "top": (top, (C, 12, R, P_l)),
        "bot": (bot, (C, 12, R, P_l)),
        "ls": (ls, (C, 12, n, 128)),
        "wext": (wext, (nplanes, 12, n + 2 * R, P_l)),
        "wk3": (wk3, (K, Fin, Fout)),
    }
    for name, (t, shape) in want.items():
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"stencil kernel: {name} must be a contiguous "
                             f"float32 {shape} tensor on {dev}")
    if kind not in ("cheby", "mono"):
        raise ValueError(f"unknown basis kind: {kind}")
    T = _conv_tile(n, h, r, nplanes)
    if T is None or r * (K - 1) > h or nplanes > 81:
        raise ValueError(f"stencil kernel does not take n={n} h={h} r={r} "
                         f"K={K}: no tile fits shared memory")
    if B * -(-Fout // 8) > 65535:
        raise ValueError("stencil kernel: batch * Fout too large for the grid")
    if offsets is None:
        offsets = torch.tensor(st.offsets, dtype=torch.int32, device=dev)
    if (offsets.dtype != torch.int32 or offsets.device != dev
            or tuple(offsets.shape) != (nplanes, 2)):
        raise ValueError("stencil kernel: offsets must be int32 (nplanes, 2)")
    out = torch.empty((B * Fout, 12, n, P_l), dtype=xc.dtype, device=dev)
    lib = _cuda.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ds_stencil_conv(
            xc.data_ptr(), top.data_ptr(), bot.data_ptr(), ls.data_ptr(),
            wext.data_ptr(), wk3.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), 0 if kind == "cheby" else 1, K, r, nplanes, B,
            Fin, Fout, n, h, R, P_l, T, stream,
        )
    _cuda.check(rc, "ds_stencil_conv")
    _cuda.launch_counts["stencil_conv"] += 1
    return out


def run_stencil_kernel(st, kind, n_terms, xc, wext, strips, wk3, B,
                       offsets=None):
    """The raw fused conv (before the corner correction).

    :param xc: (B*Fin, 12, n, P_l) activations (interior lanes read)
    :param wext: (T2, 12, n+2R, P_l) wrapped-extended weight planes
        (``FaceStencil.weights``)
    :param strips: (top, bot, ls) halo strips of ``xc``
    :param wk3: (K, Fin, Fout) channel kernel per term
    :param offsets: (T2, 2) int32 tap offsets on the device
        (``tables["offsets"]``), else built here
    :return: (B*Fout, 12, n, P_l), 0 outside the interior lanes; exact at
        every interior row whose K-1-step neighbourhood lies in the
        rectangular face extension
    """
    if wk3.shape[0] != n_terms:
        raise ValueError(f"wk3 has {wk3.shape[0]} terms, expected {n_terms}")
    if xc.is_cuda:
        return _stencil_cuda(st, kind, xc, wext, strips, wk3, B, offsets)
    if xc.device.type != "cpu":
        raise ValueError(f"no stencil conv implementation for device {xc.device}")
    return run_stencil_plain(st, kind, n_terms, xc, wext, strips, wk3, B)


# ---------------------------------------------------------------------------
# corner correction: exact recompute of the rows the rectangular face
# extension cannot represent
# ---------------------------------------------------------------------------


def _ball_spmv(idx, val, t):
    W = idx.shape[1]
    y = val[:, 0:1] * t[idx[:, 0]]
    for w in range(1, W):
        y = y + val[:, w : w + 1] * t[idx[:, w]]
    return y


def _ball_terms(tables, xc, n_terms, kind):
    """Exact per-term basis values over the correction ball, (Bn, C) each;
    the ball's source rows are read with one flat gather."""
    idx = tables["corr_idx"]
    val = tables["corr_val"]
    C = xc.shape[0]
    t = xc.reshape(C, -1)[:, tables["corr_src_cfp"]].t().float()
    yield t
    prev2, prev1 = None, t
    for k in range(1, n_terms):
        tk = _ball_spmv(idx, val, prev1)
        if kind == "cheby" and k >= 2:
            tk = 2.0 * tk - prev2
        yield tk
        prev2, prev1 = prev1, tk


def _corrected_rows(tables, xc, wk3, n_terms, kind, B):
    """Exact conv outputs at the corrupt rows: (Rc, B*Fout)."""
    out_rows = tables["corr_out_ball"]
    K, Fin, Fout = wk3.shape
    acc = None
    for k, tk in enumerate(_ball_terms(tables, xc, n_terms, kind)):
        d = torch.einsum("rbf,fo->rbo", tk[out_rows].reshape(-1, B, Fin),
                         wk3[k]).reshape(-1, B * Fout)
        acc = d if acc is None else acc + d
    return acc


def _forward_cfp(st, tables, xc, kernel, n_terms, kind, B, strips_fn, conv_fn):
    C = xc.shape[0]
    Fin = C // B
    Fout = kernel.shape[-1]
    wk3 = kernel.float().reshape(Fin, n_terms, Fout).permute(1, 0, 2).contiguous()
    xc = xc.float().contiguous()
    strips = strips_fn(xc)
    y = conv_fn(st, kind, n_terms, xc, tables["weights"], strips, wk3, B)
    if "corr_rows_cfp" in tables:
        y_fix = _corrected_rows(tables, xc, wk3, n_terms, kind, B)
        y = y.reshape(B * Fout, -1)
        y[:, tables["corr_rows_cfp"]] = y_fix.t().to(y.dtype)
        y = y.reshape(B * Fout, 12, st.nside, -1)
    return y


def fused_stencil_conv_cfp(st: FaceStencil, tables, xc, kernel, n_terms,
                           kind, B):
    """Fused K-term polynomial graph conv in the cface layout.

    Strips (:func:`.strips.build_strips`), then the raw conv
    (:func:`run_stencil_kernel`), then the corner-row correction.  The
    device of ``xc`` decides: CUDA kernels for a CUDA tensor, their plain
    versions for a CPU tensor.

    :param st: FaceStencil with ``n_steps >= radius * (n_terms - 1)``
    :param tables: :func:`.stencil.as_tensors` of ``stencil_tables(st)`` on
        the device of ``xc``
    :param xc: (B*Fin, 12, n, P_l) activations, batch-major channels; only
        the interior (lanes [h, h+n)) is read
    :param kernel: (Fin*n_terms, Fout)
    :param B: batch size (the channel packing)
    :return: (B*Fout, 12, n, P_l) float32, 0 outside the interior lanes
    """
    if xc.is_cuda and torch.is_grad_enabled() and (
            xc.requires_grad or kernel.requires_grad):
        raise NotImplementedError(
            "the fused stencil conv has no CUDA backward yet (ROADMAP.md, "
            "queue 1: backward kernels K2 and K3); run the forward under "
            "torch.no_grad() or torch.inference_mode()"
        )
    offsets = tables.get("offsets")
    index = tables.get("strip_idx")
    return _forward_cfp(
        st, tables, xc, kernel, n_terms, kind, B,
        lambda x: build_strips(st, x, index),
        lambda *a: run_stencil_kernel(*a, offsets=offsets),
    )


def fused_stencil_conv_cfp_plain(st: FaceStencil, tables, xc, kernel,
                                 n_terms, kind, B):
    """:func:`fused_stencil_conv_cfp` through the plain versions of both
    kernels, on any device (the reference the kernels are held to)."""
    return _forward_cfp(
        st, tables, xc, kernel, n_terms, kind, B,
        lambda x: strip_arrays(st, x), run_stencil_plain,
    )
