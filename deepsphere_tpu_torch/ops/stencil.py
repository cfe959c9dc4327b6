"""Gather-free graph convolution: the stencil on the 12-face HEALPix layout.

PyTorch counterpart of the JAX package's ``deepsphere_tpu.ops.stencil``
(without its Pallas parts).  With the Laplacian in stencil form
(:func:`~deepsphere_tpu_torch.graph.stencil.face_stencil`) each Laplacian
application is (2r+1)^2 shifted multiply-adds on dense face images, the
face-border halo is refilled between applications from precomputed strip
maps, and the [K*Fin, Fout] contraction is folded into the recursion one
term at a time.

Two conv forms live here:

* :func:`stencil_graph_conv` — the conv on (B, M, F) activations in NEST
  or face-flat order.  The per-step path: one halo refill and one stencil
  application per term, plain torch ops.  A CUDA input of a deep-radius
  graph (radius >= 3, K > 2) on its shallow stencil takes the lap chain
  instead (:func:`conv_route`, :func:`lap_chain_conv`): one fused launch
  (K4 strips, K1) per L~ application, the recursion and the channel
  contraction between the launches, as the JAX package does on a TPU.
* :func:`stencil_graph_conv_cface` — the conv on the channels-first padded
  "cface" layout (B, F, 12, n, P_l), face col y at lane y + h.  It calls
  :func:`.fused_stencil.fused_stencil_conv_cfp` (the device of the tensor
  decides between the CUDA kernels and their plain versions), except for a
  CUDA input of a shape the one-shot kernels refuse
  (:func:`.fused_stencil.cface_route`): where the JAX package runs no
  kernel either, the per-step path on the interior lanes, padded again;
  at radius <= 2, the lap chain on the shallow stencil.

The face-sharded conv (``parallel/cface_sharded.py``) exchanges only the
four h-deep edge bands of each face: :func:`pack_edge_bands` cuts them (the
CUDA kernel ``csrc/bands.cu``, K5), packed face-major for one all-gather,
and :func:`edge_strips` builds any faces' halo strips from the gathered
bands.

The static graph arrays travel as a ``tables`` dict (:func:`stencil_tables`
on the host, :func:`as_tensors` for a device); the model layers keep them
as non-persistent buffers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.stencil import FaceStencil
from . import _cuda

__all__ = [
    "stencil_tables",
    "as_tensors",
    "pad_faces",
    "edge_strips",
    "extract_edge_bands",
    "pack_edge_bands",
    "pack_edge_bands_plain",
    "unpack_edge_bands",
    "stencil_matvec",
    "stencil_graph_conv",
    "stencil_graph_conv_cface",
    "conv_route",
    "check_lap_chain",
    "lap_chain_available",
    "lap_chain_conv",
    "cface_embed",
    "cface_extract",
]

# int32 tables that CUDA kernels read as they are; every other integer
# table becomes int64 for torch indexing
_INT32_TABLES = ("strip_idx", "strip_idx_bf16", "offsets")


def _src_block(bands, n, h, ax, ay):
    """Slice the (ax, ay) source rectangle of face ``nbf`` out of the edge
    bands.  A halo-region rectangle always has at least one thin (h-wide)
    axis pinned to a face edge, so it lives inside one of the four bands."""
    fr, lr, fc, lc = bands  # (C,12,h,n) first/last rows, (C,12,n,h) cols
    (a0, a1), (b0, b1) = ax, ay
    if a1 - a0 == h and (a0 == 0 or a0 == n - h):
        band = fr if a0 == 0 else lr
        return band if (b1 - b0) == n else band[..., b0:b1]
    band = fc if b0 == 0 else lc
    return band if (a1 - a0) == n else band[:, :, a0:a1, :]


def _edge_block(bands, n, h, f, xs, ys):
    """Halo block for region (xs, ys) of face ``f`` as a structured copy.

    Returns (C, lx, ly) with lx = h if xs else n (same for y), raster-
    ordered by the region's local (xw, yw): slices, flips and one transpose
    of an h-thin band, per :func:`..sphere.faces.edge_descriptor`.
    """
    from ..sphere.faces import edge_descriptor

    d = edge_descriptor(f, xs, ys)
    lx = h if xs else n
    ly = h if ys else n
    if d is None:  # polar 3-way corner: no pixels
        return bands[0].new_zeros((bands[0].shape[0], lx, ly))
    nbf, fx, fy, swap = d
    xw0 = n - h if xs < 0 else 0
    yw0 = n - h if ys < 0 else 0

    def rng(w0, l, flip):
        return (n - w0 - l, n - w0) if flip else (w0, w0 + l)

    ax = rng(xw0, lx, fx)
    ay = rng(yw0, ly, fy)
    if swap:
        blk = _src_block(bands, n, h, ay, ax)[:, nbf].transpose(1, 2)
    else:
        blk = _src_block(bands, n, h, ax, ay)[:, nbf]
    if fx:
        blk = torch.flip(blk, dims=(1,))
    if fy:
        blk = torch.flip(blk, dims=(2,))
    return blk


def _extract_bands(x3, n, h, lane_off=0):
    """The four face-edge bands of the map, cut to depth h in face coords:
    first/last h rows (C, 12, h, n) and first/last h columns (C, 12, n, h).
    x3: (C, 12, n, W) with face col y at lane ``y + lane_off``."""
    lo = lane_off
    return (
        x3[:, :, :h, lo : lo + n],
        x3[:, :, n - h : n, lo : lo + n],
        x3[:, :, :, lo : lo + h],
        x3[:, :, :, lo + n - h : lo + n],
    )


def edge_strips(n, h, x3, embedded=False, faces=None, bands=None):
    """The four halo strips of every face, as structured edge copies.

    x3: (C, 12, n, n) channels-first faces — or, with ``embedded=True``,
    (C, 12, n, P_l) in the cface layout (face col y at lane y + h).
    Returns ``(west, east, south, north)`` with west/east (C, F, h, n+2h)
    spanning the full padded width (corners included) and south/north
    (C, F, n, h) covering interior rows — the coverage of the gather
    tables built in :mod:`..graph.stencil`.

    For the face-sharded conv, pass ``faces`` (the local face ids, F of
    them) and ``bands`` (the all-gathered full-sphere edge bands, as
    :func:`extract_edge_bands` returns them): strips are built for those
    faces only, with neighbour data read from the bands (``x3`` is not
    read).
    """
    if bands is None:
        bands = _extract_bands(x3, n, h, lane_off=h if embedded else 0)
    if faces is None:
        faces = range(12)

    def row_strip(xs):
        return torch.stack(
            [
                torch.cat(
                    [
                        _edge_block(bands, n, h, f, xs, -1),
                        _edge_block(bands, n, h, f, xs, 0),
                        _edge_block(bands, n, h, f, xs, 1),
                    ],
                    dim=2,
                )
                for f in faces
            ],
            dim=1,
        )

    def col_strip(ys):
        return torch.stack(
            [_edge_block(bands, n, h, f, 0, ys) for f in faces], dim=1
        )

    return row_strip(-1), row_strip(1), col_strip(-1), col_strip(1)


def extract_edge_bands(x3, n, h, embedded=False):
    """The four face-edge bands of ``x3`` (C, F, n, W), cut to depth h:
    first/last h rows (C, F, h, n) and first/last h columns (C, F, n, h),
    face col y at lane ``y + h`` with ``embedded=True`` (else lane y)."""
    return _extract_bands(x3, n, h, lane_off=h if embedded else 0)


def pack_edge_bands_plain(xc, n, h):
    """Plain version of :func:`pack_edge_bands`: the four bands of
    :func:`extract_edge_bands` (embedded) packed face-major, (F, C, 4*h*n)."""
    C, F = xc.shape[0], xc.shape[1]
    return torch.cat([b.transpose(0, 1).reshape(F, C, -1)
                      for b in extract_edge_bands(xc, n, h, embedded=True)],
                     dim=2)


def unpack_edge_bands(packed, n, h):
    """(F, C, 4*h*n) packed bands -> the four bands of
    :func:`extract_edge_bands`: (C, F, h, n) twice, (C, F, n, h) twice."""
    F, C = packed.shape[0], packed.shape[1]
    parts = packed.split(h * n, dim=2)
    shapes = ((h, n), (h, n), (n, h), (n, h))
    return tuple(p.reshape((F, C) + s).transpose(0, 1)
                 for p, s in zip(parts, shapes))


def pack_edge_bands(xc, n, h):
    """The four h-deep edge bands of every face of ``xc`` (C, F, n, P_l),
    cface layout (face col y at lane y + h), packed face-major into one
    (F, C, 4*h*n) buffer: per (face, channel) the first rows, last rows,
    first columns and last columns, each raster-ordered.  Through the
    ``bands`` op: the CUDA kernel (K5) for a CUDA tensor,
    :func:`pack_edge_bands_plain` for a CPU one."""
    from .library import check_device

    check_device("band", xc)
    return torch.ops.deepsphere.bands(xc, n, h)


def stencil_tables(st: FaceStencil, bf16_io=False):
    """The arrays of a stencil that the convs read, as a dict of host numpy
    arrays (see :func:`as_tensors` for a device).

    Beyond the stencil's weight planes, halo-strip maps, correction ball and
    fix rows it holds, for the fused conv:
    ``corr_src_cfp`` / ``corr_rows_cfp``, the correction ball's source rows
    and the corrupt rows as flat indices into one channel of the cface
    layout (one gather and one scatter per conv); ``corr_mask``, the
    (12, n, P_l) plane that is 0 at the corrupt rows and 1 elsewhere (the
    backward's masks); ``strip_idx``, the halo
    strips' source map (:func:`.strips.strip_index_map`); and ``offsets``,
    the (nplanes, 2) tap offsets.

    ``bf16_io`` (the layers pass ``config.conv_dtype == "bfloat16_io"``,
    as the JAX package's): where :func:`.fused_stencil.cfp_io_available`,
    also ``weights_bf16``, the weight planes re-extended to R = roundup(h,
    16) margins and rounded to bfloat16 once (a torch bfloat16 tensor, the
    JAX package's ``weights_bf16`` bit for bit), and ``strip_idx_bf16``,
    the source map of the bfloat16 strips.
    """
    from .fused_stencil import (
        _round_up,
        cfp_geometry,
        cfp_io_available,
        cfp_structural_available,
        reextend_weights,
    )
    from .strips import strip_index_map

    extra = {}
    n, h = st.nside, st.n_steps
    if np.asarray(st.corr_src).shape[0]:
        _, P_l = cfp_geometry(n, h)

        def cfp_rows(a):
            a = np.asarray(a, dtype=np.int64)
            fa, xa, ya = a // (n * n), (a // n) % n, a % n
            return (fa * n + xa) * P_l + ya + h

        extra["corr_src_cfp"] = cfp_rows(st.corr_src)
        extra["corr_rows_cfp"] = cfp_rows(st.corr_out_face)
        # (12, n, P_l) plane, 0 at the corrupt rows and 1 elsewhere: the
        # backward zeroes those rows of x (K2) or dy (K3) with it
        cm = np.ones(12 * n * P_l, np.float32)
        cm[extra["corr_rows_cfp"]] = 0.0
        extra["corr_mask"] = cm.reshape(12, n, P_l)
    if cfp_structural_available(st, "mono", 2):
        extra["strip_idx"] = strip_index_map(st)
    if bf16_io and cfp_io_available(st):
        w = reextend_weights(np.asarray(st.weights, np.float32), n,
                             _round_up(h, 8), _round_up(h, 16))
        extra["weights_bf16"] = torch.from_numpy(w).to(torch.bfloat16)
        extra["strip_idx_bf16"] = strip_index_map(st, torch.bfloat16)
    return {
        **extra,
        "offsets": np.asarray(st.offsets, dtype=np.int32),
        "weights": st.weights,
        "west_src": st.west_src,
        "west_mask": st.west_mask,
        "east_src": st.east_src,
        "east_mask": st.east_mask,
        "south_src": st.south_src,
        "south_mask": st.south_mask,
        "north_src": st.north_src,
        "north_mask": st.north_mask,
        # corner-correction ball (empty for n_steps == radius)
        "corr_idx": st.corr_idx,
        "corr_val": st.corr_val,
        "corr_out_ball": st.corr_out_ball,
        # exact-kNN per-application fix rows (empty for grid/ring graphs)
        "fix_src": st.fix_src,
        "fix_idx": st.fix_idx,
        "fix_val": st.fix_val,
    }


def as_tensors(tables, device=None):
    """Host tables -> torch tensors on ``device``: floats as float32,
    integers as int64 (the CUDA kernels' tables stay int32).  Tensors
    keep their dtype (``weights_bf16`` stays bfloat16) and move to
    ``device``."""
    out = {}
    for k, v in tables.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device) if device is not None else v
            continue
        a = np.asarray(v)
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float32)
        else:
            a = a.astype(np.int32 if k in _INT32_TABLES else np.int64)
        if a.size == 0:
            # made by torch: an empty tensor over numpy memory keeps a
            # storage pointer that torch.export.save cannot package
            out[k] = torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                                 device=device)
            continue
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def _tables_for(tables, st, device):
    return as_tensors(stencil_tables(st) if tables is None else tables, device)


def pad_faces(st: FaceStencil, xf, tables):
    """(12, n, n, C) -> (12, P, P, C) with the cross-face halo filled from
    the four strip gathers (O(nside) rows each)."""
    n, s = st.nside, st.n_steps
    C = xf.shape[-1]
    flat = xf.reshape(12 * n * n, C)

    def strip(name):
        src = tables[f"{name}_src"]
        mask = tables[f"{name}_mask"].to(xf.dtype)
        return flat[src.reshape(-1)].reshape(tuple(src.shape) + (C,)) * mask[..., None]

    xpad = F.pad(xf, (0, 0, s, s, s, s))
    xpad[:, :s, :, :] = strip("west")
    xpad[:, s + n :, :, :] = strip("east")
    xpad[:, s : s + n, :s, :] = strip("south")
    xpad[:, s : s + n, s + n :, :] = strip("north")
    return xpad


def stencil_matvec(st: FaceStencil, tables, xf):
    """One application of the rescaled Laplacian: y = L~ xf.

    :param xf: (12, n, n, C) face-layout activations
    :return: (12, n, n, C)
    """
    n, s = st.nside, st.n_steps
    offs = st.offsets
    nc = len(offs) - 1  # center plane index (center is last)
    # weight planes: wrapped-extended layout — interior face rows at [0, n),
    # face col y at lane y + s
    w = tables["weights"][:, :, 0:n, s : s + n].to(xf.dtype)
    xpad = pad_faces(st, xf, tables)
    y = w[nc][..., None] * xf
    for d, (dx, dy) in enumerate(offs[:-1]):
        sl = xpad[:, s + dx : s + dx + n, s + dy : s + dy + n, :]
        y = y + w[d][..., None] * sl
    fs = tables.get("fix_src")
    if fs is not None and fs.shape[0]:
        # exact-kNN graphs: rows whose edges escape the capture window get
        # the exact ELLPACK matvec
        C = xf.shape[-1]
        flat = xf.reshape(12 * n * n, C)
        vals = torch.einsum("rw,rwc->rc", tables["fix_val"].to(xf.dtype),
                            flat[tables["fix_idx"]])
        y = y.reshape(12 * n * n, C).clone()
        y[fs] = vals
        y = y.reshape(12, n, n, C)
    return y


def _term_stream(kind, matvec, x0, n_terms):
    """Yield the polynomial basis terms one at a time (never stacked)."""
    from .spmv import bernstein_terms, chebyshev_terms, monomial_terms

    if kind == "cheby":
        yield from chebyshev_terms(matvec, x0, n_terms)
    elif kind == "mono":
        yield from monomial_terms(matvec, x0, n_terms)
    elif kind in ("bern", "bern_ref"):
        yield from bernstein_terms(matvec, x0, n_terms,
                                   quirk=kind == "bern_ref")
    else:
        raise ValueError(f"unknown basis kind: {kind}")


def conv_route(st: FaceStencil, kind, n_terms, cuda):
    """The route of :func:`stencil_graph_conv`, from the stencil, the basis
    and the device alone: ``"chain"`` (:func:`lap_chain_conv`) for a CUDA
    input of a deep-radius conv (radius >= 3, n_terms > 2) on its shallow
    stencil (``n_steps == radius``) that the chain takes, where the JAX
    package chains its single-lap kernel; ``"per_step"`` everywhere else
    (on the CPU always, as the JAX package without a Pallas backend)."""
    r = getattr(st, "radius", 1) or 1
    if (cuda and n_terms > 2 and r >= 3 and st.n_steps == r
            and lap_chain_available(st, kind, n_terms)):
        return "chain"
    return "per_step"


def stencil_graph_conv(st: FaceStencil, x, kernel, n_terms, kind, tables=None,
                       layout="nest", route=None):
    """Polynomial graph conv on the face layout, on the route that
    :func:`conv_route` gives: the lap chain, or one stencil step per term.

    Drop-in equivalent of :func:`.spmv.graph_conv` (same kernel layout),
    keeping the reference's (batch, pixel, channel) contract.

    :param x: (B, M, Fin)
    :param kernel: (Fin * n_terms, Fout), Fin-major / term-minor rows
    :param tables: :func:`stencil_tables` (host) or :func:`as_tensors`
        (device) arrays; ``None`` builds them on the spot
    :param layout: ordering of the pixel axis — "nest" (converted at entry
        and exit) or "face" (face-flat [f, x, y])
    :param route: the route, held by the caller, who has checked it for
        this batch (an exported forward: ``layers._GraphPolyConv.batch_route``);
        None chooses it here
    :return: (B, M, Fout)
    """
    held = route is not None
    if not held:
        route = conv_route(st, kind, n_terms, x.is_cuda)
    if route == "chain":
        _cuda.route_counts["lap_chain"] += 1
        return lap_chain_conv(st, x, kernel, n_terms, kind, tables=tables,
                              layout=layout, planned=held)
    return _per_step(st, x, kernel, n_terms, kind, tables, layout)


def _to_face(x, layout):
    """(B, M, F) in ``layout`` -> face-flat."""
    if layout == "nest":
        from .layout import nest_to_face

        return nest_to_face(x)
    if layout != "face":
        raise ValueError(f"unknown layout: {layout}")
    return x


def _from_face(y, layout):
    if layout == "nest":
        from .layout import face_to_nest

        return face_to_nest(y)
    return y


def _per_step(st: FaceStencil, x, kernel, n_terms, kind, tables=None,
              layout="nest"):
    """:func:`stencil_graph_conv`'s per-step path: one halo refill and one
    stencil application per term, plain torch ops on any device."""
    B, M, Fin = x.shape
    n = st.nside
    if M != 12 * n * n:
        raise ValueError(f"stencil conv needs the full sphere ({12*n*n} pixels), got {M}")
    Fout = kernel.shape[-1]
    tables = _tables_for(tables, st, x.device)

    xf = _to_face(x, layout).permute(1, 0, 2).reshape(12, n, n, B * Fin)
    matvec = lambda t: stencil_matvec(st, tables, t)
    wk = kernel.reshape(Fin, n_terms, Fout)
    y = x.new_zeros((M, B, Fout), dtype=torch.float32)
    for k, t in enumerate(_term_stream(kind, matvec, xf, n_terms)):
        tk = t.reshape(M, B, Fin)
        y = y + torch.einsum("mbf,fo->mbo", tk, wk[:, k, :].to(t.dtype))
    return _from_face(y.permute(1, 0, 2), layout).to(x.dtype)


def lap_chain_available(st: FaceStencil, kind, n_terms):
    """Whether :func:`lap_chain_conv` takes this conv: a Chebyshev or
    monomial recursion of at least 2 terms on a shallow stencil
    (``n_steps`` == its radius) that fits the fused conv for one
    application."""
    from .fused_stencil import cfp_structural_available

    if st is None or kind not in ("cheby", "mono") or n_terms < 2:
        return False
    r = getattr(st, "radius", 1) or 1
    if st.n_steps != r:
        return False
    return cfp_structural_available(st, "mono", 2)


def check_lap_chain(st: FaceStencil, B, Fin, sms, grad):
    """Raise where the kernels' plans on a card of ``sms`` SMs refuse a lap
    of :func:`lap_chain_conv` over B x Fin channels (``grad``: its backward's
    too)."""
    from .fused_stencil import chain_refused, staged_bytes

    refused = chain_refused(st.nside, st.radius, len(st.offsets), B, Fin,
                            sms, grad, staged_bytes())
    if refused:
        raise ValueError(
            f"lap chain: no plan of {', '.join(refused)} takes n={st.nside} "
            f"r={st.radius} B={B} channels {Fin} on {sms} SMs")


def lap_chain_conv(st: FaceStencil, x, kernel, n_terms, kind, tables=None,
                   layout="nest", planned=False):
    """Polynomial graph conv as a chain of single-lap fused convs.

    One L~ application per fused launch on the shallow stencil
    (``n_steps == radius``: strips, then K1 with the monomial K=2 term
    selector kernel ``[0; I]``, y = L~ x, exact with no corner correction),
    the Chebyshev or monomial recursion and the [Fin, Fout] contraction of
    each term between the launches.  It never builds the deep window of
    the one-shot conv, whose h = r*(K-1) outgrows a block's shared memory
    at radius >= 3 (and at radius 2 from h = 20).  Each lap is
    differentiated by the fused conv's backward; the selector needs no
    gradient, so the K1+K3 route runs no K3.  Same math as the per-step
    recursion.  Under a bf16 ``config.conv_dtype`` every lap is a bf16
    fused conv (bfloat16 out in the I/O mode), as in the JAX package's
    chain; the recursion's combine follows torch's promotion as JAX's
    does, and the contraction runs in float32.

    Same contract as :func:`stencil_graph_conv` (x: (B, M, Fin) ->
    (B, M, Fout)); requires :func:`lap_chain_available`.  A CUDA input
    whose laps the kernels' plans refuse raises before any launch, unless
    the caller has ``planned`` the laps for this batch
    (:func:`check_lap_chain`; an exported forward, whose batch is
    symbolic while it is traced).
    """
    from .fused_stencil import fused_stencil_conv_cfp
    from .spmv import chebyshev_terms, monomial_terms

    B, M, Fin = x.shape
    n, h = st.nside, st.n_steps
    if M != 12 * n * n:
        raise ValueError(
            f"stencil conv needs the full sphere ({12*n*n} pixels), got {M}")
    if not lap_chain_available(st, kind, n_terms):
        raise ValueError(f"the lap chain does not take a {kind} conv of "
                         f"{n_terms} terms on a depth-{h} stencil")
    if x.is_cuda and not planned:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        check_lap_chain(st, B, Fin, sms,
                        torch.is_grad_enabled() and x.requires_grad)
    Fout = kernel.shape[-1]
    tables = _tables_for(tables, st, x.device)

    # (B, M, Fin) -> (B*Fin, 12, n, P_l) once for the whole chain
    xc = cface_embed(_to_face(x, layout), n, h).reshape(B * Fin, 12, n, -1)
    # term selector: monomial, 2 terms, rows (Fin-major, term-minor) [0; I]
    eye = torch.eye(Fin, dtype=xc.dtype, device=x.device)
    sel = torch.stack([torch.zeros_like(eye), eye], dim=1).reshape(2 * Fin,
                                                                  Fin)

    def matvec(t):
        return fused_stencil_conv_cfp(st, tables, t, sel, 2, "mono", B)

    terms = (chebyshev_terms if kind == "cheby" else monomial_terms)(
        matvec, xc, n_terms)
    wk = kernel.reshape(Fin, n_terms, Fout)
    y = None
    for k, t in enumerate(terms):
        ti = t[..., h : h + n].reshape(B, Fin, M)
        if ti.dtype == torch.bfloat16:
            ti = ti.float()
        yk = torch.einsum("bfm,fo->bmo", ti, wk[:, k, :].to(ti.dtype))
        y = yk if y is None else y + yk
    return _from_face(y, layout).to(x.dtype)


def stencil_graph_conv_cface(st: FaceStencil, x5, kernel, n_terms, kind,
                             tables=None, chain=None, route=None):
    """Polynomial graph conv in the channels-first padded layout.

    A CUDA input takes the route that :func:`.fused_stencil.cface_route`
    gives its shape on its card: the kernels, :func:`_cface_per_step`, or
    :func:`_cface_chain`.  A CPU input runs the kernels' plain versions.

    :param x5: (B, Fin, 12, n, P_l) with face col y at lane y + h; only
        interior lanes are read
    :param chain: a callable returning the shallow stencil of the same
        Laplacian (``n_steps`` == its radius) and its tables on the device
        of ``x5``, called only where the route is the lap chain (the layer
        builds them then, not before); without it a chain route raises
    :param route: the route, held by the caller, who has checked it for
        this batch (an exported forward, whose batch is symbolic while it
        is traced: ``layers._GraphPolyConv.batch_route``); None chooses it
        here for a CUDA input
    :return: (B, Fout, 12, n, P_l); lanes outside the interior are 0
    """
    from .fused_stencil import (
        cface_route,
        cfp_geometry,
        fused_stencil_conv_cfp,
    )

    B, Fin, _, n, P_l = x5.shape
    h = st.n_steps
    _, P_exp = cfp_geometry(n, h)
    if n != st.nside or P_l != P_exp:
        raise ValueError(
            f"cface input geometry {(n, P_l)} does not match the stencil "
            f"({st.nside}, {P_exp})"
        )
    Fout = kernel.shape[-1]
    held = route is not None
    if x5.is_cuda and not held:
        sms = torch.cuda.get_device_properties(x5.device).multi_processor_count
        grad = torch.is_grad_enabled() and (x5.requires_grad
                                            or kernel.requires_grad)
        route = cface_route(st, kind, n_terms, B, Fin, Fout, sms, grad)
    if route == "per_step":
        return _cface_per_step(st, x5, kernel, n_terms, kind, tables)
    if route == "chain":
        if chain is None:
            raise ValueError("the cface conv's route is the lap chain, "
                             "which needs the shallow stencil (chain=)")
        return _cface_chain(*chain(), x5, kernel, n_terms, kind, h, held)
    tables = _tables_for(tables, st, x5.device)
    y = fused_stencil_conv_cfp(
        st, tables, x5.reshape(B * Fin, 12, n, P_l), kernel, n_terms, kind, B,
    )
    return y.reshape(B, Fout, 12, n, P_l).to(x5.dtype)


def _cface_chain(st_r, tables_r, x5, kernel, n_terms, kind, h,
                 planned=False):
    """The cface conv's lap-chain route: the interior lanes of the depth-h
    layout through :func:`lap_chain_conv` on the shallow stencil ``st_r``
    (face layout), padded again to depth h (counted in
    ``_cuda.route_counts["chain_cface"]``)."""
    _cuda.route_counts["chain_cface"] += 1
    yf = lap_chain_conv(st_r, cface_extract(x5, h), kernel, n_terms, kind,
                        tables=tables_r, layout="face", planned=planned)
    return cface_embed(yf, st_r.nside, h)


def _cface_per_step(st: FaceStencil, x5, kernel, n_terms, kind, tables=None):
    """The cface conv's per-step route: :func:`stencil_graph_conv` on the
    interior lanes, padded again with zeros (differentiated by autograd;
    counted in ``_cuda.route_counts["per_step_cface"]``)."""
    n, h = st.nside, st.n_steps
    _cuda.route_counts["per_step_cface"] += 1
    yf = _per_step(st, cface_extract(x5, h), kernel, n_terms, kind,
                   tables=tables, layout="face")
    return cface_embed(yf, n, h)


def cface_embed(x, n, h):
    """(B, M, F) face-flat -> (B, F, 12, n, P_l) channels-first padded (or
    the faces that M holds: a face shard's M = F_loc*n^2)."""
    from .fused_stencil import cfp_geometry

    B, M, Fc = x.shape
    _, P_l = cfp_geometry(n, h)
    xi = x.permute(0, 2, 1).reshape(B, Fc, M // (n * n), n, n)
    return F.pad(xi, (h, P_l - n - h))


def cface_extract(x5, h):
    """(B, F, 12, n, P_l) channels-first padded (or a face shard's faces)
    -> (B, M, F) face-flat."""
    B, Fc, faces, n, _ = x5.shape
    xi = x5[:, :, :, :, h : h + n].reshape(B, Fc, faces * n * n)
    return xi.permute(0, 2, 1)


def stencil_basis_stack(st: FaceStencil, kind, x2d, n_terms, tables=None):
    """Basis stack in NEST order, shape (n_terms, M, C) — the stencil-path
    analogue of ``spmv.chebyshev_basis`` & co., for tests and parity checks
    (the filter tooling's impulse responses): ``n_terms`` per-step
    applications of :func:`stencil_matvec`, on the device of ``x2d``."""
    from .layout import face_to_nest, nest_to_face

    n = st.nside
    M, C = x2d.shape
    tables = _tables_for(tables, st, x2d.device)
    xf = nest_to_face(x2d).reshape(12, n, n, C)
    matvec = lambda t: stencil_matvec(st, tables, t)
    terms = [
        face_to_nest(t.reshape(M, C))
        for t in _term_stream(kind, matvec, xf, n_terms)
    ]
    return torch.stack(terms, dim=0)
