"""Gather-free graph convolution: the stencil on the 12-face HEALPix layout.

PyTorch counterpart of the JAX package's ``deepsphere_tpu.ops.stencil``
(without its Pallas parts).  With the Laplacian in stencil form
(:func:`~deepsphere_tpu_torch.graph.stencil.face_stencil`) each Laplacian
application is (2r+1)^2 shifted multiply-adds on dense face images, the
face-border halo is refilled between applications from precomputed strip
maps, and the [K*Fin, Fout] contraction is folded into the recursion one
term at a time.

Two conv forms live here:

* :func:`stencil_graph_conv` — the per-step path: one halo refill and one
  stencil application per term, on (B, M, F) activations in NEST or
  face-flat order.  Plain torch ops on every device.
* :func:`stencil_graph_conv_cface` — the fused conv on the channels-first
  padded "cface" layout (B, F, 12, n, P_l), face col y at lane y + h.  It
  always calls :func:`.fused_stencil.fused_stencil_conv_cfp`: the device of
  the tensor decides between the CUDA kernels and their plain versions.

The static graph arrays travel as a ``tables`` dict (:func:`stencil_tables`
on the host, :func:`as_tensors` for a device); the model layers keep them
as non-persistent buffers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.stencil import FaceStencil

__all__ = [
    "stencil_tables",
    "as_tensors",
    "pad_faces",
    "edge_strips",
    "stencil_matvec",
    "stencil_graph_conv",
    "stencil_graph_conv_cface",
    "cface_embed",
    "cface_extract",
]

# int32 tables that CUDA kernels read as they are; every other integer
# table becomes int64 for torch indexing
_INT32_TABLES = ("strip_idx", "offsets")


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


def edge_strips(n, h, x3, embedded=False):
    """The four halo strips of every face, as structured edge copies.

    x3: (C, 12, n, n) channels-first faces — or, with ``embedded=True``,
    (C, 12, n, P_l) in the cface layout (face col y at lane y + h).
    Returns ``(west, east, south, north)`` with west/east (C, 12, h, n+2h)
    spanning the full padded width (corners included) and south/north
    (C, 12, n, h) covering interior rows — the coverage of the gather
    tables built in :mod:`..graph.stencil`.
    """
    bands = _extract_bands(x3, n, h, lane_off=h if embedded else 0)

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
                for f in range(12)
            ],
            dim=1,
        )

    def col_strip(ys):
        return torch.stack(
            [_edge_block(bands, n, h, f, 0, ys) for f in range(12)], dim=1
        )

    return row_strip(-1), row_strip(1), col_strip(-1), col_strip(1)


def stencil_tables(st: FaceStencil):
    """The arrays of a stencil that the convs read, as a dict of host numpy
    arrays (see :func:`as_tensors` for a device).

    Beyond the stencil's weight planes, halo-strip maps, correction ball and
    fix rows it holds, for the fused conv:
    ``corr_src_cfp`` / ``corr_rows_cfp``, the correction ball's source rows
    and the corrupt rows as flat indices into one channel of the cface
    layout (one gather and one scatter per conv); ``strip_idx``, the halo
    strips' source map (:func:`.strips.strip_index_map`); and ``offsets``,
    the (nplanes, 2) tap offsets.
    """
    from .fused_stencil import cfp_geometry, cfp_structural_available
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
    if cfp_structural_available(st, "mono", 2):
        extra["strip_idx"] = strip_index_map(st)
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
    already on ``device`` pass through."""
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
    from .spmv import chebyshev_terms, monomial_terms

    if kind == "cheby":
        yield from chebyshev_terms(matvec, x0, n_terms)
    elif kind == "mono":
        yield from monomial_terms(matvec, x0, n_terms)
    else:
        raise ValueError(f"unknown basis kind: {kind}")


def stencil_graph_conv(st: FaceStencil, x, kernel, n_terms, kind, tables=None,
                       layout="nest"):
    """Polynomial graph conv on the face layout, one stencil step per term.

    Drop-in equivalent of :func:`.spmv.graph_conv` (same kernel layout),
    keeping the reference's (batch, pixel, channel) contract.

    :param x: (B, M, Fin)
    :param kernel: (Fin * n_terms, Fout), Fin-major / term-minor rows
    :param tables: :func:`stencil_tables` (host) or :func:`as_tensors`
        (device) arrays; ``None`` builds them on the spot
    :param layout: ordering of the pixel axis — "nest" (converted at entry
        and exit) or "face" (face-flat [f, x, y])
    :return: (B, M, Fout)
    """
    B, M, Fin = x.shape
    n = st.nside
    if M != 12 * n * n:
        raise ValueError(f"stencil conv needs the full sphere ({12*n*n} pixels), got {M}")
    Fout = kernel.shape[-1]
    tables = _tables_for(tables, st, x.device)

    x2d = x.permute(1, 0, 2).reshape(M, B * Fin)
    if layout == "nest":
        from .layout import nest_to_face

        x2d = nest_to_face(x2d)
    elif layout != "face":
        raise ValueError(f"unknown layout: {layout}")

    xf = x2d.reshape(12, n, n, B * Fin)
    matvec = lambda t: stencil_matvec(st, tables, t)
    wk = kernel.reshape(Fin, n_terms, Fout)
    y = x.new_zeros((M, B, Fout), dtype=torch.float32)
    for k, t in enumerate(_term_stream(kind, matvec, xf, n_terms)):
        tk = t.reshape(M, B, Fin)
        y = y + torch.einsum("mbf,fo->mbo", tk, wk[:, k, :].to(t.dtype))
    if layout == "nest":
        from .layout import face_to_nest

        y = face_to_nest(y.reshape(M, B * Fout)).reshape(M, B, Fout)
    return y.permute(1, 0, 2).to(x.dtype)


def stencil_graph_conv_cface(st: FaceStencil, x5, kernel, n_terms, kind,
                             tables=None):
    """Polynomial graph conv in the channels-first padded layout.

    :param x5: (B, Fin, 12, n, P_l) with face col y at lane y + h; only
        interior lanes are read
    :return: (B, Fout, 12, n, P_l); lanes outside the interior are 0
    """
    from .fused_stencil import cfp_geometry, fused_stencil_conv_cfp

    B, Fin, _, n, P_l = x5.shape
    h = st.n_steps
    _, P_exp = cfp_geometry(n, h)
    if n != st.nside or P_l != P_exp:
        raise ValueError(
            f"cface input geometry {(n, P_l)} does not match the stencil "
            f"({st.nside}, {P_exp})"
        )
    Fout = kernel.shape[-1]
    tables = _tables_for(tables, st, x5.device)
    y = fused_stencil_conv_cfp(
        st, tables, x5.reshape(B * Fin, 12, n, P_l), kernel, n_terms, kind, B,
    )
    return y.reshape(B, Fout, 12, n, P_l).to(x5.dtype)


def cface_embed(x, n, h):
    """(B, M, F) face-flat -> (B, F, 12, n, P_l) channels-first padded."""
    from .fused_stencil import cfp_geometry

    B, M, Fc = x.shape
    _, P_l = cfp_geometry(n, h)
    xi = x.permute(0, 2, 1).reshape(B, Fc, 12, n, n)
    return F.pad(xi, (h, P_l - n - h))


def cface_extract(x5, h):
    """(B, F, 12, n, P_l) channels-first padded -> (B, M, F) face-flat."""
    B, Fc, _, n, _ = x5.shape
    xi = x5[:, :, :, :, h : h + n].reshape(B, Fc, 12 * n * n)
    return xi.permute(0, 2, 1)
