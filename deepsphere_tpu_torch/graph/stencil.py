"""Stencil form of the sphere-graph Laplacian on the 12-face HEALPix layout.

The reference computes graph convolution as repeated sparse matvecs of an
M x M Laplacian (``deepsphere-cosmo-tf2 src/deepsphere/gnn_layers.py:137-143``
via ``tf.sparse.sparse_dense_matmul``).  On TPU, gathers are the enemy; but
for the grid/ring HEALPix graphs (k = 8 -> radius-1, k in {20, 40, 60} ->
radius 2/3/4 templates) the Laplacian *is* a (2r+1)^2 stencil on the
(12, nside, nside) face layout (see :mod:`..sphere.faces`), with per-pixel
weights (edge weights vary over the sphere) and a halo exchange at face
borders.  Masked skies extract too (all-zero rows outside the mask).  This
module extracts that stencil from any grid-structured
:class:`~deepsphere_tpu.graph.SphereGraph`:

* ``weights`` — (9, 12, Pw, Pw) per-direction weight planes of the rescaled
  Laplacian (directions follow the healpix_base neighbor order SW, W, NW, N,
  NE, E, SE, S, plus the diagonal/center term last).
* border fill indices — scatter/gather maps that fill a depth-``n_steps``
  halo around each face from the other faces.
* ``corrupt`` — for fused multi-step application (``n_steps > 1``): the halo
  positions near the 8 polar 3-way corners whose neighborhoods are not
  representable in a rectangular face layout (a constant ~96 positions,
  independent of nside), plus the interior NEST rows whose values they can
  reach within ``n_steps - 1`` hops.  Fused kernels must re-correct those
  rows (see :func:`~deepsphere_tpu.ops.stencil` users); the single-step
  path (``n_steps == 1``) is exact.

Extraction verifies per-row mass conservation against the CSR Laplacian, so
a graph whose edges are not grid-structured (e.g. a kNN graph that deviates
at face corners) is detected and rejected — callers then fall back to the
ELLPACK gather path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..sphere import healpix as hp
from ..sphere.faces import face2nest_index, halo_map
from ..sphere.healpix import _NB_XOFFSET, _NB_YOFFSET

__all__ = [
    "FaceStencil",
    "face_stencil",
    "STENCIL_OFFSETS",
    "stencil_offsets",
    "load_stencil_cache",
    "save_stencil_cache",
]

# (dx, dy) per weight plane; plane 8 is the center/diagonal term
STENCIL_OFFSETS = [(int(x), int(y)) for x, y in zip(_NB_XOFFSET, _NB_YOFFSET)] + [(0, 0)]


def stencil_offsets(radius):
    """Tap offsets of a radius-r stencil, center LAST.

    radius 1 keeps the legacy healpix_base neighbor order (caches and the
    native weight extractor depend on it); radius > 1 (the k in {20,40,60}
    ring graphs) uses raster order over the (2r+1)^2 template.
    """
    if radius == 1:
        return STENCIL_OFFSETS
    r = int(radius)
    offs = [(dx, dy)
            for dx in range(-r, r + 1) for dy in range(-r, r + 1)
            if (dx, dy) != (0, 0)]
    return offs + [(0, 0)]


@dataclass(eq=False)
class FaceStencil:
    """Static stencil-form Laplacian for ``n_steps`` fused applications.

    The halo fill is stored as four *strip* gathers (west/east strips span
    the full padded width including corners; south/north cover the rest).
    Strips land in the padded array via static-slice updates
    (``dynamic_update_slice``) — TPU executes those at full bandwidth,
    whereas an index scatter serializes.
    """

    nside: int
    n_steps: int  # halo (pad) depth = radius * (fused applications);
    # weights cover positions of depth <= n_steps - radius
    scale: float
    weights: np.ndarray
    # (9, 12, nside + 2R, P_l) f32 wrapped-extended weight planes,
    # R = roundup(n_steps, 8), P_l = roundup(nside + 2*n_steps, 128):
    # interior face row x at row x (lane y + n_steps for face col y);
    # rows [n, n+R) hold face rows [-R, 0) (zeros where undefined) and
    # [n+R, n+2R) hold face rows [n, n+R) — so the fused kernel's window
    # DMA pieces mirror the activation pieces with 8-aligned slices.
    # halo strips: face-flat (12*n*n) source rows (clamped) + 0/1 masks
    west_src: np.ndarray  # (12, s, P) int32, P = nside + 2*n_steps
    west_mask: np.ndarray  # (12, s, P) f32
    east_src: np.ndarray  # (12, s, P) int32
    east_mask: np.ndarray
    south_src: np.ndarray  # (12, n, s) int32
    south_mask: np.ndarray
    north_src: np.ndarray  # (12, n, s) int32
    north_mask: np.ndarray
    n2f: np.ndarray  # (12*n*n,) int32: NEST id at each face-flat position
    f2n: np.ndarray  # (npix,) int32: face-flat position of each NEST pixel
    corrupt_rows: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # NEST rows whose fused-kernel outputs need exact recomputation, plus the
    # precomputed recompute "ball": a local ELLPACK over the n_steps-hop
    # neighborhood of the corrupt rows (see ``face_stencil`` for why the
    # rectangular face extension is incomplete near the 8 polar corners)
    corr_src: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    # (Bn,) face-flat ids of ball rows (gather t_0 from the input)
    corr_idx: np.ndarray = field(default_factory=lambda: np.zeros((0, 9), np.int32))
    corr_val: np.ndarray = field(default_factory=lambda: np.zeros((0, 9), np.float32))
    corr_out_ball: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    # (Rc,) ball-local positions of the corrupt rows
    corr_out_face: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    # (Rc,) face-flat positions of the corrupt rows
    radius: int = 1  # stencil radius r: taps span (2r+1)^2; one application
    # consumes r halo rows/cols (k in {20,40,60} ring graphs have r > 1)
    # single-application fix rows (exact-kNN graphs only): interior rows
    # whose edges escape/alias the capture window.  The per-step XLA path
    # overwrites y at these rows with the exact ELLPACK matvec after every
    # application (the fused kernel instead folds them into corrupt_rows).
    fix_src: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    # (Rf,) face-flat positions of the fix rows
    fix_idx: np.ndarray = field(default_factory=lambda: np.zeros((0, 9), np.int32))
    # (Rf, W) face-flat column ids of the exact rows
    fix_val: np.ndarray = field(default_factory=lambda: np.zeros((0, 9), np.float32))

    @property
    def pad_width(self):
        return self.nside + 2 * self.n_steps

    @property
    def offsets(self):
        return stencil_offsets(self.radius)


def _stencil_cache_path(graph, scale, n_steps, cache_dir):
    if cache_dir is None:
        return None
    import os

    h = getattr(graph, "_key", None)
    if h is None:
        return None
    tag = "-".join(str(p) for p in h)
    return os.path.join(
        cache_dir, f"face_stencil-v5-{tag}-s{scale:.6g}-n{n_steps}.npz"
    )


def load_stencil_cache(graph, scale, n_steps, cache_dir):
    """Load a disk-cached stencil (None on miss).  Keyed by the graph's
    content key + (scale, n_steps), mirroring the reference smoothing
    layer's kernel cache (``healpy_layers.py:652-662``)."""
    import os

    path = _stencil_cache_path(graph, scale, n_steps, cache_dir)
    if path is None or not os.path.exists(path):
        return None
    z = np.load(path)
    fields = [
        "weights", "west_src", "west_mask", "east_src", "east_mask",
        "south_src", "south_mask", "north_src", "north_mask",
        "n2f", "f2n", "corrupt_rows",
        "corr_src", "corr_idx", "corr_val", "corr_out_ball", "corr_out_face",
        "radius", "fix_src", "fix_idx", "fix_val",
    ]
    if not all(f in z for f in fields):  # stale cache from an older layout
        return None
    return FaceStencil(
        nside=int(z["nside"]),
        n_steps=int(n_steps),
        scale=float(scale),
        **{f: z[f] for f in fields if f != "radius"},
        radius=int(z["radius"]),
    )


def save_stencil_cache(st, graph, cache_dir):
    import os

    path = _stencil_cache_path(graph, st.scale, st.n_steps, cache_dir)
    if path is None:
        return
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + f".{os.getpid()}.tmp.npz"
    np.savez(
        tmp,
        nside=np.asarray(st.nside),
        weights=st.weights,
        west_src=st.west_src,
        west_mask=st.west_mask,
        east_src=st.east_src,
        east_mask=st.east_mask,
        south_src=st.south_src,
        south_mask=st.south_mask,
        north_src=st.north_src,
        north_mask=st.north_mask,
        radius=np.asarray(st.radius),
        n2f=st.n2f,
        f2n=st.f2n,
        corrupt_rows=st.corrupt_rows,
        corr_src=st.corr_src,
        corr_idx=st.corr_idx,
        corr_val=st.corr_val,
        corr_out_ball=st.corr_out_ball,
        corr_out_face=st.corr_out_face,
        fix_src=st.fix_src,
        fix_idx=st.fix_idx,
        fix_val=st.fix_val,
    )
    os.replace(tmp, path)


def _lookup_entries(ell_idx, ell_val, rows, cols, chunk=1 << 20):
    """values[i] = L[rows[i], cols[i]] from a padded ELLPACK matrix."""
    out = np.zeros(rows.shape[0], dtype=ell_val.dtype)
    for s in range(0, rows.shape[0], chunk):
        r = rows[s : s + chunk]
        c = cols[s : s + chunk]
        out[s : s + chunk] = (ell_val[r] * (ell_idx[r] == c[:, None])).sum(axis=1)
    return out


def face_stencil(graph, scale, n_steps=None):
    """Extract the stencil form of ``graph``'s rescaled Laplacian.

    :param graph: a :class:`~deepsphere_tpu.graph.SphereGraph` over the full
        sphere.  Grid/ring graphs ("grid" construction) extract exactly at
        the template radius; exact-kNN graphs ("knn", the reference's pygsp
        semantics) extract at the wider capture radius
        (:data:`..laplacian.KNN_CAPTURE_RADIUS`) with the rare
        escaping/aliasing rows routed to the corrupt-row exact recompute.
    :param scale: spectrum rescale passed to ``graph.ellpack``.
    :param n_steps: number of fused stencil applications the caller intends
        (halo depth).  ``1`` (default) is exact; ``>1`` produces a
        ``corrupt_rows`` set that callers must re-correct.
    :raises ValueError: if the graph is not stencil-representable.
    """
    from .laplacian import GRID_RADIUS

    nside = int(graph.nside)
    npix = hp.nside2npix(nside)
    radius = getattr(graph, "stencil_radius", None)
    if radius is None:
        radius = GRID_RADIUS.get(int(graph.k))
    if radius is None:
        raise ValueError(
            f"no stencil template for k={graph.k}; supported k: "
            f"{sorted(GRID_RADIUS)}"
        )
    # grid/ring graphs are stencil-structured BY CONSTRUCTION: any
    # incomplete interior row there is an internal error.  Exact kNN
    # graphs (reference pygsp semantics) are merely stencil-CAPTURABLE:
    # the rare rows whose edges escape the capture window (or alias two
    # offsets near the polar corners) become corrupt rows, recomputed
    # exactly from the ball ELLPACK like the corner rows already are.
    strict = getattr(graph, "method", "grid") != "knn"
    if n_steps is None:
        n_steps = radius
    # n_steps is a halo DEPTH in rows, not a lap count: any depth >=
    # radius*(laps) supports that many fused applications (the extra rows
    # are valid-but-unused margin).  Depths that are not a multiple of the
    # radius are legal — the fused kernel pads unaligned depths up to the
    # sublane tile (deep_stencil), which is what keeps its compiled DMA
    # geometry inside the Mosaic-verified 8-aligned envelope.
    if n_steps < radius or n_steps >= nside:
        raise ValueError(
            f"n_steps (halo depth) must be in [radius={radius}, nside), "
            f"got {n_steps}"
        )

    ell_idx, ell_val = graph.ellpack(scale)
    T2 = (2 * radius + 1) ** 2
    if ell_idx.shape[1] > T2:
        raise ValueError(
            f"graph rows have up to {ell_idx.shape[1]} entries; "
            f"not a radius-{radius} grid graph"
        )

    partial = graph.n_pixels != npix
    if partial:
        # masked sky: embed the local ELLPACK into full-sphere NEST ids with
        # ALL-ZERO rows outside the mask.  A mask-restricted grid graph has
        # no out-of-mask edges, so the stencil recursion stays exact: the
        # embedded activation is zero outside, zero-weight rows emit zero,
        # and in-mask rows never read out-of-mask values (their weights are
        # zero there too).  Reference anchor: the masked advanced_tutorial
        # workload (healpy_networks.py:110-118 builds over `indexes`).
        glob = np.asarray(graph.indices, dtype=np.int64)
        W = ell_idx.shape[1]
        idx_full = np.tile(np.arange(npix, dtype=np.int32)[:, None], (1, W))
        val_full = np.zeros((npix, W), dtype=ell_val.dtype)
        idx_full[glob] = glob[np.asarray(ell_idx, dtype=np.int64)].astype(np.int32)
        val_full[glob] = ell_val
        ell_idx, ell_val = idx_full, val_full

    from .. import native

    h = n_steps - radius  # weight coverage depth
    Pw = nside + 2 * h
    hm = halo_map(nside, n_steps)  # need neighbors of depth-h positions
    core = hm[:, radius : radius + Pw, radius : radius + Pw]
    rows_flat = core.reshape(-1)
    offsets = stencil_offsets(radius)
    nplanes = len(offsets)

    # padded-activation embedding geometry (rows to a sublane multiple,
    # lanes to a lane-tile multiple, so fused-kernel band DMAs stay aligned)
    P = nside + 2 * n_steps
    P_r = nside + -(-2 * n_steps // 8) * 8
    P_l = -(-P // 128) * 128

    use_native = (
        radius == 1
        and getattr(graph, "_ell_L", None) is not None
        and native.available()
    )
    captured_abs = None
    if use_native:
        # weight planes extracted in one native pass, already embedded
        w_emb = native.stencil_weights(nside, n_steps, ell_idx, ell_val)
        weights = np.ascontiguousarray(
            w_emb[:, :, 1 : 1 + Pw, 1 : 1 + Pw]
        ).reshape(9, -1)
    elif native.available():
        # generic radius-r native extraction (the _lookup_entries loop in
        # one C++ pass; _ell_raster_ordered graphs — e.g. the smoothing
        # template builder — additionally skip the per-entry search on
        # full-interior rows).  captured mass comes back with the planes.
        w_emb, cap = native.ellpack_stencil_planes(
            nside, n_steps, radius, ell_idx, ell_val,
            raster_ordered=bool(getattr(graph, "_ell_raster_ordered", False)),
        )
        captured_abs = cap.reshape(-1)
        weights = None  # mass check uses the native captured_abs directly
    else:
        # weight planes: w[d, f, u, v] = L[pix(f,u,v), pix((f,u,v)+d)]
        weights = np.zeros((nplanes, 12 * Pw * Pw), dtype=np.float32)
        for d, (dx, dy) in enumerate(offsets):
            nbr = hm[:, radius + dx : radius + dx + Pw,
                     radius + dy : radius + dy + Pw].reshape(-1)
            valid = (rows_flat >= 0) & (nbr >= 0)
            vals = np.zeros(rows_flat.shape[0], dtype=np.float32)
            vals[valid] = _lookup_entries(
                ell_idx, ell_val, rows_flat[valid], nbr[valid]
            )
            weights[d] = vals
        w_emb = np.zeros((nplanes, 12, P_r, P_l), dtype=np.float32)
        w_emb[:, :, radius : radius + Pw, radius : radius + Pw] = (
            weights.reshape(nplanes, 12, Pw, Pw)
        )

    # mass-conservation check against the ELLPACK row sums
    if captured_abs is None:
        captured_abs = np.abs(weights.astype(np.float64)).sum(axis=0)
    row_abs = np.abs(ell_val.astype(np.float64)).sum(axis=1)
    real = rows_flat >= 0
    expect = row_abs[rows_flat[real]]
    got = captured_abs[real]
    tol = 1e-6 * (1.0 + expect)
    overcounted = np.zeros(12 * Pw * Pw, dtype=bool)
    overcounted[real] = got > expect + tol
    if strict and np.any(overcounted):
        raise ValueError("stencil extraction double-counted entries (internal error)")
    incomplete = np.zeros(12 * Pw * Pw, dtype=bool)
    incomplete[real] = got < expect - tol
    bad = incomplete | overcounted

    # interior rows must be complete for grid/ring graphs, else the graph
    # is not grid-structured; for kNN graphs bad interior rows join the
    # corrupt set (bounded fraction — beyond that the capture radius is
    # wrong for this graph and ELLPACK fallback is the honest answer)
    interior = np.zeros((12, Pw, Pw), dtype=bool)
    interior[:, h : h + nside, h : h + nside] = True
    bad_int = bad & interior.reshape(-1)
    if np.any(bad_int):
        n_bad = int(np.unique(rows_flat[bad_int]).shape[0])
        if strict:
            raise ValueError(
                f"{n_bad} graph rows have edges outside the NEST 8-neighbor "
                "structure; graph is not stencil-representable"
            )
        if n_bad > 0.03 * npix:
            raise ValueError(
                f"{n_bad} of {npix} kNN rows escape the radius-{radius} "
                "capture window; graph is not efficiently stencil-capturable"
            )

    # fused-step corruption: halo positions with incomplete neighborhoods
    # poison everything within stencil reach over the remaining
    # applications — Chebyshev distance (n_steps - radius), i.e. that many
    # 8-neighbor BFS hops
    corrupt_rows = np.zeros(0, dtype=np.int64)
    corr = {}
    need_corr = (n_steps > radius and np.any(bad)) or np.any(bad_int)
    if need_corr:
        if getattr(graph, "_nb_w", None) is not None:
            nb = graph._nb_w[0]
        elif native.available():
            nb = native.neighbors_nest(nside)
        else:
            nb = hp.neighbors_nest(nside, np.arange(npix, dtype=np.int64))

        def bfs(seed_set, hops):
            reach = set(seed_set.tolist())
            frontier = np.asarray(sorted(reach), dtype=np.int64)
            for _ in range(hops):
                if frontier.size == 0:
                    break
                cand = np.unique(nb[frontier][nb[frontier] >= 0])
                frontier = np.asarray(
                    [int(q) for q in cand if int(q) not in reach], dtype=np.int64
                )
                reach |= set(frontier.tolist())
            return np.asarray(sorted(reach), dtype=np.int64)

        seeds = np.unique(rows_flat[bad])
        corrupt_rows = bfs(seeds, n_steps - radius)
        if not strict and corrupt_rows.shape[0] > 0.6 * npix:
            # kNN corner wedges grow as (n_steps)^2 (O(1) in nside): at
            # tiny nside / deep fusion the exact-recompute ball would
            # swallow the map — ELLPACK fallback is the honest answer
            raise ValueError(
                f"{corrupt_rows.shape[0]} of {npix} rows corrupt under "
                f"{n_steps}-step fusion; stencil capture not worthwhile"
            )

        # recompute ball: t_0 gathered exactly, so a ball of radius n_steps
        # around the corrupt rows supports n_steps exact recursion steps at
        # the corrupt rows themselves
        ball = bfs(corrupt_rows, n_steps)
        local = {int(g): i for i, g in enumerate(ball)}
        # ball-local ELLPACK straight from the rescaled ELLPACK rows
        # (out-of-ball cols only matter in the invalid outer shell; clamp.
        # self-pointing zero-padded entries clamp harmlessly too)
        Wl = ell_idx.shape[1]
        corr_idx = np.zeros((len(ball), Wl), dtype=np.int32)
        corr_val = np.zeros((len(ball), Wl), dtype=np.float32)
        for i, g in enumerate(ball):
            corr_idx[i] = [local.get(int(c), 0) for c in ell_idx[g]]
            corr_val[i] = ell_val[g]
        f2n_full = face2nest_index(nside)
        corr = dict(
            corr_src=f2n_full[ball].astype(np.int32),
            corr_idx=corr_idx,
            corr_val=corr_val,
            corr_out_ball=np.asarray(
                [local[int(g)] for g in corrupt_rows], dtype=np.int32
            ),
            corr_out_face=f2n_full[corrupt_rows].astype(np.int32),
        )

    # halo strip maps for a depth-n_steps pad (regular slices, not scatter)
    s = n_steps
    hmP = halo_map(nside, s)
    f2n = face2nest_index(nside)

    def strip(pix):
        mask = (pix >= 0).astype(np.float32)
        src = f2n[np.clip(pix, 0, npix - 1)].astype(np.int32)
        return src, mask

    west_src, west_mask = strip(hmP[:, :s, :])  # (12, s, P)
    east_src, east_mask = strip(hmP[:, s + nside :, :])  # (12, s, P)
    south_src, south_mask = strip(hmP[:, s : s + nside, :s])  # (12, n, s)
    north_src, north_mask = strip(hmP[:, s : s + nside, s + nside :])  # (12, n, s)

    # single-application fix rows for the per-step XLA path (kNN graphs):
    # the exact ELLPACK rows of the bad interior rows, in face-flat ids
    fix = {}
    if not strict and np.any(bad_int):
        seeds_int = np.unique(rows_flat[bad_int])  # NEST ids
        fix = dict(
            fix_src=f2n[seeds_int].astype(np.int32),
            fix_idx=f2n[
                np.asarray(ell_idx[seeds_int], dtype=np.int64)
            ].astype(np.int32),
            fix_val=np.asarray(ell_val[seeds_int], dtype=np.float32),
        )
        from .._logger import logger

        logger.info(
            f"kNN stencil capture (radius {radius}): {len(seeds_int)} of "
            f"{npix} rows escape the window -> exact per-row recompute "
            f"({corrupt_rows.shape[0]} corrupt rows for the fused path)"
        )

    n2f = halo_map(nside, 0).reshape(-1).astype(np.int32)

    # wrapped-extended weight layout (see FaceStencil.weights): face row x
    # lives at old embedded row x + n_steps
    R = -(-n_steps // 8) * 8
    w_ext = np.zeros((nplanes, 12, nside + 2 * R, P_l), dtype=np.float32)
    w_ext[:, :, 0:nside] = w_emb[:, :, n_steps : n_steps + nside, :P_l]
    for rr in range(1, n_steps):  # top halo: face rows -rr
        w_ext[:, :, nside + R - rr] = w_emb[:, :, n_steps - rr, :P_l]
    for j in range(0, n_steps - 1):  # bottom halo: face rows n + j
        w_ext[:, :, nside + R + j] = w_emb[:, :, n_steps + nside + j, :P_l]

    return FaceStencil(
        nside=nside,
        n_steps=n_steps,
        scale=float(scale),
        radius=radius,
        weights=w_ext,
        west_src=west_src,
        west_mask=west_mask,
        east_src=east_src,
        east_mask=east_mask,
        south_src=south_src,
        south_mask=south_mask,
        north_src=north_src,
        north_mask=north_mask,
        n2f=n2f,
        f2n=f2n.astype(np.int32),
        corrupt_rows=corrupt_rows,
        **corr,
        **fix,
    )
