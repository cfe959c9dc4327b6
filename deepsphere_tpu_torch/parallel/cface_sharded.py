"""Face-sharded fused stencil conv: tensor parallelism for the hot op.

Counterpart of the JAX package's ``deepsphere_tpu.parallel.cface_sharded``.
The conv's native layout (C, 12, n, P_l) shards on the FACE axis (12 = 2,
3, 4, 6 or 12 shards of F_loc faces): each rank runs the fused kernel
(K1, ``csrc/stencil_conv.cu``) over its local faces, and the activation
exchange is one all-gather of the four h-deep face-edge bands, O(h*n) per
face, from which each rank builds its local halo strips.  Per conv:

1. K5 (``csrc/bands.cu``, :func:`..ops.stencil.pack_edge_bands`) cuts the
   bands of the local faces into one face-major buffer (F_loc, C, 4hn);
2. one all-gather over the pixel group gives every face's bands (12, C,
   4hn) — the JAX package gathers the four bands separately;
3. K4's gather kernel builds the local faces' strips from it through a
   host-built source map (:func:`..ops.strips.build_band_strips`);
4. K1 on the local faces;
5. the corner correction.  The rows near the 8 polar 3-way corners are
   recomputed from an exact ELLPACK ball as in the single-device conv.
   Each rank sends the ball's source rows that lie on its faces (one flat
   gather, padded to the largest count), one all-gather assembles the
   ball, the ball recursion runs replicated, and each rank patches the
   corrupt rows of its own faces.  (The JAX package gathers four corner
   boxes per face instead; the rows are the same.)

The backward is the two-kernel form: dx is the same sharded conv with the
transposed channel kernel, on dy; dW is K3 (``csrc/stencil_grad.cu``) on
the local faces with dy's corrupt rows zeroed, all-reduced over the pixel
group inside the backward, plus the exact ball term, added once after the
all-reduce (it is computed from the gathered ball, the same on every face
rank).  The JAX package emits the ball term on face rank 0 only because
``shard_map`` sums the cotangents of unmapped inputs over the mesh; torch
does no such sum.

Batch parallelism composes on the ``data`` axis: the activation packs batch
into the channel dim b-major, so each data rank's channels are its own
rows, and the conv's collectives run over the pixel group only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..graph.stencil import FaceStencil
from ..ops.fused_stencil import (
    _basis_at_rows,
    _corrected_rows,
    _gather_rows,
    _patch_rows,
    _wk3,
    _wk3t,
    cfp_geometry,
    conv_dtypes,
    run_grad_kernel,
    run_stencil_kernel,
)
from ..ops.stencil import pack_edge_bands, stencil_tables
from ..ops.strips import band_strip_index_map, build_band_strips
from .collectives import all_gather_tensor, all_reduce_

__all__ = ["face_shard_tables", "face_sharded_cfp_conv", "cface_model_conv"]


def _exchange_plan(rows, slab, F, rank, n_shards):
    """Rows (flat cface indices over all 12 faces) gathered from the face
    shards in one all-gather: each shard sends those of ``rows`` on its
    faces, in order, padded with 0 to the largest count H.

    :return: ``(send, pos)``: this shard's local flat indices (H,), and for
        every entry of ``rows`` its position in the gathered (S*H) buffer
    """
    owner = rows // (F * slab)
    counts = np.bincount(owner, minlength=n_shards)
    H = max(int(counts.max()), 1)
    send = np.zeros(H, np.int64)
    mine = np.nonzero(owner == rank)[0]
    send[: mine.size] = rows[mine] - rank * F * slab
    pos = np.empty(rows.shape[0], np.int64)
    for s in range(n_shards):
        sel = np.nonzero(owner == s)[0]
        pos[sel] = s * H + np.arange(sel.size)
    return send, pos


def face_shard_tables(st: FaceStencil, rank, n_shards):
    """The host tables of face shard ``rank`` of ``n_shards`` (its faces are
    [rank*F, (rank+1)*F), F = 12 / n_shards), as a dict of numpy arrays:

    * ``weights`` (T2, F, n+2R, P_l): K1's and K3's;
    * ``band_strip_idx``: the local faces' strip map into the gathered
      bands (:func:`..ops.strips.band_strip_index_map`);
    * with corner corrections: ``corr_idx``/``corr_val``/``corr_out_ball``
      (the ball, replicated), ``corr_mask`` (F, n, P_l), ``ball_send`` /
      ``ball_pos`` and ``rows_send``/``rows_pos`` (:func:`_exchange_plan` of
      the ball's source rows and of the corrupt rows), ``patch_rows`` (the
      corrupt rows on the local faces, local flat indices) and
      ``patch_sel`` (their index among the corrupt rows).
    """
    if 12 % n_shards or not 0 <= rank < n_shards:
        raise ValueError(f"face shard {rank} of {n_shards}: the shards must "
                         "divide the 12 faces")
    n, h = st.nside, st.n_steps
    F = 12 // n_shards
    f0 = rank * F
    _, P_l = cfp_geometry(n, h)
    full = stencil_tables(st)
    out = {
        "weights": np.ascontiguousarray(st.weights[:, f0 : f0 + F]),
        "band_strip_idx": band_strip_index_map(st, range(f0, f0 + F)),
    }
    if "corr_rows_cfp" in full:
        slab = n * P_l
        rows = full["corr_rows_cfp"]
        out["corr_mask"] = np.ascontiguousarray(full["corr_mask"][f0 : f0 + F])
        for k in ("corr_idx", "corr_val", "corr_out_ball"):
            out[k] = full[k]
        out["ball_send"], out["ball_pos"] = _exchange_plan(
            full["corr_src_cfp"], slab, F, rank, n_shards)
        out["rows_send"], out["rows_pos"] = _exchange_plan(
            rows, slab, F, rank, n_shards)
        own = rows // (F * slab) == rank
        out["patch_rows"] = rows[own] - f0 * slab
        out["patch_sel"] = np.nonzero(own)[0]
    return out


def _gather_shard_rows(a, send, pos, group):
    """Rows of the face-sharded ``a`` (C, F_loc, n, P_l) at flat positions
    over all faces: this rank's ``send`` rows, one all-gather, then the
    ``pos`` entries of the gathered buffer: (len(pos), C)."""
    return all_gather_tensor(_gather_rows(a, send), group)[pos]


def _forward_sharded(st, tables, xc, wk3, n_terms, kind, B, group, bdt):
    """xc (C, F_loc, n, P_l) local shard -> ``(y, strips, ball)``: y
    (B*Fout, F_loc, n, P_l), the local strips and the gathered ball source
    rows (None without corrections), which the backward reuses; ``bdt``
    the band dtype."""
    n, h = st.nside, st.n_steps
    F = xc.shape[1]
    bands = all_gather_tensor(pack_edge_bands(xc, n, h), group)
    if bands.shape[0] != 12:
        raise ValueError(f"{F} faces per shard over the group do not make 12")
    f0 = dist.get_rank(group) * F
    strips = build_band_strips(st, bands, range(f0, f0 + F),
                               index=tables["band_strip_idx"])
    y = run_stencil_kernel(st, kind, n_terms, xc, tables["weights"], strips,
                           wk3, B, bdt)
    ball = None
    if "ball_send" in tables:
        ball = _gather_shard_rows(xc, tables["ball_send"], tables["ball_pos"],
                                  group)
        y_fix = _corrected_rows(tables, ball, wk3, n_terms, kind, B)
        y = _patch_rows(y, tables["patch_rows"], y_fix[tables["patch_sel"]])
    return y, strips, ball


class _FaceShardedConv(torch.autograd.Function):
    """K5 -> band all-gather -> band strips -> K1 -> correction; backward
    dx by the same sharded conv with W^T, dW by K3 + the ball term, summed
    over the pixel group."""

    @staticmethod
    def forward(ctx, xc, kernel, st, tables, n_terms, kind, B, group, bdt):
        y, strips, ball = _forward_sharded(
            st, tables, xc, _wk3(kernel, n_terms), n_terms, kind, B, group,
            bdt)
        ctx.save_for_backward(xc, kernel, *strips,
                              *(() if ball is None else (ball,)))
        ctx.meta = (st, tables, n_terms, kind, B, group, bdt)
        return y

    @staticmethod
    def backward(ctx, dy):
        st, tables, K, kind, B, group, bdt = ctx.meta
        xc, kernel, top, bot, ls, *ball = ctx.saved_tensors
        dy = dy.to(xc.dtype).contiguous()
        Fin = xc.shape[0] // B
        Fout = kernel.shape[-1]
        dx = None
        if ctx.needs_input_grad[0]:
            # the patched conv is the exact symmetric operator: its adjoint
            # is the same sharded conv with the transposed channel kernel
            dx, _, _ = _forward_sharded(st, tables, dy, _wk3t(kernel, K), K,
                                        kind, B, group, bdt)
        has_corr = "ball_send" in tables
        dy_clean = dy * tables["corr_mask"].to(dy.dtype) if has_corr else dy
        dwk = run_grad_kernel(st, kind, K, xc, tables["weights"],
                              (top, bot, ls), dy_clean, B, bdt)
        dwk = all_reduce_(dwk.reshape(K, Fin, Fout).contiguous(), group)
        if has_corr:
            basis = _basis_at_rows(tables, ball[0], K, kind)
            dy_rc = _gather_shard_rows(dy, tables["rows_send"],
                                       tables["rows_pos"], group)
            dwk = dwk + torch.einsum(
                "krbf,rbo->kfo", basis.reshape(K, -1, B, Fin),
                dy_rc.reshape(-1, B, Fout))
        dkernel = dwk.permute(1, 0, 2).reshape(Fin * K, Fout)
        return (dx, dkernel.to(kernel.dtype), None, None, None, None, None,
                None, None)


def face_sharded_cfp_conv(st: FaceStencil, tables, xc, kernel, n_terms, kind,
                          B, group):
    """Fused polynomial graph conv with the face axis sharded over the
    process group ``group``.

    :param tables: :func:`face_shard_tables` of this rank, as tensors on the
        device of ``xc`` (:func:`..ops.stencil.as_tensors`)
    :param xc: (B*Fin, F_loc, n, P_l) local activation shard (b-major
        channels, B = local batch), F_loc = 12 / the group's size
    :param kernel: (Fin*n_terms, Fout), the same on every rank
    :return: (B*Fout, F_loc, n, P_l) local output shard.  The kernel's
        gradient is the whole face group's: summed over the pixel ranks in
        the backward.

    Its device arrays stay float32 in every ``config.conv_dtype`` (K5 and
    the band strips are float32), its K1 and K3 take the mode's band dtype:
    the JAX package's sharded conv casts to float32 and its kernels read
    the band dtype from the config.
    """
    _, kdt, bdt = conv_dtypes(st, xc)
    return _FaceShardedConv.apply(xc.to(kdt).contiguous(), kernel.to(kdt),
                                  st, tables, n_terms, kind, B, group, bdt)


def cface_model_conv(st, tables, x5, kernel, n_terms, kind, cfg):
    """Model-level entry of the face-sharded fused conv.

    :param x5: (B, Fin, F_loc, n, P_l) this rank's activations: its data
        rank's rows, its pixel rank's faces
    :param cfg: :class:`~.sharded_ops.ShardConfig`
    :return: (B, Fout, F_loc, n, P_l)
    """
    S = cfg.n_pixel_shards
    if 12 % S:
        raise ValueError(
            f"face-sharded conv needs a face axis dividing 12, got {S}")
    B, Fin, F_loc, n, P_l = x5.shape
    if F_loc * S != 12:
        raise ValueError(f"{F_loc} local faces on {S} face shards")
    Fout = kernel.shape[-1]
    y = face_sharded_cfp_conv(st, tables, x5.reshape(B * Fin, F_loc, n, P_l),
                              kernel, n_terms, kind, B, cfg.pixel_group)
    return y.reshape(B, Fout, F_loc, n, P_l).to(x5.dtype)
