"""The fused K-term polynomial stencil conv, forward and backward: the
kernels' wrappers, launch plans and plain versions (the kernels themselves
are the custom ops of :mod:`.library`).

Counterpart of the JAX package's ``deepsphere_tpu.ops.pallas_stencil``.
Three kernels over (face, tile) blocks: K1 in its own template
(``csrc/stencil_conv.cuh``) with its own launch plan, :func:`_k1_plan`; K2
and K3 as the two modes of the backward template ``csrc/stencil_bwd.cuh``,
which runs its laps through K1's compile-time-tap lap, planned by
:func:`_bwd_plan`:

* K1, the forward (TPU kernel ``_stencil_kernel``, ``csrc/stencil_conv.cu``,
  :func:`run_stencil_kernel`);
* K2, the fused backward dx + dW (TPU kernel ``_dxdw_kernel``,
  ``csrc/stencil_dxdw.cu``, :func:`run_dxdw_kernel`);
* K3, the dW of the two-kernel backward (TPU kernel ``_grad_kernel``,
  ``csrc/stencil_grad.cu``, :func:`run_grad_kernel`).

The per-step path (:func:`.stencil.stencil_graph_conv`) writes every
Laplacian application to device memory; the fused kernels instead assemble
each tile's halo window on chip, run all K-1 applications there and fold
each term into the contraction (and, backward, into the dW sums) as it is
made, so the activation is read about once per conv.

Layout ("cface"): activations are ``(C, 12, n, P_l)`` channels-first face
images, C = B*F batch-major, face column y at lane ``y + h`` (h the halo
depth, ``P_l = roundup(n + 2h, 128)``); input and output share it.  Cross-
face halos come from three strip arrays (:mod:`.strips`).  The raw kernels
take any number of faces in the face axis (the arrays of a face shard,
``parallel/cface_sharded.py``), with the weight planes of those faces.

The rectangular face extension is incomplete at the 8 polar 3-way corners,
so under multi-step fusion a set of rows near them (``st.corr_out_face``)
comes out wrong; they are recomputed exactly from a precomputed ELLPACK
"ball" around them (:func:`_corrected_rows`) with one flat gather and one
flat scatter (``tables["corr_src_cfp"]`` / ``["corr_rows_cfp"]``).  At the
quick_start widths this is a large share of the map (K=10 at nside 16:
every row), so tests always check the raw kernels as well.

The conv is a ``torch.autograd.Function`` (:func:`fused_stencil_conv_cfp`);
its backward takes the route that ``config.fused_dw`` names.

Precision (``config.conv_dtype``, the JAX package's modes): float32; the
bfloat16 band mode, where K1-K3 and their plain versions round to bfloat16
at the points :func:`_plain_terms` names and keep float32 device arrays;
and the bfloat16 I/O mode, where the conv's own device arrays (activations,
strips, weight planes, output, dy and dx) are bfloat16 too, on the convs
that :func:`cfp_io_available` takes (the band mode on the others).  The
corner correction stays float32 in every mode, as the JAX package's.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..graph.stencil import FaceStencil, stencil_offsets
from .strips import build_strips, strip_arrays

__all__ = [
    "cfp_geometry",
    "cfp_io_available",
    "reextend_weights",
    "strip_rows",
    "cfp_structural_available",
    "cface_route",
    "staged_bytes",
    "conv_dtypes",
    "chain_refused",
    "run_stencil_kernel",
    "run_stencil_plain",
    "run_grad_kernel",
    "run_grad_plain",
    "run_dxdw_kernel",
    "run_dxdw_plain",
    "fused_stencil_conv_cfp",
    "fused_stencil_conv_cfp_plain",
]

# the dynamic shared-memory ceiling of a block (an H100 block gets 227 KB;
# the kernels' static arrays take the rest)
_SMEM_MAX = 232448 - 1024
# an SM's shared memory (an H100 SM's 228 KB; each block reserves 1 KB)
_SMEM_SM = 233472


# K1's own launch plan (``csrc/stencil_conv.cu``): its lap points per
# thread (kRun) and the input channels whose laps run together at each
# radius (the kernel's GMAX)
_K1_RUN = 4
_K1_GMAX = {1: 4, 2: 2, 3: 1, 4: 1}


class Plan(NamedTuple):
    """One launch of K1, K2 or K3: tile side ``T``, channels per lap group
    ``G`` (K1's input channels, K2's and K3's recursion channels), batch
    indices per block ``GB``, output or fold channels per block ``FC``,
    dynamic shared bytes and the grid (256 threads a block)."""

    T: int
    G: int
    GB: int
    FC: int
    smem: int
    grid: tuple


def _k1_smem(T, h, r, nplanes, K, G, FC, es=4):
    """Dynamic shared bytes of one K1 block: two slots of the group's
    channel kernel (float32), the interleaved weight window (padded to 4
    elements) and 2 x G halo-window buffers (rows padded to 4 elements,
    and kRun - 1 rows of slack for the last run), of ``es`` bytes an
    element: 4, or 2 for the bfloat16 kernels, which stage bfloat16."""
    W0 = T + 2 * h
    Ww = W0 - 2 * r
    return (4 * 2 * K * G * FC
            + es * (_round_up((Ww + _K1_RUN - 1) * Ww * nplanes, 4)
                    + 2 * G * (W0 + _K1_RUN - 1) * _round_up(W0, 4)))


def _k1_bf16_staging(plan, h, r, nplanes, K):
    """Bytes a bfloat16 K1 launch on ``plan`` (its 2-byte plan, which
    :func:`_k1_plan` gives with ``es=2``) holds each staged value in: 4
    where the float32 kernel's shared bytes fit at the plan's tile, lap
    group and output channels (bfloat16 values in float32 shared memory,
    staged with cp.async as the float32 kernel), else 2 (K1's 2-byte body,
    bfloat16 shared elements, several batch indices' windows a lap: its
    window sets and bytes are ``csrc/stencil_conv_s2.h``'s).  The same
    function bit for bit;
    chosen from the shape before the launch, by the same rule as
    ``csrc/stencil_conv.cu``, so the route and the plan are those of the
    2-byte plan in every case."""
    return (4 if _k1_smem(plan.T, h, r, nplanes, K, plan.G, plan.FC, 4)
            <= _SMEM_MAX else 2)


def _batch_group(blocks, B, sms):
    """Batch indices per block: the most that keep two blocks per SM, on a
    card of ``sms`` SMs, in a grid of ``blocks`` blocks per batch group (1
    where none does)."""
    return max([b for b in range(1, B + 1) if blocks * -(-B // b) >= 2 * sms]
               or [1])


def _k1_plan(n, h, r, nplanes, K, B, F, Fin, Fout, sms, es=4):
    """K1's launch plan on a card of ``sms`` SMs, or None where the kernel
    does not take the shape (``es``: bytes of a staged element,
    :func:`_k1_smem`).

    The largest tile side (32, 16 or 8, dividing n) whose window fits
    shared memory; on it the largest lap group G (a power of two up to
    ``_K1_GMAX[r]`` dividing Fin) that fits; FC the smallest of 4, 8, 16,
    32 that holds Fout (at most 16 on a 32-tile, whose threads hold 4
    pixels x FC sums); GB the most batch indices per block that keep two
    blocks per SM in the grid.  Each rule was the fastest, or within 10% of
    it, at the four phase-3 shapes of ``chip_smoke.py`` on an H100
    (PERF.md)."""
    if (r not in _K1_GMAX or nplanes != (2 * r + 1) ** 2 or K < 1
            or r * (K - 1) > h or not 1 <= F <= 12 or min(B, Fin, Fout) < 1):
        return None
    for t in (32, 16, 8):
        if n % t or (t == 32 and r > 2):
            continue
        cap = 16 if t == 32 else 32
        fc = next(c for c in (4, 8, 16, 32) if c >= min(Fout, cap))
        for g in (g for g in (4, 2, 1) if g <= _K1_GMAX[r] and Fin % g == 0):
            smem = _k1_smem(t, h, r, nplanes, K, g, fc, es)
            if smem > _SMEM_MAX:
                continue
            chunks = -(-Fout // fc)
            gb = _batch_group(F * (n // t) ** 2 * chunks, B, sms)
            gz = -(-B // gb) * chunks
            if gz > 65535:
                return None
            return Plan(t, g, gb, fc, smem, ((n // t) ** 2, F, gz))
    return None


# warps per block of the backward kernels: the dW sums of one term are
# reduced over each warp, then over the warps in shared memory
_BWD_WARPS = 8


def _bwd_smem(T, h, r, nplanes, K, G, FC, Crec, dx, es=4):
    """Dynamic shared bytes of one K2 (``dx``) or K3 block: K1's weight
    window and 2 x G halo-window buffers (``es`` bytes an element, as
    :func:`_k1_smem`), and in float32 two slots of the group's channel
    kernel (K2 only), two slots of the warps' dW sums of one term, and the
    block's K x Crec x FC dW cells."""
    W0 = T + 2 * h
    Ww = W0 - 2 * r
    return (4 * ((2 * K * G * FC if dx else 0)
                 + 2 * _BWD_WARPS * G * FC + K * Crec * FC)
            + es * (_round_up((Ww + _K1_RUN - 1) * Ww * nplanes, 4)
                    + 2 * G * (W0 + _K1_RUN - 1) * _round_up(W0, 4)))


def _bwd_blocks(plan, r, dx, smem):
    """Blocks of K2 (``dx``) or K3 an SM holds on ``plan`` at ``smem``
    dynamic shared bytes: the fewer of what its launch bounds leave the
    registers (2 where a thread's dx sums and fold operand, PP x FC each,
    PP = 4 pixels a thread on a 32-tile, fit 128 registers, else 1) and
    what ``_SMEM_SM`` allows at 1 KB reserved a block."""
    pp = 4 if plan.T == 32 and r <= 2 else 1
    by_regs = 2 if (2 if dx else 1) * pp * plan.FC <= 32 else 1
    return min(by_regs, _SMEM_SM // (smem + 1024))


def _bwd_bf16_staging(plan, h, r, nplanes, K, Crec, dx):
    """Bytes a bfloat16 K2 (``dx``) or K3 launch on ``plan`` (its 2-byte
    plan, which :func:`_bwd_plan` gives with ``es=2``) holds each staged
    value in: 4 (bfloat16 values in float32 shared memory, staged with
    cp.async as the float32 kernel) where the float32 kernel's shared bytes
    fit at the plan's tile, lap group and fold channels and keep the blocks
    an SM holds at 2 bytes (:func:`_bwd_blocks`), else 2 (the 2-byte
    kernel: bfloat16 shared elements, several batch indices' windows a lap
    where they keep those blocks; its window sets and bytes are
    ``csrc/stencil_bwd_s2.h``'s).  K2 at quick_start's conv 1,
    whose float32 bytes leave room for one block an SM where 2 bytes hold
    two, ran 17% slower staged in float32 on an H100 (PERF.md).  The same
    function bit for bit; chosen from the shape before the launch and
    passed to the C entry points (``csrc/stencil_bwd.cuh::launch_bwd``
    only checks that the bytes fit), so the route and the plan are those
    of the 2-byte plan in every case."""
    s2, s4 = (_bwd_smem(plan.T, h, r, nplanes, K, plan.G, plan.FC, Crec, dx,
                        es) for es in (2, 4))
    return (4 if s4 <= _SMEM_MAX and _bwd_blocks(plan, r, dx, s4)
            >= _bwd_blocks(plan, r, dx, s2) else 2)


def _bwd_plan(n, h, r, nplanes, K, B, F, Crec, Cch, dx, sms, es=4):
    """The launch plan of K2 (``dx``: recursion over Crec = Fout channels,
    Cch = Fin fold channels) or K3 (Crec = Fin, Cch = Fout) on a card of
    ``sms`` SMs, or None where the kernels do not take the shape (``es``:
    bytes of a staged element, :func:`_bwd_smem`).

    FC the smallest of 4, 8, 16, 32 that holds Cch (at most 8 on a 32-tile,
    whose threads hold 4 pixels x FC fold values, and K2's as many dx
    sums); the tile the largest (32, 16 or 8, dividing n) on which one
    chunk of FC holds every fold channel, else the largest; on it the
    largest lap group G (up to ``_K1_GMAX[r]``, dividing Crec) that fits
    shared memory; GB the most batch indices per block that keep two
    blocks per SM in the grid.  Measured on an H100 at the four phase-3
    shapes of ``chip_smoke.py`` (PERF.md)."""
    if (r not in _K1_GMAX or nplanes != (2 * r + 1) ** 2 or K < 1
            or r * (K - 1) > h or not 1 <= F <= 12
            or min(B, Crec, Cch) < 1):
        return None
    plans = []
    for t in (32, 16, 8):
        if n % t or (t == 32 and r > 2):
            continue
        fc = next(c for c in (4, 8, 16, 32)
                  if c >= min(Cch, 8 if t == 32 else 32))
        for g in (g for g in (4, 2, 1) if g <= _K1_GMAX[r] and Crec % g == 0):
            smem = _bwd_smem(t, h, r, nplanes, K, g, fc, Crec, dx, es)
            if smem > _SMEM_MAX:
                continue
            chunks = -(-Cch // fc)
            gb = _batch_group(F * (n // t) ** 2 * chunks, B, sms)
            gz = -(-B // gb) * chunks
            if gz <= 65535:
                plans.append(Plan(t, g, gb, fc, smem, ((n // t) ** 2, F, gz)))
            break
    one = [p for p in plans if p.FC >= Cch]
    return (one or plans or [None])[0]


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


def cface_route(st: FaceStencil, kind, n_terms, B, Fin, Fout, sms,
                grad=True):
    """The route of the unsharded cface conv of a CUDA input on a card of
    ``sms`` SMs, from the shape alone, before any launch.

    ``"fused"`` where the kernels take every launch the conv makes: K1
    forward and, with ``grad`` (autograd will differentiate the conv), every
    launch of its backward on either ``config.fused_dw`` route (K2; K1 on dy
    with the channels swapped, and K3).  ``"per_step"``, the per-step face
    path through the interior slice, only where the JAX package runs no
    kernel either: where ``cfp_structural_available`` fails, or at radius
    >= 3 with n_terms > 2 (its compile-mode gate) and a plan is refused.
    ``"chain"`` at radius <= 2 where a one-shot plan is refused but the
    lap chain's are (:func:`chain_refused`): one L~ application per launch
    on the shallow stencil (h = radius, K = 2, Fin -> Fin), which never
    builds the deep window.  A shape both refuse raises.

    The plans are those of the precision in force (``config.conv_dtype``:
    the bfloat16 kernels stage 2-byte elements).  The JAX gate's other
    declines route around TPU compiler faults and have no counterpart here
    (``config``): h > 8 and not a multiple of 8 (its ``deep_stencil``
    rounds such depths up; the port keeps exact depths, h = 9 at
    quick_start, which the kernels take), and a dot-form contraction below
    ``dot_fused_min_nside``."""
    if not cfp_structural_available(st, kind, n_terms):
        return "per_step"
    return _cface_route(st.nside, st.n_steps, st.radius, len(st.offsets),
                        n_terms, B, Fin, Fout, sms, bool(grad),
                        staged_bytes())


def staged_bytes():
    """Bytes of an element the kernels stage in shared memory under
    ``config.conv_dtype``: 4 in float32, 2 in either bfloat16 mode."""
    return 4 if config.conv_dtype == "float32" else 2


def _refused(n, h, r, nplanes, K, B, Fin, Fout, sms, grad, es=4):
    """Names of the kernels of a conv's launches (K1 forward; with
    ``grad`` K2, K1 on dy and K3) whose plan does not take the shape, with
    ``es`` bytes a staged element."""
    shape = (n, h, r, nplanes, K, B, 12)
    plans = {"K1": _k1_plan(*shape, Fin, Fout, sms, es)}
    if grad:
        plans["K2"] = _bwd_plan(*shape, Fout, Fin, True, sms, es)
        plans["K1 on dy"] = _k1_plan(*shape, Fout, Fin, sms, es)
        plans["K3"] = _bwd_plan(*shape, Fin, Fout, False, sms, es)
    return [name for name, plan in plans.items() if plan is None]


def chain_refused(n, r, nplanes, B, C, sms, grad=True, es=4):
    """The kernels whose plan does not take a lap of the lap chain
    (:func:`.stencil.lap_chain_conv`): one application on the shallow
    stencil (h = r, K = 2) over B x C channels in and out.  Empty where
    the chain runs on the card."""
    return _refused(n, r, r, nplanes, 2, B, C, C, sms, grad, es)


@functools.lru_cache(maxsize=None)
def _cface_route(n, h, r, nplanes, K, B, Fin, Fout, sms, grad, es=4):
    """:func:`cface_route` past the structural check, memoised on the ints
    of the shape (it runs at every forward)."""
    refused = _refused(n, h, r, nplanes, K, B, Fin, Fout, sms, grad, es)
    if not refused:
        return "fused"
    if r >= 3 and K > 2:
        return "per_step"
    chain = chain_refused(n, r, nplanes, B, Fin, sms, grad, es)
    if not chain:
        return "chain"
    raise ValueError(
        f"cface conv: no plan of {', '.join(refused)} takes n={n} h={h} "
        f"r={r} K={K} B={B} Fin={Fin} Fout={Fout} on {sms} SMs, and no plan "
        f"of {', '.join(chain)} takes its lap chain (h={r}, {Fin} -> {Fin}): "
        "no tile fits shared memory or the grid")


def cfp_geometry(n, h):
    """(R, P_l) of the cface layout: R = roundup(h, 8) rows of the row-halo
    strips, P_l = roundup(n + 2h, 128) lanes (face col y at lane y + h)."""
    return _round_up(h, 8), _round_up(n + 2 * h, 128)


def strip_rows(h, dtype):
    """Rows R of the row-halo strips and of each margin of the weight
    planes for device arrays of ``dtype``: roundup(h, 8) in float32,
    roundup(h, 16) in bfloat16 (the JAX package's bf16 layout; its
    ``weights_bf16`` planes are R16-extended)."""
    return _round_up(h, 16 if dtype == torch.bfloat16 else 8)


def cfp_io_available(st: FaceStencil):
    """Whether this conv keeps its device arrays in bfloat16 under
    ``config.conv_dtype == "bfloat16_io"``: n % 16 == 0 and n >= roundup(h,
    16), the JAX package's gate (``pallas_stencil.cfp_io_available``).

    The 16-row alignment is a TPU rule (a bf16 DMA row slice is 16-row
    aligned); the kernels here need none.  It is kept because it decides
    which convs' activations and outputs are rounded to bfloat16, and so
    the numbers: both packages round the same convs."""
    h = st.n_steps
    return st.nside % 16 == 0 and st.nside >= _round_up(h, 16)


def _io_dtype(st):
    """The dtype of this conv's device arrays under ``config.conv_dtype``:
    bfloat16 where the mode asks for it and :func:`cfp_io_available`."""
    iodt = config.conv_io_dtype()
    if iodt == torch.bfloat16 and not cfp_io_available(st):
        return torch.float32
    return iodt


def reextend_weights(w, n, R0, R1):
    """Wrapped-extended weight planes (T2, F, n + 2 R0, P) with margin R0
    -> the (T2, F, n + 2 R1, P) layout of a wider margin R1 (the bfloat16
    layout, R1 = roundup(h, 16)); the new margin rows are zeros.  A numpy
    array or a torch tensor."""
    if R1 == R0:
        return w
    if R1 < R0:
        raise ValueError(f"margin {R1} < {R0}")
    parts = [w[:, :, 0:n], None, w[:, :, n : n + R0],
             w[:, :, n + R0 : n + 2 * R0], None]
    shape = tuple(w.shape[:2]) + (R1 - R0, w.shape[3])
    if isinstance(w, torch.Tensor):
        parts[1] = parts[4] = w.new_zeros(shape)
        return torch.cat(parts, dim=2)
    parts[1] = parts[4] = np.zeros(shape, dtype=w.dtype)
    return np.concatenate(parts, axis=2)


def _io_weights(st, tables, iodt):
    """The weight planes in the conv's device dtype: ``tables["weights"]``
    in float32; in bfloat16 ``tables["weights_bf16"]``
    (``stencil_tables(st, bf16_io=True)``), or, where the table lacks it,
    the float32 planes re-extended and rounded here (the same bits)."""
    if iodt != torch.bfloat16:
        return tables["weights"]
    w16 = tables.get("weights_bf16")
    if w16 is not None:
        return w16.to(torch.bfloat16)
    h = st.n_steps
    return reextend_weights(tables["weights"], st.nside, _round_up(h, 8),
                            _round_up(h, 16)).to(torch.bfloat16)


def _strip_index(tables, dtype):
    """The device copy of the strip source map for arrays of ``dtype``
    (``strip_idx``, or ``strip_idx_bf16`` for bfloat16), or None."""
    return tables.get("strip_idx_bf16" if dtype == torch.bfloat16
                      else "strip_idx")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _plain_dtype(t):
    """The dtype a plain version computes in: float32 for bfloat16 arrays
    (the kernels' sums), else the arrays' own (float64 on the CPU for
    gradient checks)."""
    return torch.float32 if t.dtype == torch.bfloat16 else t.dtype


def _rounding(bdt):
    """The band dtype's rounding: to bfloat16 and back for "bfloat16",
    none for "float32"."""
    if bdt == "bfloat16":
        return lambda t: t.to(torch.bfloat16).to(t.dtype)
    if bdt != "float32":
        raise ValueError(f"band dtype must be float32 or bfloat16, got {bdt}")
    return lambda t: t


def _window(st, xc, wext, strips, rnd):
    """The halo-extended maps of the plain version, in its compute dtype
    and rounded by ``rnd``: activation (C, 12, n+2R, P_l) and weight planes
    (T2, 12, n+2R, P_l), window row w holding face row w - R, R the strips'
    rows (:func:`strip_rows`), and R."""
    n, h = st.nside, st.n_steps
    top, bot, ls = strips
    R = top.shape[2]
    if wext.shape[2] != n + 2 * R:
        raise ValueError(f"weight planes of {wext.shape[2]} rows do not "
                         f"match strips of {R} rows at n={n}")
    cdt = _plain_dtype(xc)
    mid = xc.clone()
    mid[..., 0:h] = ls[..., 0:h]
    mid[..., h + n : 2 * h + n] = ls[..., h : 2 * h]
    win = torch.cat([top, mid, bot], dim=2).to(cdt)
    ww = torch.cat([wext[:, :, n : n + R], wext[:, :, 0:n],
                    wext[:, :, n + R : n + 2 * R]], dim=2)
    return rnd(win), rnd(ww.to(cdt)), R


def _plain_terms(st, kind, n_terms, xc, wext, strips, bdt="float32"):
    """Yield the K recursion terms T_k(L~) xc at the face rows, (C, 12, n,
    P_l) each: the padded-window recursion with ``torch.roll`` taps over
    each face's halo-extended map.  Roll wrap-around only reaches the
    window border, r rows/lanes per step, never the interior lanes.

    Under the band dtype "bfloat16" the plain versions and the kernels
    (``csrc/stencil_conv.cuh``, ``stencil_bwd.cuh``) round at the same
    points, as the JAX package's bf16 kernels cast (``x0 =
    xw.astype(bdt)``):

    * the halo window and the weight planes are rounded to bfloat16 once
      (exact where they are bfloat16 already, in the I/O mode);
    * each lap sums its taps in float32, and the term it stores is
      rounded to bfloat16;
    * a Chebyshev term 2 L~T_{k-1} - T_{k-2} is formed in float32 from
      the lap's float32 sum and rounded once;
    * the contraction multiplies the bfloat16 terms by the channel kernel
      rounded to bfloat16 and accumulates in float32 (the products are
      exact in float32);
    * dW multiplies the terms by the other operand rounded to bfloat16
      (x, or dy), accumulating in float32, as the JAX kernels' bf16 dots;
    * the output is float32 in the band mode, rounded to bfloat16 where
      the arrays are bfloat16 (the I/O mode).

    The kernels sum the same values in other orders, so a term may differ
    from the plain version's by one bfloat16 step."""
    if kind not in ("cheby", "mono"):
        raise ValueError(f"unknown basis kind: {kind}")
    n = st.nside
    rnd = _rounding(bdt)
    win, ww, R = _window(st, xc, wext, strips, rnd)
    offs = st.offsets

    def lap(p):
        t = None
        for d, (dx, dy) in enumerate(offs):
            c = ww[d] * torch.roll(p, shifts=(-dx, -dy), dims=(2, 3))
            t = c if t is None else t + c
        return t

    prev2, prev1 = None, win
    for k in range(n_terms):
        if k == 0:
            t = win
        elif k == 1 or kind == "mono":
            t = rnd(lap(prev1))
        else:
            t = rnd(2.0 * lap(prev1) - prev2)
        if k:
            prev2, prev1 = prev1, t
        yield t[:, :, R : R + n]


def _zero_pad_lanes(y, h, n):
    y[..., :h] = 0.0
    y[..., h + n :] = 0.0
    return y


def run_stencil_plain(st, kind, n_terms, xc, wext, strips, wk3, B,
                      bdt="float32"):
    """Plain version of the raw fused conv (no corner correction); same
    contract as :func:`run_stencil_kernel`."""
    n, h = st.nside, st.n_steps
    _, P_l = cfp_geometry(n, h)
    K, Fin, Fout = wk3.shape
    F = xc.shape[1]
    cdt = _plain_dtype(xc)
    wk = _rounding(bdt)(wk3.to(cdt))
    y = xc.new_zeros((B, Fout, F, n, P_l), dtype=cdt)
    for k, ctr in enumerate(_plain_terms(st, kind, n_terms, xc, wext,
                                         strips, bdt)):
        y = y + torch.einsum("bfgxp,fo->bogxp",
                             ctr.reshape(B, Fin, F, n, P_l), wk[k])
    return _zero_pad_lanes(y, h, n).reshape(B * Fout, F, n, P_l).to(xc.dtype)


def run_grad_plain(st, kind, n_terms, xc, wext, strips, dy, B,
                   bdt="float32"):
    """Plain version of the raw dW of the two-kernel backward; same
    contract as :func:`run_grad_kernel`."""
    n, h = st.nside, st.n_steps
    Fin = xc.shape[0] // B
    Fout = dy.shape[0] // B
    F = xc.shape[1]
    dyi = _rounding(bdt)(dy[..., h : h + n].to(_plain_dtype(xc)))
    dyi = dyi.reshape(B, Fout, F, n, n)
    dw = [
        torch.einsum("bfgxy,bogxy->fo",
                     ctr[..., h : h + n].reshape(B, Fin, F, n, n), dyi)
        for ctr in _plain_terms(st, kind, n_terms, xc, wext, strips, bdt)
    ]
    return torch.stack(dw).reshape(n_terms * Fin, Fout)


def run_dxdw_plain(st, kind, n_terms, dy, wext, strips, wk3t, xr, mask, B,
                   bdt="float32"):
    """Plain version of the raw fused backward; same contract as
    :func:`run_dxdw_kernel`."""
    n, h = st.nside, st.n_steps
    _, P_l = cfp_geometry(n, h)
    K, Fc, Fx = wk3t.shape  # recursion channels Fout, x channels Fin
    F = dy.shape[1]
    cdt = _plain_dtype(dy)
    rnd = _rounding(bdt)
    xm = xr[..., h : h + n].to(cdt)
    if mask is not None:
        xm = xm * mask[..., h : h + n].to(cdt)
    xm = rnd(xm).reshape(B, Fx, F, n, n)
    wk = rnd(wk3t.to(cdt))
    dx = dy.new_zeros((B, Fx, F, n, P_l), dtype=cdt)
    dws = []
    for k, ctr in enumerate(_plain_terms(st, kind, n_terms, dy, wext,
                                         strips, bdt)):
        c5 = ctr.reshape(B, Fc, F, n, P_l)
        dx = dx + torch.einsum("bfgxp,fo->bogxp", c5, wk[k])
        dws.append(torch.einsum("bogxy,bfgxy->of", xm, c5[..., h : h + n]))
    dx = _zero_pad_lanes(dx, h, n).reshape(B * Fx, F, n, P_l).to(dy.dtype)
    return dx, torch.stack(dws).reshape(K * Fx, Fc)


# ---------------------------------------------------------------------------
# the kernels, through their custom ops (``library.py``)
# ---------------------------------------------------------------------------


def _check_stencil(what, st, kind, t):
    """The wrappers' checks on the stencil: the kernels compile their taps
    in the order of :func:`..graph.stencil.stencil_offsets`, take the
    Chebyshev and monomial bases, and run on the CPU or a CUDA card."""
    from .library import check_device

    if list(st.offsets) != stencil_offsets(st.radius):
        raise ValueError(f"{what}: its taps are compiled in the order of "
                         f"stencil_offsets({st.radius}), not {st.offsets}")
    if kind not in ("cheby", "mono"):
        raise ValueError(f"unknown basis kind: {kind}")
    check_device(what, t)


def run_stencil_kernel(st, kind, n_terms, xc, wext, strips, wk3, B,
                       bdt="float32"):
    """The raw fused conv (before the corner correction), through the
    ``stencil_conv`` op: K1 for a CUDA tensor, :func:`run_stencil_plain`
    for a CPU tensor.

    ``bdt``: the band dtype, "float32" or "bfloat16" (the rounding points
    of :func:`_plain_terms`).  The device arrays (``xc``, ``wext``, the
    strips and the output) are all float32, or all bfloat16 (the I/O
    mode, ``bdt`` "bfloat16"; ``wext`` with R16 margins,
    :func:`strip_rows`); ``wk3`` is float32.

    :param xc: (B*Fin, F, n, P_l) activations (interior lanes read), F the
        faces of the arrays (12, or a face shard's)
    :param wext: (T2, F, n+2R, P_l) wrapped-extended weight planes
        (``FaceStencil.weights``, of the same faces)
    :param strips: (top, bot, ls) halo strips of ``xc``
    :param wk3: (K, Fin, Fout) channel kernel per term; the kernel's taps
        are compile-time, so ``st.offsets`` must be
        :func:`..graph.stencil.stencil_offsets` of its radius
    :return: (B*Fout, F, n, P_l), 0 outside the interior lanes; exact at
        every interior row whose K-1-step neighbourhood lies in the
        rectangular face extension
    """
    if wk3.shape[0] != n_terms:
        raise ValueError(f"wk3 has {wk3.shape[0]} terms, expected {n_terms}")
    _check_stencil("stencil conv", st, kind, xc)
    return torch.ops.deepsphere.stencil_conv(
        xc, *strips, wext, wk3, st.nside, st.n_steps, st.radius, B, kind, bdt)


def run_grad_kernel(st, kind, n_terms, xc, wext, strips, dy, B,
                    bdt="float32"):
    """The raw dW of the two-kernel backward, through the ``stencil_grad``
    op: K3 for a CUDA tensor, :func:`run_grad_plain` for a CPU tensor
    (``bdt`` and the device arrays' dtypes as :func:`run_stencil_kernel`'s;
    dW is float32).

    dW[k, fi, fo] = sum_b sum of T_k(L~) x[b, fi] * dy[b, fo] over the
    interior lanes, the recursion run on ``xc`` through its strips.  The
    caller has zeroed dy's corrupt rows; dy's halo lanes are never read.

    :param xc: (B*Fin, F, n, P_l) forward input (F faces, as K1's)
    :param strips: (top, bot, ls) halo strips of ``xc``
    :param dy: (B*Fout, F, n, P_l) cotangent of the conv output
    :return: (K*Fin, Fout) float, Fin-major per term (k-major rows).  The
        kernel's taps are compile-time, so ``st.offsets`` must be
        :func:`..graph.stencil.stencil_offsets` of its radius
    """
    _check_stencil("grad kernel", st, kind, xc)
    return torch.ops.deepsphere.stencil_grad(
        xc, *strips, wext, dy, st.nside, st.n_steps, st.radius, n_terms, B,
        kind, bdt)


def run_dxdw_kernel(st, kind, n_terms, dy, wext, strips, wk3t, xr, mask, B,
                    bdt="float32"):
    """The raw fused backward, through the ``stencil_dxdw`` op: K2 for a
    CUDA tensor, :func:`run_dxdw_plain` for a CPU tensor; dx and dW in one
    pass over dy (``bdt`` and the device arrays' dtypes as
    :func:`run_stencil_kernel`'s, ``xr`` among them; ``mask`` and dW are
    float32).

    Channel roles are the forward's swapped: the recursion runs on ``dy``
    through its strips, with ``wk3t`` = (K, Fout, Fin).  L~ is symmetric,
    so dW[k] = <T_k(L~) x, dy> = <x, T_k(L~) dy>, over the terms the dx pass
    already makes.

    :param dy: (B*Fout, F, n, P_l) cotangent (interior lanes read), F
        faces as K1's
    :param strips: (top, bot, ls) halo strips of ``dy``
    :param wk3t: (K, Fout, Fin) transposed channel kernel per term
    :param xr: (B*Fin, F, n, P_l) forward input (interior lanes read)
    :param mask: (F, n, P_l) plane multiplied into x at the interior lanes
        (``tables["corr_mask"]``: 0 at the corrupt rows), or None
    :return: ``(dx, dW)``: dx (B*Fin, F, n, P_l) = sum_k T_k(L~) dy W_k^T,
        0 outside the interior lanes and wrong at the corrupt rows, as the
        forward's y; dW (K*Fin, Fout) in the forward's orientation.  The
        kernel's taps are compile-time, as K1's
    """
    if wk3t.shape[0] != n_terms:
        raise ValueError(f"wk3t has {wk3t.shape[0]} terms, expected {n_terms}")
    _check_stencil("dxdw kernel", st, kind, dy)
    return torch.ops.deepsphere.stencil_dxdw(
        dy, *strips, wext, wk3t, xr, mask, st.nside, st.n_steps, st.radius,
        B, kind, bdt)


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


def _ball_src(tables, a):
    """The correction ball's source rows of ``a`` (C, 12, n, P_l), (Bn, C),
    with one flat gather."""
    return _gather_rows(a, tables["corr_src_cfp"])


def _ball_terms(tables, t, n_terms, kind):
    """Exact per-term basis values over the correction ball, (Bn, C) each,
    from its source rows ``t`` (Bn, C); bfloat16 rows are taken to float32
    first, so the correction is float32 in every mode (as the JAX
    package's ``_ball_terms``)."""
    t = t.to(_plain_dtype(t))
    idx = tables["corr_idx"]
    val = tables["corr_val"].to(t.dtype)
    yield t
    prev2, prev1 = None, t
    for k in range(1, n_terms):
        tk = _ball_spmv(idx, val, prev1)
        if kind == "cheby" and k >= 2:
            tk = 2.0 * tk - prev2
        yield tk
        prev2, prev1 = prev1, tk


def _corrected_rows(tables, t, wk3, n_terms, kind, B):
    """Exact conv outputs at the corrupt rows, (Rc, B*Fout), from the
    ball's source rows ``t``."""
    out_rows = tables["corr_out_ball"]
    K, Fin, Fout = wk3.shape
    acc = None
    for k, tk in enumerate(_ball_terms(tables, t, n_terms, kind)):
        d = torch.einsum("rbf,fo->rbo", tk[out_rows].reshape(-1, B, Fin),
                         wk3[k]).reshape(-1, B * Fout)
        acc = d if acc is None else acc + d
    return acc


def _basis_at_rows(tables, t, n_terms, kind):
    """Exact per-term basis values at the corrupt rows, (K, Rc, C), from
    the ball's source rows ``t``."""
    out_rows = tables["corr_out_ball"]
    return torch.stack([tk[out_rows] for tk in
                        _ball_terms(tables, t, n_terms, kind)])


def _gather_rows(a, rows):
    """(C, 12, n, P_l) at flat cface rows ``rows`` -> (len(rows), C), one
    gather."""
    return a.reshape(a.shape[0], -1)[:, rows].t()


def _patch_rows(y, rows, y_fix):
    """Overwrite the rows ``rows`` of y (C, 12, n, P_l) with ``y_fix``
    (len(rows), C), one scatter (in place)."""
    y.reshape(y.shape[0], -1)[:, rows] = y_fix.t().to(y.dtype)
    return y


def _forward_cfp(st, tables, xc, wk3, n_terms, kind, B, strips, conv_fn,
                 bdt="float32"):
    """The raw conv ``conv_fn`` (a kernel's wrapper or its plain version)
    on the weight planes of ``xc``'s dtype, then the corner correction;
    the output in ``xc``'s dtype."""
    y = conv_fn(st, kind, n_terms, xc, _io_weights(st, tables, xc.dtype),
                strips, wk3, B, bdt)
    if "corr_rows_cfp" in tables:
        y_fix = _corrected_rows(tables, _ball_src(tables, xc), wk3, n_terms,
                                kind, B)
        y = _patch_rows(y, tables["corr_rows_cfp"], y_fix)
    return y


def _wk3(kernel, n_terms):
    """(Fin*K, Fout) Fin-major kernel -> (K, Fin, Fout)."""
    Fin = kernel.shape[0] // n_terms
    return kernel.reshape(Fin, n_terms, -1).permute(1, 0, 2).contiguous()


def _wk3t(kernel, n_terms):
    """(Fin*K, Fout) Fin-major kernel -> (K, Fout, Fin), the dx pass's."""
    Fin = kernel.shape[0] // n_terms
    return kernel.reshape(Fin, n_terms, -1).permute(1, 2, 0).contiguous()


class _FusedConv(torch.autograd.Function):
    """Strips, then K1, then the correction; backward on the
    ``config.fused_dw`` route (the JAX package's custom VJP without its
    TPU routing).  ``xc`` arrives in the conv's device dtype (float32,
    bfloat16 or, on the CPU, float64), ``bdt`` names the band dtype."""

    @staticmethod
    def forward(ctx, xc, kernel, st, tables, n_terms, kind, B, bdt):
        strips = build_strips(st, xc, _strip_index(tables, xc.dtype))
        y = _forward_cfp(st, tables, xc, _wk3(kernel, n_terms), n_terms, kind,
                         B, strips, run_stencil_kernel, bdt)
        # the fused backward rebuilds its strips from dy: keep x's only for
        # the two-kernel backward's K3 (none for a constant kernel)
        keep = not config.fused_dw and kernel.requires_grad
        ctx.save_for_backward(xc, kernel, *(strips if keep else ()))
        ctx.meta = (st, tables, n_terms, kind, B, bdt)
        return y

    @staticmethod
    def backward(ctx, dy):
        st, tables, K, kind, B, bdt = ctx.meta
        xc, kernel, *strips = ctx.saved_tensors
        dy = dy.to(xc.dtype).contiguous()
        Fin = xc.shape[0] // B
        Fout = kernel.shape[-1]
        need_dx = ctx.needs_input_grad[0]
        has_corr = "corr_rows_cfp" in tables
        rows = tables.get("corr_rows_cfp")
        wext = _io_weights(st, tables, xc.dtype)
        index = _strip_index(tables, xc.dtype)
        wk3t = _wk3t(kernel, K)
        dx = None
        if config.fused_dw:
            # one pass over dy: dx, and dW at every row but the corrupt
            # ones (x is zeroed there by the mask), whose exact terms
            # <x, T_k(L~) dy> come from the ball
            dy_strips = build_strips(st, dy, index)
            dx, dw = run_dxdw_kernel(st, kind, K, dy, wext, dy_strips, wk3t,
                                     xc, tables.get("corr_mask"), B, bdt)
            dwk = dw.reshape(K, Fin, Fout)
            if has_corr:
                if need_dx:
                    dx = _patch_rows(dx, rows, _corrected_rows(
                        tables, _ball_src(tables, dy), wk3t, K, kind, B))
                tdy = _basis_at_rows(tables, _ball_src(tables, dy), K, kind)
                x_rc = _gather_rows(xc, rows).to(tdy.dtype)
                dwk = dwk + torch.einsum(
                    "rbf,krbo->kfo", x_rc.reshape(-1, B, Fin),
                    tdy.reshape(K, -1, B, Fout))
        else:
            # dx: the patched conv is the exact symmetric operator, so its
            # adjoint is the same conv with the transposed channel kernel
            if need_dx:
                dx = _forward_cfp(st, tables, dy, wk3t, K, kind, B,
                                  build_strips(st, dy, index),
                                  run_stencil_kernel, bdt)
            if not ctx.needs_input_grad[1]:
                # a constant kernel (the lap chain's term selector): no K3
                return dx, None, None, None, None, None, None, None
            if not strips:  # fused_dw was switched on between fwd and bwd
                strips = build_strips(st, xc, index)
            dy_clean = dy * tables["corr_mask"].to(dy.dtype) if has_corr else dy
            dwk = run_grad_kernel(st, kind, K, xc, wext, tuple(strips),
                                  dy_clean, B, bdt).reshape(K, Fin, Fout)
            if has_corr:
                basis = _basis_at_rows(tables, _ball_src(tables, xc), K,
                                       kind)
                dy_rc = _gather_rows(dy, rows).to(basis.dtype)
                dwk = dwk + torch.einsum(
                    "krbf,rbo->kfo", basis.reshape(K, -1, B, Fin),
                    dy_rc.reshape(-1, B, Fout))
        dkernel = dwk.permute(1, 0, 2).reshape(Fin * K, Fout)
        return (dx if need_dx else None, dkernel.to(kernel.dtype), None, None,
                None, None, None, None)


def conv_dtypes(st, xc):
    """The precision of the fused conv of ``xc`` under
    ``config.conv_dtype``: ``(io, kernel, bdt)``, the dtype of its device
    arrays, that of its channel kernel and the band dtype's name.

    float64 on the CPU where the input is float64 (gradient checks; every
    mode then computes in float64, unrounded); else float32 arrays, or
    bfloat16 arrays in the I/O mode where :func:`cfp_io_available`; a
    float32 channel kernel; "bfloat16" in either bf16 mode."""
    if xc.dtype == torch.float64:
        return torch.float64, torch.float64, "float32"
    bdt = "float32" if config.conv_dtype == "float32" else "bfloat16"
    return _io_dtype(st), torch.float32, bdt


def fused_stencil_conv_cfp(st: FaceStencil, tables, xc, kernel, n_terms,
                           kind, B):
    """Fused K-term polynomial graph conv in the cface layout, with its
    backward.

    Strips (:func:`.strips.build_strips`), then the raw conv
    (:func:`run_stencil_kernel`), then the corner-row correction.  The
    backward takes the route that ``config.fused_dw`` names: K2
    (:func:`run_dxdw_kernel`) on dy's strips, or the forward conv on dy plus
    K3 (:func:`run_grad_kernel`), in every precision (the JAX package sends
    its bf16 backwards to the two-kernel form for TPU compiler reasons).
    The device of ``xc`` decides: CUDA kernels for a CUDA tensor, their
    plain versions for a CPU tensor.  The precision is
    :func:`conv_dtypes`'.

    :param st: FaceStencil with ``n_steps >= radius * (n_terms - 1)``
    :param tables: :func:`.stencil.as_tensors` of ``stencil_tables(st)`` on
        the device of ``xc``
    :param xc: (B*Fin, 12, n, P_l) activations, batch-major channels; only
        the interior (lanes [h, h+n)) is read
    :param kernel: (Fin*n_terms, Fout)
    :param B: batch size (the channel packing)
    :return: (B*Fout, 12, n, P_l) in the conv's device dtype (float32;
        bfloat16 in the I/O mode; float64 for a float64 input on the CPU),
        0 outside the interior lanes; its gradient with respect to ``xc``
        is 0 outside the interior lanes too, in ``xc``'s dtype
    """
    io, kdt, bdt = conv_dtypes(st, xc)
    return _FusedConv.apply(xc.to(io).contiguous(), kernel.to(kdt), st,
                            tables, n_terms, kind, B, bdt)


def fused_stencil_conv_cfp_plain(st: FaceStencil, tables, xc, kernel,
                                 n_terms, kind, B):
    """:func:`fused_stencil_conv_cfp` through the plain versions of both
    forward kernels, on any device, in the same precision, differentiated
    by autograd through the torch ops (the reference the kernels are held
    to)."""
    io, kdt, bdt = conv_dtypes(st, xc)
    xc = xc.to(io).contiguous()
    return _forward_cfp(st, tables, xc, _wk3(kernel.to(kdt), n_terms),
                        n_terms, kind, B, strip_arrays(st, xc),
                        run_stencil_plain, bdt)
