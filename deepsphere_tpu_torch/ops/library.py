"""The port's five hand-written CUDA kernels as ``torch.library`` custom ops.

One namespace, ``deepsphere``, one op per kernel:

* ``strips`` — K4, the halo-strip gather (``csrc/strips.cu``);
* ``stencil_conv`` — K1, the raw fused conv (``csrc/stencil_conv.cu``);
* ``stencil_dxdw`` — K2, the fused backward dx + dW (``csrc/stencil_dxdw.cu``);
* ``stencil_grad`` — K3, the dW of the two-kernel backward
  (``csrc/stencil_grad.cu``);
* ``bands`` — K5, the edge-band cut (``csrc/bands.cu``).

Each op has a CUDA implementation, which launches the kernel on the plan
its wrapper's shape gives on this card (computed here, at run time, from
the concrete shape) and adds one to its entry of
:data:`._cuda.launch_counts`; a CPU implementation, the kernel's plain
PyTorch version; and a fake implementation (``register_fake``) that gives
the output shapes from the inputs alone, with no plan and no launch.  A
tensor on any other device has no implementation: the op raises there.
The dispatcher picks the implementation from the inputs' device, so the
wrappers (:mod:`.strips`, :mod:`.fused_stencil`, :mod:`.stencil`) keep
their checks and call the op, and ``torch.export`` traces them as op nodes
(:mod:`..serve`).

An op takes tensors, ints and strings only: the wrapper checks the
stencil (its tap order, its basis kind) and passes its ints (nside ``n``,
halo depth ``h``, radius ``r``, batch ``B``); the rest follows from the
tensors' shapes.

Precision: the conv ops take the band dtype ``bdt`` ("float32", or
"bfloat16": the kernels' bfloat16 instantiations, which round at the
points of :func:`.fused_stencil._plain_terms`) and device arrays that are
all float32 (K1-K3 in float32, or the bf16 band mode) or all bfloat16 (the
bf16 I/O mode, ``bdt`` "bfloat16"); any other dtype raises.  The strips op
copies float32 or bfloat16.  A bfloat16 launch counts in
:data:`._cuda.bf16_launch_counts`, by mode (and the 2-byte stagings of
K1-K3 apart, ``_s2``).  The ops are registered when :mod:`deepsphere_tpu_torch.ops`
is imported; the kernel library itself builds at the first launch, never
at import (:mod:`._cuda`).
"""

from typing import NamedTuple, Optional

import torch

from ..graph.stencil import stencil_offsets
from . import _cuda
from .fused_stencil import (
    _bwd_bf16_staging,
    _bwd_plan,
    _k1_bf16_staging,
    _k1_plan,
    cfp_geometry,
    run_dxdw_plain,
    run_grad_plain,
    run_stencil_plain,
    strip_rows,
)
from .stencil import pack_edge_bands_plain, unpack_edge_bands
from .strips import strip_arrays

__all__ = ["strips", "stencil_conv", "stencil_dxdw", "stencil_grad", "bands",
           "check_device"]

_NS = "deepsphere"


class _Stencil(NamedTuple):
    """The ints of a stencil that the plain versions read (nside, depth,
    radius), with its compile-time tap order."""

    nside: int
    n_steps: int
    radius: int = 1

    @property
    def offsets(self):
        return stencil_offsets(self.radius)


def check_device(what, t):
    """Raise where no implementation of a kernel takes ``t``'s device (the
    ops have a CUDA and a CPU one)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} implementation for device {t.device}")


def _check_tensors(what, dev, want, dtype=torch.float32):
    for name, (t, shape) in want.items():
        if (t.device != dev or t.dtype != dtype
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{str(dtype)[6:]} {shape} tensor on {dev}")


def _mode(what, io, bdt):
    """The C entry points' precision mode: 0 float32, 1 the bf16 band
    mode (float32 arrays), 2 the bf16 I/O mode (bfloat16 arrays)."""
    if bdt not in ("float32", "bfloat16"):
        raise ValueError(f"{what}: band dtype must be float32 or bfloat16, "
                         f"got {bdt}")
    if io not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: its arrays must be float32 or bfloat16, "
                         f"got {io}")
    if io == torch.bfloat16 and bdt != "bfloat16":
        raise ValueError(f"{what}: bfloat16 arrays need the bfloat16 band")
    return 0 if bdt == "float32" else (2 if io == torch.bfloat16 else 1)


def _count(name, mode, staged=4):
    """One launch of kernel ``name`` in precision ``mode``, holding its
    staged values in ``staged`` bytes (the 2-byte stagings, ``_s2``)."""
    if mode == 0:
        _cuda.launch_counts[name] += 1
    else:
        _cuda.bf16_launch_counts[name + ("_bf16_io" if mode == 2 else "_bf16")
                                 + ("_s2" if staged == 2 else "")] += 1


def _aligned4(t):
    """``t``, or a copy of it where its data does not start 4-byte aligned
    (the I/O mode of K1-K3 copies whole 4-byte words of bfloat16 pairs)."""
    return t if t.data_ptr() % 4 == 0 else t.clone()


def _kind_code(kind):
    if kind not in ("cheby", "mono"):
        raise ValueError(f"unknown basis kind: {kind}")
    return 0 if kind == "cheby" else 1


def _stream():
    """The current stream of the current device (the launches run inside
    ``torch.cuda.device`` of their tensors)."""
    return torch.cuda.current_stream().cuda_stream


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


# ---------------------------------------------------------------------------
# K4: the strips
# ---------------------------------------------------------------------------


def _strips_len(n, h, C, F, dtype):
    """Elements of the flat strip buffer of C channels and F faces of
    ``dtype``: top and bot (C, F, R, P_l) each, then ls (C, F, n, 128)."""
    R, P_l = strip_rows(h, dtype), cfp_geometry(n, h)[1]
    return C * F * (2 * R * P_l + n * 128)


# channels per block of the strip kernel (``kCC`` in ``csrc/strips.cu``)
_STRIPS_CC = 2


def _gather_strips(n, h, src, index, C, F, slab):
    """Launch the strip gather kernel (``csrc/strips.cu``): strips of F
    faces and C channels, ``out[c, e] = src[c*slab + index[e]]`` (0 where
    the index is -1), as one flat buffer; the caller has checked ``src``.
    The kernel reads ``index`` in 16-byte groups, so it must start 16-byte
    aligned; it copies four elements a group, 4 bytes each (float32) or 2
    (bfloat16: the R16 strips)."""
    R, P_l = strip_rows(h, src.dtype), cfp_geometry(n, h)[1]
    if (index.dtype != torch.int32 or index.device != src.device
            or index.numel() != F * (2 * R * P_l + n * 128)
            or not index.is_contiguous()):
        raise ValueError("strip index map does not match this conv")
    if index.data_ptr() % 16:
        raise ValueError("strip index map must start 16-byte aligned")
    if -(-C // _STRIPS_CC) > 65535:
        raise ValueError(f"strips kernel: {C} channels are too many for the grid")
    out = torch.empty(_strips_len(n, h, C, F, src.dtype), dtype=src.dtype,
                      device=src.device)
    es = src.element_size()
    vec = int(src.data_ptr() % (4 * es) == 0 and slab % 4 == 0)
    lib = _cuda.lib()
    with torch.cuda.device(src.device):
        rc = lib.ds_strips(src.data_ptr(), index.data_ptr(), out.data_ptr(),
                           C, slab, F, n, h, R, P_l, vec, es, _stream())
    _cuda.check(rc, "ds_strips")
    if es == 4:
        _cuda.launch_counts["strips"] += 1
    else:
        _cuda.bf16_launch_counts["strips_bf16"] += 1
    return out


def _strips_source(src, n, h):
    """(C, slab) of a strip source: a full-sphere cface map (C, 12, n, P_l)
    or packed all-gathered edge bands (12, C, 4*h*n)."""
    if src.dim() == 4:
        return src.shape[0], 12 * n * cfp_geometry(n, h)[1]
    return src.shape[1], src.shape[2]


@torch.library.custom_op(f"{_NS}::strips", mutates_args=(),
                         device_types="cuda")
def strips(src: torch.Tensor, index: torch.Tensor, n: int, h: int,
           faces: list[int]) -> torch.Tensor:
    """K4: the halo strips of ``faces`` as one flat buffer (top, bot, ls;
    :func:`.strips.build_strips` makes the views), from a full-sphere cface
    map ``src`` (C, 12, n, P_l), float32 or bfloat16, or the packed edge
    bands (12, C, 4*h*n), float32, through the int32 source map
    ``index``."""
    if (src.dtype not in (torch.float32, torch.bfloat16)
            or not src.is_contiguous()
            or (src.dim() != 4 and src.dtype != torch.float32)):
        raise ValueError("strips kernel needs a contiguous float32 source "
                         "(or a bfloat16 cface map)")
    C, slab = _strips_source(src, n, h)
    want = ((C, 12, n, slab // (12 * n)) if src.dim() == 4
            else (12, C, 4 * h * n))
    if tuple(src.shape) != want:
        raise ValueError(f"strips source {tuple(src.shape)} != {want}")
    return _gather_strips(n, h, src, index, C, len(faces), slab)


@strips.register_kernel("cpu")
def _strips_cpu(src, index, n, h, faces):
    st = _Stencil(n, h)
    if src.dim() == 4:
        parts = strip_arrays(st, src)
    else:
        parts = strip_arrays(st, None, faces, unpack_edge_bands(src, n, h))
    return torch.cat([p.reshape(-1) for p in parts])


@strips.register_fake
def _strips_fake(src, index, n, h, faces):
    C, _ = _strips_source(src, n, h)
    return src.new_empty(_strips_len(n, h, C, len(faces), src.dtype))


# ---------------------------------------------------------------------------
# K1: the raw fused conv
# ---------------------------------------------------------------------------


@torch.library.custom_op(f"{_NS}::stencil_conv", mutates_args=(),
                         device_types="cuda")
def stencil_conv(xc: torch.Tensor, top: torch.Tensor, bot: torch.Tensor,
                 ls: torch.Tensor, wext: torch.Tensor, wk3: torch.Tensor,
                 n: int, h: int, r: int, B: int, kind: str,
                 bdt: str = "float32") -> torch.Tensor:
    """K1 on :func:`.fused_stencil._k1_plan`'s plan for this card: the raw
    fused conv (:func:`.fused_stencil.run_stencil_kernel`), (B*Fout, F, n,
    P_l) in ``xc``'s dtype.  A bfloat16 launch takes the 2-byte plan, in
    the staging :func:`.fused_stencil._k1_bf16_staging` names."""
    io = xc.dtype
    mode = _mode("stencil kernel", io, bdt)
    R, P_l = strip_rows(h, io), cfp_geometry(n, h)[1]
    K, Fin, Fout = wk3.shape
    F = xc.shape[1]
    dev = xc.device
    nplanes = (2 * r + 1) ** 2
    code = _kind_code(kind)
    if not 1 <= F <= 12:
        raise ValueError(f"stencil kernel: {F} faces (1..12)")
    C = B * Fin
    _check_tensors("stencil kernel", dev, {
        "xc": (xc, (C, F, n, P_l)),
        "top": (top, (C, F, R, P_l)), "bot": (bot, (C, F, R, P_l)),
        "ls": (ls, (C, F, n, 128)),
        "wext": (wext, (nplanes, F, n + 2 * R, P_l)),
    }, io)
    _check_tensors("stencil kernel", dev, {"wk3": (wk3, (K, Fin, Fout))})
    sms = _sms(dev)
    plan = _k1_plan(n, h, r, nplanes, K, B, F, Fin, Fout, sms,
                    2 if mode else 4)
    if plan is None:
        raise ValueError(f"stencil kernel does not take n={n} h={h} r={r} "
                         f"K={K} B={B} Fout={Fout}: no tile fits shared "
                         "memory or the grid")
    staged = _k1_bf16_staging(plan, h, r, nplanes, K) if mode else 4
    if mode == 2 and staged == 4:
        xc, top, bot, ls, wext = map(_aligned4, (xc, top, bot, ls, wext))
    out = torch.empty((B * Fout, F, n, P_l), dtype=xc.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _cuda.lib().ds_stencil_conv(
            xc.data_ptr(), top.data_ptr(), bot.data_ptr(), ls.data_ptr(),
            wext.data_ptr(), wk3.data_ptr(), out.data_ptr(),
            code, K, r, nplanes, B, F, Fin, Fout, n, h,
            R, P_l, plan.T, plan.G, plan.GB, plan.FC, mode, _stream(),
        )
    _cuda.check(rc, "ds_stencil_conv")
    _count("stencil_conv", mode, staged)
    return out


@stencil_conv.register_kernel("cpu")
def _stencil_conv_cpu(xc, top, bot, ls, wext, wk3, n, h, r, B, kind,
                      bdt="float32"):
    return run_stencil_plain(_Stencil(n, h, r), kind, wk3.shape[0], xc, wext,
                             (top, bot, ls), wk3, B, bdt)


@stencil_conv.register_fake
def _stencil_conv_fake(xc, top, bot, ls, wext, wk3, n, h, r, B, kind,
                       bdt="float32"):
    return xc.new_empty((B * wk3.shape[2], xc.shape[1], n, xc.shape[3]))


# ---------------------------------------------------------------------------
# K2 and K3: the backward
# ---------------------------------------------------------------------------


def _bwd_launch(what, n, h, r, kind, K, src, strips3, wext, oth, B, Crec,
                Cch, dx, bdt):
    """Checks and plan shared by K2 (``dx``) and K3: the recursion over the
    B*Crec channels of ``src`` through ``strips3``, the fold over the B*Cch
    channels of ``oth``.  A bfloat16 launch takes the 2-byte plan, in the
    staging :func:`.fused_stencil._bwd_bf16_staging` names.

    :return: (arrays, partial, dw, ints, staged): (src, top, bot, ls,
        wext), each copied where the I/O mode's word copies need it 4-byte
        aligned; the scratch of per-block dW sums (each block writes its own
        column, a second launch reduces the rows in a fixed order: no float
        atomics, so two calls give bitwise-equal dW); dW; the C entry
        points' ints (kind, K, radius, nplanes, B, F, Crec, Cch, n, h, Rs,
        P, T, G, GB, FC, prec: the mode, plus 2 for a 2-byte staging); the
        mode; and the bytes a staged value takes
    """
    io = src.dtype
    mode = _mode(what, io, bdt)
    R, P_l = strip_rows(h, io), cfp_geometry(n, h)[1]
    nplanes = (2 * r + 1) ** 2
    F = src.shape[1]
    dev = src.device
    code = _kind_code(kind)
    if not 1 <= F <= 12:
        raise ValueError(f"{what}: {F} faces (1..12)")
    top, bot, ls = strips3
    C = B * Crec
    _check_tensors(what, dev, {
        "src": (src, (C, F, n, P_l)), "oth": (oth, (B * Cch, F, n, P_l)),
        "top": (top, (C, F, R, P_l)), "bot": (bot, (C, F, R, P_l)),
        "ls": (ls, (C, F, n, 128)),
        "wext": (wext, (nplanes, F, n + 2 * R, P_l)),
    }, io)
    p = _bwd_plan(n, h, r, nplanes, K, B, F, Crec, Cch, dx, _sms(dev),
                  2 if mode else 4)
    if p is None:
        raise ValueError(f"{what} does not take n={n} h={h} r={r} K={K} B={B}"
                         f" channels {Crec} x {Cch}: no tile fits shared "
                         "memory or the grid")
    staged = (_bwd_bf16_staging(p, h, r, nplanes, K, Crec, dx) if mode
              else 4)
    arrays = (src, top, bot, ls, wext)
    if mode == 2 and staged == 4:
        arrays = tuple(map(_aligned4, arrays))
    ncol = -(-B // p.GB) * F * (n // p.T) ** 2
    partial = torch.empty((K * Crec * Cch, ncol), dtype=torch.float32,
                          device=dev)
    dw = torch.empty((K * Crec * Cch,), dtype=torch.float32, device=dev)
    ints = (code, K, r, nplanes, B, F, Crec, Cch, n, h, R, P_l, p.T, p.G,
            p.GB, p.FC, mode + (2 if staged == 2 else 0))
    return arrays, partial, dw, ints, mode, staged


@torch.library.custom_op(f"{_NS}::stencil_dxdw", mutates_args=(),
                         device_types="cuda")
def stencil_dxdw(dy: torch.Tensor, top: torch.Tensor, bot: torch.Tensor,
                 ls: torch.Tensor, wext: torch.Tensor, wk3t: torch.Tensor,
                 xr: torch.Tensor, mask: Optional[torch.Tensor], n: int,
                 h: int, r: int, B: int, kind: str,
                 bdt: str = "float32") -> tuple[torch.Tensor, torch.Tensor]:
    """K2 on :func:`.fused_stencil._bwd_plan`'s plan for this card: dx
    (B*Fin, F, n, P_l) in dy's dtype and dW (K*Fin, Fout), float32, in one
    pass over dy (:func:`.fused_stencil.run_dxdw_kernel`)."""
    _, P_l = cfp_geometry(n, h)
    K, Fc, Fx = wk3t.shape
    F = dy.shape[1]
    dev = dy.device
    arrays, partial, dw, ints, mode, staged = _bwd_launch(
        "dxdw kernel", n, h, r, kind, K, dy, (top, bot, ls), wext, xr, B, Fc,
        Fx, True, bdt)
    want = {"wk3t": (wk3t, (K, Fc, Fx))}
    if mask is not None:
        want["mask"] = (mask, (F, n, P_l))
    _check_tensors("dxdw kernel", dev, want)
    dx = torch.empty((B * Fx, F, n, P_l), dtype=dy.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _cuda.lib().ds_stencil_dxdw(
            *(t.data_ptr() for t in arrays), wk3t.data_ptr(), xr.data_ptr(),
            0 if mask is None else mask.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), dw.data_ptr(), *ints, _stream(),
        )
    _cuda.check(rc, "ds_stencil_dxdw")
    _count("dxdw", mode, staged)
    return dx, dw.reshape(K * Fx, Fc)


@stencil_dxdw.register_kernel("cpu")
def _stencil_dxdw_cpu(dy, top, bot, ls, wext, wk3t, xr, mask, n, h, r, B,
                      kind, bdt="float32"):
    return run_dxdw_plain(_Stencil(n, h, r), kind, wk3t.shape[0], dy, wext,
                          (top, bot, ls), wk3t, xr, mask, B, bdt)


def _dw_dtype(t):
    """dW's dtype: float32 for float32 and bfloat16 arrays (float64 only
    on the CPU's float64 path)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


@stencil_dxdw.register_fake
def _stencil_dxdw_fake(dy, top, bot, ls, wext, wk3t, xr, mask, n, h, r, B,
                       kind, bdt="float32"):
    K, Fc, Fx = wk3t.shape
    return (dy.new_empty((B * Fx, dy.shape[1], n, dy.shape[3])),
            dy.new_empty((K * Fx, Fc), dtype=_dw_dtype(dy)))


@torch.library.custom_op(f"{_NS}::stencil_grad", mutates_args=(),
                         device_types="cuda")
def stencil_grad(xc: torch.Tensor, top: torch.Tensor, bot: torch.Tensor,
                 ls: torch.Tensor, wext: torch.Tensor, dy: torch.Tensor,
                 n: int, h: int, r: int, K: int, B: int, kind: str,
                 bdt: str = "float32") -> torch.Tensor:
    """K3 on :func:`.fused_stencil._bwd_plan`'s plan for this card: dW
    (K*Fin, Fout), float32, of the two-kernel backward
    (:func:`.fused_stencil.run_grad_kernel`)."""
    Fin, Fout = xc.shape[0] // B, dy.shape[0] // B
    arrays, partial, dw, ints, mode, staged = _bwd_launch(
        "grad kernel", n, h, r, kind, K, xc, (top, bot, ls), wext, dy, B, Fin,
        Fout, False, bdt)
    with torch.cuda.device(xc.device):
        rc = _cuda.lib().ds_stencil_grad(
            *(t.data_ptr() for t in arrays), dy.data_ptr(), partial.data_ptr(),
            dw.data_ptr(),
            *ints, _stream(),
        )
    _cuda.check(rc, "ds_stencil_grad")
    _count("grad", mode, staged)
    return dw.reshape(K * Fin, Fout)


@stencil_grad.register_kernel("cpu")
def _stencil_grad_cpu(xc, top, bot, ls, wext, dy, n, h, r, K, B, kind,
                      bdt="float32"):
    return run_grad_plain(_Stencil(n, h, r), kind, K, xc, wext,
                          (top, bot, ls), dy, B, bdt)


@stencil_grad.register_fake
def _stencil_grad_fake(xc, top, bot, ls, wext, dy, n, h, r, K, B, kind,
                       bdt="float32"):
    return xc.new_empty((K * (xc.shape[0] // B), dy.shape[0] // B),
                        dtype=_dw_dtype(xc))


# ---------------------------------------------------------------------------
# K5: the edge bands
# ---------------------------------------------------------------------------


@torch.library.custom_op(f"{_NS}::bands", mutates_args=(),
                         device_types="cuda")
def bands(xc: torch.Tensor, n: int, h: int) -> torch.Tensor:
    """K5: the four h-deep edge bands of every face of ``xc`` (C, F, n, P),
    packed face-major, (F, C, 4*h*n) (:func:`.stencil.pack_edge_bands`)."""
    if xc.dtype != torch.float32 or not xc.is_contiguous() or xc.ndim != 4:
        raise ValueError("band kernel needs a contiguous float32 (C, F, n, P) xc")
    C, F, rows, P = xc.shape
    if rows != n or not 1 <= h <= n or 2 * h + n > P:
        raise ValueError(f"band kernel: xc {tuple(xc.shape)} does not hold "
                         f"n={n} rows and h={h} halo lanes")
    if C > 65535:
        raise ValueError(f"band kernel takes 1..65535 channels, got {C}")
    out = torch.empty((F, C, 4 * h * n), dtype=xc.dtype, device=xc.device)
    with torch.cuda.device(xc.device):
        rc = _cuda.lib().ds_bands(xc.data_ptr(), out.data_ptr(), C, F, n, h,
                                  P, h, _stream())
    _cuda.check(rc, "ds_bands")
    _cuda.launch_counts["bands"] += 1
    return out


@bands.register_kernel("cpu")
def _bands_cpu(xc, n, h):
    return pack_edge_bands_plain(xc, n, h)


@bands.register_fake
def _bands_fake(xc, n, h):
    return xc.new_empty((xc.shape[1], xc.shape[0], 4 * h * n))
