"""The smoothing operator's power chain S^j x on the fused conv, with its
exact transpose backward.

Counterpart of the chain in the JAX package's
``deepsphere_tpu.nn.smoothing.HealpySmoothing._apply_stencil``.  S^j x is
the j-th term of the monomial recursion on the smoothing template's
stencil, so channel c's power j_c comes out of a monomial conv whose
(K, C, C) channel kernel is one-hot: ``wk3[j_c, c, c] = 1``.  A pass fuses
``apps`` applications (K = apps + 1 terms on a stencil of depth h =
radius * apps); ``ceil(max_c(m_c) / apps)`` passes run the chain, a
finished channel riding term 0 (the identity).

On a CUDA tensor each pass is K4 (the halo strips), then K1 (the fused
conv), then the corner correction (rows near the polar corners, for apps >
1 only); on a CPU tensor the same chain runs the kernels' plain versions.

S is row-normalised and *not* symmetric, so the fused conv's backward
(``_FusedConv``: K2, or K1 on dy and K3, which assume a symmetric L~)
would backpropagate S instead of S^T.  :class:`_SmoothChain` runs the
kernels forward with no autograd graph, and its backward is the
vector-Jacobian product of the plain per-step chain (stencil matvecs, one
application a term), i.e. the exact S^T: the counterpart of the JAX
package's ``jax.linear_transpose`` of its per-step chain.  It launches no
kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda

__all__ = ["smooth_route", "smooth_chain", "smooth_chain_plain"]


def _one_hot(j, C, n_terms, dtype, device):
    """(K, C, C) channel kernel selecting term j[c] for channel c, made on
    ``device`` with no copy from the host (a CUDA graph may capture it)."""
    wk3 = torch.zeros((n_terms, C, C), dtype=dtype, device=device)
    for c in range(C):
        wk3[int(j[c]), c, c].fill_(1.0)
    return wk3


def _passes(remaining, apps):
    """The per-pass powers: [j (C,) ...] until every channel is done."""
    rem = np.asarray(remaining, dtype=np.int64).copy()
    out = []
    while rem.max() > 0:
        j = np.minimum(rem, apps)
        out.append(j)
        rem = rem - j
    return out


def smooth_route(st, B, C, apps, device, sms=None):
    """The route of the chain of a (B, M, C) input on ``device``:
    ``"fused"`` where the stencil fits the fused conv and the cface layout
    (``cfp_structural_available``), ``"per_step"`` where it does not (the
    JAX package runs no kernel there either).  A CUDA input whose K1 plan
    on a card of ``sms`` SMs (default: the device's) is refused raises,
    before any launch."""
    from .fused_stencil import _k1_plan, cfp_structural_available

    if not cfp_structural_available(st, "mono", apps + 1):
        return "per_step"
    if torch.device(device).type == "cuda":
        n, h, r = st.nside, st.n_steps, st.radius
        if sms is None:
            sms = torch.cuda.get_device_properties(
                device).multi_processor_count
        if _k1_plan(n, h, r, len(st.offsets), apps + 1, B, 12, C, C,
                    sms) is None:
            raise ValueError(
                f"smoothing: no K1 plan takes n={n} h={h} r={r} "
                f"K={apps + 1} B={B} C={C} on {sms} SMs (no tile fits "
                "shared memory or the grid)")
    return "fused"


def _fused_chain(st, tables, xf, passes, apps):
    """The passes through the fused conv: (B, npix, C) face-flat ->
    (B, npix, C)."""
    from .fused_stencil import _forward_cfp, run_stencil_kernel
    from .stencil import cface_embed, cface_extract
    from .strips import build_strips

    B, M, C = xf.shape
    n, h = st.nside, st.n_steps
    dt = torch.float64 if xf.dtype == torch.float64 else torch.float32
    xc = cface_embed(xf.to(dt), n, h).reshape(B * C, 12, n, -1).contiguous()
    for j in passes:
        wk3 = _one_hot(j, C, apps + 1, dt, xf.device)
        strips = build_strips(st, xc, tables.get("strip_idx"))
        xc = _forward_cfp(st, tables, xc, wk3, apps + 1, "mono", B, strips,
                          run_stencil_kernel)
    return cface_extract(xc.reshape(B, C, 12, n, -1), h).to(xf.dtype)


def _per_step_chain(st, tables, xf, passes, apps):
    """The same passes, one stencil matvec a term (plain torch, any device,
    differentiable by autograd)."""
    from .stencil import _per_step

    B, M, C = xf.shape
    for j in passes:
        kern = _one_hot(j, C, apps + 1, xf.dtype, xf.device)
        # (K, Fin, Fout) -> the conv's (Fin*K, Fout), Fin-major
        kern = kern.permute(1, 0, 2).reshape(C * (apps + 1), C)
        xf = _per_step(st, xf, kern, apps + 1, "mono", tables, "face")
    return xf


class _SmoothChain(torch.autograd.Function):
    """The fused chain forward (no autograd graph), the VJP of the plain
    per-step chain backward: S^T, exactly."""

    @staticmethod
    def forward(ctx, xf, st, tables, passes, apps):
        ctx.meta = (st, tables, passes, apps)
        return _fused_chain(st, tables, xf, passes, apps)

    @staticmethod
    def backward(ctx, dy):
        st, tables, passes, apps = ctx.meta
        with torch.enable_grad():
            # the chain is linear: its VJP at any point is the transpose
            v = torch.zeros_like(dy, requires_grad=True)
            y = _per_step_chain(st, tables, v, passes, apps)
            (dx,) = torch.autograd.grad(y, v, dy)
        return dx, None, None, None, None


def smooth_chain(st, tables, xf, remaining, apps, route=None):
    """S^{remaining[c]} applied to channel c of ``xf``.

    :param st: the template's stencil, depth ``st.n_steps`` = radius * apps
    :param tables: :func:`.stencil.as_tensors` of its tables on the device
        of ``xf``
    :param xf: (B, npix, C) face-flat maps
    :param remaining: (C,) powers, each >= 0
    :param apps: applications a pass fuses
    :param route: the route, held by the caller, who has checked it for
        this batch (an exported forward: ``HealpySmoothing.batch_route``);
        None chooses it here
    :return: (B, npix, C); its gradient is the exact transpose chain
    """
    B, _, C = xf.shape
    passes = _passes(remaining, apps)
    if not passes:
        return xf
    if route is None:
        route = smooth_route(st, B, C, apps, xf.device)
    _cuda.route_counts[f"smooth_{route}"] += 1
    if route == "per_step":
        return _per_step_chain(st, tables, xf, passes, apps)
    return _SmoothChain.apply(xf, st, tables, passes, apps)


def smooth_chain_plain(st, tables, xf, remaining, apps):
    """:func:`smooth_chain` through the plain per-step chain, differentiated
    by autograd (the reference the fused chain is held to)."""
    return _per_step_chain(st, tables, xf, _passes(remaining, apps), apps)
