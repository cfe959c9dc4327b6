"""Global numerical configuration of the PyTorch port.

The port computes in float32 everywhere.  A float32 matrix product on a
CUDA card runs in full float32 by default, but a float32 convolution goes
through cuDNN in TF32 (about three decimal digits); both are pinned off
here, at import, so every torch op on the card matches the JAX package's
``matmul_precision="highest"`` (the <1e-5 parity target).

The JAX package's Pallas routing flags (``use_pallas``, ``contract_mode``,
``dot_fused_min_nside``, ``strips_mode``, the ``DS_KB`` bisection hook)
route around TPU compiler faults and have no counterpart here: on a CUDA
tensor the port always runs its CUDA kernels, on a CPU tensor their plain
PyTorch versions.  The one routing flag that is math, not a workaround,
is :data:`fused_dw`: which of the two backward forms the fused conv takes,
at every width and depth.  :data:`conv_dtype` picks the fused conv's
precision, as the JAX package's flag of the same name.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# Backward of the fused stencil conv.  True: one pass over dy computes dx
# AND dW (kernel K2, ``csrc/stencil_dxdw.cu``: L~ is symmetric, so
# dW[k] = <x, T_k(L~) dy> over the recursion terms the dx pass already
# holds).  False: the two-kernel form, dx as the forward conv on dy (K4 +
# K1) and dW from the recursion on x (K3, ``csrc/stencil_grad.cu``) —
# kept as the cross-check of the first.
fused_dw: bool = True


def set_fused_dw(on: bool):
    global fused_dw
    fused_dw = bool(on)


# Precision of the fused stencil conv (K1-K3 and their plain versions), the
# JAX package's three modes.  "float32" (default): the whole conv in
# float32.  "bfloat16": the band mode; each kernel rounds its halo window
# and weight planes to bfloat16 once, runs the recursion on bfloat16 terms
# and contracts them with a bfloat16 channel kernel, accumulating in
# float32; its device arrays stay float32.  "bfloat16_io": also keeps the
# conv's own device arrays in bfloat16 (activations, halo strips, weight
# planes, output and, backward, the cotangent and dx) where the geometry
# takes it (``ops.fused_stencil.cfp_io_available``), the band mode
# elsewhere.  Set it before a model is built: under "bfloat16_io" the
# layers build the bfloat16 weight planes once
# (``ops.stencil.stencil_tables(st, bf16_io=True)``).  The per-step conv
# routes, the smoothing chain and the ELLPACK convs stay float32, as the
# JAX package's do.
conv_dtype: str = "float32"


def set_conv_dtype(name: str):
    global conv_dtype
    if name not in ("float32", "bfloat16", "bfloat16_io"):
        raise ValueError(
            f"conv_dtype must be float32/bfloat16/bfloat16_io, got {name}"
        )
    conv_dtype = name


def band_dtype():
    """The torch dtype the fused kernels' recursion runs in."""
    return torch.float32 if conv_dtype == "float32" else torch.bfloat16


def conv_io_dtype():
    """The torch dtype of the fused conv's device arrays (activations,
    strips, weight planes, output) where the conv's geometry takes it."""
    return torch.bfloat16 if conv_dtype == "bfloat16_io" else torch.float32
