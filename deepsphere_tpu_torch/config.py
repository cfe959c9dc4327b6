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
at every width and depth.
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
