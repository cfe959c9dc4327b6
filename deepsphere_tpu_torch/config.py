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
PyTorch versions.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
