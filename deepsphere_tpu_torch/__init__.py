"""deepsphere_tpu_torch — the PyTorch/CUDA port of ``deepsphere_tpu``.

Spherical CNNs on HEALPix maps, running on PyTorch, with the JAX package's
TPU (Pallas) kernels rewritten by hand as CUDA kernels for Hopper
(``sm_90a``).  The JAX package ``deepsphere_tpu`` stays beside it as the
reference; this package never imports jax.

What runs today: the ``HealpyGCNN`` (the graph conv family, pooling,
pseudo-convs, residual layers, Gaussian smoothing, the graph ViT and the
edge-sparse transformer, dense heads) in inference and in training
(``compile``/``fit``, :mod:`.train`), on the CPU through plain PyTorch and
on an H100 through the hand-written kernels in ``csrc/``: the fused
stencil conv, its two backward kernels, the halo-strip gather and the
edge-band cut, registered as ``torch.library`` custom ops; DP x
face-sharded over a device mesh (:mod:`.parallel`); and served from
``torch.export`` artifacts (:mod:`.serve`).  See ROADMAP.md for what is
still to port.
"""

from . import config  # noqa: F401  (pins float32 matmuls and convs)
from ._logger import logger
from .models import HealpyGCNN

__version__ = "0.1.0"

__all__ = ["HealpyGCNN", "logger", "__version__"]

from . import graph, models, nn, ops, parallel, serve, sphere, train, utils  # noqa: E402
from .nn import healpy_layers  # noqa: E402
