"""Serving: ahead-of-time exported inference artifacts (``torch.export``).

The port's counterpart of the JAX package's ``deepsphere_tpu.serve``:
inference is exported with the weights and graph tables held as
constants, so the consumer needs no graph build and no HEALPix
precompute; it needs ``torch`` and this package's kernel op registration
(the kernels are custom ops, :mod:`..ops.library`), and it runs on the
device it was exported on (see :mod:`.export`).
"""

from .export import (
    MAX_BATCH,
    ExportedModel,
    export_inference,
    load_exported,
    save_exported,
)

__all__ = [
    "ExportedModel",
    "MAX_BATCH",
    "export_inference",
    "save_exported",
    "load_exported",
]
