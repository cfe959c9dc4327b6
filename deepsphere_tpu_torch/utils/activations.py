"""Activation resolution by name.

Parity with the JAX package's ``deepsphere_tpu.utils.activations`` (and the
reference's ``getattr(tf.keras.activations, name)`` lookup): layers accept
``None``, a callable, or a string name and raise ``ValueError`` for unknown
names.  Each function matches its ``jax.nn`` namesake, including gelu's
tanh approximation (``jax.nn.gelu`` default).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": torch.relu,
    "relu6": F.relu6,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "swish": F.silu,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": lambda x: F.relu6(x + 3.0) / 6.0,
    "tanh": torch.tanh,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "exponential": torch.exp,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
}


def resolve_activation(activation):
    """None -> None, callable -> itself, known name -> function, else raise."""
    if activation is None or callable(activation):
        return activation
    if isinstance(activation, str) and activation in _ACTIVATIONS:
        return _ACTIVATIONS[activation]
    raise ValueError(f"Could not find activation <{activation}>...")
