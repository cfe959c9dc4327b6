"""Checkpoints of the full training state: parameters, batch statistics,
optimizer state and step, one ``torch.save`` file per step.

Counterpart of the JAX package's ``deepsphere_tpu.train.checkpoint`` (orbax
there): ``save_checkpoint(path, state, keep=3)`` writes
``path/ckpt_{step}.pt`` and keeps the newest ``keep``;
``restore_checkpoint`` reads the newest (or a given) step.
"""

from __future__ import annotations

import os
import re

import torch

__all__ = ["save_checkpoint", "restore_checkpoint"]

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _steps(path):
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(path))
                  if m)


def save_checkpoint(path, state, keep=3):
    """Save ``state`` (a :class:`~.trainer.TrainState`, e.g.
    ``Trainer.state``, or a dict with ``params``, ``batch_stats``,
    ``opt_state`` and ``step``) under directory ``path``; the ``keep``
    newest steps stay."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    payload = state if isinstance(state, dict) else {
        "params": state.params, "batch_stats": state.batch_stats,
        "opt_state": state.opt_state, "step": state.step}
    step = int(payload.get("step", 0))
    final = os.path.join(path, f"ckpt_{step}.pt")
    tmp = final + f".{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, final)
    for old in _steps(path)[:-keep] if keep else []:
        os.remove(os.path.join(path, f"ckpt_{old}.pt"))
    return path


def restore_checkpoint(path, target=None, step=None):
    """Load the newest (or the given) step under ``path``.

    :param target: optionally a Trainer: its model, optimizer and step are
        restored in place
    :return: the checkpoint's dict
    """
    path = os.path.abspath(path)
    if step is None:
        steps = _steps(path)
        if not steps:
            raise FileNotFoundError(f"No checkpoint found under {path}")
        step = steps[-1]
    dev = target._device() if target is not None else "cpu"
    payload = torch.load(os.path.join(path, f"ckpt_{step}.pt"),
                         map_location=dev)
    if target is not None:
        if target.optimizer is None:
            target.init_state()
        target.load_state_arrays(payload["params"], payload["batch_stats"])
        target.optimizer.load_state_dict(payload["opt_state"])
        target.step = int(payload["step"])
    return payload
