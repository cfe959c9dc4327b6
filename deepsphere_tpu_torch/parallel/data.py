"""Input pipeline for data-parallel training: each rank's rows of each
global batch.

Counterpart of the JAX package's ``deepsphere_tpu.parallel.data``.  There a
process hands its rows to ``jax.make_array_from_process_local_data`` and the
step sees one global array; here every rank is its own process, holds the
same host arrays, draws the same shuffle from ``seed``, and takes its
contiguous share of each global batch:

    for xb, yb in data_iterator(mesh, x, y, batch_size=64):
        trainer.train_on_batch(xb, yb)        # this rank's 64 / D rows

The ranks of one data shard (its pixel ranks) get the same rows.
"""

from __future__ import annotations

import numpy as np

__all__ = ["global_batch", "data_iterator"]


def _data_rank(mesh, data_axis):
    dim = mesh.mesh_dim_names.index(data_axis)
    return mesh.size(dim), mesh.get_local_rank(data_axis)


def global_batch(mesh, batch, data_axis="data"):
    """This data rank's contiguous rows of a global batch (an array, or a
    tuple / list / dict of them).

    :param batch: arrays whose leading axis is the global batch, divisible
        by the size of the ``data_axis``
    """
    D, r = _data_rank(mesh, data_axis)

    def one(a):
        a = np.asarray(a)
        if a.shape[0] % D:
            raise ValueError(f"batch of {a.shape[0]} does not divide over the "
                             f"{D} ranks of the '{data_axis}' mesh axis")
        m = a.shape[0] // D
        return a[r * m : (r + 1) * m]

    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(one(v) for v in batch)
    return one(batch)


def data_iterator(mesh, x, y=None, batch_size=16, *, shuffle=True, seed=0,
                  drop_remainder=True, data_axis="data", epochs=1):
    """Yield this rank's rows of each global batch, as numpy arrays.

    ``batch_size`` is the global batch and must divide over the
    ``data_axis``.  With ``drop_remainder=False`` the trailing batch is
    padded by repeating its last row and yielded with a boolean ``mask``
    (this rank's rows of the (B,) mask) so losses and metrics can ignore the
    padding.

    :param x, y: host arrays with matching leading dim (y optional), the
        same on every rank
    :param epochs: number of passes (reshuffled per pass)
    :yield: ``(xb, yb)``, or ``(xb, yb, mask)`` when a padded trailing
        batch is possible (mask all-True for full batches)
    """
    x = np.asarray(x)
    if y is not None:
        y = np.asarray(y)
    n = x.shape[0]
    D, _ = _data_rank(mesh, data_axis)
    if batch_size % D:
        raise ValueError(
            f"batch_size {batch_size} must divide over the {D} ranks of the "
            f"'{data_axis}' mesh axis"
        )
    rng = np.random.RandomState(seed)
    emit_mask = (not drop_remainder) and (n % batch_size != 0)

    for _ in range(int(epochs)):
        order = rng.permutation(n) if shuffle else np.arange(n)
        stop = (n // batch_size) * batch_size if drop_remainder else n
        for start in range(0, stop, batch_size):
            sel = order[start:start + batch_size]
            mask = np.ones(batch_size, bool)
            if sel.shape[0] < batch_size:  # trailing partial batch
                pad = batch_size - sel.shape[0]
                mask[sel.shape[0]:] = False
                sel = np.concatenate([sel, np.repeat(sel[-1:], pad)])
            out = (global_batch(mesh, x[sel], data_axis),)
            if y is not None:
                out += (global_batch(mesh, y[sel], data_axis),)
            if emit_mask:
                out += (global_batch(mesh, mask, data_axis),)
            yield out if len(out) > 1 else out[0]
