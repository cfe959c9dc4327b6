"""Model summary helpers (the analogue of Keras ``model.summary()``).

A port of the JAX package's ``deepsphere_tpu.utils.summary``: the table
format is the same, the parameter count runs over tensors."""

from __future__ import annotations


def count_params(module):
    """Parameters and persistent buffers (the batch-norm statistics) of
    ``module``: the entries of its ``state_dict``, never the graph tables,
    which are non-persistent buffers (the JAX package's count of every
    variable collection but ``graph_tables``)."""
    return int(sum(t.numel() for t in module.state_dict().values()))


def format_summary(name, rows, total_params):
    """rows: list of (layer_name, layer_type, output_shape, n_params)."""
    lines = [f'Model: "{name}"']
    header = f"{'Layer (name)':30s} {'Type':28s} {'Output shape':22s} {'Params':>10s}"
    lines.append("=" * len(header))
    lines.append(header)
    lines.append("-" * len(header))
    for lname, ltype, shape, nparams in rows:
        lines.append(f"{lname:30s} {ltype:28s} {str(shape):22s} {nparams:>10d}")
    lines.append("-" * len(header))
    lines.append(f"Total params: {total_params:,}")
    lines.append("=" * len(header))
    return "\n".join(lines)
