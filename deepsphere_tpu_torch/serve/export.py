"""Ahead-of-time inference export via ``torch.export``.

The port's counterpart of the JAX package's ``deepsphere_tpu.serve.export``
(a ``jax.export`` StableHLO artifact).  Why this shape:

* **Self-contained artifacts, up to the kernels.**  The exported program
  holds the model's parameters, batch statistics and graph tables as
  constants: no graph build (the nside=1024 stencil extraction is minutes
  of host precompute), no stencil extraction and no call into
  :mod:`deepsphere_tpu_torch.graph` on the serving side.  Unlike the JAX
  artifact it is not framework-free: the hand-written kernels are Python
  custom ops (:mod:`..ops.library`, ``deepsphere::*``), which the graph
  references by name, so loading needs ``torch`` and the op registration
  (importing this package), and the card's build of the kernels at the
  first launch.
* **Device-bound.**  JAX's ``platforms=`` has no counterpart: the artifact
  holds its tensors on the device it was exported on and runs there (the
  CUDA kernels on a card, their plain versions on the CPU).  Export on the
  device you serve on.
* **Routes fixed before tracing.**  A conv chooses its route (the fused
  kernels, the lap chain or the per-step path) from its batch on the card
  (:func:`..ops.fused_stencil.cface_route`), and ``torch.export`` refuses
  a branch on a symbolic batch.  So export evaluates every such layer's
  route in pure Python for every batch the artifact is to serve, with the
  card's SM count, raises where they differ (naming ``batch_size=``), and
  traces with that route held on each layer.  The kernels' launch plans
  are still made at run time, from the concrete batch.
* **Polymorphic batch.**  ``batch_size=None`` exports a symbolic leading
  axis ``b`` in ``[1, max_batch]``; an int pins it.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from .._logger import logger

__all__ = ["export_inference", "save_exported", "load_exported",
           "ExportedModel", "MAX_BATCH"]

#: The default largest batch of a polymorphic artifact.  Export checks the
#: route of every batch in [1, max_batch] before tracing, which takes
#: O(max_batch^2) steps of pure-Python planning per conv (a fraction of a
#: second at 1024), and at a few thousand maps a batch the card's grid
#: limits start to refuse plans of the wide convs (the K1 grid's z
#: extent): 1024 maps is 64 of ``predict``'s default batches of 16, far
#: past where serving stops gaining throughput.
MAX_BATCH = 1024


def _infer_pixel_shape(model):
    """(npix_in, Fin) for a built HealpyGCNN."""
    shp = getattr(model, "_built_input_shape", None)
    if shp is None:
        raise ValueError(
            "Model has no variables yet; call build(input_shape) or fit() "
            "before exporting."
        )
    return tuple(shp[1:])


def _sm_count(device):
    """The SM count of a CUDA ``device``, None for the CPU (whose plain
    versions take every batch and choose no route)."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).multi_processor_count


def _model_device(model):
    return next(iter(model.state_dict().values())).device


def _routed_inputs(model, x0):
    """{layer: its input shape} of the layers that choose a route from the
    batch (``batch_route``), from one eval forward of ``x0``."""
    shapes = {}

    def record(mod, args):
        shapes.setdefault(mod, tuple(args[0].shape))

    hooks = [m.register_forward_pre_hook(record)
             for m in model.modules() if hasattr(m, "batch_route")]
    try:
        with torch.no_grad():
            model(x0)
    finally:
        for hk in hooks:
            hk.remove()
    return shapes


def _held_routes(model, x0, batches, sms):
    """{layer: route} to hold while tracing: each routed layer's route,
    which must be the same for every batch in ``batches``."""
    if sms is None:
        return {}
    names = {m: nm for nm, m in model.named_modules()}
    held = {}
    for layer, shape in _routed_inputs(model, x0).items():
        routes = {}
        for b in batches:
            try:
                route = layer.batch_route((b,) + shape[1:], sms)
            except ValueError as e:
                raise ValueError(f"export: {names[layer]} at batch {b}: {e}; "
                                 "export with a batch_size= (or max_batch=) "
                                 "that its kernels take") from e
            routes.setdefault(route, []).append(b)
        if len(routes) > 1:
            spans = "; ".join(f"{r} at batches {bs[0]}..{bs[-1]}"
                              for r, bs in routes.items())
            raise ValueError(
                f"export: {names[layer]} takes different routes across the "
                f"batches the artifact would serve ({spans}): export with a "
                "fixed batch_size= (or a max_batch=) within one route")
        route = next(iter(routes))
        if route is not None:
            held[layer] = route
    return held


@contextlib.contextmanager
def _holding(held):
    """Hold each layer's route (its ``_held_route``) for the trace."""
    for layer, route in held.items():
        layer._held_route = route
    try:
        yield
    finally:
        for layer in held:
            layer._held_route = None


@contextlib.contextmanager
def _state_of(model, variables):
    """The model with copies of ``variables`` (a ``state_dict``; default its
    own) in place of its parameters and persistent buffers, the originals
    put back after: the artifact owns its weights, and the live model is
    left as it was."""
    own = model.state_dict()
    variables = own if variables is None else variables
    if set(variables) != set(own):
        raise ValueError(
            f"variables do not match the model's state_dict: missing "
            f"{sorted(set(own) - set(variables))}, unexpected "
            f"{sorted(set(variables) - set(own))}")
    saved = []
    for key, t in own.items():
        v = torch.as_tensor(variables[key])
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"variables[{key!r}] has shape {tuple(v.shape)}, "
                             f"the model {tuple(t.shape)}")
        mod_name, _, attr = key.rpartition(".")
        mod = model.get_submodule(mod_name)
        old = getattr(mod, attr)
        new = v.detach().to(device=t.device, dtype=t.dtype).clone()
        saved.append((mod, attr, old))
        if isinstance(old, torch.nn.Parameter):
            new = torch.nn.Parameter(new, requires_grad=old.requires_grad)
        setattr(mod, attr, new)
    try:
        yield
    finally:
        for mod, attr, old in saved:
            setattr(mod, attr, old)


def export_inference(model, variables=None, *, batch_size=None,
                     max_batch=MAX_BATCH):
    """Trace a built model's eval-mode forward with ``torch.export``.

    :param model: a built :class:`~deepsphere_tpu_torch.models.HealpyGCNN`
    :param variables: optional ``state_dict`` to bake (default: the
        model's own); copies go into the artifact, the model is left as it
        was
    :param batch_size: ``None`` exports a symbolic batch axis ``b``
        (``Dim("b", min=1, max=max_batch)``: one artifact, any batch in
        that range); an int pins the leading axis
    :param max_batch: the largest batch of a polymorphic artifact
        (:data:`MAX_BATCH`); every batch up to it must take the same
        routes on this card
    :return: ``torch.export.ExportedProgram`` on the model's device
        (:class:`ExportedModel` wraps it for calling)
    """
    npix, fin = _infer_pixel_shape(model)
    if getattr(model, "shard_cfg", None) is not None:
        raise ValueError("export: a sharded model runs collectives; export "
                         "an unsharded copy")
    dev = _model_device(model)
    if batch_size is None:
        batches = range(1, int(max_batch) + 1)
    else:
        batches = [int(batch_size)]
    was_training = model.training
    model.eval()
    try:
        with _state_of(model, variables):
            held = _held_routes(model, torch.zeros((1, npix, fin), device=dev),
                                batches, _sm_count(dev))
            # a traced batch of 1 would be specialised: trace at 2 where
            # the artifact serves more than one batch size
            example = torch.zeros((min(2, batches[-1]) if batch_size is None
                                   else batches[0], npix, fin), device=dev)
            dynamic = None
            if batch_size is None:
                dynamic = ({0: torch.export.Dim("b", min=1,
                                                max=int(max_batch))},)
            with _holding(held):
                # a guard on the symbolic batch that the solver cannot
                # prove (torch 2.11 raises on the per-step conv's layout
                # checks, min(32b, 256b, 2048b) == 32b) becomes a run-time
                # assert instead of failing the export
                program = torch.export.export(
                    model, (example,), dynamic_shapes=dynamic,
                    prefer_deferred_runtime_asserts_over_guards=True)
    finally:
        model.train(was_training)
    logger.info(f"Exported inference: input (b, {npix}, {fin}) on {dev}, "
                f"routes held: {sorted(set(held.values()))}")
    return program


def save_exported(path, model, variables=None, *, batch_size=None,
                  max_batch=MAX_BATCH):
    """Export (see :func:`export_inference`) and write the artifact to
    ``path`` with ``torch.export.save``.  Returns the byte count."""
    program = export_inference(model, variables, batch_size=batch_size,
                               max_batch=max_batch)
    torch.export.save(program, path)
    return os.path.getsize(path)


class ExportedModel:
    """A loaded inference artifact: ``torch.export.ExportedProgram`` with
    its weights and graph tables, on the device it was exported on.
    Calling it needs ``torch`` and the kernels' op registration, no graph
    build."""

    def __init__(self, program):
        self.program = program
        self._fn = program.module()
        spec = next(s for s in program.graph_signature.input_specs
                    if s.kind == torch.export.graph_signature.InputKind.USER_INPUT)
        node = next(n for n in program.graph.nodes
                    if n.op == "placeholder" and n.name == spec.arg.name)
        self._val = node.meta["val"]

    @property
    def input_shape(self):
        """The input's shape, the symbolic batch shown as ``"b"``."""
        return tuple(d if isinstance(d, int) else "b" for d in self._val.shape)

    @property
    def max_batch(self):
        """The largest batch the artifact serves."""
        b = self._val.shape[0]
        if isinstance(b, int):
            return b
        return int(self.program.range_constraints[b.node.expr].upper)

    @property
    def device(self):
        return self._val.device

    def op_counts(self):
        """{op name: nodes} of the kernels' custom ops in the graph."""
        counts = {}
        for n in self.program.graph.nodes:
            if n.op == "call_function" and str(n.target).startswith(
                    "deepsphere."):
                name = str(n.target).split(".")[1]
                counts[name] = counts.get(name, 0) + 1
        return counts

    def __call__(self, x):
        """Logits of ``x`` (numpy or a tensor), moved to the artifact's
        device; a tensor there."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        with torch.inference_mode():
            return self._fn(x)

    def predict(self, x, batch_size=16):
        """Keras-like convenience: chunked inference -> one numpy array.

        A polymorphic artifact takes chunks of up to its ``max_batch``; a
        fixed-batch artifact needs ``len(x)`` divisible by its batch."""
        x = np.asarray(x)
        baked = self.input_shape[0]
        if isinstance(baked, int):
            if x.shape[0] % baked:
                raise ValueError(
                    f"fixed-batch artifact (batch={baked}): predict needs "
                    f"len(x) divisible by it, got {x.shape[0]} — export "
                    f"with batch_size=None for arbitrary batches"
                )
            batch_size = baked
        batch_size = min(batch_size, self.max_batch)
        outs = [self(x[i:i + batch_size]).cpu().numpy()
                for i in range(0, x.shape[0], batch_size)]
        return np.concatenate(outs, axis=0)


def load_exported(path):
    """Read an artifact written by :func:`save_exported`."""
    return ExportedModel(torch.export.load(path))
