"""HealpyGCNN: the model assembler of the PyTorch port.

Counterpart of the JAX package's ``deepsphere_tpu.models.healpy_gcnn``:
scans the layer list for resolution changes, validates the pixel-index set
against the NEST hierarchy, builds one
:class:`~deepsphere_tpu_torch.graph.SphereGraph` per resolution level
(memoized), instantiates the deferred graph layers, plans the internal
layout (:meth:`HealpyGCNN._plan_internal_layout`) and wires everything into
one ``nn.Module``:

    model = HealpyGCNN(nside, indices, layers)
    model.build((B, n_pix, F), seed=0)     # parameters on the card
    model.compile(optimizer=1e-3, loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    history = model.fit(x, y, batch_size=16, epochs=10)
    logits = model.predict(x, batch_size=16)

Submodules are named ``layer_{i}`` after the user layer list (layout
converters get positional names), the JAX package's ``layers_layer_{i}``
keys, so :func:`deepsphere_tpu_torch.interop.load_jax_variables` can load a
JAX model's variables and :func:`~deepsphere_tpu_torch.interop.export_jax_variables`
write them back; ``layer_names`` holds the JAX package's display names
(``chebyshev``, ``gcnn__residual_layer``, ...).  A sharded model
(``shard_cfg``) has the same parameter tree as an unsharded one.
:meth:`HealpyGCNN.export_inference` / :meth:`HealpyGCNN.save_exported` write
a ``torch.export`` artifact (:mod:`deepsphere_tpu_torch.serve`).
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._logger import logger
from ..graph import build_sphere_graph
from ..nn.healpy_layers import (
    HealpyPool,
    HealpyPseudoConv,
    HealpyPseudoConv_Transpose,
    _DeferredLayer,
)
from ..nn.layers import frozen_running_stats
from ..nn.transformers import GraphViT
from ..sphere import healpix as hp
from ..sphere.indexing import check_indices_consistent, transform_indices
from ..utils.summary import count_params, format_summary

__all__ = ["HealpyGCNN"]


def _remat_contexts():
    """A checkpointed layer's contexts: its forward as it is; its
    recompute in the backward with the running statistics frozen."""
    return contextlib.nullcontext(), frozen_running_stats()


def _layer_display_name(layer, counters):
    """Keras-style snake-case auto names, as the JAX package gives them
    (the reference test suite looks up ``chebyshev`` and
    ``gcnn__residual_layer``)."""
    cls = type(layer).__name__
    base = {
        "ChebyshevConv": "chebyshev",
        "MonomialConv": "monomial",
        "BernsteinConv": "bernstein",
        "ResidualLayer": "gcnn__residual_layer",
        "HealpyPool": "healpy_pool",
        "HealpyPseudoConv": "healpy_pseudo_conv",
        "HealpyPseudoConv_Transpose": "healpy_pseudo_conv__transpose",
        "GraphViT": "graph_vit",
        "Healpy_ViT": "graph_vit",
        "GraphTransformer": "graph_transformer",
        "HealpySmoothing": "healpy_smoothing",
        "Flatten": "flatten",
        "Dense": "dense",
    }.get(cls, cls.lower())
    n = counters.get(base, 0)
    counters[base] = n + 1
    return base if n == 0 else f"{base}_{n}"


class HealpyGCNN(nn.Module):
    """A graph convolutional network on HEALPix maps.

    :param nside: nside of the input maps
    :param indices: 1d array of NEST pixel ids covered by the input
    :param layers: list of layer specs — deferred graph layers
        (``HealpyChebyshev`` & co., ``Healpy_Transformer``, a deferred
        ``HealpySmoothing``), resolution layers (``HealpyPool``,
        ``HealpyPseudoConv``, ``HealpyPseudoConv_Transpose``,
        ``Healpy_ViT``), or any ``nn.Module``
    :param n_neighbors: graph degree; 8 (default), 20, 40 or 60
    :param max_batch_size, initial_Fin: accepted for API parity with the
        reference (no matmul splitting is needed)
    :param graph_cache_dir: optional on-disk cache for built graphs
    :param kernel_width: optional Gaussian kernel width override
    :param shard_cfg: optional :class:`~deepsphere_tpu_torch.parallel.ShardConfig`:
        DP x pixel sharding over a device mesh.  Every rank feeds its data
        rank's rows; the cface convs run face-sharded over the pixel axis
        (when it divides the 12 faces), the other graph convs on the
        halo-sharded ELLPACK, and a transformer's edge attention runs
        pixel-sharded where the pixel count divides over the pixel axis
    :param remat: checkpoint every layer in training
        (``torch.utils.checkpoint``, non-reentrant): the backward recomputes
        each layer's forward instead of keeping its activations, one extra
        forward of work.  It saves what the stack holds between layers at
        the end of the forward; a layer's own working set in its backward
        stays, and where that sets the step's peak (a cface conv's corner
        correction at large nside) remat does not lower it.  Batch norms
        update their running statistics once a step (not again in the
        recompute)
    :param graph_method: "auto" (grid/ring graph where a template exists),
        "grid" or "knn"
    :param internal_layout: "auto" (cface/face planning) or "nest"
    """

    def __init__(
        self,
        nside,
        indices,
        layers,
        n_neighbors=8,
        max_batch_size=None,
        initial_Fin=None,
        graph_cache_dir=None,
        kernel_width=None,
        shard_cfg=None,
        graph_method="auto",
        internal_layout="auto",
        remat=False,
    ):
        super().__init__()
        logger.info(
            "WARNING: This network assumes that everything concerning healpy "
            "is in NEST ordering..."
        )
        if n_neighbors not in [8, 20, 40, 60]:
            raise NotImplementedError(
                f"The requested number of neighbors {n_neighbors} is nor supported. "
                f"Choose either 8, 20, 40 or 60."
            )
        self.nside_in = nside
        self.indices_in = np.asarray(indices, dtype=np.int64)
        self.layers_in = list(layers)
        self.n_neighbors = n_neighbors
        self.shard_cfg = shard_cfg
        self.remat = bool(remat)
        self.max_batch_size = max_batch_size
        self._graph_cache_dir = graph_cache_dir
        self._kernel_width = kernel_width
        if graph_method not in ("auto", "grid", "knn"):
            raise ValueError(f"graph_method must be auto/grid/knn, got {graph_method}")
        self._graph_method = graph_method

        # resolution scan
        self.reduction_fac = 1.0
        for layer in self.layers_in:
            if isinstance(layer, (HealpyPool, HealpyPseudoConv, GraphViT)):
                self.reduction_fac *= 2**layer.p
            if isinstance(layer, HealpyPseudoConv_Transpose):
                self.reduction_fac /= 2**layer.p

        self.nside_out = int(self.nside_in // self.reduction_fac)
        if self.nside_out < 1:
            raise ValueError(
                "With the given input, the layers would reduce the nside below zero!"
                "Use less layers that reduce the nside, e.g. HealpyPool or "
                "HealpyPseudoConv..."
            )
        if not hp.isnsideok(self.nside_out, nest=True):
            raise ValueError(
                f"The ouput of the network does not have a valid nside {self.nside_out}..."
            )
        logger.info(
            f"Detected a reduction factor of {self.reduction_fac}, the input with "
            f"nside {self.nside_in} will be transformed to {self.nside_out} during "
            f"a forward pass. Checking for consistency with indices..."
        )

        # index consistency
        if not check_indices_consistent(self.indices_in, self.nside_in, self.nside_out):
            raise ValueError(
                "With the given indices it would not be possible to properly reduce "
                "the input maps with the reduction factor determined by the layers. "
                "Use the function <extend_indices> from utils with the determined "
                "minimal nside to make your set of indices compatible..."
            )
        logger.info("indices seem consistent...")

        # per-layer build with graph memoization per resolution level
        self.layers_use = []
        self.layer_names = []
        self.graphs = {}
        counters = {}
        current_nside = self.nside_in
        current_indices = self.indices_in
        for layer in self.layers_in:
            if isinstance(layer, _DeferredLayer) and layer.needs == "res":
                # resolution-only layers (a deferred HealpySmoothing): the
                # current nside and indices, no graph Laplacian
                self.layers_use.append(layer._get_layer_res(
                    current_nside, current_indices,
                    cache_dir=self._graph_cache_dir))
            elif isinstance(layer, _DeferredLayer):
                graph = self._get_graph(current_nside, current_indices)
                extra = {}
                if shard_cfg is not None and layer.needs == "L":
                    extra["shard_cfg"] = shard_cfg
                elif (shard_cfg is not None and layer.needs == "A"
                      and graph.n_pixels % shard_cfg.n_pixel_shards == 0):
                    # the transformer's edge attention, pixel-sharded
                    # (parallel.attention_sharded); replicated where the
                    # pixel count does not divide over the pixel axis
                    extra["shard_cfg"] = shard_cfg
                self.layers_use.append(layer._get_layer(graph, **extra))
            elif isinstance(layer, (HealpyPool, HealpyPseudoConv,
                                    HealpyPseudoConv_Transpose, GraphViT)):
                if isinstance(layer, HealpyPseudoConv_Transpose):
                    new_nside = int(current_nside * 2**layer.p)
                else:
                    new_nside = int(current_nside // 2**layer.p)
                current_indices = transform_indices(current_nside, new_nside, current_indices)
                current_nside = new_nside
                self.layers_use.append(layer)
            else:
                self.layers_use.append(layer)
            self.layer_names.append(
                _layer_display_name(self.layers_use[-1], counters))

        self._plan_internal_layout(internal_layout)
        names = []
        counts = {}
        for k, layer in enumerate(self._module_layers):
            if k in self._index_to_module:
                nm = f"layer_{self._index_to_module[k]}"
            else:  # layout converter: parameter-free, positional name ok
                base = type(layer).__name__.lower()
                counts[base] = counts.get(base, 0) + 1
                nm = f"{base}_{counts[base] - 1}"
            names.append(nm)
        self.layers = nn.ModuleDict(dict(zip(names, self._module_layers)))
        self.order = tuple(names)
        self._built_input_shape = None
        self._trainer = None

    def _plan_internal_layout(self, internal_layout):
        """Run as much of the model as possible in the conv's native layout.

        * **cface** — channels-first padded face images (B, F, 12, n, P_l),
          the fused conv's native layout: a chain of convs, residual
          layers, pools and pseudo-convs runs with no per-layer
          permutation.  Chosen for every maximal run of layers whose convs
          fit the deep stencil structurally (so plans do not depend on the
          device).
        * **face** — face-flat pixel axis (B, M, F), for stencil-capable
          convs that cannot run cface (e.g. Bernstein, or a halo deeper
          than the face); pools and pseudo-convs stay in it.

        Under a mesh a cface conv runs face-sharded, so its pixel axis must
        divide the 12 faces; the other convs take the halo-sharded ELLPACK
        in the NEST layout (no face layout), as in the JAX package.
        """
        from ..nn.layers import (
            CfaceReEmbed,
            CfaceToNest,
            FaceToNest,
            NestToCface,
            NestToFace,
            ResidualLayer,
            _GraphPolyConv,
        )
        from ..ops.fused_stencil import cfp_structural_available

        def shardable(layer):
            """A shard_cfg is cface-compatible when its pixel axis divides
            the 12 faces (the conv then runs face-sharded,
            ``parallel.cface_sharded.cface_model_conv``)."""
            cfg = layer.shard_cfg
            return cfg is None or 12 % cfg.n_pixel_shards == 0

        def full_sphere(layer):
            g = layer.graph
            return g.n_pixels == hp.nside2npix(g.nside)

        def cface_info(layer):
            """("cf", h) for a cface-capable conv, ("sif",) for a pass-through
            geometry layer, else None."""
            if internal_layout == "nest":
                return None
            if isinstance(layer, _GraphPolyConv):
                if (not shardable(layer)
                        or layer.conv_method not in ("auto", "stencil")
                        or not full_sphere(layer)):
                    return None
                n_terms = layer.n_terms
                if layer._basis_kind not in ("cheby", "mono") or n_terms < 2:
                    return None
                st = layer.graph.deep_stencil(layer._scale, n_terms)
                if st is None or not cfp_structural_available(
                    st, layer._basis_kind, n_terms
                ):
                    return None
                return ("cf", st.n_steps)
            if isinstance(layer, ResidualLayer):
                scales = {"CHEBY": 0.75, "MONO": 1.0}
                if (not shardable(layer) or layer.layer_type not in scales
                        or not full_sphere(layer)):
                    return None
                K = dict(layer.layer_kwargs or {}).get("K", None)
                if K is None or K < 2:
                    return None
                st = layer.graph.deep_stencil(scales[layer.layer_type], K)
                kind = "cheby" if layer.layer_type == "CHEBY" else "mono"
                if st is None or not cfp_structural_available(st, kind, K):
                    return None
                return ("cf", st.n_steps)
            if isinstance(layer, stay_in_face):
                return ("sif",)
            return None

        def face_version(layer):
            if internal_layout == "nest":
                return None
            if isinstance(layer, _GraphPolyConv):
                if (
                    layer.shard_cfg is None
                    and layer.conv_method in ("auto", "stencil")
                    and full_sphere(layer)
                    and layer.graph.face_stencil(layer._scale) is not None
                ):
                    return layer.clone(layout="face")
            if isinstance(layer, ResidualLayer):
                scales = {"CHEBY": 0.75, "MONO": 1.0}
                if (
                    layer.shard_cfg is None
                    and layer.layer_type in scales
                    and full_sphere(layer)
                    and layer.graph.face_stencil(scales[layer.layer_type])
                    is not None
                ):
                    return layer.clone(layout="face")
            return None  # pools and pseudo-convs: stay-in-face only

        stay_in_face = (HealpyPool, HealpyPseudoConv,
                        HealpyPseudoConv_Transpose)

        # 1) carve out cface segments: maximal runs of (cf | sif) layers
        #    containing at least one conv
        infos = [cface_info(l) for l in self.layers_use]
        n_layers = len(self.layers_use)
        seg_of = [-1] * n_layers
        segments = []
        i = 0
        while i < n_layers:
            if infos[i] is None:
                i += 1
                continue
            j = i
            while j < n_layers and infos[j] is not None:
                j += 1
            if any(infos[t][0] == "cf" for t in range(i, j)):
                for t in range(i, j):
                    seg_of[t] = len(segments)
                segments.append((i, j))
            i = j

        def next_cf_h(t, j):
            for u in range(t, j):
                if infos[u][0] == "cf":
                    return infos[u][1]
            return 0

        # 2) emit, falling back to the face layout outside cface segments
        self._module_layers = []
        self._index_to_module = {}
        in_face = False
        cur_off = 0
        for i, layer in enumerate(self.layers_use):
            if seg_of[i] >= 0:
                a, j = segments[seg_of[i]]
                if in_face:
                    self._module_layers.append(FaceToNest())
                    in_face = False
                if i == a:  # segment entry
                    cur_off = next_cf_h(a, j)
                    self._module_layers.append(
                        NestToCface(off=cur_off, shard_cfg=self.shard_cfg))
                if infos[i][0] == "cf":
                    h = infos[i][1]
                    if cur_off != h:
                        self._module_layers.append(
                            CfaceReEmbed(off_in=cur_off, off_out=h)
                        )
                    actual = layer.clone(layout="cface")
                    cur_off = h
                else:  # sif: pool / pseudo-conv — re-embeds for the next conv
                    off_out = next_cf_h(i + 1, j)
                    actual = layer.clone(
                        layout="cface", cface_off=cur_off,
                        cface_off_out=off_out,
                    )
                    cur_off = off_out
                self._module_layers.append(actual)
                self._index_to_module[len(self._module_layers) - 1] = i
                self.layers_use[i] = actual
                if i == j - 1:  # segment exit
                    self._module_layers.append(
                        CfaceToNest(off=cur_off, shard_cfg=self.shard_cfg))
                continue

            fc = face_version(layer)
            if fc is not None:
                if not in_face:
                    self._module_layers.append(NestToFace())
                    in_face = True
                actual = fc
            elif in_face and isinstance(layer, stay_in_face):
                actual = layer.clone(layout="face")
            else:
                if in_face:
                    self._module_layers.append(FaceToNest())
                    in_face = False
                actual = layer
            self._module_layers.append(actual)
            self._index_to_module[len(self._module_layers) - 1] = i
            self.layers_use[i] = actual
        if in_face:
            self._module_layers.append(FaceToNest())

    def _get_graph(self, nside, indices):
        key = (nside, hash(np.ascontiguousarray(indices).tobytes()))
        if key not in self.graphs:
            from ..graph.laplacian import GRID_RADIUS

            method = self._graph_method
            if method == "auto":
                method = "grid" if self.n_neighbors in GRID_RADIUS else "knn"
            self.graphs[key] = build_sphere_graph(
                nside,
                indices,
                k=self.n_neighbors,
                lap_type="normalized",
                kernel_width=self._kernel_width,
                cache_dir=self._graph_cache_dir,
                method=method,
            )
        return self.graphs[key]

    def forward(self, x):
        """The layers in order.  Each runs under a ``torch.profiler``
        scope named ``{class}_{key}`` (the JAX package's ``named_scope``
        names) while a profiler records, so per-layer costs show in its
        traces; with ``remat`` a training forward under autograd
        checkpoints each layer."""
        remat = self.remat and self.training and torch.is_grad_enabled()
        scoped = torch.autograd._profiler_enabled()
        for key in self.order:
            layer = self.layers[key]
            with (torch.profiler.record_function(
                    f"{type(layer).__name__}_{key}") if scoped
                  else contextlib.nullcontext()):
                if remat:
                    x = checkpoint(layer, x, use_reentrant=False,
                                   context_fn=_remat_contexts)
                else:
                    x = layer(x)
        return x

    def build(self, input_shape, seed=0, device=None):
        """Create the parameters and graph tables on ``device`` (default
        ``"cuda"``; pass ``device="cpu"`` for the CPU) by running one
        eval-mode forward on zeros of ``(1,) + input_shape[1:]``.  The
        weights come from a seeded CPU ``torch.Generator``, so they are the
        same on either device.  Raises when the card is asked for and there
        is none."""
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "HealpyGCNN.build: no CUDA card; pass device='cpu' to build "
                "on the CPU")
        gen = torch.Generator().manual_seed(int(seed))
        lazy = [m for m in self.modules() if hasattr(m, "_init_generator")]
        for m in lazy:
            m._init_generator = gen
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                self(torch.zeros((1,) + tuple(input_shape[1:]), device=dev))
        finally:
            self.train(was_training)
            for m in lazy:
                m._init_generator = None
        self._built_input_shape = tuple(input_shape)
        return self

    def get_layer(self, name=None, index=None):
        """Layer instance by display name or position."""
        if index is not None:
            return self.layers_use[index]
        if name is not None:
            if name not in self.layer_names:
                raise ValueError(f"No such layer: {name}. Layers: {self.layer_names}")
            return self.layers_use[self.layer_names.index(name)]
        raise ValueError("Provide a layer name or index.")

    def param_key(self, index):
        """The key of the user layer at ``index`` in :attr:`layers` (its
        entries sit under ``layers.<key>.`` in the ``state_dict``): the JAX
        package's ``layers_layer_{index}`` without its prefix, stable across
        layout plans (the layout converters take other names)."""
        return f"layer_{index}"

    def summary(self, input_shape=None, line_length=None, print_fn=print):
        """Print a Keras-style table: each user layer's display name, type,
        output shape and parameter count, and the total of parameters and
        batch statistics (the graph tables are not counted).  The output
        shapes come from forward hooks on one eval forward of zeros of
        ``input_shape`` (default: the built shape) on the model's device;
        an unbuilt model is summarised through a copy built on the CPU."""
        if input_shape is None:
            if self._built_input_shape is None:
                raise ValueError("Call build(input_shape) first or pass input_shape.")
            input_shape = self._built_input_shape
        model = self
        if self._built_input_shape is None:
            model = copy.deepcopy(self).build(input_shape, device="cpu")
        shapes = model._layer_output_shapes(input_shape)
        rows = []
        for i, (name, layer) in enumerate(zip(model.layer_names,
                                              model.layers_use)):
            nparams = sum(p.numel() for p in layer.parameters())
            rows.append((name, type(layer).__name__,
                         shapes.get(model.param_key(i), "?"), nparams))
        print_fn(format_summary("HealpyGCNN", rows, count_params(model)))

    def _layer_output_shapes(self, input_shape):
        """Map :meth:`param_key` -> output shape, from forward hooks on one
        eval forward of zeros on the model's device."""
        shapes = {}
        hooks = [self.layers[key].register_forward_hook(
            lambda mod, args, out, key=key: shapes.__setitem__(
                key, tuple(out.shape)))
            for key in (self.param_key(i) for i in range(len(self.layers_use)))]
        dev = next(iter(self.state_dict().values())).device
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                self(torch.zeros(tuple(input_shape), device=dev))
        finally:
            self.train(was_training)
            for hk in hooks:
                hk.remove()
        return shapes

    # ------------------------------------------------------------------
    # filter extraction + visualization
    # (parity with healpy_networks.py:190-385; pygsp replaced by
    #  viz.SphericalFilterBank over the layer's own graph)
    # ------------------------------------------------------------------

    def _resolve_conv_layer(self, layer):
        """Layer spec (index or display name) -> (index, layer instance)."""
        if isinstance(layer, int):
            idx = layer
        elif isinstance(layer, str):
            if layer not in self.layer_names:
                raise ValueError(f"No such layer: {layer}. Layers: {self.layer_names}")
            idx = self.layer_names.index(layer)
        else:
            raise ValueError("layer should be either string or int.")
        return idx, self.layers_use[idx]

    @staticmethod
    def _coeffs_from_kernel(kernel, K, ind_in=None, ind_out=None):
        """(Fin*K, Fout) kernel -> (K, Fout, Fin) coefficients — the reshape
        and slicing semantics of ``_get_filter_coeffs``
        (healpy_networks.py:190-212)."""
        kernel = np.asarray(kernel)
        Fout = kernel.shape[-1]
        coeffs = kernel.reshape((-1, K, Fout)).transpose([1, 2, 0])
        if ind_in is not None:
            coeffs = coeffs[:, :, np.atleast_1d(ind_in)]
        if ind_out is not None:
            coeffs = coeffs[:, np.atleast_1d(ind_out), :]
        return coeffs

    def get_filters(self, layer, ind_in=None, ind_out=None, return_weights=False):
        """Trained filters of a Chebyshev (or residual-of-Chebyshev) layer as
        :class:`~deepsphere_tpu_torch.viz.SphericalFilterBank` objects on
        the model's device (the ``get_gsp_filters`` analogue,
        healpy_networks.py:214-289).

        :param layer: layer index or display name
        :param return_weights: return the raw (K, Fout, Fin) coeff arrays
        :return: list of filter banks (two for a residual layer)
        """
        from ..nn.layers import ChebyshevConv, ResidualLayer
        from ..viz import SphericalFilterBank

        if self._built_input_shape is None:
            raise ValueError("Build the model first (model.build(input_shape)).")
        idx, lyr = self._resolve_conv_layer(layer)

        if isinstance(lyr, ResidualLayer):
            if lyr.layer_type != "CHEBY":
                raise ValueError(
                    f"The requested layer ({layer}) is a residual layer of type "
                    f"{lyr.layer_type}; only CHEBY residual layers are supported..."
                )
            K = dict(lyr.layer_kwargs or {}).get("K")
            kernels = [lyr.layer1.kernel, lyr.layer2.kernel]
            graph = lyr.graph
        elif isinstance(lyr, ChebyshevConv):
            K = lyr.K
            kernels = [lyr.kernel]
            graph = lyr.graph
        else:
            raise ValueError(
                f"The requested layer ({layer}) is of type {type(lyr).__name__}, "
                f"but only ChebyshevConv or ResidualLayer layers (with CHEBY "
                f"sublayers) are supported..."
            )

        weights = [self._coeffs_from_kernel(k.detach().cpu().numpy(), K,
                                            ind_in, ind_out)
                   for k in kernels]
        if return_weights:
            return weights
        dev = kernels[0].device
        return [SphericalFilterBank(graph, w, kind="cheby", device=dev)
                for w in weights]

    # pygsp-era name kept for drop-in compatibility
    get_gsp_filters = get_filters

    def plot_chebyshev_coeffs(self, layer, ind_in=None, ind_out=None, ax=None,
                              title="Chebyshev coefficients - layer {}"):
        """Scatter the Chebyshev coefficients of a layer
        (healpy_networks.py:291-310)."""
        import matplotlib.pyplot as plt

        weights = self.get_filters(layer, ind_in, ind_out, return_weights=True)
        if ax is None:
            ax = plt.gca()
        for weight in weights:
            K, Fout, Fin = weight.shape
            ax.plot(weight.reshape((K, Fin * Fout)), ".")
            ax.set_title(title.format(layer))
        return ax

    def plot_filters_spectral(self, layer, ind_in=None, ind_out=None, ax=None, **kwargs):
        """Spectral response of a layer's filters
        (healpy_networks.py:312-329)."""
        import matplotlib.pyplot as plt

        banks = self.get_filters(layer, ind_in=ind_in, ind_out=ind_out)
        if ax is None:
            ax = plt.gca()
        for bank in banks:
            x = np.linspace(-bank.scale, bank.scale, 200)
            resp = bank.evaluate(x)  # (Fout, Fin, n_x)
            # plot in the unrescaled eigenvalue domain [0, lmax]
            lam = (x / bank.scale + 1.0) * bank.graph.lmax / 2.0
            for fo in range(resp.shape[0]):
                for fi in range(resp.shape[1]):
                    ax.plot(lam, resp[fo, fi], **kwargs)
            ax.set_xlabel(r"$\lambda$")
            ax.set_ylabel(r"$\hat{g}(\lambda)$")
        return ax

    def plot_filters_section(self, layer, ind_in=None, ind_out=None, **kwargs):
        """Equator cross-sections of a layer's localized filters
        (healpy_networks.py:331-357)."""
        from ..viz import plot_filters_section as _pfs

        banks = self.get_filters(layer, ind_in=ind_in, ind_out=ind_out)
        order = banks[0].K
        return [_pfs(bank, order=order, **kwargs) for bank in banks]

    def plot_filters_gnomonic(self, layer, ind_in=None, ind_out=None, **kwargs):
        """Gnomonic views of a layer's localized filters
        (healpy_networks.py:359-385)."""
        from ..viz import plot_filters_gnomonic as _pfg

        banks = self.get_filters(layer, ind_in=ind_in, ind_out=ind_out)
        order = banks[0].K
        return [_pfg(bank, order=order, **kwargs) for bank in banks]

    def _predict(self, x, batch_size=16):
        if self._built_input_shape is None:
            raise ValueError("Build the model first (model.build(input_shape)).")
        dev = next(self.parameters()).device
        was_training = self.training
        self.eval()
        outs = []
        try:
            with torch.inference_mode():
                for start in range(0, x.shape[0], batch_size):
                    xb = torch.as_tensor(x[start:start + batch_size],
                                         dtype=torch.float32).to(dev)
                    outs.append(self(xb).cpu().numpy())
        finally:
            self.train(was_training)
        return np.concatenate(outs, axis=0)

    def predict(self, x, batch_size=16):
        """Logits of ``x`` (N, n_pix, F), numpy or tensor, in eval mode and
        under ``torch.inference_mode``, ``batch_size`` maps at a time on
        the model's device (through the trainer once compiled).  Returns a
        numpy array."""
        if self._trainer is not None:
            return self._trainer.predict(x, batch_size=batch_size)
        return self._predict(x, batch_size=batch_size)

    # ------------------------------------------------------------------
    # Keras-style training surface (delegates to train.Trainer)
    # ------------------------------------------------------------------

    def compile(self, optimizer=1e-3, loss="sparse_categorical_crossentropy",
                metrics=(), data_sharding=None):
        from ..train import Trainer

        self._trainer = Trainer(
            self, optimizer=optimizer, loss=loss, metrics=metrics,
            data_sharding=data_sharding,
        )
        return self._trainer

    def _require_trainer(self):
        if self._trainer is None:
            raise ValueError("Call compile(...) before fit/evaluate.")
        return self._trainer

    def fit(self, x, y, batch_size=16, epochs=1, validation_data=None,
            shuffle=True, verbose=1, callbacks=None):
        if self._built_input_shape is None:
            self.build((batch_size,) + tuple(np.asarray(x).shape[1:]))
        return self._require_trainer().fit(
            x, y, batch_size=batch_size, epochs=epochs,
            validation_data=validation_data, shuffle=shuffle, verbose=verbose,
            callbacks=callbacks,
        )

    def evaluate(self, x, y, batch_size=16, verbose=1):
        return self._require_trainer().evaluate(x, y, batch_size=batch_size,
                                                verbose=verbose)

    # ------------------------------------------------------------------
    # checkpointing (torch.save of the state_dict)
    # ------------------------------------------------------------------

    def save_weights(self, path):
        """Write the parameters and batch statistics (``state_dict``).  The
        graph tables are non-persistent buffers, deterministic precompute,
        and stay out of the file."""
        if self._built_input_shape is None:
            raise ValueError("Model has no variables yet; call build() first.")
        torch.save(self.state_dict(), path)

    def load_weights(self, path):
        """Load what :meth:`save_weights` wrote into this built model, on
        its device."""
        if self._built_input_shape is None:
            raise ValueError("Build the model before loading weights.")
        dev = next(self.parameters()).device
        self.load_state_dict(torch.load(path, map_location=dev), strict=True)
        return self

    def load_weights_from_reference(self, path):
        """Import a checkpoint written by the TF2 reference's
        ``HealpyGCNN.save_weights('*.weights.h5')`` — the reference's
        deployment unit (``tests/test_healpy_networks.py:133-152``) — into
        this (built) model, on its device.  See
        :func:`deepsphere_tpu_torch.train.import_keras_h5` (needs h5py)."""
        from ..train.import_ref import import_keras_h5

        return import_keras_h5(path, self)

    # ------------------------------------------------------------------
    # serving export (torch.export artifact)
    # ------------------------------------------------------------------

    def export_inference(self, *, batch_size=None):
        """Trace inference to a ``torch.export.ExportedProgram`` with the
        weights and graph tables held as constants — see
        :mod:`deepsphere_tpu_torch.serve`."""
        from ..serve import export_inference

        return export_inference(self, batch_size=batch_size)

    def save_exported(self, path, *, batch_size=None):
        """Write an inference artifact (``torch.export``) to ``path``; load
        it with :func:`deepsphere_tpu_torch.serve.load_exported` (needs
        torch and this package's kernel ops, no graph build).  Returns the
        byte count."""
        from ..serve import save_exported

        return save_exported(path, self, batch_size=batch_size)
