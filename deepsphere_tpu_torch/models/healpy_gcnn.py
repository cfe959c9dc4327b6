"""HealpyGCNN: the model assembler of the PyTorch port.

Counterpart of the JAX package's ``deepsphere_tpu.models.healpy_gcnn``:
scans the layer list for resolution changes, validates the pixel-index set
against the NEST hierarchy, builds one
:class:`~deepsphere_tpu_torch.graph.SphereGraph` per resolution level
(memoized), instantiates the deferred graph layers, plans the internal
layout (:meth:`HealpyGCNN._plan_internal_layout`) and wires everything into
one ``nn.Module``:

    model = HealpyGCNN(nside, indices, layers)
    model.build((B, n_pix, F), seed=0)     # creates the parameters (CPU)
    model.to("cuda")
    logits = model.predict(x, batch_size=16)

Submodules are named ``layer_{i}`` after the user layer list (layout
converters get positional names), the JAX package's ``layers_layer_{i}``
keys, so :func:`deepsphere_tpu_torch.interop.load_jax_variables` can load a
JAX model's variables.  Only inference is ported: training, checkpoints
and export come later (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .._logger import logger
from ..graph import build_sphere_graph
from ..nn.healpy_layers import HealpyPool, _DeferredLayer
from ..sphere import healpix as hp
from ..sphere.indexing import check_indices_consistent, transform_indices

__all__ = ["HealpyGCNN"]


class HealpyGCNN(nn.Module):
    """A graph convolutional network on HEALPix maps.

    :param nside: nside of the input maps
    :param indices: 1d array of NEST pixel ids covered by the input
    :param layers: list of layer specs — deferred graph layers
        (``HealpyChebyshev`` & co.), ``HealpyPool``, or any ``nn.Module``
    :param n_neighbors: graph degree; 8 (default), 20, 40 or 60
    :param max_batch_size, initial_Fin: accepted for API parity with the
        reference (no matmul splitting is needed)
    :param graph_cache_dir: optional on-disk cache for built graphs
    :param kernel_width: optional Gaussian kernel width override
    :param shard_cfg, remat: sharding and rematerialization are not ported
        yet; anything but the defaults raises ``NotImplementedError``
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
        if shard_cfg is not None:
            raise NotImplementedError(
                "shard_cfg: sharded execution is not ported yet (ROADMAP.md, "
                "queue 1, parallel)")
        if remat:
            raise NotImplementedError(
                "remat is a training option; training is not ported yet")

        self.nside_in = nside
        self.indices_in = np.asarray(indices, dtype=np.int64)
        self.layers_in = list(layers)
        self.n_neighbors = n_neighbors
        self.max_batch_size = max_batch_size
        self._graph_cache_dir = graph_cache_dir
        self._kernel_width = kernel_width
        if graph_method not in ("auto", "grid", "knn"):
            raise ValueError(f"graph_method must be auto/grid/knn, got {graph_method}")
        self._graph_method = graph_method

        # resolution scan
        self.reduction_fac = 1.0
        for layer in self.layers_in:
            if isinstance(layer, HealpyPool):
                self.reduction_fac *= 2**layer.p

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
        self.graphs = {}
        current_nside = self.nside_in
        current_indices = self.indices_in
        for layer in self.layers_in:
            if isinstance(layer, _DeferredLayer):
                graph = self._get_graph(current_nside, current_indices)
                self.layers_use.append(layer._get_layer(graph))
            elif isinstance(layer, HealpyPool):
                new_nside = int(current_nside // 2**layer.p)
                current_indices = transform_indices(current_nside, new_nside, current_indices)
                current_nside = new_nside
                self.layers_use.append(layer)
            else:
                self.layers_use.append(layer)

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

    def _plan_internal_layout(self, internal_layout):
        """Run as much of the model as possible in the conv's native layout.

        * **cface** — channels-first padded face images (B, F, 12, n, P_l),
          the fused conv's native layout: a chain of convs and pools runs
          with no per-layer permutation.  Chosen for every maximal run of
          layers whose convs fit the deep stencil structurally (so plans do
          not depend on the device).
        * **face** — face-flat pixel axis (B, M, F), for stencil-capable
          convs that cannot run cface (e.g. a halo deeper than the face).
        """
        from ..nn.layers import (
            CfaceReEmbed,
            CfaceToNest,
            FaceToNest,
            NestToCface,
            NestToFace,
            _GraphPolyConv,
        )
        from ..ops.fused_stencil import cfp_structural_available

        def full_sphere(layer):
            g = layer.graph
            return g.n_pixels == hp.nside2npix(g.nside)

        def cface_info(layer):
            """("cf", h) for a cface-capable conv, ("sif",) for a pass-through
            geometry layer, else None."""
            if internal_layout == "nest":
                return None
            if isinstance(layer, _GraphPolyConv):
                if layer.conv_method not in ("auto", "stencil") or not full_sphere(layer):
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
            if isinstance(layer, HealpyPool):
                return ("sif",)
            return None

        def face_version(layer):
            if internal_layout == "nest":
                return None
            if isinstance(layer, _GraphPolyConv):
                if (
                    layer.conv_method in ("auto", "stencil")
                    and full_sphere(layer)
                    and layer.graph.face_stencil(layer._scale) is not None
                ):
                    return layer.clone(layout="face")
            return None

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
                    self._module_layers.append(NestToCface(off=cur_off))
                if infos[i][0] == "cf":
                    h = infos[i][1]
                    if cur_off != h:
                        self._module_layers.append(
                            CfaceReEmbed(off_in=cur_off, off_out=h)
                        )
                    actual = layer.clone(layout="cface")
                    cur_off = h
                else:  # sif: pool — re-embeds for the next conv
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
                    self._module_layers.append(CfaceToNest(off=cur_off))
                continue

            fc = face_version(layer)
            if fc is not None:
                if not in_face:
                    self._module_layers.append(NestToFace())
                    in_face = True
                actual = fc
            elif in_face and isinstance(layer, HealpyPool):
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
        for key in self.order:
            x = self.layers[key](x)
        return x

    def build(self, input_shape, seed=0):
        """Create the parameters (on the CPU, from a seeded
        ``torch.Generator``) by running one eval-mode forward on zeros of
        ``(1,) + input_shape[1:]``; move the model afterwards."""
        gen = torch.Generator().manual_seed(int(seed))
        lazy = [m for m in self.modules() if hasattr(m, "_init_generator")]
        for m in lazy:
            m._init_generator = gen
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                self(torch.zeros((1,) + tuple(input_shape[1:])))
        finally:
            self.train(was_training)
            for m in lazy:
                m._init_generator = None
        self._built_input_shape = tuple(input_shape)
        return self

    def predict(self, x, batch_size=16):
        """Logits of ``x`` (N, n_pix, F), numpy or tensor, in eval mode and
        under ``torch.inference_mode``, ``batch_size`` maps at a time on
        the model's device.  Returns a numpy array."""
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
