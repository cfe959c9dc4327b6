"""Graph attention layers: a ViT over NEST superpixels and the edge-sparse
graph transformer.

Counterpart of the JAX package's ``deepsphere_tpu.nn.transformers``:

* ``AddPositionEmbs`` — a learned additive positional embedding (1, S, E),
  normal(0.02) init;
* ``MultiHeadAttention`` — the pre-LN block with the reference's residual
  wiring: LayerNorm (epsilon 1e-3, a scale and a bias), q/k/v projections,
  dense or edge-sparse attention, the residual adding the *normed* input,
  then LayerNorm -> Dense -> activation -> a second residual;
* ``GraphViT`` — patches of 4^p NEST pixels embedded by a blocked matmul
  (a Conv1D whose kernel == stride), then dense-attention blocks; p must
  exceed 1, as in the reference;
* ``GraphTransformer`` — full-resolution attention masked by the graph's
  edges (``SphereGraph.edge_idx``): a Dense embedding, then edge-sparse
  blocks; under ``shard_cfg`` the attention runs pixel-sharded
  (:mod:`..parallel.attention_sharded`).

Parameter names follow the flax modules (``wq``/``wk``/``wv``/``dense``
with ``kernel`` (in, out) and ``bias``, ``layer_norm1``/``layer_norm2``
with ``scale`` and ``bias``, ``pos_encoder.pos_embedding``,
``embed_kernel``/``embed_bias``, ``embed``, ``mha_{i}``), so a JAX tree maps
onto ``named_parameters`` one to one (:mod:`..interop`).  Parameters are
created at the first forward from the layer's ``_init_generator``, as the
other layers' are.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.attention import edge_sparse_attention, scaled_dot_product_attention
from ..utils import resolve_activation
from .layers import _glorot_uniform, _Layer, _LayerNorm, _truncated_normal

__all__ = ["AddPositionEmbs", "MultiHeadAttention", "GraphViT",
           "GraphTransformer"]


class _Dense(_Layer):
    """flax ``nn.Dense``: y = x @ kernel + bias, kernel (in, out) from
    lecun_normal, bias zeros."""

    def __init__(self, features):
        super().__init__(features=features)
        self.features = features
        self.register_parameter("kernel", None)
        self.register_parameter("bias", None)

    def forward(self, x):
        if self.kernel is None:
            fan_in = x.shape[-1]
            # lecun_normal: variance 1/fan_in, truncated at +-2 sigma of the
            # untruncated normal (flax's variance_scaling rescale)
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            self.kernel = nn.Parameter(_truncated_normal(
                (fan_in, self.features), std, self._init_generator
            ).to(x.device))
            self.bias = nn.Parameter(torch.zeros(self.features,
                                                 device=x.device))
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


class AddPositionEmbs(_Layer):
    """Adds a learned positional embedding of shape (1, seq, emb).

    ``posemb_init``: a callable of (shape, generator) returning the initial
    embedding, as the convs' ``initializer``; None draws N(0, 0.02)."""

    def __init__(self, posemb_init=None):
        super().__init__(posemb_init=posemb_init)
        self.posemb_init = posemb_init
        self.register_parameter("pos_embedding", None)

    def forward(self, x):
        if self.pos_embedding is None:
            shape = (1,) + tuple(x.shape[1:])
            if self.posemb_init is None:
                w = torch.randn(shape, generator=self._init_generator) * 0.02
            else:
                w = self.posemb_init(shape, self._init_generator)
            self.pos_embedding = nn.Parameter(w.to(x.device))
        return x + self.pos_embedding.to(x.dtype)


class _EdgeSet:
    """A static (E, 2) (dst, src) edge list, sorted by dst, and its node
    count."""

    def __init__(self, edge_idx, num_nodes):
        self.edge_idx = np.asarray(edge_idx, dtype=np.int64)
        self.num_nodes = int(num_nodes)


class MultiHeadAttention(_Layer):
    """Pre-LN multi-head attention block (dense, or edge-sparse over
    ``edges``) with a one-layer MLP.

    With ``shard_cfg`` (and ``edges``) the edge-sparse attention runs
    pixel-sharded: each pixel rank takes its destination chunk of the
    edges and its pixels of q, with the whole of k and v (its gradient
    summed over the ranks), and the ranks' outputs are gathered back, so
    the block's input and output are the whole map on every pixel rank,
    as every NEST activation under a mesh.
    """

    def __init__(self, d_model, num_heads, use_norm=True, activation="relu",
                 edges=None, shard_cfg=None):
        super().__init__(d_model=d_model, num_heads=num_heads,
                         use_norm=use_norm, activation=activation,
                         edges=edges, shard_cfg=shard_cfg)
        assert d_model % num_heads == 0
        self.d_model = d_model
        self.num_heads = num_heads
        self.use_norm = use_norm
        self.activation = activation
        self.edges = edges
        self.shard_cfg = shard_cfg
        # the norms are made at the first forward, on its device
        self.layer_norm1 = None
        self.wq = _Dense(d_model)
        self.wk = _Dense(d_model)
        self.wv = _Dense(d_model)
        self.layer_norm2 = None
        self.dense = _Dense(d_model)
        self._edge_keys = ()

    def _norms(self, device):
        if self.layer_norm1 is None:
            # epsilon: tf.keras.layers.LayerNormalization's default (1e-3)
            self.layer_norm1 = _LayerNorm(self.d_model, epsilon=1e-3).to(device)
            self.layer_norm2 = _LayerNorm(self.d_model, epsilon=1e-3).to(device)
        return self.layer_norm1, self.layer_norm2

    def _edge_tables(self, device):
        """The edge list (or, sharded, this pixel rank's chunk and its
        mask) as non-persistent buffers on ``device``, made at the first
        forward: out of ``state_dict``, moved by ``.to``."""
        if not self._edge_keys:
            if self.shard_cfg is not None:
                from ..parallel.attention_sharded import partition_edges_by_dst

                cfg = self.shard_cfg
                parts, mask = partition_edges_by_dst(
                    self.edges.edge_idx, self.edges.num_nodes,
                    cfg.n_pixel_shards)
                tables = {"edges_parts": parts[cfg.pixel_rank],
                          "edges_mask": mask[cfg.pixel_rank]}
            else:
                tables = {"edges": self.edges.edge_idx}
            for k, v in tables.items():
                self.register_buffer(f"tab_{k}", torch.from_numpy(v).to(device),
                                     persistent=False)
            self._edge_keys = tuple(tables)
        return [getattr(self, f"tab_{k}") for k in self._edge_keys]

    def forward(self, x, mask=None):
        B, S, _ = x.shape
        depth = self.d_model // self.num_heads
        if self.use_norm:
            norm1, norm2 = self._norms(x.device)
            x = norm1(x)

        def split_heads(t):
            return t.reshape(B, S, self.num_heads, depth).permute(0, 2, 1, 3)

        q = split_heads(self.wq(x))
        k = split_heads(self.wk(x))
        v = split_heads(self.wv(x))
        if self.edges is None:
            attn, _ = scaled_dot_product_attention(q, k, v, mask)
        elif self.shard_cfg is not None:
            from ..parallel.attention_sharded import sharded_edge_attention
            from ..parallel.collectives import shard, unshard

            g = self.shard_cfg.pixel_group
            parts, emask = self._edge_tables(x.device)
            attn = unshard(sharded_edge_attention(
                shard(q, 2, g), k, v, parts, emask, g), 2, g)
        else:
            (edges,) = self._edge_tables(x.device)
            attn = edge_sparse_attention(q, k, v, edges, self.edges.num_nodes)
        attn = attn.permute(0, 2, 1, 3).reshape(B, S, self.d_model)

        # the residual adds the *normed* input (gnn_transformers.py:234)
        concat = x + attn
        out = norm2(concat) if self.use_norm else concat
        out = self.dense(out)
        act = resolve_activation(self.activation)
        if act is not None:
            out = act(out)
        return out + concat


class GraphViT(_Layer):
    """ViT over 4^p NEST superpixels: blocked-matmul patch embedding,
    positional embedding, ``n_layers`` dense MHA blocks.  Output (B,
    M/4^p, key_dim * num_heads)."""

    def __init__(self, p, key_dim, num_heads, positional_encoding=True,
                 n_layers=1, activation="relu", layer_norm=True):
        super().__init__(p=p, key_dim=key_dim, num_heads=num_heads,
                         positional_encoding=positional_encoding,
                         n_layers=n_layers, activation=activation,
                         layer_norm=layer_norm)
        if not p > 1:
            raise IOError("The super pixel size factor p has to be at least 1!")
        assert n_layers >= 1, "Number of attention layers should be at least 1"
        self.p = p
        self.key_dim = key_dim
        self.num_heads = num_heads
        self.positional_encoding = positional_encoding
        self.n_layers = n_layers
        self.activation = activation
        self.layer_norm = layer_norm
        self.register_parameter("embed_kernel", None)
        self.register_parameter("embed_bias", None)
        self.pos_encoder = AddPositionEmbs() if positional_encoding else None
        for i in range(n_layers):
            setattr(self, f"mha_{i}", MultiHeadAttention(
                self.embedding_size, num_heads, use_norm=layer_norm,
                activation=activation))

    @property
    def filter_size(self):
        return int(4**self.p)

    @property
    def embedding_size(self):
        return self.key_dim * self.num_heads

    def forward(self, x):
        B, M, Fin = x.shape
        fs = self.filter_size
        if M % fs != 0:
            raise IOError(
                f"Input shape {tuple(x.shape)} not compatible with the "
                f"embedding filter size {fs}"
            )
        if self.embed_kernel is None:
            self.embed_kernel = nn.Parameter(_glorot_uniform(
                (fs * Fin, self.embedding_size), self._init_generator
            ).to(x.device))
            self.embed_bias = nn.Parameter(torch.zeros(self.embedding_size,
                                                       device=x.device))
        # a Conv1D with kernel == stride == 4^p is one blocked matmul
        y = (x.reshape(B, M // fs, fs * Fin) @ self.embed_kernel.to(x.dtype)
             + self.embed_bias.to(x.dtype))
        if self.positional_encoding:
            y = self.pos_encoder(y)
        for i in range(self.n_layers):
            y = getattr(self, f"mha_{i}")(y)
        return y


class GraphTransformer(_Layer):
    """Full-resolution graph transformer, its attention masked by the
    adjacency edge set of a :class:`~deepsphere_tpu_torch.graph.SphereGraph`
    (or any explicit ``_EdgeSet``)."""

    def __init__(self, edges, key_dim, num_heads, positional_encoding=True,
                 n_layers=1, activation="relu", layer_norm=True,
                 shard_cfg=None):
        super().__init__(edges=edges, key_dim=key_dim, num_heads=num_heads,
                         positional_encoding=positional_encoding,
                         n_layers=n_layers, activation=activation,
                         layer_norm=layer_norm, shard_cfg=shard_cfg)
        assert n_layers >= 1, "Number of attention layers should be at least 1"
        self.edges = edges
        self.key_dim = key_dim
        self.num_heads = num_heads
        self.positional_encoding = positional_encoding
        self.n_layers = n_layers
        self.activation = activation
        self.layer_norm = layer_norm
        self.shard_cfg = shard_cfg
        self.embed = _Dense(self.embedding_size)
        self.pos_encoder = AddPositionEmbs() if positional_encoding else None
        for i in range(n_layers):
            setattr(self, f"mha_{i}", MultiHeadAttention(
                self.embedding_size, num_heads, use_norm=layer_norm,
                activation=activation, edges=edges, shard_cfg=shard_cfg))

    @classmethod
    def from_graph(cls, graph, **kwargs):
        return cls(edges=_EdgeSet(graph.edge_idx, graph.n_pixels), **kwargs)

    @property
    def embedding_size(self):
        return self.key_dim * self.num_heads

    def forward(self, x):
        y = self.embed(x)
        if self.positional_encoding:
            y = self.pos_encoder(y)
        for i in range(self.n_layers):
            y = getattr(self, f"mha_{i}")(y)
        return y
