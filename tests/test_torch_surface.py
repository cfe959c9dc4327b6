"""PyTorch port, its public surface against the JAX package's: every name
that ``deepsphere_tpu.nn`` and ``deepsphere_tpu.ops`` export, the port's
packages export too, and ``AddPositionEmbs`` takes the JAX layer's
``posemb_init``."""

import numpy as np
import pytest
import torch

import deepsphere_tpu.nn as jnn
import deepsphere_tpu.ops as jops
import deepsphere_tpu_torch.nn as tnn
import deepsphere_tpu_torch.ops as tops


@pytest.mark.parametrize("jax_mod,port_mod", [(jnn, tnn), (jops, tops)],
                         ids=["nn", "ops"])
def test_port_exports_every_jax_name(jax_mod, port_mod):
    missing = sorted(set(jax_mod.__all__) - set(port_mod.__all__))
    assert not missing, missing
    for name in port_mod.__all__:
        assert hasattr(port_mod, name), name


def test_add_position_embs_takes_posemb_init():
    seen = []

    def init(shape, generator):
        seen.append((shape, generator))
        return torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape)

    x = torch.zeros((2, 5, 3))
    layer = tnn.AddPositionEmbs(posemb_init=init)
    y = layer(x)
    assert [s for s, _ in seen] == [(1, 5, 3)]
    want = torch.arange(15, dtype=torch.float32).reshape(1, 5, 3)
    assert torch.equal(layer.pos_embedding.detach(), want)
    assert torch.equal(y, want.expand(2, 5, 3))
    # the default stays N(0, 0.02), and clone keeps the initializer
    g = torch.Generator().manual_seed(0)
    dflt = tnn.AddPositionEmbs()
    dflt._init_generator = g
    dflt(x)
    ref = torch.randn((1, 5, 3), generator=torch.Generator().manual_seed(0))
    assert torch.equal(dflt.pos_embedding.detach(), ref * 0.02)
    assert layer.clone().posemb_init is init
