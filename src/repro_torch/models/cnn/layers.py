"""Functional CNN layers, port of `repro.models.cnn.layers`.

Every layer is (init, apply) over explicit parameter dicts with the
reference's names.  `apply` takes the layer's `ConvSharding`; this slice
runs the one-device path.  Pooling and dense layers come with resnet50.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.spatial_conv import ConvSharding, spatial_conv2d
from repro_torch.core.spatial_norm import batch_norm


def conv_init(gen: torch.Generator, k: int, c_in: int, c_out: int,
              dtype=torch.float32) -> dict:
    """He-normal HWIO weights drawn from `gen` (a CPU generator, so the
    same seed gives the same weights on every device)."""
    w = torch.randn((k, k, c_in, c_out), generator=gen,
                    dtype=torch.float32) * math.sqrt(2.0 / (k * k * c_in))
    return {"w": w.to(dtype)}


def conv_apply(params, x, *, stride=1, sharding: ConvSharding):
    return spatial_conv2d(x, params["w"], strides=(stride, stride),
                          sharding=sharding)


def bn_init(c: int, dtype=torch.float32) -> dict:
    return {"gamma": torch.ones((c,), dtype=dtype),
            "beta": torch.zeros((c,), dtype=dtype)}


def bn_apply(params, x, *, sharding: ConvSharding, scope: str = "local"):
    return batch_norm(x, params["gamma"], params["beta"], sharding=sharding,
                      scope=scope)


def relu(x):
    return torch.relu(x)
