"""Functional CNN layers, port of `repro.models.cnn.layers`.

Every layer is (init, apply) over explicit parameter dicts with the
reference's names.  `apply` takes this rank's block and the layer's
`ConvSharding`; conv and pool route through the halo-exchange
implementations of `core.spatial_conv`, BN through `core.spatial_norm`.
Element-wise ops parallelize trivially under any distribution.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.spatial_conv import (ConvSharding, spatial_conv2d,
                                           spatial_pool)
from repro_torch.core.spatial_norm import all_reduce, batch_norm
from repro_torch.launch.mesh import Mesh, mesh_shape


def fitted(sharding: ConvSharding, x: torch.Tensor, k: int, s: int,
           mesh: Mesh | None) -> ConvSharding:
    """`sharding.fit` at x's GLOBAL extents (local extent x shard count).

    A spatial axis that the fit drops while x is split over it needs a
    §III-C reshard, which comes with the plan slice: that raises."""
    h, w = sharding.global_hw(x, mesh)
    sh = sharding.fit(h, w, k, s, mesh_shape(mesh))
    if sh != sharding:
        raise NotImplementedError(
            f"{sharding} does not fit a {k}x{k} stride-{s} layer at "
            f"{h}x{w} on mesh {mesh_shape(mesh)} (§III-A) and would need a "
            f"reshard, which comes with the plan slice (core/plan.py)")
    return sh


def conv_init(gen: torch.Generator, k: int, c_in: int, c_out: int,
              dtype=torch.float32) -> dict:
    """He-normal HWIO weights drawn from `gen` (a CPU generator, so the
    same seed gives the same weights on every device)."""
    w = torch.randn((k, k, c_in, c_out), generator=gen,
                    dtype=torch.float32) * math.sqrt(2.0 / (k * k * c_in))
    return {"w": w.to(dtype)}


def conv_apply(params, x, *, stride=1, sharding: ConvSharding,
               mesh: Mesh | None = None, overlap: bool = True):
    sh = fitted(sharding, x, params["w"].shape[0], stride, mesh)
    return spatial_conv2d(x, params["w"], strides=(stride, stride),
                          sharding=sh, mesh=mesh, overlap=overlap)


def bn_init(c: int, dtype=torch.float32) -> dict:
    return {"gamma": torch.ones((c,), dtype=dtype),
            "beta": torch.zeros((c,), dtype=dtype)}


def bn_apply(params, x, *, sharding: ConvSharding, mesh: Mesh | None = None,
             scope: str = "local"):
    return batch_norm(x, params["gamma"], params["beta"], sharding=sharding,
                      mesh=mesh, scope=scope)


def relu(x):
    return torch.relu(x)


def max_pool(x, *, window=3, stride=2, sharding: ConvSharding,
             mesh: Mesh | None = None):
    sh = fitted(sharding, x, window, stride, mesh)
    return spatial_pool(x, window=(window, window), strides=(stride, stride),
                        sharding=sh, mesh=mesh, kind="max")


def global_avg_pool(x, *, sharding: ConvSharding, mesh: Mesh | None = None):
    """Mean over H, W: a local mean, then a sum over the spatial axes
    divided by their size (one value per sample and channel moves)."""
    axes = sharding.spatial_axes
    if not axes or mesh is None:
        return x.mean(dim=(1, 2))
    return all_reduce(x.mean(dim=(1, 2)), mesh, axes) / mesh.axis_size(axes)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> dict:
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32) \
        * math.sqrt(1.0 / d_in)
    return {"w": w.to(dtype), "b": torch.zeros((d_out,), dtype=dtype)}


def dense_apply(params, x):
    return x @ params["w"] + params["b"]
