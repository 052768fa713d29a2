"""Functional CNN layers, port of `repro.models.cnn.layers`.

Every layer is (init, apply) over explicit parameter dicts with the
reference's names.  `apply` takes this rank's block and the layer's
sharding: under a `ConvSharding` conv and pool route through the
halo-exchange implementations of `core.spatial_conv` and BN through
`core.spatial_norm`; under a `CFSharding` (§III-D) conv and BN route
through `core.channel_conv`, and the global average pool gathers the
channels for the head.  Element-wise ops parallelize trivially
under any distribution.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import collectives
from repro_torch.core.channel_conv import (CFSharding, cf_batch_norm,
                                           cf_conv2d)
from repro_torch.core.spatial_conv import (ConvSharding, spatial_conv2d,
                                           spatial_pool)
from repro_torch.core.spatial_norm import all_reduce, batch_norm
from repro_torch.launch.mesh import Mesh, mesh_shape


def fitted(sharding, x: torch.Tensor, k: int, s: int, mesh: Mesh | None):
    """`sharding.fit` at x's GLOBAL extents (local extent x shard count).

    x is already split as `sharding` says, so a spatial axis that the fit
    drops here is a plan that was not fitted to the layers' geometry
    (`core.plan`: compile_plan, or NetworkPlan.uniform with the layer
    specs, which put a reshard before such a layer): that raises."""
    _, h_axis, w_axis, _ = sharding.x_spec()
    h, w = x.shape[1], x.shape[2]
    if mesh is not None:
        h, w = h * mesh.axis_size(h_axis), w * mesh.axis_size(w_axis)
    sh = sharding.fit(h, w, k, s, mesh_shape(mesh))
    if sh != sharding:
        raise ValueError(
            f"{sharding} does not fit a {k}x{k} stride-{s} layer at "
            f"{h}x{w} on mesh {mesh_shape(mesh)} (§III-A): the plan was not "
            f"fitted to the layer geometry (core.plan.compile_plan, or "
            f"NetworkPlan.uniform with specs)")
    return sh


def conv_init(gen: torch.Generator, k: int, c_in: int, c_out: int,
              dtype=torch.float32) -> dict:
    """He-normal HWIO weights drawn from `gen` (a CPU generator, so the
    same seed gives the same weights on every device)."""
    w = torch.randn((k, k, c_in, c_out), generator=gen,
                    dtype=torch.float32) * math.sqrt(2.0 / (k * k * c_in))
    return {"w": w.to(dtype)}


def conv_apply(params, x, *, stride=1, sharding, mesh: Mesh | None = None,
               overlap: bool = True):
    sh = fitted(sharding, x, params["w"].shape[0], stride, mesh)
    if isinstance(sh, CFSharding):
        return cf_conv2d(x, params["w"], strides=(stride, stride),
                         sharding=sh, mesh=mesh, overlap=overlap)
    return spatial_conv2d(x, params["w"], strides=(stride, stride),
                          sharding=sh, mesh=mesh, overlap=overlap)


def bn_init(c: int, dtype=torch.float32) -> dict:
    return {"gamma": torch.ones((c,), dtype=dtype),
            "beta": torch.zeros((c,), dtype=dtype)}


def bn_apply(params, x, *, sharding, mesh: Mesh | None = None,
             scope: str = "local"):
    if isinstance(sharding, CFSharding):
        return cf_batch_norm(x, params["gamma"], params["beta"],
                             sharding=sharding, mesh=mesh, scope=scope)
    return batch_norm(x, params["gamma"], params["beta"], sharding=sharding,
                      mesh=mesh, scope=scope)


def relu(x):
    return torch.relu(x)


def max_pool(x, *, window=3, stride=2, sharding: ConvSharding,
             mesh: Mesh | None = None):
    sh = fitted(sharding, x, window, stride, mesh)
    return spatial_pool(x, window=(window, window), strides=(stride, stride),
                        sharding=sh, mesh=mesh, kind="max")


def global_avg_pool(x, *, sharding, mesh: Mesh | None = None):
    """Mean over H, W: a local mean, then a sum over the spatial axes
    divided by their size (one value per sample and channel moves).
    Under a CFSharding each rank holds its block of the channels, and the
    head needs them all: an all-gather over the CF axis
    (`collectives.all_gather`, whose backward reduce-scatters the
    gradient's shares) gives every rank every channel."""
    y = x.mean(dim=(1, 2))
    if mesh is None:
        return y
    axes = sharding.spatial_axes
    if axes:
        y = all_reduce(y, mesh, axes) / mesh.axis_size(axes)
    if isinstance(sharding, CFSharding) and sharding.cf_axis is not None:
        y = collectives.all_gather(y, mesh, sharding.cf_axis, 1,
                                   "cf_all_gather")
    return y


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> dict:
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32) \
        * math.sqrt(1.0 / d_in)
    return {"w": w.to(dtype), "b": torch.zeros((d_out,), dtype=dtype)}


def dense_apply(params, x):
    return x @ params["w"] + params["b"]
