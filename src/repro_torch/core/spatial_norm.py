"""Batch normalization under spatial decomposition (paper §III-B), port of
`repro.core.spatial_norm`.

Three statistics scopes, over (N, H, W) of an NHWC tensor:

  'local'   per-shard statistics (the paper's default; no communication).
            Under a spatial split this is NOT one-device BN: each shard
            normalises by its own rows.
  'spatial' aggregated over the spatial shards of a sample: (sum x,
            sum x^2) all-reduced over `sharding.spatial_axes`.
  'global'  aggregated over every batch and spatial shard.

A sharding with no spatial axis (sample parallelism) normalises by the
statistics of the whole batch at every scope, summed over the batch
axes: the reference applies its one-device BN to the global array there
and GSPMD sums over the shards.

The statistics' all-reduce is the named region `bn_collective`
(`core.trace.annotate`), an autograd Function whose backward all-reduces
the cotangent over the same ranks (the transpose of a psum is a psum).
gamma and beta are replicated; their gradients are summed over the mesh
once a step by `train.train_loop.reduce_replicated_grads`. Training mode
only, without running statistics, like the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core import trace
from repro_torch.core.spatial_conv import ConvSharding
from repro_torch.launch.mesh import Mesh


class _AllReduce(torch.autograd.Function):
    """Differentiable sum over the ranks of `axes`."""

    @staticmethod
    def forward(ctx, t, mesh: Mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        ctx.layer = trace.current_layer()
        with trace.annotate("bn_collective", t):
            return mesh.all_reduce(t, axes)

    @staticmethod
    def backward(ctx, g):
        with trace.annotate("bn_collective", g, ctx.layer, bwd=True):
            return ctx.mesh.all_reduce(g, ctx.axes), None, None


def all_reduce(t: torch.Tensor, mesh: Mesh | None, axes) -> torch.Tensor:
    """Sum of `t` over the ranks of `axes`, differentiable."""
    if mesh is None or mesh.axis_size(axes) == 1:
        return t
    return _AllReduce.apply(t, mesh, tuple(axes))


def batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
               sharding: ConvSharding, mesh: Mesh | None = None,
               scope: str = "local", eps: float = 1e-5) -> torch.Tensor:
    """BN of this rank's block with the statistics of `scope`.

    Written out as the reference does, not through `F.batch_norm` (which
    computes the variance another way and keeps running buffers):
    var = E[x^2] - mean^2 in fp32, then (x - mean) * rsqrt(var + eps),
    scaled by gamma and shifted by beta."""
    if scope not in ("local", "spatial", "global"):
        raise ValueError(f"unknown BN scope {scope!r}")
    if not sharding.is_spatial:
        comm: tuple[str, ...] = tuple(sharding.batch_axes or ())
    elif scope == "local":
        comm = ()
    elif scope == "spatial":
        comm = sharding.spatial_axes
    else:
        comm = tuple(sharding.batch_axes or ()) + sharding.spatial_axes
    xf = x.float()
    n = x.shape[0] * x.shape[1] * x.shape[2]
    stats = torch.stack([xf.sum((0, 1, 2)), xf.square().sum((0, 1, 2))])
    if comm and mesh is not None:
        stats = all_reduce(stats, mesh, comm)
        n *= mesh.axis_size(comm)
    mean = stats[0] / n
    var = stats[1] / n - mean.square()
    inv = torch.rsqrt(var + eps)
    y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
    return y * gamma + beta
