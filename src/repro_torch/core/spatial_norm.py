"""Batch normalization (paper §III-B), port of `repro.core.spatial_norm`.

This slice ports the statistics of one device: over (N, H, W) of the whole
local tensor, which is the 'local' scope and what every scope computes
under a non-spatial sharding.  The 'spatial' and 'global' scopes of a
spatially split tensor come with the halo slice.  Training-mode only and
without running statistics, like the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.spatial_conv import ConvSharding


def batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
               sharding: ConvSharding, scope: str = "local",
               eps: float = 1e-5) -> torch.Tensor:
    """BN over (N, H, W) of an NHWC tensor.

    Written out as the reference does, not through `F.batch_norm` (which
    computes the variance another way and keeps running buffers):
    var = E[x^2] - mean^2 in fp32, then (x - mean) * rsqrt(var + eps),
    scaled by gamma and shifted by beta.
    """
    if sharding.is_spatial:
        raise NotImplementedError(
            f"batch_norm under spatial {sharding} (scope {scope!r}) needs "
            f"per-shard statistics, which come with the halo slice")
    xf = x.float()
    n = x.shape[0] * x.shape[1] * x.shape[2]
    mean = xf.sum((0, 1, 2)) / n
    var = xf.square().sum((0, 1, 2)) / n - mean.square()
    inv = torch.rsqrt(var + eps)
    y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
    return y * gamma + beta
