"""Convolution under sample/spatial decomposition (paper §III), port of
`repro.core.spatial_conv`.

This slice ports the non-spatial path: a 'SAME'-padded strided conv of the
whole local tensor, padded explicitly and run through the implicit-GEMM
kernel (`kernels.conv2d.Conv2d`).  The halo exchange and the §IV-A
interior/boundary split come with the halo slice; a spatial
`ConvSharding` raises until then.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.kernels.conv2d import Conv2d
from repro_torch.utils import same_pads


def cast_to_weight_dtype(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The repo-wide mixed-precision rule for conv layers: compute in the
    *weight* dtype."""
    return x.to(w.dtype) if x.dtype != w.dtype else x


def axes_tuple(axis) -> tuple[str, ...]:
    """A mesh axis spec (None, a name, or a tuple of names) as a tuple."""
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def product_size(axis, mesh_shape: Mapping[str, int]) -> int:
    """Total size of a (possibly product) mesh axis."""
    m = 1
    for a in axes_tuple(axis):
        m *= mesh_shape[a]
    return m


def fit_spatial_axis(size: int, axis, k: int, s: int,
                     mesh_shape: Mapping[str, int]):
    """The §III-A geometry test for one (possibly product) spatial axis:
    keep it only when every shard divides evenly, stays stride-aligned, and
    is at least kernel-sized; else None."""
    if axis is None:
        return None
    m = product_size(axis, mesh_shape)
    good = size % m == 0 and (size // m) % s == 0 and size // m >= max(k, s)
    return axis if good else None


@dataclasses.dataclass(frozen=True)
class ConvSharding:
    """Distribution descriptor for a conv layer (paper's D).

    batch_axes: mesh axes sharding N (sample parallelism).
    h_axis / w_axis: the mesh axis, or tuple of axes forming one product
        axis, sharding H / W (spatial parallelism), or None.
    """
    batch_axes: tuple[str, ...] = ()
    h_axis: str | tuple[str, ...] | None = None
    w_axis: str | tuple[str, ...] | None = None

    @property
    def is_spatial(self) -> bool:
        return self.h_axis is not None or self.w_axis is not None

    @property
    def h_axes(self) -> tuple[str, ...]:
        return axes_tuple(self.h_axis)

    @property
    def w_axes(self) -> tuple[str, ...]:
        return axes_tuple(self.w_axis)

    @property
    def spatial_axes(self) -> tuple[str, ...]:
        return self.h_axes + self.w_axes

    def fit(self, h: int, w: int, k: int, s: int,
            mesh_shape: Mapping[str, int] | None) -> "ConvSharding":
        """Drop spatial axes this layer's geometry cannot support (§III-A);
        `mesh_shape` maps axis names to sizes (None: one device)."""
        if mesh_shape is None or not self.is_spatial:
            return self
        return dataclasses.replace(
            self, h_axis=fit_spatial_axis(h, self.h_axis, k, s, mesh_shape),
            w_axis=fit_spatial_axis(w, self.w_axis, k, s, mesh_shape))


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, strides, pads):
    """Local dense conv, the per-shard compute the paper times as cuDNN:
    explicit (possibly asymmetric) padding, then the VALID kernel."""
    if strides[0] != strides[1]:
        raise ValueError(f"the conv kernel takes one stride for both "
                         f"spatial dims; got {tuple(strides)}")
    (h_lo, h_hi), (w_lo, w_hi) = pads
    xp = F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi)) \
        if h_lo or h_hi or w_lo or w_hi else x.contiguous()
    return Conv2d.apply(xp, w.contiguous(), int(strides[0]))


def spatial_conv2d(x: torch.Tensor, w: torch.Tensor, *, strides=(1, 1),
                   sharding: ConvSharding):
    """'SAME'-padded strided conv2d, x (N, H, W, C), w (K_h, K_w, C, F)."""
    x = cast_to_weight_dtype(x, w)
    if sharding.is_spatial:
        raise NotImplementedError(
            f"spatial ConvSharding {sharding} needs the halo exchange, "
            f"which comes with the halo + distributed spatial conv slice; "
            f"this slice runs ConvSharding() on one device")
    k_h, k_w = w.shape[0], w.shape[1]
    return _conv_nhwc(x, w, strides, (same_pads(k_h, strides[0]),
                                      same_pads(k_w, strides[1])))
