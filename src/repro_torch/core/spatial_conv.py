"""Convolution and pooling under sample/spatial decomposition (paper §III),
port of `repro.core.spatial_conv`.

Every function takes this rank's local block of an NHWC tensor: N split
over the batch axes (sample parallelism), H and optionally W over mesh
axes (spatial parallelism), each possibly a tuple of axes forming one
product axis (`core.halo`).  A forward conv needs the stencil halo of its
neighbours' boundary rows (paper Eq. 1), exchanged by `core.halo`, whose
autograd Function also carries the backward's halo exchange on dL/dy
(Eq. 3) and the boundary-gradient accumulation.  dL/dw here is the local
contraction (Eq. 2) only: the all-reduce over the ranks that replicate the
weight is `train.train_loop.reduce_replicated_grads`, done once a step
(the psum that the reference's `shard_map` inserts).

Overlap (§IV-A): with `overlap=True` the local conv is split into an
interior block that reads local rows only and top and bottom blocks that
read the halo.  The halo transfers are posted first
(`halo.HaloSchedule`), the interior conv is launched while they are in
flight, and the boundary convs run after `pin` has waited for them.
Every piece runs through the conv kernel (`kernels.conv2d.Conv2d`).

The pieces are named regions (`core.trace.annotate`): `conv_interior`,
`conv_boundary`, and `conv_serialized` for the conv that waits for its
halo first.  Under an audit (`analysis.collectives.record`) each conv
launch is one `conv` op of the recorder in its region, the anchor of the
schedule checks; its backward (`kernels.conv2d.Conv2d`) is another.

The interior block is an H-slice of the local block, which for N > 1 is
not contiguous.  Its W padding (`F.pad`) copies it into a contiguous
tensor, the same one copy per layer that the unsplit conv's padding makes;
only a slice with no padding to add (a W-split conv, whose H halo is
already in place) is copied by `.contiguous()`.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.core import halo as halo_lib
from repro_torch.core import trace
from repro_torch.core.halo import axes_tuple, product_size  # noqa: F401
from repro_torch.kernels.conv2d import Conv2d
from repro_torch.launch.mesh import Mesh
from repro_torch.utils import cdiv, same_pads


def cast_to_weight_dtype(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The repo-wide mixed-precision rule for conv layers: compute in the
    *weight* dtype."""
    return x.to(w.dtype) if x.dtype != w.dtype else x


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

    def x_spec(self) -> tuple:
        """NHWC placement, the reference's PartitionSpec as a tuple: N on
        the batch axes, H and W on the spatial axes, C replicated."""
        return (self.batch_axes or None, self.h_axis, self.w_axis, None)

    def fit(self, h: int, w: int, k: int, s: int,
            mesh_shape: Mapping[str, int] | None) -> "ConvSharding":
        """Drop spatial axes this layer's geometry cannot support (§III-A);
        h and w are GLOBAL extents, `mesh_shape` maps axis names to sizes
        (None: one device)."""
        if mesh_shape is None or not self.is_spatial:
            return self
        return dataclasses.replace(
            self, h_axis=fit_spatial_axis(h, self.h_axis, k, s, mesh_shape),
            w_axis=fit_spatial_axis(w, self.w_axis, k, s, mesh_shape))


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, strides, pads,
               interior_first: bool = False):
    """Local dense conv, the per-shard compute the paper times as cuDNN:
    explicit (possibly asymmetric) padding, then the VALID kernel.
    `interior_first` asks the kernel to run the tiles that read the halo
    rows last (`kernels.conv2d.tile_order`)."""
    if strides[0] != strides[1]:
        raise ValueError(f"the conv kernel takes one stride for both "
                         f"spatial dims; got {tuple(strides)}")
    (h_lo, h_hi), (w_lo, w_hi) = pads
    xp = F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi)) \
        if h_lo or h_hi or w_lo or w_hi else x.contiguous()
    if trace.RECORDER is not None:
        trace.note("conv", xp)
    return Conv2d.apply(xp, w.contiguous(), int(strides[0]), interior_first)


def split_rows(hl: int, k: int, s: int, lo: int) -> tuple[int, int, int]:
    """(t_lo, i_hi, ho) of the §IV-A split of a local extent `hl` with a
    lo-row halo: output rows [0, t_lo) read the lo halo, rows [i_hi, ho)
    the hi halo, rows [t_lo, i_hi) local rows only."""
    return cdiv(lo, s), cdiv(hl + lo - k + 1, s), hl // s


def conv_calls(hl: int, k: int, s: int, overlap: bool = True) -> int:
    """Kernel calls `_split_dim_conv` makes for a local extent `hl` along
    the split dim under SAME padding: 1 without a halo or without overlap,
    else the interior plus a top block where lo > 0 and a bottom block
    where hi > 0 (1 where the shard is too small to split)."""
    lo, hi = same_pads(k, s)
    if (lo == 0 and hi == 0) or not overlap:
        return 1
    t_lo, i_hi, ho = split_rows(hl, k, s, lo)
    if t_lo >= i_hi:                          # no interior row
        return 1
    return 1 + (t_lo > 0) + (i_hi < ho)


def _split_dim_conv(x, w, *, dim, s, k, lo, hi, axis, mesh, other_pads,
                    stride_other, overlap):
    """Conv along one sharded spatial `dim` (1=H or 2=W) of local block x.

    `other_pads` / `stride_other` apply to the other (unsharded) spatial
    dim.  Returns the local output block for this shard."""
    hl = x.shape[dim]
    if hl % s:
        raise ValueError(f"local extent {hl} not divisible by stride {s}")
    if hl < k:
        raise ValueError(f"spatial shard of {hl} rows is smaller than the "
                         f"kernel ({k}); use sample parallelism for this "
                         f"layer")

    def conv(z, pad_dim, interior_first=False):
        pads = [(0, 0), (0, 0)]
        pads[dim - 1] = pad_dim
        pads[2 - dim] = other_pads
        strides = [0, 0]
        strides[dim - 1] = s
        strides[2 - dim] = stride_other
        return _conv_nhwc(z, w, tuple(strides), tuple(pads), interior_first)

    if lo == 0 and hi == 0:
        return conv(x, (0, 0))

    # post the halo transfers first (§IV-A): the interior conv below is
    # launched while they are in flight
    sched = halo_lib.HaloSchedule(x, dim, lo, hi, axis, mesh)

    t_lo, i_hi, ho = split_rows(hl, k, s, lo)
    t_hi = ho - i_hi
    if not overlap or t_lo + t_hi >= ho:
        # one conv over lo + local + hi rows; where the shard is too small
        # to split and the halo rides along H, the kernel still runs the
        # tiles that read it last
        with trace.annotate("conv_serialized", x):
            h_lo, h_hi = sched.halos()
            parts = [p for p in (h_lo, x, h_hi) if p is not None]
            return conv(torch.cat(parts, dim), (0, 0),
                        interior_first=overlap and dim == 1)

    # interior first: rows [t_lo, i_hi) read input [t_lo*s - lo,
    # (i_hi-1)s - lo + k), no halo
    start = t_lo * s - lo
    inner_in = x.narrow(dim, start, (i_hi - 1) * s - lo + k - start)
    with trace.annotate("conv_interior", x):
        interior = conv(inner_in, (0, 0))
    interior, halo_lo, halo_hi = sched.pin(interior)

    blocks = []
    with trace.annotate("conv_boundary", x):
        if t_lo > 0:
            # top boundary: rows [0, t_lo) read input [-lo, (t_lo-1)s - lo
            # + k)
            top_in = torch.cat([halo_lo, x.narrow(
                dim, 0, (t_lo - 1) * s - lo + k)], dim)
            blocks.append(conv(top_in, (0, 0)))
        blocks.append(interior)
        if t_hi > 0:
            start = i_hi * s - lo
            bot_in = torch.cat([x.narrow(dim, start, hl - start), halo_hi],
                               dim)
            blocks.append(conv(bot_in, (0, 0)))
    return torch.cat(blocks, dim) if len(blocks) > 1 else blocks[0]


def _local_conv(x, w, *, strides, sharding: ConvSharding, mesh: Mesh,
                overlap: bool):
    """Shard-local forward conv of a spatially split block."""
    k_h, k_w = w.shape[0], w.shape[1]
    s_h, s_w = strides
    ph = same_pads(k_h, s_h)
    pw = same_pads(k_w, s_w)

    if sharding.h_axis is not None and sharding.w_axis is not None:
        # H first (its halo spans the local W), then W
        x = halo_lib.halo_exchange(x, 1, ph[0], ph[1], sharding.h_axis,
                                   mesh)
        return _split_dim_conv(
            x, w, dim=2, s=s_w, k=k_w, lo=pw[0], hi=pw[1],
            axis=sharding.w_axis, mesh=mesh, other_pads=(0, 0),
            stride_other=s_h, overlap=overlap)
    if sharding.h_axis is not None:
        return _split_dim_conv(
            x, w, dim=1, s=s_h, k=k_h, lo=ph[0], hi=ph[1],
            axis=sharding.h_axis, mesh=mesh, other_pads=pw,
            stride_other=s_w, overlap=overlap)
    return _split_dim_conv(
        x, w, dim=2, s=s_w, k=k_w, lo=pw[0], hi=pw[1],
        axis=sharding.w_axis, mesh=mesh, other_pads=ph, stride_other=s_h,
        overlap=overlap)


def spatial_conv2d(x: torch.Tensor, w: torch.Tensor, *, strides=(1, 1),
                   sharding: ConvSharding, mesh: Mesh | None = None,
                   overlap: bool = True) -> torch.Tensor:
    """'SAME'-padded strided conv2d of this rank's block x (N, H, W, C)
    with replicated weights w (K_h, K_w, C, F) under hybrid sample/spatial
    parallelism; returns this rank's block of the output."""
    x = cast_to_weight_dtype(x, w)
    k_h, k_w = w.shape[0], w.shape[1]
    if not sharding.is_spatial:
        return _conv_nhwc(x, w, strides, (same_pads(k_h, strides[0]),
                                          same_pads(k_w, strides[1])))
    if mesh is None:
        raise ValueError(f"spatial {sharding} needs the mesh")
    return _local_conv(x, w, strides=strides, sharding=sharding, mesh=mesh,
                       overlap=overlap)


# ---------------------------------------------------------------------------
# Pooling under spatial decomposition (paper §III-B: "parallelized similarly")
# ---------------------------------------------------------------------------

def _pool_windows(x, window, strides, pads, kind):
    """Pooling as stacked shifted slices reduced over the window axis."""
    k_h, k_w = window
    s_h, s_w = strides
    edge = float("-inf") if kind == "max" else 0.0
    (h_lo, h_hi), (w_lo, w_hi) = pads
    x = F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi), value=edge)
    h_out = (x.shape[1] - k_h) // s_h + 1
    w_out = (x.shape[2] - k_w) // s_w + 1
    taps = [x[:, i:i + h_out * s_h:s_h, j:j + w_out * s_w:s_w, :]
            for i in range(k_h) for j in range(k_w)]
    stack = torch.stack(taps, dim=-1)
    if kind == "max":
        return stack.amax(dim=-1)
    return stack.sum(dim=-1) / (k_h * k_w)


def spatial_pool(x: torch.Tensor, *, window=(3, 3), strides=(2, 2),
                 sharding: ConvSharding, mesh: Mesh | None = None,
                 kind: str = "max") -> torch.Tensor:
    """'SAME' max/avg pool of this rank's block under the same
    decomposition as `spatial_conv2d`.  Max pooling fills the global-edge
    halo with -inf, so edge windows match single-device 'SAME'; avg
    pooling counts the zero padding (count_include_pad), as the
    reference."""
    k_h, k_w = window
    s_h, s_w = strides
    ph = same_pads(k_h, s_h)
    pw = same_pads(k_w, s_w)
    edge = float("-inf") if kind == "max" else 0.0
    if sharding.h_axis is not None:
        x = halo_lib.halo_exchange(x, 1, ph[0], ph[1], sharding.h_axis,
                                   mesh, edge_value=edge)
        ph = (0, 0)
    if sharding.w_axis is not None:
        x = halo_lib.halo_exchange(x, 2, pw[0], pw[1], sharding.w_axis,
                                   mesh, edge_value=edge)
        pw = (0, 0)
    return _pool_windows(x, window, strides, (ph, pw), kind)
