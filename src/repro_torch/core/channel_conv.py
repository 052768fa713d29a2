"""Channel/filter-parallel convolution (paper §III-D), port of
`repro.core.channel_conv`.

The C input channels and the F filters of a conv are partitioned over one
mesh axis, the convolution analogue of Megatron's row/column-parallel
linear layers:

  'channel' (row-parallel, the scheme the §V perf model costs):
      x enters C-sharded; each rank takes the C rows of w for its channel
      block and convolves them against all F filters, a full-F partial
      sum; a reduce-scatter over the CF axis completes the channel sum
      and leaves y F-sharded.  Its backward is the all-gather of dL/dy.
  'filter' (column-parallel):
      x is all-gathered over the CF axis to full C; each rank convolves
      against its F block of w, so y comes out F-sharded with no output
      collective.  The backward reduce-scatters dL/dx.

Both modes take a C-sharded block and give an F-sharded one on the same
axis, so consecutive CF layers chain with no reshard.

CF x spatial composition: a `CFSharding` may carry `h_axis` / `w_axis` on
other mesh axes than `cf_axis`; the local conv is then
`core.spatial_conv._local_conv`, with its halo exchange and its §IV-A
interior/boundary split.  Chunked channel mode: with `overlap` and
`channel_chunks > 1` the local conv runs per channel block and each
block's partial is reduce-scattered as it completes.

Every local conv is `spatial_conv._conv_nhwc` or `_local_conv`, and so
the conv kernel (`kernels/conv2d.Conv2d`) on the card.  Weights stay
globally addressed and are sliced per rank; a rank's gradient of w is
then zero outside its block, and the sum over the mesh of every
replicated param's gradient (`train.train_loop.reduce_grads`)
puts the blocks together into dL/dw.  The collectives are
`core.collectives`', in the named regions `cf_all_gather` /
`cf_reduce_scatter` (`core.trace.annotate`).

BN under a CF sharding needs no communication at 'local' scope (each
channel lives on one rank of the CF axis); 'spatial' and 'global' sum the
moments over the composed spatial axes, and 'global' over the batch axes
too.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from repro_torch.core import collectives, trace
from repro_torch.core.spatial_conv import (ConvSharding, _conv_nhwc,
                                           _local_conv, axes_tuple,
                                           cast_to_weight_dtype,
                                           fit_spatial_axis, spatial_conv2d)
from repro_torch.core.spatial_norm import all_reduce
from repro_torch.launch.mesh import Mesh
from repro_torch.utils import same_pads

MODES = ("channel", "filter")


# the measured achieved-overlap efficiency (Machine.overlap_eta), installed
# by core.calibrate whenever a calibration with live overlap samples runs or
# loads; None: no measurement yet
_MEASURED_ETA: float | None = None

# chunking must hide at least this fraction of the hideable min(comm,
# compute) to pay for its extra per-block collective launches and slices.
ETA_CHUNK_THRESHOLD = 0.5


def set_measured_eta(eta: float | None) -> None:
    """Install (or clear with None) the measured η that `chunks_decision`
    reads; core.calibrate calls it after a fit or load that carries live
    overlap samples.  Every rank of a mesh installs the same η (the
    calibration is one for all of them), or their chunk counts, and so
    their collectives, would differ."""
    global _MEASURED_ETA
    _MEASURED_ETA = eta


def measured_eta() -> float | None:
    return _MEASURED_ETA


def chunks_decision() -> tuple[int, str]:
    """The 'channel'-mode chunk default, with its reason.  Chunking
    pipelines the reduce-scatter of block b with the conv of block b+1,
    which pays only where a measured η >= ETA_CHUNK_THRESHOLD says the
    machine hides collectives behind compute; unmeasured, it stays off."""
    if _MEASURED_ETA is None:
        return 1, "eta unmeasured"
    if _MEASURED_ETA >= ETA_CHUNK_THRESHOLD:
        return 2, f"measured eta {_MEASURED_ETA:.2f} >= {ETA_CHUNK_THRESHOLD}"
    return 1, f"measured eta {_MEASURED_ETA:.2f} < {ETA_CHUNK_THRESHOLD}"


def default_channel_chunks() -> int:
    return chunks_decision()[0]


@dataclasses.dataclass(frozen=True)
class CFSharding:
    """Distribution descriptor for a channel/filter-parallel conv layer.

    batch_axes: mesh axes sharding N, as ConvSharding.
    cf_axis:    the mesh axis partitioning C of the input and F of the
                output (the §III-D group).
    mode:       'channel' (reduce-scatter on y) or 'filter' (all-gather on
                x); the plan compiler picks per layer (core.plan).
    h_axis / w_axis: optional spatial sharding of H / W on other mesh
                axes than `cf_axis` (each may be a product axis).
    """
    batch_axes: tuple[str, ...] = ()
    cf_axis: str | None = None
    mode: str = "channel"
    h_axis: str | tuple[str, ...] | None = None
    w_axis: str | tuple[str, ...] | None = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"CFSharding mode {self.mode!r} not in {MODES}")
        if {self.cf_axis} & set(self.spatial_axes):
            raise ValueError(
                f"CFSharding cf_axis {self.cf_axis!r} also shards a spatial "
                f"dim — the CF collective and the halo exchange must live "
                f"on different mesh axes")

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
        """NHWC placement (the reference's PartitionSpec as a tuple):
        channels on the CF axis, N on the batch axes, H/W on the spatial
        axes when composed."""
        return (self.batch_axes or None, self.h_axis, self.w_axis,
                self.cf_axis)

    def fit(self, h: int, w: int, k: int, s: int,
            mesh_shape: Mapping[str, int] | None) -> "CFSharding":
        """The §III-A geometry fit of the composed spatial axes (the CF
        group is untouched; channel divisibility is checked when a plan is
        compiled)."""
        if mesh_shape is None or not self.is_spatial:
            return self
        return dataclasses.replace(
            self, h_axis=fit_spatial_axis(h, self.h_axis, k, s, mesh_shape),
            w_axis=fit_spatial_axis(w, self.w_axis, k, s, mesh_shape))

    def fits_channels(self, c: int, f: int, mesh_shape) -> bool:
        if self.cf_axis is None:
            return True
        ways = dict(mesh_shape).get(self.cf_axis, 1)
        return c % ways == 0 and f % ways == 0


def _conv_local_block(x, w, *, strides, sharding: CFSharding, mesh: Mesh,
                      overlap: bool):
    """The local conv of a (possibly spatially sharded) block with the
    already-sliced weights: dense where nothing spatial is sharded, else
    the halo-exchange path of `core.spatial_conv` (with its §IV-A split)
    on the composed H/W axes."""
    if not sharding.is_spatial:
        return _conv_nhwc(x, w, strides, (same_pads(w.shape[0], strides[0]),
                                          same_pads(w.shape[1], strides[1])))
    view = ConvSharding(h_axis=sharding.h_axis, w_axis=sharding.w_axis)
    return _local_conv(x, w, strides=strides, sharding=view, mesh=mesh,
                       overlap=overlap)


def _local_cf_conv(x, w, *, strides, sharding: CFSharding, mesh: Mesh,
                   overlap: bool, channel_chunks: int):
    """This rank's CF conv: x its (n, H, W, C/p) channel block (H and W
    local too when composed), w the full (K, K, C, F) weights."""
    ax = sharding.cf_axis
    if sharding.mode == "filter":
        # column-parallel: full C, my F block; the all-gather's adjoint
        # reduce-scatters dL/dx
        with trace.annotate("cf_all_gather", x):
            xg = collectives.all_gather(x, mesh, ax, 3, "cf_all_gather")
        return _conv_local_block(xg, collectives.take_block(w, mesh, ax, 3),
                                 strides=strides, sharding=sharding,
                                 mesh=mesh, overlap=overlap)

    # row-parallel: my C rows of w against all F filters, then the
    # reduce-scatter that completes the channel sum, y F-sharded
    wp = collectives.take_block(w, mesh, ax, 2)
    c_loc = x.shape[3]
    n_blk = channel_chunks if overlap and not sharding.is_spatial else 1
    n_blk = max(1, min(n_blk, c_loc))
    bounds = [round(i * c_loc / n_blk) for i in range(n_blk + 1)]
    y = None
    for lo, hi in zip(bounds, bounds[1:]):
        if hi <= lo:
            continue
        xs, ws = (x, wp) if n_blk == 1 else \
            (x.narrow(3, lo, hi - lo), wp.narrow(2, lo, hi - lo))
        partial = _conv_local_block(xs, ws, strides=strides,
                                    sharding=sharding, mesh=mesh,
                                    overlap=overlap)
        with trace.annotate("cf_reduce_scatter", partial):
            scat = collectives.reduce_scatter(partial, mesh, ax, 3,
                                              "cf_reduce_scatter")
        y = scat if y is None else y + scat
    return y


def cf_conv2d(x: torch.Tensor, w: torch.Tensor, *, strides=(1, 1),
              sharding: CFSharding, mesh: Mesh | None = None,
              overlap: bool = True, channel_chunks: int | None = None
              ) -> torch.Tensor:
    """'SAME'-padded strided conv2d of this rank's block x (N, H, W, C/p)
    under channel/filter parallelism, optionally composed with spatial
    parallelism on other mesh axes; returns its (N, H', W', F/p) block.

    w: (K_h, K_w, C, F), globally addressed (sliced per rank).
    channel_chunks: 'channel'-mode block count of the §IV-A-style split
    (None: `chunks_decision`)."""
    x = cast_to_weight_dtype(x, w)
    p = mesh.axis_size(sharding.cf_axis) if mesh is not None and \
        sharding.cf_axis else 1
    k_h, k_w = w.shape[0], w.shape[1]
    if p <= 1:
        if sharding.is_spatial:
            return spatial_conv2d(
                x, w, strides=strides,
                sharding=ConvSharding(batch_axes=sharding.batch_axes,
                                      h_axis=sharding.h_axis,
                                      w_axis=sharding.w_axis),
                mesh=mesh, overlap=overlap)
        return _conv_nhwc(x, w, strides, (same_pads(k_h, strides[0]),
                                          same_pads(k_w, strides[1])))
    c, f = w.shape[2], w.shape[3]
    if c % p or f % p:
        raise ValueError(
            f"channels C={c}, F={f} not divisible by {p}-way CF axis "
            f"{sharding.cf_axis!r} — core.plan demotes such layers at "
            "compile time; direct callers must pre-check "
            "CFSharding.fits_channels")
    if channel_chunks is None:
        channel_chunks = default_channel_chunks()
    return _local_cf_conv(x, w, strides=strides, sharding=sharding,
                          mesh=mesh, overlap=overlap,
                          channel_chunks=channel_chunks)


def cf_bias_add(x: torch.Tensor, b: torch.Tensor, *, sharding: CFSharding,
                mesh: Mesh | None = None) -> torch.Tensor:
    """Add a per-channel bias (global, sliced per rank) to a C-sharded
    NHWC block."""
    if mesh is None or sharding.cf_axis is None:
        return x + b
    return x + collectives.take_block(b, mesh, sharding.cf_axis, 0)


def cf_batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  *, sharding: CFSharding, mesh: Mesh | None = None,
                  scope: str = "local", eps: float = 1e-5) -> torch.Tensor:
    """BN over (N, H, W) of a C-sharded NHWC block, written as
    `core.spatial_norm.batch_norm` is; gamma and beta global, sliced per
    rank like the conv weights."""
    if scope not in ("local", "spatial", "global"):
        raise ValueError(f"unknown BN scope {scope!r}")
    stat_axes: tuple[str, ...] = ()
    if scope in ("spatial", "global"):
        stat_axes += sharding.spatial_axes
    if scope == "global":
        stat_axes += tuple(sharding.batch_axes or ())
    comm = tuple(a for a in stat_axes
                 if mesh is not None and mesh.shape.get(a, 1) > 1)
    xf = x.float()
    n = x.shape[0] * x.shape[1] * x.shape[2]
    stats = torch.stack([xf.sum((0, 1, 2)), xf.square().sum((0, 1, 2))])
    if comm:
        stats = all_reduce(stats, mesh, comm)
        n *= mesh.axis_size(comm)
    mean = stats[0] / n
    var = stats[1] / n - mean.square()
    inv = torch.rsqrt(var + eps)
    y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
    if mesh is not None and sharding.cf_axis is not None:
        gamma = collectives.take_block(gamma, mesh, sharding.cf_axis, 0)
        beta = collectives.take_block(beta, mesh, sharding.cf_axis, 0)
    return y * gamma + beta
