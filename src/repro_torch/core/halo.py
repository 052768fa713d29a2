"""Halo exchange over `torch.distributed`, port of `repro.core.halo`: the
paper's core communication primitive (§III-A, §IV).

A tensor dimension is block-partitioned over a mesh axis, or over a tuple
of axes forming one product axis (shards ranked major-to-minor in tuple
order, `launch.mesh.Mesh.index`).  Each shard needs `lo` trailing rows of
its predecessor and `hi` leading rows of its successor (a stencil halo).
Shard i sends its tail to i+1 and its head to i-1.

JAX's `ppermute` fills the halo of a shard that receives nothing with
zeros and differentiates itself.  Here both are written out:

- the global-edge shards fill their missing halo explicitly with
  `edge_value` (0 for a conv's zero padding, -inf for max pooling);
- `_Halo` is an autograd Function whose backward sends the halo
  gradients the other way (shard i's lo-halo gradient to i-1, its
  hi-halo gradient to i+1) and adds what it receives into its own tail
  and head rows.  Every rank of the axis takes part in that exchange,
  also where a halo's gradient is zero, or the matched sends would hang.

`HaloSchedule` issues the transfers when it is built and waits for them
in `pin(interior)`, so an interior conv launched in between runs while
they are in flight (§IV-A).  The backward mirrors it: `pin` is also an
autograd identity (`_Pin`) over the interior and the halos, whose
backward runs as soon as the boundary convs' backward has produced the
halo gradients and posts their sends and receives; autograd then runs
the interior conv's dL/dx (its node was created after `_Halo`'s, so it
runs first), and `_Halo.backward` only waits for the transfers and lands
them.  An exchange that is not pinned (`halos`) posts and waits in
`_Halo.backward`.

Each transfer, its wait and the backward's exchange is the named region
`halo_exchange` (`core.trace.annotate`) of the layer that built it.

Under an audit (`analysis.collectives.record`) each transfer direction
is one `ppermute` op of the recorder, forward and backward, with the
bytes of the slice that enters it on this rank (also at a global edge,
where nothing is sent, as JAX's `ppermute` counts it), and each `pin`
one `pin` op, forward where it waits and backward where it posts.

Transport follows the backend (`Mesh.to_wire`): NCCL sends device
tensors; gloo sends host tensors, so a CUDA halo goes through host memory
explicitly, and every message sent or received that way adds one to
`staged`.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import trace
from repro_torch.launch.mesh import Mesh, axes_tuple  # noqa: F401 — re-export

# halo messages this process sent or received through host memory (gloo
# carrying CUDA tensors), forward and backward
staged = 0


def product_size(axis, mesh_shape) -> int:
    """Total shard count of a (possibly product) axis under `mesh_shape`."""
    n = 1
    for a in axes_tuple(axis):
        n *= mesh_shape[a]
    return n


def reset_staged() -> None:
    global staged
    staged = 0


def _p2p(sends: list, recvs: list) -> list:
    """Post `sends` [(tensor, rank)] and `recvs` [(buffer, rank)] as one
    batch; returns the works to wait on."""
    ops = [dist.P2POp(dist.isend, t, r) for t, r in sends] + \
        [dist.P2POp(dist.irecv, b, r) for b, r in recvs]
    return dist.batch_isend_irecv(ops) if ops else []


def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    global staged
    out = mesh.to_wire(t)
    if out.device != t.device:
        staged += 1
    return out


def _land(buf: torch.Tensor, out: torch.Tensor) -> None:
    """Copy a received buffer into `out` where they differ (gloo's host
    buffer into a CUDA tensor)."""
    global staged
    if buf is not out:
        staged += 1
        with torch.no_grad():
            out.copy_(buf)


class _Exchange:
    """One halo exchange of a local block along `dim`: the forward
    transfers (issued by `issue`, awaited by `wait`) and the backward's."""

    def __init__(self, dim: int, lo: int, hi: int, axis, mesh: Mesh | None,
                 edge_value: float):
        self.dim, self.lo, self.hi, self.edge = dim, lo, hi, edge_value
        self.axis, self.mesh = axis, mesh
        self.layer = trace.current_layer()
        ranks = [0] if mesh is None else mesh.ranks(axis)
        i = 0 if mesh is None else mesh.index(axis)
        # peers by process-group rank: the mesh may span a subset
        peer = (lambda r: r) if mesh is None else mesh.global_rank
        self.prev = peer(ranks[i - 1]) if i > 0 else None
        self.next = peer(ranks[i + 1]) if i < len(ranks) - 1 else None
        self._works: list = []
        self._sending: list = []
        self._landing: list = []
        self._bwd: tuple | None = None     # the posted backward transfers

    def _halo(self, x: torch.Tensor, width: int) -> torch.Tensor:
        shape = list(x.shape)
        shape[self.dim] = width
        return x.new_empty(shape)

    def issue(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Post the sends of x's tail (to next) and head (to prev) and the
        receives of both halos; fill the global-edge halos."""
        with trace.annotate("halo_exchange", x, self.layer):
            return self._issue(x)

    def _issue(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        dim, lo, hi = self.dim, self.lo, self.hi
        h_lo, h_hi = self._halo(x, lo), self._halo(x, hi)
        sends, recvs = [], []
        for width, out, src in ((lo, h_lo, self.prev),
                                (hi, h_hi, self.next)):
            if width == 0:
                continue
            if src is None:
                out.fill_(self.edge)
            else:
                buf = self.mesh.wire_buffer(out.shape, out.dtype,
                                            out.device) \
                    if self.mesh.stages(out.device) else out
                recvs.append((buf, src))
                self._landing.append((buf, out))
        if lo and self.next is not None:
            sends.append((_wire(self.mesh, x.narrow(dim, x.shape[dim] - lo,
                                                    lo)), self.next))
        if hi and self.prev is not None:
            sends.append((_wire(self.mesh, x.narrow(dim, 0, hi)),
                          self.prev))
        if trace.RECORDER is not None:
            self._note(x, "fwd")
        self._works = _p2p(sends, recvs)
        self._sending = sends       # alive until the sends complete
        return h_lo, h_hi

    def wait(self) -> None:
        with trace.annotate("halo_exchange", layer=self.layer):
            self._wait()

    def _wait(self) -> None:
        for w in self._works:
            w.wait()
        self._works, self._sending = [], []
        for buf, out in self._landing:
            _land(buf, out)
        self._landing = []

    def _note(self, t: torch.Tensor, direction: str) -> None:
        """One recorder op a transfer direction: `lo` rows of `t` (its
        tail, or the lo halo's gradient) and `hi` rows."""
        row = t.numel() // max(t.shape[self.dim], 1) * t.element_size()
        for width in (self.lo, self.hi):
            if width:
                trace.note("ppermute", nbytes=width * row,
                           axes=axes_tuple(self.axis), layer=self.layer,
                           region="halo_exchange", direction=direction)

    def post_backward(self, x_shape, g_lo: torch.Tensor,
                      g_hi: torch.Tensor) -> None:
        """Post the backward transfers: g_lo to prev, g_hi to next, and the
        receives of next's g_lo (for this block's tail) and prev's g_hi
        (for its head)."""
        with trace.annotate("halo_exchange", g_lo, self.layer, bwd=True):
            dim, lo, hi = self.dim, self.lo, self.hi
            sends, recvs, landing = [], [], []
            if lo and self.prev is not None:
                sends.append((_wire(self.mesh, g_lo), self.prev))
            if hi and self.next is not None:
                sends.append((_wire(self.mesh, g_hi), self.next))
            for width, src, start in ((lo, self.next, x_shape[dim] - lo),
                                      (hi, self.prev, 0)):
                if width == 0 or src is None:
                    continue
                shape = list(x_shape)
                shape[dim] = width
                buf = self.mesh.wire_buffer(shape, g_lo.dtype, g_lo.device)
                recvs.append((buf, src))
                landing.append((buf, start, width))
            if trace.RECORDER is not None:
                self._note(g_lo if lo else g_hi, "bwd")
            # the sends stay alive until their works complete
            self._bwd = (_p2p(sends, recvs), sends, landing)

    def backward(self, x_shape, g_lo: torch.Tensor, g_hi: torch.Tensor
                 ) -> torch.Tensor:
        """dx of the halo outputs: g_lo to prev, g_hi to next (posted here
        unless `post_backward` has); next's g_lo adds into this block's
        tail, prev's g_hi into its head."""
        if self._bwd is None:
            self.post_backward(x_shape, g_lo, g_hi)
        with trace.annotate("halo_exchange", g_lo, self.layer, bwd=True):
            works, _, landing = self._bwd
            self._bwd = None
            dx = g_lo.new_zeros(x_shape)
            for w in works:
                w.wait()
            global staged
            for buf, start, width in landing:
                if buf.device != dx.device:
                    staged += 1
                    buf = buf.to(dx.device)
                dx.narrow(self.dim, start, width).add_(buf)
            return dx


class _Halo(torch.autograd.Function):
    """(x, exchange) -> (halo_lo, halo_hi), differentiable in x.  The
    outputs may still be in flight when this returns: `_Exchange.wait`
    lands them before anything reads them."""

    @staticmethod
    def forward(ctx, x, ex: _Exchange):
        ctx.ex, ctx.x_shape = ex, tuple(x.shape)
        return ex.issue(x)

    @staticmethod
    def backward(ctx, g_lo, g_hi):
        return ctx.ex.backward(ctx.x_shape, g_lo, g_hi), None


class _Pin(torch.autograd.Function):
    """(interior, halo_lo, halo_hi) -> the same three, the §IV-A pin.
    Its backward posts the halo gradients' transfers the moment the
    boundary convs' backward has made them, before autograd runs the
    interior conv's dL/dx; `_Halo.backward` lands them after it.  Where
    the halos need no gradient (a first layer's input) it passes
    through."""

    @staticmethod
    def forward(ctx, interior, h_lo, h_hi, ex: _Exchange, x_shape):
        ctx.ex, ctx.x_shape = ex, x_shape
        ctx.halo_grad = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        if not ctx.halo_grad:
            ctx.mark_non_differentiable(h_lo, h_hi)
        return interior, h_lo, h_hi

    @staticmethod
    def backward(ctx, g_int, g_lo, g_hi):
        if ctx.halo_grad:
            if trace.RECORDER is not None:
                trace.note("pin", layer=ctx.ex.layer, region="halo_exchange",
                           direction="bwd")
            ctx.ex.post_backward(ctx.x_shape, g_lo, g_hi)
        return g_int, g_lo, g_hi, None, None


class HaloSchedule:
    """Latency-hiding issue order for the halo transfers (§IV-A).

    Construction posts the sends and receives at once; `pin(interior)`
    waits for them after the caller has launched the interior compute,
    which needs no halo, and returns (interior, halo_lo, halo_hi).  A halo
    of width 0 is None."""

    def __init__(self, x: torch.Tensor, dim: int, lo: int, hi: int, axis,
                 mesh: Mesh | None, edge_value: float = 0.0):
        self._ex = _Exchange(dim, lo, hi, axis, mesh, edge_value)
        self._x_shape = tuple(x.shape)
        self._lo, self._hi = _Halo.apply(x, self._ex)
        self.lo = self._lo if lo else None
        self.hi = self._hi if hi else None

    def halos(self):
        """(halo_lo, halo_hi), once they have landed."""
        self._ex.wait()
        return self.lo, self.hi

    def pin(self, interior):
        """(interior, halo_lo, halo_hi) once the halos have landed, through
        `_Pin`, so the backward posts the halo gradients' transfers before
        the interior's dL/dx."""
        self._ex.wait()
        if trace.RECORDER is not None:
            trace.note("pin", layer=self._ex.layer, region="halo_exchange")
        interior, h_lo, h_hi = _Pin.apply(interior, self._lo, self._hi,
                                          self._ex, self._x_shape)
        return (interior, h_lo if self.lo is not None else None,
                h_hi if self.hi is not None else None)


def halo_slices(x: torch.Tensor, dim: int, lo: int, hi: int, axis,
                mesh: Mesh | None, edge_value: float = 0.0):
    """(halo_lo, halo_hi) of local block `x` along `dim`: the last `lo`
    rows of the predecessor shard and the first `hi` rows of the successor
    (`edge_value` at the global edges); None where the width is 0."""
    return HaloSchedule(x, dim, lo, hi, axis, mesh, edge_value).halos()


def halo_exchange(x: torch.Tensor, dim: int, lo: int, hi: int, axis,
                  mesh: Mesh | None, edge_value: float = 0.0) -> torch.Tensor:
    """Local block `x` extended along `dim` with its halo: lo + local + hi
    rows, `edge_value` beyond the global edges."""
    h_lo, h_hi = halo_slices(x, dim, lo, hi, axis, mesh, edge_value)
    parts = [p for p in (h_lo, x, h_hi) if p is not None]
    return x if len(parts) == 1 else torch.cat(parts, dim)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh: Mesh, step: int):
        ctx.axis, ctx.mesh, ctx.step = axis, mesh, step
        return _rotate(x, axis, mesh, step)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, ctx.axis, ctx.mesh, -ctx.step), None, None, None


def _rotate(x: torch.Tensor, axis, mesh: Mesh, step: int) -> torch.Tensor:
    n = mesh.axis_size(axis)
    i = mesh.index(axis)
    buf = mesh.wire_buffer(x.shape, x.dtype, x.device)
    ranks = [mesh.global_rank(r) for r in mesh.ranks(axis)]
    for w in _p2p([(_wire(mesh, x), ranks[(i + step) % n])],
                  [(buf, ranks[(i - step) % n])]):
        w.wait()
    out = x.new_empty(x.shape)
    if buf.device == out.device:
        return buf
    _land(buf, out)
    return out


def ring_shift(x: torch.Tensor, axis, mesh: Mesh | None,
               reverse: bool = False) -> torch.Tensor:
    """Full ring rotation (ring attention's): shard i's block moves to
    shard i+1 (mod n), or to i-1 with `reverse`.  Unlike the stencil halo
    this wraps around.  Differentiable: the backward rotates the other
    way."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    return _RingShift.apply(x, axis, mesh, -1 if reverse else 1)
