"""Differentiable collectives over mesh axes, and the §III-C redistribution
of an NHWC block from one layout to another built from them.

The reference gets both from JAX: a collective inside `shard_map` carries
its transpose, and a reshard is a `with_sharding_constraint` that GSPMD
lowers.  Here each is written out.  `all_gather`, `reduce_scatter` and
`all_to_all` are autograd Functions over `launch.mesh.Mesh`'s
collectives whose backward is the exact adjoint of the forward: the
adjoint of an all-gather is a reduce-scatter (and back), the adjoint of
an all-to-all the inverse all-to-all.  A block cut from a replicated
tensor is `narrow`, whose adjoint, zero-padding, autograd supplies.

The convention that makes those adjoints the right ones: where a tensor
is replicated over an axis, each replica's gradient is its share of the
gradient, and the shares sum to it.  A reduce-scatter, or the sum over
the mesh of a replicated param's gradient
(`train.train_loop.reduce_grads`), adds them up.

A layout names, for each dim of an NHWC block, the tuple of mesh axes
that shard it, major-to-minor, () where it is not sharded (`layout`).
`reshard` moves a block between two layouts, axis by axis: an axis that
moves from one dim to another is one all-to-all on that axis's group,
an axis that stops sharding a dim is an all-gather, and an axis that
starts sharding a dim is a local slice.

Every collective is a named region (`core.trace.annotate`, forward and
backward alike, qualified by the layer that runs it:
`conv4_2/cf_reduce_scatter`) and the bytes this rank sends in it are
added to `sent[name]`.
"""
from __future__ import annotations

import torch

from repro_torch.core import trace
from repro_torch.launch.mesh import Mesh, axes_tuple

Layout = tuple[tuple[str, ...], tuple[str, ...], tuple[str, ...],
               tuple[str, ...]]

# bytes this process sent, by collective name, forward and backward
sent: dict[str, int] = {}


def reset_sent() -> None:
    sent.clear()


def _count(name: str, nbytes: float) -> None:
    sent[name] = sent.get(name, 0) + int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _gather(t, mesh: Mesh, axes, dim: int, name: str,
            layer: str | None = None, bwd: bool = False) -> torch.Tensor:
    p = mesh.axis_size(axes)
    with trace.annotate(name, t, layer, bwd):
        _count(name, _nbytes(t) * (p - 1))
        return mesh.all_gather(t, axes, dim)


def _scatter(t, mesh: Mesh, axes, dim: int, name: str,
             layer: str | None = None, bwd: bool = False) -> torch.Tensor:
    p = mesh.axis_size(axes)
    with trace.annotate(name, t, layer, bwd):
        _count(name, _nbytes(t) * (p - 1) // p)
        return mesh.reduce_scatter(t, axes, dim)


def _exchange(t, mesh: Mesh, axes, split_dim: int, cat_dim: int,
              name: str, layer: str | None = None, bwd: bool = False
              ) -> torch.Tensor:
    p = mesh.axis_size(axes)
    with trace.annotate(name, t, layer, bwd):
        _count(name, _nbytes(t) * (p - 1) // p)
        return mesh.all_to_all(t, axes, split_dim, cat_dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim, name):
        ctx.args = (mesh, axes, dim, name, trace.current_layer())
        return _gather(t, mesh, axes, dim, name)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, *ctx.args, bwd=True), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim, name):
        ctx.args = (mesh, axes, dim, name, trace.current_layer())
        return _scatter(t, mesh, axes, dim, name)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args, bwd=True), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, split_dim, cat_dim, name):
        ctx.args = (mesh, axes, split_dim, cat_dim, name,
                    trace.current_layer())
        return _exchange(t, mesh, axes, split_dim, cat_dim, name)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_dim, cat_dim, name, layer = ctx.args
        return (_exchange(g, mesh, axes, cat_dim, split_dim, name, layer,
                          bwd=True),
                None, None, None, None, None)


def all_gather(t: torch.Tensor, mesh: Mesh, axes, dim: int,
               name: str = "all_gather") -> torch.Tensor:
    """The blocks of every rank of `axes` concatenated along `dim`, in
    shard-index order; backward: the reduce-scatter of the gradient."""
    if mesh is None or mesh.axis_size(axes) == 1:
        return t
    return _AllGather.apply(t, mesh, axes_tuple(axes), dim, name)


def reduce_scatter(t: torch.Tensor, mesh: Mesh, axes, dim: int,
                   name: str = "reduce_scatter") -> torch.Tensor:
    """This rank's block along `dim` of the sum over the ranks of `axes`;
    backward: the all-gather of the gradient."""
    if mesh is None or mesh.axis_size(axes) == 1:
        return t
    return _ReduceScatter.apply(t, mesh, axes_tuple(axes), dim, name)


def all_to_all(t: torch.Tensor, mesh: Mesh, axes, split_dim: int,
               cat_dim: int, name: str = "all_to_all") -> torch.Tensor:
    """`split_dim` cut over the shards of `axes`, block j to shard j, the
    received blocks concatenated along `cat_dim`; backward: the inverse
    all-to-all."""
    if mesh is None or mesh.axis_size(axes) == 1:
        return t
    return _AllToAll.apply(t, mesh, axes_tuple(axes), split_dim, cat_dim,
                           name)


def take_block(t: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block along `dim` of `t` (replicated over `axes`): a
    local slice, whose adjoint is zero-padding."""
    if mesh is None or mesh.axis_size(axes) == 1:
        return t
    n = t.shape[dim] // mesh.axis_size(axes)
    return t.narrow(dim, mesh.index(axes) * n, n)


# ------------------------------------------------------------- reshard --

def layout(sharding) -> Layout:
    """The mesh axes of each dim of the NHWC block that `sharding` (a
    ConvSharding or a CFSharding) takes, from its `x_spec`."""
    return tuple(axes_tuple(a) for a in sharding.x_spec())


def reshard_steps(src: Layout, dst: Layout) -> list[tuple]:
    """The collectives that move a block from layout `src` to `dst`, in
    order, each ("gather", axis, dim), ("slice", axis, dim) or
    ("all_to_all", axis, from_dim, to_dim).

    Each dim keeps the longest prefix its two layouts share.  The rest of
    its `src` axes are gathered innermost first, and the rest of its
    `dst` axes sliced in outermost first, once the dim holds only its
    prefix.  An axis gathered from one dim while it can be sliced into
    another is one all-to-all."""
    cur = [list(a) for a in src]
    dst = [tuple(a) for a in dst]

    def done(d):                      # cur[d] is a prefix of dst[d]
        return tuple(cur[d]) == dst[d][:len(cur[d])]

    def next_slice(d):
        return dst[d][len(cur[d])] if done(d) and \
            len(cur[d]) < len(dst[d]) else None

    steps = []
    while any(tuple(c) != d for c, d in zip(cur, dst)):
        gathers = [(cur[d][-1], d) for d in range(4) if not done(d)]
        fused = [(a, d1, d2) for a, d1 in gathers for d2 in range(4)
                 if d2 != d1 and next_slice(d2) == a]
        if fused:
            a, d1, d2 = fused[0]
            cur[d1].pop()
            cur[d2].append(a)
            steps.append(("all_to_all", a, d1, d2))
            continue
        if gathers:
            # a gather that no slice waits for first, so an axis that
            # moves keeps its chance of going as one all-to-all
            wanted = {a for d in dst for a in d}
            a, d = min(gathers, key=lambda g: g[0] in wanted)
            cur[d].pop()
            steps.append(("gather", a, d))
            continue
        d = next(d for d in range(4) if next_slice(d) is not None)
        a = next_slice(d)
        cur[d].append(a)
        steps.append(("slice", a, d))
    return steps


def reshard(x: torch.Tensor, src: Layout, dst: Layout, mesh: Mesh | None,
            name: str = "reshard") -> torch.Tensor:
    """This rank's block of the tensor whose block under layout `src` is
    `x`, under layout `dst` (§III-C); differentiable."""
    if mesh is None or src == dst:
        return x
    for op, a, d1, *rest in reshard_steps(src, dst):
        if op == "gather":
            x = all_gather(x, mesh, a, d1, name)
        elif op == "slice":
            x = take_block(x, mesh, a, d1)
        else:
            x = all_to_all(x, mesh, a, rest[0], d1, name)
    return x.contiguous()


def reshard_bytes(shape, src: Layout, dst: Layout,
                  mesh_shape: dict[str, int], wordsize: int = 4) -> int:
    """Bytes one rank sends in the forward `reshard` of a tensor of global
    `shape` from `src` to `dst` (the counts `sent` takes at run time)."""
    block = list(shape)
    for d, axes in enumerate(src):
        for a in axes:
            block[d] //= mesh_shape[a]
    total = 0
    for op, a, d1, *rest in reshard_steps(src, dst):
        p = mesh_shape[a]
        words = 1
        for e in block:
            words *= e
        if op == "gather":
            total += words * wordsize * (p - 1)
            block[d1] *= p
        elif op == "slice":
            block[d1] //= p
        else:
            total += words * wordsize * (p - 1) // p
            block[d1] *= p
            block[rest[0]] //= p
    return total
