"""The train step, port of `repro.train.train_loop`: mixed precision,
gradient accumulation (micro-batching, the out-of-core technique the
paper cites in §VII), on a mesh the params held at rest as each rank's
FSDP blocks (`launch.shardings.rest_dims`: the models gather a layer's
blocks at their use and reduce-scatter their gradients over "data" in
its backward), the gradient reduction over the other axes, the
cross-pod gradient compression (`optim.grad_compress`), ZeRO-1 over
("data", "model") with leaves that are a rank's block over "model"
(`TrainStepConfig.zero_axes`, `make_train_step(roles=)`: the dry run's
opt / vpz cells), and remat of the
whole loss (`TrainStepConfig.remat`, the reference's `jax.checkpoint` of
the loss fn).  The trainer asks for remat in the LM loss instead
(`models.lm.transformer.loss_fn(remat=)`, a checkpoint a unit of the
layer stack), as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import trace
from repro_torch.launch import shardings
from repro_torch.launch.mesh import Mesh
from repro_torch.optim.grad_compress import count_sent, cross_pod_mean
from repro_torch.optim.optimizer import Optimizer, global_norm
from repro_torch.utils import BF16, Precision, tree_leaves


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    grad_accum: int = 1
    precision: Precision = BF16
    remat: bool = False                  # rematerialize the loss fn
    pod_compression: str = "none"        # none | bf16 | int8_ef
    # the axes the optimizer state is sharded over: ("data",) (ZeRO over
    # data, FSDP's rule) or ("data", "model") (ZeRO-1 over all chips, the
    # reference's opt / vpz variants, `launch.shardings.zero1_spec`)
    zero_axes: tuple = ("data",)


def reduce_replicated_grads(grads: list[torch.Tensor],
                            mesh: Mesh | None, axes=None
                            ) -> list[torch.Tensor]:
    """Each replicated param's gradient summed over the ranks that hold a
    replica: the psum that the reference's `shard_map` inserts for a
    replicated weight's cotangent, done here once a step and nowhere in
    the ops.  Under the uniform plan every param (conv w, gamma, beta) is
    replicated over every mesh axis.  The grads, in params-tree order, go
    as one flat buffer through one all-reduce over `axes` (default: every
    mesh axis), so every rank gets the same sums and its params stay
    identical to every other rank's: the named region `grad_bucket`,
    outside every layer (`core.trace.annotate`)."""
    if mesh is None or mesh.size == 1 or not grads:
        return grads
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    with trace.annotate("grad_bucket", flat, bwd=True):
        flat = mesh.all_reduce(flat, mesh.axis_names if axes is None
                               else axes)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view(g.shape).to(g.dtype))
        i += g.numel()
    return out


def reduce_grads(grads: list[torch.Tensor], mesh: Mesh | None, *,
                 method: str = "none", ef=None, zero_axes=("data",),
                 roles=None, rest=None):
    """(the gradient blocks this rank holds, the new error-feedback
    state): each rank's share of the gradient (params-tree order) reduced
    over the mesh, in the named region `grad_bucket`.

    The leaves go in groups with the same (axes their state is cut over,
    `launch.shardings.zero_specs`', and axes their gradient is summed
    over), the cut groups first, each group one flat buffer whose
    per-rank blocks are contiguous: a reduce-scatter over its cut and a
    psum over the rest of its sum (a local cut where the sum has none of
    the cut's axes); an uncut group one all-reduce
    (`reduce_replicated_grads`).  With ZeRO over "data" and whole leaves
    that is a reduce-scatter over "data" of the leaves
    `shardings.fsdp_tree_specs` shards, a psum over the other axes, and
    one all-reduce over every axis of the rest.  A leaf that is this
    rank's block over "model" (`roles`) is summed only over the axes its
    gradient has not been summed over already (`shardings.reduce_axes`:
    none for a vocabulary block, the batch axes for an expert block).
    With the params at rest (`rest`, `shardings.rest_dims`' entries) a
    cut leaf's gradient is its block summed over "data" already: under
    ZeRO over "data" it goes through the psum over the rest of the axes
    with the whole leaves', under ZeRO-1 through a reduce-scatter over
    "model" within the block and a psum over the pods.

    Under a compressing `method` the pod axis is left out of every sum,
    and each pod's gradient (its share times the pod count) goes through
    `cross_pod_mean` instead, its int8 scale each whole leaf's; a
    vocabulary block, already summed over the pods, goes through it as
    it is (its rounding alone, as in the reference, which compresses a
    gradient summed over every axis)."""
    if mesh is None or mesh.size == 1:
        return grads, ef
    roles = roles or ["whole"] * len(grads)
    dims = shardings.rest_list(rest, len(grads))
    specs = shardings.zero_specs(grads, mesh, zero_axes, roles, rest)
    pods = "pod" in mesh.axis_names
    compress = pods and method != "none"
    if pods and not compress:                     # fp32, in the psums
        count_sent("none", 4 * sum(shardings.shard(g, s, mesh).numel()
                                   for g, s in zip(grads, specs)),
                   mesh.shape["pod"], gather=False)
    with trace.annotate("grad_bucket", grads[0], bwd=True):
        held = _reduce_groups(grads, mesh, specs, roles,
                              skip=("pod",) if compress else (), dims=dims)
        if compress:
            # a pod's share times the pod count; a vocabulary block
            # arrives summed over the pods already
            npods = [mesh.shape["pod"] if "pod" in
                     shardings.reduce_axes(r, mesh, d) else 1
                     for r, d in zip(roles, dims)]
            cut = {a for s, r, d in zip(specs, roles, dims)
                   for a in shardings.spec_axes(s) +
                   shardings.block_axes(r, d)}
            held, ef = cross_pod_mean(
                [h * k for h, k in zip(held, npods)], mesh=mesh,
                method=method, error_feedback=ef,
                cut_axes=tuple(a for a in mesh.axis_names if a in cut))
    return held, ef


def _reduce_groups(grads: list[torch.Tensor], mesh: Mesh, specs, roles,
                   skip=(), dims=None) -> list[torch.Tensor]:
    """`reduce_grads`' sums: the leaves grouped by (the axes their state
    is cut over, `specs`, the axes their gradient is summed over, less
    `skip`), the cut groups first.  `dims`: each leaf's dim cut at rest
    (None: held as the model reads it)."""
    dims = dims or [None] * len(grads)
    groups: dict[tuple, list[int]] = {}
    for i, (s, r, d) in enumerate(zip(specs, roles, dims)):
        over = tuple(a for a in shardings.reduce_axes(r, mesh, d)
                     if a not in skip)
        groups.setdefault((shardings.spec_axes(s), over), []).append(i)
    held: list = [None] * len(grads)
    for (cut, over), idx in sorted(groups.items(),
                                   key=lambda kv: not kv[0][0]):
        if not cut:
            for i, g in zip(idx, reduce_replicated_grads(
                    [grads[i] for i in idx], mesh, over)):
                held[i] = g
            continue
        k = mesh.axis_size(cut)
        flat = shardings.pack_rows([grads[i] for i in idx],
                                   [specs[i] for i in idx], k)
        if set(cut) <= set(over):
            flat = mesh.reduce_scatter(flat, cut, 0)
        elif set(cut) & set(over):
            raise ValueError(f"state cut over {cut}, gradient summed "
                             f"over {over}")
        else:
            flat = flat.view(k, -1)[mesh.index(cut)]
        flat = mesh.all_reduce(flat, tuple(a for a in over
                                           if a not in cut))
        n = 0
        for i in idx:
            like = shardings.shard(grads[i], specs[i], mesh)
            held[i] = shardings.unpack(flat[n:n + like.numel()], like,
                                       specs[i]).to(grads[i].dtype)
            n += like.numel()
    return held


def held_norm(held: list[torch.Tensor], specs: list, mesh: Mesh | None,
              roles=None, rest=None) -> torch.Tensor:
    """The global norm of the whole gradient from the blocks this rank
    holds (`specs`: the leaves' `shardings.zero_specs`): each block's
    squares summed over the axes its leaf is cut over (the state's cut,
    "model" for a leaf of `roles` that is a block over it, and "data"
    for a leaf cut at rest, `rest`), a whole leaf's once."""
    roles = roles or ["whole"] * len(held)
    dims = shardings.rest_list(rest, len(held))
    over = [shardings.spec_axes(s) + tuple(
        a for a in shardings.block_axes(r, d)
        if a not in shardings.spec_axes(s))
        for s, r, d in zip(specs, roles, dims)]
    if not any(over):
        return global_norm(held)
    sq = [h.float().square().sum() for h in held]
    total = None
    for axes in dict.fromkeys(o for o in over if o):
        part = mesh.all_reduce(sum(q for q, o in zip(sq, over) if o == axes),
                               axes)
        total = part if total is None else total + part
    return torch.sqrt(sum((q for q, o in zip(sq, over) if not o), total))


def make_grad_fn(loss_fn: Callable,
                 cfg: TrainStepConfig = TrainStepConfig()):
    """fwd_bwd(params, batch) -> (loss, grads): one forward and backward of
    `loss_fn` in `cfg.precision`, the grads in params-tree order, each in
    its master leaf's dtype, before any sum over a mesh.  Under
    `cfg.remat` the forward keeps only its inputs and the backward runs it
    again (`torch.utils.checkpoint`)."""
    def lfn(params, batch):
        if cfg.remat:
            return checkpoint(loss_fn, params, batch, use_reentrant=False)
        return loss_fn(params, batch)

    def fwd_bwd(params, batch):
        leaves = tree_leaves(params)
        loss = lfn(cfg.precision.cast_compute(params), batch)
        # grads come back in each master leaf's own dtype; an empty leaf
        # (olmo's non-parametric norms) has an empty one, and any other
        # leaf the loss does not reach raises
        grads = iter(torch.autograd.grad(
            loss, [p for p in leaves if p.numel()]))
        return loss.detach(), [next(grads) if p.numel() else
                               torch.zeros_like(p) for p in leaves]
    return fwd_bwd


def make_train_step(loss_fn: Callable, opt: Optimizer,
                    cfg: TrainStepConfig = TrainStepConfig(),
                    mesh: Mesh | None = None, roles=None, rest=None):
    """loss_fn(params, batch) -> scalar loss (params in compute dtype); on
    a mesh, this rank's share of it (`meshnet.loss_fn`).

    Returns step(params, opt_state, ef_state, batch) -> (params,
    opt_state, ef_state, metrics), the reference's signature, with
    metrics {"loss", "grad_norm"} as 0-d tensors on the params' device.
    On a mesh whose data axis cuts a leaf, `params` are held at rest:
    each such leaf this rank's block (`launch.shardings.param_blocks`
    under `rest`, `shardings.rest_dims`' tree or its leaves), which
    `loss_fn` gathers at its use (`shardings.gather_at_use`); `roles`,
    `shardings.leaf_roles`', says which leaves are blocks over "model".
    `opt_state` holds moments for this rank's blocks
    (`opt.init(launch.shardings.local_shards(params, mesh,
    cfg.zero_axes, roles, rest))`), `ef_state` the int8 residuals of
    `grad_compress.init_error_feedback` (or None).  On a mesh the grads
    are `reduce_grads`'s before the update, the norm is the whole
    gradient's after compression, the loss is summed over the ranks (a
    report: autograd does not go through it); under ZeRO-1 the updated
    pieces of each data block are gathered over "model"
    (`shardings.gather_cuts_`).  The params tree is updated in place
    (see optim.optimizer).
    """
    fwd_bwd = make_grad_fn(loss_fn, cfg)

    def step(params, opt_state, ef_state, batch):
        if cfg.grad_accum > 1:
            k = cfg.grad_accum
            n = next(iter(batch.values())).shape[0]
            if n % k:
                raise ValueError(f"batch {n} not divisible by grad_accum {k}")
            loss, grads = 0.0, None
            for i in range(k):
                mb = {key: v[i * n // k:(i + 1) * n // k]
                      for key, v in batch.items()}
                l, g = fwd_bwd(params, mb)
                loss = loss + l
                grads = g if grads is None else \
                    [a + b for a, b in zip(grads, g)]
            loss = loss / k
            grads = [g / k for g in grads]
        else:
            loss, grads = fwd_bwd(params, batch)
        specs = shardings.zero_specs(grads, mesh, cfg.zero_axes, roles,
                                     rest)
        if mesh is not None and mesh.shape.get(shardings.DATA_AXIS, 1) > 1 \
                and any(shardings.DATA_AXIS in shardings.spec_axes(s)
                        for s in specs):
            raise ValueError(
                "a param held whole on a mesh whose data axis cuts it: "
                "hold the params at rest (launch.shardings.param_blocks) "
                "and pass their rest_dims")
        if mesh is not None and mesh.size > 1:
            grads, ef_state = reduce_grads(
                grads, mesh, method=cfg.pod_compression, ef=ef_state,
                zero_axes=cfg.zero_axes, roles=roles, rest=rest)
            loss = mesh.all_reduce(loss, mesh.axis_names)
        gnorm = held_norm(grads, specs, mesh, roles, rest)
        _, opt_state = opt.update(
            grads, opt_state,
            shardings.local_shards(params, mesh, cfg.zero_axes, roles,
                                   rest), norm=gnorm)
        shardings.gather_cuts_(params, mesh, cfg.zero_axes, roles, rest)
        return params, opt_state, ef_state, {"loss": loss,
                                             "grad_norm": gnorm}

    return step
