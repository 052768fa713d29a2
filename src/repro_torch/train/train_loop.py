"""The train step, port of `repro.train.train_loop`: mixed precision,
gradient accumulation (micro-batching, the out-of-core technique the
paper cites in §VII), on a mesh the gradient reduction with the
training state sharded over "data" (ZeRO, `launch.shardings`) and the
cross-pod gradient compression (`optim.grad_compress`), and remat of the
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
                 method: str = "none", ef=None):
    """(the gradient blocks this rank holds, the new error-feedback
    state): each rank's share of the gradient (params-tree order) reduced
    over the mesh, in the named region `grad_bucket`.

    With one data rank every leaf is held whole.  Otherwise the leaves
    that `launch.shardings.fsdp_tree_specs` shards go, as one flat buffer
    whose per-rank blocks are contiguous, through one reduce-scatter over
    "data", and each rank's blocks through one all-reduce over the other
    axes; the rest (`reduce_replicated_grads`) through one all-reduce
    over every axis.  Under a compressing `method` the pod axis is left
    out of both, and each pod's gradient (its share times the pod count)
    goes through `cross_pod_mean` instead.  On one data rank and with
    nothing to compress every leaf is small: one all-reduce over every
    axis, as `reduce_replicated_grads` alone."""
    if mesh is None or mesh.size == 1:
        return grads, ef
    pods = method != "none" and "pod" in mesh.axis_names
    specs = shardings.zero_specs(grads, mesh)
    if "pod" in mesh.axis_names and not pods:     # fp32, in the psums
        count_sent("none", 4 * sum(shardings.shard(g, s, mesh).numel()
                                   for g, s in zip(grads, specs)),
                   mesh.shape["pod"], gather=False)
    rest_axes = tuple(a for a in mesh.axis_names if a != "pod" or not pods)
    held: list = [None] * len(grads)
    big = [i for i, s in enumerate(specs) if s]
    small = [i for i, s in enumerate(specs) if not s]
    with trace.annotate("grad_bucket", grads[0], bwd=True):
        if big:
            flat = shardings.pack_rows([grads[i] for i in big],
                                       [specs[i] for i in big],
                                       mesh.shape["data"])
            flat = mesh.reduce_scatter(flat, "data", 0)
            flat = mesh.all_reduce(flat, tuple(a for a in rest_axes
                                               if a != "data"))
            n = 0
            for i in big:
                like = shardings.shard(grads[i], specs[i], mesh)
                held[i] = shardings.unpack(flat[n:n + like.numel()], like,
                                           specs[i]).to(grads[i].dtype)
                n += like.numel()
        if small:
            for i, g in zip(small, reduce_replicated_grads(
                    [grads[i] for i in small], mesh, rest_axes)):
                held[i] = g
        if pods:
            held, ef = cross_pod_mean(
                [h * mesh.shape["pod"] for h in held], mesh=mesh,
                method=method, error_feedback=ef,
                sharded=[bool(s) for s in specs])
    return held, ef


def held_norm(held: list[torch.Tensor], specs: list, mesh: Mesh | None
              ) -> torch.Tensor:
    """The global norm of the whole gradient from the blocks this rank
    holds (`specs`: the whole leaves' `shardings.zero_specs`): the
    sharded blocks' squares summed over "data", the whole leaves' once."""
    if not any(specs):
        return global_norm(held)
    sq = [h.float().square().sum() for h in held]
    blocks = mesh.all_reduce(sum(q for q, s in zip(sq, specs) if s), "data")
    return torch.sqrt(sum((q for q, s in zip(sq, specs) if not s), blocks))


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
                    mesh: Mesh | None = None):
    """loss_fn(params, batch) -> scalar loss (params in compute dtype); on
    a mesh, this rank's share of it (`meshnet.loss_fn`).

    Returns step(params, opt_state, ef_state, batch) -> (params,
    opt_state, ef_state, metrics), the reference's signature, with
    metrics {"loss", "grad_norm"} as 0-d tensors on the params' device.
    `opt_state` holds moments for this rank's blocks
    (`opt.init(launch.shardings.local_shards(params, mesh))`), `ef_state`
    the int8 residuals of `grad_compress.init_error_feedback` (or None).
    On a mesh the grads are `reduce_grads`'s before the update, the norm
    is the whole gradient's after compression, the loss is summed over
    the ranks (a report: autograd does not go through it), and the
    updated blocks are gathered over "data" (`shardings.gather_params_`).
    The params tree is updated in place (see optim.optimizer).
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
        specs = shardings.zero_specs(grads, mesh)
        if mesh is not None and mesh.size > 1:
            grads, ef_state = reduce_grads(
                grads, mesh, method=cfg.pod_compression, ef=ef_state)
            loss = mesh.all_reduce(loss, mesh.axis_names)
        gnorm = held_norm(grads, specs, mesh)
        _, opt_state = opt.update(grads, opt_state,
                                  shardings.local_shards(params, mesh),
                                  norm=gnorm)
        shardings.gather_params_(params, mesh)
        return params, opt_state, ef_state, {"loss": loss,
                                             "grad_norm": gnorm}

    return step
