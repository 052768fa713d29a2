"""The train step, port of `repro.train.train_loop`: mixed precision,
gradient accumulation (micro-batching, the out-of-core technique the
paper cites in §VII) and, on a mesh, the sum of the replicated params'
gradients over the ranks.  Remat and cross-pod gradient compression come
with their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import trace
from repro_torch.launch.mesh import Mesh
from repro_torch.optim.optimizer import Optimizer, global_norm
from repro_torch.utils import BF16, Precision, tree_leaves


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    grad_accum: int = 1
    precision: Precision = BF16


def reduce_replicated_grads(grads: list[torch.Tensor],
                            mesh: Mesh | None) -> list[torch.Tensor]:
    """Each replicated param's gradient summed over the ranks that hold a
    replica: the psum that the reference's `shard_map` inserts for a
    replicated weight's cotangent, done here once a step and nowhere in
    the ops.  Under the uniform plan every param (conv w, gamma, beta) is
    replicated over every mesh axis.  The grads, in params-tree order, go
    as one flat buffer through one all-reduce, so every rank gets the same
    sums and its params stay identical to every other rank's: the named
    region `grad_bucket`, outside every layer (`core.trace.annotate`)."""
    if mesh is None or mesh.size == 1:
        return grads
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    with trace.annotate("grad_bucket", flat, bwd=True):
        flat = mesh.all_reduce(flat, mesh.axis_names)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view(g.shape).to(g.dtype))
        i += g.numel()
    return out


def make_grad_fn(loss_fn: Callable,
                 cfg: TrainStepConfig = TrainStepConfig()):
    """fwd_bwd(params, batch) -> (loss, grads): one forward and backward of
    `loss_fn` in `cfg.precision`, the grads in params-tree order, each in
    its master leaf's dtype, before any sum over a mesh."""
    def fwd_bwd(params, batch):
        leaves = tree_leaves(params)
        loss = loss_fn(cfg.precision.cast_compute(params), batch)
        # grads come back in each master leaf's own dtype
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), list(grads)
    return fwd_bwd


def make_train_step(loss_fn: Callable, opt: Optimizer,
                    cfg: TrainStepConfig = TrainStepConfig(),
                    mesh: Mesh | None = None):
    """loss_fn(params, batch) -> scalar loss (params in compute dtype); on
    a mesh, this rank's share of it (`meshnet.loss_fn`).

    Returns step(params, opt_state, batch) -> (params, opt_state, metrics)
    with metrics {"loss", "grad_norm"} as 0-d tensors on the params'
    device.  On a mesh the grads are `reduce_replicated_grads`'s before
    the update and the norm, and the loss is summed over the ranks (a
    report: autograd does not go through it).  The params tree is updated
    in place (see optim.optimizer).
    """
    fwd_bwd = make_grad_fn(loss_fn, cfg)

    def step(params, opt_state, batch):
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
        if mesh is not None and mesh.size > 1:
            grads = reduce_replicated_grads(grads, mesh)
            loss = mesh.all_reduce(loss, mesh.axis_names)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss,
                                   "grad_norm": global_norm(grads)}

    return step
