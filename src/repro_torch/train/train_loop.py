"""Train-step builder, port of `repro.train.train_loop` for one device:
mixed precision and gradient accumulation (micro-batching, the
out-of-core technique the paper cites in §VII).  Remat and cross-pod
gradient compression come with their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.optim.optimizer import Optimizer, global_norm
from repro_torch.utils import BF16, Precision, tree_leaves


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    grad_accum: int = 1
    precision: Precision = BF16


def make_train_step(loss_fn: Callable, opt: Optimizer,
                    cfg: TrainStepConfig = TrainStepConfig()):
    """loss_fn(params, batch) -> scalar loss (params in compute dtype).

    Returns step(params, opt_state, batch) -> (params, opt_state, metrics)
    with metrics {"loss", "grad_norm"} as 0-d tensors on the params'
    device.  The params tree is updated in place (see optim.optimizer).
    """
    def fwd_bwd(params, batch):
        leaves = tree_leaves(params)
        loss = loss_fn(cfg.precision.cast_compute(params), batch)
        # grads come back in each master leaf's own dtype
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), list(grads)

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
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss,
                                   "grad_norm": global_norm(grads)}

    return step
