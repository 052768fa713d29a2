"""Optimizers over parameter trees, port of `repro.optim.optimizer`:
SGD with momentum (the paper's CNN training), AdamW (the LM training), a
warmup + cosine schedule and global-norm clipping.

Unlike the reference's pure transforms, `update` writes the new values
into the parameter tensors in place (under `no_grad`), which saves a copy
of every weight; it returns the same tree.  The state follows what it is
given: on a mesh with more than one data rank the train step hands `init`
and `update` this rank's blocks of the params and the global gradient
norm, so the moments are sharded as the reference's inherit FSDP's
sharding (ZeRO).  This module knows no mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.utils import tree_leaves, tree_unflatten


class OptState(NamedTuple):
    step: int
    mu: Any          # momentum, one tensor per parameter leaf
    nu: Any          # second moment (None for SGD)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any], tuple[Any, OptState]]


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> Callable[[int], float]:
    """Linear warmup to `base_lr` over `warmup` steps, then a cosine decay
    to `final_frac * base_lr` at `total`."""
    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * (final_frac + (1 - final_frac) * 0.5
                          * (1 + math.cos(math.pi * prog)))
    return lr


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(g.float().square().sum()
                          for g in tree_leaves(grads)))


def clip_by_global_norm(grads: list, max_norm: float,
                        norm: torch.Tensor | None = None):
    """(grads scaled so their global norm is at most `max_norm`, norm).
    `norm`: the global norm where `grads` are blocks of the gradient (the
    ZeRO step's `train_loop.held_norm`), else it is theirs."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return [(g * scale).to(g.dtype) for g in grads], norm


def sgd(lr: float | Callable[[int], float], momentum: float = 0.9,
        clip_norm: float | None = None) -> Optimizer:
    """SGD with momentum.  `params` and `grads` are trees of equal
    structure; the learning rate is evaluated at step+1, as in the
    reference."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return OptState(0, [torch.zeros_like(p) for p in tree_leaves(params)],
                        None)

    @torch.no_grad()
    def update(grads, state, params, norm=None):
        ps, gs = tree_leaves(params), tree_leaves(grads)
        if clip_norm:
            gs, _ = clip_by_global_norm(gs, clip_norm, norm)
        mu = [momentum * m + g for m, g in zip(state.mu, gs)]
        step = state.step + 1
        lrv = lr_fn(step)
        for p, u in zip(ps, mu):
            p.sub_(lrv * u)
        return params, OptState(step, mu, None)

    return Optimizer(init, update)


def adamw(lr: float | Callable[[int], float], b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: float | None = 1.0) -> Optimizer:
    """AdamW (the reference's LM optimizer): global-norm clipping, fp32
    moments, bias correction, decoupled weight decay on every leaf, and
    the learning rate evaluated at step+1.  The moments and the params are
    updated in place."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in tree_leaves(params)]
        return OptState(0, zeros, [torch.zeros_like(z) for z in zeros])

    @torch.no_grad()
    def update(grads, state, params, norm=None):
        ps, gs = tree_leaves(params), tree_leaves(grads)
        if clip_norm:
            gs, _ = clip_by_global_norm(gs, clip_norm, norm)
        step = state.step + 1
        bc1 = 1 - b1 ** step
        bc2 = 1 - b2 ** step
        lrv = lr_fn(step)
        for p, g, m, v in zip(ps, gs, state.mu, state.nu):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            p.sub_((lrv * (u + weight_decay * p.float())).to(p.dtype))
        return params, OptState(step, state.mu, state.nu)

    return Optimizer(init, update)


def state_tree(params, state: OptState,
               to_ref: Callable[[Any], Any] | None = None, *,
               ef: list | None = None) -> tuple:
    """`(params, state, ef)` as the reference's train state, the tree a
    checkpoint holds: flattened (dict keys sorted, None no leaf) its
    leaves run in `jax.tree.flatten` order of the reference's
    `(params, OptState, ef)`: the params, `OptState.step` as a 0-d
    int32, the `mu` leaves, the `nu` leaves (none for SGD), then the
    error-feedback leaves (none without `ef`: one `(npods,) + leaf.shape`
    fp32 array per leaf, the reference's layout).  `mu`, `nu` and `ef`,
    flat lists in params order here, take the params' structure.
    `to_ref` maps a tree of the params' structure to the reference's
    layout where the two differ (an LM's `transformer.tree_to_jax`); the
    CNNs' trees are the reference's.  Every array is global (a sharded
    state is gathered first: `launch.shardings.sharded_state_tree`).  The
    tensors are the live ones (or stacked copies): `CheckpointManager.save`
    copies them to the host."""
    to_ref = to_ref or (lambda t: t)

    def like(flat):
        return to_ref(tree_unflatten(params, iter(flat)))
    return (to_ref(params),
            (np.asarray(state.step, np.int32), like(state.mu),
             None if state.nu is None else like(state.nu)),
            None if ef is None else like(ef))


@torch.no_grad()
def load_state_tree(tree: tuple, params, state: OptState,
                    from_ref: Callable[[Any], Any] | None = None, *,
                    ef: list | None = None) -> OptState:
    """Write a restored `state_tree` into the live tensors in place
    (`copy_`): the params, the moments, the error-feedback residuals
    (`ef`, where the run keeps them); returns the state with the restored
    step.  In place, so a module, the plan's closures and the optimizer's
    moments keep their references.  Every tensor is global (a sharded
    state is cut afterwards: `launch.shardings.load_sharded_state_tree`).
    `from_ref` inverts `state_tree`'s `to_ref` (an LM's
    `transformer.tree_from_jax`)."""
    from_ref = from_ref or (lambda t: t)
    p_tree, (step, mu, nu), ef_tree = tree
    pairs = list(zip(tree_leaves(params), tree_leaves(from_ref(p_tree))))
    pairs += zip(state.mu, tree_leaves(from_ref(mu)))
    if state.nu is not None:
        pairs += zip(state.nu, tree_leaves(from_ref(nu)))
    if ef is not None:
        pairs += zip(ef, tree_leaves(from_ref(ef_tree)))
    for dst, src in pairs:
        dst.copy_(src)
    return OptState(int(step), state.mu, state.nu)
