"""Gradient compression for the cross-pod data-parallel reduction, port of
`repro.optim.grad_compress`.

On a multi-pod mesh the `pod` axis crosses the slow fabric between pods;
the gradient reduction there is the dominant inter-pod collective.  Two
compressors:

  * bf16: each pod's gradient goes over the wire in bf16 (2x), summed in
    fp32 locally;
  * int8 + error feedback: a per-tensor scale, the quantization residual
    carried to the next step (1-bit Adam-style EF); 4x over fp32.

Each is an all-gather of the compressed payloads over `pod` followed by
the same fp32 mean on every pod, so every pod ends with the same result
in the same order.  The step (`train.train_loop`) calls `cross_pod_mean`
on each pod's own gradient, the blocks this rank holds after the ZeRO
reduction within its pod (`launch.shardings`), so the compressed payload
is what crosses the pod axis.  (The reference calls it on a gradient
GSPMD has already reduced over every axis: there it rounds a gradient
that is the same on every pod.  With the same input on every pod the two
compute the same thing.)  Under ZeRO a sharded leaf's int8 scale is still
the whole leaf's: its maximum is taken over "data" first.

gloo reduces and gathers a narrower set of dtypes than NCCL (no int16 in
torch 2.13's, for one), so the bf16 payload travels as its bytes (a
uint8 view) and the int8 one as it is.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.utils import tree_leaves, tree_unflatten

METHODS = ("none", "bf16", "int8_ef")

# payload bytes this process put on the pod axis, by method
sent: dict[str, int] = {}


def reset_sent() -> None:
    sent.clear()


def count_sent(method: str, payload: int, npods: int,
               gather: bool = True) -> None:
    """Add a pod exchange's bytes: an all-gather sends its payload to
    every other pod, a (ring) all-reduce 2 (p - 1) / p of it."""
    n = payload * (npods - 1) if gather else \
        payload * 2 * (npods - 1) // npods
    sent[method] = sent.get(method, 0) + n


def _quantize_int8(x: torch.Tensor, amax: torch.Tensor | None = None):
    """(int8 payload, fp32 scale) of `x`: scale = max(max|x|, 1e-12) / 127
    (`amax` in place of max|x| where the caller took it over more than
    `x`), each element rounded half to even and clipped to +-127."""
    if amax is None:
        amax = x.abs().amax()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_feedback(held: Sequence[torch.Tensor], mesh: Mesh | None,
                        method: str) -> list[torch.Tensor] | None:
    """The int8 residual of each of the blocks this rank holds, zero (fp32,
    their shapes), on a mesh with a pod axis under `int8_ef`; else None
    (the other methods carry no state)."""
    if method != "int8_ef" or mesh is None or "pod" not in mesh.axis_names:
        return None
    return [torch.zeros(h.shape, dtype=torch.float32, device=h.device)
            for h in held]


def _flat(leaves, dtype) -> torch.Tensor:
    return torch.cat([x.reshape(-1).to(dtype) for x in leaves])


def _split(flat: torch.Tensor, leaves) -> list[torch.Tensor]:
    out, i = [], 0
    for x in leaves:
        out.append(flat[i:i + x.numel()].view(x.shape).to(x.dtype))
        i += x.numel()
    return out


def cross_pod_mean(grads: Any, *, mesh: Mesh | None, method: str = "bf16",
                   error_feedback: Any = None,
                   sharded: Sequence[bool] | None = None):
    """Average each pod's `grads` over the pod axis with optional
    compression: (the mean, in every pod's `grads` structure and dtypes,
    the new error-feedback state).

    grads: a tree of this pod's gradient blocks (the same on every rank
    of the pod that holds the same blocks).  error_feedback: under
    `int8_ef`, this pod's residual of every leaf (a list in `tree_leaves`
    order; None: zeros).  sharded: which leaves are a "data" block of a
    larger leaf, whose int8 scale is the whole leaf's (None: none).
    Returns `(grads, error_feedback)` unchanged on a mesh with no pod
    axis."""
    if mesh is None or "pod" not in mesh.axis_names:
        return grads, error_feedback
    if method not in METHODS:
        raise ValueError(f"unknown compression method {method!r}")
    npods = mesh.shape["pod"]
    leaves = tree_leaves(grads)

    if method == "none":
        flat = _flat(leaves, torch.float32)
        count_sent(method, flat.numel() * 4, npods, gather=False)
        flat = mesh.all_reduce(flat, "pod") / npods
        return tree_unflatten(grads, iter(_split(flat, leaves))), \
            error_feedback

    if method == "bf16":
        # the bf16 payload on the wire, then a local fp32 mean
        wire = _flat(leaves, torch.bfloat16).view(torch.uint8)
        count_sent(method, wire.numel(), npods)
        xs = mesh.all_gather(wire[None], "pod", 0).view(torch.bfloat16)
        flat = xs.float().sum(0) / npods
        return tree_unflatten(grads, iter(_split(flat, leaves))), \
            error_feedback

    # int8_ef: the residual is per-pod state
    if error_feedback is None:
        error_feedback = [torch.zeros(x.shape, dtype=torch.float32,
                                      device=x.device) for x in leaves]
    x32 = [x.float() + e for x, e in zip(leaves, error_feedback)]
    amax = torch.stack([x.abs().amax() for x in x32])
    if sharded is not None and any(sharded):
        amax = mesh.all_reduce(amax, "data", op="max")
    qs, scales, new_e = [], [], []
    for x, m in zip(x32, amax):
        q, scale = _quantize_int8(x, m)
        qs.append(q.reshape(-1))
        scales.append(scale)
        new_e.append(x - _dequantize(q, scale))     # the next step's residual
    q = torch.cat(qs)
    scale = torch.stack(scales)
    count_sent(method, q.numel() + scale.numel() * 4, npods)
    # the int8 payload and the scales on the wire; every pod dequantizes
    # and averages the same gathered blocks
    q_all = mesh.all_gather(q[None], "pod", 0)                # (npods, S)
    s_all = mesh.all_gather(scale[None], "pod", 0)            # (npods, L)
    out, i = [], 0
    for j, x in enumerate(leaves):
        n = x.numel()
        red = (q_all[:, i:i + n].float() * s_all[:, j:j + 1]).mean(0)
        out.append(red.view(x.shape).to(x.dtype))
        i += n
    return tree_unflatten(grads, iter(out)), new_e
