"""Exact attention with the sequence split over devices, port of
`repro.core.ring_attention`: the paper's spatial decomposition applied to
the transformer's sequence dimension.

Each shard of the sequence axis holds one Q/K/V block.  The halo a query
block needs is its causal past:

- full (global) attention: every predecessor shard, so the K/V blocks
  sweep the ring (`core.halo.ring_shift`, K and V as one message a step)
  while each step's partial softmax is merged by log-sum-exp (ring
  attention): P - 1 exchanges of the local K/V block;
- sliding-window attention: at most `window` past keys, a halo of
  ceil((window - 1) / S_local) predecessor blocks, so the ring stops after
  1 + that many steps (the paper's O-row conv halo);
- bidirectional: the full ring, no causal mask.

Each (query block, K/V block) tile is one call of the attention kernel's
block entry (`kernels.ops.flash_attention_block`, the kernel on the card,
its plain version on the CPU) with the blocks' position offset
delta = (idx - src) * S_local; it returns the block's output normalised
by its own sum, in fp32, and each row's lse.  Under causality a block from
a later shard is fully masked: its launch is skipped, its K/V still passed
on.  The blocks merge in fp32, o = sum_b exp(lse_b - M) o_b / sum_b
exp(lse_b - M) with M the rows' largest lse (a row a block admits no key
to has lse <= -1e29: weight 0), and the result is cast to q's dtype once.
This is the reference's online-softmax accumulator (m, l, o over the
steps, o / max(l, 1e-30)) written as one merge; the results agree up to
fp32 rounding.

The backward keeps no step's P: each block's backward recomputes it
(`FlashAttentionBlock`, the reference's `jax.checkpoint(step)`), and
`ring_shift`'s backward rotates the K/V cotangents home.  A rotation's
backward is a collective of every shard of the axis, so the K/V that
leaves the last step is anchored to the output (`_Anchor`): every shard
runs the backward of every rotation, also where its later blocks were
skipped.  Transport is `core.halo`'s (gloo stages CUDA tensors through the
host, counted in `halo.staged`).

`seq_axis=None` (or a mesh of one shard on it) attends the whole sequence
in one kernel call, `kernels.ops.flash_attention`.  The reference's ring
indexes the mesh by one axis name; a tuple raises here.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.halo import ring_shift
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh


def ring_steps(axis_size: int, s_local: int, window: int | None) -> int:
    """The ring's steps: every shard, or with a window the local block and
    the ceil((window - 1) / S_local) predecessors its halo reaches."""
    if window is None:
        return axis_size
    return min(axis_size, 1 + -(-max(window - 1, 0) // s_local))


class _Anchor(torch.autograd.Function):
    """(out, kv) -> out; the backward hands kv a zero cotangent, so that
    every rotation that made kv has its backward run."""

    @staticmethod
    def forward(ctx, out, kv):
        ctx.kv_shape, ctx.kv_dtype = kv.shape, kv.dtype
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return g, g.new_zeros(ctx.kv_shape, dtype=ctx.kv_dtype)


def merge_blocks(outs: list, lses: list) -> torch.Tensor:
    """The blocks' partial softmaxes (o_b (B,S,Hq,D), lse_b (B,Hq,S), fp32)
    merged by log-sum-exp, in fp32."""
    if len(outs) == 1:
        return outs[0]
    lse = torch.stack(lses)                       # (n, B, Hq, S)
    w = torch.exp(lse - lse.amax(0).detach())
    w = (w / w.sum(0)).transpose(2, 3)[..., None]  # (n, B, S, Hq, 1)
    out = outs[0] * w[0]
    for o, wb in zip(outs[1:], w[1:]):
        out = out + o * wb
    return out


def _ring_attention_local(q, k, v, *, axis: str, mesh: Mesh, scale: float,
                          causal: bool, window, softcap) -> torch.Tensor:
    """This shard's block of the output (see the module docstring)."""
    n, idx, sl = mesh.axis_size(axis), mesh.index(axis), q.shape[1]
    d = k.shape[-1]
    kv = torch.cat([k, v], dim=-1)
    outs, lses = [], []
    steps = ring_steps(n, sl, window)
    for t in range(steps):
        src = (idx - t) % n          # whose K/V this shard holds
        if not (causal and src > idx):
            o_b, lse_b = ops.flash_attention_block(
                q, kv[..., :d].contiguous(), kv[..., d:].contiguous(),
                delta=(idx - src) * sl, causal=causal, window=window,
                softcap=softcap, scale=scale)
            outs.append(o_b)
            lses.append(lse_b)
        if t + 1 < steps:
            kv = ring_shift(kv, axis, mesh)
    out = merge_blocks(outs, lses).to(q.dtype)
    return _Anchor.apply(out, kv) if steps > 1 else out


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: Mesh | None = None, seq_axis: str | None = None,
                   scale: float | None = None, causal: bool = True,
                   window: int | None = None,
                   softcap: float | None = None) -> torch.Tensor:
    """q: (B, S, Hq, D), k/v: (B, S, Hkv, D) -> (B, S, Hq, D) in q's dtype.

    With `seq_axis` (one mesh axis name) the tensors are this rank's
    blocks: S cut over `seq_axis` of `mesh` (B over the batch axes, which
    the ring does not see), and so is the result."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if isinstance(seq_axis, (tuple, list)):
        raise ValueError(f"ring attention runs over one mesh axis, as the "
                         f"reference's does; got seq_axis={seq_axis!r}")
    if seq_axis is None or mesh is None or mesh.axis_size(seq_axis) == 1:
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    return _ring_attention_local(q, k, v, axis=seq_axis, mesh=mesh,
                                 scale=scale, causal=causal, window=window,
                                 softcap=softcap)
