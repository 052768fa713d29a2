"""Sequence-parallel state-space recurrence over `torch.distributed`, port
of `repro.core.seq_ssm`: the paper's halo exchange in its purest
transformer-era form.

A (chunked) SSM layer on a sequence-sharded tensor needs exactly one
piece of remote data per shard: the recurrent state flowing in across its
left boundary, a single (B, heads, d_head, d_state) tensor.  That is a
constant-width halo, the analogue of the paper's O-row conv halo.

Each shard reduces its block to a (decay, state) summary (A, S); the
state entering shard p is the exclusive prefix under the associative
combine (x before y)

    (A_x, S_x) o (A_y, S_y) = (A_x A_y, S_x A_y + S_y),

computed over the mesh axis in ceil(log2 P) rounds of a non-wrapping
shift (Hillis-Steele; `core.halo.shift`, differentiable, whose backward is
the mirror shift), then one more shift by one shard: shard 0 receives
zeros, the zero initial state.  Each round sends A and S as one message.
A shard that receives nothing in a round (i < d) adds the zeros it got,
times its decay: exactly its own S, the reference's `where`, with the
received message kept in the graph so that every shard joins every
round's backward.
"""
from __future__ import annotations

import torch

from repro_torch.core.halo import shift
from repro_torch.launch.mesh import Mesh


def seq_prefix_state(a_total: torch.Tensor, s_local: torch.Tensor,
                     axis: str, mesh: Mesh) -> torch.Tensor:
    """Exclusive prefix combine of per-shard (decay, state) summaries.

    a_total: the total decay across the local block (B, H, 1, 1);
    s_local: the state the local block contributes alone (B, H, dh, ds).
    Returns s_in, the recurrent state entering this shard (zeros on shard
    0), in s_local's dtype."""
    n, idx = mesh.axis_size(axis), mesh.index(axis)
    a_inc, s_inc = a_total.to(s_local.dtype), s_local
    d = 1
    while d < n:
        # (A, S) of the prefix ending at i-d, one message (zeros if i < d)
        msg = shift(torch.cat([a_inc.flatten(2), s_inc.flatten(2)], -1),
                    axis, mesh, d)
        a_recv = msg[..., :1].reshape(a_inc.shape)
        s_recv = msg[..., 1:].reshape(s_inc.shape)
        # S[i] <- S[i-d] A[i] + S[i]  (the old A[i])
        s_inc = s_recv * a_inc + s_inc
        if idx >= d:
            a_inc = a_recv * a_inc
        d *= 2
    return shift(s_inc, axis, mesh, 1)
