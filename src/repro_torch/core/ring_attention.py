"""Exact attention with the sequence split over devices, port of
`repro.core.ring_attention`: the paper's spatial decomposition applied to
the transformer's sequence dimension.

This slice ports the one-device path: `seq_axis=None` attends the whole
sequence as one tile, which is what the reference's `_block_attend` does
there (online softmax, GQA, causal and window masks at -1e30, softcap, l
clamped at 1e-30) and what `kernels.ops.flash_attention` computes.  The
ring over `torch.distributed` (K/V blocks passed around the sequence
shards, a window-wide halo for sliding-window layers) comes with the halo
slice.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   seq_axis: str | None = None, scale: float | None = None,
                   causal: bool = True, window: int | None = None,
                   softcap: float | None = None) -> torch.Tensor:
    """q: (B, S, Hq, D), k/v: (B, S, Hkv, D) -> (B, S, Hq, D) in q's dtype.

    Only `seq_axis=None` (one shard) is ported; a sequence axis raises."""
    if seq_axis is not None:
        raise NotImplementedError(
            f"ring attention over seq_axis={seq_axis!r} comes with the halo "
            f"slice; this port runs seq_axis=None")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale)
