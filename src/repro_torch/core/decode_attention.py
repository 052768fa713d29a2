"""Sequence-sharded KV-cache decoding, port of
`repro.core.decode_attention`: the paper's spatial decomposition applied
to inference.

The KV cache (B, S, Hkv, D) is block-split along S over the sequence
axis of the mesh (a name, or a tuple of names ranked major-to-minor); the
new token's query is replicated.  Each rank holds its block of the cache
(and, where the batch is split, of B: the caller allocates that block,
as `launch.serve` does, or cuts it from a whole cache with
`launch.shardings.cache_blocks`), computes a partial softmax over it
against the global maximum, and one sum of the denominators and
numerators, packed into one buffer, completes the exact softmax.  So a
step's merge is two all-reduces over the sequence axis: a max of
(B, Hq) and a sum of (B, Hq, D + 1), in fp32.

Window masking makes the same routine serve sliding-window layers: a rank
whose block lies outside the window contributes zeros.

Plain PyTorch, as the reference computes this in jnp outside any Pallas
kernel.  `length` is a host int (the serve loop's step counter), so no
step waits on the device for it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ref import NEG_INF
from repro_torch.launch.mesh import axes_tuple


def _scores(q: torch.Tensor, k: torch.Tensor, k_off: int, length: int,
            scale: float, window: int | None, softcap: float | None
            ) -> torch.Tensor:
    """Masked fp32 scores (B, Hkv, G, S_block) of the one-token query q
    (B, 1, Hq, D) against the block k (B, S_block, Hkv, D) that starts at
    position `k_off`: filled positions (kpos < length) within the window
    around the tip (length - 1 - kpos < window)."""
    b, _, hq, d = q.shape
    sl, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(k_off, k_off + sl, device=q.device)
    mask = kpos < length
    if window is not None:
        mask &= (length - 1 - kpos) < window
    return s.masked_fill(~mask, NEG_INF)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int, *, mesh=None,
                     seq_axis=None, scale: float | None = None,
                     window: int | None = None,
                     softcap: float | None = None) -> torch.Tensor:
    """One-token attention against a (sequence-sharded) KV cache.

    q: (B, 1, Hq, D); k_cache / v_cache: (B, S, Hkv, D), this rank's
    block of S under `seq_axis` (the whole cache where it is None);
    length: the filled length, the new token's position + 1.  Returns
    (B, 1, Hq, D) in q's dtype, the same on every rank of the axis."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    b, _, hq, d = q.shape
    if seq_axis is None or mesh is None:
        s = _scores(q, k_cache, 0, length, scale, window, softcap)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
        return out.reshape(b, 1, hq, d).to(q.dtype)

    axes = axes_tuple(seq_axis)
    sl = k_cache.shape[1]
    s = _scores(q, k_cache, mesh.index(axes) * sl, length, scale, window,
                softcap)
    m = mesh.all_reduce(s.amax(dim=-1), axes, "max")          # (B, Hkv, G)
    p = torch.exp(s - m[..., None])
    num = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    # the denominator rides in the numerator's last column: one sum
    packed = mesh.all_reduce(torch.cat([num, p.sum(-1)[..., None]], -1),
                             axes)
    out = packed[..., :d] / packed[..., d:].clamp_min(1e-30)
    return out.reshape(b, 1, hq, d).to(q.dtype)


@torch.no_grad()
def cache_append(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, length: int, *,
                 mesh=None, seq_axis=None):
    """Write the new token's k/v (B, 1, Hkv, D) at position `length` of
    the cache, in place (the reference donates its caches).  Under a
    sequence axis only the rank whose block holds that position writes;
    there is no communication.  A position outside the cache raises (the
    reference's `dynamic_update_slice` clamps it to the last slot).
    Returns (k_cache, v_cache)."""
    sl = k_cache.shape[1]
    sharded = seq_axis is not None and mesh is not None
    off = mesh.index(axes_tuple(seq_axis)) * sl if sharded else 0
    total = sl * (mesh.axis_size(seq_axis) if sharded else 1)
    if not 0 <= length < total:
        raise IndexError(f"position {length} outside a cache of {total}")
    if off <= length < off + sl:
        k_cache[:, length - off] = k_new[:, 0]
        v_cache[:, length - off] = v_new[:, 0]
    return k_cache, v_cache
