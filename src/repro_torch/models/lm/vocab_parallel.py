"""Ring vocab-parallel embedding and cross entropy, port of
`repro.models.lm.vocab_parallel` (the paper's §III-D channel/filter
parallelism applied to the embedding, run as a ring like the spatial
halo sweeps).

The dense path forms the (B, S, V) logits and needs the whole (V, d)
table on every rank.  Here each rank of the sequence axis ("model")
holds one (V/P, d) block of the table, the vocabulary padded to a
multiple of P with rows that never match (`launch.shardings.
vocab_blocks`), and the blocks rotate round the ring
(`core.halo.ring_shift`, one message a step):

- `embed_lookup`: each step adds the rows of the tokens the visiting
  block owns; the backward rotates each block's cotangent home through
  `ring_shift`'s own backward.
- `xent_loss` (`_XentRing`, an autograd Function): each step streams the
  (B, S_l, V/P) logits of the visiting block into each row's running max,
  sum-exp and gold logit, so no (B, S, V) tensor exists; the backward
  recomputes each block's logits, forms dlogits = g (softmax - onehot)
  times the final softcap's derivative, adds dx locally and sends each
  block's table cotangent round the ring beside the table, so that it
  arrives home after the full rotation.  Nothing is kept per step.

A rotation that nothing reads after it is skipped (P - 1 table messages
a pass; the cotangent's P in the cross entropy's backward).  The table
is replicated over the batch axes, so its cotangent is summed over them
in both backwards: a rank's table-block gradient is that block of the
global gradient.  Every other gradient is the rank's part, for the
caller to sum over the whole mesh, as `transformer.loss_fn` leaves it.
The products are plain `torch.matmul`, as the reference's are `@`
outside any Pallas kernel.  `sent` counts the rotations' messages and
bytes (forward and backward), which gloo stages through the host on CUDA
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.halo import ring_shift
from repro_torch.models.lm.config import LMConfig

NEG_BIG = -1e30     # a padded column's logit

# table (and table-cotangent) rotations this process sent, forward and
# backward: {"messages": n, "bytes": b}
sent = {"messages": 0, "bytes": 0}


def reset_sent() -> None:
    sent.update(messages=0, bytes=0)


def _count(t: torch.Tensor) -> None:
    sent["messages"] += 1
    sent["bytes"] += t.numel() * t.element_size()


def _rotate(t: torch.Tensor, axis, mesh) -> torch.Tensor:
    """`ring_shift` by one shard, counted in `sent` (where `t` needs a
    gradient, its backward's message too)."""
    _count(t)
    out = ring_shift(t, axis, mesh)
    if out.requires_grad:
        out.register_hook(lambda g: _count(g))
    return out


class _SumOverBatch(torch.autograd.Function):
    """Identity; the backward sums the cotangent over the batch axes (the
    table block is replicated there)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), ctx.axes), None, None


def _ring(ctx, seq_axis) -> tuple:
    """(axis size, this rank's index on it, the batch axes of more than
    one shard) of `ctx.mesh`: (1, 0, ()) without a mesh."""
    mesh = ctx.mesh
    if mesh is None:
        return 1, 0, ()
    batch = tuple(a for a in ctx.batch_axes if mesh.axis_size(a) > 1)
    return mesh.axis_size(seq_axis), mesh.index(seq_axis), batch


def _owned(ids: torch.Tensor, lo: int, vshard: int):
    """(ids - lo clipped into the block, whether the block owns them)."""
    return ((ids - lo).clamp(0, vshard - 1),
            (ids >= lo) & (ids < lo + vshard))


def embed_lookup(table_block: torch.Tensor, cfg: LMConfig,
                 tokens: torch.Tensor, ctx, seq_axis="model") -> torch.Tensor:
    """table_block: this rank's (V/P, d) rows of the padded table (the
    whole table without a ring); tokens: this rank's (B, S_l) block ->
    x (B, S_l, d) in the table's dtype."""
    n, idx, batch = _ring(ctx, seq_axis)
    tokens = tokens.long()
    if batch:
        table_block = _SumOverBatch.apply(table_block, ctx.mesh, batch)
    if n == 1:
        return table_block[tokens]
    vshard = table_block.shape[0]
    tbl, x = table_block, None
    for t in range(n):
        local, owns = _owned(tokens, ((idx - t) % n) * vshard, vshard)
        rows = torch.where(owns[..., None], tbl[local], 0.0)
        x = rows if x is None else x + rows
        if t + 1 < n:
            tbl = _rotate(tbl, seq_axis, ctx.mesh)
    return x


def _logits_chunk(x: torch.Tensor, tbl: torch.Tensor, lo: int, *,
                  softcap, v_real: int) -> torch.Tensor:
    """x (B, S_l, d) against the block of rows lo .. lo + V/P: fp32 logits
    with the final softcap, padded columns (rows >= v_real) at -1e30."""
    logits = (x @ tbl.to(x.dtype).T).float()
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    vshard = tbl.shape[0]
    if lo + vshard > v_real:
        pad = torch.arange(lo, lo + vshard, device=x.device) >= v_real
        logits = logits.masked_fill(pad, NEG_BIG)
    return logits


class _XentRing(torch.autograd.Function):
    """Per-token cross entropy (B, S_l) of x against the ring's table
    blocks; 0 where `valid` is false.  ring: (mesh, axis, its size, this
    rank's index, the batch axes to sum the table's cotangent over, the
    final softcap, the real vocabulary)."""

    @staticmethod
    def forward(ctx, x, tbl, lbl, valid, ring):
        mesh, axis, n, idx, _, softcap, v_real = ring
        vshard = tbl.shape[0]
        m = torch.full(lbl.shape, NEG_BIG, device=x.device)
        se = torch.zeros(lbl.shape, device=x.device)
        gold = torch.zeros(lbl.shape, device=x.device)
        tblc = tbl
        for t in range(n):
            lo = ((idx - t) % n) * vshard
            logits = _logits_chunk(x, tblc, lo, softcap=softcap,
                                   v_real=v_real)
            m_new = torch.maximum(m, logits.amax(-1))
            se = se * torch.exp(m - m_new) + \
                torch.exp(logits - m_new[..., None]).sum(-1)
            m = m_new
            local, owns = _owned(lbl, lo, vshard)
            g = torch.gather(logits, -1, local[..., None])[..., 0]
            gold = gold + torch.where(owns, g, 0.0)
            del logits
            if t + 1 < n:
                tblc = _rotate(tblc, axis, mesh)
        ctx.save_for_backward(x, tbl, lbl, valid, m, se)
        ctx.ring = ring
        logz = m + torch.log(se.clamp_min(1e-30))
        return torch.where(valid, logz - gold, 0.0)

    @staticmethod
    def backward(ctx, g):
        x, tbl, lbl, valid, m, se = ctx.saved_tensors
        mesh, axis, n, idx, batch, softcap, v_real = ctx.ring
        vshard = tbl.shape[0]
        gv = (g * valid).float()[..., None]              # (B, S_l, 1)
        inv = 1.0 / se.clamp_min(1e-30)[..., None]
        x2 = x.reshape(-1, x.shape[-1]).float()
        dx = torch.zeros(x2.shape, device=x.device)
        tblc, dtbl = tbl, None
        for t in range(n):
            lo = ((idx - t) % n) * vshard
            logits = _logits_chunk(x, tblc, lo, softcap=softcap,
                                   v_real=v_real)
            dl = torch.exp(logits - m[..., None]) * inv
            local, owns = _owned(lbl, lo, vshard)
            dl.scatter_add_(-1, local[..., None],
                            -owns[..., None].to(dl.dtype))
            dl = dl * gv
            if softcap:      # d tanh-cap: 1 - (logits / cap)^2
                dl = dl * (1.0 - (logits / softcap).square())
            if lo + vshard > v_real:     # padded columns: no 0 * inf
                pad = torch.arange(lo, lo + vshard, device=x.device) >= v_real
                dl = dl.masked_fill(pad, 0.0)
            del logits
            dl = dl.reshape(-1, vshard)
            tf = tblc.float()
            dx += dl @ tf
            # a flat 2-D product: no (B, V/P, d) partial products
            part = dl.T @ x2
            dtbl = part if dtbl is None else dtbl + part
            del dl, part
            if n > 1:
                if t + 1 < n:
                    tblc = _rotate(tblc, axis, mesh)
                dtbl = _rotate(dtbl, axis, mesh)
        # after the full rotation each block's cotangent is home; the table
        # is replicated over the batch axes, so its cotangent sums there
        if batch:
            dtbl = mesh.all_reduce(dtbl, batch)
        return (dx.reshape(x.shape).to(x.dtype), dtbl.to(tbl.dtype),
                None, None, None)


def xent_loss(table_block: torch.Tensor, cfg: LMConfig, x: torch.Tensor,
              labels: torch.Tensor, ctx, seq_axis="model") -> torch.Tensor:
    """Next-token cross entropy without the global logits.

    table_block: this rank's (V/P, d) rows of the padded table (the whole
    table without a ring); x: this rank's (B, S_l, d) final hidden states;
    labels: (B, S_l), -1 (any negative) unscored.  Returns this rank's
    share of the global mean, its sum over the global count of scored
    tokens, so that the shares of the mesh sum to the mean (the port's
    mesh convention, `transformer.loss_fn`'s); the mean itself without a
    mesh."""
    n, idx, batch = _ring(ctx, seq_axis)
    labels = labels.long()
    valid = labels >= 0
    per_tok = _XentRing.apply(x, table_block, labels.clamp_min(0), valid,
                              (ctx.mesh, seq_axis, n, idx, batch,
                               cfg.final_softcap, cfg.vocab))
    count = valid.sum().float()
    if ctx.mesh is not None and ctx.mesh.size > 1:
        count = ctx.mesh.all_reduce(count, ctx.mesh.axis_names)
    return per_tok.sum() / count
