"""Generic LM, port of `repro.models.lm.transformer`.

The reference runs its layer stack as `lax.scan` over parameters stacked
per segment of equal block types (`plan`).  PyTorch runs eagerly, so the
port keeps one parameter dict per layer, in execution order, with the
reference's names:

    {"embed": (vocab, d), "final_norm": (d,),
     "layers": [{"ln1", "attn": {"wq", "wk", "wv", "wo"}, "ssm": {...},
                 "fuse_attn", "fuse_ssm", "ln2", "mlp": {...}
                 or "moe": {"router", "wi", "wg", "wo"}}, ...]}

`params_from_jax` unstacks the reference's `segments` into that list.
The dense-attention (`attn`, `swa`), `ssm` and hybrid (`hybrid_g`,
`hybrid_s`) blocks are ported, each with a dense MLP or a mixture of
experts (`moe`, the reference's capacity routing), and so is serving: `prefill` (the prompt
through the kernels, returning each layer's K/V), `init_decode_state`
and `decode_step` (one token against the sequence-sharded KV cache of
`core.decode_attention` and the SSD's recurrence).  Decode state and
prefill K/V are per-layer lists too; `tree_to_jax` / `tree_from_jax`
convert them to and from the reference's per-segment stacks.

`forward`, `loss_fn` and `prefill` take a `ShardCtx`: with the sequence
split over its axis (training and prefill on a mesh, the batch over the
batch axes), each rank runs its own block of tokens at its global
positions, attention as the ring, the SSD with its state halo and the
MoE's routing groups over the global sequence (`modules`); with
`ctx.tp_axis` the experts are split over that axis (expert parallelism,
the params' expert leaves each rank's block, `launch.shardings.
expert_blocks`).  `loss_fn(vocab_parallel=True)` keeps the embedding (and
the unembedding) as each rank's block of the vocabulary and runs the
lookup and the cross entropy as rings over the sequence axis
(`vocab_parallel`).  Encoder-decoder (and so cross-attention decode)
and the modality frontends wait for their slices.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core.decode_attention import cache_append, decode_attention
from repro_torch.models.lm import modules as M
from repro_torch.models.lm import vocab_parallel as VP
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.modules import ShardCtx
from repro_torch.utils import tree_leaves, tree_map

Segment = tuple[tuple[str, ...], int]


def plan(cfg: LMConfig, types: list[str] | None = None) -> list[Segment]:
    """The reference's segmentation of the layer stack: one period-2 unit
    if the types alternate, else runs of equal types."""
    types = types if types is not None else cfg.layer_types()
    if len(set(types)) > 1 and len(types) % 2 == 0:
        unit = tuple(types[:2])
        if types == list(unit) * (len(types) // 2):
            return [(unit, len(types) // 2)]
    segs: list[Segment] = []
    for t in types:
        if segs and segs[-1][0] == (t,):
            segs[-1] = ((t,), segs[-1][1] + 1)
        else:
            segs.append(((t,), 1))
    return segs


def _check_ported(cfg: LMConfig) -> None:
    if cfg.is_encdec or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and modality frontends are not "
            f"ported yet")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _block_init(gen: torch.Generator, cfg: LMConfig, btype: str,
                device) -> dict:
    p: dict[str, Any] = {"ln1": M.norm_init(cfg, cfg.d_model, device)}
    hybrid = btype.startswith("hybrid")
    if btype in ("attn", "swa") or hybrid:
        p["attn"] = M.attn_init(gen, cfg, device)
    if hybrid or btype == "ssm":
        p["ssm"] = M.ssm_init(gen, cfg, device)
    if hybrid:
        p["fuse_attn"] = torch.ones((cfg.d_model,), device=device)
        p["fuse_ssm"] = torch.ones((cfg.d_model,), device=device)
    if cfg.sandwich_norm:
        p["ln1_post"] = M.norm_init(cfg, cfg.d_model, device)
    if cfg.d_ff > 0 and btype != "ssm":
        p["ln2"] = M.norm_init(cfg, cfg.d_model, device)
        if cfg.n_experts:
            p["moe"] = M.moe_init(gen, cfg, device)
        else:
            p["mlp"] = M.mlp_init(gen, cfg, device)
        if cfg.sandwich_norm:
            p["ln2_post"] = M.norm_init(cfg, cfg.d_model, device)
    return p


def init(gen: torch.Generator, cfg: LMConfig, *,
         device: torch.device | str) -> dict:
    """Random fp32 params drawn from `gen` (on the generator's device)
    with the reference's scales: N(0, 1/fan_in) weights, ones for norms and
    the SSD's D, zeros for biases, A_log = log(linspace(1, 16)).  Each
    tensor is moved to `device` (required, as `MeshNet`'s is) as soon as
    it is drawn; the leaves require grad."""
    _check_ported(cfg)
    params: dict[str, Any] = {
        "embed": M.normal_init(gen, (cfg.vocab, cfg.d_model),
                               1.0 / math.sqrt(cfg.d_model), device),
        "final_norm": M.norm_init(cfg, cfg.d_model, device),
        "layers": [_block_init(gen, cfg, bt, device)
                   for bt in cfg.layer_types()],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = M.normal_init(
            gen, (cfg.d_model, cfg.vocab), 1.0 / math.sqrt(cfg.d_model),
            device)
    return tree_map(lambda t: t.requires_grad_(), params)


def params_from_jax(tree: dict, cfg: LMConfig) -> dict:
    """The reference's param (or gradient) tree -> the port's per-layer
    tree, fp32 leaf tensors on the CPU that require grad.

    `tree["segments"]` holds one tuple per `plan(cfg)` segment, each entry a
    block dict whose leaves are stacked on a leading `count` axis; layer
    c of a segment is slice c of every leaf of its unit, units in order.
    Leaves may be numpy arrays or anything `np.asarray` takes; they are
    copied, never aliased."""
    def conv(a, i=None):
        a = np.asarray(a)
        return torch.tensor(a if i is None else a[i], dtype=torch.float32)

    def unstack(sub, i):
        if isinstance(sub, dict):
            return {k: unstack(v, i) for k, v in sub.items()}
        return conv(sub, i)

    segs = plan(cfg)
    if len(tree["segments"]) != len(segs):
        raise ValueError(f"{len(tree['segments'])} segments given, "
                         f"{len(segs)} wanted ({segs})")
    out = {k: conv(v) for k, v in tree.items()
           if k not in ("segments", "enc_segments", "enc_final_norm")}
    layers = []
    for (unit, count), seg in zip(segs, tree["segments"]):
        if len(seg) != len(unit):
            raise ValueError(f"segment {unit} x {count}: {len(seg)} blocks "
                             f"given")
        for c in range(count):
            for block in seg:
                lead = {np.shape(a)[0] for a in tree_leaves(block)}
                if lead != {count}:
                    raise ValueError(f"segment {unit} x {count}: leading "
                                     f"axes {sorted(lead)}")
                layers.append(unstack(block, c))
    out["layers"] = layers
    return tree_map(lambda t: t.requires_grad_(), out)


def _stack(blocks: list):
    if blocks[0] is None:
        return None
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    if isinstance(blocks[0], tuple):
        return tuple(_stack([b[i] for b in blocks])
                     for i in range(len(blocks[0])))
    return torch.stack(blocks)


def _slice(block, c: int):
    if block is None:
        return None
    if isinstance(block, dict):
        return {k: _slice(v, c) for k, v in block.items()}
    if isinstance(block, tuple):
        return tuple(_slice(v, c) for v in block)
    return block[c]


def tree_to_jax(tree: dict, cfg: LMConfig) -> dict:
    """The port's per-layer tree (the params, or any tree of their
    structure: gradients, Adam moments; `{"layers": caches}` for decode
    state or prefill K/V, whose entries are dicts, (k, v) tuples or None)
    in the reference's layout, the
    tensors on their device: `layers` regrouped into `segments`, one tuple
    per `plan(cfg)` segment of block dicts whose leaves stack the
    segment's layers on a leading `count` axis (new tensors).  How a
    checkpoint of the port lays out an LM's leaves."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    segs, first = [], 0
    for unit, count in plan(cfg):
        segs.append(tuple(
            _stack([tree["layers"][first + c * len(unit) + b]
                    for c in range(count)]) for b in range(len(unit))))
        first += count * len(unit)
    out["segments"] = segs
    return out


def tree_from_jax(tree: dict, cfg: LMConfig) -> dict:
    """`tree_to_jax`'s inverse on tensors, without a copy: layer c of a
    segment is slice c of every leaf of its unit's block (a view)."""
    out = {k: v for k, v in tree.items() if k != "segments"}
    out["layers"] = [_slice(block, c)
                     for (unit, count), seg in zip(plan(cfg), tree["segments"])
                     for c in range(count) for block in seg]
    return out


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _block_apply(p: dict, x: torch.Tensor, btype: str, cfg: LMConfig,
                 positions: torch.Tensor, kvs: list | None = None,
                 ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """One block; where `kvs` is a list, the block's (k, v) (None for an
    SSM block) is appended to it (the reference's `collect_kv`)."""
    h = M.norm_apply(cfg, p["ln1"], x)
    window = cfg.window if btype in ("swa", "hybrid_s") else None
    kv = None
    if btype == "ssm":
        out = M.ssm_apply(p["ssm"], h, cfg, ctx)
    elif btype.startswith("hybrid"):
        a_out, kv = M.attn_apply(p["attn"], h, cfg=cfg, positions=positions,
                                 window=window, causal=True, return_kv=True,
                                 ctx=ctx)
        s_out = M.ssm_apply(p["ssm"], h, cfg, ctx)
        out = 0.5 * (M.norm_apply(cfg, p["fuse_attn"], a_out)
                     + M.norm_apply(cfg, p["fuse_ssm"], s_out))
    elif btype in ("attn", "swa"):
        out, kv = M.attn_apply(p["attn"], h, cfg=cfg, positions=positions,
                               window=window, causal=True, return_kv=True,
                               ctx=ctx)
    else:
        raise NotImplementedError(f"block type {btype!r} is not ported yet")
    if kvs is not None:
        kvs.append(kv)
    return _block_tail(p, x, out, btype, cfg, ctx)


def _block_tail(p: dict, x: torch.Tensor, out: torch.Tensor, btype: str,
                cfg: LMConfig, ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """The residual add of the mixer's `out`, then the MLP's or the MoE's
    (shared by the forward and the decode step; `ctx` as x is split, for
    the MoE's routing groups and expert blocks)."""
    if cfg.sandwich_norm:
        out = M.norm_apply(cfg, p["ln1_post"], out)
    x = x + out

    if cfg.d_ff > 0 and btype != "ssm":
        h = M.norm_apply(cfg, p["ln2"], x)
        out = M.moe_apply(p["moe"], h, cfg, ctx) if cfg.n_experts \
            else M.mlp_apply(p["mlp"], h, cfg)
        if cfg.sandwich_norm:
            out = M.norm_apply(cfg, p["ln2_post"], out)
        x = x + out
    return x


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def _embed(params: dict, cfg: LMConfig, tokens: torch.Tensor
           ) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.scale_embedding:
        x = x * math.sqrt(cfg.d_model)
    return x


def _logits(params: dict, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    emb = params["unembed"] if "unembed" in params else params["embed"].T
    logits = x @ emb
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _unit_apply(lps: list, x: torch.Tensor, unit: tuple, cfg: LMConfig,
                positions: torch.Tensor, kvs: list | None = None,
                ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """One unit of a `plan` segment (the reference's scan body): its
    blocks in order."""
    for bt, lp in zip(unit, lps):
        x = _block_apply(lp, x, bt, cfg, positions, kvs, ctx)
    return x


def positions_of(ctx: ShardCtx, s_local: int, device) -> torch.Tensor:
    """The global positions of this rank's S_local tokens: its shard index
    along the sequence axis times S_local, plus 0 .. S_local-1 (what RoPE
    and the masks see; the reference's `arange(S)` over the global
    array)."""
    return ctx.seq_index * s_local + torch.arange(s_local, device=device)


def forward(params: dict, cfg: LMConfig, tokens: torch.Tensor,
            remat: bool = False, collect_kv: bool = False,
            ctx: ShardCtx = ShardCtx()):
    """tokens: (B, S) -> logits (B, S, V); under a `ctx` that splits the
    sequence, this rank's blocks of both.  The layers run unit by unit
    of `plan(cfg)`; with `remat` each unit is a
    `torch.utils.checkpoint` region (the reference's `jax.checkpoint` of
    its scan body): only its input is kept, and the backward runs its
    forward again.  With `collect_kv`, returns (logits, kv): each layer's
    (k, v) in order (this rank's blocks), None for an SSM layer."""
    _check_ported(cfg)
    if remat and collect_kv:
        raise ValueError("collect_kv under remat: the K/V of a recomputed "
                         "unit would be collected twice")
    kvs = [] if collect_kv else None
    x = _layers(params, cfg, _embed(params, cfg, tokens), remat, kvs, ctx)
    logits = _logits(params, cfg, x)
    return (logits, kvs) if collect_kv else logits


def _layers(params: dict, cfg: LMConfig, x: torch.Tensor, remat: bool,
            kvs: list | None, ctx: ShardCtx) -> torch.Tensor:
    """The embedded tokens x (B, S, d) through every layer, unit by unit
    of `plan(cfg)`, and the final norm."""
    types = cfg.layer_types()
    if len(params["layers"]) != len(types):
        raise ValueError(f"{len(params['layers'])} layers given, "
                         f"{len(types)} wanted")
    positions = positions_of(ctx, x.shape[1], x.device)
    first = 0
    for unit, count in plan(cfg):
        for _ in range(count):
            lps = params["layers"][first:first + len(unit)]
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    _unit_apply, lps, x, unit, cfg, positions, None, ctx,
                    use_reentrant=False)
            else:
                x = _unit_apply(lps, x, unit, cfg, positions, kvs, ctx)
            first += len(unit)
    return M.norm_apply(cfg, params["final_norm"], x)


def loss_fn(params: dict, batch: dict, cfg: LMConfig,
            remat: bool = False, ctx: ShardCtx = ShardCtx(),
            vocab_parallel: bool = False) -> torch.Tensor:
    """Next-token cross entropy in fp32.  batch: tokens (B, S), labels
    (B, S).  `remat`: see `forward`.  On a mesh (`ctx.mesh` of more than
    one rank; the batch this rank's block: B over `ctx.batch_axes`, S
    over `ctx.seq_axis`) it is this rank's share of the global mean: the
    local sum over the global token count, as `meshnet.loss_fn`'s, so
    that the train step's sum over the mesh is the mean.

    With `vocab_parallel`, `params["embed"]` (and `params["unembed"]`)
    are this rank's blocks of the vocabulary over "model"
    (`launch.shardings.vocab_blocks`) and the lookup and the cross
    entropy run as rings (`vocab_parallel`): no rank forms the logits of
    the whole vocabulary.  Their gradients come back as whole blocks of
    the global gradient; every other gradient is this rank's share."""
    if vocab_parallel:
        return _loss_vocab_parallel(params, batch, cfg, remat, ctx)
    logits = forward(params, cfg, batch["tokens"], remat, ctx=ctx)
    labels = batch["labels"].long()
    logits = logits[:, -labels.shape[1]:].float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    if ctx.mesh is None or ctx.mesh.size == 1:
        return (logz - gold).mean()
    shards = ctx.mesh.axis_size(ctx.batch_axes) * ctx.seq_size
    return (logz - gold).sum() / (labels.numel() * shards)


def _loss_vocab_parallel(params: dict, batch: dict, cfg: LMConfig,
                         remat: bool, ctx: ShardCtx) -> torch.Tensor:
    """The reference's `_loss_vocab_parallel`: the ring lookup (scaled by
    sqrt(d) where the config says), the layers, the final norm, and the
    ring cross entropy against `unembed`'s block transposed, or the tied
    `embed` block."""
    _check_ported(cfg)
    x = VP.embed_lookup(params["embed"], cfg, batch["tokens"], ctx)
    if cfg.scale_embedding:
        x = x * math.sqrt(cfg.d_model)
    x = _layers(params, cfg, x, remat, None, ctx)
    table = params["unembed"].T if "unembed" in params else params["embed"]
    return VP.xent_loss(table, cfg, x, batch["labels"], ctx)


# ---------------------------------------------------------------------------
# serving: prefill / decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(params: dict, cfg: LMConfig, tokens: torch.Tensor,
            ctx: ShardCtx = ShardCtx()):
    """Run the whole prompt (B, S) through the forward (the attention and
    SSD-chunk kernels on the card) and return (the last position's logits
    (B, 1, V), each layer's (k, v) (B, S, Hkv, hd), None for an SSM
    layer).  `tree_to_jax({"layers": kv}, cfg)["segments"]` is the
    reference's per-segment stacked layout (count, B, S, Hkv, hd).

    Under a `ctx` that splits the sequence, `tokens` is this rank's block
    (B over the batch axes, S over the sequence axis) and so is each
    layer's (k, v), as the reference's `P(ba, "model")` caches; the last
    position's logits come from the last shard of the sequence axis, on
    every rank of it (a sum over the axis in which the others add
    zeros)."""
    logits, kv = forward(params, cfg, tokens, collect_kv=True, ctx=ctx)
    last = logits[:, -1:]
    if ctx.sharded:
        mine = ctx.seq_index == ctx.seq_size - 1
        last = ctx.mesh.all_reduce(last if mine else torch.zeros_like(last),
                                   ctx.seq_axis)
    return last, kv


def init_decode_state(cfg: LMConfig, batch: int, max_len: int, *,
                      device: torch.device | str) -> list[dict]:
    """Empty decode state in fp32, one dict a layer: `k` / `v` (batch,
    max_len, Hkv, hd) for attention and hybrid blocks; `ssm` (batch, H,
    P, N) and `conv` (batch, ssm_conv - 1, d_inner + 2 N) for SSM and
    hybrid blocks.  Under a sequence split, `batch` and `max_len` are
    this rank's block of them.  (The reference stacks them per segment;
    its server asks for fp32.)"""
    _check_ported(cfg)
    state = []
    for bt in cfg.layer_types():
        entry = {}
        if bt in ("attn", "swa") or bt.startswith("hybrid"):
            entry["k"] = torch.zeros(
                (batch, max_len, cfg.n_kv_heads, cfg.head_dim),
                dtype=torch.float32, device=device)
            entry["v"] = torch.zeros_like(entry["k"])
        if bt == "ssm" or bt.startswith("hybrid"):
            entry["ssm"] = torch.zeros(
                (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                dtype=torch.float32, device=device)
            entry["conv"] = torch.zeros(
                (batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                dtype=torch.float32, device=device)
        state.append(entry)
    return state


@torch.no_grad()
def decode_step(params: dict, cfg: LMConfig, tokens: torch.Tensor,
                caches: list[dict], length: int,
                ctx: ShardCtx = ShardCtx()):
    """One decode step.  tokens: (B, 1), this rank's block of the batch;
    caches: `init_decode_state`'s (this rank's blocks under `ctx`);
    length: the filled length, so the token's position.  The K/V caches
    are written in place; the SSM entries are replaced.  Returns (logits
    (B, 1, V), caches)."""
    _check_ported(cfg)
    x = _embed(params, cfg, tokens)
    positions = torch.full((tokens.shape[0], 1), length, dtype=torch.long,
                           device=x.device)
    scale = cfg.attn_scale or 1.0 / math.sqrt(max(cfg.head_dim, 1))
    for lp, bt, cache in zip(params["layers"], cfg.layer_types(), caches):
        x = _decode_block(lp, x, bt, cfg, ctx, positions, length, cache,
                          scale)
    x = M.norm_apply(cfg, params["final_norm"], x)
    return _logits(params, cfg, x), caches


def _decode_block(p: dict, x: torch.Tensor, btype: str, cfg: LMConfig,
                  ctx: ShardCtx, positions: torch.Tensor, length: int,
                  cache: dict, scale: float) -> torch.Tensor:
    h = M.norm_apply(cfg, p["ln1"], x)
    window = cfg.window if btype in ("swa", "hybrid_s") else None

    def attend(h):
        q, k, v = M.attn_qkv(p["attn"], cfg, h, positions)
        kc, vc = cache_append(cache["k"], cache["v"], k, v, length,
                              mesh=ctx.mesh, seq_axis=ctx.seq_axis)
        o = decode_attention(q, kc, vc, length + 1, mesh=ctx.mesh,
                             seq_axis=ctx.seq_axis, scale=scale,
                             window=window, softcap=cfg.attn_softcap)
        return o.reshape(h.shape[0], 1, cfg.n_heads * cfg.head_dim) \
            @ p["attn"]["wo"]

    def recur(h):
        out, cache["ssm"], cache["conv"] = M.ssm_decode_step(
            p["ssm"], h, cfg, cache["ssm"], cache["conv"])
        return out

    if btype == "ssm":
        out = recur(h)
    elif btype.startswith("hybrid"):
        out = 0.5 * (M.norm_apply(cfg, p["fuse_attn"], attend(h))
                     + M.norm_apply(cfg, p["fuse_ssm"], recur(h)))
    elif btype in ("attn", "swa"):
        out = attend(h)
    else:
        raise NotImplementedError(f"block type {btype!r} is not ported yet "
                                  f"(cross-attention decode comes with the "
                                  f"encoder-decoder slice)")
    # the step's one token a row is not split over the sequence: the MoE
    # routes it alone (a group of 1, capacity 1, nothing dropped)
    return _block_tail(p, x, out, btype, cfg)
