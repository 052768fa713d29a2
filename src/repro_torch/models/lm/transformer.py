"""Generic LM, port of `repro.models.lm.transformer`.

The reference runs its layer stack as `lax.scan` over parameters stacked
per segment of equal block types (`plan`).  PyTorch runs eagerly, so the
port keeps one parameter dict per layer, in execution order, with the
reference's names:

    {"embed": (vocab, d), "final_norm": (d,),
     "layers": [{"ln1", "attn": {"wq", "wk", "wv", "wo"}, "ssm": {...},
                 "fuse_attn", "fuse_ssm", "ln_cross", "cross": {...},
                 "ln2", "mlp": {...}
                 or "moe": {"router", "wi", "wg", "wo"}}, ...],
     "enc_layers": [...], "enc_final_norm": (d,)}   (encoder-decoder)

`params_from_jax` unstacks the reference's `segments` (and
`enc_segments`) into those lists.  Every block type of the reference is
ported: dense attention (`attn`, `swa`), `ssm`, hybrid (`hybrid_g`,
`hybrid_s`), the bidirectional encoder block (`enc`) and the decoder
block with cross-attention to the encoder's memory (`xattn`), each with
a dense MLP or a mixture of experts (`moe`, the reference's capacity
routing); so is serving: `prefill` (the prompt through the kernels,
returning each layer's K/V and the encoder's memory),
`init_decode_state` and `decode_step` (one token against the
sequence-sharded KV cache of `core.decode_attention`, the SSD's
recurrence and, for `xattn`, the memory).  Decode state and prefill K/V
are per-layer lists too; `tree_to_jax` / `tree_from_jax` convert them
to and from the reference's per-segment stacks.

The modality frontends are the reference's stubs: an encoder-decoder
(`cfg.is_encdec`) takes precomputed frame embeddings (`frames`, (B,
S_enc, d)) into `encode`; the VLM backbone takes precomputed patch
embeddings (`extra_embeds`, `batch["patch_embeds"]`, (B, S_img, d)),
prefixed to the text tokens' embeddings, and its loss scores the text
only.

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
(`vocab_parallel`).  Under a sequence split the patch prefix is part of
the sequence that is split: each rank holds its block of prefix + text,
with -1 labels over the prefix (`data.pipeline.shard_lm_batch`); the
encoder's frames, and so its memory, are split as the tokens are.

With `ctx.rest` (the params at rest, the trainer's and the dry run's
cells': each leaf that the reference's `fsdp_tree_specs` cuts held as
this rank's block over "data"), each layer gathers its blocks where it
runs, in the forward, `prefill` and `decode_step` alike, and so do the
embedding, the final norms and the unembedding at their uses
(`launch.shardings.gather_at_use`); their gradients are reduce-scattered
over "data" in the backward.  The serving cells' vocabulary and expert
blocks over "model" (`ctx.model_blocks`) are gathered whole after that,
under no_grad.  Outside a checkpointed unit
(`shardings.AtUse`) an op's saved copy of a gathered leaf is kept as its
block and gathered again in the backward; under remat the unit's
recompute gathers again.  `stack_counts` gives the reference's stacked
leaf count that the placement rule reads (`shardings.rest_dims`).

The loss runs no dead encoder: where no layer of `cfg.layer_types()` is
`xattn` (every registered encoder-decoder: the reference's `layer_types`
never yields one), the memory reaches nothing, so `loss_fn` does not run
`encode` and hands every encoder leaf a zero gradient, which is what
`jax.grad` gives the reference's.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core.decode_attention import cache_append, decode_attention
from repro_torch.launch import shardings
from repro_torch.models.lm import modules as M
from repro_torch.models.lm import vocab_parallel as VP
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.modules import ShardCtx
from repro_torch.utils import tree_leaves, tree_map

Segment = tuple[tuple[str, ...], int]
ATTN_TYPES = ("attn", "swa", "enc", "xattn")


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


def enc_types(cfg: LMConfig) -> list[str]:
    """The encoder's block types (the reference's `["enc"] *
    n_enc_layers`)."""
    return ["enc"] * cfg.n_enc_layers


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _block_init(gen: torch.Generator, cfg: LMConfig, btype: str,
                device) -> dict:
    p: dict[str, Any] = {"ln1": M.norm_init(cfg, cfg.d_model, device)}
    hybrid = btype.startswith("hybrid")
    if btype in ATTN_TYPES or hybrid:
        p["attn"] = M.attn_init(gen, cfg, device)
    if hybrid or btype == "ssm":
        p["ssm"] = M.ssm_init(gen, cfg, device)
    if hybrid:
        p["fuse_attn"] = torch.ones((cfg.d_model,), device=device)
        p["fuse_ssm"] = torch.ones((cfg.d_model,), device=device)
    if btype == "xattn":
        p["ln_cross"] = M.norm_init(cfg, cfg.d_model, device)
        p["cross"] = M.attn_init(gen, cfg, device)
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


# the leaves that the reference draws in fp32 whatever the params' dtype:
# the norms' scales, the hybrid block's fuse scales, the SSD's dt_bias,
# A_log, D and gate_norm, and the MoE's router
FP32_LEAVES = frozenset({
    "ln1", "ln2", "ln1_post", "ln2_post", "ln_cross", "final_norm",
    "enc_final_norm", "fuse_attn", "fuse_ssm", "dt_bias", "A_log", "D",
    "gate_norm", "router"})


def in_dtype(tree: Any, dtype: torch.dtype, name: str | None = None
             ) -> Any:
    """`tree` (the params, or any subtree of them, `name` the key it
    sits under) with its leaves in `dtype` by the reference's rule
    (`init(dtype=)`): every leaf but FP32_LEAVES, which stay fp32.  A
    leaf already in its dtype is itself; the others are new tensors."""
    if isinstance(tree, dict):
        return {k: in_dtype(v, dtype, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(in_dtype(v, dtype, name) for v in tree)
    return tree.to(torch.float32 if name in FP32_LEAVES else dtype)


def init(gen: torch.Generator, cfg: LMConfig, *,
         device: torch.device | str, dtype: torch.dtype = torch.float32,
         place=None) -> dict:
    """Random params drawn from `gen` (on the generator's device) with
    the reference's scales: N(0, 1/fan_in) weights, ones for norms and
    the SSD's D, zeros for biases, A_log = log(linspace(1, 16)).  Each
    tensor is drawn in fp32 and moved to `device` (required, as
    `MeshNet`'s is) as soon as it is drawn; the leaves are then in
    `dtype` by the reference's rule (`in_dtype`: the norms, the SSD's
    scalars and the router stay fp32), so one seed gives the same values
    in every dtype, rounded.  `place(path, subtree)`, where given, is
    called on each top-level entry and each layer as soon as it is drawn
    (path ("embed",), ("layers", i), ...) and its result is kept in its
    place: a caller cuts a layer to its blocks before the next is drawn.
    The leaves require grad.  An encoder-decoder's `enc_layers` and
    `enc_final_norm` are drawn last, as the reference adds them last."""
    def put(path, sub):
        sub = in_dtype(sub, dtype, path[0])
        return sub if place is None else place(path, sub)

    params: dict[str, Any] = {
        "embed": put(("embed",), M.normal_init(
            gen, (cfg.vocab, cfg.d_model), 1.0 / math.sqrt(cfg.d_model),
            device)),
        "final_norm": put(("final_norm",),
                          M.norm_init(cfg, cfg.d_model, device)),
        "layers": [put(("layers", i), _block_init(gen, cfg, bt, device))
                   for i, bt in enumerate(cfg.layer_types())],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = put(("unembed",), M.normal_init(
            gen, (cfg.d_model, cfg.vocab), 1.0 / math.sqrt(cfg.d_model),
            device))
    if cfg.is_encdec:
        params["enc_layers"] = [
            put(("enc_layers", i), _block_init(gen, cfg, bt, device))
            for i, bt in enumerate(enc_types(cfg))]
        params["enc_final_norm"] = put(
            ("enc_final_norm",), M.norm_init(cfg, cfg.d_model, device))
    return tree_map(lambda t: t.requires_grad_(), params)


def params_from_jax(tree: dict, cfg: LMConfig) -> dict:
    """The reference's param (or gradient) tree -> the port's per-layer
    tree, fp32 leaf tensors on the CPU that require grad.

    `tree["segments"]` holds one tuple per `plan(cfg)` segment, each entry a
    block dict whose leaves are stacked on a leading `count` axis; layer
    c of a segment is slice c of every leaf of its unit, units in order.
    An encoder-decoder's `tree["enc_segments"]` (the segments of
    `plan(cfg, enc_types(cfg))`) become `enc_layers` the same way.
    Leaves may be numpy arrays or anything `np.asarray` takes; they are
    copied, never aliased."""
    def conv(a, i=None):
        a = np.asarray(a)
        return torch.tensor(a if i is None else a[i], dtype=torch.float32)

    def unstack(sub, i):
        if isinstance(sub, dict):
            return {k: unstack(v, i) for k, v in sub.items()}
        return conv(sub, i)

    def layers_of(segments, segs):
        if len(segments) != len(segs):
            raise ValueError(f"{len(segments)} segments given, "
                             f"{len(segs)} wanted ({segs})")
        layers = []
        for (unit, count), seg in zip(segs, segments):
            if len(seg) != len(unit):
                raise ValueError(f"segment {unit} x {count}: {len(seg)} "
                                 f"blocks given")
            for c in range(count):
                for block in seg:
                    lead = {np.shape(a)[0] for a in tree_leaves(block)}
                    if lead != {count}:
                        raise ValueError(f"segment {unit} x {count}: "
                                         f"leading axes {sorted(lead)}")
                    layers.append(unstack(block, c))
        return layers

    if ("enc_segments" in tree) != cfg.is_encdec:
        raise ValueError(f"{cfg.name}: enc_segments "
                         f"{'missing' if cfg.is_encdec else 'given'} "
                         f"(n_enc_layers {cfg.n_enc_layers})")
    out = {k: conv(v) for k, v in tree.items()
           if k not in ("segments", "enc_segments")}
    out["layers"] = layers_of(tree["segments"], plan(cfg))
    if cfg.is_encdec:
        out["enc_layers"] = layers_of(tree["enc_segments"],
                                      plan(cfg, enc_types(cfg)))
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
    segment's layers on a leading `count` axis (new tensors); an
    encoder-decoder's `enc_layers` into `enc_segments` the same way.  How
    a checkpoint of the port lays out an LM's leaves."""
    def segments(layers, segs):
        out, first = [], 0
        for unit, count in segs:
            out.append(tuple(
                _stack([layers[first + c * len(unit) + b]
                        for c in range(count)]) for b in range(len(unit))))
            first += count * len(unit)
        return out

    out = {k: v for k, v in tree.items()
           if k not in ("layers", "enc_layers")}
    out["segments"] = segments(tree["layers"], plan(cfg))
    if "enc_layers" in tree:
        out["enc_segments"] = segments(tree["enc_layers"],
                                       plan(cfg, enc_types(cfg)))
    return out


def tree_from_jax(tree: dict, cfg: LMConfig) -> dict:
    """`tree_to_jax`'s inverse on tensors, without a copy: layer c of a
    segment is slice c of every leaf of its unit's block (a view)."""
    def layers(segments, segs):
        return [_slice(block, c) for (unit, count), seg in zip(segs, segments)
                for c in range(count) for block in seg]

    out = {k: v for k, v in tree.items()
           if k not in ("segments", "enc_segments")}
    out["layers"] = layers(tree["segments"], plan(cfg))
    if "enc_segments" in tree:
        out["enc_layers"] = layers(tree["enc_segments"],
                                   plan(cfg, enc_types(cfg)))
    return out


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _cross_kv(p: dict, cfg: LMConfig, memory: torch.Tensor):
    """K/V (B, S_mem, Hkv, hd) of the encoder memory (B, S_mem, d) under
    the cross-attention params `p`: no rope on cross-attention."""
    b, s, _ = memory.shape
    k = memory @ p["wk"]
    v = memory @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return (k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim))


def _block_apply(p: dict, x: torch.Tensor, btype: str, cfg: LMConfig,
                 positions: torch.Tensor, kvs: list | None = None,
                 ctx: ShardCtx = ShardCtx(),
                 memory: torch.Tensor | None = None) -> torch.Tensor:
    """One block; where `kvs` is a list, the block's (k, v) (None for an
    SSM block) is appended to it (the reference's `collect_kv`).  An
    `enc` block attends bidirectionally; an `xattn` block runs its causal
    self-attention, then cross-attention of the residual stream against
    `memory` (the encoder's output: this rank's block under `ctx`)."""
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
    elif btype in ATTN_TYPES:
        out, kv = M.attn_apply(p["attn"], h, cfg=cfg, positions=positions,
                               window=window, causal=btype != "enc",
                               return_kv=True, ctx=ctx)
    else:
        raise ValueError(f"unknown block type {btype!r}")
    if kvs is not None:
        kvs.append(kv)
    cross = None
    if btype == "xattn":
        if memory is None:
            raise ValueError("an xattn block needs the encoder's memory")

        def cross(x):
            hc = M.norm_apply(cfg, p["ln_cross"], x)
            return x + M.attn_apply(
                p["cross"], hc, cfg=cfg, positions=positions, window=None,
                causal=False, ctx=ctx,
                kv_override=_cross_kv(p["cross"], cfg, memory))
    return _block_tail(p, x, out, btype, cfg, ctx, cross)


def _block_tail(p: dict, x: torch.Tensor, out: torch.Tensor, btype: str,
                cfg: LMConfig, ctx: ShardCtx = ShardCtx(),
                cross=None) -> torch.Tensor:
    """The residual add of the mixer's `out`, then `cross` (an `xattn`
    block's cross-attention, x -> x plus its output), then the MLP's or the
    MoE's (shared by the forward and the decode step; `ctx` as x is
    split, for the MoE's routing groups and expert blocks)."""
    if cfg.sandwich_norm:
        out = M.norm_apply(cfg, p["ln1_post"], out)
    x = x + out
    if cross is not None:
        x = cross(x)

    if cfg.d_ff > 0 and btype != "ssm":
        h = M.norm_apply(cfg, p["ln2"], x)
        out = M.moe_apply(p["moe"], h, cfg, ctx) if cfg.n_experts \
            else M.mlp_apply(p["mlp"], h, cfg)
        if cfg.sandwich_norm:
            out = M.norm_apply(cfg, p["ln2_post"], out)
        x = x + out
    return x


# ---------------------------------------------------------------------------
# params at rest
# ---------------------------------------------------------------------------

def stack_counts(params: dict, cfg: LMConfig) -> dict:
    """A tree of `params`' structure: for each leaf of `layers` (and
    `enc_layers`), the layer count of the `plan` segment whose stacked
    leaf holds it in the reference's tree (`tree_to_jax`); None for the
    other leaves, which the reference does not stack."""
    def per_layer(layers, types):
        counts = []
        for unit, count in plan(cfg, types):
            counts += [count] * (len(unit) * count)
        return [tree_map(lambda _, c=c: c, lp)
                for lp, c in zip(layers, counts)]
    out = tree_map(lambda _: None, params)
    out["layers"] = per_layer(params["layers"], cfg.layer_types())
    if "enc_layers" in params:
        out["enc_layers"] = per_layer(params["enc_layers"], enc_types(cfg))
    return out


def _rest(ctx: ShardCtx, *keys):
    """`ctx.rest`'s entry at `keys` (None where the params are held as
    the model reads them)."""
    r = ctx.rest
    for k in keys:
        if r is None:
            return None
        r = r[k]
    return r


def _at_use(use, params: dict, ctx: ShardCtx, *names: str,
            summed: bool = False, cfg: LMConfig | None = None) -> dict:
    """`params` with its top-level leaves `names` (those it has) gathered
    at their use by `use` (`shardings.AtUse`); with `cfg`, a vocabulary
    block over "model" that `ctx.model_blocks` names is then gathered
    whole over "model" too (the serving cells')."""
    names = [n for n in names if n in params]
    part = use({n: params[n] for n in names},
               {n: _rest(ctx, n) for n in names} if ctx.rest is not None
               else None, summed=summed)
    if cfg is not None and "vocab" in ctx.model_blocks:
        _serving_only(ctx)
        part = shardings.gather_vocab(part, ctx.mesh, cfg.vocab)
    return {**params, **part}


def _serving_only(ctx: ShardCtx) -> None:
    """`ctx.model_blocks`' gathers pass no gradient back: serving only."""
    if torch.is_grad_enabled():
        raise ValueError(f"ctx.model_blocks {ctx.model_blocks} are gathered "
                         f"for serving, under no_grad; a trainer reads its "
                         f"blocks over \"model\" as blocks (tp_axis, the "
                         f"vocab-parallel loss)")


def _layer_at_use(lp: dict, rest, ctx: ShardCtx, use=None) -> dict:
    """One layer's params `lp` as the layer reads them: its blocks at
    rest (`rest`, its `ctx.rest` entry) gathered over "data"
    (`shardings.gather_at_use`, `use` its `AtUse`), then its experts
    gathered over "model" where `ctx.model_blocks` names them."""
    lp = shardings.gather_at_use(lp, rest, ctx.mesh, saved=use)
    if "experts" in ctx.model_blocks and "moe" in lp:
        _serving_only(ctx)
        lp = shardings.gather_experts({"layers": [lp]}, ctx.mesh)["layers"][0]
    return lp


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def _embed(params: dict, cfg: LMConfig, tokens: torch.Tensor,
           extra_embeds: torch.Tensor | None = None,
           ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """The tokens' embeddings (scaled by sqrt(d) where the config says),
    after the frontend's `extra_embeds` (B, S_img, d), cast to their dtype
    (the reference's modality prefix)."""
    with shardings.AtUse(ctx.mesh) as use:
        x = _at_use(use, params, ctx, "embed",
                    cfg=cfg)["embed"][tokens.long()]
    if cfg.scale_embedding:
        x = x * math.sqrt(cfg.d_model)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def _logits(params: dict, cfg: LMConfig, x: torch.Tensor,
            ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    with shardings.AtUse(ctx.mesh) as use:
        held = _at_use(use, params, ctx, "unembed" if "unembed" in params
                       else "embed", cfg=cfg)
        emb = held["unembed"] if "unembed" in params else held["embed"].T
        logits = x @ emb
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _unit_apply(lps: list, x: torch.Tensor, unit: tuple, cfg: LMConfig,
                positions: torch.Tensor, kvs: list | None = None,
                ctx: ShardCtx = ShardCtx(),
                memory: torch.Tensor | None = None, rests=None,
                use=None) -> torch.Tensor:
    """One unit of a `plan` segment (the reference's scan body): its
    blocks in order, each gathering its params held at rest (`rests`,
    their `ctx.rest` entries) at its use (`_layer_at_use`; `use`: the
    `shardings.AtUse` of the unit, None in a checkpointed unit)."""
    for i, (bt, lp) in enumerate(zip(unit, lps)):
        lp = _layer_at_use(lp, None if rests is None else rests[i], ctx,
                           use)
        x = _block_apply(lp, x, bt, cfg, positions, kvs, ctx, memory)
    return x


def positions_of(ctx: ShardCtx, s_local: int, device) -> torch.Tensor:
    """The global positions of this rank's S_local tokens: its shard index
    along the sequence axis times S_local, plus 0 .. S_local-1 (what RoPE
    and the masks see; the reference's `arange(S)` over the global
    array).  With a patch prefix, S is prefix + text and the rank's block
    is its block of that (`data.pipeline.shard_lm_batch`)."""
    return ctx.seq_index * s_local + torch.arange(s_local, device=device)


def _run_layers(layers: list, types: list[str], cfg: LMConfig,
                x: torch.Tensor, remat: bool, kvs: list | None,
                ctx: ShardCtx, memory: torch.Tensor | None = None,
                rest: list | None = None) -> torch.Tensor:
    """x (B, S, d) through `layers` of block `types`, unit by unit of
    `plan(cfg, types)`, at this rank's global positions, each layer
    gathering its params held at rest (`rest`, their `ctx.rest`
    entries) at its use; with `remat` each unit is a
    `torch.utils.checkpoint` region (the reference's `jax.checkpoint` of
    its scan body): only its inputs are kept, and the backward runs its
    forward again, the gathers with it."""
    if len(layers) != len(types):
        raise ValueError(f"{len(layers)} layers given, {len(types)} "
                         f"wanted")
    positions = positions_of(ctx, x.shape[1], x.device)
    first = 0
    for unit, count in plan(cfg, types):
        for _ in range(count):
            lps = layers[first:first + len(unit)]
            rests = None if rest is None else rest[first:first + len(unit)]
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    _unit_apply, lps, x, unit, cfg, positions, None, ctx,
                    memory, rests, use_reentrant=False)
            else:
                with shardings.AtUse(ctx.mesh) as use:
                    x = _unit_apply(lps, x, unit, cfg, positions, kvs, ctx,
                                    memory, rests, use)
            first += len(unit)
    return x


def _layers(params: dict, cfg: LMConfig, x: torch.Tensor, remat: bool,
            kvs: list | None, ctx: ShardCtx,
            memory: torch.Tensor | None = None) -> torch.Tensor:
    """The embedded tokens x (B, S, d) through every decoder layer and the
    final norm."""
    x = _run_layers(params["layers"], cfg.layer_types(), cfg, x, remat, kvs,
                    ctx, memory, _rest(ctx, "layers"))
    with shardings.AtUse(ctx.mesh) as use:
        return M.norm_apply(cfg, _at_use(use, params, ctx,
                                         "final_norm")["final_norm"], x)


def encode(params: dict, cfg: LMConfig, frames: torch.Tensor,
           ctx: ShardCtx = ShardCtx(), remat: bool = False) -> torch.Tensor:
    """The encoder stack over the frontend's frame embeddings (B, S_enc,
    d) (cast to the embedding's dtype): one bidirectional attention call
    a layer, then `enc_final_norm`.  Under a `ctx` that splits the
    sequence, `frames` and the memory returned are this rank's blocks (B
    over the batch axes, S_enc over the sequence axis) at their global
    positions, and each layer's attention is the ring's full sweep."""
    if not cfg.is_encdec:
        raise ValueError(f"{cfg.name} has no encoder")
    x = frames.to(params["embed"].dtype)
    x = _run_layers(params["enc_layers"], enc_types(cfg), cfg, x, remat,
                    None, ctx, rest=_rest(ctx, "enc_layers"))
    with shardings.AtUse(ctx.mesh) as use:
        return M.norm_apply(cfg, _at_use(use, params, ctx, "enc_final_norm")
                            ["enc_final_norm"], x)


def _frames(cfg: LMConfig, frames):
    if cfg.is_encdec and frames is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder needs its "
                         f"encoder frames")
    return frames


def forward(params: dict, cfg: LMConfig, tokens: torch.Tensor,
            remat: bool = False, collect_kv: bool = False,
            ctx: ShardCtx = ShardCtx(),
            extra_embeds: torch.Tensor | None = None,
            frames: torch.Tensor | None = None):
    """tokens: (B, S) -> logits (B, S_img + S, V) (S_img: `extra_embeds`'
    prefix, if any); under a `ctx` that splits the sequence, this rank's
    blocks of them.  An encoder-decoder encodes `frames` first (its
    memory feeds the `xattn` layers).  `remat`: see `_run_layers`.  With
    `collect_kv`, returns (logits, kv, memory): each layer's (k, v) in
    order (this rank's blocks), None for an SSM layer, and the encoder's
    memory (None without an encoder), as the reference's."""
    if remat and collect_kv:
        raise ValueError("collect_kv under remat: the K/V of a recomputed "
                         "unit would be collected twice")
    frames = _frames(cfg, frames)
    memory = None if frames is None else \
        encode(params, cfg, frames, ctx, remat)
    kvs = [] if collect_kv else None
    x = _layers(params, cfg, _embed(params, cfg, tokens, extra_embeds, ctx),
                remat, kvs, ctx, memory)
    logits = _logits(params, cfg, x, ctx)
    return (logits, kvs, memory) if collect_kv else logits


class _ZeroGrads(torch.autograd.Function):
    """(loss, *leaves) -> loss; the backward hands each leaf a zero
    gradient: the leaves that the loss does not read, for which
    `jax.grad` gives zeros."""

    @staticmethod
    def forward(ctx, loss, *leaves):
        ctx.like = [(t.shape, t.dtype, t.device) for t in leaves]
        return loss.view_as(loss)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=dt, device=dev)
                            for s, dt, dev in ctx.like)


def _loss_memory(params: dict, batch: dict, cfg: LMConfig, remat: bool,
                 ctx: ShardCtx):
    """(memory, dead): the encoder's memory where an `xattn` layer reads
    it, with no dead leaves; else no memory, and the encoder's leaves,
    which the loss must give zero gradients (see the module docstring)."""
    frames = _frames(cfg, batch.get("frames"))
    if frames is None:
        return None, ()
    if "xattn" in cfg.layer_types():
        return encode(params, cfg, frames, ctx, remat), ()
    return None, tuple(tree_leaves([params["enc_final_norm"],
                                    params["enc_layers"]]))


def _front_pad(labels: torch.Tensor, s: int) -> torch.Tensor:
    """labels (B, S_l) preceded by -1 (unscored) up to s positions: the
    patch prefix's."""
    if labels.shape[1] > s:
        raise ValueError(f"{labels.shape[1]} labels for {s} positions")
    return F.pad(labels, (s - labels.shape[1], 0), value=-1)


def loss_fn(params: dict, batch: dict, cfg: LMConfig,
            remat: bool = False, ctx: ShardCtx = ShardCtx(),
            vocab_parallel: bool = False) -> torch.Tensor:
    """Next-token cross entropy in fp32.  batch: tokens (B, S), labels
    (B, S); an encoder-decoder's `frames` (B, S_enc, d); a VLM's
    `patch_embeds` (B, S_img, d), whose positions are not scored (the
    reference's `logits[:, -S:]`).  `remat`: see `_run_layers`.  On a
    mesh (`ctx.mesh` of more than one rank; the batch this rank's block:
    B over `ctx.batch_axes`, S over `ctx.seq_axis`, with a patch prefix
    the block of prefix + text and its labels, -1 over the prefix) it is
    this rank's share of the global mean: the local sum over the global
    token count, as `meshnet.loss_fn`'s, so that the train step's sum
    over the mesh is the mean.  An encoder-decoder whose memory no layer
    reads runs no encoder: its leaves get zero gradients.

    With `vocab_parallel`, `params["embed"]` (and `params["unembed"]`)
    are this rank's blocks of the vocabulary over "model"
    (`launch.shardings.vocab_blocks`) and the lookup and the cross
    entropy run as rings (`vocab_parallel`): no rank forms the logits of
    the whole vocabulary.  Their gradients come back as whole blocks of
    the global gradient; every other gradient is this rank's share."""
    memory, dead = _loss_memory(params, batch, cfg, remat, ctx)
    if vocab_parallel:
        loss = _loss_vocab_parallel(params, batch, cfg, remat, ctx, memory)
    else:
        extra = batch.get("patch_embeds")
        x = _layers(params, cfg, _embed(params, cfg, batch["tokens"], extra,
                                        ctx), remat, None, ctx, memory)
        logits = _logits(params, cfg, x, ctx).float()
        labels = batch["labels"].long()
        if extra is None:
            loss = _xent(logits, labels, ctx)
        else:
            loss = _xent_scored(logits, _front_pad(labels, x.shape[1]), ctx)
    return _ZeroGrads.apply(loss, *dead) if dead else loss


def _xent(logits: torch.Tensor, labels: torch.Tensor,
          ctx: ShardCtx) -> torch.Tensor:
    """The mean cross entropy of every token (this rank's share on a
    mesh)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    if ctx.mesh is None or ctx.mesh.size == 1:
        return (logz - gold).mean()
    shards = ctx.mesh.axis_size(ctx.batch_axes) * ctx.seq_size
    return (logz - gold).sum() / (labels.numel() * shards)


def _xent_scored(logits: torch.Tensor, labels: torch.Tensor,
                 ctx: ShardCtx) -> torch.Tensor:
    """The mean cross entropy of the tokens whose label is not negative,
    over their count on the whole mesh (this rank's share on a mesh)."""
    valid = labels >= 0
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    count = valid.sum().float()
    if ctx.mesh is not None and ctx.mesh.size > 1:
        count = ctx.mesh.all_reduce(count, ctx.mesh.axis_names)
    return torch.where(valid, logz - gold, 0.0).sum() / count


def _loss_vocab_parallel(params: dict, batch: dict, cfg: LMConfig,
                         remat: bool, ctx: ShardCtx,
                         memory: torch.Tensor | None) -> torch.Tensor:
    """The reference's `_loss_vocab_parallel`: the ring lookup (scaled by
    sqrt(d) where the config says), the patch prefix before it (its
    labels -1), the layers, the final norm, and the ring cross entropy
    against `unembed`'s block transposed, or the tied `embed` block."""
    # the vocabulary blocks' gradients arrive summed over every axis: the
    # backward of their gathers at use cuts this rank's block out
    with shardings.AtUse(ctx.mesh) as use:
        x = VP.embed_lookup(_at_use(use, params, ctx, "embed",
                                    summed=True)["embed"], cfg,
                            batch["tokens"], ctx)
    if cfg.scale_embedding:
        x = x * math.sqrt(cfg.d_model)
    labels = batch["labels"]
    extra = batch.get("patch_embeds")
    if extra is not None:
        x = torch.cat([extra.to(x.dtype), x], dim=1)
        labels = _front_pad(labels, x.shape[1])
    x = _layers(params, cfg, x, remat, None, ctx, memory)
    with shardings.AtUse(ctx.mesh) as use:
        held = _at_use(use, params, ctx, "unembed" if "unembed" in params
                       else "embed", summed=True)
        table = held["unembed"].T if "unembed" in params else held["embed"]
        return VP.xent_loss(table, cfg, x, labels, ctx)


# ---------------------------------------------------------------------------
# serving: prefill / decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(params: dict, cfg: LMConfig, tokens: torch.Tensor,
            ctx: ShardCtx = ShardCtx(),
            extra_embeds: torch.Tensor | None = None,
            frames: torch.Tensor | None = None):
    """Run the whole prompt (B, S) (after `extra_embeds`' prefix, if any;
    an encoder-decoder's `frames` through the encoder first) through the
    forward (the attention and SSD-chunk kernels on the card) and return
    (the last position's logits (B, 1, V), each layer's (k, v) (B, S,
    Hkv, hd), None for an SSM layer, the encoder's memory or None), the
    reference's three values.  `tree_to_jax({"layers": kv},
    cfg)["segments"]` is the reference's per-segment stacked layout
    (count, B, S, Hkv, hd).

    Under a `ctx` that splits the sequence, `tokens` (and the prefix and
    the frames) are this rank's blocks (B over the batch axes, S over the
    sequence axis), and so are each layer's (k, v) and the memory, as the
    reference's `P(ba, "model")` caches; the last position's logits come
    from the last shard of the sequence axis, on every rank of it (a sum
    over the axis in which the others add zeros)."""
    logits, kv, memory = forward(params, cfg, tokens, collect_kv=True,
                                 ctx=ctx, extra_embeds=extra_embeds,
                                 frames=frames)
    last = logits[:, -1:]
    if ctx.sharded:
        mine = ctx.seq_index == ctx.seq_size - 1
        last = ctx.mesh.all_reduce(last if mine else torch.zeros_like(last),
                                   ctx.seq_axis)
    return last, kv, memory


def init_decode_state(cfg: LMConfig, batch: int, max_len: int, *,
                      device: torch.device | str,
                      dtype: torch.dtype = torch.float32) -> list[dict]:
    """Empty decode state, one dict a layer: `k` / `v` (batch, max_len,
    Hkv, hd) for attention (`xattn`'s self-attention too) and hybrid
    blocks; `ssm` (batch, H, P, N) and `conv` (batch, ssm_conv - 1,
    d_inner + 2 N) for SSM and hybrid blocks.  `k`, `v` and `conv` are in
    `dtype`, `ssm` in fp32, as the reference's.  Under a sequence split,
    `batch` and `max_len` are this rank's block of them.  (The reference
    stacks them per segment; its server asks for fp32, its dry run for
    bf16.)"""
    state = []
    for bt in cfg.layer_types():
        entry = {}
        if bt in ("attn", "swa", "xattn") or bt.startswith("hybrid"):
            entry["k"] = torch.zeros(
                (batch, max_len, cfg.n_kv_heads, cfg.head_dim),
                dtype=dtype, device=device)
            entry["v"] = torch.zeros_like(entry["k"])
        if bt == "ssm" or bt.startswith("hybrid"):
            entry["ssm"] = torch.zeros(
                (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                dtype=torch.float32, device=device)
            entry["conv"] = torch.zeros(
                (batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                dtype=dtype, device=device)
        state.append(entry)
    return state


@torch.no_grad()
def decode_step(params: dict, cfg: LMConfig, tokens: torch.Tensor,
                caches: list[dict], length: int,
                ctx: ShardCtx = ShardCtx(),
                memory: torch.Tensor | None = None):
    """One decode step.  tokens: (B, 1), this rank's block of the batch;
    caches: `init_decode_state`'s (this rank's blocks under `ctx`);
    length: the filled length, so the token's position; memory: an
    encoder-decoder's `encode` output (this rank's block under `ctx`),
    which its `xattn` layers attend to (without it they skip their
    cross-attention, as the reference's do).  The K/V caches are written
    in place; the SSM entries are replaced; each keeps its dtype (`ssm`
    fp32, the others the params').  Returns (logits (B, 1, V), caches).

    With `ctx.rest` (the params at rest, as `forward` takes them), the
    embedding, each layer's blocks (an `xattn` layer's cross-attention
    with them), the final norm and the unembedding are gathered at their
    use, one layer at a time (`_layer_at_use`; nothing is saved under
    no_grad), and so are the blocks over "model" that `ctx.model_blocks`
    names.  Without them the step is the same op for op."""
    x = _embed(params, cfg, tokens, ctx=ctx)
    positions = torch.full((tokens.shape[0], 1), length, dtype=torch.long,
                           device=x.device)
    scale = cfg.attn_scale or 1.0 / math.sqrt(max(cfg.head_dim, 1))
    rest = _rest(ctx, "layers")
    for i, (lp, bt, cache) in enumerate(zip(params["layers"],
                                            cfg.layer_types(), caches)):
        lp = _layer_at_use(lp, None if rest is None else rest[i], ctx)
        x = _decode_block(lp, x, bt, cfg, ctx, positions, length, cache,
                          scale, memory)
    with shardings.AtUse(ctx.mesh) as use:
        x = M.norm_apply(cfg, _at_use(use, params, ctx,
                                      "final_norm")["final_norm"], x)
    return _logits(params, cfg, x, ctx), caches


def _decode_block(p: dict, x: torch.Tensor, btype: str, cfg: LMConfig,
                  ctx: ShardCtx, positions: torch.Tensor, length: int,
                  cache: dict, scale: float,
                  memory: torch.Tensor | None = None) -> torch.Tensor:
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

    def cross(x):
        # the reference's cross query is not roped here (its forward's is)
        hc = M.norm_apply(cfg, p["ln_cross"], x)
        mk, mv = _cross_kv(p["cross"], cfg, memory)
        b = hc.shape[0]
        qc = hc @ p["cross"]["wq"]
        if cfg.qkv_bias:
            qc = qc + p["cross"]["bq"]
        qc = qc.reshape(b, 1, cfg.n_heads, cfg.head_dim)
        oc = decode_attention(qc, mk, mv, memory.shape[1] * ctx.seq_size,
                              mesh=ctx.mesh, seq_axis=ctx.seq_axis,
                              scale=scale)
        return x + oc.reshape(b, 1, cfg.n_heads * cfg.head_dim) \
            @ p["cross"]["wo"]

    if btype == "ssm":
        out = recur(h)
    elif btype.startswith("hybrid"):
        out = 0.5 * (M.norm_apply(cfg, p["fuse_attn"], attend(h))
                     + M.norm_apply(cfg, p["fuse_ssm"], recur(h)))
    elif btype in ("attn", "swa", "xattn"):
        out = attend(h)
    else:
        raise ValueError(f"block type {btype!r} has no decode step")
    # the step's one token a row is not split over the sequence: the MoE
    # routes it alone (a group of 1, capacity 1, nothing dropped)
    return _block_tail(p, x, out, btype, cfg,
                       cross=cross if btype == "xattn" and memory is not None
                       else None)
