"""Sharding rules of the training state, port of `repro.launch.shardings`.

The reference's baseline (the paper's hybrid sample x spatial plan plus
FSDP memory sharding): every parameter leaf of at least 2^14 elements is
sharded over "data" along its largest dim that the data axis divides,
replicated over "model"; smaller leaves replicate; the optimizer state
inherits the params' sharding (ZeRO).

A spec is a plain tuple, as `core.distribution.Dist.spec` is: the mesh
axis of each dim of the leaf, None where the dim is whole, and () for a
replicated leaf (the reference's `PartitionSpec` as a tuple).

The port keeps every param whole on every rank and shards what the
update touches: this rank's block of each sharded leaf (`shard`, a view)
takes the update, its optimizer moments and its error-feedback residual
exist for that block only, and the updated blocks are gathered over
"data" once a step (`gather_params_`).  A checkpoint holds global arrays:
`unshard` gathers a block back, `shard` cuts one from a global array, and
`sharded_state_tree` / `load_sharded_state_tree` do so for the whole
training state around `optim.optimizer`'s mesh-free `state_tree` /
`load_state_tree`.

Serving: `kv_cache_specs` gives the decode state's specs (the KV cache
split along S over the sequence axes, B over the batch axes where the
batch is split, the SSM state and conv buffers whole in S), and
`cache_blocks` / `gather_caches` cut each rank's block of a global cache
and gather it back.

The vocab-parallel loss (`transformer.loss_fn(vocab_parallel=True)`):
`vocab_blocks` cuts each rank's block of the vocabulary over "model" from
whole params (`embed`'s rows, `unembed`'s columns, padded to the shard
count with zeros, as the reference pads), and `gather_vocab` gathers
such blocks (params or their gradients) back whole.

Expert parallelism (`ShardCtx(tp_axis="model")`): `expert_blocks` cuts
each rank's block of every MoE layer's experts over "model" (`wi`, `wg`,
`wo` along E, as the reference's dry-run `ep_spec` places them; the
router stays whole), and `gather_experts` gathers them back.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.core import trace
from repro_torch.launch.mesh import MODEL_AXIS, Mesh, batch_axes
from repro_torch.optim import optimizer
from repro_torch.utils import tree_leaves, tree_map

MIN_SHARDED = 2 ** 14     # leaves below this many elements replicate

Spec = tuple


def _shape_map(mesh) -> dict[str, int]:
    if mesh is None:
        return {}
    return dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)


def fsdp_spec(shape: Sequence[int], n_data: int) -> Spec:
    """The reference's rule for one leaf of `shape` on a data axis of
    `n_data` (None: the mesh has no data axis): () for a leaf with no
    shape or under 2^14 elements, else "data" on the largest dim that
    `n_data` divides (ties to the lower dim: a stable sort), else ()."""
    shape = tuple(int(s) for s in shape)
    size = 1
    for s in shape:
        size *= s
    if not shape or size < MIN_SHARDED or n_data is None:
        return ()
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % n_data == 0 and shape[d] >= n_data:
            s: list = [None] * len(shape)
            s[d] = "data"
            return tuple(s)
    return ()


def fsdp_tree_specs(tree: Any, mesh) -> Any:
    """A spec for every leaf of `tree` (tensors or arrays: anything with a
    `.shape`) on `mesh` (a `Mesh`, or a dict of axis sizes: only its
    shape is read), in the tree's structure.  Weights stay replicated
    over "model", as the paper replicates them within a spatial group."""
    shape = _shape_map(mesh)
    n_data = shape.get("data") if "data" in shape else None
    return tree_map(lambda x: fsdp_spec(tuple(x.shape), n_data), tree)


def sharded_dim(spec: Spec) -> int | None:
    """The dim that `spec` shards over "data", None for a whole leaf."""
    return spec.index("data") if "data" in spec else None


def zero_specs(leaves: Sequence, mesh: Mesh | None) -> list[Spec]:
    """The spec of each leaf as the step holds it: `fsdp_tree_specs`'s
    where the mesh's data axis has more than one rank, else () for every
    leaf (one data rank holds every leaf whole)."""
    if mesh is None or mesh.shape.get("data", 1) == 1:
        return [() for _ in leaves]
    return list(fsdp_tree_specs(list(leaves), mesh))


def shard(x: torch.Tensor, spec: Spec, mesh: Mesh | None) -> torch.Tensor:
    """This rank's block of the global `x` under `spec`: a view (`narrow`)
    along the sharded dim, `x` itself where the leaf is whole."""
    d = sharded_dim(spec)
    if d is None or mesh is None:
        return x
    n = x.shape[d] // mesh.shape["data"]
    return x.narrow(d, mesh.index("data") * n, n)


def unshard(block: torch.Tensor, spec: Spec, mesh: Mesh | None
            ) -> torch.Tensor:
    """The global leaf of this rank's `block` (every data rank takes
    part): all-gathered over "data" along the sharded dim."""
    d = sharded_dim(spec)
    if d is None or mesh is None:
        return block
    return mesh.all_gather(block.contiguous(), "data", d)


def local_shards(params: Any, mesh: Mesh | None) -> list[torch.Tensor]:
    """This rank's block of every param leaf (views, in `tree_leaves`
    order): what the optimizer updates and keeps moments for."""
    leaves = tree_leaves(params)
    return [shard(p, s, mesh) for p, s in zip(leaves,
                                             zero_specs(leaves, mesh))]


def state_bytes(params: Any, mesh: Mesh | None) -> tuple[int, int]:
    """(bytes of this rank's blocks of the sharded leaves, bytes of the
    replicated leaves): a moment's footprint on this rank."""
    leaves = tree_leaves(params)
    out = [0, 0]
    for p, s in zip(leaves, zero_specs(leaves, mesh)):
        b = shard(p, s, mesh)
        out[0 if s else 1] += b.numel() * b.element_size()
    return out[0], out[1]


def pack_rows(leaves: Sequence[torch.Tensor], specs: Sequence[Spec], k: int
              ) -> torch.Tensor:
    """The sharded leaves as one flat fp32 buffer whose k per-rank blocks
    are contiguous: row r holds every leaf's block r (its sharded dim
    moved first, flattened), leaf after leaf."""
    return torch.cat([t.float().movedim(sharded_dim(s), 0).reshape(k, -1)
                      for t, s in zip(leaves, specs)], dim=1).reshape(-1)


def unpack(flat: torch.Tensor, like: torch.Tensor, spec: Spec
           ) -> torch.Tensor:
    """`flat`, a tensor of `like`'s shape flattened with the sharded dim
    moved first (as `pack_rows` lays each block out), in `like`'s shape."""
    d = sharded_dim(spec)
    return flat.reshape(like.movedim(d, 0).shape).movedim(0, d)


@torch.no_grad()
def gather_params_(params: Any, mesh: Mesh | None) -> None:
    """Every sharded param whole again on every rank, in place: the
    updated blocks of all sharded leaves go as one flat buffer through one
    all-gather over "data" (the named region `param_gather`)."""
    if mesh is None or mesh.shape.get("data", 1) == 1:
        return
    leaves = tree_leaves(params)
    specs = zero_specs(leaves, mesh)
    big = [(p, s) for p, s in zip(leaves, specs) if s]
    if not big:
        return
    blocks = [shard(p, s, mesh) for p, s in big]
    flat = pack_rows(blocks, [s for _, s in big], 1)
    with trace.annotate("param_gather", flat, bwd=True):
        rows = mesh.all_gather(flat[None], "data", 0)        # (k, S)
    i = 0
    for b, (p, s) in zip(blocks, big):
        n = b.numel()
        p.copy_(unpack(rows[:, i:i + n].reshape(-1), p, s).to(p.dtype))
        i += n


def sharded_state_tree(params: Any, state, ef: list | None,
                       mesh: Mesh | None, to_ref=None) -> tuple:
    """`optim.optimizer.state_tree` of this rank's training state with
    every array global, so every rank of the mesh takes part (only the
    writer writes): the moments of a sharded leaf gathered over "data";
    `ef`, this pod's int8 residual of each of this rank's blocks, as the
    reference's `(npods,) + leaf.shape` array per leaf, gathered over
    "data" and "pod"."""
    specs = zero_specs(tree_leaves(params), mesh)

    def whole(flat):
        return [unshard(t, s, mesh) for t, s in zip(flat, specs)]

    def pods(e, s):
        e = unshard(e, s, mesh)[None]
        if mesh is None or "pod" not in mesh.axis_names:
            return e
        return mesh.all_gather(e.contiguous(), "pod", 0)
    state = state._replace(mu=whole(state.mu),
                           nu=None if state.nu is None else whole(state.nu))
    return optimizer.state_tree(
        params, state, to_ref,
        ef=None if ef is None else [pods(e, s) for e, s in zip(ef, specs)])


@torch.no_grad()
def load_sharded_state_tree(tree: tuple, params: Any, state,
                            ef: list | None, mesh: Mesh | None,
                            from_ref=None):
    """`optim.optimizer.load_state_tree` onto this rank's training state:
    the global moments and residuals cut to this rank's blocks on `mesh`
    (its pod's row of a residual), so a checkpoint restores onto any
    mesh; in place, as there.  Returns the state with the restored
    step."""
    leaves = tree_leaves(params)
    specs = zero_specs(leaves, mesh)

    def whole(live):         # a whole leaf's moment is written in place
        return [t if not s else t.new_empty(p.shape)
                for t, p, s in zip(live, leaves, specs)]
    glob = state._replace(mu=whole(state.mu),
                          nu=None if state.nu is None else whole(state.nu))
    npods = mesh.shape.get("pod", 1) if mesh is not None else 1
    glob_ef = None if ef is None else \
        [e.new_empty((npods,) + tuple(p.shape)) for e, p in zip(ef, leaves)]
    step = optimizer.load_state_tree(tree, params, glob, from_ref,
                                     ef=glob_ef).step
    moments = [(state.mu, glob.mu)] + ([] if state.nu is None else
                                       [(state.nu, glob.nu)])
    for live, whole_ in moments:
        for dst, src, s in zip(live, whole_, specs):
            if s:
                dst.copy_(shard(src, s, mesh))
    if ef is not None:
        pod = mesh.coords["pod"] if mesh is not None and \
            "pod" in mesh.axis_names else 0
        for dst, src, s in zip(ef, glob_ef, specs):
            dst.copy_(shard(src[pod], s, mesh))
    return state._replace(step=step)


# ------------------------------------------------------------- serving --

# the rank of each decode-state entry of one layer (more: stacked layers)
_CACHE_RANK = {"k": 4, "v": 4, "ssm": 4, "conv": 3}


def _map_entries(fn, tree: Any, *more: Any) -> Any:
    """`fn(name, leaf, *leaves of more)` for every decode-state entry of
    `tree` (dict entries named in _CACHE_RANK), the structure kept."""
    if isinstance(tree, dict):
        return {k: fn(k, v, *(m[k] for m in more)) if k in _CACHE_RANK
                else _map_entries(fn, v, *(m[k] for m in more))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_entries(fn, t, *(m[i] for m in more))
                          for i, t in enumerate(tree))
    raise TypeError(f"not a decode-state tree: {type(tree).__name__}")


def kv_cache_specs(caches: Any, mesh, batch_sharded: bool, seq_axes
                   ) -> Any:
    """The reference's cache specs: k / v (B, S, Hkv, hd) split B over the
    mesh's batch axes (where `batch_sharded`) and S over `seq_axes`; the
    SSM state (B, H, P, N) and conv buffer (B, k-1, C) split B only (they
    are small).  `caches` is `transformer.init_decode_state`'s per-layer
    list or the reference's per-segment stacks: each leading stacked dim
    gets None."""
    ba = batch_axes(mesh) if batch_sharded else None

    def spec(name, x):
        lead = (None,) * (len(x.shape) - _CACHE_RANK[name])
        if name in ("k", "v"):
            return lead + (ba, seq_axes, None, None)
        return lead + (ba,) + (None,) * (_CACHE_RANK[name] - 1)
    return _map_entries(spec, caches)


def _dims(spec: Spec):
    return [(d, a) for d, a in enumerate(spec) if a is not None]


def cache_blocks(caches: Any, specs: Any, mesh: Mesh | None) -> Any:
    """This rank's block of every entry of the global `caches` under
    `specs` (`kv_cache_specs`'s), each a new contiguous tensor: what the
    rank decodes against."""
    def block(name, x, spec):
        for d, axes in _dims(spec):
            n = x.shape[d] // mesh.axis_size(axes)
            x = x.narrow(d, mesh.index(axes) * n, n)
        return x.clone(memory_format=torch.contiguous_format)
    return caches if mesh is None else _map_entries(block, caches, specs)


def gather_caches(blocks: Any, specs: Any, mesh: Mesh | None) -> Any:
    """The global caches from every rank's `blocks` (every rank of the
    mesh takes part and gets them whole): `cache_blocks`' inverse."""
    def whole(name, x, spec):
        for d, axes in reversed(_dims(spec)):
            x = mesh.all_gather(x.contiguous(), axes, d)
        return x
    return blocks if mesh is None else _map_entries(whole, blocks, specs)


# --------------------------------------------------- the vocabulary blocks --

VOCAB_DIMS = {"embed": 0, "unembed": 1}     # the vocabulary's dim


def vocab_padded(vocab: int, n: int) -> int:
    """The vocabulary padded to a multiple of `n` shards (the reference's
    `vocab_parallel` rule: n - vocab % n zero rows where n does not
    divide it)."""
    return vocab + (n - vocab % n) % n


def vocab_blocks(params: dict, mesh: Mesh | None) -> dict:
    """`params` with `embed` (V, d) and `unembed` (d, V) replaced by this
    rank's block of the vocabulary over "model": V padded with zeros to
    `vocab_padded`, then cut into equal blocks in shard order.  Each
    block is a new contiguous leaf that requires grad; the other leaves
    are `params`' own."""
    n = 1 if mesh is None else mesh.axis_size(MODEL_AXIS)
    i = 0 if mesh is None else mesh.index(MODEL_AXIS)
    out = dict(params)
    for name, dim in VOCAB_DIMS.items():
        if name in params:
            t = params[name].detach()
            pad = vocab_padded(t.shape[dim], n) - t.shape[dim]
            if pad:
                shape = list(t.shape)
                shape[dim] = pad
                t = torch.cat([t, t.new_zeros(shape)], dim)
            m = t.shape[dim] // n
            out[name] = t.narrow(dim, i * m, m).clone(
                memory_format=torch.contiguous_format).requires_grad_()
    return out


def gather_vocab(tree: dict, mesh: Mesh | None, vocab: int) -> dict:
    """`vocab_blocks`' inverse on `tree` (params, or their gradients):
    `embed` / `unembed` gathered whole over "model" and cut back to
    `vocab` (every rank of the axis takes part and gets them whole); the
    other leaves as they are."""
    out = dict(tree)
    for name, dim in VOCAB_DIMS.items():
        if name in tree:
            t = tree[name].detach()
            if mesh is not None:
                t = mesh.all_gather(t.contiguous(), MODEL_AXIS, dim)
            out[name] = t.narrow(dim, 0, vocab)
    return out


# ------------------------------------------------------ the expert blocks --

EXPERT_LEAVES = ("wi", "wg", "wo")          # (E, ...) each


def expert_blocks(params: dict, mesh: Mesh | None) -> dict:
    """`params` with each layer's MoE `wi`, `wg`, `wo` replaced by this
    rank's block of E over "model" (E / n experts, in shard order; n must
    divide E).  Each block is a new contiguous leaf that requires grad;
    the other leaves are `params`' own."""
    n = 1 if mesh is None else mesh.axis_size(MODEL_AXIS)
    i = 0 if mesh is None else mesh.index(MODEL_AXIS)
    layers = []
    for lp in params["layers"]:
        if "moe" in lp:
            moe = dict(lp["moe"])
            for name in EXPERT_LEAVES:
                t = moe[name].detach()
                if t.shape[0] % n:
                    raise ValueError(f"{t.shape[0]} experts do not divide "
                                     f"over {n} model shards")
                m = t.shape[0] // n
                moe[name] = t[i * m:(i + 1) * m].clone().requires_grad_()
            lp = {**lp, "moe": moe}
        layers.append(lp)
    return {**params, "layers": layers}


def gather_experts(tree: dict, mesh: Mesh | None) -> dict:
    """`expert_blocks`' inverse on `tree` (params, or their gradients):
    each MoE layer's expert leaves gathered whole over "model" (every
    rank of the axis takes part and gets them whole); the other leaves as
    they are."""
    layers = []
    for lp in tree["layers"]:
        if "moe" in lp:
            moe = dict(lp["moe"])
            for name in EXPERT_LEAVES:
                t = moe[name].detach()
                moe[name] = t if mesh is None else \
                    mesh.all_gather(t.contiguous(), MODEL_AXIS, 0)
            lp = {**lp, "moe": moe}
        layers.append(lp)
    return {**tree, "layers": layers}
