"""Sharding rules of the training state, port of `repro.launch.shardings`.

The reference's baseline (the paper's hybrid sample x spatial plan plus
FSDP memory sharding): every parameter leaf of at least 2^14 elements is
sharded over "data" along its largest dim that the data axis divides,
replicated over "model"; smaller leaves replicate; the optimizer state
inherits the params' sharding (ZeRO).

A spec is a plain tuple, as `core.distribution.Dist.spec` is: the mesh
axis of each dim of the leaf, None where the dim is whole, and () for a
replicated leaf (the reference's `PartitionSpec` as a tuple).

Params at rest (the reference's FSDP placement): every rank holds only
its block of each leaf that `fsdp_tree_specs` cuts (`rest_dims`, the
dim cut over "data" or None; `param_blocks` cuts them from whole
params).  The models gather a layer's blocks where they use them
(`gather_at_use`, one all-gather over "data" of the layer's blocks,
whose backward reduce-scatters their gradients over "data"), and
`AtUse` keeps an op's saved copy of a gathered leaf as its block,
gathered again in the backward.  So the step's gradients arrive as
blocks already summed over "data" (`reduce_axes`), the optimizer
updates the blocks in place, and its moments and error-feedback
residuals exist for the blocks only.  A checkpoint holds global arrays:
`unshard` gathers a block back, `shard` cuts one from a global array,
and `sharded_state_tree` / `load_sharded_state_tree` do so for the whole
training state around `optim.optimizer`'s mesh-free `state_tree` /
`load_state_tree`.

ZeRO-1 over all chips (the reference's opt / vpz variants of the dry
run): `zero1_tree_specs` puts each optimizer-state leaf of at least 2^14
elements over ("data", "model") on its largest dim that the product
divides, else over "data"; `zero_specs(axes=("data", "model"))` cuts
the step's state so (a tuple entry of a spec is a product axis; a block
at rest keeps the cut over "model" of that spec, and `gather_cuts_`
all-gathers its updated pieces over "model" after the update), and
`leaf_roles` says which leaves are a rank's block over "model" (the
vocabulary's, the experts'): their state is cut over "data" within the
block, and their gradient arrives summed over the axes `reduce_axes`
leaves out.  `lm_batch_spec` is the reference's batch placement.

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

import weakref
from typing import Any, Sequence

import torch

from repro_torch.core import trace
from repro_torch.launch.mesh import MODEL_AXIS, Mesh, axes_tuple, batch_axes
from repro_torch.optim import optimizer
from repro_torch.utils import (leaves_with_path, tree_leaves, tree_map,
                               tree_unflatten)

MIN_SHARDED = 2 ** 14     # leaves below this many elements replicate
DATA_AXIS = "data"
AT_USE = "fsdp_gather"    # the named region of the gathers at use

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


def zero1_spec(shape: Sequence[int], mesh_shape: dict[str, int],
               axes=("data", "model")) -> Spec:
    """The reference's ZeRO-1 rule for one optimizer-state leaf of
    `shape`: () under 2^14 elements; else the tuple of `axes` on the mesh
    (one product axis of n shards) on the largest dim that n divides;
    else "data" on the largest dim that the data axis divides; else ()."""
    shape = tuple(int(s) for s in shape)
    size = 1
    for s in shape:
        size *= s
    if not shape or size < MIN_SHARDED:
        return ()
    ax = _entry(tuple(a for a in axes if a in mesh_shape))
    n = 1
    for a in axes_tuple(ax):
        n *= mesh_shape[a]
    n_data = mesh_shape.get("data", 1)
    for want, entry in ((n, ax), (n_data, "data")):
        for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if shape[d] % want == 0 and shape[d] >= want:
                s: list = [None] * len(shape)
                s[d] = entry
                return tuple(s)
    return ()


def _entry(axes: tuple):
    """A spec entry of `axes`: one axis by its name (as a PartitionSpec
    holds it), several as their tuple."""
    return axes[0] if len(axes) == 1 else axes


def zero1_tree_specs(tree: Any, mesh, axes=("data", "model")) -> Any:
    """The reference's optimizer-state sharding over both axes (ZeRO-1
    over all chips): `zero1_spec` for every leaf of `tree` (anything
    with a `.shape`) on `mesh` (a `Mesh` or a dict of axis sizes)."""
    shape = _shape_map(mesh)
    return tree_map(lambda x: zero1_spec(tuple(x.shape), shape, axes), tree)


def lm_batch_spec(mesh, kind: str) -> dict[str, Spec]:
    """The reference's LM batch specs: tokens (and labels) B over the
    batch axes, S over "model" (train, prefill); a decode step's one
    token a row B only."""
    shape = _shape_map(mesh)
    ba = _entry(tuple(a for a in ("pod", "data") if a in shape))
    if kind == "train":
        return {"tokens": (ba, "model"), "labels": (ba, "model")}
    if kind == "prefill":
        return {"tokens": (ba, "model")}
    if kind == "decode":
        return {"tokens": (ba, None)}
    raise ValueError(kind)


def sharded_dim(spec: Spec) -> int | None:
    """The dim that `spec` shards (its one entry that is not None), None
    for a whole leaf."""
    for d, a in enumerate(spec):
        if a is not None:
            return d
    return None


def spec_axes(spec: Spec) -> tuple[str, ...]:
    """The mesh axes that `spec` shards its dim over, () for a whole
    leaf."""
    d = sharded_dim(spec)
    return () if d is None else axes_tuple(spec[d])


# what a param leaf is as the model reads it: the global leaf ("whole"),
# or this rank's block over "model" of the vocabulary (`vocab_blocks`:
# its gradient arrives whole, summed over every axis) or of a MoE layer's
# experts (`expert_blocks`: summed over "model" by the all-to-alls)
_SUMMED = {"whole": (), "vocab": None, "expert": (MODEL_AXIS,)}
# a leaf held at rest as its block over "data" (`rest_dims`): the
# backward of its gather at use has summed its gradient over "data"
_SUMMED_AT_REST = (DATA_AXIS,)


def leaf_roles(params: Any, *, vocab: bool = False, experts: bool = False
               ) -> list[str]:
    """The role of each leaf of an LM's `params` (`tree_leaves` order):
    `embed` / `unembed` "vocab" with `vocab`, each MoE layer's `wi`,
    `wg`, `wo` "expert" with `experts`, else "whole"."""
    def role(path: str) -> str:
        if vocab and path in ("['embed']", "['unembed']"):
            return "vocab"
        if experts and any(path.endswith(f"['moe']['{n}']")
                           for n in EXPERT_LEAVES):
            return "expert"
        return "whole"
    return [role(p) for p, _ in leaves_with_path(params)]


def reduce_axes(role: str, mesh: Mesh, rest: int | None = None
                ) -> tuple[str, ...]:
    """The axes over which a leaf of `role`'s gradient still has to be
    summed on `mesh`; `rest`, the dim the leaf is cut along at rest (None:
    held as the model reads it)."""
    done = _SUMMED[role]
    if done is None:
        return ()
    if rest is not None:
        done = done + _SUMMED_AT_REST
    return tuple(a for a in mesh.axis_names if a not in done)


def block_axes(role: str, rest: int | None = None) -> tuple[str, ...]:
    """The axes over which the held param is cut into blocks of the
    global leaf: "model" for a block of `role`, "data" at rest."""
    return (() if role == "whole" else (MODEL_AXIS,)) + \
        (() if rest is None else (DATA_AXIS,))


def rest_list(rest, n: int) -> list:
    """`rest` (a tree or list of `rest_dims`' entries, or None) as a
    list of n entries."""
    return [None] * n if rest is None else tree_leaves(rest)


def zero_specs(leaves: Sequence, mesh: Mesh | None, axes=("data",),
               roles: Sequence[str] | None = None, rest=None) -> list[Spec]:
    """The spec of each held leaf's optimizer state as the step holds it,
    relative to the held leaf.  A leaf held as the model reads it (`rest`
    None, or its entry None): with `axes` ("data",), `fsdp_tree_specs`'s;
    with ("data", "model") (ZeRO-1 over all chips), `zero1_spec`'s for a
    whole leaf and `fsdp_spec`'s for a block over "model" (its state is
    cut within the block).  A block at rest (`rest_dims`' dim): () with
    `axes` ("data",) or for a block over "model" (the state is the held
    block), and for a whole leaf under ZeRO-1 its global `zero1_spec` with
    "data" taken out (a cut over "model" within the data block).  A spec
    over axes of one rank is () (one data rank holds every leaf
    whole)."""
    if mesh is None:
        return [() for _ in leaves]
    shape = dict(mesh.shape)
    roles = roles or ["whole"] * len(leaves)
    zero1 = tuple(axes) != ("data",)
    out = []
    for x, role, d in zip(leaves, roles, rest_list(rest, len(leaves))):
        if d is not None:
            spec = ()
            if role == "whole" and zero1:
                glob = list(x.shape)
                glob[d] *= shape[DATA_AXIS]
                spec = zero1_spec(glob, shape, axes)
                c = sharded_dim(spec)
                left = () if c is None else tuple(
                    a for a in axes_tuple(spec[c]) if a != DATA_AXIS)
                spec = () if not left else \
                    spec[:c] + (_entry(left),) + spec[c + 1:]
        elif role == "whole" and zero1:
            spec = zero1_spec(tuple(x.shape), shape, axes)
        else:
            spec = fsdp_spec(tuple(x.shape), shape.get("data")
                             if "data" in shape else None)
        if spec and mesh.axis_size(spec_axes(spec)) == 1:
            spec = ()
        out.append(spec)
    return out


def shard(x: torch.Tensor, spec: Spec, mesh: Mesh | None) -> torch.Tensor:
    """This rank's block of the global `x` under `spec`: a view (`narrow`)
    along the sharded dim, `x` itself where the leaf is whole."""
    d = sharded_dim(spec)
    if d is None or mesh is None:
        return x
    axes = spec_axes(spec)
    n = x.shape[d] // mesh.axis_size(axes)
    return x.narrow(d, mesh.index(axes) * n, n)


def unshard(block: torch.Tensor, spec: Spec, mesh: Mesh | None
            ) -> torch.Tensor:
    """The global leaf of this rank's `block` (every rank of the spec's
    axes takes part): all-gathered along the sharded dim."""
    d = sharded_dim(spec)
    if d is None or mesh is None:
        return block
    return mesh.all_gather(block.contiguous(), spec_axes(spec), d)


def local_shards(params: Any, mesh: Mesh | None, axes=("data",),
                 roles: Sequence[str] | None = None, rest=None
                 ) -> list[torch.Tensor]:
    """This rank's block of every held param leaf (views, in
    `tree_leaves` order) under `zero_specs(axes, roles, rest)`: what the
    optimizer updates and keeps moments for."""
    leaves = tree_leaves(params)
    return [shard(p, s, mesh) for p, s in
            zip(leaves, zero_specs(leaves, mesh, axes, roles, rest))]


def state_bytes(params: Any, mesh: Mesh | None, rest=None
                ) -> tuple[int, int]:
    """(bytes of this rank's blocks of the sharded leaves, bytes of the
    replicated leaves): a moment's footprint on this rank.  With `rest`
    the held params are blocks at rest, and a moment is the held block."""
    leaves = tree_leaves(params)
    out = [0, 0]
    for p, s, d in zip(leaves, zero_specs(leaves, mesh, rest=rest),
                       rest_list(rest, len(leaves))):
        b = shard(p, s, mesh)
        out[0 if s or d is not None else 1] += b.numel() * b.element_size()
    return out[0], out[1]


def held_bytes(params: Any) -> int:
    """The bytes of the params as this rank holds them (at rest: its
    blocks)."""
    return sum(p.numel() * p.element_size() for p in tree_leaves(params))


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
def gather_cuts_(params: Any, mesh: Mesh | None, axes=("data",),
                 roles: Sequence[str] | None = None, rest=None) -> None:
    """Every held param leaf whose optimizer state is cut within it
    (`zero_specs(axes, roles, rest)`) rebuilt on every rank, in place,
    from the updated pieces of its state's blocks: the leaves cut over
    the same axes go as one flat buffer through one all-gather over them
    (the named region `param_gather`).  With the params at rest that is
    ZeRO-1's cut over "model" of a data block, and nothing under ZeRO over
    "data" (the state is the held block)."""
    if mesh is None or mesh.size == 1:
        return
    leaves = tree_leaves(params)
    specs = zero_specs(leaves, mesh, axes, roles, rest)
    groups: dict[tuple, list] = {}
    for p, s in zip(leaves, specs):
        if s:
            groups.setdefault(spec_axes(s), []).append((p, s))
    for over, big in groups.items():
        blocks = [shard(p, s, mesh) for p, s in big]
        flat = pack_rows(blocks, [s for _, s in big], 1)
        with trace.annotate("param_gather", flat, bwd=True):
            rows = mesh.all_gather(flat[None], over, 0)      # (k, S)
        i = 0
        for b, (p, s) in zip(blocks, big):
            n = b.numel()
            p.copy_(unpack(rows[:, i:i + n].reshape(-1), p, s).to(p.dtype))
            i += n


def _whole(t: torch.Tensor, cut: Spec, d: int | None, mesh: Mesh | None
           ) -> torch.Tensor:
    """The global leaf of a held piece `t` of a state leaf: gathered over
    its cut within the held leaf (`cut`), then over "data" along the dim
    `d` the held leaf is cut along at rest."""
    t = unshard(t, cut, mesh)
    return t if d is None else unshard(t, rest_spec(t.dim(), d), mesh)


def sharded_state_tree(params: Any, state, ef: list | None,
                       mesh: Mesh | None, to_ref=None, rest=None) -> tuple:
    """`optim.optimizer.state_tree` of this rank's training state with
    every array global, so every rank of the mesh takes part (only the
    writer writes): the params held at rest (`rest`) and the moments of
    a sharded leaf gathered over "data"; `ef`, this pod's int8 residual
    of each of this rank's blocks, as the reference's `(npods,) +
    leaf.shape` array per leaf, gathered over "data" and "pod"."""
    leaves = tree_leaves(params)
    specs = zero_specs(leaves, mesh, rest=rest)
    dims = rest_list(rest, len(leaves))

    def whole(flat):
        return [_whole(t, s, d, mesh) for t, s, d in zip(flat, specs, dims)]

    def pods(e, s, d):
        e = _whole(e, s, d, mesh)[None]
        if mesh is None or "pod" not in mesh.axis_names:
            return e
        return mesh.all_gather(e.contiguous(), "pod", 0)
    if rest is not None:
        params = tree_unflatten(params, iter(
            [_whole(p.detach(), (), d, mesh) for p, d in zip(leaves, dims)]))
    state = state._replace(mu=whole(state.mu),
                           nu=None if state.nu is None else whole(state.nu))
    return optimizer.state_tree(
        params, state, to_ref,
        ef=None if ef is None else [pods(e, s, d) for e, s, d in
                                    zip(ef, specs, dims)])


@torch.no_grad()
def load_sharded_state_tree(tree: tuple, params: Any, state,
                            ef: list | None, mesh: Mesh | None,
                            from_ref=None, rest=None):
    """`optim.optimizer.load_state_tree` onto this rank's training state:
    the global params, moments and residuals cut to this rank's blocks on
    `mesh` (the params to their blocks at rest under `rest`; a residual
    to its pod's row), so a checkpoint restores onto any mesh; in place,
    as there.  Returns the state with the restored step."""
    leaves = tree_leaves(params)
    specs = zero_specs(leaves, mesh, rest=rest)
    dims = rest_list(rest, len(leaves))

    def glob_shape(p, d):
        shape = list(p.shape)
        if d is not None:
            shape[d] *= mesh.shape[DATA_AXIS]
        return tuple(shape)

    def whole(live):         # a whole leaf's moment is written in place
        return [t if not s and d is None else t.new_empty(glob_shape(p, d))
                for t, p, s, d in zip(live, leaves, specs, dims)]
    glob_params = params if rest is None else tree_unflatten(params, iter(
        [p if d is None else p.new_empty(glob_shape(p, d))
         for p, d in zip(leaves, dims)]))
    glob = state._replace(mu=whole(state.mu),
                          nu=None if state.nu is None else whole(state.nu))
    npods = mesh.shape.get("pod", 1) if mesh is not None else 1
    glob_ef = None if ef is None else \
        [e.new_empty((npods,) + glob_shape(p, d))
         for e, p, d in zip(ef, leaves, dims)]
    step = optimizer.load_state_tree(tree, glob_params, glob, from_ref,
                                     ef=glob_ef).step

    def cut(src, s, d):
        if d is not None:
            src = shard(src, rest_spec(src.dim(), d), mesh)
        return shard(src, s, mesh)
    if rest is not None:
        for dst, src, d in zip(leaves, tree_leaves(glob_params), dims):
            if d is not None:
                dst.copy_(cut(src, (), d))
    moments = [(state.mu, glob.mu)] + ([] if state.nu is None else
                                       [(state.nu, glob.nu)])
    for live, whole_ in moments:
        for dst, src, s, d in zip(live, whole_, specs, dims):
            if s or d is not None:
                dst.copy_(cut(src, s, d))
    if ef is not None:
        pod = mesh.coords["pod"] if mesh is not None and \
            "pod" in mesh.axis_names else 0
        for dst, src, s, d in zip(ef, glob_ef, specs, dims):
            dst.copy_(cut(src[pod], s, d))
    return state._replace(step=step)


# ------------------------------------------------------- params at rest --

def rest_spec(ndim: int, d: int | None) -> Spec:
    """The spec of a leaf of `ndim` dims cut along `d` over "data" (()
    for None)."""
    if d is None:
        return ()
    return (None,) * d + (DATA_AXIS,) + (None,) * (ndim - d - 1)


def rest_dims(params: Any, mesh, counts: Any = None) -> Any:
    """The reference's FSDP placement of `params` (`fsdp_tree_specs`):
    for each leaf, in the tree's structure, the dim a rank's block cuts
    over "data", or None where the leaf stays whole (under 2^14 elements,
    no dim that the data axis divides, or a data axis of one rank).  Each
    leaf is taken as the model reads it: the global leaf, or a rank's
    block over "model" of the vocabulary or the experts (`vocab_blocks`,
    `expert_blocks`), which is cut within the block.

    `counts`: a tree of `params`' structure holding, for an LM's layer
    leaf, the layer count of the reference's leaf that stacks it
    (`transformer.stack_counts`), None elsewhere.  The rule then reads
    the stacked shape (count,) + shape, as the reference's tree holds it,
    and keeps the per-layer leaf's part of the cut.  A stacked leaf cut
    along its count would have no per-layer block: that raises (no
    registered arch comes to it)."""
    shape = _shape_map(mesh)
    n = shape.get(DATA_AXIS, 1)
    leaves = tree_leaves(params)
    cs = [None] * len(leaves) if counts is None else tree_leaves(counts)
    out = []
    for x, c in zip(leaves, cs):
        stacked = tuple(x.shape) if c is None else (c,) + tuple(x.shape)
        d = sharded_dim(fsdp_spec(stacked, n)) if n > 1 else None
        if d is not None and c is not None:
            if d == 0:
                raise ValueError(
                    f"a stacked leaf {stacked} is cut over data {n} along "
                    f"its layer count; the port holds its layers apart")
            d -= 1
        out.append(d)
    return tree_unflatten(params, iter(out))


def param_blocks(params: Any, rest: Any, mesh: Mesh | None) -> Any:
    """`params` as a rank holds them at rest: each leaf that `rest` cuts
    replaced by a new contiguous leaf of this rank's block (requiring
    grad as the leaf does), the others the leaves themselves."""
    def block(x, d):
        if d is None or mesh is None:
            return x
        b = shard(x.detach(), rest_spec(x.dim(), d), mesh)
        return b.clone(memory_format=torch.contiguous_format) \
            .requires_grad_(x.requires_grad)
    leaves = tree_leaves(params)
    return tree_unflatten(params, iter(
        [block(x, d) for x, d in zip(leaves,
                                     rest_list(rest, len(leaves)))]))


@torch.no_grad()
def whole_params(params: Any, rest: Any, mesh: Mesh | None) -> Any:
    """`param_blocks`' inverse: every block gathered whole over "data"
    (every rank of the axis takes part and gets them whole)."""
    leaves = tree_leaves(params)
    return tree_unflatten(params, iter(
        [_whole(x.detach(), (), d, mesh) if d is not None else x
         for x, d in zip(leaves, rest_list(rest, len(leaves)))]))


def held_rest(tree: Any, shapes: Any, mesh: Mesh | None) -> Any:
    """The `rest_dims` entries of a held `tree` whose leaves the model
    reads whole in the shapes of `shapes` (a tree of `tree`'s structure
    whose leaves have the global shapes: meta tensors, say): a leaf held
    whole gives None, a leaf held as its block under the rule the dim
    the block cuts.  A leaf that is neither raises."""
    n = 1 if mesh is None else mesh.shape.get(DATA_AXIS, 1)
    leaves = tree_leaves(tree)
    out = []
    for x, glob in zip(leaves, tree_leaves(shapes)):
        glob = tuple(glob.shape)
        d = sharded_dim(fsdp_spec(glob, n)) if n > 1 else None
        if d is None or tuple(x.shape) == glob:
            out.append(None)
            continue
        want = glob[:d] + (glob[d] // n,) + glob[d + 1:]
        if tuple(x.shape) != want:
            raise ValueError(f"a leaf of {tuple(x.shape)}: neither its "
                             f"global {glob} nor its block {want}")
        out.append(d)
    return tree_unflatten(tree, iter(out))


def _gather_blocks(blocks, dims, mesh: Mesh) -> list[torch.Tensor]:
    """The whole leaves of `blocks` (each cut along its `dims` entry over
    "data"): one all-gather of the blocks packed flat, each block's cut
    dim first; each whole leaf a new contiguous tensor, written once."""
    flat = torch.cat([b.detach().movedim(d, 0).reshape(-1).to(blocks[0].dtype)
                      for b, d in zip(blocks, dims)])
    rows = mesh.all_gather(flat[None], DATA_AXIS, 0)          # (k, S)
    k, out, i = rows.shape[0], [], 0
    for b, d in zip(blocks, dims):
        moved = tuple(b.movedim(d, 0).shape)
        shape = list(b.shape)
        shape[d] *= k
        w = torch.empty(shape, dtype=b.dtype, device=b.device)
        w.movedim(d, 0).unflatten(0, (k, moved[0])).copy_(
            rows[:, i:i + b.numel()].unflatten(1, moved))
        out.append(w)
        i += b.numel()
    return out


class _GatherAtUse(torch.autograd.Function):
    """(mesh, dims, reduce, *blocks) -> the whole leaves: one all-gather
    over "data".  The backward packs the whole leaves' gradients the same
    way and reduce-scatters them over "data" (`reduce`), or, where each
    is the same on every rank of "data" already (a vocabulary block's),
    cuts this rank's block out of each."""

    @staticmethod
    def forward(ctx, mesh, dims, reduce, *blocks):
        ctx.mesh, ctx.dims, ctx.reduce = mesh, dims, reduce
        ctx.like = [(b.shape, b.dtype) for b in blocks]
        ctx.layer = trace.current_layer()
        with trace.annotate(AT_USE, blocks[0]):
            return tuple(_gather_blocks(blocks, dims, mesh))

    @staticmethod
    def backward(ctx, *grads):
        mesh, dims = ctx.mesh, ctx.dims
        k, me = mesh.axis_size(DATA_AXIS), mesh.index(DATA_AXIS)
        if not ctx.reduce:
            return (None, None, None) + tuple(
                g.narrow(d, me * (g.shape[d] // k), g.shape[d] // k)
                for g, d in zip(grads, dims))
        specs = [rest_spec(g.dim(), d) for g, d in zip(grads, dims)]
        with trace.annotate(AT_USE, grads[0], layer=ctx.layer, bwd=True):
            flat = mesh.reduce_scatter(pack_rows(grads, specs, k),
                                       DATA_AXIS, 0)
        out, i = [], 0
        for (shape, dtype), d in zip(ctx.like, dims):
            n = shape.numel()
            moved = (shape[d],) + shape[:d] + shape[d + 1:]
            out.append(flat[i:i + n].reshape(moved).movedim(0, d).to(dtype))
            i += n
        return (None, None, None) + tuple(out)


def gather_at_use(tree: Any, rest: Any, mesh: Mesh | None, *,
                  summed: bool = False, saved=None) -> Any:
    """`tree` (one layer's held params, say) with every leaf that `rest`
    cuts gathered whole over "data": one all-gather of the blocks
    (`_GatherAtUse`), whose backward reduce-scatters their gradients over
    "data" (`summed`: cuts them, a gradient the same on every rank of
    "data" already).  The identity where nothing is cut (`rest` None, one
    device, a data axis of one rank).  `saved`: an `AtUse` that keeps
    each op's saved copy of these whole leaves as its block."""
    if rest is None or mesh is None or mesh.shape.get(DATA_AXIS, 1) == 1:
        return tree
    leaves = tree_leaves(tree)
    dims = tree_leaves(rest)
    at = [i for i, d in enumerate(dims) if d is not None]
    if not at:
        return tree
    blocks = [leaves[i] for i in at]
    wholes = _GatherAtUse.apply(mesh, [dims[i] for i in at], not summed,
                                *blocks)
    if saved is not None:
        saved.keep(blocks, [dims[i] for i in at], wholes)
    out = list(leaves)
    for i, w in zip(at, wholes):
        out[i] = w
    return tree_unflatten(tree, iter(out))


class AtUse:
    """The gathers at use of one region (a layer), as a context manager:
    `use(tree, rest)` is `gather_at_use(tree, rest, mesh, saved=use)`, and
    inside the `with` every tensor an op saves for the backward that is
    (a view of) such a whole leaf is kept as its block and the region's
    blocks gathered again, once, where the backward first needs one
    (`torch.autograd.graph.saved_tensors_hooks`): a whole leaf does not
    outlive its region.  Not for the inside of a checkpointed region
    (`torch.utils.checkpoint`), which keeps nothing and runs the gather
    again itself."""

    def __init__(self, mesh: Mesh | None):
        self.mesh = mesh
        self._held: list = []      # (weakref to a whole leaf, record, i)
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, self._unpack)

    def __call__(self, tree: Any, rest: Any, *, summed: bool = False
                 ) -> Any:
        return gather_at_use(tree, rest, self.mesh, summed=summed,
                             saved=self)

    def keep(self, blocks, dims, wholes) -> None:
        rec = _Regather(blocks, dims, self.mesh)
        self._held += [(weakref.ref(w), rec, i) for i, w in
                       enumerate(wholes)]

    def _pack(self, t: torch.Tensor):
        # a whole leaf, or a view of one: its storage (a live leaf's
        # storage is no other tensor's)
        if self._held:
            st = t.untyped_storage()._cdata
            for ref, rec, i in self._held:
                w = ref()
                if w is not None and w.untyped_storage()._cdata == st:
                    return rec, i, t.size(), t.stride(), t.storage_offset()
        return t

    @staticmethod
    def _unpack(packed):
        if isinstance(packed, torch.Tensor):
            return packed
        rec, i, size, stride, offset = packed
        return rec.whole(i).as_strided(size, stride, offset)

    def __enter__(self) -> "AtUse":
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._hooks.__exit__(*exc)
        self._held.clear()


class _Regather:
    """One gather at use's blocks, gathered whole again (once) where the
    backward first unpacks a saved copy of one of them."""

    def __init__(self, blocks, dims, mesh):
        self.blocks = [b.detach() for b in blocks]
        self.dims, self.mesh, self.wholes = dims, mesh, None
        self.layer = trace.current_layer()

    @torch.no_grad()
    def whole(self, i: int) -> torch.Tensor:
        if self.wholes is None:
            with trace.annotate(AT_USE, self.blocks[0], layer=self.layer,
                                bwd=True):
                self.wholes = _gather_blocks(self.blocks, self.dims,
                                             self.mesh)
        return self.wholes[i]


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
