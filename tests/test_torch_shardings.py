"""The port's training-state sharding (`launch/shardings.py`) against the
reference's (`repro.launch.shardings`).

- `fsdp_tree_specs` leaf for leaf on the param trees of meshnet SMOKE,
  ResNet-50 SMOKE and hymba SMOKE at data 1-4 (the reference needs only
  the mesh's shape): leaves under 2^14 elements replicate, the rest shard
  their largest dim that data divides, ties to the lower dim.  At data 3
  a 3x3 kernel's height takes the shard where no width divides by 3.
  The port's own trees (meshnet's, hymba's stacked into segments) get
  the reference's specs.
- `shard` / `unshard` / `pack_rows` on layout-only
  meshes: each rank's block, the blocks stitched back, the flat buffer's
  per-rank rows.
- Params at rest: `rest_dims`, `param_blocks` and `held_rest` on
  layout-only meshes; the axes a block's gradient is summed over
  already (`reduce_axes`, `block_axes`); ZeRO-1's state a cut over
  "model" within the data block, the reference's zero1 block.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import hymba_1_5b as jhymba
from repro.configs import mesh1k as jmesh1k
from repro.configs import resnet50 as jres50
from repro.launch import shardings as jsh
from repro.models.cnn import meshnet as jmesh
from repro.models.cnn import resnet as jres
from repro.models.lm import transformer as jT
from repro_torch.launch import shardings
from repro_torch.launch.mesh import Mesh
from repro_torch.models.cnn import meshnet as tmesh
from repro_torch.models.lm import transformer as tT
from repro_torch.configs import hymba_1_5b as thymba


class _Shape:
    """What the reference's rule reads of a mesh: its shape."""

    def __init__(self, **shape):
        self.shape = shape


def _ref_trees():
    key = jax.random.PRNGKey(0)
    return {"meshnet": jmesh.init(key, jmesh1k.SMOKE),
            "resnet50": jres.init(key, jres50.SMOKE),
            "hymba": jT.init(key, jhymba.SMOKE),
            # full width, shapes only: leaves of >= 2^14 elements
            "mesh1k": jax.eval_shape(
                lambda k: jmesh.init(k, jmesh1k.CONFIG), key),
            "resnet50_full": jax.eval_shape(
                lambda k: jres.init(k, jres50.CONFIG), key)}


TREES = _ref_trees()


def _shapes(tree):
    return jax.tree.map(lambda a: np.zeros(a.shape, np.float32), tree)


def _tree(name):
    """The reference's param tree `name`: arrays, or (full width) shapes."""
    t = TREES[name]
    return t if name in ("mesh1k", "resnet50_full") else _shapes(t)


def _per_leaf(params, specs) -> list[tuple]:
    """The specs of `params`' leaves, in `jax.tree.leaves` order (a spec
    is a tuple: flattened only down to `params`' own structure)."""
    return [tuple(s) for s in
            jax.tree.structure(params).flatten_up_to(specs)]


@pytest.mark.parametrize("data", [1, 2, 3, 4])
@pytest.mark.parametrize("name", list(TREES))
def test_fsdp_specs_match_the_reference_leaf_for_leaf(name, data):
    tree = _tree(name)
    mesh = _Shape(data=data, model=2)
    want = _per_leaf(tree, jsh.fsdp_tree_specs(tree, mesh))
    got = _per_leaf(tree, shardings.fsdp_tree_specs(
        tree, {"data": data, "model": 2}))
    assert len(got) == len(want) == len(jax.tree.leaves(tree))
    assert got == want
    if name in ("mesh1k", "resnet50_full"):
        assert any(got), "every leaf replicated: the case tests nothing"


def test_data_3_shards_a_kernels_height():
    """mesh1k's 3x3 convs of widths 64-512 at data 3: no width divides
    by 3, the kernel's height does (the full tree's specs)."""
    specs = _per_leaf(TREES["mesh1k"], shardings.fsdp_tree_specs(
        TREES["mesh1k"], {"data": 3, "model": 1}))
    big = [s for s in specs if s]
    assert big and all(s == ("data", None, None, None) for s in big)
    assert shardings.fsdp_spec((3, 3, 64, 128), 3) == ("data", None, None,
                                                       None)
    assert shardings.fsdp_spec((3, 3, 96, 64), 3) == (None, None, "data",
                                                      None)
    assert shardings.fsdp_spec((127, 129), 2) == ()
    assert shardings.fsdp_spec((64, 64), 2) == ()          # 2^12 elements
    assert shardings.fsdp_spec((), 2) == ()


def test_port_trees_get_the_reference_specs():
    """The port's own param trees (meshnet's list of dicts, hymba's
    per-layer list) take, layer for layer, the specs of the reference's
    trees of the same leaves."""
    mine = tmesh.init(torch.Generator().manual_seed(0),
                      tmesh.MeshNetConfig(**{
                          k: getattr(jmesh1k.SMOKE, k) for k in (
                              "name", "input_hw", "in_channels",
                              "convs_per_block", "widths")}))
    ref = _shapes(TREES["meshnet"])
    got = shardings.fsdp_tree_specs(mine, {"data": 2, "model": 1})
    want = jsh.fsdp_tree_specs(ref, _Shape(data=2, model=1))
    assert _per_leaf(ref, got) == _per_leaf(ref, want)
    # hymba's per-layer tree, stacked into the reference's segments
    lm = tT.init(torch.Generator().manual_seed(0), thymba.SMOKE,
                 device="cpu")
    ref = _shapes(TREES["hymba"])
    got = shardings.fsdp_tree_specs(tT.tree_to_jax(lm, thymba.SMOKE),
                                    {"data": 2})
    want = jsh.fsdp_tree_specs(ref, _Shape(data=2))
    assert _per_leaf(ref, got) == _per_leaf(ref, want)


def _layout_meshes(shape):
    n = 1
    for v in shape.values():
        n *= v
    return [Mesh(shape, rank=r) for r in range(n)]


def test_shard_unshard_and_the_flat_rows():
    g = np.random.default_rng(3)
    leaves = [torch.from_numpy(g.standard_normal(s).astype(np.float32))
              for s in [(3, 3, 64, 64), (64,), (3, 3, 32, 128), (256, 72)]]
    shape = {"pod": 2, "data": 2, "model": 1}
    meshes = _layout_meshes(shape)
    specs = shardings.zero_specs(leaves, meshes[0])
    assert [bool(s) for s in specs] == [True, False, True, True]
    big = [(x, s) for x, s in zip(leaves, specs) if s]
    rows = shardings.pack_rows([x for x, _ in big], [s for _, s in big], 2)
    rows = rows.view(2, -1)
    for m in meshes:
        blocks = [shardings.shard(x, s, m) for x, s in big]
        d = m.coords["data"]
        # row d of the flat buffer is this rank's blocks, leaf after leaf
        np.testing.assert_array_equal(
            rows[d].numpy(), torch.cat([b.movedim(shardings.sharded_dim(s),
                                                  0).reshape(-1)
                                        for b, (_, s) in zip(blocks, big)
                                        ]).numpy())
        assert all(b.shape[shardings.sharded_dim(s)] * 2 ==
                   x.shape[shardings.sharded_dim(s)]
                   for b, (x, s) in zip(blocks, big))
    # the blocks of the two data ranks stitched along the dim: the leaf
    for x, s in big:
        d = shardings.sharded_dim(s)
        parts = [shardings.shard(x, s, meshes[r]) for r in (0, 1)]
        np.testing.assert_array_equal(torch.cat(parts, d).numpy(),
                                      x.numpy())
    assert shardings.unshard(leaves[1], specs[1], meshes[0]) is leaves[1]
    assert shardings.state_bytes(leaves, meshes[0]) == (
        sum(x.numel() * 2 for x, _ in big), 64 * 4)


# ------------------------------------------------------- params at rest --

def test_param_blocks_are_the_rank_blocks_at_rest():
    """`rest_dims` cuts the leaves `fsdp_spec` cuts (at data 2), on the
    same dim; `param_blocks` gives each rank its block (a new leaf that
    requires grad, the small leaves themselves); `held_rest` reads the
    cut back from the global shapes, for whole and held trees alike."""
    g = np.random.default_rng(5)
    leaves = [torch.from_numpy(g.standard_normal(s).astype(np.float32))
              .requires_grad_()
              for s in [(3, 3, 64, 64), (64,), (3, 3, 32, 128), (256, 72)]]
    shape = {"pod": 2, "data": 2, "model": 1}
    rest = shardings.rest_dims(leaves, shape)
    assert rest == [shardings.sharded_dim(shardings.fsdp_spec(x.shape, 2))
                    for x in leaves] == [2, None, 3, 0]
    meta = [torch.empty(x.shape, device="meta") for x in leaves]
    for m in _layout_meshes(shape):
        held = shardings.param_blocks(leaves, rest, m)
        assert held[1] is leaves[1]
        for x, h, d in zip(leaves, held, rest):
            spec = shardings.rest_spec(x.dim(), d)
            np.testing.assert_array_equal(
                h.detach().numpy(), shardings.shard(x.detach(), spec,
                                                    m).numpy())
            assert h.requires_grad and (d is None or h.is_contiguous())
        assert shardings.held_rest(held, meta, m) == rest
        assert shardings.held_rest(leaves, meta, m) == [None] * 4
        # a moment is the held block; the bytes a rank holds
        assert shardings.state_bytes(held, m, rest) == (
            sum(h.numel() * 4 for h, d in zip(held, rest) if d is not None),
            64 * 4)
        assert shardings.held_bytes(held) == sum(h.numel() * 4
                                                 for h in held)
    with pytest.raises(ValueError, match="neither"):
        shardings.held_rest([torch.zeros(3, 3, 64, 16)], meta[:1],
                            _layout_meshes(shape)[0])
    assert shardings.rest_dims(leaves, {"data": 1, "model": 2}) == \
        [None] * 4


def test_a_block_at_rest_is_summed_over_data():
    """The axes a held leaf's gradient still needs (`reduce_axes`) and the
    axes it is cut over (`block_axes`): at rest, "data" moves from the
    first to the second, for a whole leaf and an expert block alike; a
    vocabulary block needs none."""
    m = Mesh({"pod": 2, "data": 2, "model": 2}, rank=0)
    assert shardings.reduce_axes("whole", m) == ("pod", "data", "model")
    assert shardings.reduce_axes("whole", m, 0) == ("pod", "model")
    assert shardings.reduce_axes("expert", m, 1) == ("pod",)
    assert shardings.reduce_axes("vocab", m, 0) == ()
    assert shardings.block_axes("whole", 0) == ("data",)
    assert shardings.block_axes("expert", 0) == ("model", "data")
    assert shardings.block_axes("whole") == ()


def test_zero1_state_is_a_cut_within_the_block_at_rest():
    """Under ZeRO-1 a whole leaf's state cut over (data, model) on the
    dim data cuts at rest is the block's cut over model on that dim (the
    reference's zero1 block); where ZeRO-1 falls back to data, the held
    block; ZeRO over data keeps the block whole."""
    m = Mesh({"data": 2, "model": 2}, rank=3)
    glob = (512, 64)
    held = [torch.zeros(256, 64), torch.zeros(3, 3, 32, 6 * 16)]
    rest = [0, 2]
    axes = ("data", "model")
    specs = shardings.zero_specs(held, m, axes, None, rest)
    assert shardings.zero1_spec(glob, dict(m.shape), axes) == \
        (("data", "model"), None)
    assert specs[0] == ("model", None)
    # (3, 3, 64, 96): zero1 cuts 96 over both, the block's cut over data
    # is the 64: the state cuts the block's 96 over model
    assert specs[1] == (None, None, None, "model")
    assert shardings.zero_specs(held, m, ("data",), None, rest) == [(), ()]
    # the reference's zero1 block is this rank's cut of its data block
    x = torch.arange(512 * 64, dtype=torch.float32).view(glob)
    z1 = shardings.shard(x, (("data", "model"), None), m)
    blk = shardings.shard(x, ("data", None), m)
    np.testing.assert_array_equal(z1.numpy(), shardings.shard(
        blk, specs[0], m).numpy())
