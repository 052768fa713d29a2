"""The port's training-state sharding (`launch/shardings.py`) against the
reference's (`repro.launch.shardings`).

- `fsdp_tree_specs` leaf for leaf on the param trees of meshnet SMOKE,
  ResNet-50 SMOKE and hymba SMOKE at data 1-4 (the reference needs only
  the mesh's shape): leaves under 2^14 elements replicate, the rest shard
  their largest dim that data divides, ties to the lower dim.  At data 3
  a 3x3 kernel's height takes the shard where no width divides by 3.
  The port's own trees (meshnet's, hymba's stacked into segments) get
  the reference's specs.
- `shard` / `unshard` / `pack_rows` / `gather_params_` on layout-only
  meshes: each rank's block, the blocks stitched back, the flat buffer's
  per-rank rows.
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
