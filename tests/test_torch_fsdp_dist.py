"""Params held at rest as the reference's FSDP blocks over "data"
(`launch/shardings.py`: `rest_dims`, `param_blocks`, `gather_at_use`,
`AtUse`), on gloo CPU ranks against the whole-weight step and the
reference's placement.

    python tests/torch_dist_cases.py fsdp 2,2 DIR
    python tests/torch_dist_cases.py fsdp_pod 2,2,1 DIR

- Each of `torch_dist_cases.FSDP_RUNS` on data 2 x model 2 (ZERO_NET,
  mesh1k's structure at widths data 2 cuts, under the uniform plan and
  the §V-C solve, and at grad-accum 2; a ResNet cut to one bottleneck a
  stage under both plans; qwen1.5 SMOKE, also at grad-accum 2, under
  --remat and under ZeRO-1 over data x model), and the meshnet under
  each pod compression on pod 2 x data 2: FSDP_STEPS steps at rest give
  the losses, gradient norms and params of the whole-weight step
  (`torch_dist_cases.whole_weight_step`, the step as the port ran it with
  every param whole) within 1e-6, on every rank.
- Each rank's blocks are the reference's: the shapes
  `repro.launch.shardings.fsdp_tree_specs` gives on the reference's own
  tree (an LM's stacked per segment), for those nets, and for the
  registered archs at full width (shapes only) at data 2 and 16, where no
  stacked leaf is cut along its layer count.
- The collectives of a step by region: one gather over data a layer that
  holds a block (and one a use of the embedding, the norms, the
  unembedding), one reduce-scatter each in the backward, the gathers
  again in the backward where an op kept a whole leaf (in the recompute
  under --remat), no gather of the params after the update (ZeRO-1's
  gather over "model" alone), no reduce-scatter in the gradient bucket
  but ZeRO-1's over "model".
- Save -> restore -> resume: the at-rest state and the whole-weight
  state (`repro/ckpt@1`, as the port wrote it before it held params at
  rest) restore into fresh blocks exactly and the next step is the live
  run's.  The reference's checkpoint restores at rest in
  `test_torch_zero_dist.py`.
"""
import json

import jax
import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from repro.configs import registry as jreg
from repro.launch import shardings as jsh
from repro.models.cnn import meshnet as jmesh
from repro.models.cnn import resnet as jres
from repro.models.lm import transformer as jT
from repro_torch.configs import registry
from repro_torch.launch import shardings
from repro_torch.models.cnn import meshnet as tmesh
from repro_torch.models.cnn import resnet as tres
from repro_torch.models.lm import transformer as tT
from repro_torch.utils import tree_leaves, tree_unflatten

DIMS, POD_DIMS = (2, 2), (2, 2, 1)
TOL = 1e-6
RUNS = [r[0] for r in cases.FSDP_RUNS]
POD_RUNS = [f"pod_{m}" for m in cases.FSDP_POD_METHODS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank groups, started together."""
    d1 = str(tmp_path_factory.mktemp("fsdp"))
    d2 = str(tmp_path_factory.mktemp("fsdp_pod"))
    p1 = cases.start("fsdp", DIMS, d1)
    p2 = cases.start("fsdp_pod", POD_DIMS, d2)
    ranks = cases.collect(p1, DIMS, d1)
    return ranks + cases.collect(p2, POD_DIMS, d2)


def _group(runs, key):
    return runs[:4] if not key.startswith("pod_") else runs[4:]


def _params(r, key, mode, what="param"):
    n = sum(1 for k in r if k.startswith(f"{key}/{mode}/{what}") and
            k[len(f"{key}/{mode}/{what}"):].isdigit())
    return [r[f"{key}/{mode}/{what}{i}"] for i in range(n)]


@pytest.mark.parametrize("key", RUNS + POD_RUNS)
def test_at_rest_is_the_whole_weight_step(runs, key):
    for r in _group(runs, key):
        np.testing.assert_allclose(r[f"{key}/rest/losses"],
                                   r[f"{key}/whole/losses"], rtol=TOL)
        np.testing.assert_allclose(r[f"{key}/rest/grad_norms"],
                                   r[f"{key}/whole/grad_norms"], rtol=TOL)
        got, want = _params(r, key, "rest"), _params(r, key, "whole")
        assert len(got) == len(want) > 0
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape
            assert float(np.abs(a - b).max()) <= TOL, (key, i)


@pytest.mark.parametrize("key", RUNS + POD_RUNS)
def test_every_rank_ends_with_the_same_params(runs, key):
    group = _group(runs, key)
    for r in group[1:]:
        np.testing.assert_array_equal(r[f"{key}/rest/losses"],
                                      group[0][f"{key}/rest/losses"])
        for a, b in zip(_params(r, key, "rest"),
                        _params(group[0], key, "rest")):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------- the reference's placement --

class _Shape:
    def __init__(self, **shape):
        self.shape = shape


def _ref_blocks(tree, data: int) -> list[tuple]:
    """The per-device block shape of every leaf of the reference's
    `tree` under its `fsdp_tree_specs` on a data axis of `data`."""
    specs = jax.tree.structure(tree).flatten_up_to(
        jsh.fsdp_tree_specs(tree, _Shape(data=data, model=2)))
    out = []
    for x, s in zip(jax.tree.leaves(tree), specs):
        shape = list(x.shape)
        for d, a in enumerate(tuple(s)):
            if a is not None:
                shape[d] //= data
        out.append(tuple(shape))
    return out


def _port_blocks(params, data: int, counts=None) -> list:
    """The port's block of every leaf of `params` on a data axis of
    `data` (`rest_dims`), as meta tensors in `params`' structure."""
    rest = shardings.rest_dims(params, {"data": data, "model": 2}, counts)

    def block(x, d):
        shape = list(x.shape)
        if d is not None:
            shape[d] //= data
        return torch.empty(shape, device="meta")
    return tree_unflatten(params, iter(
        [block(x, d) for x, d in zip(tree_leaves(params),
                                     tree_leaves(rest))]))


def _meta(tree):
    return jax.tree.map(lambda a: torch.empty(a.shape, device="meta"), tree)


def _lm_blocks(arch, smoke, data):
    """(the reference's blocks, the port's blocks stacked into the
    reference's segments) of an LM arch's params."""
    ref = jax.eval_shape(lambda k: jT.init(k, jreg.get(arch, smoke=smoke)),
                         jax.random.PRNGKey(0))
    cfg = registry.get(arch, smoke=smoke)
    mine = tT.tree_from_jax(_meta(ref), cfg)      # per layer, meta
    stacked = tT.tree_to_jax(_port_blocks(mine, data,
                                          tT.stack_counts(mine, cfg)), cfg)
    return _ref_blocks(ref, data), [tuple(t.shape) for t in
                                    jax.tree.leaves(_meta(stacked))]


def test_each_rank_holds_the_references_blocks(runs):
    """The held shapes of the runs against the reference's trees."""
    key = jax.random.PRNGKey(0)
    ref = {"mesh_uniform": jax.eval_shape(lambda k: jmesh.init(
               k, jmesh.MeshNetConfig("z", **cases.ZERO_NET)), key),
           "resnet_uniform": jax.eval_shape(lambda k: jres.init(
               k, jres.ResNetConfig("r", **cases.FSDP_RESNET)), key)}
    want = {run: _ref_blocks(tree, 2) for run, tree in ref.items()}
    for run, tree in ref.items():
        assert want[run] != [tuple(x.shape) for x in jax.tree.leaves(tree)]
    cfg = registry.get(cases.FSDP_LM, smoke=True)
    like = tT.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    want_lm, _ = _lm_blocks(cases.FSDP_LM, True, 2)
    for r in runs[:4]:
        for run in ref:
            got = [tuple(s) for s in json.loads(str(r[f"{run}/held_shapes"]))]
            assert got == want[run], run
        held = tree_unflatten(like, iter(
            [torch.empty(s, device="meta") for s in
             json.loads(str(r["lm/held_shapes"]))]))
        assert [tuple(t.shape) for t in jax.tree.leaves(_meta(
            tT.tree_to_jax(held, cfg)))] == want_lm


@pytest.mark.parametrize("data", [2, 16])
@pytest.mark.parametrize("arch", registry.ARCHS)
def test_full_size_lm_blocks_are_the_references(arch, data):
    """Every registered LM arch at full width, shapes only: the port's
    per-layer blocks, stacked, are the reference's blocks of its stacked
    leaves (so no stacked leaf is cut along its layer count, which
    `rest_dims` refuses)."""
    want, got = _lm_blocks(arch, False, data)
    assert got == want


@pytest.mark.parametrize("data", [2, 16])
def test_full_size_cnn_blocks_are_the_references(data):
    key = jax.random.PRNGKey(0)
    for jcfg, tcfg, jmod, tmod in (
            (jreg.get("mesh1k"), registry.get("mesh1k"), jmesh, tmesh),
            (jreg.get("resnet50"), registry.get("resnet50"), jres, tres)):
        ref = jax.eval_shape(lambda k, c=jcfg, m=jmod: m.init(k, c), key)
        got = [tuple(t.shape) for t in tree_leaves(
            _port_blocks(tmod.global_params(tcfg), data))]
        assert got == _ref_blocks(ref, data)
        assert got != [tuple(x.shape) for x in jax.tree.leaves(ref)]


def test_the_stacked_rule_cuts_what_a_layer_alone_would_not():
    """A layer's norm of d elements is under 2^14, the stack of its
    segment's norms over it: the reference cuts the stack along d, and
    the port each layer's norm with it."""
    cfg = registry.get("qwen2.5-14b")
    norm = torch.empty((cfg.d_model,), device="meta")
    assert cfg.d_model < shardings.MIN_SHARDED <= cfg.n_layers * cfg.d_model
    assert shardings.rest_dims([norm], {"data": 16}) == [None]
    assert shardings.rest_dims([norm], {"data": 16}, [cfg.n_layers]) == [0]
    with pytest.raises(ValueError, match="layer count"):
        shardings.rest_dims([torch.empty((1000,), device="meta")],
                            {"data": 16}, [48])


# ------------------------------------------------ the step's collectives --

def _sites(key):
    """(gathers at use a step: with a block cut over data, per layer and
    per top-level use; those inside a checkpointed unit) of a run."""
    net = next(n for k, n, *_ in cases.FSDP_RUNS if k == key)
    mesh = {"data": 2, "model": 2}
    if net == "lm":
        cfg = registry.get(cases.FSDP_LM, smoke=True)
        params = tT.init(torch.Generator().manual_seed(0), cfg, device="cpu")
        rest = shardings.rest_dims(params, mesh, tT.stack_counts(params, cfg))
        def cut(t):
            return any(d is not None for d in tree_leaves(t))
        layers = sum(cut(lr) for lr in rest["layers"])
        # the lookup, the logits (the tied table again), the final norm
        top = cut(rest["embed"]) + cut(rest.get("unembed", rest["embed"])) \
            + cut(rest["final_norm"])
        return top + layers, layers
    cfg = tmesh.MeshNetConfig("z", **cases.ZERO_NET) if net == "mesh" else \
        tres.ResNetConfig("r", **cases.FSDP_RESNET)
    glob = (tmesh if net == "mesh" else tres).global_params(cfg)
    rest = shardings.rest_dims(glob, mesh)
    if net == "mesh":
        parts = list(rest)
    else:
        parts = [{k: rest[k] for k in ("conv1", "bn1")}] + \
            list(rest["blocks"]) + [rest["head"]]
    return sum(any(d is not None for d in tree_leaves(p))
               for p in parts), 0


@pytest.mark.parametrize("key", RUNS + POD_RUNS)
def test_collectives_a_step_by_region(runs, key):
    ops = json.loads(str(_group(runs, key)[0][f"{key}/ops"]))
    accum = next((a for k, _, _, a, _ in cases.FSDP_RUNS if k == key), 1)
    sites, remat_layers = _sites(key if key in RUNS else "mesh_uniform")
    remat = key == "lm_remat"
    assert sites > 0
    assert ops.get("fsdp_gather/all_gather/fwd") == accum * (
        sites + (remat_layers if remat else 0)), ops
    assert ops.get("fsdp_gather/reduce_scatter/bwd") == accum * sites, ops
    # a gather again where an op kept a view of a whole leaf (a
    # channel/filter layer keeps its own block of the kernel instead);
    # under --remat a checkpointed layer's recompute gathers instead
    again = ops.get("fsdp_gather/all_gather/bwd", 0)
    assert again <= accum * (sites - (remat_layers if remat else 0)), ops
    if not key.endswith("_auto"):
        assert again > 0, ops
    if key == "lm_zero1":
        assert ops.get("param_gather/all_gather/bwd") == 1, ops
        assert ops.get("grad_bucket/reduce_scatter/bwd") == 1, ops
    else:
        assert not any(k.startswith("param_gather") for k in ops), ops
        assert "grad_bucket/reduce_scatter/bwd" not in ops, ops


# ----------------------------------------------- save, restore, resume --

@pytest.mark.parametrize("mode", ["rest", "whole"])
@pytest.mark.parametrize("key", ["mesh_uniform", "lm"])
def test_save_restore_resume(runs, key, mode):
    for r in runs[:4]:
        assert int(r[f"{key}/{mode}/restored_step"]) == cases.FSDP_STEPS
        assert float(r[f"{key}/{mode}/restored_diff"]) == 0.0
        resumed = _params(r, key, mode, "resumed")
        live = _params(r, key, mode, "live")
        assert len(resumed) == len(live) > 0
        if mode == "rest":            # the same blocks and moments
            assert r[f"{key}/{mode}/resumed_loss"] == \
                r[f"{key}/{mode}/live_loss"]
            for a, b in zip(resumed, live):
                np.testing.assert_array_equal(a, b)
        else:                         # at rest against the whole step
            np.testing.assert_allclose(r[f"{key}/{mode}/resumed_loss"],
                                       r[f"{key}/{mode}/live_loss"],
                                       rtol=TOL)
            for a, b in zip(resumed, live):
                assert float(np.abs(a - b).max()) <= TOL
