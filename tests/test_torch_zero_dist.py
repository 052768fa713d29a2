"""The training state sharded over "data" (ZeRO, `launch/shardings.py`)
and the cross-pod gradient compression in the port's train step, on 4
gloo ranks at pod 2 x data 2 x model 1, against the reference trainer's
step on 4 host devices (`jax_mesh_oracles.py zero`).

The net (`torch_dist_cases.ZERO_NET`, BN at mesh1k's local scope) has
three 3x3x64x64 convs, the leaves of >= 2^14 elements that data 2
shards.  (check_train's config, dist_checks.py:261, shards nothing.)

- Every rank reports the same losses and ends with the same params.
- Each rank's momentum is its block under the reference's spec.
- `none`: 3 SGD steps' losses and params within the multi-rank
  trajectory tolerance (losses rtol 1e-4, params rtol 3e-4 / atol 3e-5,
  test_torch_spatial_meshnet.py's).
- `bf16`, `int8_ef`, and `int8_ef` at grad_accum 2 (check_train's run):
  the port sends each pod's own gradient compressed, the reference
  rounds the already-reduced one (ROADMAP Queue 3), so the two differ by
  construction.  The bound, to first order (the gradients' change with
  the params' divergence left out): each step's gradient differs by at
  most 2 u G per element, G the largest |x| a pod exchange took, u one
  payload's rounding relative to it (2 x 1/254 for int8, whose emitted
  value carries the previous residual too; for bf16, which keeps 8
  significant bits, a rounding's worst case is 2^-8, and the test holds
  the two packages' roundings together to that one worst case, u =
  2^-9); SGD with momentum 0.9 weights step t's
  gradient in the final params by 1 + 0.9 + ... (2.71, 1.9, 1), so the
  params lie within lr x 5.61 x 2 u G (+ the `none` tolerance), and a
  loss within |grad| sqrt(n) times its params' bound.
- The int8_ef run's checkpoint (`repro/ckpt@1`, its residuals in the
  reference's (npods,) + leaf.shape layout) restores in the reference,
  and the reference's restores in the port, each rank's block cut, also
  onto params held at rest.

The port's runs hold the params at rest (each sharded conv's block over
data, gathered at its use), so the trajectories above are the at-rest
step's.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import jax_mesh_oracles
import torch_dist_cases as cases
from repro.checkpoint import checkpoint as jck
from repro.launch import shardings as jsh
from repro.models.cnn import meshnet as jmesh
from repro.optim import optimizer as jopt
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.launch import shardings
from repro_torch.launch.mesh import Mesh
from repro_torch.optim import optimizer as topt

DIMS = (2, 2, 1)                      # (pod, data, model)
SHAPE = {"pod": 2, "data": 2, "model": 1}
MOMENTUM = 0.9
# per element, one payload's rounding relative to the largest |x|, times
# the payloads that differ a step (see the module docstring)
UNIT = {"bf16": 2 * 2.0 ** -9, "int8_ef": 2 * 2 / 254}


def _ref_params():
    return jmesh.init(jax.random.PRNGKey(0),
                      jmesh.MeshNetConfig("z", **cases.ZERO_NET))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero")
    np.savez(d / "inputs.npz", **{
        f"{i}.{k}.{pk}": np.asarray(v) for i, layer in enumerate(
            _ref_params()) for k, sub in layer.items()
        for pk, v in sub.items()})
    p = cases.start("zero", DIMS, str(d))
    r = jax_mesh_oracles.popen("zero", str(d))
    ranks = cases.collect(p, DIMS, str(d))
    jax_mesh_oracles.wait(r)
    return d, ranks, dict(np.load(d / "zero.npz"))


def _n_leaves():
    return len(jax.tree.leaves(_ref_params()))


def _specs():
    params = _ref_params()
    return [tuple(s) for s in jax.tree.structure(params).flatten_up_to(
        jsh.fsdp_tree_specs(params, type("M", (), {"shape": SHAPE})))]


@pytest.mark.parametrize("key", [r[0] for r in cases.ZERO_RUNS])
def test_every_rank_has_the_same_losses_and_params(runs, key):
    _, ranks, _ = runs
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{key}/losses"],
                                      ranks[0][f"{key}/losses"])
        for i in range(_n_leaves()):
            np.testing.assert_array_equal(r[f"{key}/param{i}"],
                                          ranks[0][f"{key}/param{i}"])


def test_each_rank_keeps_the_moments_of_its_block(runs):
    _, ranks, _ = runs
    params = jax.tree.leaves(_ref_params())
    specs = _specs()
    assert sum(1 for s in specs if s) == 3, specs
    want = []
    for p, s in zip(params, specs):
        shape = list(p.shape)
        if s:
            shape[s.index("data")] //= SHAPE["data"]
        want.append(shape)
    for r in ranks:
        for key, *_ in cases.ZERO_RUNS:
            assert json.loads(str(r[f"{key}/mu_shapes"])) == want


def test_none_matches_the_reference_trainer(runs):
    _, ranks, ref = runs
    got = ranks[0]
    np.testing.assert_allclose(got["none/losses"], ref["none/losses"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["none/grad_norms"],
                               ref["none/grad_norms"], rtol=1e-4)
    for i in range(_n_leaves()):
        np.testing.assert_allclose(got[f"none/param{i}"],
                                   ref[f"none/param{i}"], rtol=3e-4,
                                   atol=3e-5, err_msg=f"leaf {i}")


@pytest.mark.parametrize("key,method", [(k, m) for k, m, *_ in
                                        cases.ZERO_RUNS if m != "none"])
def test_compressed_runs_lie_within_the_rounding_bound(runs, key, method):
    _, ranks, ref = runs
    got = ranks[0]
    big = max(float(r[f"{key}/max_abs"]) for r in ranks)
    assert big > 0                   # the pod exchange ran compressed
    per_step = UNIT[method] * big * cases.ZERO_LR
    weights = [sum(MOMENTUM ** j for j in range(cases.ZERO_STEPS - t))
               for t in range(cases.ZERO_STEPS)]
    bound = per_step * sum(weights)
    for i in range(_n_leaves()):
        np.testing.assert_allclose(got[f"{key}/param{i}"],
                                   ref[f"{key}/param{i}"], rtol=3e-4,
                                   atol=3e-5 + bound, err_msg=f"leaf {i}")
    n = sum(got[f"{key}/param{i}"].size for i in range(_n_leaves()))
    losses, want = got[f"{key}/losses"], ref[f"{key}/losses"]
    np.testing.assert_allclose(losses[0], want[0], rtol=1e-5)
    for t in range(1, cases.ZERO_STEPS):
        moved = per_step * sum(sum(MOMENTUM ** j for j in range(t - s))
                               for s in range(t))
        tol = got[f"{key}/grad_norms"][t] * np.sqrt(n) * moved
        assert abs(losses[t] - want[t]) <= tol + 1e-4 * abs(want[t]), \
            (t, losses[t], want[t], tol)


def _ref_template():
    params = jax.tree.map(np.zeros_like, _ref_params())
    ef = jax.tree.map(lambda a: np.zeros((SHAPE["pod"],) + a.shape,
                                         np.float32), params)
    return (params, jopt.OptState(np.zeros((), np.int32), params, None), ef)


def test_port_int8_ef_checkpoint_restores_in_the_reference(runs):
    d, ranks, _ = runs
    (params, state, ef), manifest = jck.CheckpointManager(
        str(d / "ckpt_port"), async_save=False).restore(_ref_template())
    assert int(state.step) == cases.ZERO_STEPS
    assert manifest["extra"]["step"] == cases.ZERO_STEPS
    got = ranks[0]
    for i, (p, m, e) in enumerate(zip(jax.tree.leaves(params),
                                      jax.tree.leaves(state.mu),
                                      jax.tree.leaves(ef))):
        np.testing.assert_array_equal(np.asarray(p),
                                      got[f"int8_ef/param{i}"])
        np.testing.assert_array_equal(np.asarray(m), got[f"int8_ef/mu{i}"])
        np.testing.assert_array_equal(np.asarray(e), got[f"int8_ef/ef{i}"])
    # row p of a residual is pod p's, cut as each rank of it holds it
    specs = _specs()
    for rank, r in enumerate(ranks):
        m = Mesh(SHAPE, rank=rank)
        for i, (e, s) in enumerate(zip(jax.tree.leaves(ef), specs)):
            np.testing.assert_array_equal(
                shardings.shard(torch.from_numpy(np.asarray(e)[
                    m.coords["pod"]].copy()), s, m).numpy(),
                r[f"int8_ef/ef_local{i}"])


def test_reference_int8_ef_checkpoint_restores_in_the_port(runs):
    d, _, _ = runs
    (jp, js, jef), _ = jck.CheckpointManager(
        str(d / "ckpt_ref"), async_save=False).restore(_ref_template())

    def zeros(lead=()):
        return jax.tree.map(lambda a: torch.zeros(lead + a.shape),
                            _ref_params())
    tree, manifest = tck.CheckpointManager(str(d / "ckpt_ref"),
                                           writer=False).restore(
        (zeros(), (np.zeros((), np.int32), zeros(), None),
         zeros((SHAPE["pod"],))))
    assert manifest["extra"]["step"] == cases.ZERO_STEPS
    specs = _specs()
    for rank in range(4):
        m = Mesh(SHAPE, rank=rank)
        params = zeros()
        leaves = jax.tree.leaves(params)
        mine = [torch.zeros(shardings.shard(p, s, m).shape)
                for p, s in zip(leaves, specs)]
        ef = [torch.zeros_like(x) for x in mine]
        state = shardings.load_sharded_state_tree(
            tree, params, topt.OptState(0, mine, None), ef, m)
        assert state.step == cases.ZERO_STEPS
        for i, (p, mu, e, s) in enumerate(zip(
                jax.tree.leaves(jp), jax.tree.leaves(js.mu),
                jax.tree.leaves(jef), specs)):
            glob_mu = torch.from_numpy(np.asarray(mu).copy())
            row = torch.from_numpy(np.asarray(e)[m.coords["pod"]].copy())
            np.testing.assert_array_equal(leaves[i].numpy(), np.asarray(p))
            np.testing.assert_array_equal(
                state.mu[i].numpy(), shardings.shard(glob_mu, s, m).numpy())
            np.testing.assert_array_equal(
                ef[i].numpy(), shardings.shard(row, s, m).numpy())


def test_reference_checkpoint_restores_at_rest(runs):
    """The reference's int8_ef checkpoint restored onto params held at
    rest: each rank's param blocks, moments and residuals are its blocks
    of the reference's global arrays."""
    d, _, _ = runs
    (jp, js, jef), _ = jck.CheckpointManager(
        str(d / "ckpt_ref"), async_save=False).restore(_ref_template())

    def zeros(lead=()):
        return jax.tree.map(lambda a: torch.zeros(lead + a.shape),
                            _ref_params())
    tree, _ = tck.CheckpointManager(str(d / "ckpt_ref"),
                                    writer=False).restore(
        (zeros(), (np.zeros((), np.int32), zeros(), None),
         zeros((SHAPE["pod"],))))
    for rank in range(4):
        m = Mesh(SHAPE, rank=rank)
        rest = shardings.rest_dims(zeros(), m)
        params = shardings.param_blocks(zeros(), rest, m)
        held = jax.tree.leaves(params)
        assert any(p.shape != a.shape for p, a in
                   zip(held, jax.tree.leaves(_ref_params())))
        mu = [torch.zeros_like(p) for p in held]
        ef = [torch.zeros_like(p) for p in held]
        state = shardings.load_sharded_state_tree(
            tree, params, topt.OptState(0, mu, None), ef, m, rest=rest)
        assert state.step == cases.ZERO_STEPS
        for i, (p, a, e, dim) in enumerate(zip(
                zip(held, state.mu), zip(jax.tree.leaves(jp),
                                         jax.tree.leaves(js.mu)),
                zip(ef, jax.tree.leaves(jef)),
                shardings.rest_list(rest, len(held)))):
            spec = shardings.rest_spec(p[0].dim(), dim)

            def cut(x):
                return shardings.shard(torch.from_numpy(np.asarray(x).copy()),
                                       spec, m).numpy()
            np.testing.assert_array_equal(p[0].detach().numpy(), cut(a[0]))
            np.testing.assert_array_equal(p[1].numpy(), cut(a[1]))
            np.testing.assert_array_equal(
                e[0].numpy(), cut(np.asarray(e[1])[m.coords["pod"]]))
