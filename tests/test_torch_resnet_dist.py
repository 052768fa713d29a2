"""ResNet on a DAG plan over gloo CPU ranks (`models/cnn/resnet.py`,
`core/plan.py`'s explicit-producer reshards and the residual-add
reshard, `layers.global_avg_pool` under a CFSharding) against the JAX
reference with the same plan on as many host devices
(`jax_mesh_oracles.py resnet`).

The tiny config (`input_hw=32, stages=(1, 1), widths=(8, 16)`) at batch
2, on 2 and 4 ranks, under the reference's uniform N x H sharding and
under plans the reference's `plan_graph` solves (LASSEN, or the H100
preset's constants) for it; and a `stages=(1, 2)` variant, whose res3b is
the only kind of block with an identity shortcut.  Together the solved
plans hold a projection whose layout differs from its 2c's (the add
reshards the shortcut), an identity shortcut across a layout change, a
last block under a CFSharding before the head (the pool gathers the
channels), CF layers on the data axis, and sample-parallel layers whose
labels are cut along the head's batch axes.

The loss within 3e-5 relative of the reference's, and every param's
gradient within rtol 5e-4 / atol 5e-5 of it: the reference's own
tolerances for its ResNet on a mesh (`tests/dist_checks.py`); f32 sums in
other orders put the largest difference near 1.1e-5 of each leaf's
largest magnitude.  As in `test_torch_plan.py`, the reference is its run with the same
plan on host devices, except for a plan whose every BN normalises as one
device does: its function is the one-device ResNet's, and it is held
against the reference's one-device run, because the reference's own
gradients under GSPMD-partitioned sample-parallel layers are off (ROADMAP
Queue 3).  One plan ends in a CF x spatial layer, whose global average
pool the reference cannot run on its mesh (its `shard_map` over the
spatial axes leaves the CF axis out of its specs); that case runs at the
'global' BN scope, where its function is the one-device ResNet's.  Each
rank's forward reshards send the bytes the plan's `reshard_report`
(residual adds included) predicts.

The N-step trajectory: 3 SGD-momentum steps (lr 0.1, warmup(1) + cosine)
of the tiny ResNet under a plan solved for 2 ranks (H100 preset,
hillclimb, no CF: replicated layers, then sample-parallel ones behind
slice reshards), against the reference's one-device 3 steps from the
same params and batches: losses and params within rtol 1e-4, atol 1e-6
(`test_torch_meshnet.py`'s trajectory tolerances), equal on both ranks.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

import jax_mesh_oracles
import torch_dist_cases as cases
from repro.core import perfmodel as jpm
from repro.core import plan as jplan
from repro.models.cnn import resnet as jres
from repro_torch.core import perfmodel as tpm
from repro_torch.core import plan as tplan
from repro_torch.core.spatial_conv import ConvSharding
from repro_torch.models.cnn import resnet as tres


@pytest.fixture(scope="module", autouse=True)
def _reference_eta_unmeasured():
    with jax_mesh_oracles.reference_eta_unmeasured():
        yield


TINY = {"name": "tiny", "input_hw": 32, "n_classes": 10, "stages": (1, 1),
        "widths": (8, 16)}
TINY2 = dict(TINY, name="tiny2", stages=(1, 2))
J_H100 = jpm.Machine(**{f.name: getattr(tpm.H100, f.name)
                        for f in dataclasses.fields(tpm.H100)})
# (case, config, mesh dims, how its plan is solved: None for the uniform
# plan, else (machine, search, allow CF), at the case's batch 2)
PLAN_CASES = [
    ("uniform_1x2", TINY, (1, 2), None),
    ("uniform_2x2", TINY, (2, 2), None),
    ("greedy_2x2", TINY, (2, 2), (jpm.LASSEN, "greedy", True)),
    ("greedy_1x4", TINY, (1, 4), (jpm.LASSEN, "greedy", True)),
    ("hillclimb_2x2", dict(TINY, bn_scope="global"), (2, 2),
     (jpm.LASSEN, "hillclimb", True)),
    ("identity_1x4", TINY2, (1, 4), (jpm.LASSEN, "hillclimb", True)),
]
TRAJ = ("trajectory_1x2", TINY, (1, 2), (J_H100, "hillclimb", False))
BATCH, STEPS = 2, 3
LOSS_RTOL, RTOL, ATOL = 3e-5, 5e-4, 5e-5
TRAJ_RTOL, TRAJ_ATOL = 1e-4, 1e-6


def _shape(dims):
    return {"data": dims[0], "model": dims[1]}


def _spec(case):
    _, cfg, dims, how = case
    if how is None:
        return None
    machine, search, cf = how
    c = jres.ResNetConfig(**cfg)
    plan = jplan.plan_graph(machine, jres.resnet_graph(BATCH, c),
                            jres.layer_specs(BATCH, c), _shape(dims),
                            search=search, allow_channel_filter=cf)
    return plan.to_spec(_shape(dims))


def _port_plan(rec):
    cfg = tres.ResNetConfig(**rec["cfg"])
    shape = _shape(rec["dims"])
    if rec["spec"] is None:
        return tres.network_plan(cfg, ConvSharding(
            batch_axes=("data",), h_axis="model"), shape)
    return tplan.compile_plan(tplan.dists_from_spec(rec["spec"]),
                              tres.all_specs(BATCH, cfg), shape,
                              graph=tres.resnet_graph(BATCH, cfg))


def _one_device_bn(plan, scope: str) -> bool:
    """Whether every BN of `plan` takes the statistics one device would:
    of the whole batch and image (every layer but the pool has a BN)."""
    for lp in plan.layers.values():
        if lp.name == "pool1":
            continue
        sh = lp.out_sharding
        batch, spatial = bool(sh.batch_axes), sh.is_spatial
        if getattr(sh, "cf_axis", None) is not None:
            ok = scope == "global" or not batch and (
                scope == "spatial" or not spatial)
        else:
            ok = not spatial or scope == "global" or (
                scope == "spatial" and not batch)
        if not ok:
            return False
    return True


@pytest.fixture(scope="module")
def resnet_runs(tmp_path_factory):
    """The JAX oracle (in two processes) and the gloo ranks of every mesh,
    all at once."""
    d = tmp_path_factory.mktemp("resnet")
    recs, flat = [], {}
    for i, case in enumerate(PLAN_CASES + [TRAJ]):
        name, cfg, dims, _ = case
        rec = {"name": name, "batch": BATCH, "dims": list(dims),
               "spec": _spec(case), "cfg": dict(cfg)}
        if case is TRAJ:
            rec["steps"] = STEPS
        rec["one_device"] = case is TRAJ or _one_device_bn(
            _port_plan(rec), cfg.get("bn_scope", "local"))
        recs.append(rec)
        params = jres.init(jax.random.PRNGKey(i), jres.ResNetConfig(**cfg))
        flat.update({f"{name}/{j}": np.asarray(v)
                     for j, v in enumerate(jax.tree.leaves(params))})
    (d / "resnet.json").write_text(json.dumps(recs))
    np.savez(d / "inputs.npz", **flat)
    runs = [("resnet", dims) for dims in sorted({c[2] for c in PLAN_CASES})]
    runs.append(("resnet_trajectory", TRAJ[2]))
    procs = {}
    for what, dims in runs:
        sub = d / f"{what}{dims[0]}x{dims[1]}"
        sub.mkdir()
        for f in ("resnet.json", "inputs.npz"):
            (sub / f).write_bytes((d / f).read_bytes())
        procs[what, dims] = (sub, cases.start(what, dims, str(sub)))
    oracles = [jax_mesh_oracles.popen("resnet", str(d), f"{k}/2")
               for k in range(2)]
    want = {}
    for k, p in enumerate(oracles):
        jax_mesh_oracles.wait(p)
        want.update(np.load(d / f"resnet{k}.npz"))
    got = {key: cases.collect(p, key[1], str(sub))
           for key, (sub, p) in procs.items()}
    return want, got, {r["name"]: r for r in recs}


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_loss_and_grads_match_the_reference(resnet_runs, case):
    want, got, recs = resnet_runs
    name, cfg, dims, how = case
    outs = got["resnet", dims]
    rec = recs[name]
    plan = _port_plan(rec)
    ref = f"{name}/one" if rec["one_device"] else name
    n_leaves = sum(k.startswith(f"{ref}/grad") for k in want)
    assert n_leaves == len(jax.tree.leaves(jres.init(
        jax.random.PRNGKey(0), jres.ResNetConfig(**cfg))))
    for o in outs:                    # one loss and grad on every rank
        np.testing.assert_array_equal(o[f"{name}/loss"],
                                      outs[0][f"{name}/loss"])
        for i in range(n_leaves):
            np.testing.assert_array_equal(o[f"{name}/grad{i}"],
                                          outs[0][f"{name}/grad{i}"])
        assert int(o[f"{name}/sent"]) == int(o[f"{name}/want_sent"])
    loss, want_loss = float(outs[0][f"{name}/loss"]), \
        float(want[f"{ref}/loss"])
    assert np.isfinite(loss) and \
        abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), \
        (loss, want_loss)
    for i in range(n_leaves):
        np.testing.assert_allclose(outs[0][f"{name}/grad{i}"],
                                   want[f"{ref}/grad{i}"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"leaf {i} ({ref})")
    assert int(outs[0][f"{name}/n_reshards"]) == plan.n_reshards
    if how is not None:
        # the plan the ranks ran is the one the reference compiles from
        # the same Dists against its graph: the same flagged reshards
        c = jres.ResNetConfig(**cfg)
        jg = jres.resnet_graph(BATCH, c)
        js = [jg.nodes[s.name]["layer"] for s in tres.all_specs(
            BATCH, tres.ResNetConfig(**cfg))]
        jp = jplan.compile_plan(jplan.dists_from_spec(rec["spec"]), js,
                                _shape(dims), graph=jg)
        assert plan.describe() == jp.describe()


def test_the_cases_cover_the_dag_reshards(resnet_runs):
    """Among the solved plans: a projection whose layout differs from its
    2c's, an identity shortcut across a layout change, and a last block
    under a CFSharding; each residual-add reshard is in the report."""
    _, got, recs = resnet_runs
    seen = set()
    for name, cfg, dims, how in PLAN_CASES:
        if how is None:
            continue
        plan = _port_plan(recs[name])
        c = tres.ResNetConfig(**cfg)
        shape = _shape(dims)
        report = plan.reshard_report(tres.all_specs(BATCH, c), shape,
                                     flow=tres.flow(c))
        adds = {r["layer"] for r in report if r["layer"].endswith("(add)")}
        for src, dst, kind in tres.flow(c):
            moved = tplan._layout(plan.out_sharding(src), shape) != \
                tplan._layout(plan.out_sharding(dst), shape)
            if kind == "add" and moved:
                seen.add("projection" if src.endswith("branch1")
                         else "identity")
                assert f"{dst} (add)" in adds
        if getattr(plan.sharding(tres.last_layer(c)), "cf_axis", None):
            seen.add("cf_last")
        assert int(got["resnet", dims][0][f"{name}/n_moves"]) == len(report)
    assert seen == {"projection", "identity", "cf_last"}, seen


def test_three_step_sgd_trajectory_matches_the_one_device_reference(
        resnet_runs):
    want, got, recs = resnet_runs
    name = TRAJ[0]
    outs = got["resnet_trajectory", TRAJ[2]]
    plan = _port_plan(recs[name])
    kinds = {("N" if lp.sharding.batch_axes else "R")
             for lp in plan.layers.values()}
    assert kinds == {"N", "R"} and plan.n_reshards > 0
    for o in outs:
        for k in o:
            np.testing.assert_array_equal(o[k], outs[0][k])
    np.testing.assert_allclose(outs[0][f"{name}/losses"],
                               want[f"{name}/losses"], rtol=TRAJ_RTOL,
                               atol=TRAJ_ATOL)
    n = sum(k.startswith(f"{name}/param") for k in want)
    assert n == sum(k.startswith(f"{name}/param") for k in outs[0]) > 0
    for i in range(n):
        np.testing.assert_allclose(outs[0][f"{name}/param{i}"],
                                   want[f"{name}/param{i}"],
                                   rtol=TRAJ_RTOL, atol=TRAJ_ATOL,
                                   err_msg=f"param {i}")
