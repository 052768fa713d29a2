"""The branchy-network solve (`core/strategy.py` `solve_dag`,
`solve_dag_beam`; `core/plan.py` `plan_graph`, `compile_plan(graph=)`)
against the reference's, in process (both are pure Python over the same
numbers).

ResNet-50 at batches 1, 2 and 32 and the reference's SMOKE config at
batches 1 and 2, on the meshes {model: 2}, {data: 2, model: 2} and
{model: 4}, on the H100 preset's and LASSEN's constants (the reference's
Machine built from the port's fields):

- `solve_dag` and `solve_dag_beam` over the same executable candidates
  give the same Dist for every layer;
- `plan_graph` under `--search` greedy, beam:4 and hillclimb (seeded)
  gives the same plan: the same `to_spec()` JSON and the same
  `describe()` text (flagged reshard points, CF modes, demotion notes,
  predicted cost and memory);
- `plan_graph` under a memory limit of 0.7 times the unconstrained plan's
  predicted peak gives the same plan, or raises the same error;
- `NetworkPlan.input_spec` gives every layer's input placement as the
  reference's does (SMOKE at batch 1, each search mode).

The worked case, full-width ResNet-50 at batch 32 on {model: 2} on the
H100 preset: N:model through res5a_branch2a and on all four projections,
CF:model from res5a_branch2b on (channel for 2a/2b, filter for 2c), one
flagged reshard point (into res5a_branch2b), 10.478 ms predicted, 2.23
GiB a device; the port's reshard report lists what it executes: that
reshard and the all-to-all that joins res5a's N-sharded projection to
its CF-sharded 2c output before the add, which GSPMD inserts unflagged
in the reference.
"""
import dataclasses
import json
from types import SimpleNamespace

import pytest

import jax_mesh_oracles
from repro.configs import resnet50 as jcfgs
from repro.core import perfmodel as jpm
from repro.core import plan as jplan
from repro.core import strategy as jst
from repro.models.cnn import resnet as jres
from repro_torch.configs import resnet50 as tcfgs
from repro_torch.core import perfmodel as tpm
from repro_torch.core import plan as tplan
from repro_torch.core import strategy as tst
from repro_torch.models.cnn import resnet as tres


@pytest.fixture(scope="module", autouse=True)
def _reference_eta_unmeasured():
    with jax_mesh_oracles.reference_eta_unmeasured():
        yield


MACHINES = {name: (jpm.Machine(**{f.name: getattr(m, f.name)
                                  for f in dataclasses.fields(m)}), m)
            for name, m in (("h100", tpm.H100), ("lassen", tpm.LASSEN))}
CASES = [("resnet50", 1), ("resnet50", 2), ("resnet50", 32), ("smoke", 1),
         ("smoke", 2)]
CFGS = {"resnet50": (jres.RESNET50, tres.RESNET50),
        "smoke": (jcfgs.SMOKE, tcfgs.SMOKE)}
MESHES = [{"model": 2}, {"data": 2, "model": 2}, {"model": 4}]
SEARCHES = ["greedy", "beam:4", "hillclimb"]


def _mesh_id(shape):
    return "x".join(f"{k}{v}" for k, v in shape.items())


def _solve(lib, machine, graph, specs, shape, **kw):
    try:
        plan = lib.plan_graph(machine, graph, specs, shape, **kw)
    except ValueError as e:             # CapacityError, PlanError
        return type(e).__name__, str(e)
    return json.dumps(plan.to_spec(shape)), plan.describe()


def _dists(d):
    return {k: (v.name, dict(v.dims)) for k, v in d.items()}


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("cfg,n", CASES, ids=[f"{c}-b{n}" for c, n in CASES])
def test_dag_solvers_and_plan_graph_pick_the_reference_plan(cfg, n, shape):
    jcfg, tcfg = CFGS[cfg]
    jg, tg = jres.resnet_graph(n, jcfg), tres.resnet_graph(n, tcfg)
    js, ts = jres.layer_specs(n, jcfg), tres.layer_specs(n, tcfg)
    for mname, (jm, tm) in MACHINES.items():
        for wide, jsolve, tsolve, kw in (
                (False, jst.solve_dag, tst.solve_dag, {}),
                (True, jst.solve_dag_beam, tst.solve_dag_beam,
                 {"width": 4})):
            want = jsolve(jm, jg, shape, candidate_fn=lambda l: (
                jplan.executable_candidates(l, shape, wide=wide)), **kw)
            got = tsolve(tm, tg, shape, candidate_fn=lambda l: (
                tplan.executable_candidates(l, shape, wide=wide)), **kw)
            assert list(got) == list(want)
            assert _dists(got) == _dists(want), (mname, wide)
        for search in SEARCHES:
            want = _solve(jplan, jm, jg, js, shape, search=search)
            got = _solve(tplan, tm, tg, ts, shape, search=search)
            assert got == want, (mname, search)
        peak = jplan.plan_graph(jm, jg, js, shape).predicted["memory"][
            "peak_bytes"]
        want = _solve(jplan, jm, jg, js, shape, mem_limit=0.7 * peak)
        got = _solve(tplan, tm, tg, ts, shape, mem_limit=0.7 * peak)
        assert got == want, (mname, "mem_limit")


def test_compile_plan_flags_reshards_against_graph_predecessors():
    """The same Dist map compiled with and without the graph: with it, a
    projection is flagged against the block input, not against the
    previous layer in the list, as the reference flags it."""
    n, shape = 1, {"model": 2}
    jg, tg = jres.resnet_graph(n, jcfgs.SMOKE), tres.resnet_graph(n,
                                                                  tcfgs.SMOKE)
    ts = tres.all_specs(n, tcfgs.SMOKE)
    js = [jg.nodes[s.name]["layer"] for s in ts]
    dists = jplan.plan_graph(MACHINES["lassen"][0], jg, jres.layer_specs(
        n, jcfgs.SMOKE), shape).to_spec(shape)
    d = tplan.dists_from_spec(dists)
    for graph_j, graph_t in ((jg, tg), (None, None)):
        want = jplan.compile_plan(jplan.dists_from_spec(dists), js, shape,
                                  graph=graph_j)
        got = tplan.compile_plan(d, ts, shape, graph=graph_t)
        assert [lp.reshard_in for lp in got.layers.values()] == \
            [lp.reshard_in for lp in want.layers.values()]
        assert got.describe() == want.describe()


def test_worked_case_h100_batch32_model2():
    shape = {"model": 2}
    plan = tplan.plan_graph(tpm.H100, tres.resnet_graph(32),
                            tres.layer_specs(32), shape)
    names = list(plan.layers)
    cf = [n for n in names if getattr(plan.sharding(n), "cf_axis", None)]
    assert cf == [f"res5{b}_branch2{c}" for b in "abc" for c in "abc"][1:]
    assert all(plan.sharding(n).batch_axes == ("model",)
               for n in names if n not in cf)
    assert [plan.sharding(n).mode for n in cf] == \
        ["channel", "filter"] + ["channel", "channel", "filter"] * 2
    assert [n for n in names if plan.layers[n].reshard_in] == \
        ["res5a_branch2b"]
    assert f"{plan.predicted['total'] * 1e3:.3f}" == "10.478"
    assert f"{plan.predicted['memory']['peak_bytes'] / 2**30:.2f}" == "2.23"
    report = plan.reshard_report(tres.all_specs(32), shape,
                                 flow=tres.flow())
    assert [r["layer"] for r in report] == ["res5a_branch2b",
                                           "res5a_branch2c (add)"]
    for r in report:
        assert r["steps"] == [("all_to_all", "model", 3, 0)] or \
            r["steps"] == [("all_to_all", "model", 0, 3)]
        assert r["bytes"] == 16 * 7 * 7 * 2048 * 4 // 2
    lines = tplan.reshard_lines(report)
    assert lines.startswith("reshards: 2") and "(add)" in lines


def _axes(e):
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
def test_input_spec_equals_the_reference(shape):
    """`NetworkPlan.input_spec`: every layer's input placement, fitted to
    its geometry, as the reference's PartitionSpec (axes compared as
    tuples: jax writes a one-axis tuple as the bare name)."""
    n = 1
    for search in SEARCHES:
        jp = jplan.plan_graph(MACHINES["lassen"][0], jres.resnet_graph(
            n, jcfgs.SMOKE), jres.layer_specs(n, jcfgs.SMOKE), shape,
            search=search)
        tp = tplan.plan_graph(tpm.LASSEN, tres.resnet_graph(n, tcfgs.SMOKE),
                              tres.layer_specs(n, tcfgs.SMOKE), shape,
                              search=search)
        for l in tres.all_specs(n, tcfgs.SMOKE):
            for geom in ((l.h, l.w, l.k, l.s), (l.h, l.w, 1, 1)):
                got = tp.input_spec(l.name, *geom, mesh=shape)
                want = tuple(jp.input_spec(l.name, *geom,
                                           mesh=SimpleNamespace(shape=shape)))
                assert [_axes(e) for e in got] == \
                    [_axes(e) for e in want], (search, l.name, geom)
