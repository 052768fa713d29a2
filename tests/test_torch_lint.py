"""The port's plan linter (`repro_torch.analysis.lint`) against the
reference's (`repro.analysis.lint`), in process: both are pure Python over
the same plan objects.

Every case is built twice from the same recipe, once on each package's
objects: the solved and the resharding plans of `tests/test_analysis.py`,
each hand-broken plan of that file (and two more: a first layer marked
reshard_in, a plan compiled without a machine), and every bench workload
of the registry solved on 1x2 and 2x2 under the reference's machine
constants (TPU_V5E's, copied into the port's `Machine`).  The port's
`lint_plan` gives the same multiset of (rule, severity, layer), and
`format_findings` renders both lists to the same text.
"""
import collections
import dataclasses
import types

import pytest

import jax_mesh_oracles
from repro import analysis as janalysis
from repro.analysis import workloads as jworkloads
from repro.core import perfmodel as jpm
from repro.core import plan as jplan
from repro.core.spatial_conv import ConvSharding as JConvSharding
from repro_torch import analysis as tanalysis
from repro_torch.analysis import workloads as tworkloads
from repro_torch.core import perfmodel as tpm
from repro_torch.core import plan as tplan
from repro_torch.core.spatial_conv import ConvSharding as TConvSharding

MESH = {"data": 2, "model": 2}
REF = types.SimpleNamespace(pm=jpm, plan=jplan, ConvSharding=JConvSharding,
                            analysis=janalysis, workloads=jworkloads,
                            machine=jpm.TPU_V5E)
PORT = types.SimpleNamespace(
    pm=tpm, plan=tplan, ConvSharding=TConvSharding, analysis=tanalysis,
    workloads=tworkloads,
    machine=tpm.Machine(**{f.name: getattr(jpm.TPU_V5E, f.name)
                           for f in dataclasses.fields(tpm.Machine)}))


@pytest.fixture(scope="module", autouse=True)
def _reference_eta_unmeasured():
    with jax_mesh_oracles.reference_eta_unmeasured():
        yield


def specs3(k):
    return [k.pm.ConvLayer("a", n=4, c=8, h=16, w=16, f=8),
            k.pm.ConvLayer("b", n=4, c=8, h=16, w=16, f=16),
            k.pm.ConvLayer("c", n=4, c=16, h=16, w=16, f=8)]


def resharding_plan(k, machine=True):
    """a: batch x H, b/c: H x W — one priced reshard into 'b'."""
    d1 = k.plan._sharding_to_dist(
        k.ConvSharding(batch_axes=("data",), h_axis="model"))
    d2 = k.plan._sharding_to_dist(
        k.ConvSharding(h_axis="model", w_axis="data"))
    return k.plan.compile_plan({"a": d1, "b": d2, "c": d2}, specs3(k), MESH,
                               machine=k.machine if machine else None)


def _with_layer(plan, name, **kw):
    return dataclasses.replace(plan, layers={
        **plan.layers, name: dataclasses.replace(plan.layers[name], **kw)})


def _with_shuffle(plan, name, value):
    shuf = dict(plan.predicted["shuffle_per_layer"])
    shuf[name] = value
    return dataclasses.replace(
        plan, predicted={**plan.predicted, "shuffle_per_layer": shuf})


def _with_half_limit(plan):
    mem = dict(plan.predicted["memory"])
    mem["limit_bytes"] = mem["peak_bytes"] / 2
    return dataclasses.replace(plan,
                               predicted={**plan.predicted, "memory": mem})


def _lint(k, plan, specs=None):
    return k.analysis.lint_plan(plan, specs=specs if specs is not None
                                else specs3(k), mesh_shape=MESH)


def _divisibility(k):
    spec = k.pm.ConvLayer("a", n=4, c=8, h=16, w=16, f=8)
    plan = k.plan.compile_plan(
        {"a": k.plan._sharding_to_dist(
            k.ConvSharding(batch_axes=("data",), h_axis="model"))},
        [spec], MESH)
    return _lint(k, plan, [k.pm.ConvLayer("a", n=3, c=8, h=16, w=16, f=8)])


# name -> findings of the case built on package k (and the rule it fires)
CASES = {
    "solved": (lambda k: _lint(k, k.plan.plan_line(k.machine, specs3(k),
                                                   MESH)), None),
    "resharding": (lambda k: _lint(k, resharding_plan(k)), None),
    "dropped_reshard": (lambda k: _lint(k, _with_layer(
        resharding_plan(k), "b", reshard_in=False)), "reshard-missing"),
    "first_layer_reshard": (lambda k: _lint(k, _with_layer(
        resharding_plan(k), "a", reshard_in=True)), "reshard-spurious"),
    "unpriced_reshard": (lambda k: _lint(k, _with_shuffle(
        resharding_plan(k), "b", 0.0)), "reshard-unpriced"),
    "phantom_shuffle": (lambda k: _lint(k, _with_shuffle(
        resharding_plan(k), "c", 1e-3)), "phantom-shuffle"),
    "memory_overrun": (lambda k: _lint(k, _with_half_limit(
        resharding_plan(k))), "memory-fit"),
    "non_load_bearing_demotion": (lambda k: _lint(k, _with_layer(
        resharding_plan(k), "a",
        solved=resharding_plan(k).layers["a"].dist)),
        "demotion-not-load-bearing"),
    "divisibility": (_divisibility, "divisibility"),
    "no_machine": (lambda k: _lint(k, resharding_plan(k, machine=False)),
                   "no-cost-report"),
}


def _key(findings):
    return collections.Counter((f.rule, f.severity, f.layer)
                               for f in findings)


def _as_reference(findings):
    return [janalysis.Finding(**f.to_json()) for f in findings]


def _check_same(ref, port):
    assert _key(port) == _key(ref), (
        [f.to_json() for f in ref], [f.to_json() for f in port])
    assert tanalysis.format_findings(port) == \
        janalysis.format_findings(_as_reference(port))
    assert janalysis.format_findings(_as_reference(port)) == \
        janalysis.format_findings(ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lint_matches_the_reference(case):
    build, rule = CASES[case]
    ref, port = build(REF), build(PORT)
    _check_same(ref, port)
    if rule is None:
        assert not [f for f in port if f.severity == "error"]
    else:
        assert rule in [f.rule for f in port]


@pytest.mark.parametrize("dims", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("name", sorted(jworkloads.WORKLOADS))
def test_workload_plans_lint_as_the_reference(name, dims):
    mesh = {"data": dims[0], "model": dims[1]}
    got = {}
    for side, k in (("ref", REF), ("port", PORT)):
        try:
            plan, specs, _ = k.workloads.solve_workload(name, k.machine,
                                                        mesh)
        except ValueError as e:         # PlanError / CapacityError
            got[side] = (type(e).__name__, str(e))
            continue
        got[side] = (plan.to_spec(mesh),
                     k.analysis.lint_plan(plan, specs=specs,
                                          mesh_shape=mesh))
    if isinstance(got["ref"][0], str):
        # the memory-fit recipe has no plan on this mesh: both refuse alike
        assert got["port"] == got["ref"]
        return
    assert got["port"][0] == got["ref"][0]
    _check_same(got["ref"][1], got["port"][1])
    assert not [f for f in got["port"][1] if f.severity == "error"]


def test_registry_is_the_reference_s():
    assert list(tworkloads.WORKLOADS) == list(jworkloads.WORKLOADS)
    for name, w in tworkloads.WORKLOADS.items():
        j = jworkloads.WORKLOADS[name]
        assert (w.batch, w.recipe, w.needs_model_axis) == \
            (j.batch, j.recipe, j.needs_model_axis)
        assert dataclasses.asdict(w.cfg) == dataclasses.asdict(j.cfg)


def test_finding_json_and_table():
    f = tanalysis.Finding("warning", "payload-mismatch", layer="conv1_1",
                          message="priced 10 B but moves 20 B",
                          fix="re-derive")
    assert f.to_json() == janalysis.Finding(**f.to_json()).to_json()
    assert tanalysis.format_findings([]) == "no findings"
    assert tanalysis.error_count([f]) == 0
    assert tanalysis.error_count(
        [f, tanalysis.Finding("error", "x", message="m")]) == 1
