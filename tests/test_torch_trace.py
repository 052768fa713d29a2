"""Tracing and attribution (`repro_torch.core.trace`,
`NetworkPlan.attribution_report`) against the reference's, on the CPU.

- StepTrace JSON (``repro/step_trace@1``) written by either package loads
  in the other; the Chrome-trace export and the per-layer sums agree.
- `attribution_report` of the same compiled plan and trace is the same in
  both packages to 1e-9, and `format_attribution` renders it alike.
- `annotate` is the identity on values (forward and gradient), names its
  range `<layer>/<region>` in the profiler, and a region nested in one of
  the same name opens no second range.
- `meshnet.layer_fns` composed is `apply`, layer for layer.
- The timing helpers: `time_fn(return_samples=)`, `interleaved_samples`,
  `interleaved_min`.
- 2 gloo ranks: `trace_plan` of the mesh1k SMOKE net under the uniform
  plan and an auto plan with CF layers and a reshard covers every layer
  with bwd_s >= 0, the same numbers on both ranks
  (`tests/torch_dist_cases.py trace`).
- The CLI's `--profile` on `--device cpu`.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

import jax_mesh_oracles
import torch_dist_cases
from repro.core import perfmodel as jpm
from repro.core import plan as jplan
from repro.core import trace as jtrace
from repro.core.distribution import Dist as JDist
from repro.models.cnn import meshnet as jmesh
from repro_torch.core import collectives
from repro_torch.core import perfmodel as tpm
from repro_torch.core import plan as tplan
from repro_torch.core import trace as ttrace
from repro_torch.core.distribution import Dist as TDist
from repro_torch.models.cnn import meshnet as tmesh
from repro_torch.utils import interleaved_min, interleaved_samples, time_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS22 = {"data": 2, "model": 2}
NET = {"input_hw": 32, "in_channels": 4, "convs_per_block": 1,
       "widths": (8, 16)}


@pytest.fixture(scope="module", autouse=True)
def _reference_eta_unmeasured():
    with jax_mesh_oracles.reference_eta_unmeasured():
        yield


def _trace(lib, layers, fwd=1e-3, bwd=2e-3):
    rows = {n: {"fwd_s": fwd * (i + 1), "bwd_s": bwd / (i + 1),
                "fwd_bwd_s": fwd * (i + 1) + bwd / (i + 1)}
            for i, n in enumerate(layers)}
    step = {"fwd_s": fwd * len(layers), "bwd_s": bwd * len(layers),
            "fwd_bwd_s": (fwd + bwd) * len(layers)}
    return lib.StepTrace(layers=rows, step=step, meta={"backend": "test"})


# ------------------------------------------------------------ StepTrace --
def test_steptrace_json_loads_across_packages(tmp_path):
    names = ["conv1_1", "conv2_1", "pred"]
    j = _trace(jtrace, names)
    j.save(str(tmp_path / "j.json"))
    t = ttrace.StepTrace.load(str(tmp_path / "j.json"))
    assert t.to_dict() == json.loads(json.dumps(j.to_dict()))
    assert t.layer_sum_s == pytest.approx(j.layer_sum_s, rel=1e-15)
    t.meta["card"] = "a card, 700.00 W"
    t.save(str(tmp_path / "t.json"))
    j2 = jtrace.StepTrace.load(str(tmp_path / "t.json"))
    assert j2.to_dict() == t.to_dict()
    assert ttrace.SCHEMA == jtrace.SCHEMA == "repro/step_trace@1"
    with pytest.raises(ValueError, match="not a step trace"):
        ttrace.StepTrace.from_dict({"schema": "x@9", "layers": {},
                                    "step": {}})


def test_chrome_trace_matches_reference(tmp_path):
    names = ["conv1_1", "conv2_1", "pred"]
    t, j = _trace(ttrace, names), _trace(jtrace, names)
    assert t.chrome_trace() == j.chrome_trace()
    xs = [e for e in t.chrome_trace()["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in xs] == names + names[::-1]
    t.save_chrome(str(tmp_path / "t.chrome.json"))
    with open(tmp_path / "t.chrome.json") as f:
        assert json.load(f)["traceEvents"]
    assert ttrace.REGIONS == jtrace.REGIONS


# ---------------------------------------------------------- attribution --
PLANS = {
    "hybrid": {"conv1_1": ("hybrid", {"N": ("data",), "H": ("model",)}),
               "conv2_1": ("sample", {"N": ("data", "model")}),
               "pred": ("hybrid", {"N": ("data",), "H": ("model",)})},
    "cf": {"conv1_1": ("hybrid", {"N": ("data",), "H": ("model",)}),
           "conv2_1": ("cf", {"N": ("data",), "C": ("model",),
                              "F": ("model",)}),
           "pred": ("sample", {"N": ("data", "model")})},
}


def _compiled(name):
    m = dataclasses.asdict(tpm.LASSEN)
    out = []
    for lib, pm, Dist, mesh in ((jplan, jpm, JDist, jmesh),
                                (tplan, tpm, TDist, tmesh)):
        specs = mesh.layer_specs(mesh.MeshNetConfig("t", **NET), 4)
        dists = {k: Dist(n, d) for k, (n, d) in PLANS[name].items()}
        out.append(lib.compile_plan(dists, specs, MS22,
                                    machine=pm.Machine(**m)))
    return out, [l.name for l in specs]


def _close(a, b, rel=1e-9):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k], rel)
    elif isinstance(a, float) and isinstance(b, float):
        assert b == pytest.approx(a, rel=rel, nan_ok=True)
    else:
        assert a == b


@pytest.mark.parametrize("name", sorted(PLANS))
@pytest.mark.parametrize("scale", [1.0, 300.0])
def test_attribution_report_matches_reference(name, scale):
    (jp, tp), names = _compiled(name)
    assert set(tp.predicted["layer_costs"]) == set(names)
    jt = _trace(jtrace, names, fwd=scale * 1e-5, bwd=scale * 3e-5)
    tt = ttrace.StepTrace.from_dict(json.loads(json.dumps(jt.to_dict())))
    jr = jp.attribution_report(jt)
    tr = tp.attribution_report(tt)
    json.dumps(tr)                  # json-clean as it is
    _close(jr, tr)
    assert tr["worst_term"] in tr["terms"]
    assert ttrace.format_attribution(tr) == jtrace.format_attribution(jr)
    if scale > 100:
        assert tr["flagged"] == names
        assert "<-- drift" in ttrace.format_attribution(tr)


def test_attribution_needs_predictions_and_every_layer():
    (_, tp), names = _compiled("hybrid")
    bare = dataclasses.replace(tp, predicted=None)
    with pytest.raises(tplan.PlanError, match="machine"):
        bare.attribution_report(_trace(ttrace, names))
    with pytest.raises(tplan.PlanError, match="no measurement"):
        tp.attribution_report(_trace(ttrace, names[:-1]))


# ----------------------------------------------------------- annotation --
def test_annotate_is_identity_and_names_its_range():
    from torch.profiler import ProfilerActivity, profile

    def f(x):
        with ttrace.layer_context("conv9_9"):
            with ttrace.annotate("halo_exchange", x):
                with ttrace.annotate("halo_exchange", x):   # no 2nd range
                    y = x * 2 + 1
            with ttrace.annotate("reshard", x):
                return collectives.all_gather(y, None, "model", 0)

    x = torch.arange(6.0, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = f(x)
    assert torch.equal(y.detach(), torch.arange(6.0) * 2 + 1)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(g, torch.full((6,), 2.0))
    names = [e.name for e in prof.events()]
    assert names.count("conv9_9/halo_exchange") == 1
    assert names.count("conv9_9/reshard") == 1
    assert names.count("conv9_9") == 1
    assert ttrace.current_layer() is None


def test_layer_context_qualifies_regions():
    assert ttrace.qualified("reshard") == "reshard"
    with ttrace.layer_context("conv2_1"):
        assert ttrace.current_layer() == "conv2_1"
        assert ttrace.qualified("reshard") == "conv2_1/reshard"
        assert ttrace.qualified("reshard", "pred") == "pred/reshard"
        with ttrace.layer_context("inner"):
            assert ttrace.qualified("x") == "inner/x"
    assert ttrace.current_layer() is None


def test_layer_fns_compose_to_apply():
    cfg = tmesh.MeshNetConfig("t", **NET)
    model = tmesh.MeshNet(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    x = torch.randn(2, 32, 32, 4, generator=torch.Generator().manual_seed(1))
    fns = tmesh.layer_fns(cfg)
    assert [n for n, _ in fns] == tmesh.layer_names(cfg) == \
        jmesh.layer_names(jmesh.MeshNetConfig("t", **NET))
    y = x
    for (_, fn), lp in zip(fns, model.params()):
        y = fn(lp, y)
    assert torch.equal(y, tmesh.apply(model.params(), x, cfg))


# -------------------------------------------------------------- timing --
def test_time_fn_return_samples_and_interleaved():
    est = time_fn(lambda: torch.zeros(4), reps=2)
    est2, samples = time_fn(lambda: torch.zeros(4), reps=3,
                            return_samples=True)
    assert est > 0 and est2 > 0 and len(samples) == 3
    assert all(s > 0 for s in samples)
    fns = {"a": lambda: torch.zeros(2), "b": lambda: torch.ones(2)}
    s = interleaved_samples(fns, reps=2, rounds=3)
    assert set(s) == {"a", "b"} and all(len(v) == 3 for v in s.values())
    m = interleaved_min(fns, reps=1, rounds=2)
    assert set(m) == {"a", "b"} and all(v > 0 for v in m.values())


# ------------------------------------------------------------ two ranks --
def test_trace_plan_on_two_ranks(tmp_path):
    ranks = torch_dist_cases.run("trace", (1, 2), str(tmp_path))
    names = ["conv1_1", "conv2_1", "conv3_1", "pred"]
    for key in torch_dist_cases.TRACE_PLANS:
        for name in names:
            fwd = float(ranks[0][f"{key}/{name}/fwd_s"])
            bwd = float(ranks[0][f"{key}/{name}/bwd_s"])
            fb = float(ranks[0][f"{key}/{name}/fwd_bwd_s"])
            assert fwd > 0 and bwd >= 0 and fb > 0
            assert bwd == pytest.approx(max(fb - fwd, 0.0), abs=1e-15)
            for k in ("fwd_s", "bwd_s", "fwd_bwd_s"):
                assert ranks[1][f"{key}/{name}/{k}"] == \
                    ranks[0][f"{key}/{name}/{k}"]   # the max over ranks
        assert all(v > 0 for v in ranks[0][f"{key}/step"][[0, 2]])
    assert int(ranks[0]["auto/n_reshards"]) >= 1
    assert "CF:model" in str(ranks[0]["auto/kinds"])
    rep = json.loads(str(ranks[0]["auto/report"]))
    assert list(rep["per_layer"]) == names
    assert all(math.isfinite(r["ratio_total"])
               for r in rep["per_layer"].values())
    assert "uniform/report" not in ranks[0]


# ------------------------------------------------------------------ CLI --
def test_cli_profile(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mesh1k", "--smoke", "--batch", "2", "--device", "cpu",
         "--strategy", "auto", "--profile", "tr.json"],
        capture_output=True, text=True, timeout=240, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "profiled 4 layers" in r.stdout
    assert "per-term drift" in r.stdout and "TOTAL" in r.stdout
    assert "wrote tr.json and tr.chrome.json" in r.stdout
    assert "done at step" not in r.stdout           # no training
    t = ttrace.StepTrace.load(str(tmp_path / "tr.json"))
    assert list(t.layers) == ["conv1_1", "conv2_1", "conv3_1", "pred"]
    assert t.meta["attribution"]["schema"] == "repro/attribution@1"
    assert t.meta["backend"] == "cpu" and t.meta["mesh"] == {}
    with open(tmp_path / "tr.chrome.json") as f:
        assert len(json.load(f)["traceEvents"]) == 3 + 2 * 4
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "resnet50", "--smoke", "--device", "cpu", "--profile"],
        capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)
    assert bad.returncode != 0 and "meshnet archs" in bad.stderr
