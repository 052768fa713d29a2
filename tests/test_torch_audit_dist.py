"""The port's collective auditor (`repro_torch.analysis.collectives`) on
gloo CPU ranks, against the reference where the reference still traces
its collectives on this jax.

- Every executable candidate dist of the reference's six audit probes
  (tests/dist_checks.py check_audit) on the 2x2, 1x4 and 4x1 meshes of 4
  ranks audits with no error finding (`torch_dist_cases.py audit`).
- For five cases (H, H x W, CF channel, CF filter, CF x H) the recorded
  collectives, grouped by (layer, direction, kind), have the counts and
  byte totals of the reference's `collect_ops` on 4 host devices
  (`jax_mesh_oracles.py audit`), weight-gradient psums excepted (the port
  sums them in one gradient bucket; jax 0.9.0 drops some from the
  reference's trace, ROADMAP Queue 3).
- The ZeRO bucket (a net whose convs data 2 shards): 0 errors on data 2 x
  model 2, and on pod 2 x data 2 under int8_ef with the pod exchange.
- The reference's negative cases fire their rules: an all-reduce injected
  into the layer `unpriced-collective`, a serialized step declared
  overlapped `schedule-pin-missing`.
- The mirrored §IV-A backward: on 2 ranks the halo gradients' sends are
  posted before the interior conv's dL/dx, and the gradients equal the
  serialized conv's.
- `train.py --audit` on 2 ranks prints its table and leaves the 3 steps'
  losses and the params bitwise those of the run without it; an error
  finding exits non-zero.  `python -m repro_torch.launch.dryrun --audit`
  on 4 ranks exits 0 and writes the `repro/plan_audit@1` JSON of all six
  workloads.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax_mesh_oracles
import torch_dist_cases as cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ERROR = "error"


@pytest.fixture(scope="module")
def audit_runs(tmp_path_factory):
    """The 4-rank audit, the reference's oracle and the 2-rank halo order,
    started together."""
    da, dr, dh = (tmp_path_factory.mktemp(n) for n in ("audit", "ref",
                                                       "halo"))
    pa = cases.start("audit", (2, 2), str(da))
    ph = cases.start("halo_order", (1, 2), str(dh))
    pr = jax_mesh_oracles.popen("audit", str(dr))
    ranks = cases.collect(pa, (2, 2), str(da))
    halo = cases.collect(ph, (1, 2), str(dh))
    jax_mesh_oracles.wait(pr)
    with open(dr / "audit_ref.json") as f:
        ref = json.load(f)
    reports = [json.loads(str(r["report"])) for r in ranks]
    return reports, ref, halo


def _errors(findings):
    return [f"{f['rule']}: {f['message']}" for f in findings
            if f["severity"] == ERROR]


@pytest.mark.parametrize("dims", cases.AUDIT_MESHES,
                         ids=[f"{d}x{m}" for d, m in cases.AUDIT_MESHES])
def test_every_candidate_audits_clean(audit_runs, dims):
    reports, _, _ = audit_runs
    for rank, rep in enumerate(reports):
        mine = [p for p in rep["probes"] if tuple(p["mesh"]) == dims]
        probes = {p["probe"] for p in mine}
        assert probes == set(range(len(cases.AUDIT_PROBES))), probes
        bad = [(p["probe"], p["dims"], _errors(p["findings"]))
               for p in mine if _errors(p["findings"])]
        assert not bad, (rank, bad)


@pytest.mark.parametrize("key", [c[0] for c in cases.AUDIT_CASES])
def test_recorded_ops_match_the_reference(audit_runs, key):
    reports, ref, _ = audit_runs
    assert ref[key], key              # the reference traced collectives
    for rep in reports:
        assert rep["cases"][key]["ops"] == ref[key]
        assert not _errors(rep["cases"][key]["findings"])


@pytest.mark.parametrize("key", ["data2", "pod2_int8_ef"])
def test_zero_bucket_audits_clean(audit_runs, key):
    """The step with its training state sharded over data 2: the
    reduce-scatter of the sharded convs and the rest's psum together
    carry the priced weight gradients once (0 errors, the bucket's bytes
    the priced ones plus the BN vectors); under int8_ef on pod 2 x data 2
    the pod exchange's all-gathers are in the bucket too."""
    for rep in audit_runs[0]:
        got = rep["zero"][key]
        assert not _errors(got["findings"]), got["findings"]
        kinds = {(k, tuple(a)) for k, a, _ in got["bucket"]}
        assert ("reduce_scatter", ("data",)) in kinds, kinds
        moved, priced = got["moved"]
        assert priced < moved <= priced * 1.01
        infos = [f["message"] for f in got["findings"]
                 if f["rule"] == "grad-bucket" and f["layer"] is None]
        assert any(m.startswith("ZeRO over data") for m in infos), infos
        assert any("skips the update" in m for m in infos), infos
        assert any(m.startswith("pod exchange") for m in infos) == \
            (key == "pod2_int8_ef"), infos


def test_injected_collective_fires_unpriced(audit_runs):
    for rep in audit_runs[0]:
        rules = [(f["rule"], f["severity"]) for f in rep["negative"]
                 ["injected"]]
        assert ("unpriced-collective", ERROR) in rules, rules


def test_serialized_step_fires_pin_missing(audit_runs):
    for rep in audit_runs[0]:
        found = [f for f in rep["negative"]["serialized"]
                 if f["rule"] == "schedule-pin-missing"]
        assert len(found) == 2 and all(f["severity"] == ERROR
                                       for f in found), found
        assert {"forward" in f["message"] for f in found} == {True, False}


def test_mirrored_backward_posts_before_the_interior_dgrad(audit_runs):
    for rank in audit_runs[2]:
        ops = [tuple(o) for o in json.loads(str(rank["overlap/ops"]))]
        at = {op: ops.index(op) for op in reversed(ops)}    # first index
        assert at[("pin", "bwd", "halo_exchange")] < \
            at[("ppermute", "bwd", "halo_exchange")] < \
            at[("conv", "bwd", "conv_interior")], ops
        assert at[("conv", "bwd", "conv_boundary")] < \
            at[("pin", "bwd", "halo_exchange")], ops
        serial = [tuple(o) for o in json.loads(str(rank["serialized/ops"]))]
        assert not [o for o in serial if o[0] == "pin"], serial
        np.testing.assert_allclose(rank["overlap/dx"], rank["serialized/dx"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rank["overlap/dw"], rank["serialized/dw"],
                                   rtol=1e-5, atol=1e-4)


# ----------------------------------------------------------- the CLIs --

RANK_MAIN = r"""
import json, sys
from repro_torch.launch import train
from repro_torch.utils import tree_leaves
r = train.main(sys.argv[1:])
print("RESULT " + json.dumps({
    "losses": r["losses"],
    "digest": [float(p.detach().double().sum()) for p in
               tree_leaves(r["params"])]}))
"""
TRAIN = ["--arch", "mesh1k", "--smoke", "--model", "2", "--steps", "3",
         "--batch", "2", "--device", "cpu"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    env.pop("WORLD_SIZE", None)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(tmp_path, n: int, args: list) -> list:
    port, procs = _free_port(), []
    for rank in range(n):
        env = _env()
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN, *args], env=env, cwd=tmp_path,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _finish(procs) -> tuple[list, list]:
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    res = [json.loads(next(ln for ln in o.splitlines()
                           if ln.startswith("RESULT "))[7:]) for o in outs]
    return res, outs


def test_audit_leaves_the_trajectory_bitwise(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    with_audit = _start(tmp_path / "a", 2, TRAIN + ["--audit"])
    without = _start(tmp_path / "b", 2, TRAIN)
    got, outs = _finish(with_audit)
    want, _ = _finish(without)
    assert len(got[0]["losses"]) == 3
    assert got == want                   # losses and params, bitwise
    head = [ln for ln in outs[0].splitlines()
            if ln.startswith("plan audit: ")]
    assert len(head) == 1 and " 0 error(s) " in head[0], head
    assert "grad-bucket" in outs[0]
    assert not [ln for ln in outs[1].splitlines()
                if ln.startswith("plan audit")]      # rank 0 prints


def test_audit_gate_refuses_an_erroneous_plan():
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.core.plan import NetworkPlan
    from repro_torch.core.spatial_conv import ConvSharding
    from repro_torch.launch import train
    from repro_torch.models.cnn import meshnet
    args = train.parse_args(TRAIN[:2] + ["--audit", "--device", "cpu"])
    cfg = registry.get("mesh1k", smoke=True)
    plan = NetworkPlan.uniform(ConvSharding(), meshnet.layer_names(cfg))
    first = meshnet.layer_names(cfg)[0]
    broken = dataclasses.replace(plan, layers={
        **plan.layers,
        first: dataclasses.replace(plan.layers[first], reshard_in=True)})
    with pytest.raises(SystemExit, match="error-severity"):
        train.audit_gate(args, cfg, None, broken, None, None, "cpu",
                         lead=False)
    assert train.audit_gate(args, cfg, None, plan, None, None, "cpu",
                            lead=False) is not None
    for bad in (["--arch", "resnet50", "--audit"],
                ["--arch", "mesh1k", "--audit", "--profile"]):
        with pytest.raises(SystemExit):
            train.parse_args(bad + ["--device", "cpu"])


def test_dryrun_audits_the_six_workloads_on_4_ranks(tmp_path):
    out = tmp_path / "PLAN_audit.json"
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.dryrun",
         "--audit", "--device", "cpu", "--audit-out", str(out)],
        env=_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    rep = json.loads(out.read_text())
    assert rep["schema"] == "repro/plan_audit@1"
    assert rep["mesh"] == {"data": 2, "model": 2}
    assert rep["collective_backend"] == "gloo" and rep["n_errors"] == 0
    assert set(rep["workloads"]) == {
        "mesh128", "overlap", "mesh16cf", "mesh2k_proxy", "mesh16_proxy",
        "mesh2k_unreachable"}
    for name, w in rep["workloads"].items():
        assert not w["skipped"] and w["n_errors"] == 0, (name, w)
        assert {"n_findings", "n_reshards", "findings"} <= set(w)
    assert "# audit/overlap: " in r.stdout


def test_dryrun_one_process_skips_what_needs_a_model_axis(tmp_path, capsys):
    from repro_torch.launch import dryrun
    out = tmp_path / "one.json"
    assert dryrun.main(["--audit", "overlap", "mesh16_proxy", "--device",
                        "cpu", "--no-hlo", "--audit-out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["mesh"] == {"data": 1, "model": 1}
    assert rep["workloads"]["mesh16_proxy"] == {"skipped": True}
    assert rep["workloads"]["overlap"]["n_errors"] == 0
    assert "SKIPPED" in capsys.readouterr().out
    for bad in ([], ["--audit", "nope"]):
        with pytest.raises(SystemExit):
            dryrun.main(bad + ["--device", "cpu"])


def test_record_is_scoped_and_attributes_from_the_op():
    import torch
    from repro_torch import analysis
    from repro_torch.core import trace
    from repro_torch.core.spatial_conv import ConvSharding, spatial_conv2d
    x = torch.randn(1, 6, 6, 3, requires_grad=True)
    w = torch.randn(3, 3, 3, 4, requires_grad=True)

    def layer():
        with trace.layer_context("c1"):
            with trace.annotate("conv_serialized", x):
                y = spatial_conv2d(x, w, sharding=ConvSharding())
        y.sum().backward()

    with analysis.record() as rec:
        layer()
        with pytest.raises(RuntimeError):
            with analysis.record():
                pass
    assert trace.RECORDER is None
    got = [(o.kind, o.layer, o.direction, o.region) for o in rec.ops]
    # the backward runs after the layer's context closed: its layer and
    # region come from the forward
    assert got == [("conv", "c1", "fwd", "conv_serialized"),
                   ("conv", "c1", "bwd", "conv_serialized")]
    assert rec.ops[0].bytes == 8 * 8 * 3 * 4      # the SAME-padded input
    assert rec.regions[("c1", "conv_serialized")] == 1
    layer()                            # outside record(): nothing recorded
    assert len(rec.ops) == 2
