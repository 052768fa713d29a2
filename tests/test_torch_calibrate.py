"""The calibration (`repro_torch.core.calibrate`) against the reference's
(`repro.core.calibrate`), on the CPU with the reference tests'
deterministic fake timer (seconds from the argument sizes only; no kernel
runs, no clock is read), so every comparison is exact.

- The same layers and mesh shape give the same calibration JSON in both
  packages: the same table keys and times, the fitted constants equal to
  1e-12 relative; only meta's backend, device count, the card fields and
  the machine's name may differ.
- A file the reference wrote loads in the port (and the reverse), and the
  port's `plan_line` / `plan_graph` on its machine and table solve the
  same dists as the reference's, for the mesh1k SMOKE net and the tiny
  ResNet.
- The fits on the same sample rows agree.
- The reference's fake-timer cases, ported: idempotent `load_or_run`,
  the foreign-network warning, `grow`, the shape cap, the analytic
  fallback, the η backfill and η driving `chunks_decision`.
- 2 gloo ranks, each with a different fake time, end with one calibration
  (the communication samples the max over the ranks, the table rank 0's)
  and one solved plan (`tests/torch_dist_cases.py calibrate`).
- The CLIs: `--calibrate` twice (written, then loaded) and
  `python -m repro_torch.core.calibrate`, on `--device cpu`.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax_mesh_oracles
import torch_dist_cases
from repro.configs import mesh1k as jmesh1k
from repro.core import calibrate as jcal
from repro.core import channel_conv as jcc
from repro.core import perfmodel as jpm
from repro.core import plan as jplan
from repro.models.cnn import meshnet as jmesh
from repro.models.cnn import resnet as jres
from repro_torch.configs import mesh1k as tmesh1k
from repro_torch.core import calibrate as tcal
from repro_torch.core import channel_conv as tcc
from repro_torch.core import perfmodel as tpm
from repro_torch.core import plan as tplan
from repro_torch.models.cnn import meshnet as tmesh
from repro_torch.models.cnn import resnet as tres

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS22 = {"data": 2, "model": 2}
NET = torch_dist_cases.CALIB_NET
JSPECS = jmesh.layer_specs(jmesh.MeshNetConfig("t", **NET),
                           torch_dist_cases.CALIB_BATCH)
TSPECS = tmesh.layer_specs(tmesh.MeshNetConfig("t", **NET),
                           torch_dist_cases.CALIB_BATCH)
fake_timer = torch_dist_cases.rank_fake_timer(0)
TINY = {"name": "tiny", "input_hw": 32, "n_classes": 10, "stages": (1, 1),
        "widths": (8, 16)}
# meta keys that name the backend the calibration ran on
BACKEND_META = {"backend", "ndevices", "card"}


@pytest.fixture(autouse=True)
def _deterministic_state(monkeypatch):
    """A fixed memory capacity (the host's free memory jitters) and no
    measured η in either package, restored afterwards.  The reference's
    benches draw their inputs from `jax.random.normal`, one compile a
    shape; the fake timer reads only their shapes, so they are numpy
    zeros here."""
    monkeypatch.setenv("REPRO_MEM_CAPACITY", str(8 << 30))
    monkeypatch.setattr(jcal.jax.random, "normal",
                        lambda key, shape, dtype=np.float32:
                        np.zeros(shape, np.float32))
    for lib in (jcal, tcal):
        lib.detect_mem_capacity.cache_clear()
    before = tcc.measured_eta()
    tcc.set_measured_eta(None)
    with jax_mesh_oracles.reference_eta_unmeasured():
        yield
    tcc.set_measured_eta(before)
    for lib in (jcal, tcal):
        lib.detect_mem_capacity.cache_clear()


def _machines_equal(jm, tm, rel=1e-12):
    for f in dataclasses.fields(tm):
        a, b = getattr(jm, f.name), getattr(tm, f.name)
        if f.name == "name":
            continue
        if isinstance(a, float):
            assert b == pytest.approx(a, rel=rel, abs=0), f.name
        else:
            assert a == b, f.name


# ------------------------------------------------- the two packages agree --
@pytest.mark.parametrize("mesh", [MS22, {"model": 2}, {"data": 1,
                                                       "model": 4}],
                         ids=["2x2", "1x2", "1x4"])
@pytest.mark.parametrize("kw", [{}, {"max_shapes": 4},
                                {"allow_channel_filter": False}],
                         ids=["full", "capped", "no-cf"])
def test_fake_timer_calibration_matches_reference(mesh, kw):
    j = jcal.calibrate(JSPECS, mesh, timer=fake_timer, **kw)
    t = tcal.calibrate(TSPECS, mesh, timer=fake_timer, device="cpu", **kw)
    jj, tj = j.to_json(), t.to_json()
    assert tj["schema"] == jj["schema"] == "repro/calibration@1"
    assert [k for k, _ in tj["table"]] == [k for k, _ in jj["table"]]
    assert [v for _, v in tj["table"]] == [v for _, v in jj["table"]]
    _machines_equal(j.machine, t.machine)
    assert t.machine.name == "calibrated-cpu"
    jm = {k: v for k, v in jj["meta"].items() if k not in BACKEND_META}
    tm = {k: v for k, v in tj["meta"].items() if k not in BACKEND_META}
    assert json.loads(json.dumps(jm)) == tm
    assert t.meta["backend"] == "cpu"


def _written(tmp_path, specs_j, mesh):
    path = str(tmp_path / "BENCH_calibration.json")
    jcal.calibrate(specs_j, mesh, timer=fake_timer).save(path)
    return path


def _dists(plan):
    return {n: (lp.dist.name, {k: tuple(v) for k, v in lp.dist.dims.items()})
            for n, lp in plan.layers.items()}


@pytest.mark.parametrize("mesh", [{"model": 2}, MS22], ids=["1x2", "2x2"])
@pytest.mark.parametrize("batch", [1, 2])
def test_reference_file_solves_the_same_meshnet(tmp_path, mesh, batch):
    jspecs = jmesh.layer_specs(jmesh1k.SMOKE, batch)
    tspecs = tmesh.layer_specs(tmesh1k.SMOKE, batch)
    path = _written(tmp_path, jspecs, mesh)
    j = jcal.Calibration.load(path)
    t = tcal.Calibration.load(path)
    assert t.table == tpm.EmpiricalTable(j.table.entries)
    assert dataclasses.asdict(t.machine) == dataclasses.asdict(j.machine)
    jp = jplan.plan_line(j.machine, jspecs, mesh, table=j.table)
    tp = tplan.plan_line(t.machine, tspecs, mesh, table=t.table)
    assert _dists(tp) == _dists(jp)
    assert tp.predicted["total"] == pytest.approx(jp.predicted["total"],
                                                  rel=1e-12)
    # the table moved the solve: it prices what the analytic model would
    tpa = tplan.plan_line(t.machine, tspecs, mesh)
    assert tp.predicted["total"] != tpa.predicted["total"]


@pytest.mark.parametrize("mesh", [{"model": 2}, MS22], ids=["1x2", "2x2"])
def test_reference_file_solves_the_same_resnet(tmp_path, mesh):
    jc, tc = jres.ResNetConfig(**TINY), tres.ResNetConfig(**TINY)
    jspecs, tspecs = jres.layer_specs(2, jc), tres.layer_specs(2, tc)
    path = _written(tmp_path, jspecs, mesh)
    j, t = jcal.Calibration.load(path), tcal.Calibration.load(path)
    jp = jplan.plan_graph(j.machine, jres.resnet_graph(2, jc), jspecs, mesh,
                          table=j.table)
    tp = tplan.plan_graph(t.machine, tres.resnet_graph(2, tc), tspecs, mesh,
                          table=t.table)
    assert _dists(tp) == _dists(jp)
    assert tp.predicted["total"] == pytest.approx(jp.predicted["total"],
                                                  rel=1e-12)


def test_port_file_loads_in_the_reference(tmp_path):
    path = str(tmp_path / "c.json")
    t = tcal.calibrate(TSPECS, MS22, timer=fake_timer, device="cpu")
    t.save(path)
    j = jcal.Calibration.load(path)
    assert dataclasses.asdict(j.machine) == dataclasses.asdict(t.machine)
    assert j.table.entries == t.table.entries
    assert jcal.coverage(j, JSPECS, MS22) == 1.0


# ------------------------------------------------------------- the fits --
ROWS = [
    [(1.0, float(n), 3e-6 + n / 12e9) for n in (1 << 10, 1 << 14, 1 << 18)],
    [(1.0, 512.0, 4e-5), (1.0, 4096.0, 3.9e-5), (1.0, 1 << 20, 2e-4)],
    [(1.0, 8.0, 1e-6)],
    [(1.0, 8.0, 1e-6), (2.0, 16.0, 2e-6)],             # rank-deficient
]


@pytest.mark.parametrize("rows", ROWS, ids=range(len(ROWS)))
def test_fit_alpha_beta_matches_reference(rows):
    want = jcal._fit_alpha_beta(rows, (1e-6, 1e-10))
    assert tcal._fit_alpha_beta(rows, (1e-6, 1e-10)) == \
        pytest.approx(want, rel=1e-12)


COMPUTE = [
    [(fl, (fl + 2e9) / 5e11 + jpm.LAUNCH_OVERHEAD)
     for fl in (1e8, 1e9, 1e10, 1e11)],
    [(1e6, 3e-5), (4e6, 2e-5)],                         # slope < 0
    [(1e9, 1e-3)],
    [],
]


@pytest.mark.parametrize("samples", COMPUTE, ids=range(len(COMPUTE)))
def test_fit_compute_matches_reference(samples):
    want = jcal._fit_compute(samples, jcal.HOST_BASE)
    got = tcal._fit_compute(samples, tcal.HOST_BASE)
    assert got == pytest.approx(want, rel=1e-12)


def test_fit_composed_factors_and_eta_default_match_reference():
    m = dataclasses.asdict(tpm.LASSEN)
    geom = {"o": 1, "n": 2, "c": 8, "h_l": 16, "w_l": 32, "hops": 2}
    halo = [{"t_fused": 5e-4, "t_compute": 1e-4, "geom": geom},
            {"t_fused": 1e-4, "t_compute": 2e-4, "geom": geom}]
    cf = [{"p_cf": 2, "t_fused": 7e-4, "t_compute": 1e-4,
           "geom": {"o": 1, "n": 2, "c_l": 8, "f": 16, "h_l": 16,
                    "w_l": 32}}]
    for c, h in ((cf, halo), ([], []), (cf, [])):
        want = jcal._fit_composed_factors(jpm.Machine(**m), c, h)
        got = tcal._fit_composed_factors(tpm.Machine(**m), c, h)
        assert got == pytest.approx(want, rel=1e-12)
    assert tcal.fit_eta(MS22, timer=fake_timer) == \
        jcal.fit_eta(MS22, timer=fake_timer) == (1.0, [])


def test_sizes_and_shapes_match_reference():
    for mesh in (MS22, {"model": 4}):
        assert tcal.table_shapes(TSPECS, mesh) == \
            jcal.table_shapes(JSPECS, mesh)
        assert tcal.comm_sizes(TSPECS, mesh) == \
            jcal.comm_sizes(JSPECS, mesh)
        assert tcal.shuffle_sizes(TSPECS, mesh) == \
            jcal.shuffle_sizes(JSPECS, mesh)
    keys = tcal.table_shapes(TSPECS, MS22)
    assert tcal._choose_shapes(keys, 5) == jcal._choose_shapes(keys, 5)
    assert tcal._representative(list(range(17)), 4) == \
        jcal._representative(list(range(17)), 4)


# -------------------------------- the reference's fake-timer cases, ported --
def test_calibration_roundtrip_and_rejects_foreign_json(tmp_path):
    c = tcal.calibrate(TSPECS, MS22, timer=fake_timer, device="cpu")
    path = str(tmp_path / "BENCH_calibration.json")
    c.save(path)
    c2 = tcal.Calibration.load(path)
    assert (c2.machine, c2.table, c2.meta) == (c.machine, c.table, c.meta)
    assert c2.fingerprint == c.fingerprint
    assert len(c.table) > 0 and c.machine.peak_flops > 0
    with open(path, "w") as f:
        json.dump({"schema": "something-else"}, f)
    with pytest.raises(ValueError, match="schema"):
        tcal.Calibration.load(path)


def test_calibration_deterministic_under_seeded_timings():
    c1 = tcal.calibrate(TSPECS, MS22, timer=fake_timer, device="cpu")
    c2 = tcal.calibrate(TSPECS, MS22, timer=fake_timer, device="cpu")
    assert c1.to_json() == c2.to_json()


def _boom(fn, *a):
    raise AssertionError("re-measured instead of loading")


def test_load_or_run_is_idempotent(tmp_path):
    path = str(tmp_path / "c.json")
    c1 = tcal.load_or_run(path, TSPECS, MS22, timer=fake_timer,
                          device="cpu")
    c2 = tcal.load_or_run(path, TSPECS, MS22, timer=_boom, device="cpu")
    assert c2.to_json() == c1.to_json()


OTHER = tmesh.layer_specs(tmesh.MeshNetConfig(
    "o", input_hw=128, in_channels=6, convs_per_block=2, widths=(12, 24)), 8)


def test_load_warns_when_calibration_covers_foreign_network(tmp_path,
                                                            capsys):
    path = str(tmp_path / "c.json")
    c = tcal.load_or_run(path, TSPECS, MS22, timer=fake_timer, device="cpu")
    assert tcal.coverage(c, TSPECS, MS22) == pytest.approx(1.0)
    capsys.readouterr()
    c2 = tcal.load_or_run(path, OTHER, {"data": 1, "model": 4},
                          timer=fake_timer, device="cpu")
    out = capsys.readouterr().out
    assert "WARNING" in out and "covers only" in out
    assert "was measured on mesh" in out
    assert c2.table == c.table


def test_load_or_run_grows_table_for_new_shapes(tmp_path, capsys):
    path = str(tmp_path / "c.json")
    c = tcal.load_or_run(path, TSPECS, MS22, timer=fake_timer, device="cpu")
    n0 = len(c.table)
    capsys.readouterr()
    c2 = tcal.load_or_run(path, OTHER, MS22, timer=fake_timer,
                          grow_table=True, device="cpu")
    out = capsys.readouterr().out
    assert len(c2.table) > n0
    assert "grew" in out and "covers only" not in out
    assert tcal.coverage(c2, OTHER, MS22) == pytest.approx(1.0)
    assert tcal.coverage(c2, TSPECS, MS22) == pytest.approx(1.0)
    c3 = tcal.load_or_run(path, OTHER, MS22, timer=fake_timer, device="cpu")
    assert c3.table == c2.table
    assert tcal.grow(c3, OTHER, MS22, timer=fake_timer, device="cpu") == 0
    assert c3.machine == c.machine


def test_calibrate_caps_shape_grid():
    c = tcal.calibrate(TSPECS, MS22, timer=fake_timer, max_shapes=4,
                       device="cpu")
    assert len(c.table) <= 4
    assert c.meta["shapes"]["dropped"] > 0
    assert tcal.coverage(c, TSPECS, MS22) == pytest.approx(1.0)
    keys = sorted(c.table.entries,
                  key=lambda k: tcal._conv_flops_bytes(k)[0])
    all_keys = sorted(tcal.table_shapes(TSPECS, MS22),
                      key=lambda k: (tcal._conv_flops_bytes(k)[0], k))
    assert keys[0] == all_keys[0] and keys[-1] == all_keys[-1]


def test_solver_with_table_and_without_gives_executable_plans():
    c = tcal.calibrate(TSPECS, MS22, timer=fake_timer, device="cpu")
    names = {l.name for l in TSPECS}
    for table in (c.table, None):
        plan = tplan.plan_line(c.machine, TSPECS, MS22, table=table)
        assert set(plan.layers) == names
        assert plan.predicted is not None and plan.predicted["total"] > 0
    # a table pricing every candidate shape absurdly slow moves the cost
    layer = tpm.ConvLayer("l", n=8, c=8, h=32, w=32, f=8, k=3, s=1)
    slow = tpm.EmpiricalTable({k: 10.0 for k in
                               tcal.table_shapes([layer], MS22)})
    d = tplan.executable_candidates(layer, MS22)[0]
    assert tpm.layer_cost(tpm.H100, layer, d, MS22, slow).total > \
        100 * tpm.layer_cost(tpm.H100, layer, d, MS22, None).total


def test_analytic_fallback_on_missing_shapes():
    foreign = tpm.EmpiricalTable({("conv", 1, 1, 8, 8, 1, 3, 1): 123.0})
    p_t = tplan.plan_line(tpm.H100, TSPECS, MS22, table=foreign)
    p_a = tplan.plan_line(tpm.H100, TSPECS, MS22)
    assert _dists(p_t) == _dists(p_a)
    assert p_t.predicted["total"] == pytest.approx(p_a.predicted["total"])


def test_eta_backfill_on_pre_eta_file(tmp_path, capsys):
    path = str(tmp_path / "c.json")
    c = tcal.load_or_run(path, TSPECS, MS22, timer=fake_timer, device="cpu")
    with open(path) as f:
        obj = json.load(f)
    del obj["meta"]["eta_fit"]
    del obj["machine"]["overlap_eta"]
    with open(path, "w") as f:
        json.dump(obj, f)
    capsys.readouterr()
    c2 = tcal.load_or_run(path, TSPECS, MS22, timer=fake_timer, device="cpu")
    assert "backfilled overlap eta" in capsys.readouterr().out
    assert c2.meta["eta_fit"] == {"eta": 1.0, "samples": []}
    assert c2.to_json() == c.to_json()
    c3 = tcal.load_or_run(path, TSPECS, MS22, timer=_boom, device="cpu")
    assert c3.to_json() == c2.to_json()


def test_measured_eta_drives_chunk_default():
    assert tcc.chunks_decision() == (1, "eta unmeasured")
    tcal.calibrate(TSPECS, MS22, timer=fake_timer, device="cpu")
    assert tcc.measured_eta() is None         # an empty fit installs none
    tcc.set_measured_eta(tcc.ETA_CHUNK_THRESHOLD)
    assert tcc.default_channel_chunks() == 2
    tcc.set_measured_eta(0.1)
    assert tcc.chunks_decision() == (1, "measured eta 0.10 < 0.5")
    assert tcc.ETA_CHUNK_THRESHOLD == jcc.ETA_CHUNK_THRESHOLD
    # a loaded file whose η resolved installs it; the compiled plan's
    # notes say so
    cal = tcal.calibrate(TSPECS, MS22, timer=fake_timer, device="cpu")
    cal.meta["eta_fit"] = {"eta": 0.8, "samples": [
        {"axis": "model", "p": 2, "t_overlap": 1e-3, "t_serial": 1.5e-3,
         "t_compute": 1e-3, "eta": 0.8}]}
    tcc.set_measured_eta(None)
    tcal._synced(cal, None)
    assert tcc.measured_eta() == 0.8
    notes = [lp.note for lp in tplan.plan_line(
        tpm.LASSEN, tmesh.layer_specs(tmesh1k.SMOKE, 1), {"model": 2})
        .layers.values() if "chunks" in lp.note]
    assert notes and all("chunks=2 (measured eta 0.80" in n for n in notes)


def test_refit_from_attribution_matches_reference():
    report = {"terms": {"shuffle": {"drift": 3.0, "predicted_s": 1e-3},
                        "fp_comm": {"drift": 0.5, "predicted_s": 2e-3},
                        "bp_comm": {"drift": 2.0, "predicted_s": 1e-3}},
              "worst_term": "shuffle"}
    j = jcal.calibrate(JSPECS, MS22, timer=fake_timer)
    t = tcal.calibrate(TSPECS, MS22, timer=fake_timer, device="cpu")
    assert tcal.refit_from_attribution(t, report) == \
        pytest.approx(jcal.refit_from_attribution(j, report), rel=1e-12)
    assert t.meta["attribution_refits"] == j.meta["attribution_refits"]


def test_step_peak_bytes_is_none_on_the_cpu():
    assert tcal.step_peak_bytes(lambda: torch.ones(3)) is None
    plan = tplan.plan_line(tpm.H100, TSPECS, MS22)
    check = tcal.crosscheck_memory(plan, lambda: torch.ones(3))
    assert check["measured_bytes"] is None
    assert check["predicted_bytes"] == plan.predicted["memory"]["peak_bytes"]
    assert np.isnan(check["ratio"])
    assert tcal.detect_mem_capacity("cpu") == float(8 << 30)
    assert tcal.mem_capacity_source("cpu") == "env:REPRO_MEM_CAPACITY"


# ------------------------------------------------------------ two ranks --
def test_two_ranks_agree_on_one_calibration_and_plan(tmp_path):
    """Each rank times with its own fake (rank r: 1 + r times the
    reference's): the table is rank 0's, every communication sample the
    max over the ranks (rank 1's), and both ranks hold one calibration,
    one fingerprint and one solved plan; the second call loads."""
    ranks = torch_dist_cases.run("calibrate", (1, 2), str(tmp_path))
    r0, r1 = ranks
    assert str(r0["cal"]) == str(r1["cal"])
    assert str(r0["fingerprint"]) == str(r1["fingerprint"])
    assert str(r0["again"]) == str(r0["cal"])
    assert str(r0["plan"]) == str(r1["plan"])
    cal = json.loads(str(r0["cal"]))
    slow = torch_dist_cases.rank_fake_timer(1)
    for _, nbytes, t in cal["meta"]["p2p_samples"]:
        assert t == slow(None, np.zeros(max(1, nbytes // 4)))
    for op, _, p, nbytes, t in cal["meta"]["collective_samples"]:
        elems = max(p, nbytes // 4) // p * p
        shape = elems // p if op == "all_gather" else elems
        assert t == slow(None, np.zeros(shape))
    want = jcal.calibrate(JSPECS, {"data": 1, "model": 2},
                          timer=fake_timer)
    assert [k for k, _ in cal["table"] if k[0] in ("conv", "pool")] == \
        [k for k, _ in want.to_json()["table"]]
    assert [v for k, v in cal["table"] if k[0] in ("conv", "pool")] == \
        [v for _, v in want.to_json()["table"]]
    assert {k[0] for k, _ in cal["table"]
            if k[0] not in ("conv", "pool")} == {"shuffle:a2a"}
    assert cal["meta"]["mesh"] == {"data": 1, "model": 2}
    assert len(cal["meta"]["eta_fit"]["samples"]) == 1
    with open(tmp_path / "cal.json") as f:
        assert json.load(f) == cal


# ----------------------------------------------------------------- CLIs --
def _run(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-m"] + args, capture_output=True,
                       text=True, timeout=240, env=env, cwd=cwd)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout


def test_cli_calibrate_writes_then_loads(tmp_path):
    args = ["repro_torch.launch.train", "--arch", "mesh1k", "--smoke",
            "--steps", "1", "--batch", "2", "--device", "cpu",
            "--strategy", "auto", "--calibrate", "cal.json"]
    first = _run(args, tmp_path)
    assert "calibration written to cal.json" in first
    fp = next(l for l in first.splitlines()
              if l.startswith("calibration ready")).split()[-1].rstrip(")")
    assert f"calibration={fp}" in first
    assert "on the calibration cal.json (calibrated-cpu)" in first
    assert "done at step 1" in first
    second = _run(args, tmp_path)
    assert "calibration loaded from cal.json" in second
    assert f"fingerprint {fp}" in second
    skip = _run(args[:-4] + ["--calibrate", "other.json"], tmp_path)
    assert "skipping calibration for --strategy uniform" in skip
    assert not os.path.exists(tmp_path / "other.json")


def test_cli_calibrate_module(tmp_path):
    out = _run(["repro_torch.core.calibrate", "--arch", "resnet50",
                "--smoke", "--batch", "2", "--device", "cpu", "--model",
                "2", "--max-shapes", "6", "--out", "r.json"], tmp_path)
    assert "calibration written to r.json" in out
    cal = tcal.Calibration.load(str(tmp_path / "r.json"))
    assert len(cal.table) == 6 and cal.meta["mesh"] == {"data": 1,
                                                        "model": 2}
    assert f"calibration fingerprint {cal.fingerprint}" in out
    again = _run(["repro_torch.core.calibrate", "--arch", "resnet50",
                  "--smoke", "--batch", "2", "--device", "cpu", "--model",
                  "2", "--max-shapes", "6", "--out", "r.json"], tmp_path)
    assert "calibration loaded from r.json" in again
