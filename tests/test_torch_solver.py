"""The port's strategy solver (`core/{distribution,perfmodel,strategy}.py`)
and plan compiler (`core/plan.py`) against the JAX package's, in process
(both are pure Python over the same numbers).

For mesh1k and mesh2k at full width and the reference's CFG16 and CFG128
(`repro/analysis/workloads.py`), on the meshes 1x2, 2x2, 1x4, 2x4 and
1x8 at batches 1, 2, 4 and 8, on LASSEN's constants:

- `plan_line` under `--search` greedy, beam:4 and hillclimb (seeded) gives
  the same plan: the same `to_spec()` JSON (solved Dists, demotions
  included) and the same `describe()` text (shardings, CF modes, reshard
  points, demotion notes, predicted cost and memory);
- `plan_line` under memory limits of 0.9 and 0.5 times the unconstrained
  plan's predicted peak gives the same plan, or raises the same error
  (CapacityError / PlanError, the same message);
- for every candidate Dist of every layer (the wide space, CF included),
  `layer_cost`, `layer_memory` and `layer_collectives` agree to 1e-12
  relative, and `shuffle_time` between consecutive layers' candidates.

The trainer: `--strategy auto` on 2 gloo ranks under torchrun prints the
plan table and trains with equal finite losses; an LM arch refuses it.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

import jax_mesh_oracles
from repro.analysis import workloads
from repro.core import perfmodel as jpm
from repro.core import plan as jplan
from repro.core import strategy as jst
from repro.models.cnn import meshnet as jmesh
from repro_torch.core import distribution as tdist
from repro_torch.core import perfmodel as tpm
from repro_torch.core import plan as tplan
from repro_torch.core import strategy as tst
from repro_torch.launch import train as train_cli
from repro_torch.models.cnn import meshnet as tmesh


@pytest.fixture(scope="module", autouse=True)
def _reference_eta_unmeasured():
    with jax_mesh_oracles.reference_eta_unmeasured():
        yield


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"mesh1k": jmesh.MESH1K, "mesh2k": jmesh.MESH2K,
           "cfg16": workloads.CFG16, "cfg128": workloads.CFG128}
MESHES = [(1, 2), (2, 2), (1, 4), (2, 4), (1, 8)]
BATCHES = [1, 2, 4, 8]
SEARCHES = ["greedy", "beam:4", "hillclimb"]


def _specs(cfg, n):
    """The same layers in each package's ConvLayer."""
    js = jmesh.layer_specs(cfg, n)
    ts = [tpm.ConvLayer(**dataclasses.asdict(l)) for l in js]
    return js, ts


def _solve(lib, machine, specs, shape, **kw):
    try:
        plan = lib.plan_line(machine, specs, shape, **kw)
    except ValueError as e:             # CapacityError, PlanError
        return type(e).__name__, str(e)
    return json.dumps(plan.to_spec(shape)), plan.describe()


def _close(a: float, b: float) -> bool:
    return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))


def _fields(obj) -> list[float]:
    return [float(v) for v in dataclasses.astuple(obj)
            if isinstance(v, (int, float))]


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("name", list(CONFIGS))
def test_solver_and_compiler_pick_the_reference_plan(name, dims):
    shape = {"data": dims[0], "model": dims[1]}
    for n in BATCHES:
        js, ts = _specs(CONFIGS[name], n)
        for search in SEARCHES:
            want = _solve(jplan, jpm.LASSEN, js, shape, search=search)
            got = _solve(tplan, tpm.LASSEN, ts, shape, search=search)
            assert got == want, (name, dims, n, search)
        peak = jplan.plan_line(jpm.LASSEN, js, shape).predicted[
            "memory"]["peak_bytes"]
        for frac in (0.9, 0.5):
            want = _solve(jplan, jpm.LASSEN, js, shape,
                          mem_limit=frac * peak)
            got = _solve(tplan, tpm.LASSEN, ts, shape,
                         mem_limit=frac * peak)
            assert got == want, (name, dims, n, frac)


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("name", list(CONFIGS))
def test_perf_model_terms_agree(name, dims):
    shape = {"data": dims[0], "model": dims[1]}
    m_j, m_t = jpm.LASSEN, tpm.LASSEN
    n_checked = 0
    for n in (1, 8):
        js, ts = _specs(CONFIGS[name], n)
        prev = None
        for jl, tl in zip(js, ts):
            jc = jst.candidate_dists(jl, shape, allow_channel_filter=True,
                                     wide=True)
            tc = tst.candidate_dists(tl, shape, allow_channel_filter=True,
                                     wide=True)
            assert [(d.name, dict(d.dims)) for d in jc] == \
                [(d.name, dict(d.dims)) for d in tc]
            for jd, td in zip(jc, tc):
                for a, b in ((jpm.layer_cost(m_j, jl, jd, shape),
                              tpm.layer_cost(m_t, tl, td, shape)),
                             (jpm.layer_memory(m_j, jl, jd, shape),
                              tpm.layer_memory(m_t, tl, td, shape))):
                    assert all(_close(x, y)
                               for x, y in zip(_fields(a), _fields(b)))
                jcol = jpm.layer_collectives(m_j, jl, jd, shape)
                tcol = tpm.layer_collectives(m_t, tl, td, shape)
                assert [dataclasses.astuple(c) for c in jcol] == \
                    [dataclasses.astuple(c) for c in tcol]
                n_checked += 1
            if prev is not None:
                pj, pt, pl_j, pl_t = prev
                for a, b in zip(pj[::3], pt[::3]):
                    for c, d in zip(jc[::3], tc[::3]):
                        assert _close(
                            jpm.shuffle_time(m_j, pl_j, a, c, shape),
                            tpm.shuffle_time(m_t, pl_t, b, d, shape))
            prev = (jc, tc, jl, tl)
    assert n_checked > 0


def test_ported_surface():
    """Dist.spec is a plain tuple; the H100 preset holds the data sheet's
    numbers; parse_search's modes and refusals; the solver module needs
    no networkx."""
    d = tdist.channel_filter()
    assert d.spec("N", "H", "_", "C") == (("data",), None, None, ("model",))
    assert tpm.H100.peak_flops == 67e12 and tpm.H100.mem_bw == 3.35e12
    assert tpm.H100.beta == 1 / 450e9 and tpm.H100.mem_capacity == 80e9
    assert not hasattr(tpm, "TPU_V5E")
    assert tst.parse_search("beam") == ("beam", 4)
    assert tst.parse_search("beam:2") == ("beam", 2)
    for bad in ("beam:0", "beam:x", "dfs"):
        with pytest.raises(ValueError):
            tst.parse_search(bad)
    assert "networkx" not in open(tst.__file__).read().split('"""', 2)[2]


def test_plan_spec_round_trip_and_refusals():
    """to_spec / plan_from_spec round-trip; a spec of other layers and a
    non-plan record are refused as the reference refuses them."""
    shape = {"data": 1, "model": 2}
    js, ts = _specs(jmesh.MESH1K, 2)
    plan = tplan.plan_line(tpm.LASSEN, ts, shape)
    spec = plan.to_spec(shape)
    again = tplan.plan_from_spec(spec, ts, shape, machine=tpm.LASSEN)
    assert again.describe() == plan.describe()
    with pytest.raises(tplan.PlanError, match="no entry for layers"):
        tplan.plan_from_spec(spec, _specs(jmesh.MESH2K, 2)[1], shape)
    with pytest.raises(tplan.PlanError, match="not a repro/plan@1"):
        tplan.dists_from_spec({"schema": "x"})
    with pytest.raises(tst.CapacityError):
        tplan.plan_line(tpm.LASSEN, ts, shape, mem_limit=1e3)


def test_trainer_auto_flags():
    args = train_cli.parse_args(["--strategy", "auto", "--search", "beam:2",
                                 "--no-cf", "--mem-limit", "1e9"])
    assert (args.strategy, args.search, args.no_cf, args.mem_limit) == \
        ("auto", "beam:2", True, "1e9")
    for bad in (["--search", "dfs"], ["--mem-limit", "lots"]):
        with pytest.raises(SystemExit):
            train_cli.parse_args(bad)
    import torch
    assert train_cli.parse_mem_limit("1e9", torch.device("cpu")) == 1e9
    assert train_cli.parse_mem_limit("auto", torch.device("cpu"), 2) > 0
    assert train_cli.parse_mem_limit(None, torch.device("cpu")) is None
    with pytest.raises(SystemExit, match="LM arch"):
        train_cli.build(train_cli.parse_args(
            ["--arch", "hymba-1.5b", "--smoke", "--strategy", "auto",
             "--device", "cpu"]), torch.device("cpu"))


RANK_MAIN = r"""
import json, os, sys
from repro_torch.launch import train
from repro_torch.utils import tree_leaves
r = train.main(sys.argv[1:])
with open(f"result{os.environ['RANK']}.json", "w") as f:
    json.dump({"losses": r["losses"],
               "digest": [float(p.detach().double().sum())
                          for p in tree_leaves(r["params"])]}, f)
"""


def test_torchrun_auto_plan_on_two_ranks(tmp_path):
    """The trainer's entry under torchrun, each rank writing its losses
    and a digest of its params."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    env.pop("WORLD_SIZE", None)
    main = tmp_path / "rank_main.py"
    main.write_text(RANK_MAIN)
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(main),
         "--arch", "mesh1k", "--smoke", "--strategy", "auto", "--model",
         "2", "--batch", "1", "--steps", "2", "--device", "cpu",
         "--log-every", "1", "--metrics", str(tmp_path / "m.jsonl")],
        capture_output=True, text=True, timeout=240, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    res = [json.loads((tmp_path / f"result{r}.json").read_text())
           for r in range(2)]
    assert res[0] == res[1]
    assert "strategy optimizer" in out and "LASSEN" in out
    assert "NetworkPlan: 4 layers, 1 reshard points" in out
    assert "CF:model(channel)" in out and "shuffle <- H:model" in out
    assert "reshards: 1" in out
    recs = [json.loads(l) for l in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert recs[0]["strategy"] == "auto"
    losses = [x["loss"] for x in recs if x["kind"] == "step"]
    assert len(losses) == 2 and all(math.isfinite(l) for l in losses)
    assert out.count("done at step 2") == 1
